// K3: monotonic alignment search (MAS), forward dynamic program and
// backtrack in one launch.
//
// Replaces the TPU kernel `_mas_kernel` (bert_vits2_tpu/ops/align_pallas.py:39,
// launched by `maximum_path_pallas`). For each batch item with lengths
// (t_y, t_x) it computes, bit for bit, what `maximum_path_numpy`
// (bert_vits2_tpu/ops/align.py:126) computes:
//
//   v[y][x] = neg[y][x] + max(v[y-1][x-1], v[y-1][x])   inside the band
//             max(0, t_x + y - t_y) <= x < min(t_x, y + 1)
//   (v[y-1][x-1] is 0 at x = 0, y = 0 and -1e9 at x = 0, y > 0;
//    v[y-1][x] is -1e9 at x == y; the row before the first is -1e9), and
//   neg[y][x] + 0 outside the band;
//   move-left[y][x] = (x == y) | (v[y-1][x] < v[y-1][x-1])      (strict);
//   the walk from index = t_x - 1 at y = t_y - 1 down to y = 0 writes 1 at
//   [y][index] and steps left where index != 0 and move-left says so.
//
// The arithmetic is one fp32 add and one max per cell, so there is nothing
// to tolerate against the plain version.
//
// What bounds it on the card: not bytes (the valid scores read once, the
// path written once: ~6.6 MB at [16, 512, 128], 2 us at 3.35 TB/s) and
// not operations, but two dependent chains per item: t_y frames, each
// needing the whole previous row, then t_y steps of the walk, each needing
// the index the step before left. The block-per-item kernel before this
// one paid a block-wide barrier per frame (~30 ns a link) and read each
// walk step's decision word from device memory; here both links are short:
//
// - Frames in warps, values in registers. One block per item; its columns
//   are cut into slabs of 32*K, one warp each (K = 1..32, a template; the
//   wrapper's `mas_plan` picks the least K whose warps number at most 12).
//   Lane L of warp w holds columns x = 32*K*w + 32*k + L, k < K, of the
//   previous row in registers. A frame is K shuffles (the left
//   neighbours), K max+add and K ballots: no barrier, no row in shared
//   memory. Where no column of the warp is on the diagonal or at the
//   band's edge for a whole batch of frames (most frames), an unrolled
//   interior form drops the band and diagonal tests (K <= 4; wider, the
//   unrolled code outgrows the instruction cache).
// - Warps of one item form a one-way pipeline. A column needs only its left
//   neighbour and itself in the row before, so warp w needs from warp w-1
//   one value per frame, its last column, and nothing from warp w+1. Lane
//   31 of warp w-1 puts it in a ring of RING_FRAMES slots in shared memory;
//   every PUBLISH frames each warp publishes its frame count (st.release)
//   and waits (ld.acquire) only if its left neighbour has not published
//   the frames of the batch or its right neighbour has not read the slots
//   it is about to reuse. A warp publishes its own count before it waits,
//   so no two warps wait on each other; each runs about PUBLISH frames
//   behind the one to its left. A wait that never ends traps.
// - Scores arrive ahead of use: each lane copies its own K cells of frame
//   y + S - 1 into its warp's ring of S frames with cp.async while it
//   computes frame y and reads frame y + 1's back into registers (K <= 8),
//   so neither the copy's latency nor the shared-memory read's is on the
//   frame's chain. It reads back only what it copied, so the ring needs
//   no barrier. The warps that hold no columns (one helper warp at least)
//   prefetch the item's scores into L2 first.
// - Decisions in shared memory where they fit: each frame's ballots are
//   the move-left bits 32 to a word in the natural order (word x / 32, bit
//   x % 32), t_y * W * K words per item (8 KB at [512, 128], 96 KB at
//   [1500, 512]). Where they do not fit beside the rings (the wrapper
//   decides by shape), they go to a scratch [b, t_y, W * K] in device
//   memory instead, the same layout.
// - A walk that does not wait for memory. One thread walks back; the index
//   falls by at most one per row, so over the next WALK_AHEAD rows it stays
//   within one word or the word below it. The walk loads both candidate
//   words WALK_AHEAD rows ahead into registers, and a step is four
//   dependent integer operations on them, from shared or device memory
//   alike. It records each row's index in shared memory; after each
//   WALK_CHUNK rows the block writes their 1.0s (one thread's scattered
//   stores to device memory cost more than the walk itself).
// - The helpers write the path's zeros while the frames run, in 16-byte
//   stores; the barrier before the walk orders them before the 1.0s.
//
// The TPU kernel's frame-major layout, sublane batch padding, lane padding
// to 128 and 4-frame DMA chunks are tiling of that machine and are not
// carried over: neg_cent is read in its natural [b, t_y, t_x] layout.
//
// A second entry point, `mas_link_probe`, runs a chain of one kind of
// dependent link (an fmax+add in registers, a shuffle + fmax + add, a
// shared-memory load, one step of the walk, a block barrier); timed from
// the host it gives the latency of one link, from which the chain bounds
// beside the bytes bound are computed (chip_smoke.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NEG (-1e9f)
#define FULL 0xffffffffu
#define MAX_WARPS 16         // warps a block may have: compute warps + helpers
#define RING_FRAMES 64       // boundary slots between neighbouring warps
#define PUBLISH 16           // frames between a warp's syncs with its neighbours
#define WALK_AHEAD 8         // rows the walk loads its decision words ahead
#define WALK_CHUNK 1024      // rows walked before the block writes their 1.0s
#define SMEM_MAX 232448      // dynamic shared memory a block may take (227 KB)
#define SPIN_LIMIT 4000000000LL  // cycles a warp waits for a neighbour, then traps
#define MAX_DEVICES 64

// frames of scores in flight per warp, by K: ~0.5-1 us of frames ahead
__host__ __device__ constexpr int stages(int k) {
    return k <= 2 ? 32 : (k == 4 ? 16 : (k <= 16 ? 8 : 4));
}

// shared memory of one block: the warps' score rings, the boundary rings,
// the progress counters and (dec_in_smem) the decision words
static size_t smem_bytes(int T_y, int k, int warps, int dec_in_smem) {
    size_t words = (size_t)warps * stages(k) * 32 * k + (size_t)warps * RING_FRAMES
                   + MAX_WARPS;
    if (dec_in_smem) words += (size_t)T_y * warps * k;
    return 4 * words;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// a read of the score ring: volatile asm, so that it stays after the
// cp.async wait before it (volatile asm keeps its order)
__device__ __forceinline__ float ld_ring(const float* p) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(v) : "r"((unsigned)__cvta_generic_to_shared(p)));
    return v;
}
// v >> s with the shift clamped at 32 (PTX shr): 0 for s >= 32, as unsigned
__device__ __forceinline__ uint32_t shr_clamp(uint32_t v, uint32_t s) {
    uint32_t r;
    asm("shr.b32 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(s));
    return r;
}
// *p = v where pred holds, as a predicated store: a branch around the
// store would make the warp diverge and reconverge every frame
__device__ __forceinline__ void store_if(bool pred, uint32_t* p, uint32_t v) {
    asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q st.u32 [%0], %1;\n}\n"
                 ::"l"(p), "r"(v), "r"((uint32_t)pred) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const float* p) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.cta.shared.b32 [%0], %1;\n"
                 ::"r"((unsigned)__cvta_generic_to_shared(p)), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
                 : "=r"(v) : "r"((unsigned)__cvta_generic_to_shared(p)) : "memory");
    return v;
}
// the counter once it is at least `need`; a neighbour that never gets
// there (a fault) traps instead of hanging the card
__device__ __forceinline__ int wait_at_least(const int* p, int need) {
    int v = ld_acquire(p);
    if (v >= need) return v;
    const long long t0 = clock64();
    while ((v = ld_acquire(p)) < need)
        if (clock64() - t0 > SPIN_LIMIT) __trap();
    return v;
}

template <bool B>
struct Path {
    static constexpr bool edge = B;
};

// grid: b blocks; block: 32 * (W + 1) threads; dynamic shared memory:
// smem_bytes(T_y, K, W, dec == nullptr). `dec` is the device scratch
// [b, T_y, W * K] or nullptr for decisions in shared memory.
template <int K>
__global__ void __launch_bounds__(MAX_WARPS * 32)
mas_kernel(const float* __restrict__ neg, const int* __restrict__ t_ys,
           const int* __restrict__ t_xs, float* __restrict__ path,
           uint32_t* dec_scratch, int T_y, int T_x, int W) {
    constexpr int S = stages(K);
    // scores read one frame ahead of use, off the chain; at K >= 16 the
    // registers for that are not there, and a frame is long enough anyway
    constexpr bool AHEAD = K <= 8;
    constexpr int SLAB = 32 * K;  // columns of one warp
    constexpr int D = WALK_AHEAD;
    static_assert(S * SLAB >= WALK_CHUNK && WALK_CHUNK % D == 0,
                  "one warp's ring holds a chunk of the walk's indices");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* ring = reinterpret_cast<float*>(smem_raw);
    float* bnd = ring + (size_t)W * S * SLAB;
    int* prog = reinterpret_cast<int*>(bnd + W * RING_FRAMES);
    uint32_t* dec_smem = reinterpret_cast<uint32_t*>(prog + MAX_WARPS);

    const int bi = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int ty = min(max(t_ys[bi], 0), T_y);
    const int tx = min(max(t_xs[bi], 0), T_x);
    const int frames = (tx > 0) ? ty : 0;
    const int WK = W * K;  // decision words per row
    const int w_item = min(W, (tx + SLAB - 1) / SLAB);  // warps with columns < tx
    const float* negb = neg + (size_t)bi * T_y * T_x;
    float* pathb = path + (size_t)bi * T_y * T_x;
    uint32_t* dec = dec_scratch ? dec_scratch + (size_t)bi * T_y * WK : dec_smem;

    if (threadIdx.x < MAX_WARPS) prog[threadIdx.x] = 0;
    __syncthreads();

    if (warp < w_item) {
        const int base = warp * SLAB + lane;  // column of element k: base + 32 k
        const int dty = ty - tx;  // the band's low edge is y - dty
        const int wmin = warp * SLAB, wlast = min(wmin + SLAB, tx) - 1;
        const bool has_right = warp + 1 < w_item;
        uint32_t valid = 0;  // bit k: column base + 32 k < tx
#pragma unroll
        for (int k = 0; k < K; ++k) valid |= (uint32_t)(base + 32 * k < tx) << k;
        const float* src = negb + base + (size_t)(S - 1) * T_x;  // frame y + S - 1
        float* lane_ring = ring + (size_t)warp * S * SLAB + lane;
        uint32_t* dec_row = dec + warp * K + lane;  // frame y's words
        const float* left_slots = bnd + (warp > 0 ? warp - 1 : 0) * RING_FRAMES;
        float* my_slots = bnd + warp * RING_FRAMES;
        auto publish = [&](int done) {
            if (lane == 31) st_release(&prog[warp], done);
        };
        auto copy = [&](const float* s, int f) {
            float* d = lane_ring + (f & (S - 1)) * SLAB;
#pragma unroll
            for (int k = 0; k < K; ++k)
                if ((valid >> k) & 1u) cp_async4(d + 32 * k, s + 32 * k);
        };
        float cur[K], raw[K];  // row y - 1; frame y's scores
#pragma unroll
        for (int k = 0; k < K; ++k) cur[k] = NEG;

        // one frame: row y from row y - 1. The interior form holds where no
        // column < t_x of this warp is on or above the diagonal or below
        // the band's low edge: there v = neg + max(left, here) and
        // move-left = here < left
        // edge: v[y-1] at the column left of the slab
        auto frame = [&](int y, float edge, auto path_tag) {
            constexpr bool EDGE = decltype(path_tag)::edge;
            if (y + S - 1 < frames) copy(src, y + S - 1);
            src += T_x;
            cp_async_commit();
            // this lane's copies of frame y + 1 (AHEAD) or y landed
            cp_async_wait<AHEAD ? S - 2 : S - 1>();
            float next[K];  // AHEAD: frame y + 1's scores, read while frame y computes
            const float* ring_next = lane_ring + ((y + AHEAD) & (S - 1)) * SLAB;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (AHEAD) next[k] = ld_ring(ring_next + 32 * k);
                else raw[k] = ld_ring(ring_next + 32 * k);
            }
            // the left neighbours in row y-1: lane L - 1's element k, and
            // for lane 0 lane 31's element k - 1 (lane 31 sends that one)
            float left[K];
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float v = (lane == 31 && k > 0) ? cur[k > 0 ? k - 1 : 0] : cur[k];
                left[k] = __shfl_sync(FULL, v, (lane + 31) & 31);
            }
            if (lane == 0) left[0] = edge;
            uint32_t word = 0;
            if constexpr (EDGE) {
                const int lo = max(0, y - dty), hi = min(tx, y + 1);
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const int x = base + 32 * k;
                    const bool diag = x == y;
                    const float here = cur[k];
                    const uint32_t moves = __ballot_sync(FULL, diag || here < left[k]);
                    if (lane == k) word = moves;
                    const float v_cur = diag ? NEG : here;
                    const float best = (x >= lo && x < hi) ? fmaxf(left[k], v_cur) : 0.f;
                    cur[k] = raw[k] + best;
                }
            } else {
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const uint32_t moves = __ballot_sync(FULL, cur[k] < left[k]);
                    if (lane == k) word = moves;
                    cur[k] = raw[k] + fmaxf(left[k], cur[k]);
                }
            }
            // the walk never moves left from x = 0: a clear bit there spares
            // it the test
            if (warp == 0 && lane == 0) word &= ~1u;
            store_if(lane < K, dec_row, word);
            dec_row += WK;
            if (has_right && lane == 31) my_slots[y & (RING_FRAMES - 1)] = cur[K - 1];
            if (AHEAD) {
#pragma unroll
                for (int k = 0; k < K; ++k) raw[k] = next[k];
            }
        };

        for (int f = 0; f < S - 1; ++f) {
            if (f < frames) copy(negb + base + (size_t)f * T_x, f);
            cp_async_commit();
        }
        if (AHEAD) {
            cp_async_wait<S - 2>();  // frame 0 landed
#pragma unroll
            for (int k = 0; k < K; ++k) raw[k] = ld_ring(lane_ring + 32 * k);
        }
        int left_ready = 0;  // frames of warp - 1 known to be published
        int right_read = 0;  // frames warp + 1 is known to have finished
        for (int y0 = 0; y0 < frames; y0 += PUBLISH) {
            const int yend = min(y0 + PUBLISH, frames);
            publish(y0);  // before any wait, so no two warps wait on each other
            // frames y0 .. yend-1 read warp - 1's frames up to yend - 2
            if (warp > 0 && left_ready < yend - 1)
                left_ready = wait_at_least(&prog[warp - 1], yend - 1);
            // frame f's slot held frame f - RING_FRAMES, which warp + 1
            // reads in its frame f - RING_FRAMES + 1
            if (has_right && right_read < yend - RING_FRAMES + 1)
                right_read = wait_at_least(&prog[warp + 1], yend - RING_FRAMES + 1);
            // (unrolled, the interior form outgrows the instruction cache
            // beyond K = 4)
            if (K <= 4 && yend - y0 == PUBLISH && wlast < y0 && wmin >= yend - 1 - dty) {
                // y0 > 0 here; the batch's edges come first, off the chain
                float edges[PUBLISH];
#pragma unroll
                for (int j = 0; j < PUBLISH; ++j)
                    edges[j] = warp == 0 ? NEG : left_slots[(y0 + j - 1) & (RING_FRAMES - 1)];
#pragma unroll
                for (int j = 0; j < PUBLISH; ++j) frame(y0 + j, edges[j], Path<false>());
            } else {
                for (int y = y0; y < yend; ++y) {
                    float edge = (warp == 0 && y == 0) ? 0.f : NEG;
                    if (warp > 0 && y > 0) edge = left_slots[(y - 1) & (RING_FRAMES - 1)];
                    frame(y, edge, Path<true>());
                }
            }
        }
        cp_async_wait<0>();
        publish(frames);
    } else {
        // helpers: bring the item's scores into L2 ahead of the warps'
        // copies, then zero the item's path, [T_y, T_x], in 16-byte stores
        const int nh = 32 * (blockDim.x / 32 - w_item);
        const int hid = threadIdx.x - 32 * w_item;
        const size_t lines = ((size_t)frames * T_x + 31) / 32;  // 128-byte lines
        for (size_t i = hid; i < lines; i += nh) prefetch_l2(negb + 32 * i);
        const size_t n = (size_t)T_y * T_x;
        const size_t head = min(n, (size_t)((16 - ((uintptr_t)pathb & 15)) & 15) / 4);
        if ((size_t)hid < head) pathb[hid] = 0.f;
        float4* body = reinterpret_cast<float4*>(pathb + head);
        const size_t n4 = (n - head) / 4;
        for (size_t i = hid; i < n4; i += nh) body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (size_t i = head + 4 * n4 + hid; i < n; i += nh) pathb[i] = 0.f;
    }
    __syncthreads();  // decisions and zeros before the walk

    // The walk: one thread records each row's index in shared memory (the
    // score rings, idle now), WALK_CHUNK rows at a time; then the block
    // writes those rows' 1.0s. Slot j of the registers serves the rows y
    // with y = ty - 1 - j (mod D): hw is word col of its row and lw the word
    // below, so that the index, which falls by at most one per row, lies
    // in the 64 bits lw:hw, at bit index - cb with cb = 32 * (col - 1). A
    // step is two clamped shifts, an or and a subtraction.
    int* idx = reinterpret_cast<int*>(ring);
    int index = tx - 1;
    uint32_t hw[D], lw[D];
    int cb[D];
    auto load = [&](int j, const uint32_t* row) {
        const int col = index >> 5;
        cb[j] = 32 * col - 32;
        hw[j] = row[col];
        lw[j] = col > 0 ? row[col - 1] : 0u;
    };
    auto step = [&](int j) {
        const uint32_t q = (uint32_t)(index - cb[j]);
        index -= (int)((shr_clamp(lw[j], q) | shr_clamp(hw[j], q - 32)) & 1u);
    };
    if (threadIdx.x == 0 && frames > 0) {  // t_x = 0: no walk, and index -1
#pragma unroll
        for (int j = 0; j < D; ++j)
            if (frames - 1 - j >= 0) load(j, dec + (size_t)(frames - 1 - j) * WK);
    }
    for (int hi = frames - 1; hi >= 0; hi -= WALK_CHUNK) {  // hi: a slot-0 row
        const int lo = max(hi - WALK_CHUNK + 1, 0);
        if (threadIdx.x == 0) {
            for (int y0 = hi; y0 >= lo; y0 -= D) {
                int* out = idx + (y0 - lo);
                if (y0 - D + 1 >= lo && y0 >= 2 * D - 1) {  // no row or reload out of range
                    const uint32_t* next = dec + (size_t)(y0 - D) * WK;
#pragma unroll
                    for (int j = 0; j < D; ++j) {
                        out[-j] = index;
                        step(j);
                        load(j, next);
                        next -= WK;
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < D; ++j) {
                        const int y = y0 - j;
                        if (y < lo) break;
                        out[-j] = index;
                        step(j);
                        if (y >= D) load(j, dec + (size_t)(y - D) * WK);
                    }
                }
            }
        }
        __syncthreads();
        for (int y = lo + threadIdx.x; y <= hi; y += blockDim.x)
            pathb[(size_t)y * T_x + idx[y - lo]] = 1.f;
        __syncthreads();
    }
}

// One warp (kinds 0-3) or block (kind 4) runs `steps` dependent links of
// one kind: 0 fmax + add in registers, 1 a shuffle + fmax + add, 2 a
// shared-memory load (pointer chase), 3 one step of the walk on register
// words, 4 a shared-memory step closed by __syncthreads(). `out` holds
// blockDim.x floats, zero on entry.
__global__ void link_probe_kernel(float* out, int steps, int kind) {
    __shared__ int chase[1024];
    __shared__ float buf[2][1024];
    const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
    const float c = out[tid];  // 0, unknown to the compiler
    float x = (float)tid;
    if (kind == 0) {
        for (int s = 0; s < steps; ++s) x = fmaxf(x, c) + 1.f;
    } else if (kind == 1) {
        for (int s = 0; s < steps; ++s)
            x = fmaxf(__shfl_sync(FULL, x, (lane + 31) & 31), x) + 1.f;
    } else if (kind == 2) {
        for (int i = tid; i < 1024; i += nt) chase[i] = (i + 33 + (int)c) & 1023;
        __syncthreads();
        int j = tid;
        for (int s = 0; s < steps; ++s) j = chase[j];
        x = (float)j;
    } else if (kind == 3) {
        // the walk's step on two words lw:hw, and a mask that keeps the
        // index in their 64 bits
        const uint32_t lw = 0x55555555u + __float_as_uint(c), hw = ~lw;
        int index = 63;
        for (int s = 0; s < steps; ++s) {
            const uint32_t q = (uint32_t)index;
            index = (index - (int)((shr_clamp(lw, q) | shr_clamp(hw, q - 32)) & 1u)) & 63;
        }
        x = (float)index;
    } else {
        buf[0][tid] = x;
        __syncthreads();
        for (int s = 0; s < steps; ++s) {
            const float left = buf[s & 1][(tid + nt - 1) % nt];
            buf[(s + 1) & 1][tid] = fmaxf(left, buf[s & 1][tid]) + 1.f;
            __syncthreads();
        }
        x = buf[steps & 1][tid];
    }
    out[tid] = x;
}

static cudaError_t use_device(int device) {
    int cur;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    return err;
}

template <int K>
static cudaError_t launch(const float* neg, const int* t_ys, const int* t_xs,
                          float* path, uint32_t* dec, int b, int T_y, int T_x,
                          int warps, size_t smem, int device, cudaStream_t stream) {
    static bool attr_set[MAX_DEVICES];
    if (!attr_set[device]) {
        cudaError_t err = cudaFuncSetAttribute(
            mas_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return err;
        attr_set[device] = true;
    }
    mas_kernel<K><<<b, 32 * (warps + 1), smem, stream>>>(neg, t_ys, t_xs, path, dec,
                                                         T_y, T_x, warps);
    return cudaGetLastError();
}

// dec: the scratch [b, T_y, warps * k] int32, or nullptr to keep the
// decisions in shared memory. k: columns per lane (1, 2, 4, 8, 16, 32);
// warps: compute warps per item, 32 * k * warps >= T_x. plan_smem: the
// caller's figure for the block's shared memory (ops/align.py plans by
// it), refused unless it is smem_bytes' own.
extern "C" int mas_fwd(const float* neg, const int* t_ys, const int* t_xs,
                       float* path, uint32_t* dec, int b, int T_y, int T_x,
                       int k, int warps, int plan_smem, int device, void* stream) {
    if (device < 0 || device >= MAX_DEVICES || b < 1 || T_y < 1 || T_x < 1
        || warps < 1 || warps + 1 > MAX_WARPS || (long long)32 * k * warps < T_x)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(T_y, k, warps, dec == nullptr);
    if (smem > SMEM_MAX || smem != (size_t)plan_smem) return (int)cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    switch (k) {
        case 1: return (int)launch<1>(neg, t_ys, t_xs, path, dec, b, T_y, T_x, warps, smem, device, s);
        case 2: return (int)launch<2>(neg, t_ys, t_xs, path, dec, b, T_y, T_x, warps, smem, device, s);
        case 4: return (int)launch<4>(neg, t_ys, t_xs, path, dec, b, T_y, T_x, warps, smem, device, s);
        case 8: return (int)launch<8>(neg, t_ys, t_xs, path, dec, b, T_y, T_x, warps, smem, device, s);
        case 16: return (int)launch<16>(neg, t_ys, t_xs, path, dec, b, T_y, T_x, warps, smem, device, s);
        case 32: return (int)launch<32>(neg, t_ys, t_xs, path, dec, b, T_y, T_x, warps, smem, device, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// kind: see link_probe_kernel; threads: 32 for kinds 0-3, 32..1024 (a
// multiple of 32) for kind 4.
extern "C" int mas_link_probe(float* out, int steps, int kind, int threads,
                              int device, void* stream) {
    if (kind < 0 || kind > 4 || threads < 32 || threads > 1024 || threads % 32)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return (int)err;
    link_probe_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(out, steps, kind);
    return (int)cudaGetLastError();
}
