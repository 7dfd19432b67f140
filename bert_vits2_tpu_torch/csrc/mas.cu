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
// What bounds it on the card: not bytes (neg_cent is read once, the path
// written once: ~8 MB at [16, 512, 128], 2.5 us at 3.35 TB/s) and not
// operations, but the chain of t_y dependent rows followed by t_y dependent
// steps of the walk. The design keeps each link of that chain short:
//
// - one thread block per batch item, threads across x (a loop when t_x
//   exceeds the block), so the items run side by side on separate SMs;
// - the previous row lives in shared memory (two buffers, swapped), with one
//   __syncthreads() per frame;
// - neg_cent rows stream from device memory into a shared-memory ring with
//   cp.async, STAGES - 1 frames ahead, so a frame never waits for device
//   memory; a thread reads back only the ring cells it copied itself, so the
//   ring needs no barrier of its own;
// - each frame's move-left decisions are packed 32 to a word with
//   __ballot_sync and written to a scratch [b, t_y, ceil(t_x / 32)] in device
//   memory (it stays in L2 for the walk);
// - the block zero-fills its slice of the path while it runs the frames
//   (stores do not stall the chain), and one thread walks back after the
//   last frame, so no separate memset pass is needed.
//
// The TPU kernel's frame-major layout, sublane batch padding, lane padding
// to 128 and 4-frame DMA chunks are tiling of that machine and are not
// carried over: neg_cent is read in its natural [b, t_y, t_x] layout.
//
// A second entry point, `mas_sync_probe`, runs a chain of dependent
// shared-memory steps separated by __syncthreads(); timed from the host it
// gives the latency of one link, the second figure beside the bytes bound.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG (-1e9f)
#define STAGES 4
#define MAX_THREADS 1024

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

// grid: b blocks; block: nt threads (a multiple of 32);
// dynamic shared memory: (2 + STAGES) * T_x floats.
__global__ void mas_kernel(const float* __restrict__ neg,
                           const int* __restrict__ t_ys,
                           const int* __restrict__ t_xs,
                           float* __restrict__ path,
                           uint32_t* __restrict__ dec,
                           int T_y, int T_x, int W) {
    extern __shared__ float smem[];
    float* cur = smem;
    float* nxt = smem + T_x;
    float* ring = smem + 2 * T_x;

    const int bi = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int ty = min(max(t_ys[bi], 0), T_y);
    const int tx = min(max(t_xs[bi], 0), T_x);
    const float* negb = neg + (size_t)bi * T_y * T_x;
    float* pathb = path + (size_t)bi * T_y * T_x;
    uint32_t* decb = dec + (size_t)bi * T_y * W;
    const int frames = (tx > 0) ? ty : 0;

    for (int x = tid; x < tx; x += nt) cur[x] = NEG;
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < frames)
            for (int x = tid; x < tx; x += nt)
                cp_async4(&ring[s * T_x + x], &negb[(size_t)s * T_x + x]);
        cp_async_commit();
    }
    __syncthreads();

    for (int y = 0; y < frames; ++y) {
        const int yn = y + STAGES - 1;
        if (yn < frames)
            for (int x = tid; x < tx; x += nt)
                cp_async4(&ring[(yn % STAGES) * T_x + x],
                          &negb[(size_t)yn * T_x + x]);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();  // this thread's copies of frame y landed

        for (int x = tid; x < T_x; x += nt) pathb[(size_t)y * T_x + x] = 0.f;

        const float* raw = ring + (y % STAGES) * T_x;
        const int lo = max(0, tx + y - ty), hi = min(tx, y + 1);
        for (int x0 = 0; x0 < tx; x0 += nt) {  // x0 is uniform: whole warps vote
            const int x = x0 + tid;
            const bool in = x < tx;
            const float here = in ? cur[x] : NEG;
            const float left = (in && x > 0) ? cur[x - 1] : NEG;
            const uint32_t word =
                __ballot_sync(0xffffffffu, in && (x == y || here < left));
            if (in) {
                if ((tid & 31) == 0) decb[(size_t)y * W + (x >> 5)] = word;
                const float v_prev = (x == 0) ? (y == 0 ? 0.f : NEG) : left;
                const float v_cur = (x == y) ? NEG : here;
                const float best = (x >= lo && x < hi) ? fmaxf(v_prev, v_cur) : 0.f;
                nxt[x] = raw[x] + best;
            }
        }
        __syncthreads();
        float* t = cur; cur = nxt; nxt = t;
    }

    // rows the frames did not reach: past t_y, or every row of an empty item
    for (size_t i = (size_t)frames * T_x + tid; i < (size_t)T_y * T_x; i += nt)
        pathb[i] = 0.f;
    __syncthreads();  // zeros and decisions are visible to the walking thread

    if (tid == 0 && frames > 0) {
        int index = tx - 1;
        for (int y = ty - 1; y >= 0; --y) {
            pathb[(size_t)y * T_x + index] = 1.f;
            if (index != 0 &&
                ((decb[(size_t)y * W + (index >> 5)] >> (index & 31)) & 1u))
                --index;
        }
    }
}

__global__ void sync_probe_kernel(float* out, int steps) {
    __shared__ float buf[2][MAX_THREADS];
    const int tid = threadIdx.x, nt = blockDim.x;
    buf[0][tid] = (float)tid;
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
        const float left = buf[s & 1][(tid + nt - 1) % nt];
        buf[(s + 1) & 1][tid] = fmaxf(left, buf[s & 1][tid]) + 1.f;
        __syncthreads();
    }
    out[tid] = buf[steps & 1][tid];
}

static int block_threads(int T_x) {
    int nt = ((T_x + 31) / 32) * 32;
    return nt < 32 ? 32 : (nt > MAX_THREADS ? MAX_THREADS : nt);
}

extern "C" int mas_fwd(const float* neg, const int* t_ys, const int* t_xs,
                       float* path, uint32_t* dec, int b, int T_y, int T_x,
                       int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int W = (T_x + 31) / 32;
    const size_t smem = (size_t)(2 + STAGES) * T_x * sizeof(float);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(mas_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    mas_kernel<<<b, block_threads(T_x), smem, (cudaStream_t)stream>>>(
        neg, t_ys, t_xs, path, dec, T_y, T_x, W);
    return (int)cudaGetLastError();
}

// One block of `threads` threads runs `steps` dependent shared-memory steps,
// each closed by __syncthreads(); `out` holds `threads` floats.
extern "C" int mas_sync_probe(float* out, int steps, int threads, int device,
                              void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (threads < 32 || threads > MAX_THREADS || threads % 32) return 1;
    sync_probe_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(out, steps);
    return (int)cudaGetLastError();
}
