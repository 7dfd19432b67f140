// Banded relative-position self-attention outside the tensor-core kernels'
// range: a head wider than 128 channels, a window above 4, or more than
// 65535 (batch, head) pairs.
//
// The same four functions as banded_attn.cu (K1, inference and train mode)
// and banded_attn_bwd.cu (B5, B6), for the shapes those kernels do not
// take; ops/attention.py picks the variant by shape before any launch. They
// replace the same TPU kernels (`_attn_fwd_kernel`, `_attn_bwd_q_kernel`,
// `_attn_bwd_k_kernel` in bert_vits2_tpu/ops/attention_pallas.py), which pad
// the head width to a multiple of 128 and the band table to a multiple of 8
// and so take any d and w. The formulas, the masking of keys only, the
// -1e4 fill and the position-hash dropout are those of banded_attn.cu and
// banded_attn_bwd.cu (see their notes).
//
// Each also takes bf16 operands (`*_bf16`: K1's, B5's and B6's bf16 modes
// outside their range): q, k, v, mask, ek, ev, g and the outputs bf16, the
// row statistics m, l, D and the band scratch fp32. The loads convert to
// fp32 and the arithmetic is the fp32 kernels'; the values that multiply a
// t-long row are rounded to bf16 where the TPU kernels round them (P where
// it multiplies v; ds where it multiplies k and q; p*ks where it
// multiplies g), the band terms take the fp32 values, and the outputs are
// rounded to bf16 (dek and dev from their fp32 sums).
//
// What bounds them: nothing the main path measures. The V2.3 widths (d =
// 96, w = 4) never reach them, so they are written to be exact and simple,
// on the fp32 cores:
//
// - One block of 128 threads per (query row, batch*head) for the forward
//   and B5, per (key, batch*head) for B6; a grid-stride loop over
//   batch*head lifts the 65535 limit of the grid's y dimension.
// - The other side is walked in tiles of 128: one warp per key (or query
//   row) of the tile computes its dot products over d (lanes take every
//   32nd channel, coalesced, then a shuffle reduction); then each thread
//   owns channels x, x + 128, ... of the row's accumulators in shared
//   memory and adds the tile's weights times the tile's rows (coalesced
//   along x). Any d up to MAX_D; any w (the band holds 2w + 1 entries in
//   shared memory).
// - The forward runs an online softmax over the tiles: row max and sum
//   rescaled per tile, the band's probabilities carried beside the output.
// - dek and dev (sums over every row of every batch*head) are not added
//   with atomics: B5 writes each row's band entries of ds and p*ks to a
//   scratch [b*h*t, 2w+1], and a second kernel sums them against q and g
//   in row order, a thread per (channel, band entry): the same gradient on
//   every run.

#include <limits.h>

#include "banded_attn_hash.cuh"
#include "banded_attn_tc.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS;     // keys (or query rows) per tile
constexpr int MAX_D = 8192;       // widest head: B6 keeps four rows of d in shared memory
constexpr int MAX_GRID_Y = 65535;
constexpr unsigned FULLMASK = 0xffffffffu;

struct Drop {
  bool on;
  uint32_t thr, seed;
  float scale;
  uint32_t salt_base, salt_stride;
};

// keep(i, j) / (1 - p_drop), or 1 without dropout; batch row b, head hh of
// bh = b * h + hh salted salt_base + b * salt_stride + hh
__device__ __forceinline__ float keep_scale(const Drop& dr, int i, int j, int bh, int h) {
  if (!dr.on) return 1.f;
  const int b = bh / h;
  const uint32_t salt = dr.salt_base + (uint32_t)b * dr.salt_stride + (uint32_t)(bh - b * h);
  return hash_keep((uint32_t)i, (uint32_t)j, salt, dr.seed, dr.thr) ? dr.scale : 0.f;
}

// a . b over n values by one warp (each float or bf16); every lane gets the sum
template <typename A, typename B>
__device__ __forceinline__ float warp_dot(const A* a, const B* b, int n, int lane) {
  float s = 0.f;
  for (int x = lane; x < n; x += 32) s = fmaf(to_f(a[x]), to_f(b[x]), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULLMASK, s, o);
  return s;
}

// max (MAX) or sum of one value per thread over the block, in a fixed
// order; red: WARPS floats of shared memory
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(FULLMASK, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red is free from its last use
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// grid (t, min(b*h, 65535)); shared memory: 2d + 2(2w+1) + TILE + WARPS
// floats; T: the operands' type (float or bf16)
template <bool TRAIN, typename T>
__global__ void __launch_bounds__(THREADS)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ mask,
                const T* __restrict__ ek, const T* __restrict__ ev,
                T* __restrict__ out, float* __restrict__ m_out,
                float* __restrict__ l_out, int bhs, int h, int t, int d, int w,
                Drop dr) {
  extern __shared__ float sm[];
  const int nb = 2 * w + 1;
  float* qs = sm;          // [d] the query row
  float* acc = qs + d;     // [d] sum_j p'_j v_j, rescaled with the row max
  float* bl = acc + d;     // [nb] band logits q_i . ek[c]
  float* pb = bl + nb;     // [nb] band probabilities p'_{i, i+c-w}, rescaled
  float* sc = pb + nb;     // [TILE] the tile's logits, then its p'
  float* red = sc + TILE;  // [WARPS]
  const int i = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int bh = blockIdx.y; bh < bhs; bh += gridDim.y) {
    const size_t base = (size_t)bh * t * d;
    const T* kb = k + base;
    const T* vb = v + base;
    const T* mrow = mask + (size_t)(bh / h) * t;
    for (int x = tid; x < d; x += THREADS) {
      qs[x] = to_f(q[base + (size_t)i * d + x]);
      acc[x] = 0.f;
    }
    for (int c = tid; c < nb; c += THREADS) pb[c] = 0.f;
    __syncthreads();
    for (int c = warp; c < nb; c += WARPS) {
      const float s = warp_dot(qs, ek + (size_t)c * d, d, lane);
      if (lane == 0) bl[c] = s;
    }
    __syncthreads();
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < t; j0 += TILE) {
      const int n = min(TILE, t - j0);
      for (int jj = warp; jj < n; jj += WARPS) {
        const int j = j0 + jj;
        float s = warp_dot(qs, kb + (size_t)j * d, d, lane);
        if (lane == 0) {
          const int c = j - i + w;
          if (c >= 0 && c < nb) s += bl[c];
          sc[jj] = to_f(mrow[j]) == 0.f ? NEG_FILL : s;
        }
      }
      __syncthreads();
      const float m_new = fmaxf(m, block_reduce<true>(tid < n ? sc[tid] : -INFINITY, red));
      const float alpha = expf(m - m_new);
      float p = tid < n ? expf(sc[tid] - m_new) : 0.f;
      l = l * alpha + block_reduce<false>(p, red);  // the undropped sum
      if (TRAIN && tid < n) p *= keep_scale(dr, i, j0 + tid, bh, h);
      if (tid < n) sc[tid] = p;  // a thread rewrites only its own entry
      __syncthreads();
      for (int c = tid; c < nb; c += THREADS) {
        const int jj = i + c - w - j0;
        pb[c] = pb[c] * alpha + (jj >= 0 && jj < n ? sc[jj] : 0.f);
      }
      for (int x = tid; x < d; x += THREADS) {
        float a = acc[x] * alpha;
        // P as the operand type holds it where it multiplies v
        for (int jj = 0; jj < n; ++jj)
          a = fmaf(rnd<T>(sc[jj]), to_f(vb[(size_t)(j0 + jj) * d + x]), a);
        acc[x] = a;
      }
      m = m_new;
      __syncthreads();  // sc and pb before the next tile
    }
    for (int x = tid; x < d; x += THREADS) {
      float a = acc[x];
      for (int c = 0; c < nb; ++c) a = fmaf(pb[c], to_f(ev[(size_t)c * d + x]), a);
      out[base + (size_t)i * d + x] = from_f<T>(a / l);
    }
    if (TRAIN && tid == 0) {
      m_out[(size_t)bh * t + i] = m;
      l_out[(size_t)bh * t + i] = l;
    }
    __syncthreads();  // shared memory before the next batch*head
  }
}

// B5: dq and each row's band entries of ds and p*ks (for dek, dev).
// grid (t, min(b*h, 65535)); shared memory: 3d + 4(2w+1) + TILE floats
template <typename T>
__global__ void __launch_bounds__(THREADS)
wide_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ mask,
                  const T* __restrict__ ek, const T* __restrict__ ev,
                  const T* __restrict__ g, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ D,
                  T* __restrict__ dq, float* __restrict__ band_ds,
                  float* __restrict__ band_pd, int bhs, int h, int t, int d, int w,
                  Drop dr) {
  extern __shared__ float sm[];
  const int nb = 2 * w + 1;
  float* qs = sm;         // [d]
  float* gs = qs + d;     // [d]
  float* acc = gs + d;    // [d] sum_j ds_j k_j
  float* bl = acc + d;    // [nb] q_i . ek[c]
  float* gl = bl + nb;    // [nb] g_i . ev[c]
  float* bds = gl + nb;   // [nb] ds_{i, i+c-w}
  float* bpd = bds + nb;  // [nb] p*ks at (i, i+c-w)
  float* ds = bpd + nb;   // [TILE]
  const int i = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int bh = blockIdx.y; bh < bhs; bh += gridDim.y) {
    const size_t base = (size_t)bh * t * d, row = (size_t)bh * t + i;
    const T* kb = k + base;
    const T* vb = v + base;
    const T* mrow = mask + (size_t)(bh / h) * t;
    for (int x = tid; x < d; x += THREADS) {
      qs[x] = to_f(q[base + (size_t)i * d + x]);
      gs[x] = to_f(g[base + (size_t)i * d + x]);
      acc[x] = 0.f;
    }
    for (int c = tid; c < nb; c += THREADS) bds[c] = bpd[c] = 0.f;
    __syncthreads();
    for (int c = warp; c < nb; c += WARPS) {
      const float a = warp_dot(qs, ek + (size_t)c * d, d, lane);
      const float b = warp_dot(gs, ev + (size_t)c * d, d, lane);
      if (lane == 0) bl[c] = a, gl[c] = b;
    }
    __syncthreads();
    const float mi = m[row], li = l[row], Di = D[row];
    for (int j0 = 0; j0 < t; j0 += TILE) {
      const int n = min(TILE, t - j0);
      for (int jj = warp; jj < n; jj += WARPS) {
        const int j = j0 + jj;
        float s = warp_dot(qs, kb + (size_t)j * d, d, lane);
        float gv = warp_dot(gs, vb + (size_t)j * d, d, lane);
        if (lane == 0) {
          const int c = j - i + w;
          const bool band = c >= 0 && c < nb;
          if (band) s += bl[c], gv += gl[c];
          const bool masked = to_f(mrow[j]) == 0.f;
          const float p = expf((masked ? NEG_FILL : s) - mi) / li;
          const float ks = keep_scale(dr, i, j, bh, h);
          const float dsv = masked ? 0.f : p * (gv * ks - Di);
          ds[jj] = dsv;
          if (band) bds[c] = dsv, bpd[c] = p * ks;
        }
      }
      __syncthreads();
      for (int x = tid; x < d; x += THREADS) {
        float a = acc[x];
        // ds as the operand type holds it where it multiplies k
        for (int jj = 0; jj < n; ++jj)
          a = fmaf(rnd<T>(ds[jj]), to_f(kb[(size_t)(j0 + jj) * d + x]), a);
        acc[x] = a;
      }
      __syncthreads();
    }
    for (int x = tid; x < d; x += THREADS) {
      float a = acc[x];
      for (int c = 0; c < nb; ++c) a = fmaf(bds[c], to_f(ek[(size_t)c * d + x]), a);
      dq[base + (size_t)i * d + x] = from_f<T>(a);
    }
    for (int c = tid; c < nb; c += THREADS) {
      band_ds[row * nb + c] = bds[c];
      band_pd[row * nb + c] = bpd[c];
    }
    __syncthreads();
  }
}

// dek[c] = sum_r band_ds[r][c] q_r, dev[c] = sum_r band_pd[r][c] g_r over the
// rows r of every batch*head, in row order (fp32 sums, stored as T). grid
// (ceil(d / 128), 2w+1, 2)
template <typename T>
__global__ void __launch_bounds__(THREADS)
wide_tables_kernel(const T* __restrict__ q, const T* __restrict__ g,
                   const float* __restrict__ band_ds, const float* __restrict__ band_pd,
                   T* __restrict__ dek, T* __restrict__ dev, size_t rows, int d,
                   int nb) {
  const int x = blockIdx.x * THREADS + threadIdx.x, c = blockIdx.y;
  if (x >= d) return;
  const T* src = blockIdx.z ? g : q;
  const float* band = blockIdx.z ? band_pd : band_ds;
  float a[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, added in a fixed order
  size_t r = 0;
  for (; r + 4 <= rows; r += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      a[u] = fmaf(band[(r + u) * nb + c], to_f(src[(r + u) * d + x]), a[u]);
  for (; r < rows; ++r) a[0] = fmaf(band[r * nb + c], to_f(src[r * d + x]), a[0]);
  (blockIdx.z ? dev : dek)[(size_t)c * d + x] = from_f<T>((a[0] + a[1]) + (a[2] + a[3]));
}

// B6: dk, dv of one key. grid (t, min(b*h, 65535)); shared memory:
// 4d + 2 TILE floats
template <typename T>
__global__ void __launch_bounds__(THREADS)
wide_bwd_k_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ mask,
                  const T* __restrict__ ek, const T* __restrict__ ev,
                  const T* __restrict__ g, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ D,
                  T* __restrict__ dk, T* __restrict__ dv, int bhs, int h,
                  int t, int d, int w, Drop dr) {
  extern __shared__ float sm[];
  const int nb = 2 * w + 1;
  float* ks_ = sm;          // [d] the key row
  float* vs = ks_ + d;      // [d] its value row
  float* adk = vs + d;      // [d] sum_i ds_i q_i
  float* adv = adk + d;     // [d] sum_i p'_i g_i
  float* ds = adv + d;      // [TILE]
  float* pd = ds + TILE;    // [TILE]
  const int j = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int bh = blockIdx.y; bh < bhs; bh += gridDim.y) {
    const size_t base = (size_t)bh * t * d, rows = (size_t)bh * t;
    const T* qb = q + base;
    const T* gb = g + base;
    const bool masked = to_f(mask[(size_t)(bh / h) * t + j]) == 0.f;
    for (int x = tid; x < d; x += THREADS) {
      ks_[x] = to_f(k[base + (size_t)j * d + x]);
      vs[x] = to_f(v[base + (size_t)j * d + x]);
      adk[x] = adv[x] = 0.f;
    }
    __syncthreads();
    for (int i0 = 0; i0 < t; i0 += TILE) {
      const int n = min(TILE, t - i0);
      for (int ii = warp; ii < n; ii += WARPS) {
        const int i = i0 + ii;
        const T* qi = qb + (size_t)i * d;
        const T* gi = gb + (size_t)i * d;
        float s = warp_dot(qi, ks_, d, lane);
        float gv = warp_dot(gi, vs, d, lane);
        const int c = j - i + w;
        if (c >= 0 && c < nb) {
          s += warp_dot(qi, ek + (size_t)c * d, d, lane);
          gv += warp_dot(gi, ev + (size_t)c * d, d, lane);
        }
        if (lane == 0) {
          const float p = expf((masked ? NEG_FILL : s) - m[rows + i]) / l[rows + i];
          const float kss = keep_scale(dr, i, j, bh, h);
          ds[ii] = masked ? 0.f : p * (gv * kss - D[rows + i]);
          pd[ii] = p * kss;
        }
      }
      __syncthreads();
      for (int x = tid; x < d; x += THREADS) {
        float a = adk[x], b = adv[x];
        // ds and p*ks as the operand type holds them where they multiply
        // q and g
        for (int ii = 0; ii < n; ++ii) {
          a = fmaf(rnd<T>(ds[ii]), to_f(qb[(size_t)(i0 + ii) * d + x]), a);
          b = fmaf(rnd<T>(pd[ii]), to_f(gb[(size_t)(i0 + ii) * d + x]), b);
        }
        adk[x] = a, adv[x] = b;
      }
      __syncthreads();
    }
    for (int x = tid; x < d; x += THREADS) {
      dk[base + (size_t)j * d + x] = from_f<T>(adk[x]);
      dv[base + (size_t)j * d + x] = from_f<T>(adv[x]);
    }
    __syncthreads();
  }
}

inline bool bad_wide_shape(int b, int h, int t, int d, int w, int device) {
  return d < 1 || d > MAX_D || w < 0 || t < 2 * w || t < 1 || b < 1 || h < 1 ||
         (long long)b * h > INT_MAX || device < 0 || device >= MAXDEV;
}

inline dim3 row_grid(int b, int h, int t) { return dim3(t, min(b * h, MAX_GRID_Y)); }

Drop drop_of(int drop, int thr, int seed, int salt_base, int salt_stride,
             float scale) {
  return Drop{drop != 0, (uint32_t)thr, (uint32_t)seed, scale, (uint32_t)salt_base,
              (uint32_t)salt_stride};
}

template <bool TRAIN, typename T>
int launch_fwd(const T* q, const T* k, const T* v, const T* mask, const T* ek,
               const T* ev, T* out, float* m, float* l, int b, int h, int t, int d,
               int w, Drop dr, int device, void* stream) {
  if (bad_wide_shape(b, h, t, d, w, device)) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  static size_t configured[MAXDEV] = {};
  const size_t bytes = sizeof(float) * (2 * d + 2 * (2 * w + 1) + TILE + WARPS);
  err = allow_smem((const void*)wide_fwd_kernel<TRAIN, T>, bytes, configured, device);
  if (err != cudaSuccess) return (int)err;
  wide_fwd_kernel<TRAIN, T><<<row_grid(b, h, t), THREADS, bytes, (cudaStream_t)stream>>>(
      q, k, v, mask, ek, ev, out, m, l, b * h, h, t, d, w, dr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_q(const T* q, const T* k, const T* v, const T* mask, const T* ek,
                 const T* ev, const T* g, const float* m, const float* l, const float* D,
                 T* dq, float* band_ds, float* band_pd, T* dek, T* dev, int b, int h,
                 int t, int d, int w, Drop dr, int device, void* stream) {
  if (bad_wide_shape(b, h, t, d, w, device)) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  static size_t configured[MAXDEV] = {};
  const int nb = 2 * w + 1;
  const size_t bytes = sizeof(float) * (3 * d + 4 * nb + TILE);
  err = allow_smem((const void*)wide_bwd_q_kernel<T>, bytes, configured, device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  wide_bwd_q_kernel<T><<<row_grid(b, h, t), THREADS, bytes, s>>>(
      q, k, v, mask, ek, ev, g, m, l, D, dq, band_ds, band_pd, b * h, h, t, d, w, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_tables_kernel<T><<<dim3((d + THREADS - 1) / THREADS, nb, 2), THREADS, 0, s>>>(
      q, g, band_ds, band_pd, dek, dev, (size_t)b * h * t, d, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_k(const T* q, const T* k, const T* v, const T* mask, const T* ek,
                 const T* ev, const T* g, const float* m, const float* l, const float* D,
                 T* dk, T* dv, int b, int h, int t, int d, int w, Drop dr, int device,
                 void* stream) {
  if (bad_wide_shape(b, h, t, d, w, device)) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  static size_t configured[MAXDEV] = {};
  const size_t bytes = sizeof(float) * (4 * d + 2 * TILE);
  err = allow_smem((const void*)wide_bwd_k_kernel<T>, bytes, configured, device);
  if (err != cudaSuccess) return (int)err;
  wide_bwd_k_kernel<T><<<row_grid(b, h, t), THREADS, bytes, (cudaStream_t)stream>>>(
      q, k, v, mask, ek, ev, g, m, l, D, dk, dv, b * h, h, t, d, w, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// Inference: the output only.
extern "C" int banded_attn_wide_fwd(const float* q, const float* k, const float* v,
                                    const float* mask, const float* ek,
                                    const float* ev, float* out, int b, int h, int t,
                                    int d, int w, int device, void* stream) {
  return launch_fwd<false>(q, k, v, mask, ek, ev, out, nullptr, nullptr, b, h, t, d,
                           w, drop_of(0, 0, 0, 0, 0, 1.f), device, stream);
}

// Inference on bf16 operands: every pointer to bf16 data.
extern "C" int banded_attn_wide_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                                         const bf16* mask, const bf16* ek,
                                         const bf16* ev, bf16* out, int b, int h, int t,
                                         int d, int w, int device, void* stream) {
  return launch_fwd<false>(q, k, v, mask, ek, ev, out, nullptr, nullptr, b, h, t, d,
                           w, drop_of(0, 0, 0, 0, 0, 1.f), device, stream);
}

// Train mode: also the row statistics m, l [b, h, t] and the hash dropout.
extern "C" int banded_attn_wide_fwd_train(const float* q, const float* k,
                                          const float* v, const float* mask,
                                          const float* ek, const float* ev, float* out,
                                          float* m, float* l, int b, int h, int t,
                                          int d, int w, int drop, int thr, int seed,
                                          int salt_base, int salt_stride,
                                          float scale, int device, void* stream) {
  return launch_fwd<true>(q, k, v, mask, ek, ev, out, m, l, b, h, t, d, w,
                          drop_of(drop, thr, seed, salt_base, salt_stride, scale), device,
                          stream);
}

// Train mode on bf16 operands: out bf16, m, l fp32.
extern "C" int banded_attn_wide_fwd_train_bf16(const bf16* q, const bf16* k,
                                               const bf16* v, const bf16* mask,
                                               const bf16* ek, const bf16* ev, bf16* out,
                                               float* m, float* l, int b, int h, int t,
                                               int d, int w, int drop, int thr, int seed,
                                               int salt_base, int salt_stride,
                                               float scale, int device, void* stream) {
  return launch_fwd<true>(q, k, v, mask, ek, ev, out, m, l, b, h, t, d, w,
                          drop_of(drop, thr, seed, salt_base, salt_stride, scale), device,
                          stream);
}

// B5: dq [b, h, t, d] and dek, dev [2w+1, d]; band_ds, band_pd: scratch
// [b*h*t, 2w+1] each.
extern "C" int banded_attn_wide_bwd_q(const float* q, const float* k, const float* v,
                                      const float* mask, const float* ek,
                                      const float* ev, const float* g, const float* m,
                                      const float* l, const float* D, float* dq,
                                      float* band_ds, float* band_pd, float* dek,
                                      float* dev, int b, int h, int t, int d, int w,
                                      int drop, int thr, int seed, int salt_base,
                                      int salt_stride, float scale, int device,
                                      void* stream) {
  return launch_bwd_q(q, k, v, mask, ek, ev, g, m, l, D, dq, band_ds, band_pd, dek, dev,
                      b, h, t, d, w, drop_of(drop, thr, seed, salt_base, salt_stride, scale),
                      device, stream);
}

// B5 on bf16 operands: q, k, v, mask, ek, ev, g, dq, dek, dev bf16; m, l, D
// and the scratch fp32.
extern "C" int banded_attn_wide_bwd_q_bf16(const bf16* q, const bf16* k, const bf16* v,
                                           const bf16* mask, const bf16* ek,
                                           const bf16* ev, const bf16* g, const float* m,
                                           const float* l, const float* D, bf16* dq,
                                           float* band_ds, float* band_pd, bf16* dek,
                                           bf16* dev, int b, int h, int t, int d, int w,
                                           int drop, int thr, int seed, int salt_base,
                                           int salt_stride, float scale, int device,
                                           void* stream) {
  return launch_bwd_q(q, k, v, mask, ek, ev, g, m, l, D, dq, band_ds, band_pd, dek, dev,
                      b, h, t, d, w, drop_of(drop, thr, seed, salt_base, salt_stride, scale),
                      device, stream);
}

// B6: dk, dv [b, h, t, d].
extern "C" int banded_attn_wide_bwd_k(const float* q, const float* k, const float* v,
                                      const float* mask, const float* ek,
                                      const float* ev, const float* g, const float* m,
                                      const float* l, const float* D, float* dk,
                                      float* dv, int b, int h, int t, int d, int w,
                                      int drop, int thr, int seed, int salt_base,
                                      int salt_stride, float scale, int device,
                                      void* stream) {
  return launch_bwd_k(q, k, v, mask, ek, ev, g, m, l, D, dk, dv, b, h, t, d, w,
                      drop_of(drop, thr, seed, salt_base, salt_stride, scale), device,
                      stream);
}

// B6 on bf16 operands: dk, dv bf16.
extern "C" int banded_attn_wide_bwd_k_bf16(const bf16* q, const bf16* k, const bf16* v,
                                           const bf16* mask, const bf16* ek,
                                           const bf16* ev, const bf16* g, const float* m,
                                           const float* l, const float* D, bf16* dk,
                                           bf16* dv, int b, int h, int t, int d, int w,
                                           int drop, int thr, int seed, int salt_base,
                                           int salt_stride, float scale, int device,
                                           void* stream) {
  return launch_bwd_k(q, k, v, mask, ek, ev, g, m, l, D, dk, dv, b, h, t, d, w,
                      drop_of(drop, thr, seed, salt_base, salt_stride, scale), device,
                      stream);
}
