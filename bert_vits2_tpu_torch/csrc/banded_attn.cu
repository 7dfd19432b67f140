// Banded relative-position self-attention, forward.
//
// Replaces the TPU kernel `_attn_fwd_kernel` in
// bert_vits2_tpu/ops/attention_pallas.py for the encoder and flow attention
// of every synthesis call and, in train mode, of the fused training
// direction. Per (batch, head), with q pre-scaled by 1/sqrt(d):
//
//   s[i,j] = q_i . k_j + (|j-i| <= w ? q_i . ek[j-i+w] : 0)
//   s[i,j] = -1e4 where key j is masked          (the reference's fill)
//   p      = softmax_j(s)                          (fp32)
//   p'     = p * keep(i, j) / (1 - p_drop)         (train mode, p_drop > 0)
//   out_i  = sum_j p'[i,j] v_j + sum_c p'[i,i+c-w] ev[c]
//
// Train mode also writes the row max m_i and the sum l_i of exp(s - m_i)
// (fp32, [b, h, t]), from which banded_attn_bwd.cu rebuilds p. The keep mask
// is the JAX package's position hash (`_hash_keep`, banded_attn_hash.cuh);
// the online softmax applies it to the probabilities that multiply v and ev,
// never to the running sum l, so l is the undropped softmax's.
//
// Query rows are not masked: a padded row's output differs from the plain
// version's, and every consumer re-masks it, so only valid rows are held to
// the plain version.
//
// What bounds it on the card: at the flow's shapes (t ~ 700, d = 96) the
// two t x t x d products dominate; in fp32 on the CUDA cores the bound is
// the 67 TFLOP/s fp32 rate, not memory (each q, k, v byte is reused t/64
// times from shared memory). The TPU kernel held a whole [Bq, t] score
// block in VMEM; 227 KB of shared memory cannot hold that at t ~ 2000, so
// this kernel walks the keys in tiles with an online (flash-style) softmax:
// running max m and sum l per row, and the 2w+1 band probabilities carried
// in registers and rescaled together with the output accumulator, so the
// value-side band term is added once at the end. One block per (query tile
// of 32 rows, batch*head); 8 threads per query row, each owning 8 of a key
// tile's 64 columns and 16 of the up-to-128 output columns. fp32 FMAs;
// wgmma/TMA tiles are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "banded_attn_hash.cuh"

namespace {

constexpr int BQ = 32;              // query rows per block
constexpr int BK = 64;              // keys per shared-memory tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;   // threads per query row
constexpr int DMAX = 128;           // largest head width
constexpr int WMAX = 4;             // largest window
constexpr int NBAND = 2 * WMAX + 1;
constexpr int KCOLS = BK / TPR;     // key columns per thread
constexpr int DCOLS = DMAX / TPR;   // output columns per thread
constexpr float NEG_FILL = -1e4f;

static_assert(32 % TPR == 0, "a query row's threads must share a warp");

size_t smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) * (size_t)(BQ * dp + BK * dp + BK * d +
                                  BQ * (BK + 1) + BQ * NBAND);
}

// TRAIN: write the row statistics and apply the hash dropout (when drop)
template <bool TRAIN>
__global__ void __launch_bounds__(THREADS)
banded_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ mask,
                       const float* __restrict__ ek, const float* __restrict__ ev,
                       float* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int h, int t, int d, int w,
                       bool drop, uint32_t thr, uint32_t seed, float keep_scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;                // padded row: conflict-free column reads
  float* Qs = smem;                    // [BQ][dp]
  float* Ks = Qs + BQ * dp;            // [BK][dp]
  float* Vs = Ks + BK * dp;            // [BK][d]
  float* Ps = Vs + BK * d;             // [BQ][BK + 1]
  float* Rs = Ps + BQ * (BK + 1);      // [BQ][NBAND]: q_i . ek[c]

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * t * d;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const float* mrow = mask + (size_t)b * t;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int lane = tid % TPR;
  const int i = q0 + r;
  const int nb = 2 * w + 1;

  for (int idx = tid; idx < BQ * d; idx += THREADS) {
    const int rr = idx / d, c = idx % d;
    const int qi = q0 + rr;
    Qs[rr * dp + c] = qi < t ? qb[(size_t)qi * d + c] : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < BQ * nb; idx += THREADS) {
    const int rr = idx / nb, c = idx % nb;
    float s = 0.f;
    for (int e = 0; e < d; ++e) s = fmaf(Qs[rr * dp + e], ek[c * d + e], s);
    Rs[rr * NBAND + c] = s;
  }

  float m_run = -INFINITY, l_run = 0.f;
  float acc[DCOLS];
  float band[NBAND];
#pragma unroll
  for (int c = 0; c < DCOLS; ++c) acc[c] = 0.f;
#pragma unroll
  for (int c = 0; c < NBAND; ++c) band[c] = 0.f;

  for (int j0 = 0; j0 < t; j0 += BK) {
    __syncthreads();  // the previous tile's readers are done; Rs is visible
    for (int idx = tid; idx < BK * d; idx += THREADS) {
      const int jj = idx / d, c = idx % d;
      const int j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < t) {
        kv = kb[(size_t)j * d + c];
        vv = vb[(size_t)j * d + c];
      }
      Ks[jj * dp + c] = kv;
      Vs[jj * d + c] = vv;
    }
    __syncthreads();

    float s[KCOLS];
#pragma unroll
    for (int a = 0; a < KCOLS; ++a) s[a] = 0.f;
    for (int e = 0; e < d; ++e) {
      const float qe = Qs[r * dp + e];
#pragma unroll
      for (int a = 0; a < KCOLS; ++a)
        s[a] = fmaf(qe, Ks[(lane + a * TPR) * dp + e], s[a]);
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int a = 0; a < KCOLS; ++a) {
      const int j = j0 + lane + a * TPR;
      float x = -INFINITY;  // past the end of the sequence: no such key
      if (j < t) {
        x = s[a];
        const int c = j - i + w;
        if (c >= 0 && c < nb) x += Rs[r * NBAND + c];
        if (mrow[j] == 0.f) x = NEG_FILL;
      }
      s[a] = x;
      tmax = fmaxf(tmax, x);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    // every tile holds key j0 < t, so m_new is finite
    const float m_new = fmaxf(m_run, tmax);
    const float scale = expf(m_run - m_new);
#pragma unroll
    for (int c = 0; c < NBAND; ++c) band[c] *= scale;
    float psum = 0.f;
#pragma unroll
    for (int a = 0; a < KCOLS; ++a) {
      const int jj = lane + a * TPR;
      const float p = expf(s[a] - m_new);
      psum += p;
      float pv = p;  // what multiplies v and ev
      if (TRAIN && drop)
        pv = hash_keep(i, j0 + jj, bh, seed, thr) ? p * keep_scale : 0.f;
      Ps[r * (BK + 1) + jj] = pv;
      const int c = j0 + jj - i + w;
#pragma unroll
      for (int cc = 0; cc < NBAND; ++cc)
        if (cc == c) band[cc] += pv;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = l_run * scale + psum;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) acc[c] *= scale;
    __syncwarp();  // this row's probabilities come from lanes of this warp

    for (int jj = 0; jj < BK; ++jj) {
      const float p = Ps[r * (BK + 1) + jj];
      const float* vrow = Vs + jj * d;
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int col = lane + c * TPR;
        if (col < d) acc[c] = fmaf(p, vrow[col], acc[c]);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < NBAND; ++c) {
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      band[c] += __shfl_xor_sync(0xffffffffu, band[c], off);
  }
  if (i < t) {
    const float inv = 1.f / l_run;
    float* orow = out + base + (size_t)i * d;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int col = lane + c * TPR;
      if (col < d) {
        float o = acc[c];
        for (int bc = 0; bc < nb; ++bc) o = fmaf(band[bc], ev[bc * d + col], o);
        orow[col] = o * inv;
      }
    }
    if (TRAIN && lane == 0) {
      m_out[(size_t)bh * t + i] = m_run;
      l_out[(size_t)bh * t + i] = l_run;
    }
  }
}

template <bool TRAIN>
int launch(const float* q, const float* k, const float* v, const float* mask,
           const float* ek, const float* ev, float* out, float* m, float* l,
           int b, int h, int t, int d, int w, bool drop, uint32_t thr,
           uint32_t seed, float keep_scale, int device, void* stream) {
  if (d < 1 || d > DMAX || w < 0 || w > WMAX || t < 2 * w || t < 1 || b < 1 ||
      h < 1 || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = smem_bytes(d);
  err = cudaFuncSetAttribute(banded_attn_fwd_kernel<TRAIN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + BQ - 1) / BQ, b * h);
  banded_attn_fwd_kernel<TRAIN><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      q, k, v, mask, ek, ev, out, m, l, h, t, d, w, drop, thr, seed, keep_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Inference: the output only.
extern "C" int banded_attn_fwd(const float* q, const float* k, const float* v,
                               const float* mask, const float* ek,
                               const float* ev, float* out, int b, int h, int t,
                               int d, int w, int device, void* stream) {
  return launch<false>(q, k, v, mask, ek, ev, out, nullptr, nullptr, b, h, t, d,
                       w, false, 0u, 0u, 1.f, device, stream);
}

// Train mode: also m, l [b, h, t]; with drop, the hash dropout at threshold
// thr from seed, kept probabilities scaled by scale = 1 / (1 - p_drop).
extern "C" int banded_attn_fwd_train(const float* q, const float* k,
                                     const float* v, const float* mask,
                                     const float* ek, const float* ev,
                                     float* out, float* m, float* l, int b,
                                     int h, int t, int d, int w, int drop,
                                     int thr, int seed, float scale, int device,
                                     void* stream) {
  return launch<true>(q, k, v, mask, ek, ev, out, m, l, b, h, t, d, w,
                      drop != 0, (uint32_t)thr, (uint32_t)seed, scale, device,
                      stream);
}
