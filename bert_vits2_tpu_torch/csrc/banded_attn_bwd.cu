// Banded relative-position self-attention, backward: the two kernels behind
// the fused training direction (ops/attention.py BandedAttentionFn).
//
// Replaces the TPU kernels `_attn_bwd_q_kernel` (B5) and `_attn_bwd_k_kernel`
// (B6) in bert_vits2_tpu/ops/attention_pallas.py. Per (batch, head), with q
// pre-scaled, the forward's row statistics m, l (banded_attn.cu, train
// mode), the output gradient g and D_i = g_i . out_i (computed by the
// caller), and ks[i,j] = keep(i, j) / (1 - p_drop) (1 without dropout):
//
//   p[i,j]  = exp(s[i,j] - m_i) / l_i        s as in the forward, key mask
//   dp[i,j] = (g_i . v_j + (|j-i| <= w ? g_i . ev[j-i+w] : 0)) * ks[i,j]
//   ds[i,j] = p[i,j] (dp[i,j] - D_i), 0 for a masked key (the mask fill is
//             a constant: no gradient reaches q or k through it)
//   B5: dq_i  = sum_j ds[i,j] k_j + sum_c ds[i,i+c-w] ek[c]
//       dek_c = sum_i ds[i,i+c-w] q_i,   dev_c = sum_i p[i,i+c-w] ks[i,i+c-w] g_i
//   B6: dv_j  = sum_i p[i,j] ks[i,j] g_i,  dk_j = sum_i ds[i,j] q_i
//
// (D_i = sum_j dp[i,j] p[i,j]: the softmax backward's row sum, with the band
// term and the dropout folded in.) Query rows are not masked, as in the
// forward: a padded row's gradient is whatever its g makes it, and every
// consumer of the attention re-masks, so its g is 0.
//
// What bounds it on the card: B5 does three t x t x d products (s, g.v and
// ds.k), 6 b h t^2 d FLOP, and B6 four (s, g.v, p.g and ds.q), 8 b h t^2 d
// FLOP; in fp32 on the CUDA cores that is 67 TFLOP/s, and the bytes (each
// input read once) are far below it. Unlike the TPU kernel, which held
// whole [Bq, t] rows in VMEM to renormalise, both kernels rebuild p from
// the saved m and l, so neither needs full rows: each walks the other side
// in shared-memory tiles (t ~ 2000 fits), fp32 FMAs from shared memory as
// in the forward kernel. wgmma tiles are later work.
//
// B5: one block per (32 query rows, batch*head); 8 threads per row, each
// owning 8 of a 64-key tile's columns and 16 of the up-to-128 output
// columns; the 2w+1 band values of ds and p*ks ride in registers as in the
// forward kernel.
// B6: one block per (32 keys, batch*head); 8 threads per key, each owning 8
// of a 64-row query tile's rows and 16 output columns of dk and of dv. The
// band logits it needs are those of the rows within w of its keys only,
// computed once per block.
//
// dek and dev sum over every row of every (batch, head): the TPU carries
// them across its sequential grid steps in one resident block. Here each B5
// block writes its partial [2][2w+1][d] sums, and a second kernel adds the
// partials in block order. Partials over atomics: the same gradient on
// every run, and no zero-fill launch; the partials are ~3.5 MB at the flow's
// shape.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "banded_attn_hash.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TPR = 8;              // threads per query row (B5) / key (B6)
constexpr int DMAX = 128;           // largest head width
constexpr int WMAX = 4;             // largest window
constexpr int NBAND = 2 * WMAX + 1;
constexpr int DCOLS = DMAX / TPR;   // output columns per thread
constexpr float NEG_FILL = -1e4f;

// B5 tiles
constexpr int Q_ROWS = THREADS / TPR;   // 32 query rows per block
constexpr int Q_KEYS = 64;              // keys per shared-memory tile
constexpr int Q_KCOLS = Q_KEYS / TPR;   // key columns per thread
// B6 tiles
constexpr int K_KEYS = THREADS / TPR;   // 32 keys per block
constexpr int K_ROWS = 64;              // query rows per shared-memory tile
constexpr int K_RROWS = K_ROWS / TPR;   // query rows per thread
constexpr int K_BAND_ROWS = K_KEYS + 2 * WMAX;

static_assert(32 % TPR == 0, "a row's (key's) threads must share a warp");

struct Drop {
  bool on;
  uint32_t thr, seed;
  float scale;
};

size_t bwd_q_smem(int d) {
  const int dp = d + 1;
  return sizeof(float) * (size_t)(2 * Q_ROWS * dp + 2 * Q_KEYS * dp +
                                  Q_ROWS * (Q_KEYS + 1) + 4 * Q_ROWS * NBAND);
}

size_t bwd_k_smem(int d) {
  const int dp = d + 1;
  return sizeof(float) * (size_t)(2 * K_KEYS * dp + 2 * K_ROWS * dp +
                                  2 * K_ROWS * (K_KEYS + 1) +
                                  2 * K_BAND_ROWS * NBAND + 3 * K_ROWS);
}

__global__ void __launch_bounds__(THREADS)
attn_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ ek, const float* __restrict__ ev,
                  const float* __restrict__ g, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ dd,
                  float* __restrict__ dq, float* __restrict__ partials, int h,
                  int t, int d, int w, Drop drop) {
  extern __shared__ float smem[];
  const int dp = d + 1;                 // padded row: conflict-free reads
  float* Qs = smem;                     // [Q_ROWS][dp]
  float* Gs = Qs + Q_ROWS * dp;         // [Q_ROWS][dp]
  float* Ks = Gs + Q_ROWS * dp;         // [Q_KEYS][dp]
  float* Vs = Ks + Q_KEYS * dp;         // [Q_KEYS][dp]
  float* Ss = Vs + Q_KEYS * dp;         // [Q_ROWS][Q_KEYS + 1]: ds
  float* Rk = Ss + Q_ROWS * (Q_KEYS + 1);  // [Q_ROWS][NBAND]: q_i . ek[c]
  float* Rv = Rk + Q_ROWS * NBAND;      // [Q_ROWS][NBAND]: g_i . ev[c]
  float* Bds = Rv + Q_ROWS * NBAND;     // [Q_ROWS][NBAND]: band of ds
  float* Bpd = Bds + Q_ROWS * NBAND;    // [Q_ROWS][NBAND]: band of p * ks

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int q0 = blockIdx.x * Q_ROWS;
  const size_t base = (size_t)bh * t * d;
  const float* mrow = mask + (size_t)b * t;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int lane = tid % TPR;
  const int i = q0 + r;
  const int nb = 2 * w + 1;

  for (int idx = tid; idx < Q_ROWS * d; idx += THREADS) {
    const int rr = idx / d, c = idx % d;
    const int qi = q0 + rr;
    const bool in = qi < t;
    Qs[rr * dp + c] = in ? q[base + (size_t)qi * d + c] : 0.f;
    Gs[rr * dp + c] = in ? g[base + (size_t)qi * d + c] : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < Q_ROWS * nb; idx += THREADS) {
    const int rr = idx / nb, c = idx % nb;
    float sk = 0.f, sv = 0.f;
    for (int e = 0; e < d; ++e) {
      sk = fmaf(Qs[rr * dp + e], ek[c * d + e], sk);
      sv = fmaf(Gs[rr * dp + e], ev[c * d + e], sv);
    }
    Rk[rr * NBAND + c] = sk;
    Rv[rr * NBAND + c] = sv;
  }

  const bool row_in = i < t;
  const size_t srow = (size_t)bh * t + (row_in ? i : 0);
  const float mi = row_in ? m[srow] : 0.f;
  const float linv = row_in ? 1.f / l[srow] : 0.f;
  const float di = row_in ? dd[srow] : 0.f;

  float acc[DCOLS];
  float bds[NBAND], bpd[NBAND];
#pragma unroll
  for (int c = 0; c < DCOLS; ++c) acc[c] = 0.f;
#pragma unroll
  for (int c = 0; c < NBAND; ++c) bds[c] = bpd[c] = 0.f;

  for (int j0 = 0; j0 < t; j0 += Q_KEYS) {
    __syncthreads();  // the previous tile's readers are done; Rk/Rv visible
    for (int idx = tid; idx < Q_KEYS * d; idx += THREADS) {
      const int jj = idx / d, c = idx % d;
      const int j = j0 + jj;
      const bool in = j < t;
      Ks[jj * dp + c] = in ? k[base + (size_t)j * d + c] : 0.f;
      Vs[jj * dp + c] = in ? v[base + (size_t)j * d + c] : 0.f;
    }
    __syncthreads();

    float s[Q_KCOLS], gv[Q_KCOLS];
#pragma unroll
    for (int a = 0; a < Q_KCOLS; ++a) s[a] = gv[a] = 0.f;
    for (int e = 0; e < d; ++e) {
      const float qe = Qs[r * dp + e];
      const float ge = Gs[r * dp + e];
#pragma unroll
      for (int a = 0; a < Q_KCOLS; ++a) {
        const int jj = lane + a * TPR;
        s[a] = fmaf(qe, Ks[jj * dp + e], s[a]);
        gv[a] = fmaf(ge, Vs[jj * dp + e], gv[a]);
      }
    }

#pragma unroll
    for (int a = 0; a < Q_KCOLS; ++a) {
      const int jj = lane + a * TPR;
      const int j = j0 + jj;
      float ds = 0.f;
      if (row_in && j < t) {
        const int c = j - i + w;
        const bool in_band = c >= 0 && c < nb;
        float x = s[a], dpv = gv[a];
        if (in_band) {
          x += Rk[r * NBAND + c];
          dpv += Rv[r * NBAND + c];
        }
        const bool key = mrow[j] != 0.f;
        if (!key) x = NEG_FILL;
        const float p = expf(x - mi) * linv;
        float pd = p;
        if (drop.on) {
          const float ks = hash_keep(i, j, bh, drop.seed, drop.thr) ? drop.scale : 0.f;
          pd = p * ks;
          dpv *= ks;
        }
        ds = key ? p * (dpv - di) : 0.f;
#pragma unroll
        for (int cc = 0; cc < NBAND; ++cc)
          if (cc == c) {
            bds[cc] += ds;
            bpd[cc] += pd;
          }
      }
      Ss[r * (Q_KEYS + 1) + jj] = ds;
    }
    __syncwarp();  // this row's ds come from lanes of this warp

    for (int jj = 0; jj < Q_KEYS; ++jj) {
      const float dsv = Ss[r * (Q_KEYS + 1) + jj];
      const float* krow = Ks + jj * dp;
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int col = lane + c * TPR;
        if (col < d) acc[c] = fmaf(dsv, krow[col], acc[c]);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < NBAND; ++c) {
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) {
      bds[c] += __shfl_xor_sync(0xffffffffu, bds[c], off);
      bpd[c] += __shfl_xor_sync(0xffffffffu, bpd[c], off);
    }
  }
  if (row_in) {
    float* drow = dq + base + (size_t)i * d;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int col = lane + c * TPR;
      if (col < d) {
        float o = acc[c];
        for (int bc = 0; bc < nb; ++bc) o = fmaf(bds[bc], ek[bc * d + col], o);
        drow[col] = o;
      }
    }
  }
  if (lane == 0) {  // rows past t hold zeros
#pragma unroll
    for (int c = 0; c < NBAND; ++c) {
      Bds[r * NBAND + c] = bds[c];
      Bpd[r * NBAND + c] = bpd[c];
    }
  }
  __syncthreads();
  // this block's partial dek (which 0) and dev (which 1), [2][nb][d]
  float* part = partials + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * nb * d;
  for (int idx = tid; idx < 2 * nb * d; idx += THREADS) {
    const int which = idx / (nb * d);
    const int c = (idx / d) % nb, e = idx % d;
    const float* band = which ? Bpd : Bds;
    const float* rows = which ? Gs : Qs;
    float sum = 0.f;
    for (int rr = 0; rr < Q_ROWS; ++rr)
      sum = fmaf(band[rr * NBAND + c], rows[rr * dp + e], sum);
    part[idx] = sum;
  }
}

// dek, dev [nb][d] = the sum of the blocks' partials, in block order
__global__ void band_tables_reduce(const float* __restrict__ partials,
                                   int n_blocks, int n, float* __restrict__ dek,
                                   float* __restrict__ dev) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n) return;
  float sum = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) sum += partials[(size_t)blk * 2 * n + idx];
  if (idx < n)
    dek[idx] = sum;
  else
    dev[idx - n] = sum;
}

__global__ void __launch_bounds__(THREADS)
attn_bwd_k_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ ek, const float* __restrict__ ev,
                  const float* __restrict__ g, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ dd,
                  float* __restrict__ dk, float* __restrict__ dv, int h, int t,
                  int d, int w, Drop drop) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* Ks = smem;                        // [K_KEYS][dp]
  float* Vs = Ks + K_KEYS * dp;            // [K_KEYS][dp]
  float* Qs = Vs + K_KEYS * dp;            // [K_ROWS][dp]
  float* Gs = Qs + K_ROWS * dp;            // [K_ROWS][dp]
  float* Pd = Gs + K_ROWS * dp;            // [K_ROWS][K_KEYS + 1]: p * ks
  float* Ds = Pd + K_ROWS * (K_KEYS + 1);  // [K_ROWS][K_KEYS + 1]: ds
  float* Rk = Ds + K_ROWS * (K_KEYS + 1);  // [K_BAND_ROWS][NBAND]: q_i . ek[c]
  float* Rv = Rk + K_BAND_ROWS * NBAND;    // [K_BAND_ROWS][NBAND]: g_i . ev[c]
  float* Ms = Rv + K_BAND_ROWS * NBAND;    // [K_ROWS] row max
  float* Li = Ms + K_ROWS;                 // [K_ROWS] 1 / row sum
  float* Dr = Li + K_ROWS;                 // [K_ROWS] D_i

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int k0 = blockIdx.x * K_KEYS;
  const size_t base = (size_t)bh * t * d;
  const size_t sbase = (size_t)bh * t;
  const int tid = threadIdx.x;
  const int jj = tid / TPR;
  const int lane = tid % TPR;
  const int j = k0 + jj;
  const int nb = 2 * w + 1;
  const int r0 = k0 - w;  // the first query row whose band reaches key k0

  for (int idx = tid; idx < K_KEYS * d; idx += THREADS) {
    const int kk = idx / d, c = idx % d;
    const int jx = k0 + kk;
    const bool in = jx < t;
    Ks[kk * dp + c] = in ? k[base + (size_t)jx * d + c] : 0.f;
    Vs[kk * dp + c] = in ? v[base + (size_t)jx * d + c] : 0.f;
  }
  for (int idx = tid; idx < K_BAND_ROWS * nb; idx += THREADS) {
    const int rr = idx / nb, c = idx % nb;
    const int ix = r0 + rr;
    float sk = 0.f, sv = 0.f;
    if (ix >= 0 && ix < t) {
      const float* qrow = q + base + (size_t)ix * d;
      const float* grow = g + base + (size_t)ix * d;
      for (int e = 0; e < d; ++e) {
        sk = fmaf(qrow[e], ek[c * d + e], sk);
        sv = fmaf(grow[e], ev[c * d + e], sv);
      }
    }
    Rk[rr * NBAND + c] = sk;
    Rv[rr * NBAND + c] = sv;
  }

  const bool key_in = j < t;
  const bool key = key_in && mask[(size_t)b * t + j] != 0.f;
  float adk[DCOLS], adv[DCOLS];
#pragma unroll
  for (int c = 0; c < DCOLS; ++c) adk[c] = adv[c] = 0.f;

  for (int i0 = 0; i0 < t; i0 += K_ROWS) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < K_ROWS * d; idx += THREADS) {
      const int rr = idx / d, c = idx % d;
      const int ix = i0 + rr;
      const bool in = ix < t;
      Qs[rr * dp + c] = in ? q[base + (size_t)ix * d + c] : 0.f;
      Gs[rr * dp + c] = in ? g[base + (size_t)ix * d + c] : 0.f;
    }
    for (int rr = tid; rr < K_ROWS; rr += THREADS) {
      const int ix = i0 + rr;
      const bool in = ix < t;
      Ms[rr] = in ? m[sbase + ix] : 0.f;
      Li[rr] = in ? 1.f / l[sbase + ix] : 0.f;  // rows past t: p = 0
      Dr[rr] = in ? dd[sbase + ix] : 0.f;
    }
    __syncthreads();

    float s[K_RROWS], gv[K_RROWS];
#pragma unroll
    for (int a = 0; a < K_RROWS; ++a) s[a] = gv[a] = 0.f;
    for (int e = 0; e < d; ++e) {
      const float ke = Ks[jj * dp + e];
      const float ve = Vs[jj * dp + e];
#pragma unroll
      for (int a = 0; a < K_RROWS; ++a) {
        const int rr = lane + a * TPR;
        s[a] = fmaf(Qs[rr * dp + e], ke, s[a]);
        gv[a] = fmaf(Gs[rr * dp + e], ve, gv[a]);
      }
    }

#pragma unroll
    for (int a = 0; a < K_RROWS; ++a) {
      const int rr = lane + a * TPR;
      const int i = i0 + rr;
      float pd = 0.f, ds = 0.f;
      if (key_in && i < t) {
        const int c = j - i + w;
        float x = s[a], dpv = gv[a];
        if (c >= 0 && c < nb) {
          x += Rk[(i - r0) * NBAND + c];
          dpv += Rv[(i - r0) * NBAND + c];
        }
        if (!key) x = NEG_FILL;
        const float p = expf(x - Ms[rr]) * Li[rr];
        pd = p;
        if (drop.on) {
          const float ks = hash_keep(i, j, bh, drop.seed, drop.thr) ? drop.scale : 0.f;
          pd = p * ks;
          dpv *= ks;
        }
        ds = key ? p * (dpv - Dr[rr]) : 0.f;
      }
      Pd[rr * (K_KEYS + 1) + jj] = pd;
      Ds[rr * (K_KEYS + 1) + jj] = ds;
    }
    __syncwarp();  // this key's column comes from lanes of this warp

    for (int rr = 0; rr < K_ROWS; ++rr) {
      const float pdv = Pd[rr * (K_KEYS + 1) + jj];
      const float dsv = Ds[rr * (K_KEYS + 1) + jj];
      const float* grow = Gs + rr * dp;
      const float* qrow = Qs + rr * dp;
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int col = lane + c * TPR;
        if (col < d) {
          adv[c] = fmaf(pdv, grow[col], adv[c]);
          adk[c] = fmaf(dsv, qrow[col], adk[c]);
        }
      }
    }
  }

  if (key_in) {
    float* dkrow = dk + base + (size_t)j * d;
    float* dvrow = dv + base + (size_t)j * d;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int col = lane + c * TPR;
      if (col < d) {
        dkrow[col] = adk[c];
        dvrow[col] = adv[c];
      }
    }
  }
}

bool bad_shape(int b, int h, int t, int d, int w) {
  return d < 1 || d > DMAX || w < 0 || w > WMAX || t < 2 * w || t < 1 ||
         b < 1 || h < 1 || b * h > 65535;
}

Drop make_drop(int on, int thr, int seed, float scale) {
  return Drop{on != 0, (uint32_t)thr, (uint32_t)seed, scale};
}

}  // namespace

// The number of B5 blocks, which the caller's partials buffer
// [blocks][2][2w+1][d] must hold.
extern "C" int banded_attn_bwd_q_blocks(int b, int h, int t) {
  return ((t + Q_ROWS - 1) / Q_ROWS) * b * h;
}

// B5, then the reduction of its partials: dq [b,h,t,d], dek, dev [2w+1,d].
extern "C" int banded_attn_bwd_q(const float* q, const float* k, const float* v,
                                 const float* mask, const float* ek,
                                 const float* ev, const float* g,
                                 const float* m, const float* l,
                                 const float* dd, float* dq, float* partials,
                                 float* dek, float* dev, int b, int h, int t,
                                 int d, int w, int drop, int thr, int seed,
                                 float scale, int device, void* stream) {
  if (bad_shape(b, h, t, d, w)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = bwd_q_smem(d);
  err = cudaFuncSetAttribute(attn_bwd_q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((t + Q_ROWS - 1) / Q_ROWS, b * h);
  attn_bwd_q_kernel<<<grid, THREADS, bytes, s>>>(
      q, k, v, mask, ek, ev, g, m, l, dd, dq, partials, h, t, d, w,
      make_drop(drop, thr, seed, scale));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (2 * w + 1) * d;
  band_tables_reduce<<<(2 * n + 255) / 256, 256, 0, s>>>(
      partials, grid.x * grid.y, n, dek, dev);
  return (int)cudaGetLastError();
}

// B6: dk, dv [b,h,t,d].
extern "C" int banded_attn_bwd_k(const float* q, const float* k, const float* v,
                                 const float* mask, const float* ek,
                                 const float* ev, const float* g,
                                 const float* m, const float* l,
                                 const float* dd, float* dk, float* dv, int b,
                                 int h, int t, int d, int w, int drop, int thr,
                                 int seed, float scale, int device,
                                 void* stream) {
  if (bad_shape(b, h, t, d, w)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = bwd_k_smem(d);
  err = cudaFuncSetAttribute(attn_bwd_k_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + K_KEYS - 1) / K_KEYS, b * h);
  attn_bwd_k_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      q, k, v, mask, ek, ev, g, m, l, dd, dk, dv, h, t, d, w,
      make_drop(drop, thr, seed, scale));
  return (int)cudaGetLastError();
}
