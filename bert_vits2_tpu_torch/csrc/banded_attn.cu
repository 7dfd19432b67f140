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
// two t x t x d products dominate, far above the machine balance (each q,
// k, v byte is reused t/16 times), so the bound is the rate of the unit
// that does them. Both run on the tensor cores as wgmma TF32 products in a
// 3xTF32 split (v = hi + lo; hi*hi + hi*lo + lo*hi summed in fp32), which
// keeps fp32 accuracy against the reference's "highest" precision: the
// bound is 3 * FLOP at 495 TFLOP/s. (mma.sync reaches ~320 of the 495
// TFLOP/s and costs the issue slots of every 16 x 8 tile;
// bert_vits2_tpu_torch/utils/tc_probe.py measures both.)
//
// The TPU kernel held a whole [Bq, t] score block in VMEM; here a block is
// one warpgroup (4 warps, 64 query rows) walking the keys in tiles of 32
// with an online (flash-style) softmax:
//
// - The block splits its 64 Q rows once into hi and lo and keeps them in
//   shared memory; each K and V tile is split as it is staged (its global
//   loads issued one tile ahead). All three are stored as the core-matrix
//   layouts the wgmma descriptors read (Layout below); d is zero-padded to
//   a multiple of 8. S = Q K^T is then 3 * d/8 products from shared memory,
//   issued back to back. The band logits q . ek[c] are one more small
//   product (mma.sync, ek as 16 zero-padded key columns).
// - S lands in the accumulator layout (lane 4*g + i of warp w holds rows
//   16w + g, +8, keys 2i, 2i+1 of each 8-key tile). P V takes P as its A
//   operand straight from those registers: its k index i <-> key 2i and
//   i + 4 <-> key 2i + 1, and V's tile is staged in that key order, so no
//   shuffle is needed.
// - The 2w+1 band probabilities of each row are carried per lane, rescaled
//   with the output accumulator, summed over the lane quad at the end and
//   added as one more product, band [16 x 16] . ev [16 x d].
// - Split: hi = v rounded to TF32 in integer ops, lo = v - hi (the tensor
//   core ignores lo's low 13 bits); cvt.rna.tf32 would run on the 16-lane
//   conversion pipe.
//
// bf16 mode (`banded_attn_fwd_bf16`, and its train mode
// `banded_attn_fwd_train_bf16`): the TPU kernel's bf16 operands
// (attention_pallas.py:88-146 under the JAX package's infer_compute_dtype
// or train_compute_dtype "bfloat16": the flow's 16 launches of a synthesis
// call or of a training step). q, k, v, the mask, ek, ev and out are bf16;
// the train mode's m and l fp32, its hash dropout applied to the fp32
// probabilities before P is rounded, as in the fp32 train mode; S = Q K^T and P V run
// as wgmma m64nNk16 bf16 with fp32 accumulators, one MMA per k16 step where
// 3xTF32 issues three per k8 step, at twice the TF32 rate: the bound is
// FLOP at 989 TFLOP/s. Scores, the online softmax and the row sums stay
// fp32 in registers; P is rounded to bf16 only as P V's A operand, taken
// from the accumulator registers as they lie (the bf16 A fragment of k16
// step kk is exactly the S accumulator's 8-key tiles 2kk and 2kk + 1);
// the band logits q . ek and the band term band(P) . ev are fp32 sums on
// the CUDA cores (16 x 16 x d and 16 x 9 x d a warp, once per block),
// band(P) from the fp32 P, as in the TPU kernel. Q, K and V lie in shared
// memory as K-major bf16 core matrices (kmajor_bf16): Q and K with the
// head dims as K (16-byte stores of 8 dims), V transposed, the keys as K
// (2-byte stores). The TPU kernel rounds the normalized P and this one P
// relative to the running max before the final 1 / l, so the two differ by
// bf16 rounding of P (a few bf16 ulps of the output).

#include "banded_attn_hash.cuh"
#include "banded_attn_tc.cuh"

namespace {

constexpr int BK = 32;              // keys per tile
constexpr int NKT = BK / 8;         // 8-key tiles per key tile

// a lane's partial band rows (its two rows g, g + 8) summed over its quad
__device__ __forceinline__ void quad_sum(float (&band)[2][NBAND]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NBAND; ++c) {
      band[r][c] += __shfl_xor_sync(0xffffffffu, band[r][c], 1);
      band[r][c] += __shfl_xor_sync(0xffffffffu, band[r][c], 2);
    }
}

// One key tile through the online softmax, for both modes: sc holds the
// tile's scores q.k (accumulator layout) and returns what multiplies v and
// ev, p' = exp(s - m) (dropped and scaled in train mode with drop); the
// band logits are added and masked keys filled first; the lane's two rows'
// running max m_run and sum l_run (of the undropped p), the band's
// probabilities and the output accumulator o are rescaled to the new max,
// and the band's p' of this tile added.
template <int DK, bool TRAIN>
__device__ __forceinline__ void softmax_tile(float (&sc)[4 * NKT], float (&o)[4 * DK],
                                             float (&band)[2][NBAND], float (&m_run)[2],
                                             float (&l_run)[2], const float* rw,
                                             const float* Mk, int j0, int r0, int t, int w,
                                             int g, int i4, uint32_t salt, bool drop,
                                             uint32_t thr, uint32_t seed,
                                             float keep_scale) {
  const int nb = 2 * w + 1;
  const bool in_band = j0 <= r0 + 15 + w && j0 + BK - 1 >= r0 - w;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e4 = 0; e4 < 4 * NKT; ++e4) {
    const int e = e4 % 4;
    const int jj = (e4 / 4) * 8 + 2 * i4 + e % 2;
    const int rr = g + 8 * (e / 2);
    float x = sc[e4];
    if (in_band) {
      const int c = j0 + jj - (r0 + rr) + w;
      if (c >= 0 && c < nb) x += rw[rr * 16 + c];
    }
    if (Mk[jj] == 0.f) x = NEG_FILL;
    if (j0 + jj >= t) x = -INFINITY;  // past the end of the sequence
    sc[e4] = x;
    mx[e / 2] = fmaxf(mx[e / 2], x);
  }
  float scale[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // every tile holds key j0 < t, so the new max is finite
    const float m_new = fmaxf(m_run[r], mx[r]);
    scale[r] = expf(m_run[r] - m_new);
    m_run[r] = m_new;
#pragma unroll
    for (int c = 0; c < NBAND; ++c) band[r][c] *= scale[r];
  }
#pragma unroll
  for (int e4 = 0; e4 < 4 * NKT; ++e4) {
    const int e = e4 % 4;
    const int jj = (e4 / 4) * 8 + 2 * i4 + e % 2;
    const int rr = g + 8 * (e / 2);
    const float p = expf(sc[e4] - m_run[e / 2]);
    psum[e / 2] += p;
    float pv = p;  // what multiplies v and ev
    if (TRAIN && drop)
      pv = hash_keep(r0 + rr, j0 + jj, salt, seed, thr) ? p * keep_scale : 0.f;
    if (in_band) {
      const int c = j0 + jj - (r0 + rr) + w;
#pragma unroll
      for (int cc = 0; cc < NBAND; ++cc)
        if (cc == c) band[e / 2][cc] += pv;
    }
    sc[e4] = pv;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
    l_run[r] = l_run[r] * scale[r] + psum[r];
  }
#pragma unroll
  for (int e = 0; e < 4 * DK; ++e) o[e] *= scale[(e % 4) / 2];
}

// Shared memory of a block, in floats. Q, K and V are stored split (hi,
// lo) as wgmma operands in 8-row x 16-byte core matrices (banded_attn_tc.cuh):
// - Q (A of S: M = rows, K = dims), K-major along the dims, 64 rows.
// - K (B of S = Q K^T: N = keys, K = dims), K-major along the dims, BK rows.
// - V (B of P V: N = dims, K = keys in P's register order, k index c <->
//   key 2c and c + 4 <-> key 2c + 1): PairLayout.
template <int DK>
struct Layout {
  static constexpr int Q = 2 * DK * 512;
  static constexpr int K = 2 * DK * BK * 8;
  static constexpr int V = 2 * NKT * PairLayout<DK>::KKS;
  static constexpr int R = 4 * 256;             // [4 warps][16][16] band logits
  static constexpr int total = Q + K + V + R + BK;
};

// One warpgroup (4 warps, 64 query rows) per block. DK: 8-wide steps of
// the zero-padded head width. TRAIN: write the row statistics and apply
// the hash dropout (when drop).
template <int DK, bool TRAIN>
__global__ void __launch_bounds__(128)
banded_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ mask,
                       const float* __restrict__ ek, const float* __restrict__ ev,
                       float* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int h, int t, int d, int w,
                       bool drop, uint32_t thr, uint32_t seed, uint32_t salt_base,
                       uint32_t salt_stride, float keep_scale) {
  using L = Layout<DK>;
  extern __shared__ __align__(16) float4 smem4[];
  float* Qc = reinterpret_cast<float*>(smem4);          // Q, split
  float* Kc = Qc + L::Q;                                // K tile, split
  float* Vc = Kc + L::K;                                // V tile, split
  float* Rs = Vc + L::V;                                // band logits
  float* Mk = Rs + L::R;                                // [BK] key mask

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, i4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / h;
  // the dropout's salt: affine in (batch row, head), b * h + head by default
  const uint32_t salt = salt_base + (uint32_t)b * salt_stride + (uint32_t)(bh - b * h);
  const int r0 = (blockIdx.x * 4 + warp) * 16;  // this warp's first row
  const size_t base = (size_t)bh * t * d;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const float* mrow = mask + (size_t)b * t;
  const int nb = 2 * w + 1;
  const bool vec = d % 4 == 0;

  // Q rows [64 blockIdx.x, +64), split; a warp's 32 lanes take 32 rows of
  // one 4-dim chunk (conflict-free 16-byte stores)
  const int q0 = blockIdx.x * 64;
#pragma unroll
  for (int it = 0; it < DK; ++it) {
    const int idx = tid + 128 * it;
    const int row = idx % 64, c4 = idx / 64;
    store_dim_major<DK, 64>(Qc, row, c4, load4(qb, q0 + row, 4 * c4, t, d, vec));
  }
  __syncthreads();
  // band logits R[r, c] = q_r . ek[c], c < 16 (zero past 2w)
  float* rw = Rs + warp * 256;
  band_logits<DK>(Qc, ek, nb, d, rw, warp, g, i4);
  __syncwarp();

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[4 * DK];  // element 4n + e: row g + 8(e/2), dim 8n + 2i + e%2
  float band[2][NBAND];
#pragma unroll
  for (int e = 0; e < 4 * DK; ++e) o[e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NBAND; ++c) band[r][c] = 0.f;

  // K and V rows of a tile: loaded into registers one tile ahead, split and
  // stored after the barrier; a warp's 32 lanes take 32 keys of one 4-dim
  // chunk (conflict-free stores)
  float4 kpre[DK / 2], vpre[DK / 2];
  float mpre = 0.f;
  auto load = [&](int j0) {
#pragma unroll
    for (int it = 0; it < DK / 2; ++it) {
      const int idx = tid + 128 * it;
      const int key = idx % BK, dim = 4 * (idx / BK);
      kpre[it] = load4(kb, j0 + key, dim, t, d, vec);
      vpre[it] = load4(vb, j0 + key, dim, t, d, vec);
    }
    if (tid < BK) mpre = j0 + tid < t ? mrow[j0 + tid] : 0.f;
  };
  load(0);

  for (int j0 = 0; j0 < t; j0 += BK) {
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int it = 0; it < DK / 2; ++it) {
      const int idx = tid + 128 * it;
      const int key = idx % BK, c4 = idx / BK;
      store_dim_major<DK, BK>(Kc, key, c4, kpre[it]);
      store_row_paired<DK, NKT>(Vc, key, 4 * c4, vpre[it]);
    }
    if (tid < BK) Mk[tid] = mpre;
    fence_async_smem();
    __syncthreads();
    if (j0 + BK < t) load(j0 + BK);  // in flight while this tile is computed

    // S = Q K^T: per k step lo*hi, hi*lo, hi*hi, all from shared memory
    float sc[4 * NKT];  // element 4n + e: row g + 8(e/2), key j0 + 8n + 2i + e%2
#pragma unroll
    for (int e = 0; e < 4 * NKT; ++e) sc[e] = 0.f;
    wg_fence();
    wgmma_rows_dot<DK, NKT>(sc, Qc, Kc);
    wg_commit();
    wg_wait<0>();
    fence_operands(sc);

    softmax_tile<DK, TRAIN>(sc, o, band, m_run, l_run, rw, Mk, j0, r0, t, w, g, i4, salt,
                            drop, thr, seed, keep_scale);

    // O += P V: P straight from the accumulator registers
    const AccFrags<NKT> pf = acc_frags<NKT>(sc);
    wg_fence();
    wgmma_frags_times<DK, NKT>(o, pf, Vc);
    wg_commit();
    wg_wait<0>();
    fence_operands(o);
  }

  // the band term: sum the quad's partial band rows, then O += band . ev
  quad_sum(band);
  add_band_term<DK>(o, band, ev, nb, d, g, i4);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (i >= t) continue;
    const float inv = 1.f / l_run[r];
    float* orow = out + base + (size_t)i * d;
#pragma unroll
    for (int nt = 0; nt < DK; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * i4 + e;
        if (col < d) orow[col] = o[4 * nt + 2 * r + e] * inv;
      }
    if (TRAIN && i4 == 0) {
      m_out[(size_t)bh * t + i] = m_run[r];
      l_out[(size_t)bh * t + i] = l_run[r];
    }
  }
}

// Shared memory of a block in bf16 mode: the bf16 operands Q (64 rows), the
// K tile (BK rows) and the V tile (8DK rows: dims by keys), each K-major
// (kmajor_bf16), then the fp32 band logits and key mask.
template <int DK>
struct LayoutBf16 {
  static constexpr int Q = 64 * 8 * DK;  // bf16 elements
  static constexpr int K = BK * 8 * DK;
  static constexpr int V = BK * 8 * DK;
  static constexpr int R = 4 * 256;      // floats: [4 warps][16][16] band logits
  static constexpr size_t bytes = 2 * (Q + K + V) + 4 * (R + BK);
};

// K1's bf16 mode: one warpgroup (4 warps, 64 query rows) per block, keys
// in tiles of BK, as banded_attn_fwd_kernel; DK even (the head width
// zero-padded to a multiple of 16). TRAIN as banded_attn_fwd_kernel's.
template <int DK, bool TRAIN>
__global__ void __launch_bounds__(128)
banded_attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ mask,
                            const bf16* __restrict__ ek, const bf16* __restrict__ ev,
                            bf16* __restrict__ out, float* __restrict__ m_out,
                            float* __restrict__ l_out, int h, int t, int d, int w,
                            bool drop, uint32_t thr, uint32_t seed, uint32_t salt_base,
                            uint32_t salt_stride, float keep_scale) {
  static_assert(DK % 2 == 0, "k16 steps of the head width");
  using L = LayoutBf16<DK>;
  constexpr int ND = 8 * DK;                   // padded head width
  constexpr int KCH = (BK * DK + 127) / 128;   // 8-dim chunks of a tile a thread stages
  extern __shared__ __align__(16) float4 smem4[];
  bf16* Qc = reinterpret_cast<bf16*>(smem4);
  bf16* Kc = Qc + L::Q;
  bf16* Vc = Kc + L::K;
  float* Rs = reinterpret_cast<float*>(Vc + L::V);
  float* Mk = Rs + L::R;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, i4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / h;
  // the dropout's salt: affine in (batch row, head), b * h + head by default
  const uint32_t salt = salt_base + (uint32_t)b * salt_stride + (uint32_t)(bh - b * h);
  const int r0 = (blockIdx.x * 4 + warp) * 16;  // this warp's first row
  const size_t base = (size_t)bh * t * d;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const bf16* mrow = mask + (size_t)b * t;
  const int nb = 2 * w + 1;
  const bool vec = d % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  // Q rows [64 blockIdx.x, +64): a thread stores 8 dims of a row at a time
  const int q0 = blockIdx.x * 64;
#pragma unroll
  for (int it = 0; it < DK / 2; ++it) {
    const int idx = tid + 128 * it;
    const int row = idx % 64, c8 = idx / 64;
    *reinterpret_cast<uint4*>(Qc + kmajor_bf16<64>(row, 8 * c8)) =
        load8(qb, q0 + row, 8 * c8, t, d, vec);
  }
  // band logits R[r, c] = q_r . ek[c] in fp32, c < 16 (zero past 2w)
  float* rw = Rs + warp * 256;
  for (int e = lane; e < 256; e += 32) {
    const int r = e / 16, c = e % 16;
    float s = 0.f;
    if (c < nb && r0 + r < t)
      for (int x = 0; x < d; ++x)
        s = fmaf(to_f(qb[(size_t)(r0 + r) * d + x]), to_f(ek[(size_t)c * d + x]), s);
    rw[e] = s;
  }
  __syncwarp();

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[4 * DK];  // element 4n + e: row g + 8(e/2), dim 8n + 2i + e%2
  float band[2][NBAND];
#pragma unroll
  for (int e = 0; e < 4 * DK; ++e) o[e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NBAND; ++c) band[r][c] = 0.f;

  // K and V rows of a tile, 8 dims at a time, loaded one tile ahead
  uint4 kpre[KCH], vpre[KCH];
  float mpre = 0.f;
  auto load = [&](int j0) {
#pragma unroll
    for (int it = 0; it < KCH; ++it) {
      const int idx = tid + 128 * it;
      if (idx >= BK * DK) break;
      const int key = idx % BK, c8 = idx / BK;
      kpre[it] = load8(kb, j0 + key, 8 * c8, t, d, vec);
      vpre[it] = load8(vb, j0 + key, 8 * c8, t, d, vec);
    }
    if (tid < BK) mpre = j0 + tid < t ? to_f(mrow[j0 + tid]) : 0.f;
  };
  load(0);

  for (int j0 = 0; j0 < t; j0 += BK) {
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int it = 0; it < KCH; ++it) {
      const int idx = tid + 128 * it;
      if (idx >= BK * DK) break;
      const int key = idx % BK, c8 = idx / BK;
      *reinterpret_cast<uint4*>(Kc + kmajor_bf16<BK>(key, 8 * c8)) = kpre[it];
      const uint32_t vw[4] = {vpre[it].x, vpre[it].y, vpre[it].z, vpre[it].w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        Vc[kmajor_bf16<ND>(8 * c8 + e, key)] =
            __ushort_as_bfloat16((unsigned short)(vw[e / 2] >> (16 * (e % 2))));
    }
    if (tid < BK) Mk[tid] = mpre;
    fence_async_smem();
    __syncthreads();
    if (j0 + BK < t) load(j0 + BK);  // in flight while this tile is computed

    // S = Q K^T: one k16 step per 16 head dims
    float sc[4 * NKT];  // element 4n + e: row g + 8(e/2), key j0 + 8n + 2i + e%2
#pragma unroll
    for (int e = 0; e < 4 * NKT; ++e) sc[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DK / 2; ++ks)
      wgmma_bf16_ss<NKT>(sc, smem_desc(Qc + ks * 64 * 16, 128, 256),
                         smem_desc(Kc + ks * BK * 16, 128, 256));
    wg_commit();
    wg_wait<0>();
    fence_operands(sc);

    softmax_tile<DK, TRAIN>(sc, o, band, m_run, l_run, rw, Mk, j0, r0, t, w, g, i4, salt,
                            drop, thr, seed, keep_scale);

    // O += P V: P rounded to bf16 straight from the accumulator registers
    uint32_t pa[NKT / 2][4];
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk)
      wgmma_bf16_rs<DK>(o, pa[kk], smem_desc(Vc + kk * ND * 16, 128, 256));
    wg_commit();
    wg_wait<0>();
    fence_operands(o);
  }

  // the band term in fp32: sum the quad's partial band rows, then
  // o += band . ev for the lane's rows g, g + 8 and dims 8n + 2i, +1
  quad_sum(band);
#pragma unroll
  for (int nt = 0; nt < DK; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * i4 + e;
      if (col >= d) continue;
      float a0 = 0.f, a1 = 0.f;
      for (int c = 0; c < nb; ++c) {
        const float evc = to_f(ev[(size_t)c * d + col]);
        a0 = fmaf(band[0][c], evc, a0);
        a1 = fmaf(band[1][c], evc, a1);
      }
      o[4 * nt + e] += a0;
      o[4 * nt + 2 + e] += a1;
    }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (i >= t) continue;
    const float inv = 1.f / l_run[r];
    bf16* orow = out + base + (size_t)i * d;
#pragma unroll
    for (int nt = 0; nt < DK; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * i4 + e;
        if (col < d) orow[col] = __float2bfloat16_rn(o[4 * nt + 2 * r + e] * inv);
      }
    if (TRAIN && i4 == 0) {
      m_out[(size_t)bh * t + i] = m_run[r];
      l_out[(size_t)bh * t + i] = l_run[r];
    }
  }
}

// The shared-memory attribute is set once per instantiation, device and
// size: the largest size set so far is kept.
template <int DK, bool TRAIN>
int launch_dk(const float* q, const float* k, const float* v, const float* mask,
              const float* ek, const float* ev, float* out, float* m, float* l,
              int b, int h, int t, int d, int w, bool drop, uint32_t thr,
              uint32_t seed, uint32_t salt_base, uint32_t salt_stride, float keep_scale,
              int device, cudaStream_t stream) {
  static size_t configured[MAXDEV] = {};
  const size_t bytes = sizeof(float) * Layout<DK>::total;
  const cudaError_t err = allow_smem((const void*)banded_attn_fwd_kernel<DK, TRAIN>,
                                     bytes, configured, device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + 63) / 64, b * h);
  banded_attn_fwd_kernel<DK, TRAIN><<<grid, 128, bytes, stream>>>(
      q, k, v, mask, ek, ev, out, m, l, h, t, d, w, drop, thr, seed, salt_base,
      salt_stride, keep_scale);
  return (int)cudaGetLastError();
}

template <bool TRAIN>
int launch(const float* q, const float* k, const float* v, const float* mask,
           const float* ek, const float* ev, float* out, float* m, float* l,
           int b, int h, int t, int d, int w, bool drop, uint32_t thr,
           uint32_t seed, uint32_t salt_base, uint32_t salt_stride, float keep_scale,
           int device, void* stream) {
  if (bad_attn_shape(b, h, t, d, w, device)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int steps = (d + 7) / 8;
#define BANDED_ATTN_LAUNCH(DK)                                                   \
  return launch_dk<DK, TRAIN>(q, k, v, mask, ek, ev, out, m, l, b, h, t, d, w,  \
                              drop, thr, seed, salt_base, salt_stride,          \
                              keep_scale, device, s)
  if (steps <= 2) BANDED_ATTN_LAUNCH(2);
  if (steps <= 4) BANDED_ATTN_LAUNCH(4);
  if (steps <= 8) BANDED_ATTN_LAUNCH(8);
  if (steps <= 12) BANDED_ATTN_LAUNCH(12);
  BANDED_ATTN_LAUNCH(16);
#undef BANDED_ATTN_LAUNCH
}

template <int DK, bool TRAIN>
int launch_bf16_dk(const bf16* q, const bf16* k, const bf16* v, const bf16* mask,
                   const bf16* ek, const bf16* ev, bf16* out, float* m, float* l, int b,
                   int h, int t, int d, int w, bool drop, uint32_t thr, uint32_t seed,
                   uint32_t salt_base, uint32_t salt_stride, float keep_scale,
                   int device, cudaStream_t stream) {
  static size_t configured[MAXDEV] = {};
  const size_t bytes = LayoutBf16<DK>::bytes;
  const cudaError_t err = allow_smem((const void*)banded_attn_fwd_bf16_kernel<DK, TRAIN>,
                                     bytes, configured, device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + 63) / 64, b * h);
  banded_attn_fwd_bf16_kernel<DK, TRAIN><<<grid, 128, bytes, stream>>>(
      q, k, v, mask, ek, ev, out, m, l, h, t, d, w, drop, thr, seed, salt_base,
      salt_stride, keep_scale);
  return (int)cudaGetLastError();
}

template <bool TRAIN>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* mask,
                const bf16* ek, const bf16* ev, bf16* out, float* m, float* l, int b,
                int h, int t, int d, int w, bool drop, uint32_t thr, uint32_t seed,
                uint32_t salt_base, uint32_t salt_stride, float keep_scale, int device,
                void* stream) {
  if (bad_attn_shape(b, h, t, d, w, device)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int steps = (d + 15) / 16;  // k16 steps
#define BANDED_ATTN_BF16_LAUNCH(DK)                                              \
  return launch_bf16_dk<DK, TRAIN>(q, k, v, mask, ek, ev, out, m, l, b, h, t, d,  \
                                   w, drop, thr, seed, salt_base, salt_stride,    \
                                   keep_scale, device, s)
  if (steps <= 1) BANDED_ATTN_BF16_LAUNCH(2);
  if (steps <= 2) BANDED_ATTN_BF16_LAUNCH(4);
  if (steps <= 4) BANDED_ATTN_BF16_LAUNCH(8);
  if (steps <= 6) BANDED_ATTN_BF16_LAUNCH(12);
  BANDED_ATTN_BF16_LAUNCH(16);
#undef BANDED_ATTN_BF16_LAUNCH
}

}  // namespace

// Inference: the output only.
extern "C" int banded_attn_fwd(const float* q, const float* k, const float* v,
                               const float* mask, const float* ek,
                               const float* ev, float* out, int b, int h, int t,
                               int d, int w, int device, void* stream) {
  return launch<false>(q, k, v, mask, ek, ev, out, nullptr, nullptr, b, h, t, d,
                       w, false, 0u, 0u, 0u, 0u, 1.f, device, stream);
}

// Train mode: also m, l [b, h, t]; with drop, the hash dropout at threshold
// thr from seed, batch row b and head hh salted salt_base + b * salt_stride +
// hh (0 and h: the TPU kernel's b * h + hh), kept probabilities scaled by
// scale = 1 / (1 - p_drop).
extern "C" int banded_attn_fwd_train(const float* q, const float* k,
                                     const float* v, const float* mask,
                                     const float* ek, const float* ev,
                                     float* out, float* m, float* l, int b,
                                     int h, int t, int d, int w, int drop,
                                     int thr, int seed, int salt_base,
                                     int salt_stride, float scale, int device,
                                     void* stream) {
  return launch<true>(q, k, v, mask, ek, ev, out, m, l, b, h, t, d, w,
                      drop != 0, (uint32_t)thr, (uint32_t)seed, (uint32_t)salt_base,
                      (uint32_t)salt_stride, scale, device, stream);
}

// K1's bf16 mode (inference): every pointer to bf16 data, [b, h, t, d]
// q, k, v and out, [b, t] mask, [2w+1, d] ek, ev.
extern "C" int banded_attn_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                                    const bf16* mask, const bf16* ek, const bf16* ev,
                                    bf16* out, int b, int h, int t, int d, int w,
                                    int device, void* stream) {
  return launch_bf16<false>(q, k, v, mask, ek, ev, out, nullptr, nullptr, b, h, t, d, w,
                            false, 0u, 0u, 0u, 0u, 1.f, device, stream);
}

// K1's train mode on bf16 operands: q, k, v, mask, ek, ev and out bf16,
// m, l [b, h, t] fp32; the dropout arguments as banded_attn_fwd_train's.
extern "C" int banded_attn_fwd_train_bf16(const bf16* q, const bf16* k, const bf16* v,
                                          const bf16* mask, const bf16* ek,
                                          const bf16* ev, bf16* out, float* m, float* l,
                                          int b, int h, int t, int d, int w, int drop,
                                          int thr, int seed, int salt_base,
                                          int salt_stride, float scale, int device,
                                          void* stream) {
  return launch_bf16<true>(q, k, v, mask, ek, ev, out, m, l, b, h, t, d, w, drop != 0,
                           (uint32_t)thr, (uint32_t)seed, (uint32_t)salt_base,
                           (uint32_t)salt_stride, scale, device, stream);
}
