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
// FLOP; each input byte is reused t/16 times or more, so the bound is the
// rate of the unit that does the products. As in the forward kernel they
// run on the tensor cores as wgmma TF32 products in a 3xTF32 split (v = hi
// + lo, lo*hi + hi*lo + hi*hi summed in fp32: fp32 accuracy), so the bound
// is 3 * FLOP at 495 TFLOP/s. Unlike the TPU kernel, which held whole
// [Bq, t] rows in VMEM to renormalise, both kernels rebuild p from the
// saved m and l, so neither needs full rows: each walks the other side in
// shared-memory tiles (any t).
//
// B5: one warpgroup per (64 query rows, batch*head). Q and G are split
// once and kept in shared memory (K-major along the dims, the A operands
// of S = Q K^T and G V^T). Each tile of TN keys is loaded into registers a
// tile ahead, split, and stored twice for K (K-major along the dims as the
// B of S; K-major along the keys, in the accumulator's key order (2i, 2i+1)
// -> (i, i+4), as the B of dS K) and once for V. Per tile: six SS products
// per k step (S and G V^T, 3xTF32), one wait; the band terms, mask, p,
// keep mask and ds in the accumulator registers (each band entry of ds
// and p*ks, one element of one lane, stored to shared memory); then
// dQ += dS K with dS as the A operand from the registers. The band logits
// q . ek, g . ev come first, as in the forward (mma.sync from the staged
// rows); at the end dq += band_ds . ek and the block's partial dek, dev
// [2][2w+1][d] = band^T . (Q, G), small mma.sync products, go to a buffer.
// B6: one block per (64 keys, batch*head), the transpose: K and V of the
// block are the A operands (S^T = K Q^T, (G V^T)^T = V G^T), the query
// rows are walked in tiles of TN (the N dimension), and dV += Pd^T G,
// dK += dS^T Q take Pd^T and dS^T from the registers, so each Q and G tile
// is stored in both layouts. Two warpgroups share the block (one at d >
// 96, where the tile is 16 rows wide), each taking
// half of every row tile with its own accumulators, which are added in a
// fixed order at the end: one's softmax rebuild (p, then ds after a second
// wait) overlaps the other's products. The band logits are needed for the
// rows within w of the block's keys only: computed once per block from
// those rows staged in shared memory, a thread per (row, table).
//
// The block's one-off work (staging, band logits, the partials) is written
// so that its loads are issued together: with one or two warpgroups per SM
// nothing else hides their latency.
//
// TN, the tile width, is 32, and 16 at d > 96: with d = 128 B6's shared
// memory at TN = 32 (K, V split 131 KB, each Q and G tile twice, 66 KB)
// would not fit in 227 KB. d is zero-padded to a multiple of 8.
//
// dek and dev sum over every row of every (batch, head): the TPU carries
// them across its sequential grid steps in one resident block. Here each B5
// block writes its partial sums, and a second kernel adds the partials in
// block order. Partials over atomics: the same gradient on every run, and
// no zero-fill launch.
//
// bf16 modes (`banded_attn_bwd_q_bf16`, `banded_attn_bwd_k_bf16`: the
// flow's 16 launches each of a bf16 training step, train_compute_dtype
// "bfloat16"). q, k, v, the mask, ek, ev, g and the outputs dq, dk, dv, dek,
// dev are bf16; m, l, D, the partials and all arithmetic fp32. They round
// where the TPU kernels do (attention_pallas.py:147-300): ds and p*ks are
// rounded to bf16 only as operands of the t x t products (dS K, dS^T Q,
// Pd^T G), whose sums are fp32; the band terms take the fp32 ds and p*ks
// against the table; dq, dk, dv are rounded at the end, dek and dev after
// the block-order reduction of fp32 partials. The tiling is the fp32
// kernels' with one wgmma m64nNk16 bf16 product per 16 head dims (or 16
// keys) where 3xTF32 issues three per 8: S and G V^T from shared memory,
// dS K (B5), Pd^T G and dS^T Q (B6) with the accumulators rounded to bf16
// as the A fragments straight from registers (the fragment of k16 step kk
// is the accumulator's 8-column tiles 2kk and 2kk + 1, as in K1's bf16
// mode). Operands lie in shared memory as K-major bf16 core matrices
// (kmajor_bf16): the block's 64 rows and each tile's rows with the head
// dims as K (16-byte stores), and each tile's K (B5) or Q and G (B6) once
// more transposed, the tile's rows as K (2-byte stores). The tile is 32
// rows at every d (bf16 halves the fp32 kernels' shared memory) and B6
// takes one warpgroup. The band logits and the band products run on the
// CUDA cores in fp32 (2w+1 columns, once per block). The bound is FLOP at
// the bf16 tensor-core rate, 989 TFLOP/s.

#include "banded_attn_hash.cuh"
#include "banded_attn_tc.cuh"

namespace {

constexpr int KBR = 64 + 2 * WMAX;  // B6: rows whose band reaches the block's keys

struct Drop {
  bool on;
  uint32_t thr, seed;
  float scale;
  // batch row b, head hh of h salted salt_base + b * salt_stride + hh
  uint32_t salt_base, salt_stride;
  __device__ uint32_t salt(int bh, int h) const {
    const int b = bh / h;
    return salt_base + (uint32_t)b * salt_stride + (uint32_t)(bh - b * h);
  }
};

// Shared memory of a block, in floats: the A side (64 rows or keys of
// the block, split, K-major along the dims), a B tile (TN rows, split,
// K-major along the dims) and a pair tile (TN rows, split, PairLayout).
// WGS warpgroups share a tile, each taking TN / WGS of its rows; with two,
// the second's sums go through the tiles' space at the end.
template <int DK, int TN, int WGS>
struct Tiles {
  static constexpr int THREADS = 128 * WGS;
  static constexpr int NT = TN / 8;               // 8-row groups per tile
  static constexpr int NTW = NT / WGS;            // per warpgroup
  static constexpr int NLD = (TN * 2 * DK + THREADS - 1) / THREADS;  // float4 loads a thread
  static constexpr int A = 2 * DK * 512;
  static constexpr int B = 2 * DK * TN * 8;
  static constexpr int P = 2 * NT * PairLayout<DK>::KKS;
  // B5: Q, G (A); K, V (B); K (pair); q.ek and g.ev of each warp's rows
  // [2][4][16][16]; the block's band of ds and of p*ks [2][64][12]; the
  // key mask of a tile
  static constexpr int q_total = 2 * A + 2 * B + P + 2 * 1024 + 2 * 64 * 12 + TN;
  // B6: K, V (A); Q, G (B); Q, G (pair); q.ek, g.ev [2][KBR][NBAND]; m,
  // 1/l and D of a tile's rows
  static constexpr int k_total = 2 * A + 2 * B + 2 * P + 2 * KBR * NBAND + 3 * TN;
  static_assert(WGS == 1 || 2 * B + 2 * P >= 8 * DK * 128, "B6's exchange space");
};

// rows [r0, r0 + 64) of two [t, d] matrices, split, K-major along the dims
// (the A operands of a block): every global load issued before any store
template <int DK, int THREADS>
__device__ __forceinline__ void stage_rows(float* a1, const float* __restrict__ x1,
                                           float* a2, const float* __restrict__ x2, int r0,
                                           int t, int d, bool vec, int tid) {
  constexpr int N = (128 * DK + THREADS - 1) / THREADS;  // 64 rows x 2DK chunks
  float4 v1[N], v2[N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int idx = tid + THREADS * it;
    const bool in = idx < 128 * DK;
    v1[it] = in ? load4(x1, r0 + idx % 64, 4 * (idx / 64), t, d, vec) : float4{};
    v2[it] = in ? load4(x2, r0 + idx % 64, 4 * (idx / 64), t, d, vec) : float4{};
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int idx = tid + THREADS * it;
    if (idx < 128 * DK) {
      store_dim_major<DK, 64>(a1, idx % 64, idx / 64, v1[it]);
      store_dim_major<DK, 64>(a2, idx % 64, idx / 64, v2[it]);
    }
  }
}

// A warpgroup's accumulator (element 4n + e: row g + 8(e/2), column 8n +
// 2i + e%2) to rows row[0], row[1] of out [t, d], column pairs as one
// 8-byte store where d is even.
template <int DK>
__device__ __forceinline__ void store_acc_rows(float* out, const float (&acc)[4 * DK],
                                               const int (&row)[2], int t, int d, int i4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= t) continue;
    float* p = out + (size_t)row[r] * d;
#pragma unroll
    for (int nt = 0; nt < DK; ++nt) {
      const int col = nt * 8 + 2 * i4;
      const float x0 = acc[4 * nt + 2 * r], x1 = acc[4 * nt + 2 * r + 1];
      if (d % 2 == 0) {
        if (col < d) *reinterpret_cast<float2*>(p + col) = make_float2(x0, x1);
      } else {
        if (col < d) p[col] = x0;
        if (col + 1 < d) p[col + 1] = x1;
      }
    }
  }
}

template <int DK, int TN>
__global__ void __launch_bounds__(128)
attn_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ ek, const float* __restrict__ ev,
                  const float* __restrict__ g, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ dd,
                  float* __restrict__ dq, float* __restrict__ partials, int h,
                  int t, int d, int w, Drop drop) {
  using L = Tiles<DK, TN, 1>;
  constexpr int NT = L::NT, THREADS = L::THREADS;
  extern __shared__ __align__(16) float4 smem4[];
  float* Qa = reinterpret_cast<float*>(smem4);
  float* Ga = Qa + L::A;
  float* Kb = Ga + L::A;
  float* Vb = Kb + L::B;
  float* Kp = Vb + L::B;
  float* Rs = Kp + L::P;             // [2][4 warps][16][16]: q.ek, g.ev
  float* Bs = Rs + 2 * 1024;         // [2][64][12]: band of ds, of p*ks
  float* Mk = Bs + 2 * 64 * 12;      // [TN] key mask

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, i4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const uint32_t salt = drop.salt(bh, h);
  const int q0 = blockIdx.x * 64;
  const int r0 = q0 + 16 * warp;  // this warp's first row
  const size_t base = (size_t)bh * t * d;
  const float* mrow = mask + (size_t)b * t;
  const int nb = 2 * w + 1;
  const bool vec = d % 4 == 0;

  stage_rows<DK, THREADS>(Qa, q + base, Ga, g + base, q0, t, d, vec, tid);
  for (int idx = tid; idx < 2 * 64 * 12; idx += THREADS) Bs[idx] = 0.f;
  __syncthreads();
  const float* rk = Rs + warp * 256;
  const float* rv = Rs + 1024 + warp * 256;
  band_logits<DK>(Qa, ek, nb, d, Rs + warp * 256, warp, gq, i4);
  band_logits<DK>(Ga, ev, nb, d, Rs + 1024 + warp * 256, warp, gq, i4);

  float mi[2], linv[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + gq + 8 * r;
    const size_t s = (size_t)bh * t + (i < t ? i : 0);
    mi[r] = i < t ? m[s] : 0.f;
    linv[r] = i < t ? 1.f / l[s] : 0.f;
    di[r] = i < t ? dd[s] : 0.f;
  }

  float acc[4 * DK];  // dq: element 4n + e: row gq + 8(e/2), dim 8n + 2i + e%2
#pragma unroll
  for (int e = 0; e < 4 * DK; ++e) acc[e] = 0.f;

  // K and V rows of a tile, loaded one tile ahead
  float4 kpre[L::NLD], vpre[L::NLD];
  float mpre = 0.f;
  auto load = [&](int j0) {
#pragma unroll
    for (int it = 0; it < L::NLD; ++it) {
      const int idx = tid + THREADS * it;
      const int key = idx % TN, dim = 4 * (idx / TN);
      kpre[it] = load4(k + base, j0 + key, dim, t, d, vec);
      vpre[it] = load4(v + base, j0 + key, dim, t, d, vec);
    }
    if (tid < TN) mpre = j0 + tid < t ? mrow[j0 + tid] : 0.f;
  };
  load(0);

  for (int j0 = 0; j0 < t; j0 += TN) {
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int it = 0; it < L::NLD; ++it) {
      const int idx = tid + THREADS * it;
      if (TN * 2 * DK % THREADS && idx >= TN * 2 * DK) break;
      const int key = idx % TN, c4 = idx / TN;
      store_dim_major<DK, TN>(Kb, key, c4, kpre[it]);
      store_row_paired<DK, NT>(Kp, key, 4 * c4, kpre[it]);
      store_dim_major<DK, TN>(Vb, key, c4, vpre[it]);
    }
    if (tid < TN) Mk[tid] = mpre;
    fence_async_smem();
    __syncthreads();
    if (j0 + TN < t) load(j0 + TN);  // in flight while this tile is computed

    // S = Q K^T and G V^T; element 4n + e: row gq + 8(e/2), key j0 + 8n + 2i + e%2
    float sc[4 * NT], gv[4 * NT];
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) sc[e] = gv[e] = 0.f;
    wg_fence();
    wgmma_rows_dot<DK, NT>(sc, Qa, Kb);
    wgmma_rows_dot<DK, NT>(gv, Ga, Vb);
    wg_commit();
    wg_wait<0>();
    fence_operands(sc);
    fence_operands(gv);

    // ds = p (dp - D) in place of S (0 for a masked key or past t); the
    // band entries of ds and p*ks (one element each) to Bs
    const bool in_band = j0 <= r0 + 15 + w && j0 + TN - 1 >= r0 - w;
#pragma unroll
    for (int e4 = 0; e4 < 4 * NT; ++e4) {
      const int e = e4 % 4, r = e / 2;
      const int jj = (e4 / 4) * 8 + 2 * i4 + e % 2;
      const int rr = gq + 8 * r;
      const int i = r0 + rr, j = j0 + jj;
      float ds = 0.f;
      if (i < t && j < t) {
        const int c = j - i + w;
        const bool band = in_band && c >= 0 && c < nb;
        float x = sc[e4], dpv = gv[e4];
        if (band) {
          x += rk[rr * 16 + c];
          dpv += rv[rr * 16 + c];
        }
        const bool key = Mk[jj] != 0.f;
        if (!key) x = NEG_FILL;
        const float p = expf(x - mi[r]) * linv[r];
        float pd = p;
        if (drop.on) {
          const float ks = hash_keep(i, j, salt, drop.seed, drop.thr) ? drop.scale : 0.f;
          pd = p * ks;
          dpv *= ks;
        }
        ds = key ? p * (dpv - di[r]) : 0.f;
        if (band) {
          Bs[(16 * warp + rr) * 12 + c] = ds;
          Bs[(64 + 16 * warp + rr) * 12 + c] = pd;
        }
      }
      sc[e4] = ds;
    }

    // dQ += dS K: dS straight from the accumulator registers
    const AccFrags<NT> df = acc_frags<NT>(sc);
    wg_fence();
    wgmma_frags_times<DK, NT>(acc, df, Kp);
    wg_commit();
    wg_wait<0>();
    fence_operands(acc);
  }

  // dq += band_ds . ek: the warp's own rows of Bs (it wrote them)
  __syncwarp();
  float bds[2][NBAND];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NBAND; ++c) bds[r][c] = Bs[(16 * warp + gq + 8 * r) * 12 + c];
  add_band_term<DK>(acc, bds, ek, nb, d, gq, i4);
  const int rows[2] = {r0 + gq, r0 + gq + 8};
  store_acc_rows<DK>(dq + base, acc, rows, t, d, i4);
  __syncthreads();
  // this block's partial dek (which 0) and dev (which 1), [2][nb][d] =
  // band^T [12 x 64 rows] . Q or G [64 rows x d]: 3xTF32 mma.sync, the
  // rows' hi and lo straight from shared memory; a warp per 8 output dims
  float* part = partials + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * nb * d;
  for (int tile = warp; tile < 2 * DK; tile += 4) {
    const int which = tile / DK, nt = tile % DK;
    const float* band = Bs + which * 64 * 12;
    const float* rows = (which ? Ga : Qa) + nt * 512 + (gq / 4) * 32 + gq % 4;
    float o[4] = {};  // element e: c = g + 8(e/2), dim 8nt + 2i + e%2
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      // b0 (row 8ks + i, dim 8nt + g), b1 (row + 4): hi, then lo
      const float* bp = rows + ks * 64 + i4 * 4;
      const float4 bv = make_float4(bp[0], bp[16], bp[DK * 512], bp[DK * 512 + 16]);
      // a0 (c = g, row 8ks + i), a1 (c + 8, zero past 11), a2, a3 (row + 4)
      const float* ap = band + (8 * ks + i4) * 12 + gq;
      const float av[4] = {ap[0], gq < 4 ? ap[8] : 0.f, ap[48], gq < 4 ? ap[56] : 0.f};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(av[e], ah[e], al[e]);
      mma3(o, ah, al, bv);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = gq + 8 * (e / 2), col = nt * 8 + 2 * i4 + e % 2;
      if (c < nb && col < d) part[(which * nb + c) * d + col] = o[e];
    }
  }
}

// dek, dev [nb][d] = the sum of the blocks' partials, in block order
// (stored as T: float, or bf16 rounded from the fp32 sum)
template <typename T>
__global__ void band_tables_reduce(const float* __restrict__ partials,
                                   int n_blocks, int n, T* __restrict__ dek,
                                   T* __restrict__ dev) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n) return;
  float sum = 0.f;
#pragma unroll 16
  for (int blk = 0; blk < n_blocks; ++blk) sum += partials[(size_t)blk * 2 * n + idx];
  if (idx < n)
    dek[idx] = from_f<T>(sum);
  else
    dev[idx - n] = from_f<T>(sum);
}

// ---- bf16 modes ----

constexpr int TNB = 32;  // bf16 modes: rows (B6) or keys (B5) per tile
constexpr int NTB = TNB / 8;

// Shared memory of a bf16-mode block: bf16 operands, then fp32 scratch.
// B5: Q, G (64 rows, dims as K); K, V tiles (dims as K); K tile transposed
// (keys as K); q.ek, g.ev of each warp's rows [2][4][16][16]; the band of
// ds and of p*ks [2][64][12]; the tile's key mask.
// B6: K, V (64 keys, dims as K); Q, G tiles (dims as K) and transposed
// (rows as K); q.ek, g.ev [2][KBR][NBAND]; m, 1/l, D of the tile's rows.
template <int DK>
struct TilesBf16 {
  static constexpr int ND = 8 * DK;  // padded head width
  static constexpr int A = 64 * ND;  // bf16 elements
  static constexpr int B = TNB * ND;
  static constexpr size_t q_bytes = 2 * (2 * A + 3 * B) + 4 * (2 * 1024 + 2 * 64 * 12 + TNB);
  static constexpr size_t k_bytes = 2 * (2 * A + 4 * B) + 4 * (2 * KBR * NBAND + 3 * TNB);
};

// rows [r0, r0 + 64) of a [t, d] bf16 matrix to shared memory, K-major with
// the dims as K (one 16-byte store of 8 dims)
template <int DK>
__device__ __forceinline__ void stage_rows_bf16(bf16* a, const bf16* __restrict__ x, int r0,
                                                int t, int d, bool vec, int tid) {
#pragma unroll
  for (int it = 0; it < DK / 2; ++it) {
    const int idx = tid + 128 * it;
    const int row = idx % 64, c8 = idx / 64;
    *reinterpret_cast<uint4*>(a + kmajor_bf16<64>(row, 8 * c8)) =
        load8(x, r0 + row, 8 * c8, t, d, vec);
  }
}

// one tile row's 8 dims from `v` into the tile (dims as K) and, with
// TRANS, into its transpose (the tile's rows as K)
template <int DK, bool TRANS>
__device__ __forceinline__ void store_tile_bf16(bf16* tile, bf16* trans, int row, int c8,
                                                uint4 v) {
  *reinterpret_cast<uint4*>(tile + kmajor_bf16<TNB>(row, 8 * c8)) = v;
  if (TRANS) {
    const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      trans[kmajor_bf16<8 * DK>(8 * c8 + e, row)] =
          __ushort_as_bfloat16((unsigned short)(vw[e / 2] >> (16 * (e % 2))));
  }
}

// the A fragments of k16 step kk from an accumulator of NTB 8-column tiles,
// rounded to bf16
__device__ __forceinline__ void acc_frags_bf16(const float (&acc)[4 * NTB],
                                               uint32_t (&a)[NTB / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NTB / 2; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
}

// d += A B^T over the head dims, bf16, both from shared memory (K-major
// along the dims): A the block's 64 rows, B a tile's TNB rows
template <int DK>
__device__ __forceinline__ void wgmma_rows_dot_bf16(float (&d)[4 * NTB], const bf16* a,
                                                    const bf16* b) {
#pragma unroll
  for (int ks = 0; ks < DK / 2; ++ks)
    wgmma_bf16_ss<NTB>(d, smem_desc(a + ks * 64 * 16, 128, 256),
                       smem_desc(b + ks * TNB * 16, 128, 256));
}

// d += acc * B, bf16: acc's fragments from registers, B a transposed tile
// (the tile's rows as K, the head dims as N)
template <int DK>
__device__ __forceinline__ void wgmma_frags_times_bf16(float (&d)[4 * DK],
                                                       const uint32_t (&a)[NTB / 2][4],
                                                       const bf16* trans) {
#pragma unroll
  for (int kk = 0; kk < NTB / 2; ++kk)
    wgmma_bf16_rs<DK>(d, a[kk], smem_desc(trans + kk * 8 * DK * 16, 128, 256));
}

// rows row[0], row[1] of out [t, d] from an accumulator, rounded to T
template <int DK, typename T>
__device__ __forceinline__ void store_acc_rows_t(T* out, const float (&acc)[4 * DK],
                                                 const int (&row)[2], int t, int d, int i4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= t) continue;
    T* p = out + (size_t)row[r] * d;
#pragma unroll
    for (int nt = 0; nt < DK; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * i4 + e;
        if (col < d) p[col] = from_f<T>(acc[4 * nt + 2 * r + e]);
      }
  }
}

// B5 on bf16 operands: one warpgroup per (64 query rows, batch*head), key
// tiles of TNB; DK even.
template <int DK>
__global__ void __launch_bounds__(128)
attn_bwd_q_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ mask,
                       const bf16* __restrict__ ek, const bf16* __restrict__ ev,
                       const bf16* __restrict__ g, const float* __restrict__ m,
                       const float* __restrict__ l, const float* __restrict__ dd,
                       bf16* __restrict__ dq, float* __restrict__ partials, int h, int t,
                       int d, int w, Drop drop) {
  static_assert(DK % 2 == 0, "k16 steps of the head width");
  using L = TilesBf16<DK>;
  constexpr int KCH = (TNB * DK + 127) / 128;  // 8-dim chunks of a tile a thread stages
  extern __shared__ __align__(16) float4 smem4[];
  bf16* Qa = reinterpret_cast<bf16*>(smem4);
  bf16* Ga = Qa + L::A;
  bf16* Kb = Ga + L::A;
  bf16* Vb = Kb + L::B;
  bf16* Kt = Vb + L::B;
  float* Rs = reinterpret_cast<float*>(Kt + L::B);  // [2][4 warps][16][16]
  float* Bs = Rs + 2 * 1024;                        // [2][64][12]
  float* Mk = Bs + 2 * 64 * 12;                     // [TNB]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, i4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const uint32_t salt = drop.salt(bh, h);
  const int q0 = blockIdx.x * 64;
  const int r0 = q0 + 16 * warp;  // this warp's first row
  const size_t base = (size_t)bh * t * d;
  const bf16* mrow = mask + (size_t)b * t;
  const int nb = 2 * w + 1;
  const bool vec = d % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)) & 15) == 0;

  stage_rows_bf16<DK>(Qa, q + base, q0, t, d, vec, tid);
  stage_rows_bf16<DK>(Ga, g + base, q0, t, d, vec, tid);
  for (int idx = tid; idx < 2 * 64 * 12; idx += 128) Bs[idx] = 0.f;
  // band logits q_r . ek[c] and g_r . ev[c] of the warp's rows, fp32, c < 16
  float* rk = Rs + warp * 256;
  float* rv = Rs + 1024 + warp * 256;
  for (int e = lane; e < 2 * 256; e += 32) {
    const int which = e / 256, r = (e / 16) % 16, c = e % 16;
    const bf16* row = (which ? g : q) + base + (size_t)(r0 + r) * d;
    const bf16* tab = (which ? ev : ek) + (size_t)c * d;
    float sum = 0.f;
    if (c < nb && r0 + r < t)
      for (int x = 0; x < d; ++x) sum = fmaf(to_f(row[x]), to_f(tab[x]), sum);
    (which ? rv : rk)[e % 256] = sum;
  }

  float mi[2], linv[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + gq + 8 * r;
    const size_t s = (size_t)bh * t + (i < t ? i : 0);
    mi[r] = i < t ? m[s] : 0.f;
    linv[r] = i < t ? 1.f / l[s] : 0.f;
    di[r] = i < t ? dd[s] : 0.f;
  }
  float acc[4 * DK];  // dq: element 4n + e: row gq + 8(e/2), dim 8n + 2i + e%2
#pragma unroll
  for (int e = 0; e < 4 * DK; ++e) acc[e] = 0.f;

  // K and V rows of a tile, 8 dims at a time, loaded one tile ahead
  uint4 kpre[KCH], vpre[KCH];
  float mpre = 0.f;
  auto load = [&](int j0) {
#pragma unroll
    for (int it = 0; it < KCH; ++it) {
      const int idx = tid + 128 * it;
      if (idx >= TNB * DK) break;
      const int key = idx % TNB, c8 = idx / TNB;
      kpre[it] = load8(k + base, j0 + key, 8 * c8, t, d, vec);
      vpre[it] = load8(v + base, j0 + key, 8 * c8, t, d, vec);
    }
    if (tid < TNB) mpre = j0 + tid < t ? to_f(mrow[j0 + tid]) : 0.f;
  };
  load(0);

  for (int j0 = 0; j0 < t; j0 += TNB) {
    __syncthreads();  // the previous tile's readers are done; Q, G, Rs, Bs visible
#pragma unroll
    for (int it = 0; it < KCH; ++it) {
      const int idx = tid + 128 * it;
      if (idx >= TNB * DK) break;
      const int key = idx % TNB, c8 = idx / TNB;
      store_tile_bf16<DK, true>(Kb, Kt, key, c8, kpre[it]);
      store_tile_bf16<DK, false>(Vb, nullptr, key, c8, vpre[it]);
    }
    if (tid < TNB) Mk[tid] = mpre;
    fence_async_smem();
    __syncthreads();
    if (j0 + TNB < t) load(j0 + TNB);  // in flight while this tile is computed

    // S = Q K^T and G V^T; element 4n + e: row gq + 8(e/2), key j0 + 8n + 2i + e%2
    float sc[4 * NTB], gv[4 * NTB];
#pragma unroll
    for (int e = 0; e < 4 * NTB; ++e) sc[e] = gv[e] = 0.f;
    wg_fence();
    wgmma_rows_dot_bf16<DK>(sc, Qa, Kb);
    wgmma_rows_dot_bf16<DK>(gv, Ga, Vb);
    wg_commit();
    wg_wait<0>();
    fence_operands(sc);
    fence_operands(gv);

    // ds = p (dp - D) in place of S (0 for a masked key or past t); the
    // band entries of ds and p*ks (fp32) to Bs
    const bool in_band = j0 <= r0 + 15 + w && j0 + TNB - 1 >= r0 - w;
#pragma unroll
    for (int e4 = 0; e4 < 4 * NTB; ++e4) {
      const int e = e4 % 4, r = e / 2;
      const int jj = (e4 / 4) * 8 + 2 * i4 + e % 2;
      const int rr = gq + 8 * r;
      const int i = r0 + rr, j = j0 + jj;
      float ds = 0.f;
      if (i < t && j < t) {
        const int c = j - i + w;
        const bool band = in_band && c >= 0 && c < nb;
        float x = sc[e4], dpv = gv[e4];
        if (band) {
          x += rk[rr * 16 + c];
          dpv += rv[rr * 16 + c];
        }
        const bool key = Mk[jj] != 0.f;
        if (!key) x = NEG_FILL;
        const float p = expf(x - mi[r]) * linv[r];
        float pd = p;
        if (drop.on) {
          const float ks = hash_keep(i, j, salt, drop.seed, drop.thr) ? drop.scale : 0.f;
          pd = p * ks;
          dpv *= ks;
        }
        ds = key ? p * (dpv - di[r]) : 0.f;
        if (band) {
          Bs[(16 * warp + rr) * 12 + c] = ds;
          Bs[(64 + 16 * warp + rr) * 12 + c] = pd;
        }
      }
      sc[e4] = ds;
    }

    // dQ += dS K: dS rounded to bf16 straight from the accumulator registers
    uint32_t da[NTB / 2][4];
    acc_frags_bf16(sc, da);
    wg_fence();
    wgmma_frags_times_bf16<DK>(acc, da, Kt);
    wg_commit();
    wg_wait<0>();
    fence_operands(acc);
  }

  // dq += band_ds . ek in fp32: the warp's own rows of Bs (it wrote them)
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < DK; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * i4 + e;
      if (col >= d) continue;
      float a0 = 0.f, a1 = 0.f;
      for (int c = 0; c < nb; ++c) {
        const float ekc = to_f(ek[(size_t)c * d + col]);
        a0 = fmaf(Bs[(16 * warp + gq) * 12 + c], ekc, a0);
        a1 = fmaf(Bs[(16 * warp + gq + 8) * 12 + c], ekc, a1);
      }
      acc[4 * nt + e] += a0;
      acc[4 * nt + 2 + e] += a1;
    }
  const int rows[2] = {r0 + gq, r0 + gq + 8};
  store_acc_rows_t<DK>(dq + base, acc, rows, t, d, i4);
  __syncthreads();  // every warp's band rows in Bs
  // this block's partial dek (which 0) and dev (which 1), [2][nb][d] =
  // band^T [nb x 64 rows] . Q or G [64 rows x d], fp32, a thread per entry
  float* part = partials + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * nb * d;
  for (int idx = tid; idx < 2 * nb * d; idx += 128) {
    const int which = idx / (nb * d), c = (idx / d) % nb, col = idx % d;
    const bf16* rows_s = which ? Ga : Qa;
    const float* band = Bs + which * 64 * 12;
    float sum = 0.f;
    for (int r = 0; r < 64; ++r)
      sum = fmaf(band[r * 12 + c], to_f(rows_s[kmajor_bf16<64>(r, col)]), sum);
    part[idx] = sum;
  }
}

// B6 on bf16 operands: one warpgroup per (64 keys, batch*head), query-row
// tiles of TNB; DK even.
template <int DK>
__global__ void __launch_bounds__(128)
attn_bwd_k_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ mask,
                       const bf16* __restrict__ ek, const bf16* __restrict__ ev,
                       const bf16* __restrict__ g, const float* __restrict__ m,
                       const float* __restrict__ l, const float* __restrict__ dd,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int t, int d,
                       int w, Drop drop) {
  static_assert(DK % 2 == 0, "k16 steps of the head width");
  using L = TilesBf16<DK>;
  constexpr int KCH = (TNB * DK + 127) / 128;
  extern __shared__ __align__(16) float4 smem4[];
  bf16* Ka = reinterpret_cast<bf16*>(smem4);
  bf16* Va = Ka + L::A;
  bf16* Qb = Va + L::A;
  bf16* Gb = Qb + L::B;
  bf16* Qt = Gb + L::B;
  bf16* Gt = Qt + L::B;
  float* Rk = reinterpret_cast<float*>(Gt + L::B);  // [KBR][NBAND]: q_i . ek[c]
  float* Rv = Rk + KBR * NBAND;                     // [KBR][NBAND]: g_i . ev[c]
  float* Ms = Rv + KBR * NBAND;                     // [TNB] row max
  float* Li = Ms + TNB;                             // [TNB] 1 / row sum
  float* Dr = Li + TNB;                             // [TNB] D_i

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, i4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const uint32_t salt = drop.salt(bh, h);
  const int k0 = blockIdx.x * 64;
  const size_t base = (size_t)bh * t * d;
  const size_t sbase = (size_t)bh * t;
  const int nb = 2 * w + 1;
  const int r0 = k0 - w;  // the first query row whose band reaches key k0
  const bool vec = d % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)) & 15) == 0;

  stage_rows_bf16<DK>(Ka, k + base, k0, t, d, vec, tid);
  stage_rows_bf16<DK>(Va, v + base, k0, t, d, vec, tid);
  // q_i . ek[c] and g_i . ev[c] of the KBR rows around the block's keys,
  // fp32, a thread per (table, row, column)
  for (int task = tid; task < 2 * KBR * nb; task += 128) {
    const int which = task / (KBR * nb), rr = (task / nb) % KBR, c = task % nb;
    const int i = r0 + rr;
    float sum = 0.f;
    if (i >= 0 && i < t) {
      const bf16* row = (which ? g : q) + base + (size_t)i * d;
      const bf16* tab = (which ? ev : ek) + (size_t)c * d;
      for (int x = 0; x < d; ++x) sum = fmaf(to_f(row[x]), to_f(tab[x]), sum);
    }
    (which ? Rv : Rk)[rr * NBAND + c] = sum;
  }

  int jr[2];  // this lane's two keys
  bool key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    jr[r] = k0 + 16 * warp + gq + 8 * r;
    key[r] = jr[r] < t && to_f(mask[(size_t)b * t + jr[r]]) != 0.f;
  }
  float adk[4 * DK], adv[4 * DK];  // element 4n + e: key gq + 8(e/2), dim 8n + 2i + e%2
#pragma unroll
  for (int e = 0; e < 4 * DK; ++e) adk[e] = adv[e] = 0.f;

  // Q and G rows of a tile and their statistics, loaded one tile ahead
  uint4 qpre[KCH], gpre[KCH];
  float mpre = 0.f, lpre = 0.f, dpre = 0.f;
  auto load = [&](int i0) {
#pragma unroll
    for (int it = 0; it < KCH; ++it) {
      const int idx = tid + 128 * it;
      if (idx >= TNB * DK) break;
      const int row = idx % TNB, c8 = idx / TNB;
      qpre[it] = load8(q + base, i0 + row, 8 * c8, t, d, vec);
      gpre[it] = load8(g + base, i0 + row, 8 * c8, t, d, vec);
    }
    if (tid < TNB) {
      const int i = i0 + tid;
      const bool in = i < t;
      mpre = in ? m[sbase + i] : 0.f;
      lpre = in ? 1.f / l[sbase + i] : 0.f;  // rows past t: p = 0
      dpre = in ? dd[sbase + i] : 0.f;
    }
  };
  load(0);

  for (int i0 = 0; i0 < t; i0 += TNB) {
    __syncthreads();  // the previous tile's readers are done; K, V, Rk, Rv visible
#pragma unroll
    for (int it = 0; it < KCH; ++it) {
      const int idx = tid + 128 * it;
      if (idx >= TNB * DK) break;
      const int row = idx % TNB, c8 = idx / TNB;
      store_tile_bf16<DK, true>(Qb, Qt, row, c8, qpre[it]);
      store_tile_bf16<DK, true>(Gb, Gt, row, c8, gpre[it]);
    }
    if (tid < TNB) {
      Ms[tid] = mpre;
      Li[tid] = lpre;
      Dr[tid] = dpre;
    }
    fence_async_smem();
    __syncthreads();
    if (i0 + TNB < t) load(i0 + TNB);  // in flight while this tile is computed

    // S^T = K Q^T and (G V^T)^T = V G^T; element 4n + e: key gq + 8(e/2),
    // row i0 + 8n + 2i + e%2
    float sc[4 * NTB], gv[4 * NTB];
#pragma unroll
    for (int e = 0; e < 4 * NTB; ++e) sc[e] = gv[e] = 0.f;
    wg_fence();
    wgmma_rows_dot_bf16<DK>(sc, Ka, Qb);
    wgmma_rows_dot_bf16<DK>(gv, Va, Gb);
    wg_commit();
    wg_wait<0>();
    fence_operands(sc);
    fence_operands(gv);

    // p*ks in place of S^T and ds = p (dp - D) in place of V G^T (0 for a
    // masked key, past t, or a row past t)
    const bool in_band = i0 <= k0 + 63 + w && i0 + TNB - 1 >= k0 - w;
#pragma unroll
    for (int e4 = 0; e4 < 4 * NTB; ++e4) {
      const int e = e4 % 4, r = e / 2;
      const int ii = (e4 / 4) * 8 + 2 * i4 + e % 2;
      const int i = i0 + ii, j = jr[r];
      const int c = j - i + w;
      const bool band = in_band && c >= 0 && c < nb;
      float x = sc[e4], dpv = gv[e4];
      if (band) {
        x += Rk[(i - r0) * NBAND + c];
        dpv += Rv[(i - r0) * NBAND + c];
      }
      if (!key[r]) x = NEG_FILL;
      const float p = i < t && j < t ? expf(x - Ms[ii]) * Li[ii] : 0.f;
      float pd = p;
      if (drop.on) {
        const float ks = hash_keep(i, j, salt, drop.seed, drop.thr) ? drop.scale : 0.f;
        pd = p * ks;
        dpv *= ks;
      }
      sc[e4] = pd;
      gv[e4] = key[r] ? p * (dpv - Dr[ii]) : 0.f;
    }

    // dV += Pd^T G and dK += dS^T Q: Pd^T and dS^T rounded to bf16 from
    // the registers
    uint32_t pa[NTB / 2][4], da[NTB / 2][4];
    acc_frags_bf16(sc, pa);
    acc_frags_bf16(gv, da);
    wg_fence();
    wgmma_frags_times_bf16<DK>(adv, pa, Gt);
    wgmma_frags_times_bf16<DK>(adk, da, Qt);
    wg_commit();
    wg_wait<0>();
    fence_operands(adv);
    fence_operands(adk);
  }
  store_acc_rows_t<DK>(dk + base, adk, jr, t, d, i4);
  store_acc_rows_t<DK>(dv + base, adv, jr, t, d, i4);
}

template <int DK, int TN, int WGS>
__global__ void __launch_bounds__(128 * WGS)
attn_bwd_k_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ ek, const float* __restrict__ ev,
                  const float* __restrict__ g, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ dd,
                  float* __restrict__ dk, float* __restrict__ dv, int h, int t,
                  int d, int w, Drop drop) {
  using L = Tiles<DK, TN, WGS>;
  constexpr int NT = L::NT, NTW = L::NTW, THREADS = L::THREADS;
  extern __shared__ __align__(16) float4 smem4[];
  float* Ka = reinterpret_cast<float*>(smem4);
  float* Va = Ka + L::A;
  float* Qb = Va + L::A;
  float* Gb = Qb + L::B;
  float* Qp = Gb + L::B;
  float* Gp = Qp + L::P;
  float* Rk = Gp + L::P;             // [KBR][NBAND]: q_i . ek[c]
  float* Rv = Rk + KBR * NBAND;      // [KBR][NBAND]: g_i . ev[c]
  float* Ms = Rv + KBR * NBAND;      // [TN] row max
  float* Li = Ms + TN;               // [TN] 1 / row sum
  float* Dr = Li + TN;               // [TN] D_i
  float* X = Qb;                     // at the end: the second warpgroup's sums

  const int tid = threadIdx.x;
  const int wg = WGS == 1 ? 0 : tid / 128, wt = tid % 128;  // rows [wg TN/WGS, +TN/WGS) of a tile
  const int warp = wt / 32, lane = tid % 32;
  const int gq = lane / 4, i4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const uint32_t salt = drop.salt(bh, h);
  const int k0 = blockIdx.x * 64;
  const size_t base = (size_t)bh * t * d;
  const size_t sbase = (size_t)bh * t;
  const int nb = 2 * w + 1;
  const int r0 = k0 - w;  // the first query row whose band reaches key k0
  const bool vec = d % 4 == 0;

  // q_i . ek[c] and g_i . ev[c] of the KBR rows around the block's keys,
  // before K and V are staged: the rows (rows padded to d + 1 floats) and
  // the tables ([d][12], one 16-byte load per 4 columns) in K's and V's
  // space; a thread per (row, table), 2w+1 independent sums
  {
    const int dp = d + 1;
    float* rows = Ka;                              // [2][KBR][dp]
    float* tabs = Ka + ((2 * KBR * dp + 3) & ~3);  // [2][d][12]
    // 4-float chunks of the rows, then of the tables, 8 loads in flight
    const int d4 = (d + 3) / 4;
    const int n_rows = 2 * KBR * d4, n_all = n_rows + 2 * nb * d4;
    for (int c0 = 0; c0 < n_all; c0 += THREADS * 8) {
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = c0 + tid + THREADS * u;
        const int which = idx < n_rows ? idx / (KBR * d4) : (idx - n_rows) / (nb * d4);
        const int rr = idx < n_rows ? (idx / d4) % KBR : ((idx - n_rows) / d4) % nb;
        const int ix = idx < n_rows ? r0 + rr : rr;
        const float* src = idx < n_rows ? (which ? g + base : q + base) : (which ? ev : ek);
        x[u] = idx < n_all && ix >= 0 ? load4(src, ix, 4 * (idx % d4), idx < n_rows ? t : nb, d, vec)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = c0 + tid + THREADS * u;
        if (idx >= n_all) break;
        const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
        const int e0 = 4 * (idx % d4);
        if (idx < n_rows) {
          float* row = rows + (idx / d4) * dp;
          for (int k4 = 0; k4 < 4 && e0 + k4 < d; ++k4) row[e0 + k4] = xs[k4];
        } else {
          const int j = idx - n_rows, which = j / (nb * d4), c = (j / d4) % nb;
          for (int k4 = 0; k4 < 4 && e0 + k4 < d; ++k4)
            tabs[(which * d + e0 + k4) * 12 + c] = xs[k4];
        }
      }
    }
    for (int idx = tid; idx < 2 * d * (12 - nb); idx += THREADS)  // the zero columns
      tabs[(idx / (12 - nb)) * 12 + nb + idx % (12 - nb)] = 0.f;
    __syncthreads();
    for (int task = tid; task < 2 * KBR; task += THREADS) {
      const int which = task / KBR, rr = task % KBR;
      const float* row = rows + task * dp;
      const float4* tab = reinterpret_cast<const float4*>(tabs + which * d * 12);
      float sum[12];
#pragma unroll
      for (int c = 0; c < 12; ++c) sum[c] = 0.f;
#pragma unroll 4
      for (int e = 0; e < d; ++e) {
        const float x = row[e];
#pragma unroll
        for (int c4 = 0; c4 < 3; ++c4) {
          const float4 tv = tab[e * 3 + c4];
          sum[4 * c4] = fmaf(x, tv.x, sum[4 * c4]);
          sum[4 * c4 + 1] = fmaf(x, tv.y, sum[4 * c4 + 1]);
          sum[4 * c4 + 2] = fmaf(x, tv.z, sum[4 * c4 + 2]);
          sum[4 * c4 + 3] = fmaf(x, tv.w, sum[4 * c4 + 3]);
        }
      }
      float* out = which ? Rv : Rk;
#pragma unroll
      for (int c = 0; c < NBAND; ++c) out[rr * NBAND + c] = sum[c];
    }
    __syncthreads();  // K and V overwrite the rows and tables
  }
  stage_rows<DK, THREADS>(Ka, k + base, Va, v + base, k0, t, d, vec, tid);

  int jr[2];  // this lane's two keys
  bool key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    jr[r] = k0 + 16 * warp + gq + 8 * r;
    key[r] = jr[r] < t && mask[(size_t)b * t + jr[r]] != 0.f;
  }
  float adk[4 * DK], adv[4 * DK];  // element 4n + e: key gq + 8(e/2), dim 8n + 2i + e%2
#pragma unroll
  for (int e = 0; e < 4 * DK; ++e) adk[e] = adv[e] = 0.f;

  // Q and G rows of a tile and their statistics, loaded one tile ahead
  float4 qpre[L::NLD], gpre[L::NLD];
  float mpre = 0.f, lpre = 0.f, dpre = 0.f;
  auto load = [&](int i0) {
#pragma unroll
    for (int it = 0; it < L::NLD; ++it) {
      const int idx = tid + THREADS * it;
      const int row = idx % TN, dim = 4 * (idx / TN);
      qpre[it] = load4(q + base, i0 + row, dim, t, d, vec);
      gpre[it] = load4(g + base, i0 + row, dim, t, d, vec);
    }
    if (tid < TN) {
      const int i = i0 + tid;
      const bool in = i < t;
      mpre = in ? m[sbase + i] : 0.f;
      lpre = in ? 1.f / l[sbase + i] : 0.f;  // rows past t: p = 0
      dpre = in ? dd[sbase + i] : 0.f;
    }
  };
  load(0);

  for (int i0 = 0; i0 < t; i0 += TN) {
    __syncthreads();  // the previous tile's readers are done; K, V, Rk, Rv visible
#pragma unroll
    for (int it = 0; it < L::NLD; ++it) {
      const int idx = tid + THREADS * it;
      if (TN * 2 * DK % THREADS && idx >= TN * 2 * DK) break;
      const int row = idx % TN, c4 = idx / TN;
      store_dim_major<DK, TN>(Qb, row, c4, qpre[it]);
      store_row_paired<DK, NT>(Qp, row, 4 * c4, qpre[it]);
      store_dim_major<DK, TN>(Gb, row, c4, gpre[it]);
      store_row_paired<DK, NT>(Gp, row, 4 * c4, gpre[it]);
    }
    if (tid < TN) {
      Ms[tid] = mpre;
      Li[tid] = lpre;
      Dr[tid] = dpre;
    }
    fence_async_smem();
    __syncthreads();
    if (i0 + TN < t) load(i0 + TN);  // in flight while this tile is computed

    // S^T = K Q^T, then (G V^T)^T = V G^T, over this warpgroup's rows, each
    // its own group; element 4n + e: key gq + 8(e/2), row i0 + wg TN/WGS +
    // 8n + 2i + e%2
    float sc[4 * NTW], gv[4 * NTW];
#pragma unroll
    for (int e = 0; e < 4 * NTW; ++e) sc[e] = gv[e] = 0.f;
    wg_fence();
    wgmma_rows_dot<DK, NTW, NT>(sc, Ka, Qb + wg * NTW * 64);
    wg_commit();
    wgmma_rows_dot<DK, NTW, NT>(gv, Va, Gb + wg * NTW * 64);
    wg_commit();

    // p while V G^T runs (0 past t)
    const int ib = i0 + wg * (TN / WGS);
    const bool in_band = ib <= k0 + 63 + w && ib + TN / WGS - 1 >= k0 - w;
    wg_wait<1>();
    fence_operands(sc);
#pragma unroll
    for (int e4 = 0; e4 < 4 * NTW; ++e4) {
      const int e = e4 % 4, r = e / 2;
      const int ii = wg * (TN / WGS) + (e4 / 4) * 8 + 2 * i4 + e % 2;
      const int i = i0 + ii, j = jr[r];
      const int c = j - i + w;
      float x = sc[e4];
      if (in_band && c >= 0 && c < nb) x += Rk[(i - r0) * NBAND + c];
      if (!key[r]) x = NEG_FILL;
      sc[e4] = i < t && j < t ? expf(x - Ms[ii]) * Li[ii] : 0.f;
    }
    wg_wait<0>();
    fence_operands(gv);
    // p*ks in place of p and ds = p (dp - D) in place of V G^T (0 for a
    // masked key)
#pragma unroll
    for (int e4 = 0; e4 < 4 * NTW; ++e4) {
      const int e = e4 % 4, r = e / 2;
      const int ii = wg * (TN / WGS) + (e4 / 4) * 8 + 2 * i4 + e % 2;
      const int i = i0 + ii, j = jr[r];
      const int c = j - i + w;
      const float p = sc[e4];
      float dpv = gv[e4];
      if (in_band && c >= 0 && c < nb) dpv += Rv[(i - r0) * NBAND + c];
      if (drop.on) {
        const float ks = hash_keep(i, j, salt, drop.seed, drop.thr) ? drop.scale : 0.f;
        sc[e4] = p * ks;
        dpv *= ks;
      }
      gv[e4] = key[r] ? p * (dpv - Dr[ii]) : 0.f;
    }

    // dV += Pd^T G and dK += dS^T Q over this warpgroup's rows, Pd^T and
    // dS^T from the registers
    const AccFrags<NTW> pf = acc_frags<NTW>(sc), df = acc_frags<NTW>(gv);
    const int pk = wg * NTW * PairLayout<DK>::KKS;
    wg_fence();
    wgmma_frags_times<DK, NTW, NT>(adv, pf, Gp + pk);
    wgmma_frags_times<DK, NTW, NT>(adk, df, Qp + pk);
    wg_commit();
    wg_wait<0>();
    fence_operands(adv);
    fence_operands(adk);
  }

  // with two warpgroups, the first writes dk and the second dv, each
  // adding the other's half through shared memory, element-wise by thread,
  // in a fixed order (the first warpgroup's sum first)
  if constexpr (WGS == 2) {
    __syncthreads();  // every tile's readers are done
#pragma unroll
    for (int e = 0; e < 4 * DK; ++e) X[(wg * 4 * DK + e) * 128 + wt] = wg ? adk[e] : adv[e];
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < 4 * DK; ++e) adk[e] += X[(4 * DK + e) * 128 + wt];
      store_acc_rows<DK>(dk + base, adk, jr, t, d, i4);
    } else {
#pragma unroll
      for (int e = 0; e < 4 * DK; ++e) adv[e] = X[e * 128 + wt] + adv[e];
      store_acc_rows<DK>(dv + base, adv, jr, t, d, i4);
    }
  } else {
    store_acc_rows<DK>(dk + base, adk, jr, t, d, i4);
    store_acc_rows<DK>(dv + base, adv, jr, t, d, i4);
  }
}

struct Args {
  const float *q, *k, *v, *mask, *ek, *ev, *g, *m, *l, *dd;
  int b, h, t, d, w;
  Drop drop;
  cudaStream_t stream;
};

// The shared-memory attribute of each instantiation is set once per device.
template <int DK, int TN>
int launch_q(const Args& a, float* dq, float* partials, float* dek, float* dev,
             int device) {
  static size_t configured[MAXDEV] = {};
  const size_t bytes = sizeof(float) * Tiles<DK, TN, 1>::q_total;
  cudaError_t err = allow_smem((const void*)attn_bwd_q_kernel<DK, TN>, bytes,
                               configured, device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + 63) / 64, a.b * a.h);
  attn_bwd_q_kernel<DK, TN><<<grid, 128, bytes, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.ek, a.ev, a.g, a.m, a.l, a.dd, dq, partials, a.h,
      a.t, a.d, a.w, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (2 * a.w + 1) * a.d;
  band_tables_reduce<float><<<(2 * n + 255) / 256, 256, 0, a.stream>>>(
      partials, grid.x * grid.y, n, dek, dev);
  return (int)cudaGetLastError();
}

template <int DK, int TN, int WGS>
int launch_k(const Args& a, float* dk, float* dv, int device) {
  static size_t configured[MAXDEV] = {};
  const size_t bytes = sizeof(float) * Tiles<DK, TN, WGS>::k_total;
  const cudaError_t err = allow_smem((const void*)attn_bwd_k_kernel<DK, TN, WGS>, bytes,
                                     configured, device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + 63) / 64, a.b * a.h);
  attn_bwd_k_kernel<DK, TN, WGS><<<grid, 128 * WGS, bytes, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.ek, a.ev, a.g, a.m, a.l, a.dd, dk, dv, a.h, a.t,
      a.d, a.w, a.drop);
  return (int)cudaGetLastError();
}

// bf16 modes: the same arguments, bf16 operands and outputs
struct ArgsBf16 {
  const bf16 *q, *k, *v, *mask, *ek, *ev, *g;
  const float *m, *l, *dd;
  int b, h, t, d, w;
  Drop drop;
  cudaStream_t stream;
};

template <int DK>
int launch_q_bf16(const ArgsBf16& a, bf16* dq, float* partials, bf16* dek, bf16* dev,
                  int device) {
  static size_t configured[MAXDEV] = {};
  const size_t bytes = TilesBf16<DK>::q_bytes;
  cudaError_t err = allow_smem((const void*)attn_bwd_q_bf16_kernel<DK>, bytes, configured,
                               device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + 63) / 64, a.b * a.h);
  attn_bwd_q_bf16_kernel<DK><<<grid, 128, bytes, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.ek, a.ev, a.g, a.m, a.l, a.dd, dq, partials, a.h, a.t, a.d,
      a.w, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (2 * a.w + 1) * a.d;
  band_tables_reduce<bf16><<<(2 * n + 255) / 256, 256, 0, a.stream>>>(
      partials, grid.x * grid.y, n, dek, dev);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_k_bf16(const ArgsBf16& a, bf16* dk, bf16* dv, int device) {
  static size_t configured[MAXDEV] = {};
  const size_t bytes = TilesBf16<DK>::k_bytes;
  const cudaError_t err = allow_smem((const void*)attn_bwd_k_bf16_kernel<DK>, bytes,
                                     configured, device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + 63) / 64, a.b * a.h);
  attn_bwd_k_bf16_kernel<DK><<<grid, 128, bytes, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.ek, a.ev, a.g, a.m, a.l, a.dd, dk, dv, a.h, a.t, a.d, a.w,
      a.drop);
  return (int)cudaGetLastError();
}

Args make_args(const float* q, const float* k, const float* v, const float* mask,
               const float* ek, const float* ev, const float* g, const float* m,
               const float* l, const float* dd, int b, int h, int t, int d, int w,
               int drop, int thr, int seed, int salt_base, int salt_stride, float scale,
               void* stream) {
  return Args{q, k, v, mask, ek, ev, g, m, l, dd, b, h, t, d, w,
              Drop{drop != 0, (uint32_t)thr, (uint32_t)seed, scale, (uint32_t)salt_base,
                   (uint32_t)salt_stride},
              (cudaStream_t)stream};
}

}  // namespace

// The number of B5 blocks, which the caller's partials buffer
// [blocks][2][2w+1][d] must hold.
extern "C" int banded_attn_bwd_q_blocks(int b, int h, int t) {
  return ((t + 63) / 64) * b * h;
}

// d in 8-wide steps picks the instantiation; the tile is 16 rows wide at
// d > 96 (shared memory), 32 below. B6 shares each tile between two
// warpgroups below d = 97 (one's softmax rebuild overlaps the other's
// products); B5 keeps one (with two, each S = Q K^T slice runs at N = 16
// and reads Q from shared memory twice as often: slower on the card), as
// does B6 at d > 96 (8-row halves).
#define BANDED_ATTN_BWD_DISPATCH(CALL)         \
  const int steps = (d + 7) / 8;               \
  if (steps <= 2) return CALL(2, 32, 2);       \
  if (steps <= 4) return CALL(4, 32, 2);       \
  if (steps <= 8) return CALL(8, 32, 2);       \
  if (steps <= 12) return CALL(12, 32, 2);     \
  return CALL(16, 16, 1)

// B5, then the reduction of its partials: dq [b,h,t,d], dek, dev [2w+1,d].
extern "C" int banded_attn_bwd_q(const float* q, const float* k, const float* v,
                                 const float* mask, const float* ek,
                                 const float* ev, const float* g,
                                 const float* m, const float* l,
                                 const float* dd, float* dq, float* partials,
                                 float* dek, float* dev, int b, int h, int t,
                                 int d, int w, int drop, int thr, int seed,
                                 int salt_base, int salt_stride, float scale,
                                 int device, void* stream) {
  if (bad_attn_shape(b, h, t, d, w, device)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const Args a = make_args(q, k, v, mask, ek, ev, g, m, l, dd, b, h, t, d, w, drop,
                           thr, seed, salt_base, salt_stride, scale, stream);
#define B5_CALL(DK, TN, WGS) launch_q<DK, TN>(a, dq, partials, dek, dev, device)
  BANDED_ATTN_BWD_DISPATCH(B5_CALL);
#undef B5_CALL
}

// B6: dk, dv [b,h,t,d].
extern "C" int banded_attn_bwd_k(const float* q, const float* k, const float* v,
                                 const float* mask, const float* ek,
                                 const float* ev, const float* g,
                                 const float* m, const float* l,
                                 const float* dd, float* dk, float* dv, int b,
                                 int h, int t, int d, int w, int drop, int thr,
                                 int seed, int salt_base, int salt_stride,
                                 float scale, int device, void* stream) {
  if (bad_attn_shape(b, h, t, d, w, device)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const Args a = make_args(q, k, v, mask, ek, ev, g, m, l, dd, b, h, t, d, w, drop,
                           thr, seed, salt_base, salt_stride, scale, stream);
#define B6_CALL(DK, TN, WGS) launch_k<DK, TN, WGS>(a, dk, dv, device)
  BANDED_ATTN_BWD_DISPATCH(B6_CALL);
#undef B6_CALL
}

// the bf16 modes' instantiation by k16 steps of d
#define BANDED_ATTN_BWD_BF16_DISPATCH(CALL) \
  const int steps = (d + 15) / 16;          \
  if (steps <= 1) return CALL(2);           \
  if (steps <= 2) return CALL(4);           \
  if (steps <= 4) return CALL(8);           \
  if (steps <= 6) return CALL(12);          \
  return CALL(16)

// B5 on bf16 operands, then the reduction of its fp32 partials into bf16
// dek, dev: q, k, v, mask, ek, ev, g, dq, dek, dev bf16; m, l, D, partials
// fp32.
extern "C" int banded_attn_bwd_q_bf16(const bf16* q, const bf16* k, const bf16* v,
                                      const bf16* mask, const bf16* ek, const bf16* ev,
                                      const bf16* g, const float* m, const float* l,
                                      const float* dd, bf16* dq, float* partials,
                                      bf16* dek, bf16* dev, int b, int h, int t, int d,
                                      int w, int drop, int thr, int seed, int salt_base,
                                      int salt_stride, float scale, int device,
                                      void* stream) {
  if (bad_attn_shape(b, h, t, d, w, device)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const ArgsBf16 a{q, k, v, mask, ek, ev, g, m, l, dd, b, h, t, d, w,
                   Drop{drop != 0, (uint32_t)thr, (uint32_t)seed, scale,
                        (uint32_t)salt_base, (uint32_t)salt_stride},
                   (cudaStream_t)stream};
#define B5_BF16_CALL(DK) launch_q_bf16<DK>(a, dq, partials, dek, dev, device)
  BANDED_ATTN_BWD_BF16_DISPATCH(B5_BF16_CALL);
#undef B5_BF16_CALL
}

// B6 on bf16 operands: dk, dv [b,h,t,d] bf16.
extern "C" int banded_attn_bwd_k_bf16(const bf16* q, const bf16* k, const bf16* v,
                                      const bf16* mask, const bf16* ek, const bf16* ev,
                                      const bf16* g, const float* m, const float* l,
                                      const float* dd, bf16* dk, bf16* dv, int b, int h,
                                      int t, int d, int w, int drop, int thr, int seed,
                                      int salt_base, int salt_stride, float scale,
                                      int device, void* stream) {
  if (bad_attn_shape(b, h, t, d, w, device)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const ArgsBf16 a{q, k, v, mask, ek, ev, g, m, l, dd, b, h, t, d, w,
                   Drop{drop != 0, (uint32_t)thr, (uint32_t)seed, scale,
                        (uint32_t)salt_base, (uint32_t)salt_stride},
                   (cudaStream_t)stream};
#define B6_BF16_CALL(DK) launch_k_bf16<DK>(a, dk, dv, device)
  BANDED_ATTN_BWD_BF16_DISPATCH(B6_BF16_CALL);
#undef B6_BF16_CALL
}
