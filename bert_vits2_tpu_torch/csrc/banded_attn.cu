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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "banded_attn_hash.cuh"

namespace {

constexpr int BK = 32;              // keys per tile
constexpr int NKT = BK / 8;         // 8-key tiles per key tile
constexpr int DMAX = 128;           // largest head width
constexpr int WMAX = 4;             // largest window
constexpr int NBAND = 2 * WMAX + 1;
constexpr int MAXDEV = 64;
constexpr float NEG_FILL = -1e4f;

// v = hi + lo for the TF32 tensor cores, in integer and fp32 ops at full
// rate (cvt.rna.tf32 runs on the conversion pipe, 16 lanes a clock): hi is
// v rounded to nearest TF32, ties away from zero (cvt.rna's rounding: add
// half a TF32 ulp, clear the 13 low bits), lo = v - hi exactly; the tensor
// core ignores lo's 13 low bits, so lo loses at most 2**-10 of itself, i.e.
// 2**-21 of |v|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// v -> (hi, lo) as floats, for shared memory
__device__ __forceinline__ float2 split2(float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: a as (hi, lo) fragments, b as (hi0, hi1, lo0, lo1)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float4 b) {
  const uint32_t h0 = __float_as_uint(b.x), h1 = __float_as_uint(b.y);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ah, h0, h1);
}

// (hi(x), hi(y), lo(x), lo(y)): one B-fragment slot
__device__ __forceinline__ float4 slot(float x, float y) {
  const float2 a = split2(x), b = split2(y);
  return make_float4(a.x, b.x, a.y, b.y);
}

__device__ __forceinline__ uint64_t smem_desc(const float* p, int lbo, int sbo) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// d += a * B (m64 x 8NT x k8, TF32): a from registers (the mma.m16n8k8
// A fragment of each warp's 16 rows), B from shared memory by descriptor
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[4 * NT], const uint32_t (&a)[4],
                                           uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_tf32<2>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<4>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<12>(float (&d)[48], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += A * B (m64n32k8, TF32), both from shared memory by descriptor
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// Shared memory of a block, in floats. Q, K and V are stored split (hi,
// lo) as wgmma operands in 8-row x 16-byte core matrices:
// - Q (A of S: M = rows, K = dims): part p, k step ks, 8-row group rg, K
//   half kh, row r, column c: at (p*DK + ks)*512 + rg*64 + kh*32 + 4r + c;
//   LBO 128 B, SBO 256 B.
// - K (B of S = Q K^T: N = keys, K = dims): part p, k step ks, 8-key group
//   jg, K half kh, row r (key), column c (dim): at
//   (p*DK + ks)*256 + jg*64 + kh*32 + 4r + c; LBO 128 B, SBO 256 B.
// - V (B of P V: N = dims, K = keys in P's register order, k index c <->
//   key 2c and c + 4 <-> key 2c + 1): part p, k step kk, K half kh, 8-dim
//   group dg, row r (dim), column c: at p*4*KKS + kk*KKS + kh*VLBO +
//   dg*32 + 4r + c with VLBO = 32*DK + 4 and KKS = 2*VLBO (4 and 8 mod
//   32: the 32 keys a warp stores land in 32 banks); LBO 4*VLBO B, SBO 128 B.
template <int DK>
struct Layout {
  static constexpr int VLBO = 32 * DK + 4;
  static constexpr int KKS = 2 * VLBO;
  static constexpr int Q = 2 * DK * 512;        // as K, 8 row groups of 64 rows
  static constexpr int K = 2 * DK * 256;
  static constexpr int V = 2 * NKT * KKS;
  static constexpr int R = 4 * 256;             // [4 warps][16][16] band logits
  static constexpr int total = Q + K + V + R + BK;
};

size_t smem_bytes(int dk) {
  switch (dk) {
    case 2: return sizeof(float) * Layout<2>::total;
    case 4: return sizeof(float) * Layout<4>::total;
    case 8: return sizeof(float) * Layout<8>::total;
    case 12: return sizeof(float) * Layout<12>::total;
    default: return sizeof(float) * Layout<16>::total;
  }
}

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
                       bool drop, uint32_t thr, uint32_t seed, float keep_scale) {
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
  const int r0 = (blockIdx.x * 4 + warp) * 16;  // this warp's first row
  const size_t base = (size_t)bh * t * d;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const float* mrow = mask + (size_t)b * t;
  const int nb = 2 * w + 1;
  const bool vec = d % 4 == 0;
  auto at = [&](const float* p, int row, int col) {
    return row < t && col < d ? p[(size_t)row * d + col] : 0.f;
  };
  auto at4 = [&](const float* p, int row, int col) {
    if (vec)
      return row < t && col < d ? *reinterpret_cast<const float4*>(p + (size_t)row * d + col)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    return make_float4(at(p, row, col), at(p, row, col + 1), at(p, row, col + 2),
                       at(p, row, col + 3));
  };

  // Q rows [64 blockIdx.x, +64), split; a warp's 32 lanes take 32 rows of
  // one 4-dim chunk (conflict-free 16-byte stores)
  const int q0 = blockIdx.x * 64;
#pragma unroll
  for (int it = 0; it < DK; ++it) {
    const int idx = tid + 128 * it;
    const int row = idx % 64, c4 = idx / 64;
    const float4 qv = at4(qb, q0 + row, 4 * c4);
    const float qx[4] = {qv.x, qv.y, qv.z, qv.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(qx[e], hi[e], lo[e]);
    float* qd = Qc + (c4 / 2) * 512 + (row / 8) * 64 + (c4 % 2) * 32 + (row % 8) * 4;
    *reinterpret_cast<uint4*>(qd) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(qd + DK * 512) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();
  // band logits R[r, c] = q_r . ek[c], c < 16 (zero past 2w)
  float* rw = Rs + warp * 256;
  {
    float rb[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < DK; ++ks) {
      // a0 (row 16w + g, dim 8ks + i), a1 (row + 8), a2 (dim + 4), a3 (both)
      const float* qf = Qc + ks * 512 + (2 * warp) * 64 + g * 4 + i4;
      const uint32_t ah[4] = {__float_as_uint(qf[0]), __float_as_uint(qf[64]),
                              __float_as_uint(qf[32]), __float_as_uint(qf[96])};
      const float* qg = qf + DK * 512;
      const uint32_t al[4] = {__float_as_uint(qg[0]), __float_as_uint(qg[64]),
                              __float_as_uint(qg[32]), __float_as_uint(qg[96])};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = nt * 8 + g, e = ks * 8 + i4;
        const bool ok = c < nb;
        mma3(rb[nt], ah, al,
             slot(ok && e < d ? ek[c * d + e] : 0.f,
                  ok && e + 4 < d ? ek[c * d + e + 4] : 0.f));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rw[(g + 8 * (e / 2)) * 16 + nt * 8 + 2 * i4 + e % 2] = rb[nt][e];
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
      kpre[it] = at4(kb, j0 + key, dim);
      vpre[it] = at4(vb, j0 + key, dim);
    }
    if (tid < BK) mpre = j0 + tid < t ? mrow[j0 + tid] : 0.f;
  };
  load(0);

  for (int j0 = 0; j0 < t; j0 += BK) {
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int it = 0; it < DK / 2; ++it) {
      const int idx = tid + 128 * it;
      const int key = idx % BK, c4 = idx / BK, dim = 4 * c4;
      const float kx[4] = {kpre[it].x, kpre[it].y, kpre[it].z, kpre[it].w};
      const float vx[4] = {vpre[it].x, vpre[it].y, vpre[it].z, vpre[it].w};
      uint32_t kh4[4], kl4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(kx[e], kh4[e], kl4[e]);
      float* kd = Kc + (c4 / 2) * 256 + (key / 8) * 64 + (c4 % 2) * 32 + (key % 8) * 4;
      *reinterpret_cast<uint4*>(kd) = make_uint4(kh4[0], kh4[1], kh4[2], kh4[3]);
      *reinterpret_cast<uint4*>(kd + DK * 256) = make_uint4(kl4[0], kl4[1], kl4[2], kl4[3]);
      float* vd = Vc + (key / 8) * L::KKS + (key % 2) * L::VLBO + (dim / 8) * 32 +
                  (dim % 8) * 4 + (key % 8) / 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi, lo;
        split(vx[e], hi, lo);
        vd[4 * e] = __uint_as_float(hi);
        vd[4 * e + NKT * L::KKS] = __uint_as_float(lo);
      }
    }
    if (tid < BK) Mk[tid] = mpre;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (j0 + BK < t) load(j0 + BK);  // in flight while this tile is computed

    // S = Q K^T: per k step lo*hi, hi*lo, hi*hi, all from shared memory
    float sc[4 * NKT];  // element 4n + e: row g + 8(e/2), key j0 + 8n + 2i + e%2
#pragma unroll
    for (int e = 0; e < 4 * NKT; ++e) sc[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DK; ++ks) {
      const float* qh = Qc + ks * 512;
      const float* kh = Kc + ks * 256;
      wgmma_ss_n32(sc, smem_desc(qh + DK * 512, 128, 256), smem_desc(kh, 128, 256));
      wgmma_ss_n32(sc, smem_desc(qh, 128, 256), smem_desc(kh + DK * 256, 128, 256));
      wgmma_ss_n32(sc, smem_desc(qh, 128, 256), smem_desc(kh, 128, 256));
    }
    wg_commit();
    wg_wait<0>();
    fence_operands(sc);

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
        pv = hash_keep(r0 + rr, j0 + jj, bh, seed, thr) ? p * keep_scale : 0.f;
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

    // O += P V: k step kk is 8-key tile kk with k index i <-> key 2i and
    // i + 4 <-> key 2i + 1, so a = (p[g][2i], p[g+8][2i], p[g][2i+1], p[g+8][2i+1])
    {
      uint32_t ph[NKT][4], pl[NKT][4];
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk) {
        split(sc[4 * kk + 0], ph[kk][0], pl[kk][0]);
        split(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
        split(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
        split(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk) {
        const float* vh = Vc + kk * L::KKS;
        wgmma_tf32<DK>(o, pl[kk], smem_desc(vh, 4 * L::VLBO, 128));
        wgmma_tf32<DK>(o, ph[kk], smem_desc(vh + NKT * L::KKS, 4 * L::VLBO, 128));
        wgmma_tf32<DK>(o, ph[kk], smem_desc(vh, 4 * L::VLBO, 128));
      }
      wg_commit();
      wg_wait<0>();
      fence_operands(o);
    }
  }

  // the band term: sum the quad's partial band rows, then O += band . ev
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NBAND; ++c) {
      band[r][c] += __shfl_xor_sync(0xffffffffu, band[r][c], 1);
      band[r][c] += __shfl_xor_sync(0xffffffffu, band[r][c], 2);
    }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};  // (g, i), (g+8, i), (g, i+4), (g+8, i+4)
#pragma unroll
    for (int cc = 0; cc < NBAND; ++cc) {
      if (cc == ks * 8 + i4) { a[0] = band[0][cc]; a[1] = band[1][cc]; }
      if (cc == ks * 8 + i4 + 4) { a[2] = band[0][cc]; a[3] = band[1][cc]; }
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
    const int c0 = ks * 8 + i4, c1 = c0 + 4;
#pragma unroll
    for (int nt = 0; nt < DK; ++nt) {
      const int col = nt * 8 + g;
      mma3(*reinterpret_cast<float(*)[4]>(o + 4 * nt), ah, al,
           slot(c0 < nb && col < d ? ev[c0 * d + col] : 0.f,
                c1 < nb && col < d ? ev[c1 * d + col] : 0.f));
    }
  }

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

// The shared-memory attribute is set once per instantiation, device and
// size: the largest size set so far is kept.
template <int DK, bool TRAIN>
int launch_dk(const float* q, const float* k, const float* v, const float* mask,
              const float* ek, const float* ev, float* out, float* m, float* l,
              int b, int h, int t, int d, int w, bool drop, uint32_t thr,
              uint32_t seed, float keep_scale, int device, cudaStream_t stream) {
  static size_t configured[MAXDEV] = {};
  const size_t bytes = smem_bytes(DK);
  if (bytes > configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_attn_fwd_kernel<DK, TRAIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured[device] = bytes;
  }
  dim3 grid((t + 63) / 64, b * h);
  banded_attn_fwd_kernel<DK, TRAIN><<<grid, 128, bytes, stream>>>(
      q, k, v, mask, ek, ev, out, m, l, h, t, d, w, drop, thr, seed, keep_scale);
  return (int)cudaGetLastError();
}

template <bool TRAIN>
int launch(const float* q, const float* k, const float* v, const float* mask,
           const float* ek, const float* ev, float* out, float* m, float* l,
           int b, int h, int t, int d, int w, bool drop, uint32_t thr,
           uint32_t seed, float keep_scale, int device, void* stream) {
  if (d < 1 || d > DMAX || w < 0 || w > WMAX || t < 2 * w || t < 1 || b < 1 ||
      h < 1 || b * h > 65535 || device < 0 || device >= MAXDEV)
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int steps = (d + 7) / 8;
#define BANDED_ATTN_LAUNCH(DK)                                                   \
  return launch_dk<DK, TRAIN>(q, k, v, mask, ek, ev, out, m, l, b, h, t, d, w,  \
                              drop, thr, seed, keep_scale, device, s)
  if (steps <= 2) BANDED_ATTN_LAUNCH(2);
  if (steps <= 4) BANDED_ATTN_LAUNCH(4);
  if (steps <= 8) BANDED_ATTN_LAUNCH(8);
  if (steps <= 12) BANDED_ATTN_LAUNCH(12);
  BANDED_ATTN_LAUNCH(16);
#undef BANDED_ATTN_LAUNCH
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
