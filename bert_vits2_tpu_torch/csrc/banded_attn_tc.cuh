// What the banded attention's forward (banded_attn.cu) and backward
// (banded_attn_bwd.cu) kernels share: the 3xTF32 split, the wgmma TF32
// wrappers, the band-logit and band-term products, and the host side of a
// launch; and, by operand type, what K1's bf16 mode and the wide kernels'
// bf16 forward (banded_attn_wide.cu) read and write: the float / bf16
// conversions, the wgmma bf16 wrappers and the bf16 operand layout.
//
// 3xTF32: an fp32 operand v is split into hi (v rounded to TF32) and lo =
// v - hi, and a product is summed as lo*hi + hi*lo + hi*hi in fp32, which
// keeps fp32 accuracy against the reference's "highest" precision.
//
// wgmma TF32 takes A and B K-major only, in 8-row x 16-byte core matrices
// (no swizzle); a descriptor's leading byte offset is the K step between
// the two 4-wide K halves of a k8 step, its stride byte offset the step
// between 8-row groups along M or N (utils/tc_probe.py checks this on the
// card). The accumulator of m64nN: lane 4g + i of warp w holds element
// 4n + e at row 16w + g + 8(e/2), column 8n + 2i + e%2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

constexpr int DMAX = 128;  // largest head width
constexpr int WMAX = 4;    // largest window
constexpr int NBAND = 2 * WMAX + 1;
constexpr int MAXDEV = 64;
constexpr float NEG_FILL = -1e4f;  // the reference's fill for a masked key

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
// generic-proxy shared-memory writes made visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// d += A * B (m64 x 8NT x k8, TF32), both from shared memory by descriptor
template <int NT>
__device__ __forceinline__ void wgmma_ss(float (&d)[4 * NT], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss<2>(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<4>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// Operand layouts in shared memory, in floats, each stored split (the lo
// part one `part` stride after the hi part):
// - K-major along the head dims, ROWS rows (64 for an A operand, the tile
//   width for a B operand): k step ks, 8-row group rg, K half kh, row r,
//   column c at ks*ROWS*8 + rg*64 + kh*32 + 4r + c; LBO 128 B, SBO 256 B.
// - K-major along a tile's NT 8-row groups, the head dims as N (the B of
//   an accumulator-times-rows product, e.g. P V): the accumulator's k
//   index c holds tile row 2c and c + 4 holds 2c + 1 (its columns 2i,
//   2i+1), so each row is stored in that order: 8-row group kk, K half kh,
//   8-dim group dg, dim r, column c at kk*KKS + kh*VLBO + dg*32 + 4r + c,
//   VLBO = 32*DK + 4 and KKS = 2*VLBO (4 and 8 mod 32: the 32 rows a warp
//   stores land in 32 banks); LBO 4*VLBO B, SBO 128 B.
template <int DK>
struct PairLayout {
  static constexpr int VLBO = 32 * DK + 4;
  static constexpr int KKS = 2 * VLBO;
};

// dims [4 c4, +4) of row `row`, split, K-major along the dims
template <int DK, int ROWS>
__device__ __forceinline__ void store_dim_major(float* base, int row, int c4, float4 v) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], hi[e], lo[e]);
  float* p = base + (c4 / 2) * (ROWS * 8) + (row / 8) * 64 + (c4 % 2) * 32 + (row % 8) * 4;
  *reinterpret_cast<uint4*>(p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(p + DK * ROWS * 8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// dims [dim, +4) of tile row `row`, split, K-major along the NT 8-row
// groups of the tile (PairLayout)
template <int DK, int NT>
__device__ __forceinline__ void store_row_paired(float* base, int row, int dim, float4 v) {
  using L = PairLayout<DK>;
  const float x[4] = {v.x, v.y, v.z, v.w};
  float* p = base + (row / 8) * L::KKS + (row % 2) * L::VLBO + (dim / 8) * 32 +
             (dim % 8) * 4 + (row % 8) / 2;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t hi, lo;
    split(x[e], hi, lo);
    p[4 * e] = __uint_as_float(hi);
    p[4 * e + NT * L::KKS] = __uint_as_float(lo);
  }
}

// The A fragments of an accumulator-times-rows product, split: k step kk
// takes the accumulator's columns 8kk + 2i (k index i) and 8kk + 2i + 1
// (k index i + 4) of each lane's two rows
template <int NT>
struct AccFrags {
  uint32_t hi[NT][4], lo[NT][4];
};
template <int NT>
__device__ __forceinline__ AccFrags<NT> acc_frags(const float (&acc)[4 * NT]) {
  AccFrags<NT> f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    split(acc[4 * kk + 0], f.hi[kk][0], f.lo[kk][0]);
    split(acc[4 * kk + 2], f.hi[kk][1], f.lo[kk][1]);
    split(acc[4 * kk + 1], f.hi[kk][2], f.lo[kk][2]);
    split(acc[4 * kk + 3], f.hi[kk][3], f.lo[kk][3]);
  }
  return f;
}

// d += acc * B over NT k steps, 3xTF32: acc's fragments from registers
// (acc_frags, split before the wgmma fence), B the NT 8-row groups at
// `tile` of a PairLayout tile of NTB groups (its lo part NTB groups on)
template <int DK, int NT, int NTB = NT>
__device__ __forceinline__ void wgmma_frags_times(float (&d)[4 * DK], const AccFrags<NT>& f,
                                                  const float* tile) {
  using L = PairLayout<DK>;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    const float* bh = tile + kk * L::KKS;
    wgmma_tf32<DK>(d, f.lo[kk], smem_desc(bh, 4 * L::VLBO, 128));
    wgmma_tf32<DK>(d, f.hi[kk], smem_desc(bh + NTB * L::KKS, 4 * L::VLBO, 128));
    wgmma_tf32<DK>(d, f.hi[kk], smem_desc(bh, 4 * L::VLBO, 128));
  }
}

// d += A B^T over DK k steps, 3xTF32, both from shared memory: A 64 rows
// and B the 8NT rows at b of a tile of 8NTB rows, K-major along the dims
// (store_dim_major)
template <int DK, int NT, int NTB = NT>
__device__ __forceinline__ void wgmma_rows_dot(float (&d)[4 * NT], const float* a, const float* b) {
#pragma unroll
  for (int ks = 0; ks < DK; ++ks) {
    const float* ah = a + ks * 512;
    const float* bh = b + ks * NTB * 64;
    wgmma_ss<NT>(d, smem_desc(ah + DK * 512, 128, 256), smem_desc(bh, 128, 256));
    wgmma_ss<NT>(d, smem_desc(ah, 128, 256), smem_desc(bh + DK * NTB * 64, 128, 256));
    wgmma_ss<NT>(d, smem_desc(ah, 128, 256), smem_desc(bh, 128, 256));
  }
}

// Band logits of a warp's 16 rows, rw[r * 16 + c] = a_r . tab[c] for c <
// 16 (zero past 2w): the rows from an A operand stored K-major along the
// dims (64 rows, split), tab [nb][d] from global memory; mma.sync, tab as
// 16 zero-padded columns.
template <int DK>
__device__ __forceinline__ void band_logits(const float* a, const float* __restrict__ tab,
                                            int nb, int d, float* rw, int warp, int g,
                                            int i4) {
  // the table's fragments first: independent loads, one latency
  float tv[DK][2][2];
#pragma unroll
  for (int ks = 0; ks < DK; ++ks)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = nt * 8 + g, e = ks * 8 + i4;
      const bool ok = c < nb;
      tv[ks][nt][0] = ok && e < d ? tab[c * d + e] : 0.f;
      tv[ks][nt][1] = ok && e + 4 < d ? tab[c * d + e + 4] : 0.f;
    }
  float rb[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < DK; ++ks) {
    // a0 (row 16w + g, dim 8ks + i), a1 (row + 8), a2 (dim + 4), a3 (both)
    const float* qf = a + ks * 512 + (2 * warp) * 64 + g * 4 + i4;
    const uint32_t ah[4] = {__float_as_uint(qf[0]), __float_as_uint(qf[64]),
                            __float_as_uint(qf[32]), __float_as_uint(qf[96])};
    const float* qg = qf + DK * 512;
    const uint32_t al[4] = {__float_as_uint(qg[0]), __float_as_uint(qg[64]),
                            __float_as_uint(qg[32]), __float_as_uint(qg[96])};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) mma3(rb[nt], ah, al, slot(tv[ks][nt][0], tv[ks][nt][1]));
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rw[(g + 8 * (e / 2)) * 16 + nt * 8 + 2 * i4 + e % 2] = rb[nt][e];
}

// o += band . tab for a warp's 16 rows: band [16 x 16] (each lane holding
// its rows g, g + 8; zero past 2w) times tab [nb][d] from global memory,
// 3xTF32 mma.sync; o in the accumulator layout of m64n(8DK)
template <int DK>
__device__ __forceinline__ void add_band_term(float (&o)[4 * DK], const float (&band)[2][NBAND],
                                              const float* __restrict__ tab, int nb, int d,
                                              int g, int i4) {
  // the table's fragments first: independent loads, one latency
  float tv[2][DK][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int nt = 0; nt < DK; ++nt) {
      const int c0 = ks * 8 + i4, c1 = c0 + 4, col = nt * 8 + g;
      tv[ks][nt][0] = c0 < nb && col < d ? tab[c0 * d + col] : 0.f;
      tv[ks][nt][1] = c1 < nb && col < d ? tab[c1 * d + col] : 0.f;
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
#pragma unroll
    for (int nt = 0; nt < DK; ++nt)
      mma3(*reinterpret_cast<float(*)[4]>(o + 4 * nt), ah, al,
           slot(tv[ks][nt][0], tv[ks][nt][1]));
  }
}

// four consecutive values of row `row` from col of a [t, d] matrix, zero
// past t and d; one 16-byte load when d % 4 == 0
__device__ __forceinline__ float4 load4(const float* p, int row, int col, int t, int d,
                                        bool vec) {
  auto at = [&](int c) { return row < t && c < d ? p[(size_t)row * d + c] : 0.f; };
  if (vec)
    return row < t && col < d ? *reinterpret_cast<const float4*>(p + (size_t)row * d + col)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(at(col), at(col + 1), at(col + 2), at(col + 3));
}

// ---- operand types: float (fp32 entry points) and bf16 (bf16 modes) ----

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
// x as the operand type holds it (rounded to nearest even for bf16)
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// (lo, hi) rounded to bf16, lo in the low half: one 32-bit fragment
// register of a bf16 MMA (the lower k index first)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint64_t smem_desc(const bf16* p, int lbo, int sbo) {
  return smem_desc(reinterpret_cast<const float*>(p), lbo, sbo);
}

// bf16 operands in shared memory, K-major, as 8-row x 16-byte core matrices
// of 8 values a row (no swizzle): element (row, col) of an operand of ROWS
// rows (M or N) by K columns lies at k16 step col / 16, 8-row group row / 8,
// K half (col / 8) % 2, row % 8, value col % 8, i.e. at
//   (col / 16) * ROWS * 16 + (row / 8) * 128 + ((col / 8) % 2) * 64 +
//   (row % 8) * 8 + col % 8
// bf16 elements; a k16 step's descriptor starts at (col / 16) * ROWS * 16
// with LBO 128 B (the K half) and SBO 256 B (the 8-row group), the layout
// of the TF32 operands with 8 values to a 16-byte row.
template <int ROWS>
__device__ __forceinline__ int kmajor_bf16(int row, int col) {
  return (col / 16) * ROWS * 16 + (row / 8) * 128 + ((col / 8) % 2) * 64 + (row % 8) * 8 +
         col % 8;
}

// d += A * B (m64 x 8NT x k16, bf16 operands, fp32 accumulators), both from
// shared memory by descriptor, both K-major
template <int NT>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[4 * NT], uint64_t da, uint64_t db);
// d += a * B (m64 x 8NT x k16, bf16): a from registers, the A fragment of
// mma.m16n8k16 for each warp's 16 rows (lane 4g + i: {row g, cols 2i, 2i+1},
// {row g + 8, the same}, {row g, cols 2i + 8, 2i + 9}, {row g + 8, the
// same}), B K-major from shared memory by descriptor
template <int NT>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[4 * NT], const uint32_t (&a)[4],
                                              uint64_t db);
template <>
__device__ __forceinline__ void wgmma_bf16_ss<4>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16_rs<2>(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16_rs<4>(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16_rs<8>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16_rs<12>(float (&d)[48], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16_rs<16>(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// eight consecutive values of row `row` from col of a [t, d] bf16 matrix,
// zero past t and d; one 16-byte load when vec (d % 8 == 0, aligned)
__device__ __forceinline__ uint4 load8(const bf16* p, int row, int col, int t, int d,
                                       bool vec) {
  if (vec)
    return row < t && col < d ? *reinterpret_cast<const uint4*>(p + (size_t)row * d + col)
                              : make_uint4(0u, 0u, 0u, 0u);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = col + 2 * e;
    const float lo = row < t && c < d ? __bfloat162float(p[(size_t)row * d + c]) : 0.f;
    const float hi = row < t && c + 1 < d ? __bfloat162float(p[(size_t)row * d + c + 1]) : 0.f;
    w[e] = pack_bf16(lo, hi);  // exact: both are bf16 values
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The shapes every banded-attention entry point takes.
inline bool bad_attn_shape(int b, int h, int t, int d, int w, int device) {
  return d < 1 || d > DMAX || w < 0 || w > WMAX || t < 2 * w || t < 1 || b < 1 ||
         h < 1 || b * h > 65535 || device < 0 || device >= MAXDEV;
}

// cudaSetDevice only when the current device differs
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

// Raise a kernel's dynamic shared-memory limit to `bytes` once per
// device: `configured` is the kernel's own table (one per instantiation),
// holding the largest size set so far.
inline cudaError_t allow_smem(const void* kernel, size_t bytes, size_t* configured,
                              int device) {
  if (bytes <= configured[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured[device] = bytes;
  return err;
}
