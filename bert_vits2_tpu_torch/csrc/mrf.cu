// Fused multi-receptive-field (MRF) stack of the HiFi-GAN vocoder (inference).
//
// Replaces both TPU kernels of bert_vits2_tpu/ops/mrf_pallas.py:
// `_mrf_kernel` and `_mrf_folded_kernel`. They compute one function; the
// second only refolds time into the TPU MXU's rows. For each upsample stage
// with 0 < C < 128 channels it computes, on x [B, C, T] and a 0/1 frame mask
// m [B, T]:
//
//   for each block j (kernel k_j, dilations d_j,s):
//     y = x
//     for each stage s:
//       a = conv(lrelu(y) * m, W1[j,s], b1[j,s], dilation d_j,s)
//       a = conv(lrelu(a) * m, W2[j,s], b2[j,s], dilation 1)
//       y = y + a
//     acc += y * m
//   out = acc / n_blocks
//
// with "same" zero padding at the sequence edges (reference ResBlock1,
// modules.py:221-322, with the static-shape re-masking of
// bert_vits2_tpu/models/generator.py).
//
// What bounds it on the card: 2*C*C*k multiply-adds per conv per sample,
// 18 convs per sample. At C = 64, 32, 16 that is 1.0, 0.26 and 0.065
// MFLOP per sample against 12 bytes per sample of input, mask and output:
// far above the machine balance, so the bound is the rate of the unit that
// does the products. The TPU kernel gave each conv to the MXU as an im2col
// matmul; here each conv is an implicit GEMM on the tensor cores,
//
//   out[t, co] = sum_tap sum_ci x[t + tap*d - h, ci] * W[co, ci, tap]
//
// with M = samples, N = C_out, K = C_in (8 per step, summed over the taps),
// issued as wgmma m64nCk8 TF32. TF32 keeps 10 mantissa bits; the JAX
// reference is fp32 at "highest" precision, so every product is split
// (3xTF32): v = hi + lo, hi = v rounded to TF32, and the sum takes
// hi*hi + hi*lo + lo*hi in fp32 (lo*lo is below fp32's rounding). That is
// 3x the TF32 operations: the bound is 3 * FLOP at 495 TFLOP/s, 2.5x above
// the 67 TFLOP/s fp32 FMA rate. (mma.sync reaches ~320 of the 495 TFLOP/s
// and costs the issue slots of every 16 x 8 tile; utils/tc_probe.py
// measures both.)
//
// - A (the activations) comes from registers: a tap's shift by tap*d
//   samples is an arbitrary row offset, which a per-thread fragment load
//   takes for free and a shared-memory descriptor cannot express. Each warp
//   builds the 16-row A fragment of its slice of a 64-row tile (lane 4g + i:
//   samples g, g + 8, channels i, i + 4), applying conv1's lrelu and the
//   split as it goes; hi is rounded in integer ops and lo = v - hi (the
//   tensor core ignores lo's low 13 bits), since cvt.rna.tf32 runs on the
//   16-lane conversion pipe and would bound the small-C stages.
// - B (the weights) comes from shared memory: split into hi and lo once on
//   the host (ops/mrf.py prepare_mrf_weights) and packed per conv as
//   slabs (tap, kstep), each the hi then the lo part as 8-row x 16-byte
//   core matrices: 8-channel output group j, K half kh, row r, column c
//   holds W[8j + r, 8*kstep + 4*kh + c, tap] (descriptor LBO 128 B, SBO
//   256 B). Slabs stream through a 3-stage ring of 8 KB with cp.async, one
//   barrier per stage.
// - One block per (time tile, batch row) holds x and the
//   mask over the tile plus a halo of the deepest chain's receptive field
//   (60 samples at k = 3, 7, 11, d = 1, 3, 5), zero outside [0, T), which
//   reproduces the zero padding. Two [C][Wp] fp32 buffers hold the residual
//   stream and conv1's output; each chain is computed only on the window
//   its output tile needs, which shrinks by (k-1)/2*d + (k-1)/2 per stage.
//   The row stride Wp is 8 mod 32, so the A-fragment loads (lane 4g + i
//   reads channel i, sample g) hit 32 distinct banks at every tap's shift.
// - Registers bound the window: each warpgroup keeps the accumulators of
//   its MT M tiles for all N (MT * NT * 4 floats a thread), so one pass
//   over a conv's weights serves the whole window. A group of products
//   takes a few hundred cycles from issue to its wait, and only two are in
//   flight per warpgroup (two A register sets), so the block has as many
//   warpgroups as registers allow: 4 (at most 128 registers a thread,
//   MT = 16 / NT) while C <= 40, 2 (MT * NT = 24) above, where fewer,
//   wider tiles measured faster. The window is 384 samples at C = 64 (264
//   kept: 69%), 768 at C = 32 (84%), 1536 at C = 16 (92%); the two
//   buffers take 192 KB at every C.
// - The residual stream is kept multiplied by the mask. With a 0/1 mask this
//   changes no valid output (a masked sample of y only ever reaches conv1
//   through the mask, and its own output is masked at the end), and it lets
//   conv1 read lrelu(y) without a mask load.
// - Above C = 64 the N tiles are done in passes of 8 (the output goes to
//   the other buffer, so a pass never overwrites what a later one reads).
//
// bf16 mode (`mrf_fwd_bf16`): the TPU kernel's bf16 operands (mrf_pallas.py:
// 128-203 under the JAX package's infer_compute_dtype "bfloat16", the 3
// launches of a synthesis call). x, the mask and the output are bf16; the
// weights arrive rounded to bf16 after an fp32 weight-norm resolve
// (ops/mrf.py prepare_mrf_weights), the biases fp32. Each conv is the same
// implicit GEMM as wgmma m64nCk16 bf16, one MMA per 16 input channels where
// 3xTF32 issues three per 8, at twice the TF32 rate: the bound is FLOP at
// 989 TFLOP/s. The slabs (tap, kstep of 16 channels) are bf16 core matrices
// of 8 rows x 8 values: output group j, K half kh, row r, column c holds
// W[8j + r, 16*kstep + 8*kh + c, tap] (LBO 128 B, SBO 256 B as above), 2
// KB at C = 64. The activations are rounded where the TPU kernel rounds
// them: each conv's fp32 sum plus the fp32 bias is rounded to bf16, then
// leaky ReLU (rounded) and the mask; conv2's output is added to the
// residual stream and the sum rounded to bf16. The two [C][Wp] buffers keep
// these bf16 values as floats, so the window, the tile and the shared
// memory are the fp32 mode's; an A fragment packs two channels of a sample
// into one register (exact). The blocks' outputs are summed in fp32 in a
// [B, C, T] scratch in device memory, and the last block writes the sum
// divided by their number, rounded to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int MAXB = 4;         // blocks per MRF
constexpr int MAXS = 4;         // stages per block
constexpr int NSTAGE = 3;       // weight ring depth
constexpr int STAGE_FLOATS = 2048;  // 8 KB per ring stage
constexpr int SLACK = 32;       // floats past the mask: reads past a row end
constexpr int MAXDEV = 64;
constexpr int UNROLL = 8;       // global loads in flight per thread (x, out)
constexpr float SLOPE = 0.1f;

struct MrfMeta {
  int nb;
  int k[MAXB];
  int ns[MAXB];
  int dil[MAXB][MAXS];
  int shrink[MAXB];
  long long w1[MAXB][MAXS], b1[MAXB][MAXS], w2[MAXB][MAXS], b2[MAXB][MAXS];
};

__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, SLOPE * v); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
// x rounded to bf16 (nearest even), as a float
__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// (lo, hi) rounded to bf16, lo in the low half: one A fragment register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

// Shared-memory matrix descriptor of a B operand stored as 8-row x
// 16-byte core matrices, no swizzle: the two K halves of an 8-column group
// LBO bytes apart, consecutive 8-column groups SBO bytes apart.
constexpr int LBO = 128, SBO = 256;
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
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

// d += a * B (m64 x 8NT x k8, TF32): a from registers (the mma.m16n8k8
// A fragment of each warp's 16 rows), B from shared memory by descriptor
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[4 * NT], const uint32_t (&a)[4],
                                           uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_tf32<1>(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
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
__device__ __forceinline__ void wgmma_tf32<3>(float (&d)[12], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
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
__device__ __forceinline__ void wgmma_tf32<5>(float (&d)[20], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<6>(float (&d)[24], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<7>(float (&d)[28], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a * B (m64 x 8NT x k16, bf16 operands, fp32 accumulators): a from
// registers (the mma.m16n8k16 A fragment of each warp's 16 rows), B
// K-major from shared memory by descriptor
template <int NT>
__device__ __forceinline__ void wgmma_bf16(float (&d)[4 * NT], const uint32_t (&a)[4],
                                           uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_bf16<1>(float (&d)[4], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<2>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<3>(float (&d)[12], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<4>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<5>(float (&d)[20], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<6>(float (&d)[24], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<7>(float (&d)[28], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One conv over the output window [olo, ohi) of a [C][Wp] shared buffer.
// FIRST: conv1 (input through lrelu; output stored activated and masked).
// Otherwise conv2 (output added into the residual stream, then masked).
// Warpgroup wg computes M tiles wg, wg + 2, ... (64 samples each from olo,
// 16 per warp) for N tiles [n0, n0 + NT) of each pass. BF16: the bf16
// mode (bf16 slabs, one k16 MMA per slab, outputs rounded to bf16).
template <int NT, int MT, int WGS, bool FIRST, bool BF16>
__device__ __forceinline__ void conv_window(const float* in, float* out,
                                            const float* Ms,
                                            const float* __restrict__ wg,
                                            const float* __restrict__ bias,
                                            float* ring, int C, int Wp, int k,
                                            int dil, int olo, int ohi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wgi = warp / 4, wq = warp % 4;
  const int g = lane / 4, i4 = lane % 4;
  const int ntt = C / 8;  // N tiles
  const int nks = BF16 ? C / 16 : C / 8;  // K steps per tap
  // floats per (tap, kstep) slab: the hi, then the lo part (fp32 mode), or
  // 16 x C bf16 values
  const int slab = BF16 ? 8 * C : 16 * C;
  const int per_stage = STAGE_FLOATS / slab;
  const int nslab = k * nks;
  const int nst = (nslab + per_stage - 1) / per_stage;
  const int half = (k - 1) / 2 * dil;
  const int nmt = (ohi - olo + 63) / 64;

  auto issue = [&](int s) {
    if (s < nst) {
      const int first = s * per_stage;
      const int n = min(per_stage, nslab - first) * slab;
      float* dst = ring + (s % NSTAGE) * STAGE_FLOATS;
      const float* src = wg + (size_t)first * slab;
      for (int e = threadIdx.x * 4; e < n; e += 128 * WGS * 4) cp_async16(dst + e, src + e);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
  };

  for (int n0 = 0; n0 < ntt; n0 += NT) {
    __syncthreads();  // earlier readers of the ring and of `in`'s producer are done
    float acc[MT][4 * NT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) acc[m][e] = 0.f;

    issue(0);
    issue(1);
    for (int s = 0; s < nst; ++s) {
      cp_async_wait1();  // stage s has landed for this thread
      // make the copies visible to the tensor cores' (async proxy) reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();   // ... for every thread; stage s - 1's readers are done
      issue(s + 2);      // into the buffer stage s - 1 used
      const float* st = ring + (s % NSTAGE) * STAGE_FLOATS;
      const int first = s * per_stage;
      const int cnt = min(per_stage, nslab - first);
      // per (slab, M tile): the A fragments (two register sets in turn),
      // then lo*hi, hi*lo, hi*hi; the tile before it may still be running
      for (int q = 0; q < cnt; ++q) {
        const int sl = first + q;
        const int tap = sl / nks, kst = sl % nks;
        // 64 floats (fp32: of the hi part) per 8-channel output group
        const float* bhi = st + q * slab + n0 * 64;
        const uint64_t dh = smem_desc(bhi), dl = smem_desc(bhi + 8 * C);
        uint32_t ah[2][4], al[2][4];
        if constexpr (BF16) {
          // lane 4g + i: channels 2i, 2i + 1 (and + 8) of samples g, g + 8
          const float* xa =
              in + (kst * 16 + 2 * i4) * Wp + olo + 16 * wq + g + tap * dil - half;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int mt = wgi + WGS * m;
            if (mt >= nmt) continue;  // uniform over the warpgroup
            const float* p = xa + mt * 64;
            const float v[8] = {p[0],      p[Wp],          p[8],          p[Wp + 8],
                                p[8 * Wp], p[9 * Wp], p[8 * Wp + 8], p[9 * Wp + 8]};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ah[m & 1][e] = FIRST ? pack_bf16(lrelu(v[2 * e]), lrelu(v[2 * e + 1]))
                                   : pack_bf16(v[2 * e], v[2 * e + 1]);
            wg_fence();
            wgmma_bf16<NT>(acc[m], ah[m & 1], dh);
            wg_commit();
            wg_wait<1>();
          }
        } else {
          const float* xa = in + (kst * 8 + i4) * Wp + olo + 16 * wq + g + tap * dil - half;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int mt = wgi + WGS * m;
            if (mt >= nmt) continue;  // uniform over the warpgroup
            const float* p = xa + mt * 64;
            const float v[4] = {p[0], p[8], p[4 * Wp], p[4 * Wp + 8]};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split(FIRST ? lrelu(v[e]) : v[e], ah[m & 1][e], al[m & 1][e]);
            wg_fence();
            wgmma_tf32<NT>(acc[m], al[m & 1], dh);
            wgmma_tf32<NT>(acc[m], ah[m & 1], dl);
            wgmma_tf32<NT>(acc[m], ah[m & 1], dh);
            wg_commit();
            wg_wait<1>();
          }
        }
        wg_wait<0>();  // the slab's B and A registers are free again
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4 * NT; ++e) asm volatile("" : "+f"(acc[m][e])::"memory");

    // epilogue: accumulator element 4n + e of tile m is sample
    // olo + 64*mt + 16*wq + g + 8*(e/2), channel 8*(n0+n) + 2*i4 + e%2
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = wgi + WGS * m;
      if (mt >= nmt) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n0 + n >= ntt) continue;
        const int co = (n0 + n) * 8 + 2 * i4;
        const float bv0 = __ldg(bias + co), bv1 = __ldg(bias + co + 1);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = olo + mt * 64 + 16 * wq + g + 8 * hr;
          if (r >= ohi) continue;
          const float mk = Ms[r];
          float* o0 = out + co * Wp + r;
          float* o1 = o0 + Wp;
          float a0 = acc[m][4 * n + 2 * hr] + bv0;
          float a1 = acc[m][4 * n + 2 * hr + 1] + bv1;
          if (BF16) {
            a0 = rnd_bf16(a0);
            a1 = rnd_bf16(a1);
          }
          if (FIRST) {
            *o0 = (BF16 ? rnd_bf16(lrelu(a0)) : lrelu(a0)) * mk;
            *o1 = (BF16 ? rnd_bf16(lrelu(a1)) : lrelu(a1)) * mk;
          } else {
            *o0 = (BF16 ? rnd_bf16(*o0 + a0) : *o0 + a0) * mk;
            *o1 = (BF16 ? rnd_bf16(*o1 + a1) : *o1 + a1) * mk;
          }
        }
      }
    }
  }
}

// V: the type of x, the mask and out (float, or bf16 in the bf16 mode);
// accb: where the blocks' outputs are summed (out itself in the fp32
// mode, an fp32 scratch [B, C, T] in the bf16 mode)
template <int NT, int MT, int WGS, typename V>
__global__ void __launch_bounds__(128 * WGS, 1)
mrf_kernel(const V* __restrict__ x, const V* __restrict__ mask,
           const float* __restrict__ wts, float* __restrict__ accb, V* __restrict__ out,
           int C, int T, int tile, int halo, int Wp, MrfMeta meta) {
  constexpr bool BF16 = sizeof(V) == 2;
  constexpr int THREADS = 128 * WGS;
  extern __shared__ __align__(16) float smem[];
  const int W = tile + 2 * halo;
  float* ring = smem;                    // [NSTAGE][STAGE_FLOATS] weight slabs
  float* Y = ring + NSTAGE * STAGE_FLOATS;  // [C][Wp] residual stream (masked)
  float* A = Y + C * Wp;                 // [C][Wp] conv1 output
  float* Ms = A + C * Wp;                // [Wp] mask, then SLACK floats
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  for (int p = threadIdx.x; p < Wp + SLACK; p += THREADS) {
    const int gi = t0 - halo + p;
    Ms[p] = (p < W && gi >= 0 && gi < T) ? to_f(mask[(size_t)b * T + gi]) : 0.f;
  }
  const V* xb = x + (size_t)b * C * T;
  V* ob = out + (size_t)b * C * T;
  float* ab = accb + (size_t)b * C * T;
  const float inv_nb = 1.f / (float)meta.nb;
  for (int j = 0; j < meta.nb; ++j) {
    const int k = meta.k[j];
    int lo = halo - meta.shrink[j], hi = halo + tile + meta.shrink[j];
    const int n = hi - lo;
    __syncthreads();  // Ms is written; the previous block's reads of Y are done
    // UNROLL loads in flight per thread before their stores
    for (int idx0 = threadIdx.x; idx0 < C * n; idx0 += UNROLL * THREADS) {
      float val[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = idx0 + u * THREADS;
        const int c = idx / n, p = lo + idx % n;
        const int gi = t0 - halo + p;
        val[u] = idx < C * n && gi >= 0 && gi < T ? to_f(xb[(size_t)c * T + gi]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = idx0 + u * THREADS;
        const int c = idx / n, p = lo + idx % n;
        if (idx < C * n) Y[c * Wp + p] = val[u] * Ms[p];
      }
    }
    for (int s = 0; s < meta.ns[j]; ++s) {
      const int d = meta.dil[j][s];
      const int h1 = (k - 1) / 2 * d, h2 = (k - 1) / 2;
      // each conv starts with a barrier: its input is complete
      conv_window<NT, MT, WGS, true, BF16>(Y, A, Ms, wts + meta.w1[j][s],
                                           wts + meta.b1[j][s], ring, C, Wp, k, d,
                                           lo + h1, hi - h1);
      conv_window<NT, MT, WGS, false, BF16>(A, Y, Ms, wts + meta.w2[j][s],
                                            wts + meta.b2[j][s], ring, C, Wp, k, 1,
                                            lo + h1 + h2, hi - h1 - h2);
      lo += h1 + h2;
      hi -= h1 + h2;
    }
    __syncthreads();  // the last conv2 has written Y
    const bool last = j == meta.nb - 1;
    for (int idx0 = threadIdx.x; idx0 < C * tile; idx0 += UNROLL * THREADS) {
      float prev[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = idx0 + u * THREADS;
        const int c = idx / tile, gi = t0 + idx % tile;
        prev[u] = j > 0 && idx < C * tile && gi < T ? ab[(size_t)c * T + gi] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = idx0 + u * THREADS;
        const int c = idx / tile, i = idx % tile;
        if (idx >= C * tile || t0 + i >= T) continue;
        const float sum = prev[u] + Y[c * Wp + halo + i];  // Y is masked
        if (!last)
          ab[(size_t)c * T + t0 + i] = sum;
        else if constexpr (BF16)
          ob[(size_t)c * T + t0 + i] = __float2bfloat16_rn(sum * inv_nb);
        else
          ob[(size_t)c * T + t0 + i] = sum * inv_nb;
      }
    }
  }
}

// The shared-memory attribute is set once per instantiation, device and
// size: the largest size set so far is kept.
template <int NT, int MT, int WGS, typename V>
int launch(const V* x, const V* mask, const float* w, float* accb, V* out, int b,
           int c, int t, int tile, int halo, int Wp, long long bytes,
           const MrfMeta& meta, int device, cudaStream_t stream) {
  static long long configured[MAXDEV] = {};
  if (tile + 2 * halo > 64 * WGS * MT) return (int)cudaErrorInvalidValue;
  if (bytes > configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        mrf_kernel<NT, MT, WGS, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured[device] = bytes;
  }
  dim3 grid((t + tile - 1) / tile, b);
  mrf_kernel<NT, MT, WGS, V><<<grid, 128 * WGS, bytes, stream>>>(x, mask, w, accb, out, c, t,
                                                              tile, halo, Wp, meta);
  return (int)cudaGetLastError();
}

// Checks the arguments and fills the launch's metadata; the window
// tile + 2 * halo must fit the warps' M tiles (ops/mrf.py pick_tile).
// step: the channels of one K step (8, or 16 in the bf16 mode).
template <typename V>
int mrf_launch(const V* x, const V* mask, const float* weights, float* accb, V* out,
               int b, int c, int t, int tile, int nb, const int* ks, const int* ns,
               const int* dils, const long long* offs, int device, void* stream) {
  const int step = sizeof(V) == 2 ? 16 : 8;
  if (nb < 1 || nb > MAXB || c < step || c % step != 0 || c >= 128 || tile < 1 ||
      b < 1 || b > 65535 || t < 1 || device < 0 || device >= MAXDEV)
    return (int)cudaErrorInvalidValue;
  MrfMeta meta = {};
  meta.nb = nb;
  int halo = 0;
  for (int j = 0; j < nb; ++j) {
    if (ns[j] < 1 || ns[j] > MAXS || ks[j] < 1 || ks[j] % 2 == 0)
      return (int)cudaErrorInvalidValue;
    meta.k[j] = ks[j];
    meta.ns[j] = ns[j];
    int shrink = 0;
    for (int s = 0; s < ns[j]; ++s) {
      const int d = dils[j * MAXS + s];
      if (d < 1) return (int)cudaErrorInvalidValue;
      meta.dil[j][s] = d;
      shrink += (ks[j] - 1) / 2 * d + (ks[j] - 1) / 2;
      const long long* o = offs + (j * MAXS + s) * 4;
      for (int q = 0; q < 4; ++q)
        if (o[q] % 4 != 0) return (int)cudaErrorInvalidValue;
      meta.w1[j][s] = o[0];
      meta.b1[j][s] = o[1];
      meta.w2[j][s] = o[2];
      meta.b2[j][s] = o[3];
    }
    meta.shrink[j] = shrink;
    halo = shrink > halo ? shrink : halo;
  }
  const int W = tile + 2 * halo;
  const int Wp = (W + 23) / 32 * 32 + 8;  // >= W, 8 mod 32
  const long long bytes =
      (long long)sizeof(float) *
      (NSTAGE * STAGE_FLOATS + 2LL * c * Wp + Wp + SLACK);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  // four warpgroups of at most 128 registers a thread while C <= 40 (more
  // warps to overlap each group's wait), two of up to 255 above
#define MRF_ARGS x, mask, weights, accb, out, b, c, t, tile, halo, Wp, bytes, meta, device, s
  switch (c / 8 < 8 ? c / 8 : 8) {
    case 1: return launch<1, 16, 4>(MRF_ARGS);
    case 2: return launch<2, 8, 4>(MRF_ARGS);
    case 3: return launch<3, 5, 4>(MRF_ARGS);
    case 4: return launch<4, 4, 4>(MRF_ARGS);
    case 5: return launch<5, 3, 4>(MRF_ARGS);
    case 6: return launch<6, 4, 2>(MRF_ARGS);
    case 7: return launch<7, 3, 2>(MRF_ARGS);
    default: return launch<8, 3, 2>(MRF_ARGS);
  }
#undef MRF_ARGS
}

}  // namespace

// ks[nb], ns[nb], dils[nb * MAXS], offs[nb * MAXS * 4] (w1, b1, w2, b2
// offsets in floats into `weights`, each a multiple of 4), all host memory.
extern "C" int mrf_fwd(const float* x, const float* mask, const float* weights,
                       float* out, int b, int c, int t, int tile, int nb,
                       const int* ks, const int* ns, const int* dils,
                       const long long* offs, int device, void* stream) {
  return mrf_launch<float>(x, mask, weights, out, out, b, c, t, tile, nb, ks, ns, dils,
                           offs, device, stream);
}

// The bf16 mode: x, mask and out bf16, C % 16 == 0; `weights` holds the
// bf16 slabs (ops/mrf.py pack_conv_weight_bf16) and the fp32 biases, the
// offsets as mrf_fwd's; acc: an fp32 scratch [b, c, t] for the blocks'
// sum (unused when nb == 1).
extern "C" int mrf_fwd_bf16(const bf16* x, const bf16* mask, const float* weights,
                            float* acc, bf16* out, int b, int c, int t, int tile,
                            int nb, const int* ks, const int* ns, const int* dils,
                            const long long* offs, int device, void* stream) {
  return mrf_launch<bf16>(x, mask, weights, acc, out, b, c, t, tile, nb, ks, ns, dils,
                          offs, device, stream);
}
