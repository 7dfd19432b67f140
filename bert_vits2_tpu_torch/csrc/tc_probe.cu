// Tensor-core probe for the TF32 paths the kernels use (sm_90a).
//
// - tc_probe_layout: one wgmma.m64n16k8 TF32 with A from registers (the
//   mma.m16n8k8 A-fragment layout per warp of the warpgroup) and B from
//   shared memory in 8-row x 16-byte core matrices, no swizzle, stored
//   N-group-major with the two K halves of a group 128 bytes apart. The
//   descriptor takes lbo as its leading and sbo as its stride byte offset;
//   the caller compares D with A B^T.
// - tc_probe_rate: a grid of blocks that issue independent products
//   back to back: kind 0 mma.sync.m16n8k8 TF32 (8 accumulators a warp),
//   kind 1 wgmma.m64n64k8 TF32 with A from registers (4 accumulators a
//   warpgroup). The caller times it and divides the FLOP by the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
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

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A [64][8], B [16][8] (row n holds the 8 K values of column n of B^T), D [64][16]
__global__ void layout_kernel(const float* A, const float* B, float* D, int lbo, int sbo) {
  __shared__ __align__(128) float Bs[16 * 8];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, i = lane % 4;
  // core matrix (n group j, K half kh) at (2j + kh) * 128 bytes; row r at 16 r
  for (int e = tid; e < 128; e += 128) {
    const int n = e / 8, kk = e % 8;
    const int j = n / 8, r = n % 8, kh = kk / 4, c = kk % 4;
    Bs[(2 * j + kh) * 32 + r * 4 + c] = __uint_as_float(to_tf32(B[n * 8 + kk]));
  }
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const int row = 16 * warp + g;
  const uint32_t a[4] = {to_tf32(A[row * 8 + i]), to_tf32(A[(row + 8) * 8 + i]),
                         to_tf32(A[row * 8 + i + 4]), to_tf32(A[(row + 8) * 8 + i + 4])};
  float d[8] = {};
  wg_fence();
  wgmma_n16(d, a, smem_desc(Bs, lbo, sbo));
  wg_commit();
  wg_wait0();
  // accumulator element 4j + e: row g + 8 (e / 2), column 8j + 2i + e % 2
  for (int e = 0; e < 8; ++e) {
    const int j = e / 4, q = e % 4;
    D[(row + 8 * (q / 2)) * 16 + 8 * j + 2 * i + q % 2] = d[e];
  }
}

__global__ void __launch_bounds__(256) rate_mma_kernel(float* sink, int iters) {
  const int lane = threadIdx.x % 32;
  uint32_t a[4] = {to_tf32(lane * 1e-3f), to_tf32(1.f), to_tf32(0.5f), to_tf32(0.25f)};
  const uint32_t b0 = to_tf32(1e-3f), b1 = to_tf32(2e-3f);
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) mma_tf32(acc[c], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 12345.f) sink[0] = s;
}

__global__ void __launch_bounds__(128) rate_wgmma_kernel(float* sink, int iters) {
  __shared__ __align__(128) float Bs[64 * 8];
  for (int e = threadIdx.x; e < 64 * 8; e += 128) Bs[e] = __uint_as_float(to_tf32(1e-3f * (e % 7)));
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const int lane = threadIdx.x % 32;
  const uint32_t a[4] = {to_tf32(lane * 1e-3f), to_tf32(1.f), to_tf32(0.5f), to_tf32(0.25f)};
  const uint64_t desc = smem_desc(Bs, 128, 256);
  float acc[4][32] = {};
  for (int it = 0; it < iters; ++it) {
    wg_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_n64(acc[c], a, desc);
    wg_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  wg_wait0();
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) s += acc[c][e];
  if (s == 12345.f) sink[0] = s;
}

}  // namespace

extern "C" int tc_probe_layout(const float* A, const float* B, float* D, int lbo,
                               int sbo, void* stream) {
  layout_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(A, B, D, lbo, sbo);
  return (int)cudaGetLastError();
}

// kind 0: mma.sync (256 threads a block); kind 1: wgmma (128 threads a block)
extern "C" int tc_probe_rate(float* sink, int kind, int iters, int blocks, void* stream) {
  if (kind == 0)
    rate_mma_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(sink, iters);
  else
    rate_wgmma_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(sink, iters);
  return (int)cudaGetLastError();
}
