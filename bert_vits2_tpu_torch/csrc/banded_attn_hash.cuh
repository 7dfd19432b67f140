// The attention dropout's keep mask: a copy of the JAX package's `_hash_keep`
// (bert_vits2_tpu/ops/attention_pallas.py:71-85), a murmur-style finalizer
// over (row, column, salt, seed). The TPU kernels salt with batch * heads +
// head; the callers here take the affine salt_base + batch * salt_stride +
// head, whose default (0, heads) is that, so that a data-parallel rank can
// salt its rows as the global batch's. The TPU computes it
// in int32 with wrapping multiplies and logical right shifts; uint32
// arithmetic is the same bits. A probability is kept when the low 31 bits
// of the hash reach thr = min(int(p_drop * 2^31), 2^31 - 1).
#pragma once

#include <stdint.h>

__device__ __forceinline__ bool hash_keep(uint32_t row, uint32_t col,
                                          uint32_t salt, uint32_t seed,
                                          uint32_t thr) {
  uint32_t x = row * 2654435769u + col * 2246822519u;  // int32 -1640531527, -2048144777
  x ^= salt * 374761393u + seed;
  x ^= x >> 16;
  x *= 2246822507u;  // int32 -2048144789
  x ^= x >> 13;
  x *= 3266489909u;  // int32 -1028477387
  x ^= x >> 16;
  return (x & 0x7FFFFFFFu) >= thr;
}
