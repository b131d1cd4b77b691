// What every Hopper kernel of the port shares: the dtype codes that
// oim_tpu_torch/ops/_build.py mirrors, the reference's mask constant,
// conversions between the storage dtypes and f32, 16-byte chunk loads,
// and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes, mirrored by DTYPE_CODES in ops/_build.py.
enum OimDType : int { kOimF32 = 0, kOimBF16 = 1, kOimI8 = 2 };

#ifdef __CUDACC__
namespace oim {

// The reference's mask constant (oim_tpu/ops/flash_attention.py _NEG_BIG):
// a fully masked row then yields zeros, not NaN.
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// One 16-byte chunk of a row: kChunk<T> elements of T.
template <typename T>
constexpr int kChunk = 16 / static_cast<int>(sizeof(T));

template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* src) {
  return *reinterpret_cast<const uint4*>(src);
}

// Widen a chunk to f32 times `scale` (1 for fp data: exact).
template <typename T>
__device__ __forceinline__ void unpack_chunk(const uint4& raw, float scale,
                                             float* dst) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kChunk<T>; ++i) dst[i] = to_f32(e[i]) * scale;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace oim
#endif  // __CUDACC__
