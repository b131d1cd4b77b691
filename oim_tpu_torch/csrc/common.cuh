// What every Hopper kernel of the port shares: the dtype codes that
// oim_tpu_torch/ops/_build.py mirrors, the reference's mask constant,
// conversions between the storage dtypes and f32, 16-byte chunk loads,
// warp reductions, and the tensor-core fragment helpers (mma.sync,
// ldmatrix, cp.async, the P V product of an online softmax) that the
// bf16 attention kernels share.
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

// ---------------------------------------------------------------------------
// Tensor-core fragments (PTX mma.sync m16n8k16, bf16 in, f32 out).  Lane
// = 4 g + t.  A (16 x 16, row): a0 = (row g, k 2t, 2t+1), a1 = (row
// g + 8, same k), a2 = (row g, k 2t+8, 2t+9), a3 = (row g + 8, those k).
// B (16 x 8, col): b0 = (k 2t, 2t+1, column g), b1 = (k 2t+8, 2t+9).
// C (16 x 8): c0, c1 = (row g, columns 2t, 2t+1), c2, c3 = (row g + 8).

// Two bf16 at p (the lower k first) as one register.
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) rounded to bf16 as one register, lo in the low half: the
// fragment order of two neighbouring k.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a @ b for one m16n8k16 bf16 fragment, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i ... 8i + 7 give
// the addresses of matrix i's rows (16 bytes each, 16-byte aligned) and
// r[i] receives it in the fragment layout: lane (g, t) holds row g,
// columns 2t and 2t + 1, or with .trans row 2t and 2t + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Online softmax runs in base 2 (exp2f is one instruction): scores are
// scaled by log2(e), and ln(2) takes a base-2 maximum back.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the hardware's approximation (a relative error near 2^-22, and
// 0 for x below -126): the online softmax's exponent.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A bf16 tile row in shared memory: hd + 8 elements, so the 8 rows of
// an ldmatrix start 16 bytes apart in the 32 banks.
template <int HD>
constexpr int kRowStride = HD + 8;

// The A fragment of k step kk (columns 16 kk ... 16 kk + 15) of a warp's
// 16-row tile held in accumulator layout, rounded to bf16.
template <int NT>
__device__ __forceinline__ void acc_to_a(const float (&c)[NT][4], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc[16 x HD] += a (16 x 16, k rows kk*16 ... of B) @ B[16 x HD], B a
// [.][HD + 8] tile read transposed: the output-shaped products (O = P V,
// dQ = dS K, dV = P^T dO, dK = dS^T Q).
template <int HD>
__device__ __forceinline__ void out_product(const uint32_t (&a)[4],
                                            const __nv_bfloat16* b, int kk,
                                            float (&acc)[HD / 8][4]) {
  constexpr int RS = kRowStride<HD>;
  const int lane = threadIdx.x % 32;
  // Matrices (k 0-7 | 8-15) x (n 0-7 | 8-15), k-major: two n tiles' b0, b1.
  const __nv_bfloat16* base =
      b + (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * RS + 8 * (lane / 16);
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) {
    uint32_t fb[4];
    ldmatrix_x4_trans(fb, base + np * 16);
    const uint32_t b0[2] = {fb[0], fb[1]}, b1[2] = {fb[2], fb[3]};
    mma_bf16(acc[2 * np], a, b0);
    mma_bf16(acc[2 * np + 1], a, b1);
  }
}

// Asynchronous copies from device to shared memory: 16 bytes (`src`
// 16-byte aligned) or 4; when `valid` is false nothing is read and the
// destination is zero-filled.  A group is committed, then awaited with
// cp_async_wait<n> (all but the newest n groups of this thread landed);
// a __syncthreads after the wait shows every thread's copies to all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace oim
#endif  // __CUDACC__
