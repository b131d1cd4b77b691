// RMSNorm for Hopper (sm_90a), written by hand in CUDA C++.
//
// rmsnorm_kernel replaces oim_tpu/ops/rmsnorm.py _kernel (the rmsnorm
// pallas_call): x * rsqrt(mean(x^2) + eps) * w over each row, reduced in
// f32, written in x's dtype.  The backward recomputes through the plain
// formula (ops/rmsnorm.py), as the reference's custom_vjp does, so there
// is no backward kernel.
//
// Bound on this card: bytes.  A row is read once and written once (the
// weight vector is shared by every row and stays in L1/L2): at the
// training shape, 4096 rows of 1536 bf16, that is 25 MB, about 7.5 us at
// 3.35 TB/s; the f32 arithmetic (3 operations an element) is far below.
//
// Design: one warp per row, eight rows per block.  Each lane reads its
// share of the row in 16-byte chunks (lane c takes chunks c, c+32, ...)
// and keeps them in registers, so the row crosses device memory once:
// sum of squares, a warp reduction, then scale, multiply and store from
// the registers.  The TPU kernel's 256-row VMEM tile becomes 8 rows a
// block; the grid covers the rows, so a ragged row count needs no
// padding.
#include "rmsnorm.cuh"

#include <math.h>

namespace {

using namespace oim;

constexpr int kRowsPerBlock = 8;

template <typename XT, typename WT, int NCH>
__global__ void __launch_bounds__(kRowsPerBlock * 32) rmsnorm_kernel(
    const XT* __restrict__ x, const WT* __restrict__ w, XT* __restrict__ out,
    int rows, int d, float eps) {
  constexpr int kE = kChunk<XT>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // warp-uniform
  const int n_chunks = d / kE;
  const XT* xr = x + static_cast<size_t>(row) * d;
  XT* outr = out + static_cast<size_t>(row) * d;

  uint4 raw[NCH];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < n_chunks) raw[c] = load_chunk(xr + chunk * kE);
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < n_chunks) {
      float v[kE];
      unpack_chunk<XT>(raw[c], 1.f, v);
#pragma unroll
      for (int i = 0; i < kE; ++i) ss += v[i] * v[i];
    }
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < n_chunks) {
      float v[kE];
      unpack_chunk<XT>(raw[c], 1.f, v);
      uint4 packed;
      XT* e = reinterpret_cast<XT*>(&packed);
#pragma unroll
      for (int i = 0; i < kE; ++i)
        from_f32(v[i] * inv * to_f32(w[chunk * kE + i]), e + i);
      *reinterpret_cast<uint4*>(outr + chunk * kE) = packed;
    }
  }
}

template <typename XT, typename WT, int NCH>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<XT, WT, NCH><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<XT*>(out), rows, d, eps);
  return cudaGetLastError();
}

// The smallest register budget (chunks a lane keeps) that holds a row.
template <typename XT, typename WT>
cudaError_t dispatch_chunks(const void* x, const void* w, void* out,
                            int rows, int d, float eps, cudaStream_t stream) {
  const int per_lane = (d / kChunk<XT> + 31) / 32;
  if (per_lane <= 1) return launch<XT, WT, 1>(x, w, out, rows, d, eps, stream);
  if (per_lane <= 2) return launch<XT, WT, 2>(x, w, out, rows, d, eps, stream);
  if (per_lane <= 4) return launch<XT, WT, 4>(x, w, out, rows, d, eps, stream);
  if (per_lane <= 8) return launch<XT, WT, 8>(x, w, out, rows, d, eps, stream);
  if (per_lane <= 16)
    return launch<XT, WT, 16>(x, w, out, rows, d, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int oim_rmsnorm(const void* x, int x_dtype, const void* w,
                           int w_dtype, void* out, int rows, int d, float eps,
                           void* stream) {
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elems = x_dtype == kOimF32 ? kChunk<float> : kChunk<__nv_bfloat16>;
  if (d <= 0 || d % elems != 0) return cudaErrorInvalidValue;
  if (x_dtype == kOimF32 && w_dtype == kOimF32)
    return dispatch_chunks<float, float>(x, w, out, rows, d, eps, s);
  if (x_dtype == kOimF32 && w_dtype == kOimBF16)
    return dispatch_chunks<float, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  if (x_dtype == kOimBF16 && w_dtype == kOimF32)
    return dispatch_chunks<__nv_bfloat16, float>(x, w, out, rows, d, eps, s);
  if (x_dtype == kOimBF16 && w_dtype == kOimBF16)
    return dispatch_chunks<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d,
                                                         eps, s);
  return cudaErrorInvalidValue;
}
