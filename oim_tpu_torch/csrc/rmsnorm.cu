// RMSNorm for Hopper (sm_90a), written by hand in CUDA C++.
//
// rmsnorm_kernel replaces oim_tpu/ops/rmsnorm.py _kernel (the rmsnorm
// pallas_call): x * rsqrt(mean(x^2) + eps) * w over each row, reduced in
// f32, written in x's dtype.  The backward recomputes through the plain
// formula (ops/rmsnorm.py), as the reference's custom_vjp does, so there
// is no backward kernel.
//
// Bound on this card: bytes.  A row is read once and written once (the
// weight vector is shared by every row): at the training shape, 4096
// rows of 1536 bf16, that is 25 MB, about 7.5 us at 3.35 TB/s; the f32
// arithmetic (3 operations an element) is far below.
//
// Design: a grid of two blocks an SM (kBlocksPerSm) whose warps walk
// the rows, each warp `gridDim.x * kWarps` rows after
// its last.  A lane holds chunks lane, lane + 32, ... of a row in 16-byte
// registers, NCH of them with NCH = ceil(D / chunk / 32) exactly (6 at
// D = 1536 bf16), so a row crosses device memory once.  The lane's share
// of the weight is loaded once, as 16-byte vectors widened to f32
// registers, and reused for every row it walks.  The next row's loads
// are issued before the current row is reduced, scaled and stored, so
// one row's stores overlap the next one's loads.  The sum of squares runs
// in the order of the first version (per lane over its chunks in order,
// then a butterfly over the warp), so the outputs are unchanged bit for
// bit.  The TPU kernel's 256-row VMEM tile becomes a warp's walk; the
// walk covers the rows, so a ragged row count needs no padding.
//
// Rows wider than a lane's registers hold (more than 16 chunks a lane:
// f32 past 2048, bf16 past 4096) take rmsnorm_wide_kernel, which
// ops/rmsnorm.py picks from the row width: one block of kWideThreads
// threads a row walks it twice, 16-byte loads in both passes.  The
// first pass sums squares in f32 in a fixed order (each thread over
// its chunks tid, tid + kWideThreads, ... in turn, a butterfly over its
// warp, then the warps' sums in warp order, which every thread reads
// alike), so the bits do not change from launch to launch; the second
// reads the row again (from L2: a row is at most a few tens of KB),
// scales it, multiplies by the weight and stores.  Still bound by
// bytes: the second read is the one cost over the register route.
#include "rmsnorm.cuh"

#include <math.h>

namespace {

using namespace oim;

constexpr int kWarps = 8;
constexpr int kBlocksPerSm = 2;
constexpr int kWideThreads = 256;
constexpr int kWideBlocksPerSm = 8;

// The kE weights of one chunk of x, widened to f32, from 16-byte (or,
// for 4 bf16 weights, 8-byte) loads.
template <typename WT, int kE>
__device__ __forceinline__ void load_weights(const WT* p, float* dst) {
  constexpr int kBytes = kE * static_cast<int>(sizeof(WT));
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int v = 0; v < kBytes / 16; ++v)
      unpack_chunk<WT>(load_chunk(p + v * kChunk<WT>), 1.f,
                       dst + v * kChunk<WT>);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const WT* e = reinterpret_cast<const WT*>(&raw);
#pragma unroll
    for (int i = 0; i < kE; ++i) dst[i] = to_f32(e[i]);
  }
}

template <typename XT, typename WT, int NCH>
__global__ void __launch_bounds__(kWarps * 32) rmsnorm_kernel(
    const XT* __restrict__ x, const WT* __restrict__ w, XT* __restrict__ out,
    int rows, int d, float eps) {
  constexpr int kE = kChunk<XT>;
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const int n_chunks = d / kE;

  float wv[NCH][kE];
  uint4 cur[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < n_chunks) {
      cur[c] = load_chunk(x + static_cast<size_t>(row) * d + chunk * kE);
      load_weights<WT, kE>(w + chunk * kE, wv[c]);
    }
  }
  for (;;) {
    const int next = row + stride;
    uint4 nxt[NCH];
    if (next < rows) {  // warp-uniform: the next row's loads fly now
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int chunk = lane + 32 * c;
        if (chunk < n_chunks)
          nxt[c] = load_chunk(x + static_cast<size_t>(next) * d + chunk * kE);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (lane + 32 * c < n_chunks) {
        float v[kE];
        unpack_chunk<XT>(cur[c], 1.f, v);
#pragma unroll
        for (int i = 0; i < kE; ++i) ss += v[i] * v[i];
      }
    }
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    XT* outr = out + static_cast<size_t>(row) * d;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = lane + 32 * c;
      if (chunk < n_chunks) {
        float v[kE];
        unpack_chunk<XT>(cur[c], 1.f, v);
        uint4 packed;
        XT* e = reinterpret_cast<XT*>(&packed);
#pragma unroll
        for (int i = 0; i < kE; ++i) from_f32(v[i] * inv * wv[c][i], e + i);
        *reinterpret_cast<uint4*>(outr + chunk * kE) = packed;
      }
    }
    if (next >= rows) break;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      if (lane + 32 * c < n_chunks) cur[c] = nxt[c];
    row = next;
  }
}

template <typename XT, typename WT, int NCH>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, int blocks, cudaStream_t stream) {
  rmsnorm_kernel<XT, WT, NCH><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<XT*>(out), rows, d, eps);
  return cudaGetLastError();
}

// Registers sized to the row: NCH = the chunks a lane holds, 1 ... 16.
template <typename XT, typename WT>
cudaError_t dispatch_chunks(const void* x, const void* w, void* out,
                            int rows, int d, float eps, int blocks,
                            cudaStream_t stream) {
  switch ((d / kChunk<XT> + 31) / 32) {
#define OIM_RMSNORM_NCH(n) \
  case n:                  \
    return launch<XT, WT, n>(x, w, out, rows, d, eps, blocks, stream);
    OIM_RMSNORM_NCH(1)
    OIM_RMSNORM_NCH(2)
    OIM_RMSNORM_NCH(3)
    OIM_RMSNORM_NCH(4)
    OIM_RMSNORM_NCH(5)
    OIM_RMSNORM_NCH(6)
    OIM_RMSNORM_NCH(7)
    OIM_RMSNORM_NCH(8)
    OIM_RMSNORM_NCH(9)
    OIM_RMSNORM_NCH(10)
    OIM_RMSNORM_NCH(11)
    OIM_RMSNORM_NCH(12)
    OIM_RMSNORM_NCH(13)
    OIM_RMSNORM_NCH(14)
    OIM_RMSNORM_NCH(15)
    OIM_RMSNORM_NCH(16)
#undef OIM_RMSNORM_NCH
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(kWideThreads) rmsnorm_wide_kernel(
    const XT* __restrict__ x, const WT* __restrict__ w, XT* __restrict__ out,
    int rows, int d, float eps) {
  constexpr int kE = kChunk<XT>;
  constexpr int kWideWarps = kWideThreads / 32;
  __shared__ float partial[kWideWarps];
  const int n_chunks = d / kE;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const XT* xr = x + static_cast<size_t>(row) * d;
    float ss = 0.f;
    for (int c = threadIdx.x; c < n_chunks; c += kWideThreads) {
      float v[kE];
      unpack_chunk<XT>(load_chunk(xr + c * kE), 1.f, v);
#pragma unroll
      for (int i = 0; i < kE; ++i) ss += v[i] * v[i];
    }
    ss = warp_sum(ss);
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kWideWarps; ++i) total += partial[i];
    __syncthreads();  // every thread has read partial before the next row
    const float inv = rsqrtf(total / static_cast<float>(d) + eps);
    XT* outr = out + static_cast<size_t>(row) * d;
    for (int c = threadIdx.x; c < n_chunks; c += kWideThreads) {
      float v[kE], wv[kE];
      unpack_chunk<XT>(load_chunk(xr + c * kE), 1.f, v);
      load_weights<WT, kE>(w + c * kE, wv);
      uint4 packed;
      XT* e = reinterpret_cast<XT*>(&packed);
#pragma unroll
      for (int i = 0; i < kE; ++i) from_f32(v[i] * inv * wv[i], e + i);
      *reinterpret_cast<uint4*>(outr + c * kE) = packed;
    }
  }
}

template <typename XT, typename WT>
cudaError_t launch_wide(const void* x, const void* w, void* out, int rows,
                        int d, float eps, int sms, cudaStream_t stream) {
  const int blocks =
      rows < kWideBlocksPerSm * sms ? rows : kWideBlocksPerSm * sms;
  rmsnorm_wide_kernel<XT, WT><<<blocks, kWideThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<XT*>(out), rows, d, eps);
  return cudaGetLastError();
}

// The SM count of the current device, or the error that stopped the
// query.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

extern "C" int oim_rmsnorm(const void* x, int x_dtype, const void* w,
                           int w_dtype, void* out, int rows, int d, float eps,
                           void* stream) {
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elems = x_dtype == kOimF32 ? kChunk<float> : kChunk<__nv_bfloat16>;
  if (d <= 0 || d % elems != 0) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int want = (rows + kWarps - 1) / kWarps;
  const int blocks =
      want < kBlocksPerSm * sms ? want : kBlocksPerSm * sms;
  if (x_dtype == kOimF32 && w_dtype == kOimF32)
    return dispatch_chunks<float, float>(x, w, out, rows, d, eps, blocks, s);
  if (x_dtype == kOimF32 && w_dtype == kOimBF16)
    return dispatch_chunks<float, __nv_bfloat16>(x, w, out, rows, d, eps,
                                                 blocks, s);
  if (x_dtype == kOimBF16 && w_dtype == kOimF32)
    return dispatch_chunks<__nv_bfloat16, float>(x, w, out, rows, d, eps,
                                                 blocks, s);
  if (x_dtype == kOimBF16 && w_dtype == kOimBF16)
    return dispatch_chunks<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d,
                                                         eps, blocks, s);
  return cudaErrorInvalidValue;
}

extern "C" int oim_rmsnorm_wide(const void* x, int x_dtype, const void* w,
                                int w_dtype, void* out, int rows, int d,
                                float eps, void* stream) {
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elems = x_dtype == kOimF32 ? kChunk<float> : kChunk<__nv_bfloat16>;
  if (d <= 0 || d % elems != 0) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (x_dtype == kOimF32 && w_dtype == kOimF32)
    return launch_wide<float, float>(x, w, out, rows, d, eps, sms, s);
  if (x_dtype == kOimF32 && w_dtype == kOimBF16)
    return launch_wide<float, __nv_bfloat16>(x, w, out, rows, d, eps, sms, s);
  if (x_dtype == kOimBF16 && w_dtype == kOimF32)
    return launch_wide<__nv_bfloat16, float>(x, w, out, rows, d, eps, sms, s);
  if (x_dtype == kOimBF16 && w_dtype == kOimBF16)
    return launch_wide<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps,
                                                     sms, s);
  return cudaErrorInvalidValue;
}
