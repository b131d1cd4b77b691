// RMSNorm kernel for Hopper (sm_90a): the C interface that
// oim_tpu_torch/ops/_build.py binds with ctypes.  Conventions as in
// paged_attention.cuh: device pointers from contiguous torch tensors,
// launch on `stream`, return cudaGetLastError().
#pragma once

#include "common.cuh"

#ifdef __cplusplus
extern "C" {
#endif

// x [rows, d] (f32 or bf16), w [d] (f32 or bf16), out [rows, d] in x's
// dtype: out = x * rsqrt(mean(x^2) + eps) * w, reduced in f32.  x, w and
// out 16-byte aligned, d a multiple of 16 bytes' worth of x's elements
// and at most 16 chunks of 16 bytes per lane (4096 bf16, 2048 f32).
// The grid is two blocks an SM; each warp walks rows until they run out.
int oim_rmsnorm(const void* x, int x_dtype, const void* w, int w_dtype,
                void* out, int rows, int d, float eps, void* stream);

#ifdef __cplusplus
}
#endif
