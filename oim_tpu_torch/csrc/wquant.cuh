// The weight-quantized product for Hopper (sm_90a): the C interface that
// oim_tpu_torch/ops/_build.py binds with ctypes.
//
// Every pointer is a device pointer taken from a contiguous torch tensor,
// `stream` is torch.cuda.current_stream().cuda_stream, and each entry
// point launches on that stream and returns cudaGetLastError() (0 = the
// launch was accepted).  Nothing here allocates or synchronises.
#pragma once

#include "common.cuh"

#ifdef __cplusplus
extern "C" {
#endif

// out[e, m, n] = sum_k x[e, m, k] * W[e, k, n] with the sums in f32, W the
// dequantized weight rounded to bf16: W = round(float(q) * scale).  x
// [M, K] bf16 shared by every expert (x_expert_stride 0) or [E, M, K]
// (x_expert_stride M * K); q int8 [E, K, N] (q_dtype kOimI8, scale [E,
// N]: per output channel) or packed int4 [E, K / 2, N] (kOimI4, byte row
// j holding rows 2j and 2j + 1; scale [E, K / group, N]); out [E, M, N] in
// out_dtype (bf16 or f32).  The reduction is cut into `splits` ranges of
// payload rows that run as separate blocks; with splits > 1, `partials`
// holds splits * E * M * N f32 of scratch and a second launch sums them
// in split order.  N must be a multiple of 128, K and an int4 group of
// 16; x, q and scale 16-byte aligned.
int oim_quant_matmul(const void* x, int x_dtype, long long x_expert_stride,
                     const void* q, int q_dtype, const float* scale,
                     void* out, int out_dtype, float* partials, int E, int M,
                     int K, int N, int group, int splits, void* stream);

// W [E, K, N] in w_dtype (f32 or bf16) = round(float(q) * scale), q and
// scale as oim_quant_matmul's: the operand of the tall route's product.
int oim_dequant_weight(const void* q, int q_dtype, const float* scale,
                       void* w, int w_dtype, int E, int K, int N, int group,
                       void* stream);

#ifdef __cplusplus
}
#endif
