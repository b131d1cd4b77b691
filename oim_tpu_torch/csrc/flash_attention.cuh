// Flash-attention kernels for Hopper (sm_90a): the C interface that
// oim_tpu_torch/ops/_build.py binds with ctypes.  Conventions as in
// paged_attention.cuh: device pointers from contiguous torch tensors,
// launch on `stream`, return cudaGetLastError().
//
// Layouts (the JAX package's public ones, read in place):
//   q, out, dout, dq     [B, T, H, hd]    f32 or bf16 (`dtype`)
//   k, v, dk, dv         [B, T, KVH, hd]  same dtype; H % KVH == 0 (GQA)
//   lse, delta           [B * H, T]       f32
//   segments             [B, T] int32, or null (no packing)
// hd is 64 or 128; every row 16-byte aligned.  Query i attends key j when
// (causal: j <= i), (window > 0: i - j < window) and the segment ids
// match; scores are (q / sqrt(hd)) . k.
#pragma once

#include "common.cuh"

#ifdef __cplusplus
extern "C" {
#endif

// Forward: out and the per-row logsumexp lse (replaces
// oim_tpu/ops/flash_attention.py _fwd_kernel).
int oim_flash_fwd(const void* q, const void* k, const void* v, int dtype,
                  const int32_t* segments, void* out, float* lse, int B,
                  int T, int H, int KVH, int hd, int causal, int window,
                  void* stream);

// dq from (q, k, v, dout, lse, delta = rowsum(dout * out)) (replaces
// _dq_kernel).
int oim_flash_dq(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 int dtype, const int32_t* segments, void* dq, int B, int T,
                 int H, int KVH, int hd, int causal, int window,
                 void* stream);

// dk and dv together, summed over each kv head's group of q heads
// (replaces _dkv_kernel).  bf16 cuts each group into `split` partitions
// of (H / KVH) / split q heads, one block each; with split > 1,
// `partials` is f32 scratch of 2 * split * B * T * KVH * hd elements
// (partial dk, then dv) that a second kernel sums in partition order.
// f32 takes split 1 (partials unused).
int oim_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  int dtype, const int32_t* segments, void* dk, void* dv,
                  float* partials, int B, int T, int H, int KVH, int hd,
                  int causal, int window, int split, void* stream);

#ifdef __cplusplus
}
#endif
