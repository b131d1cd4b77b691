// Fused unembedding + cross-entropy kernels for Hopper (sm_90a): the C
// interface that oim_tpu_torch/ops/_build.py binds with ctypes.
// Conventions as in paged_attention.cuh: device pointers from contiguous
// torch tensors, launch on `stream`, return cudaGetLastError().
//
// Layouts:
//   x        [N, D]  f32 or bf16 (`dtype`)
//   w        [D, V]  the same dtype (the caller casts the f32 master)
//   labels   [N]     int32 in [0, V)
//   lse, target, g   [N] f32
// The mma.sync entries take any N, D, V: tails are masked, unaligned
// rows are read element by element.  The wgmma entries (oim_fused_ce_tc_*)
// take bf16 only, with D and V multiples of 8 (rows of whole 16-byte
// chunks, as TMA reads them) and 16-byte-aligned bases.  Scores are x @ w
// with f32 accumulation; the dlogits are ((exp(s - lse) - onehot) * g)
// rounded to `dtype`, one definition for dx and dw.  Scratch is the
// caller's:
//   partial  [2, ceil(V / 128), N] f32 (the forward's per-tile m and l)
//   dlogits  [N, chunk_v] in `dtype`, chunk_v a multiple of 128
//   acc      [N, D] f32, or null when dtype is f32 (dx accumulates in dx)
#pragma once

#include "common.cuh"

#ifdef __cplusplus
extern "C" {
#endif

// lse = logsumexp(x @ w) per row and target = (x @ w)[row, label]
// (replaces oim_tpu/ops/fused_ce.py _fwd_kernel).  `target` must be
// zeroed by the caller.
int oim_fused_ce_fwd(const void* x, const void* w, int dtype,
                     const int32_t* labels, float* lse, float* target,
                     float* partial, int N, int D, int V, void* stream);

// dx = dlogits @ w^T, summed in f32 over vocab chunks in order, written
// once in `dtype` (replaces _dx_kernel).
int oim_fused_ce_dx(const void* x, const void* w, int dtype,
                    const int32_t* labels, const float* lse, const float* g,
                    void* dlogits, float* acc, void* dx, int N, int D, int V,
                    int chunk_v, void* stream);

// dw = x^T @ dlogits [D, V] f32 (replaces _dw_kernel).
int oim_fused_ce_dw(const void* x, const void* w, int dtype,
                    const int32_t* labels, const float* lse, const float* g,
                    void* dlogits, float* dw, int N, int D, int V,
                    int chunk_v, void* stream);

// The wgmma route's forward: oim_fused_ce_fwd's outputs for bf16 x and w.
int oim_fused_ce_tc_fwd(const void* x, const void* w, const int32_t* labels,
                        float* lse, float* target, float* partial, int N,
                        int D, int V, void* stream);

// The wgmma route's backward: per vocabulary chunk the dlogits once, then
// dx (bf16, summed in `acc`) unless dx is null and dw (f32 [D, V]) unless
// dw is null: both gradients from one dlogits pass.
int oim_fused_ce_tc_bwd(const void* x, const void* w, const int32_t* labels,
                        const float* lse, const float* g, void* dlogits,
                        float* acc, void* dx, float* dw, int N, int D, int V,
                        int chunk_v, void* stream);

#ifdef __cplusplus
}
#endif
