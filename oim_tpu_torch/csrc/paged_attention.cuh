// Paged-attention kernels for Hopper (sm_90a): the C interface that
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

// K1 — paged flash-decode (replaces oim_tpu/ops/paged_attention.py
// _decode_kernel).  q [B, t, H, hd]; pools [n_blocks, block_size, KVH,
// hd]; scales [n_blocks, block_size, KVH] f32 (int8 pools only, else
// null); tables [B, n_tables] int32; starts [B] int32; out [B, t, H, hd]
// f32.  Query row i of slot b sits at position starts[b] + i.  Each
// split walks `entries` table entries; with n_splits = ceil(n_tables /
// entries) > 1, `partials` holds n_splits * B * t * H * (hd + 2) f32 of
// scratch (else it may be null), and a second launch merges the splits.
int oim_paged_flash_decode(
    const void* q, int q_dtype, const void* k_pool, const void* v_pool,
    int kv_dtype, const float* k_scale, const float* v_scale,
    const int32_t* tables, const int32_t* starts, float* out,
    float* partials, int B, int t, int H, int KVH, int hd, int n_blocks,
    int block_size, int n_tables, int window, int entries, void* stream);

// K1's tall route on the tensor cores, for bf16 q (q_dtype must be
// bf16) over bf16 or int8 pools: the same arguments and result as
// oim_paged_flash_decode, tiles of 64 flattened q rows.  The wrapper
// sends bf16 q with more than 8 rows (t x group) a slot here;
// oim_paged_flash_decode refuses them.
int oim_paged_prefill_tc(
    const void* q, int q_dtype, const void* k_pool, const void* v_pool,
    int kv_dtype, const float* k_scale, const float* v_scale,
    const int32_t* tables, const int32_t* starts, float* out,
    float* partials, int B, int t, int H, int KVH, int hd, int n_blocks,
    int block_size, int n_tables, int window, int entries, void* stream);

// K2 — prefill K/V store with fused int8 quant (replaces
// _prefill_stage_kernel plus its paged_store_blocks landing).  Writes
// k_new/v_new [B, t, KVH, hd] into positions [starts[b], starts[b] + t)
// of each slot's blocks, in place; rows whose table entry is the
// sentinel (>= n_blocks) or lies past the table are dropped.
int oim_paged_kv_store(
    const void* k_new, const void* v_new, int new_dtype, void* k_pool,
    void* v_pool, int pool_dtype, float* k_scale, float* v_scale,
    const int32_t* tables, const int32_t* starts, int B, int t, int KVH,
    int hd, int n_blocks, int block_size, int n_tables, void* stream);

#ifdef __cplusplus
}
#endif
