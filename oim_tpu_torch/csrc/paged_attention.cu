// Paged-attention kernels for Hopper (sm_90a), written by hand in CUDA C++.
//
// K1  paged_decode_kernel  replaces oim_tpu/ops/paged_attention.py
//     _decode_kernel (paged_flash_decode).  Attention straight off the
//     block pool through the slot's block table, online softmax in f32.
//
//     Bound on this card: the K/V bytes it reads.  Each (slot, kv-head)
//     reads its slot's live blocks once per q-row tile; at decode
//     (t = 1, GQA group 6 → 6 rows, one tile) that is exactly once, so
//     the bound is context_rows × KVH × hd × 2 (K and V) × payload bytes
//     over 3.35 TB/s.
//
//     Design: one thread block per (q-row tile of 16 rows, kv-head, slot);
//     the block walks its slot's table entries in a loop (the TPU's
//     sequential grid dimension), stopping at its rows' causal frontier
//     and starting at the window's left edge, and never reads a sentinel
//     block.  Per entry it stages one [block_size, hd] K and V block in
//     shared memory as f32 (int8 dequantized with its f32 scale at the
//     load), reading it in 16-byte chunks that each thread issues
//     together before it unpacks any; each warp owns 4 query rows: lane c
//     scores key c, the warp reduces max and sum, and lane l accumulates
//     dims l, l+32, ... of the running output in registers.  Tall q from
//     prefill (t = prompt bucket) is tiled across blocks along grid.x.
//
//     Left on the table: the walk over a slot's blocks is serial and
//     latency-bound — at decode the grid is only slots × kv-heads blocks
//     (16 on 132 SMs for the Qwen2.5 shape) and a tile of 16 rows holds
//     the group's 6, so two of four warps idle; split-K over the table is
//     the fix.  The dot products run on CUDA cores in f32, not tensor
//     cores; loads wait at a barrier each block (no cp.async/TMA double
//     buffer); lanes past block_size idle while scoring; a prefill tile
//     re-reads the slot's K/V once per 16 rows.
//
// K2  paged_store_kernel  replaces _prefill_stage_kernel together with
//     its paged_store_blocks landing.  One warp per (row, slot, kv-head)
//     writes the row into the slot's pool block IN PLACE, quantizing
//     exactly as quantize_int8 does: amax over hd, scale = max(amax / 127,
//     1e-8), q = rintf(x / scale) with a true division and round-half-to-
//     even.  The TPU version staged into separate buffers only because of
//     Mosaic's double-buffered prefetch race; here rows outside the write
//     window are simply never touched, and sentinel rows are dropped.
//
//     Bound on this card: the K/V bytes it reads and writes (new rows in,
//     payload + scales out).  Left on the table: one 32-lane warp per
//     128-wide row leaves a block of KVH warps small; rows could be
//     batched per block.
#include "paged_attention.cuh"

#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr int kMaxBlockSize = 64;

using namespace oim;

// ---------------------------------------------------------------------------
// K1: paged flash-decode

template <int HD, typename QT, typename KVT, bool QUANT>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ starts, float* __restrict__ out, int t,
    int H, int KVH, int group, int n_blocks, int bs, int n_tables,
    int window, float sqrt_hd) {
  constexpr int kDimsPerLane = HD / 32;
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tg = t * group;
  const int row0 = tile * kTileRows;

  extern __shared__ float smem[];
  float* qs = smem;                     // [kTileRows][HD]
  float* ks = qs + kTileRows * HD;      // [bs][HD + 1] (padded: no conflicts)
  float* vs = ks + bs * (HD + 1);       // [bs][HD]

  const int start = starts[b];
  for (int idx = threadIdx.x; idx < kTileRows * HD; idx += blockDim.x) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int row = row0 + r;
    float val = 0.f;
    if (row < tg) {
      const int i = row / group;
      const int g = row % group;
      const size_t off =
          ((static_cast<size_t>(b) * t + i) * H + h * group + g) * HD + d;
      val = to_f32(q[off]);
    }
    qs[idx] = val;
  }

  // Positions this tile's rows query: [pos_lo, pos_hi].  Blocks wholly
  // past pos_hi or wholly left of the earliest row's window are masked
  // for every row, so the walk skips them.  A block can still be wholly
  // masked for one row (left of a later row's window): that row skips it
  // too, see below.
  const int last_row = min(row0 + kTileRows, tg) - 1;
  const int pos_lo = start + row0 / group;
  const int pos_hi = start + last_row / group;
  const int j_hi = min(pos_hi / bs + 1, n_tables);
  const int j_lo = window > 0 ? max(0, pos_lo - window + 1) / bs : 0;

  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegBig;
    l[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) acc[rr][dd] = 0.f;
  }

  const int32_t* table = tables + static_cast<size_t>(b) * n_tables;
  for (int j = j_lo; j < j_hi; ++j) {
    const int blk = table[j];
    if (blk < 0 || blk >= n_blocks) continue;  // sentinel: never read
    __syncthreads();  // the previous block's K/V are no longer in use
    // Stage the block in 16-byte chunks, kUnroll chunks of K and of V
    // per thread in flight before any is unpacked: the loads are
    // latency-bound, so issuing them together is what sets the pace.
    constexpr int kE = kChunk<KVT>;
    constexpr int kRowChunks = HD / kE;
    constexpr int kUnroll = 4;
    const int n_chunks = bs * kRowChunks;
    for (int base = threadIdx.x; base < n_chunks;
         base += kUnroll * blockDim.x) {
      uint4 kr[kUnroll], vr[kUnroll];
      float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx < n_chunks) {
          const int c = idx / kRowChunks;
          const size_t row_id = (static_cast<size_t>(blk) * bs + c) * KVH + h;
          const size_t off = row_id * HD + (idx % kRowChunks) * kE;
          kr[u] = load_chunk(k_pool + off);
          vr[u] = load_chunk(v_pool + off);
          ksc[u] = QUANT ? k_scale[row_id] : 1.f;
          vsc[u] = QUANT ? v_scale[row_id] : 1.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx < n_chunks) {
          const int c = idx / kRowChunks;
          const int d0 = (idx % kRowChunks) * kE;
          float kf[kE], vf[kE];
          unpack_chunk<KVT>(kr[u], ksc[u], kf);
          unpack_chunk<KVT>(vr[u], vsc[u], vf);
#pragma unroll
          for (int i = 0; i < kE; ++i) {
            ks[c * (HD + 1) + d0 + i] = kf[i];
            vs[c * HD + d0 + i] = vf[i];
          }
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int row = row0 + r;
      if (row >= tg) break;  // warp-uniform
      const int q_pos = start + row / group;
      float s[kMaxBlockSize / 32];
      float m_curr = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < kMaxBlockSize / 32; ++kk) {
        const int c = lane + 32 * kk;
        float sc = -INFINITY;  // not a column of this block
        if (c < bs) {
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < HD; ++d)
            dot += qs[r * HD + d] * ks[c * (HD + 1) + d];
          sc = dot / sqrt_hd;
          const int k_pos = j * bs + c;
          bool keep = k_pos <= q_pos;
          if (window > 0) keep = keep && (q_pos - k_pos < window);
          if (!keep) sc = kNegBig;
        }
        s[kk] = sc;
        m_curr = fmaxf(m_curr, sc);
      }
      m_curr = warp_max(m_curr);
      // No key of this block is valid for this row: it adds nothing once
      // a real score exists, and skipping it keeps a row that has none
      // yet at l == 0 — so a row whose window holds no live block emits
      // zeros, not the mean of masked values.
      if (m_curr == kNegBig) continue;  // warp-uniform
      const float m_next = fmaxf(m[rr], m_curr);
      const float alpha = expf(m[rr] - m_next);
      float p_sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxBlockSize / 32; ++kk) {
        const int c = lane + 32 * kk;
        s[kk] = c < bs ? expf(s[kk] - m_next) : 0.f;
        p_sum += s[kk];
      }
      l[rr] = alpha * l[rr] + warp_sum(p_sum);
      m[rr] = m_next;
      float pv[kDimsPerLane];
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) pv[dd] = 0.f;
      // Lane c2 of pass kk holds p for key 32·kk + c2; broadcast it to
      // the warp (a static index into s keeps s in registers).
#pragma unroll
      for (int kk = 0; kk < kMaxBlockSize / 32; ++kk) {
        const int n = min(32, bs - 32 * kk);  // warp-uniform
        for (int c2 = 0; c2 < n; ++c2) {
          const float p = __shfl_sync(0xffffffffu, s[kk], c2);
          const float* vrow = vs + (32 * kk + c2) * HD + lane;
#pragma unroll
          for (int dd = 0; dd < kDimsPerLane; ++dd)
            pv[dd] += p * vrow[32 * dd];
        }
      }
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd)
        acc[rr][dd] = acc[rr][dd] * alpha + pv[dd];
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= tg) break;
    const int i = row / group;
    const int g = row % group;
    // A row with no valid key has l == 0 and emits zeros.
    const float denom = fmaxf(l[rr], 1e-30f);
    const size_t off =
        ((static_cast<size_t>(b) * t + i) * H + h * group + g) * HD;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd)
      out[off + lane + 32 * dd] = acc[rr][dd] / denom;
  }
}

template <int HD, typename QT, typename KVT, bool QUANT>
cudaError_t launch_decode(const void* q, const void* k_pool,
                          const void* v_pool, const float* k_scale,
                          const float* v_scale, const int32_t* tables,
                          const int32_t* starts, float* out, int B, int t,
                          int H, int KVH, int n_blocks, int bs, int n_tables,
                          int window, cudaStream_t stream) {
  const int group = H / KVH;
  const int tiles = (t * group + kTileRows - 1) / kTileRows;
  const size_t smem =
      sizeof(float) * (kTileRows * HD + bs * (HD + 1) + bs * HD);
  auto kernel = paged_decode_kernel<HD, QT, KVT, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(tiles, KVH, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, tables, starts, out,
      t, H, KVH, group, n_blocks, bs, n_tables, window,
      static_cast<float>(sqrt(static_cast<double>(HD))));
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_decode(const void* q, int q_dtype, const void* k_pool,
                            const void* v_pool, int kv_dtype,
                            const float* k_scale, const float* v_scale,
                            const int32_t* tables, const int32_t* starts,
                            float* out, int B, int t, int H, int KVH,
                            int n_blocks, int bs, int n_tables, int window,
                            cudaStream_t stream) {
#define OIM_DECODE(QT, KVT, QUANT)                                          \
  return launch_decode<HD, QT, KVT, QUANT>(                                 \
      q, k_pool, v_pool, k_scale, v_scale, tables, starts, out, B, t, H,   \
      KVH, n_blocks, bs, n_tables, window, stream)
  if (q_dtype == kOimF32 && kv_dtype == kOimF32) OIM_DECODE(float, float, false);
  if (q_dtype == kOimF32 && kv_dtype == kOimI8) OIM_DECODE(float, int8_t, true);
  if (q_dtype == kOimBF16 && kv_dtype == kOimBF16)
    OIM_DECODE(__nv_bfloat16, __nv_bfloat16, false);
  if (q_dtype == kOimBF16 && kv_dtype == kOimI8)
    OIM_DECODE(__nv_bfloat16, int8_t, true);
#undef OIM_DECODE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K2: prefill K/V store with fused quant

template <int HD, typename NT, typename PT, bool QUANT>
__device__ __forceinline__ void store_row(const NT* __restrict__ src,
                                          PT* __restrict__ dst,
                                          float* __restrict__ scale_dst,
                                          int lane) {
  constexpr int kDimsPerLane = HD / 32;
  float x[kDimsPerLane];
#pragma unroll
  for (int dd = 0; dd < kDimsPerLane; ++dd) x[dd] = to_f32(src[lane + 32 * dd]);
  if constexpr (QUANT) {
    float amax = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) amax = fmaxf(amax, fabsf(x[dd]));
    amax = warp_max(amax);
    const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd)
      dst[lane + 32 * dd] =
          static_cast<int8_t>(rintf(__fdiv_rn(x[dd], scale)));
    if (lane == 0) *scale_dst = scale;
  } else {
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) from_f32(x[dd], dst + lane + 32 * dd);
  }
}

template <int HD, typename NT, typename PT, bool QUANT>
__global__ void paged_store_kernel(
    const NT* __restrict__ k_new, const NT* __restrict__ v_new,
    PT* __restrict__ k_pool, PT* __restrict__ v_pool,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const int32_t* __restrict__ tables, const int32_t* __restrict__ starts,
    int t, int KVH, int n_blocks, int bs, int n_tables) {
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int h = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pos = starts[b] + i;
  if (pos < 0) return;  // before the slot: dropped
  const int entry = pos / bs;
  if (entry >= n_tables) return;  // past the table: dropped
  const int blk = tables[static_cast<size_t>(b) * n_tables + entry];
  if (blk < 0 || blk >= n_blocks) return;  // sentinel: dropped
  const size_t src = ((static_cast<size_t>(b) * t + i) * KVH + h) * HD;
  const size_t row_id = (static_cast<size_t>(blk) * bs + pos % bs) * KVH + h;
  store_row<HD, NT, PT, QUANT>(k_new + src, k_pool + row_id * HD,
                               QUANT ? k_scale + row_id : nullptr, lane);
  store_row<HD, NT, PT, QUANT>(v_new + src, v_pool + row_id * HD,
                               QUANT ? v_scale + row_id : nullptr, lane);
}

template <int HD, typename NT, typename PT, bool QUANT>
cudaError_t launch_store(const void* k_new, const void* v_new, void* k_pool,
                         void* v_pool, float* k_scale, float* v_scale,
                         const int32_t* tables, const int32_t* starts, int B,
                         int t, int KVH, int n_blocks, int bs, int n_tables,
                         cudaStream_t stream) {
  const dim3 grid(t, B);
  paged_store_kernel<HD, NT, PT, QUANT><<<grid, KVH * 32, 0, stream>>>(
      static_cast<const NT*>(k_new), static_cast<const NT*>(v_new),
      static_cast<PT*>(k_pool), static_cast<PT*>(v_pool), k_scale, v_scale,
      tables, starts, t, KVH, n_blocks, bs, n_tables);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_store(const void* k_new, const void* v_new,
                           int new_dtype, void* k_pool, void* v_pool,
                           int pool_dtype, float* k_scale, float* v_scale,
                           const int32_t* tables, const int32_t* starts,
                           int B, int t, int KVH, int n_blocks, int bs,
                           int n_tables, cudaStream_t stream) {
#define OIM_STORE(NT, PT, QUANT)                                            \
  return launch_store<HD, NT, PT, QUANT>(k_new, v_new, k_pool, v_pool,     \
                                         k_scale, v_scale, tables, starts, \
                                         B, t, KVH, n_blocks, bs, n_tables, \
                                         stream)
  if (new_dtype == kOimF32 && pool_dtype == kOimF32) OIM_STORE(float, float, false);
  if (new_dtype == kOimF32 && pool_dtype == kOimI8) OIM_STORE(float, int8_t, true);
  if (new_dtype == kOimBF16 && pool_dtype == kOimBF16)
    OIM_STORE(__nv_bfloat16, __nv_bfloat16, false);
  if (new_dtype == kOimBF16 && pool_dtype == kOimI8)
    OIM_STORE(__nv_bfloat16, int8_t, true);
#undef OIM_STORE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int oim_paged_flash_decode(
    const void* q, int q_dtype, const void* k_pool, const void* v_pool,
    int kv_dtype, const float* k_scale, const float* v_scale,
    const int32_t* tables, const int32_t* starts, float* out, int B, int t,
    int H, int KVH, int hd, int n_blocks, int block_size, int n_tables,
    int window, void* stream) {
  if (B == 0 || t == 0) return cudaSuccess;
  if (block_size < 1 || block_size > kMaxBlockSize || H % KVH != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return dispatch_decode<64>(q, q_dtype, k_pool, v_pool, kv_dtype, k_scale,
                               v_scale, tables, starts, out, B, t, H, KVH,
                               n_blocks, block_size, n_tables, window, s);
  if (hd == 128)
    return dispatch_decode<128>(q, q_dtype, k_pool, v_pool, kv_dtype, k_scale,
                                v_scale, tables, starts, out, B, t, H, KVH,
                                n_blocks, block_size, n_tables, window, s);
  return cudaErrorInvalidValue;
}

extern "C" int oim_paged_kv_store(
    const void* k_new, const void* v_new, int new_dtype, void* k_pool,
    void* v_pool, int pool_dtype, float* k_scale, float* v_scale,
    const int32_t* tables, const int32_t* starts, int B, int t, int KVH,
    int hd, int n_blocks, int block_size, int n_tables, void* stream) {
  if (B == 0 || t == 0) return cudaSuccess;
  if (block_size < 1 || KVH < 1 || KVH > 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return dispatch_store<64>(k_new, v_new, new_dtype, k_pool, v_pool,
                              pool_dtype, k_scale, v_scale, tables, starts, B,
                              t, KVH, n_blocks, block_size, n_tables, s);
  if (hd == 128)
    return dispatch_store<128>(k_new, v_new, new_dtype, k_pool, v_pool,
                               pool_dtype, k_scale, v_scale, tables, starts,
                               B, t, KVH, n_blocks, block_size, n_tables, s);
  return cudaErrorInvalidValue;
}
