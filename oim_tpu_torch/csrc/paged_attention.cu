// Paged-attention kernels for Hopper (sm_90a), written by hand in CUDA C++.
//
// K1  paged_decode_kernel + paged_merge_kernel  replace
//     oim_tpu/ops/paged_attention.py _decode_kernel (paged_flash_decode).
//     Attention straight off the block pool through the slot's block
//     table, online softmax in f32, GQA folded into the row axis.
//
//     Bound on this card: the K/V bytes it reads.  Each (slot, kv-head)
//     reads its slot's live blocks once per q-row tile; at decode
//     (t = 1, GQA group 6 → 6 rows, one tile) that is exactly once, so
//     the bound is context_rows × KVH × hd × 2 (K and V) × payload bytes
//     over 3.35 TB/s: about a microsecond at the serving shape, where
//     the time is set by latency, not bytes.
//
//     Design: split-K over the block table.  One thread block per (q-row
//     tile of 8 or 16 rows, split, slot × kv-head); split s walks the table
//     entries [s·E, min((s+1)·E, n_tables)), E chosen by the wrapper from
//     host-known sizes (ops/paged_attention.py decode_split: about two
//     blocks an SM at decode), so a long slot's walk is cut into many short
//     ones that run side by side instead of one serial chain.  A split
//     whose keys lie wholly past its rows' causal frontier, wholly left of
//     the window, or only in sentinel entries returns at once and reads no
//     pool block.  The block stages 64 keys a step — each key's pool row
//     looked up through the table, sentinel keys zero-filled and never read
//     — in a three-stage cp.async ring in the pool's own dtype (one
//     __syncthreads a step, no blocking stage per entry); int8 is
//     dequantised with its f32 scale where it is consumed, so the
//     arithmetic is dequantize_int8's.  Each warp scores its own 16 keys of
//     the step against every row of the tile (lane = key × half of hd; the
//     halves meet by one shuffle), so no warp holds only padding rows, and
//     keeps its own (m, l, acc) per row, acc with hd/32 contiguous dims a
//     lane; the tile's row count is a template constant, so the rows run
//     without branches and their chains of dependent operations interleave,
//     and p reaches the product with V through shared memory as a broadcast
//     read.  At the end the four warps' states merge in shared memory in
//     warp order.  With one split the block writes the output; otherwise it
//     writes f32 partials (m, l and the unnormalised acc per row) and
//     paged_merge_kernel combines the splits of each row in split order: M
//     = max m_s, out = Σ e^(m_s−M) acc_s / Σ e^(m_s−M) l_s, splits with l_s
//     = 0 skipped.  No atomics: two launches give the same bits.  Rows with
//     no valid key emit zeros.  Tall q from prefill (t = prompt bucket) is
//     tiled across blocks along grid.x and takes the split dimension too
//     (the wrapper gives it one split when its tiles already fill the
//     card).
//
//     At the serving decode shape decode_split's 16 splits time best;
//     fewer take time in proportion to the longest slot's walk, more pay
//     for blocks and partials (PERF.md).  Left on the table: the scores
//     run on CUDA cores in f32 (tensor cores for the tall route are later
//     work), the merge is a second launch, and a prefill tile re-reads
//     the slot's K/V once per 16 rows.
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

#include <type_traits>

namespace {

using namespace oim;

// ---------------------------------------------------------------------------
// K1: paged flash-decode, split over the block table

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpKeys = 16;                  // keys a warp scores a step
constexpr int kStepKeys = kWarps * kWarpKeys;  // keys the block stages a step
constexpr int kStages = 3;                     // cp.async ring depth
constexpr int kMaxBlockSize = 64;

// A staged key row: hd values in the pool's dtype plus 16 bytes, so that
// the 16-byte reads of eight neighbouring rows fall in distinct banks.
template <int HD, typename KVT>
constexpr int kRowBytes = HD * static_cast<int>(sizeof(KVT)) + 16;

// A q row in shared memory: two halves of hd/2 f32, each padded by four,
// so the two halves a warp reads at once sit in distinct banks.
template <int HD>
constexpr int kQHalf = HD / 2 + 4;

// Shared memory of paged_decode_kernel: the q tile, each warp's p of its
// 16 keys, the ring (K and V rows, then per key the scales and a
// validity word), and the ring's bytes reused at the end for the warps'
// states (acc, m, l per row).
template <int HD, typename KVT, int ROWS>
constexpr size_t decode_smem_bytes() {
  constexpr size_t ring = static_cast<size_t>(kStages) * kStepKeys *
                          (2 * kRowBytes<HD, KVT> + 3 * sizeof(float));
  constexpr size_t merge = sizeof(float) * kWarps * ROWS * (HD + 2);
  return sizeof(float) * ROWS * (2 * kQHalf<HD> + kStepKeys) +
         (ring > merge ? ring : merge);
}

// N values of T at p (aligned to their total size when that is 4, 8 or
// 16 bytes) widened to f32 and multiplied by `scale` (1 for fp data:
// exact), read as one vector where the size allows: a lane's hd/32 dims
// of a V row.
template <typename T, int N>
__device__ __forceinline__ void load_widen(const T* p, float scale,
                                           float (&dst)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 16 || kBytes == 8 || kBytes == 4) {
    using V = std::conditional_t<
        kBytes == 16, uint4, std::conditional_t<kBytes == 8, uint2, uint32_t>>;
    const V raw = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f32(e[i]) * scale;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f32(p[i]) * scale;
  }
}

// Reductions over the 16 lanes that share lane / 16.
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Offset of flattened q row `row` (t x group) of slot b, kv head h, in
// a [B, t, H, hd] tensor, in units of hd.
__device__ __forceinline__ size_t q_row(int b, int row, int t, int H, int h,
                                        int group) {
  return (static_cast<size_t>(b) * t + row / group) * H + h * group +
         row % group;
}

// Grid (tiles, splits, B * KVH).  `part` null: write `out`; otherwise
// part[split][R][HD] holds acc and part[n_splits·R·HD + (split·R + r)·2]
// (m, l), R = B·t·H rows in out's order.
template <int HD, typename QT, typename KVT, bool QUANT, int ROWS>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ starts, float* __restrict__ out,
    float* __restrict__ part, int t, int H, int KVH, int group,
    int n_blocks, int bs, int n_tables, int entries, int window,
    float sqrt_hd) {
  constexpr int kDims = HD / 32;            // dims of acc a lane owns
  constexpr int kE = kChunk<KVT>;           // values in a 16-byte chunk
  constexpr int kRowChunks = HD / kE;       // chunks in a row
  constexpr int kRB = kRowBytes<HD, KVT>;
  constexpr int kQS = 2 * kQHalf<HD>;       // floats a q row takes
  constexpr int kQPerThread = ROWS * HD / kThreads;
  static_assert(kStepKeys * kRowChunks % kThreads == 0, "whole chunks");
  static_assert(ROWS * HD % kThreads == 0, "whole q values a thread");
  const int tile = blockIdx.x, split = blockIdx.y;
  const int b = blockIdx.z / KVH, h = blockIdx.z % KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tg = t * group, row0 = tile * ROWS;
  const int nrows = min(ROWS, tg - row0);
  const size_t R = static_cast<size_t>(gridDim.z / KVH) * t * H;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [ROWS][kQS]
  float* ps = qs + ROWS * kQS;  // warp w: [kWarpKeys][ROWS] at w·16·ROWS
  unsigned char* ring = reinterpret_cast<unsigned char*>(ps + ROWS * kStepKeys);
  // stage st: K rows at ring + st·kStepKeys·2·kRB, V rows after them;
  // then per stage and key: k scale, v scale, validity.
  float* words = reinterpret_cast<float*>(ring + kStages * kStepKeys * 2 * kRB);

  // The q tile's values, loaded first so that their latency overlaps
  // the table scan below (rows past the tile's last are zeros).
  float qv[kQPerThread];
#pragma unroll
  for (int u = 0; u < kQPerThread; ++u) {
    const int idx = threadIdx.x + u * kThreads, r = idx / HD;
    qv[u] = r < nrows
                ? to_f32(q[q_row(b, row0 + r, t, H, h, group) * HD + idx % HD])
                : 0.f;
  }

  // The positions this tile's rows query and the keys its split may
  // attend: [k_lo, k_hi).
  const int start = starts[b];
  const int pos_lo = start + row0 / group;
  const int pos_hi = start + (row0 + nrows - 1) / group;
  const int e_lo = split * entries, e_hi = min(e_lo + entries, n_tables);
  int k_lo = e_lo * bs;
  const int k_hi = min(e_hi * bs, pos_hi + 1);
  if (window > 0) k_lo = max(k_lo, pos_lo - window + 1);
  const int32_t* table = tables + static_cast<size_t>(b) * n_tables;
  bool live = false;
  if (k_lo < k_hi) {
    for (int e = k_lo / bs + threadIdx.x; e <= (k_hi - 1) / bs; e += kThreads) {
      const int blk = table[e];
      live = live || (blk >= 0 && blk < n_blocks);
    }
  }
  if (!__syncthreads_or(live)) {
    // Nothing here to attend: an empty state (or zeros), no pool read.
    for (int r = threadIdx.x; r < nrows; r += kThreads) {
      const size_t row = q_row(b, row0 + r, t, H, h, group);
      if (part == nullptr) {
        for (int d = 0; d < HD; ++d) out[row * HD + d] = 0.f;
      } else {
        float* ml = part + static_cast<size_t>(gridDim.y) * R * HD +
                    (split * R + row) * 2;
        ml[0] = kNegBig;
        ml[1] = 0.f;
      }
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < kQPerThread; ++u) {
    const int idx = threadIdx.x + u * kThreads, r = idx / HD, d = idx % HD;
    qs[r * kQS + (d / (HD / 2)) * kQHalf<HD> + d % (HD / 2)] = qv[u];
  }

  const int n_steps = (k_hi - k_lo + kStepKeys - 1) / kStepKeys;
  // Start step i's copies (one group a step): every key's K and V row
  // through the table; keys past k_hi or in a sentinel entry zero-filled
  // and marked invalid, their pool bytes never read.
  auto prefetch = [&](int i) {
    if (i < n_steps) {
      const int st = i % kStages, kb = k_lo + i * kStepKeys;
      unsigned char* ks = ring + st * kStepKeys * 2 * kRB;
      float* w = words + st * kStepKeys * 3;
#pragma unroll
      for (int u = 0; u < kStepKeys * kRowChunks / kThreads; ++u) {
        const int idx = threadIdx.x + u * kThreads;
        const int key = idx / kRowChunks, c = idx % kRowChunks;
        const int kp = kb + key;
        const int blk = kp < k_hi ? table[kp / bs] : -1;
        const bool ok = blk >= 0 && blk < n_blocks;
        const size_t row_id =
            ok ? (static_cast<size_t>(blk) * bs + kp % bs) * KVH + h : 0;
        cp_async16(ks + key * kRB + c * 16, k_pool + row_id * HD + c * kE, ok);
        cp_async16(ks + (kStepKeys + key) * kRB + c * 16,
                   v_pool + row_id * HD + c * kE, ok);
        if (c == 0) {
          if constexpr (QUANT) {
            cp_async4(w + key, k_scale + row_id, ok);
            cp_async4(w + kStepKeys + key, v_scale + row_id, ok);
          }
          reinterpret_cast<int*>(w)[2 * kStepKeys + key] = ok;
        }
      }
    }
    cp_async_commit();
  };
  prefetch(0);
  prefetch(1);

  const int key = lane % 16, half = lane / 16;
  float* pw = ps + warp * kWarpKeys * ROWS;  // this warp's p: [key][ROWS]
  // The positions of this lane's rows are start + (row0 + r) / group;
  // padding rows (r >= nrows) are masked by a position below every key.
  int q_pos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    q_pos[r] = r < nrows ? start + (row0 + r) / group : -1;
  float m[ROWS], l[ROWS], acc[ROWS][kDims];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) acc[r][dd] = 0.f;
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<1>();  // step i's rows landed
    __syncthreads();     // ... for every thread (and the q tile); step
                         // i - 1's reads done
    prefetch(i + 2);     // into the stage step i - 1 read
    const int st = i % kStages;
    const unsigned char* ks = ring + st * kStepKeys * 2 * kRB;
    const unsigned char* vs = ks + kStepKeys * kRB;
    const float* w = words + st * kStepKeys * 3;
    const int slot = warp * kWarpKeys + key;  // this lane's key
    const int kp = k_lo + i * kStepKeys + slot;
    const bool kok = reinterpret_cast<const int*>(w)[2 * kStepKeys + slot];

    // Scores: this lane's key against every row, over its half of hd.
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const KVT* krow = reinterpret_cast<const KVT*>(ks + slot * kRB) +
                      half * (HD / 2);
    const float ksc = QUANT ? w[slot] : 1.f;
#pragma unroll
    for (int j = 0; j < kRowChunks / 2; ++j) {
      float kf[kE];
      unpack_chunk<KVT>(load_chunk(krow + j * kE), ksc, kf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(
            qs + r * kQS + half * kQHalf<HD> + j * kE);
#pragma unroll
        for (int e = 0; e < kE / 4; ++e) {
          const float4 qq = qr[e];
          s[r] += qq.x * kf[4 * e];
          s[r] += qq.y * kf[4 * e + 1];
          s[r] += qq.z * kf[4 * e + 2];
          s[r] += qq.w * kf[4 * e + 3];
        }
      }
    }

    // Online softmax per row, without a branch: a row with no valid key
    // in this step has mx = kNegBig, so alpha = 1 and p = 0 leave its
    // state as it was (and one with none at all stays at l = 0).  Lanes
    // 0 ... 15 publish p for the warp's product with V.
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float sc =
          (s[r] + __shfl_xor_sync(0xffffffffu, s[r], 16)) / sqrt_hd;
      bool keep = kok && kp <= q_pos[r];
      if (window > 0) keep = keep && q_pos[r] - kp < window;
      const float mx = max16(keep ? sc : kNegBig);
      const float m_next = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_next);
      const float p = keep ? expf(sc - m_next) : 0.f;
      l[r] = alpha * l[r] + sum16(p);
      m[r] = m_next;
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) acc[r][dd] *= alpha;
      if (half == 0) pw[key * ROWS + r] = p;
    }
    __syncwarp();

    // acc += p · V over the warp's 16 keys, p read back as a broadcast.
#pragma unroll 4
    for (int c = 0; c < kWarpKeys; ++c) {
      const int vslot = warp * kWarpKeys + c;
      float vf[kDims];
      load_widen<KVT, kDims>(
          reinterpret_cast<const KVT*>(vs + vslot * kRB) + lane * kDims,
          QUANT ? w[kStepKeys + vslot] : 1.f, vf);
      const float4* pr = reinterpret_cast<const float4*>(pw + c * ROWS);
#pragma unroll
      for (int r4 = 0; r4 < ROWS / 4; ++r4) {
        const float4 p4 = pr[r4];
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int dd = 0; dd < kDims; ++dd)
            acc[4 * r4 + e][dd] += pv[e] * vf[dd];
      }
    }
    __syncwarp();  // p is rewritten next step
  }

  // Merge the four warps' states in warp order, through shared memory
  // (the ring is no longer read once every warp passes the barrier).
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [kWarps][ROWS][HD + 2]
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float* dst = red + (warp * ROWS + r) * (HD + 2);
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) dst[lane * kDims + dd] = acc[r][dd];
    if (lane == 0) {
      dst[HD] = m[r];
      dst[HD + 1] = l[r];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float mx = kNegBig;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      const float* src = red + (wi * ROWS + r) * (HD + 2);
      if (src[HD + 1] > 0.f) mx = fmaxf(mx, src[HD]);
    }
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      const float* src = red + (wi * ROWS + r) * (HD + 2);
      if (src[HD + 1] > 0.f) {
        const float e = expf(src[HD] - mx);
        num += e * src[d];
        den += e * src[HD + 1];
      }
    }
    const size_t row = q_row(b, row0 + r, t, H, h, group);
    if (part == nullptr) {
      // A row with no valid key has den == 0 and num == 0: zeros.
      out[row * HD + d] = num / fmaxf(den, 1e-30f);
    } else {
      part[(split * R + row) * HD + d] = num;
      if (d == 0) {
        float* ml = part + static_cast<size_t>(gridDim.y) * R * HD +
                    (split * R + row) * 2;
        ml[0] = mx;
        ml[1] = den;
      }
    }
  }
}

// out[r] = the splits of row r merged in split order: one warp a row,
// lane l the dims l·hd/32 ...; splits with l_s = 0 (nothing attended,
// acc never written) are skipped.
template <int HD>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(
    const float* __restrict__ part, float* __restrict__ out, int n_splits,
    size_t R) {
  constexpr int kDims = HD / 32;
  const size_t row =
      static_cast<size_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const float* ml = part + static_cast<size_t>(n_splits) * R * HD;
  float mx = kNegBig;
  for (int s = 0; s < n_splits; ++s) {
    const float* p = ml + (s * R + row) * 2;
    if (p[1] > 0.f) mx = fmaxf(mx, p[0]);
  }
  float num[kDims], den = 0.f;
#pragma unroll
  for (int dd = 0; dd < kDims; ++dd) num[dd] = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* p = ml + (s * R + row) * 2;
    if (p[1] > 0.f) {
      const float e = expf(p[0] - mx);
      den += e * p[1];
      const float* a = part + (s * R + row) * HD + lane * kDims;
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) num[dd] += e * a[dd];
    }
  }
  const float denom = fmaxf(den, 1e-30f);  // 0 / denom: no valid key
#pragma unroll
  for (int dd = 0; dd < kDims; ++dd)
    out[row * HD + lane * kDims + dd] = num[dd] / denom;
}

template <int HD, typename QT, typename KVT, bool QUANT, int ROWS>
cudaError_t launch_decode(const void* q, const void* k_pool,
                          const void* v_pool, const float* k_scale,
                          const float* v_scale, const int32_t* tables,
                          const int32_t* starts, float* out, float* part,
                          int B, int t, int H, int KVH, int n_blocks, int bs,
                          int n_tables, int entries, int window,
                          cudaStream_t stream) {
  const int group = H / KVH;
  const int tiles = (t * group + ROWS - 1) / ROWS;
  const int n_splits = n_tables > 0 ? (n_tables + entries - 1) / entries : 1;
  if (n_splits > 65535 || B * KVH > 65535) return cudaErrorInvalidValue;
  if (n_splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = decode_smem_bytes<HD, KVT, ROWS>();
  auto kernel = paged_decode_kernel<HD, QT, KVT, QUANT, ROWS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(tiles, n_splits, B * KVH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, tables, starts, out,
      n_splits > 1 ? part : nullptr, t, H, KVH, group, n_blocks, bs, n_tables,
      entries, window, static_cast<float>(sqrt(static_cast<double>(HD))));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  const size_t R = static_cast<size_t>(B) * t * H;
  const unsigned merge_blocks =
      static_cast<unsigned>((R + kWarps - 1) / kWarps);
  paged_merge_kernel<HD><<<merge_blocks, kThreads, 0, stream>>>(
      part, out, n_splits, R);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_decode(const void* q, int q_dtype, const void* k_pool,
                            const void* v_pool, int kv_dtype,
                            const float* k_scale, const float* v_scale,
                            const int32_t* tables, const int32_t* starts,
                            float* out, float* part, int B, int t, int H,
                            int KVH, int n_blocks, int bs, int n_tables,
                            int entries, int window, cudaStream_t stream) {
  // ROWS, the q rows (t x group, flattened) a block owns: 8 when they
  // all fit (a decode step: t = 1 and a GQA group of at most 8), else
  // 16.  Every row of a tile is computed without a branch, so the rows'
  // dot products and softmax updates interleave; padding rows hold q = 0
  // and are masked.  Either way a slot has ceil(t·group / 16) tiles.
#define OIM_DECODE(QT, KVT, QUANT)                                          \
  return t * (H / KVH) <= 8                                                 \
             ? launch_decode<HD, QT, KVT, QUANT, 8>(                        \
                   q, k_pool, v_pool, k_scale, v_scale, tables, starts,     \
                   out, part, B, t, H, KVH, n_blocks, bs, n_tables,         \
                   entries, window, stream)                                 \
             : launch_decode<HD, QT, KVT, QUANT, 16>(                       \
                   q, k_pool, v_pool, k_scale, v_scale, tables, starts,     \
                   out, part, B, t, H, KVH, n_blocks, bs, n_tables,         \
                   entries, window, stream)
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
    const int32_t* tables, const int32_t* starts, float* out,
    float* partials, int B, int t, int H, int KVH, int hd, int n_blocks,
    int block_size, int n_tables, int window, int entries, void* stream) {
  if (B == 0 || t == 0) return cudaSuccess;
  if (block_size < 1 || block_size > kMaxBlockSize || H % KVH != 0 ||
      entries < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return dispatch_decode<64>(q, q_dtype, k_pool, v_pool, kv_dtype, k_scale,
                               v_scale, tables, starts, out, partials, B, t,
                               H, KVH, n_blocks, block_size, n_tables,
                               entries, window, s);
  if (hd == 128)
    return dispatch_decode<128>(q, q_dtype, k_pool, v_pool, kv_dtype,
                                k_scale, v_scale, tables, starts, out,
                                partials, B, t, H, KVH, n_blocks, block_size,
                                n_tables, entries, window, s);
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
