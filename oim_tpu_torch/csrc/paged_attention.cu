// Paged-attention kernels for Hopper (sm_90a), written by hand in CUDA C++.
//
// K1  replaces oim_tpu/ops/paged_attention.py _decode_kernel
//     (paged_flash_decode, and the attend of paged_flash_prefill):
//     attention straight off the block pool through each slot's block
//     table, online softmax in f32, GQA folded into the row axis (a
//     tile's rows are the flattened t x group query rows of one kv head,
//     so each staged K/V row serves every q head of its group).  Three
//     routes, picked by the wrapper from host-known sizes
//     (ops/paged_attention.py decode_route): at most 8 flattened rows (a
//     decode step) take paged_decode_kernel<ROWS=8>; more rows take
//     paged_prefill_tc_kernel for bf16 q and paged_decode_kernel<ROWS=16>
//     for f32 q (the f32 reference route, exact f32 arithmetic).
//
//     Shared by the routes: split-K over the block table.  Split s walks
//     the table entries [s·E, min((s+1)·E, n_tables)), E chosen by the
//     wrapper (decode_split: about two blocks an SM); a block whose keys
//     lie wholly past its rows' causal frontier, wholly left of the
//     window, or only in sentinel entries returns at once and reads no
//     pool block.  Keys are staged in a three-stage cp.async ring, each
//     key's pool row looked up through the table (any block_size <= 64),
//     sentinel keys zero-filled and never read.  With one split a block
//     writes the output; otherwise f32 partials (m, l and the
//     unnormalised acc per row), which paged_merge_kernel combines in
//     split order: M = max m_s, out = Σ e^(m_s−M) acc_s / Σ e^(m_s−M) l_s,
//     splits with l_s = 0 skipped.  No atomics: two launches give the
//     same bits.  Rows with no valid key emit zeros.
//
//     Decode route (ROWS = 8; bound: the K/V bytes, read once per (slot,
//     kv head), about a microsecond at the serving shape, where latency
//     sets the time): one block per (8-row tile, split, slot × kv head),
//     64 keys a step; each warp scores its own 16 keys against every row
//     on CUDA cores (lane = key × half of hd, the halves meeting by one
//     shuffle), keeps its own (m, l, acc) per row and passes p to the
//     product with V through shared memory; the four warps' states merge
//     in warp order.  int8 is dequantised with its f32 scale where it is
//     consumed, so the arithmetic is dequantize_int8's.  At the serving
//     decode shape decode_split's 16 splits time best (PERF.md).
//
//     Tall route on the tensor cores (paged_prefill_tc_kernel; bound: the
//     4·hd operations of each attended (query head, key) pair, e.g. 4.9
//     GFLOP at a 512-token prefill of the serving model, 5 µs at 989
//     TFLOP/s): the structure of flash_fwd_tc_kernel
//     (flash_attention.cu).  One block per (slot × kv head, split,
//     64-row q tile), the tiles last-first (the tile with the most keys
//     starts first); warp w owns flattened rows 16w ... 16w + 15, so a
//     tile reads each K/V row once per 64 q rows.  Per 32-key step S = Q
//     Kᵀ on mma.sync m16n8k16 (Q's A fragments held for the whole walk,
//     K through ldmatrix), the online softmax in f32 in base 2 on the
//     accumulators, then O += P V with P rounded to bf16 as the A operand
//     and V through ldmatrix .trans.  The causal frontier of flattened
//     row r is starts[b] + r / group; the window keeps q_pos − k_pos <
//     window.  Lane l of every warp resolves key kb + l of a step through
//     the table (one division and one table read a lane, the read a step
//     ahead; the copying threads take the pool row by shuffle), and the
//     warp's ballot is the step's validity mask, held in registers and
//     the same in every warp: a step with no valid key is never staged, a
//     step whose keys every row of a warp attends skips the per-pair mask
//     (a branch, not a select), and a warp skips the products of a step
//     wholly past its rows' frontier or left of their window.  The
//     softmax reduces its row maximum and sum as trees (not 8-deep
//     chains), takes 2^x from the hardware's approximation, and needs no
//     per-pair test for masked pairs: a masked score is kNegBig, and
//     2^(kNegBig − m) is 0 once m is real (m is taken as 0 while a row
//     has no valid key).  int8 pools are not rounded: values in [−127,
//     127] are exact in bf16, so each staged step is widened to bf16 in
//     shared memory and the f32 scales stay out of the products —
//     k_scale[j] multiplies score column j after Q Kᵀ, and v_scale[j] is
//     folded into P's column j before P is rounded for P V (the row sum l
//     is of the unscaled f32 p).  Shared-memory rows are padded to hd + 8
//     elements so ldmatrix and ldmatrix .trans fall in distinct banks.
//
//     A block is latency-bound: at two blocks an SM each scheduler holds
//     one warp, so a step's dependent chains (the table read, the copies'
//     issue, S, the softmax, P V; about 1750 cycles a step for a lone
//     block, cli/paged_variants.py --stamps) are exposed.  Kept: the
//     table read a step ahead, the branch-free softmax with tree
//     reductions and approximate 2^x, four blocks an SM in the wrapper's
//     split rule.  Timed beside it and dropped (cli/paged_variants.py;
//     PERF.md): a deeper ring (4 or 5 stages: no change, the copies land
//     in time, cold or warm), the precise 2^x, the next step's copies
//     issued among the S products and S over two accumulator sets (each
//     slightly slower), and three blocks an SM (registers capped at 168,
//     Q reloaded each step: faster at a 512-token prefill, slower at a
//     ragged 100-token one).
//
//     Left on the table: the decode route's merge is a second launch and
//     most of its time is fixed cost; the tall route runs on mma.sync,
//     not wgmma with TMA and warp specialisation (which would let copies
//     and products of different warps overlap), and widens int8 through
//     shared memory (one more barrier a step).
//
// K2  paged_store_kernel replaces _prefill_stage_kernel together with its
//     paged_store_blocks landing: a segment's new K/V rows written into
//     the slot's pool blocks IN PLACE, quantizing exactly as quantize_int8
//     does: amax over hd, scale = max(amax / 127, 1e-8), q = rintf(x /
//     scale) with a true division and round-half-to-even.  The TPU
//     version staged into separate buffers only because of Mosaic's
//     double-buffered prefetch race; here rows outside the write window
//     are never touched, and sentinel rows and rows past the table are
//     dropped.
//
//     Bound: the bytes (new rows in, payload and scales out: 2 MiB at a
//     512-token prefill of the serving model, 0.6 µs), so at every shape
//     on the path the time is set by latency: the launch, then the
//     dependent reads of starts and the table entry.  Design: a flat
//     grid over the B·t·KVH (position, kv head) rows, sized from that
//     count, so a prefill fills the card and a decode step is one block.
//     A row is carried by a group of hd·sizeof/16 lanes, each moving one
//     16-byte vector (8 bf16) of K and of V, both loaded before the
//     table lookup and any store.  The row's starts entry and table entry
//     are read once (one broadcast address a group); the amax reduces
//     over the group's lanes by shuffles, and int8 leaves as one packed
//     8-byte store a lane.
//
//     Left on the table: K2 is a launch of its own before K1's (folding
//     it into K1 would save the fixed cost of one launch a layer).
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

// Merge a launch's split partials into `out` (R rows, in out's order).
template <int HD>
cudaError_t launch_merge(const float* part, float* out, int n_splits,
                         size_t R, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((R + kWarps - 1) / kWarps);
  paged_merge_kernel<HD><<<blocks, kThreads, 0, stream>>>(part, out,
                                                          n_splits, R);
  return cudaGetLastError();
}

// Raise the kernel's dynamic shared-memory limit where it needs more
// than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, n_splits, B * KVH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, tables, starts, out,
      n_splits > 1 ? part : nullptr, t, H, KVH, group, n_blocks, bs, n_tables,
      entries, window, static_cast<float>(sqrt(static_cast<double>(HD))));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  return launch_merge<HD>(part, out, n_splits,
                          static_cast<size_t>(B) * t * H, stream);
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
  // all fit (a decode step: t = 1 and a GQA group of at most 8), else 16
  // — reached by f32 q only: bf16 q with more than 8 rows takes the
  // tensor-core route (oim_paged_prefill_tc).  Every row of a tile is
  // computed without a branch, so the rows' dot products and softmax
  // updates interleave; padding rows hold q = 0 and are masked.
  const bool rows8 = t * (H / KVH) <= 8;
#define OIM_DECODE(QT, KVT, QUANT, ROWS)                                      \
  return launch_decode<HD, QT, KVT, QUANT, ROWS>(                             \
      q, k_pool, v_pool, k_scale, v_scale, tables, starts, out, part, B, t,   \
      H, KVH, n_blocks, bs, n_tables, entries, window, stream)
  if (q_dtype == kOimF32 && kv_dtype == kOimF32) {
    if (rows8) OIM_DECODE(float, float, false, 8);
    OIM_DECODE(float, float, false, 16);
  }
  if (q_dtype == kOimF32 && kv_dtype == kOimI8) {
    if (rows8) OIM_DECODE(float, int8_t, true, 8);
    OIM_DECODE(float, int8_t, true, 16);
  }
  if (!rows8) return cudaErrorInvalidValue;  // the tensor-core route's
  if (q_dtype == kOimBF16 && kv_dtype == kOimBF16)
    OIM_DECODE(__nv_bfloat16, __nv_bfloat16, false, 8);
  if (q_dtype == kOimBF16 && kv_dtype == kOimI8)
    OIM_DECODE(__nv_bfloat16, int8_t, true, 8);
#undef OIM_DECODE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K1, tall route: paged flash-prefill on the tensor cores

constexpr int kTcRows = 64;   // flattened q rows (t x group) a block owns
constexpr int kTcKeys = 32;   // keys a step stages: one a lane
constexpr int kTcStages = 3;  // cp.async ring depth

// Shared memory of paged_prefill_tc_kernel: the bf16 q tile; for int8
// pools the step's K and V widened to bf16; the ring (per stage the K
// then the V rows in the pool's dtype, then per key its k and v scale).
// Every part is a multiple of 16 bytes.
template <int HD, typename KVT>
constexpr size_t prefill_tc_smem_bytes() {
  constexpr bool kQuant = std::is_same_v<KVT, int8_t>;
  return sizeof(__nv_bfloat16) * kRowStride<HD> *
             (kTcRows + (kQuant ? 2 * kTcKeys : 0)) +
         static_cast<size_t>(kTcStages) * kTcKeys *
             (2 * kRowBytes<HD, KVT> + 2 * sizeof(float));
}

// Grid (B * KVH, splits, tiles); `part` as paged_decode_kernel's.  `c2`
// is log2(e) / sqrt(hd): scores in base 2.
template <int HD, typename KVT, bool QUANT>
__global__ void __launch_bounds__(kThreads, 2) paged_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ starts, float* __restrict__ out,
    float* __restrict__ part, int t, int H, int KVH, int group,
    int n_blocks, int bs, int n_tables, int entries, int window, float c2) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = kTcKeys, RS = kRowStride<HD>, RB = kRowBytes<HD, KVT>;
  constexpr int NT = BK / 8, ND = HD / 8, KK = HD / 16;
  constexpr int kE = kChunk<KVT>, kRowChunks = HD / kE;
  static_assert(BK == 32 && NT == 4, "a step's keys are a warp's lanes");
  static_assert(BK * kRowChunks % kThreads == 0, "whole chunks a thread");
  static_assert(kTcRows * (HD / 8) % kThreads == 0, "whole q chunks");
  static_assert(QUANT || RB == 2 * RS, "bf16 ring rows are ldmatrix rows");
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH, split = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, r0 = warp * 16;
  const int tg = t * group, row0 = tile * kTcRows;
  const int nrows = min(kTcRows, tg - row0);
  const size_t R = static_cast<size_t>(gridDim.x / KVH) * t * H;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTcRows][RS]
  bf16* wide = qs + kTcRows * RS;  // int8: the step's K, V [BK][RS] each
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(wide + (QUANT ? 2 * BK * RS : 0));
  // stage st: K rows at ring + st·2·BK·RB, V rows after them; then per
  // stage the keys' k scales and v scales.
  float* scales = reinterpret_cast<float*>(ring + kTcStages * 2 * BK * RB);

  // The q tile, copied first so that its latency overlaps the table
  // reads (rows past the tile's last are zero-filled).
#pragma unroll
  for (int u = 0; u < kTcRows * (HD / 8) / kThreads; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int r = idx / (HD / 8), c = idx % (HD / 8);
    const bool ok = r < nrows;
    const bf16* src =
        ok ? q + q_row(b, row0 + r, t, H, h, group) * HD + c * 8 : q;
    cp_async16(qs + r * RS + c * 8, src, ok);
  }

  // The positions this tile's rows query and the keys its split may
  // attend: [k_lo, k_hi), walked in steps of BK keys.
  const int start = starts[b];
  const int pos_lo = start + row0 / group;
  const int pos_hi = start + (row0 + nrows - 1) / group;
  const int e_lo = split * entries, e_hi = min(e_lo + entries, n_tables);
  int k_lo = e_lo * bs;
  const int k_hi = min(e_hi * bs, pos_hi + 1);
  if (window > 0) k_lo = max(k_lo, pos_lo - window + 1);
  const int n_steps = k_lo < k_hi ? (k_hi - k_lo + BK - 1) / BK : 0;
  const int32_t* table = tables + static_cast<size_t>(b) * n_tables;

  // The key base of the next step that holds a valid key, or -1.  Lane l
  // of every warp resolves the step's key kb + l through the table: its
  // pool row (-1 past k_hi or in a sentinel entry, never read) into
  // *row; the warp's ballot is the step's validity mask, the same in
  // every warp, so all agree without a barrier, and a step without a
  // valid key is never staged.  A lane reads its table entry of the
  // following step as it resolves one (`ahead`, the entry and the key's
  // offset in its block), so the read's latency hides behind a step.
  int cursor = 0;
  int2 ahead;
  auto read_entry = [&](int c) {
    const int kp = k_lo + BK * c + lane, e = kp / bs;
    ahead = make_int2(c < n_steps && kp < k_hi ? table[e] : -1, kp - e * bs);
  };
  read_entry(0);
  auto next_step = [&](unsigned* valid, int* row) -> int {
    while (cursor < n_steps) {
      const int kb = k_lo + BK * cursor++;
      const int2 entry = ahead;
      read_entry(cursor);
      const int r = entry.x >= 0 && entry.x < n_blocks
                        ? (entry.x * bs + entry.y) * KVH + h
                        : -1;
      *valid = __ballot_sync(0xffffffffu, r >= 0);
      *row = r;
      if (*valid) return kb;
    }
    return -1;
  };
  unsigned valid_first;
  int row_first;
  const int kb_first = next_step(&valid_first, &row_first);
  if (kb_first < 0) {
    // Nothing here to attend: zeros (or an empty state), no pool read.
    cp_async_commit();
    cp_async_wait<0>();
    if (part == nullptr) {
      for (int idx = threadIdx.x; idx < nrows * HD; idx += kThreads)
        out[q_row(b, row0 + idx / HD, t, H, h, group) * HD + idx % HD] = 0.f;
    } else {
      for (int r = threadIdx.x; r < nrows; r += kThreads) {
        const size_t row = q_row(b, row0 + r, t, H, h, group);
        float* ml = part + static_cast<size_t>(gridDim.y) * R * HD +
                    (split * R + row) * 2;
        ml[0] = kNegBig;
        ml[1] = 0.f;
      }
    }
    return;
  }

  // Start the copies of the step at key base kb into stage st (one group
  // a call; an empty group past the last step): each key's K and V row
  // from the pool row its lane resolved (`row`, shuffled to the threads
  // that copy it); invalid keys zero-filled, their pool bytes never read.
  auto prefetch = [&](int kb, int row, int st) {
    if (kb >= 0) {
      unsigned char* ks = ring + st * 2 * BK * RB;
#pragma unroll
      for (int u = 0; u < BK * kRowChunks / kThreads; ++u) {
        const int idx = threadIdx.x + u * kThreads;
        const int key = idx / kRowChunks, c = idx % kRowChunks;
        const int r = __shfl_sync(0xffffffffu, row, key);
        const size_t src = r >= 0 ? static_cast<size_t>(r) * HD + c * kE : 0;
        cp_async16(ks + key * RB + c * 16, k_pool + src, r >= 0);
        cp_async16(ks + (BK + key) * RB + c * 16, v_pool + src, r >= 0);
      }
      if constexpr (QUANT) {
        if (warp == 0) {
          float* w = scales + st * 2 * BK;
          cp_async4(w + lane, k_scale + max(row, 0), row >= 0);
          cp_async4(w + BK + lane, v_scale + max(row, 0), row >= 0);
        }
      }
    }
    cp_async_commit();
  };
  // The key bases and validity masks of steps i ... i + kTcStages - 2,
  // whose copies are in flight (-1 past the last step); step 0's share
  // the q tile's group.
  int pending[kTcStages - 1];
  unsigned pending_valid[kTcStages - 1];
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    int row = row_first;
    pending_valid[st] = valid_first;
    pending[st] = st == 0 ? kb_first : next_step(&pending_valid[st], &row);
    prefetch(pending[st], row, st);
  }

  // Q's A fragments for the warp's 16 rows, all of hd, once.
  cp_async_wait<kTcStages - 2>();
  __syncthreads();
  uint32_t qa[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    ldmatrix_x4(qa[kk], qs + (r0 + lane % 16) * RS + (lane / 16) * 8 + kk * 16);

  float acc[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  // Rows r0 + g and r0 + g + 8: running max (of scores in base 2), this
  // lane's share of the row sum, and the position; a padding row's
  // position lies below every key, so it attends nothing.
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  int q_pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    q_pos[r] = row < nrows ? start + (row0 + row) / group : -1;
  }
  // The positions of the warp's first and last rows (a warp of padding
  // rows alone has w_rows <= 0 and computes nothing).
  const int w_rows = min(16, nrows - r0);
  const int w_lo = start + (row0 + r0) / group;
  const int w_hi = start + (row0 + r0 + max(w_rows, 1) - 1) / group;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * RS + 8 * ((lane / 8) % 2);
  for (int i = 0; pending[0] >= 0; ++i) {
    const int kb = pending[0];
    const unsigned valid = pending_valid[0];
    unsigned valid_after = 0;
    int row_after = -1;
    const int kb_after = next_step(&valid_after, &row_after);
    cp_async_wait<kTcStages - 2>();  // step i's rows landed
    __syncthreads();  // ... for every thread; step i - 1's reads done
    // Into the stage step i - 1 read.
    prefetch(kb_after, row_after, (i + kTcStages - 1) % kTcStages);
    const int st = i % kTcStages;
    const unsigned char* stage = ring + st * 2 * BK * RB;
    const float* w = scales + st * 2 * BK;
    const bf16* ks = reinterpret_cast<const bf16*>(stage);
    if constexpr (QUANT) {
      // Widen the step's int8 K and V rows to bf16: exact for |x| <= 127.
      for (int idx = threadIdx.x; idx < 2 * BK * (HD / 16); idx += kThreads) {
        const int r = idx / (HD / 16), c = idx % (HD / 16);
        const uint4 raw =
            *reinterpret_cast<const uint4*>(stage + r * RB + c * 16);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        uint32_t packed[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          packed[j] = pack_bf16(static_cast<float>(e[2 * j]),
                                static_cast<float>(e[2 * j + 1]));
        uint4* dst = reinterpret_cast<uint4*>(wide + r * RS + c * 16);
        dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      }
      __syncthreads();
      ks = wide;
    }
    const bf16* vs = ks + BK * RS;

    const bool idle = w_rows <= 0 || kb > w_hi ||
                      (window > 0 && kb + BK - 1 <= w_lo - window);
    if (!idle) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t fb[4];
          ldmatrix_x4(fb, ks + np * 16 * RS + b_off + kk * 16);
          const uint32_t b0[2] = {fb[0], fb[1]}, b1[2] = {fb[2], fb[3]};
          mma_bf16(s[2 * np], qa[kk], b0);
          mma_bf16(s[2 * np + 1], qa[kk], b1);
        }
      }

      // Scores in base 2 (int8: times the key's scale); masked pairs at
      // kNegBig, unless every key is valid and every row of the warp
      // attends all of them.
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float2 ksc = make_float2(c2, c2);
        if constexpr (QUANT) {
          ksc = *reinterpret_cast<const float2*>(w + j * 8 + 2 * tq);
          ksc = make_float2(ksc.x * c2, ksc.y * c2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= e % 2 ? ksc.y : ksc.x;
      }
      const bool every = valid == 0xffffffffu && kb + BK - 1 <= w_lo &&
                         (window == 0 || kb > w_hi - window);
      if (!every) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * tq + (e % 2), kp = kb + col;
            const int qp = q_pos[e / 2];
            const bool ok = ((valid >> col) & 1u) && kp <= qp &&
                            (window == 0 || qp - kp < window);
            if (!ok) s[j][e] = kNegBig;
          }
      }
      // Per row: the new maximum (a tree over the lane's 8 scores, then
      // the quad), the rescale of the running state, and p = 2^(s − m)
      // in f32 into the row sum (a masked pair gives exactly 0: its
      // kNegBig less a real maximum, or less 0 while the row has none).
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(
            fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                  fmaxf(s[1][2 * r], s[1][2 * r + 1])),
            fmaxf(fmaxf(s[2][2 * r], s[2][2 * r + 1]),
                  fmaxf(s[3][2 * r], s[3][2 * r + 1])));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_next = fmaxf(m[r], mx);
        alpha[r] = ex2(m[r] - m_next);
        m[r] = m_next;
        const float mu = m_next == kNegBig ? 0.f : m_next;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[j][2 * r] = ex2(s[j][2 * r] - mu);
          s[j][2 * r + 1] = ex2(s[j][2 * r + 1] - mu);
        }
        l[r] = l[r] * alpha[r] +
               ((s[0][2 * r] + s[0][2 * r + 1]) +
                (s[1][2 * r] + s[1][2 * r + 1])) +
               ((s[2][2 * r] + s[2][2 * r + 1]) +
                (s[3][2 * r] + s[3][2 * r + 1]));
      }
      // The P V operand is p (int8: times the key's v scale), rounded to
      // bf16 by acc_to_a.
      if constexpr (QUANT) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 vsc =
              *reinterpret_cast<const float2*>(w + BK + j * 8 + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= e % 2 ? vsc.y : vsc.x;
        }
      }
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] *= alpha[e / 2];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(s, kk, a);
        out_product<HD>(a, vs, kk, acc);
      }
    }
#pragma unroll
    for (int j = 0; j + 1 < kTcStages - 1; ++j) {
      pending[j] = pending[j + 1];
      pending_valid[j] = pending_valid[j + 1];
    }
    pending[kTcStages - 2] = kb_after;
    pending_valid[kTcStages - 2] = valid_after;
  }
  cp_async_wait<0>();  // only empty groups remain

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + g + 8 * r;
    if (row >= nrows) continue;
    const size_t orow = q_row(b, row0 + row, t, H, h, group);
    if (part == nullptr) {
      // A row with no valid key has l == 0 and acc == 0: zeros.
      const float lv = fmaxf(l[r], 1e-30f);
      float* o = out + orow * HD + 2 * tq;
#pragma unroll
      for (int c = 0; c < ND; ++c)
        *reinterpret_cast<float2*>(o + c * 8) =
            make_float2(acc[c][2 * r] / lv, acc[c][2 * r + 1] / lv);
    } else {
      float* o = part + (split * R + orow) * HD + 2 * tq;
#pragma unroll
      for (int c = 0; c < ND; ++c)
        *reinterpret_cast<float2*>(o + c * 8) =
            make_float2(acc[c][2 * r], acc[c][2 * r + 1]);
      if (tq == 0) {
        // The merge weighs splits by e^(m_s − M): m back to base e.
        float* ml = part + static_cast<size_t>(gridDim.y) * R * HD +
                    (split * R + orow) * 2;
        ml[0] = m[r] * kLn2;
        ml[1] = l[r];
      }
    }
  }
}

template <int HD, typename KVT, bool QUANT>
cudaError_t launch_prefill_tc(const void* q, const void* k_pool,
                              const void* v_pool, const float* k_scale,
                              const float* v_scale, const int32_t* tables,
                              const int32_t* starts, float* out, float* part,
                              int B, int t, int H, int KVH, int n_blocks,
                              int bs, int n_tables, int entries, int window,
                              cudaStream_t stream) {
  const int tiles = (t * (H / KVH) + kTcRows - 1) / kTcRows;
  const int n_splits = n_tables > 0 ? (n_tables + entries - 1) / entries : 1;
  if (n_splits > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  if (n_splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = prefill_tc_smem_bytes<HD, KVT>();
  auto kernel = paged_prefill_tc_kernel<HD, KVT, QUANT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KVH, n_splits, tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, tables, starts, out,
      n_splits > 1 ? part : nullptr, t, H, KVH, H / KVH, n_blocks, bs,
      n_tables, entries, window,
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(HD))));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  return launch_merge<HD>(part, out, n_splits,
                          static_cast<size_t>(B) * t * H, stream);
}

template <int HD>
cudaError_t dispatch_prefill_tc(const void* q, const void* k_pool,
                                const void* v_pool, int kv_dtype,
                                const float* k_scale, const float* v_scale,
                                const int32_t* tables, const int32_t* starts,
                                float* out, float* part, int B, int t, int H,
                                int KVH, int n_blocks, int bs, int n_tables,
                                int entries, int window, cudaStream_t stream) {
  if (kv_dtype == kOimBF16)
    return launch_prefill_tc<HD, __nv_bfloat16, false>(
        q, k_pool, v_pool, k_scale, v_scale, tables, starts, out, part, B, t,
        H, KVH, n_blocks, bs, n_tables, entries, window, stream);
  if (kv_dtype == kOimI8)
    return launch_prefill_tc<HD, int8_t, true>(
        q, k_pool, v_pool, k_scale, v_scale, tables, starts, out, part, B, t,
        H, KVH, n_blocks, bs, n_tables, entries, window, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K2: K/V store with fused quant

constexpr int kStoreThreads = 128;

// Grid ceil(n_rows / groups a block) over the n_rows = B·t·KVH rows of
// k_new/v_new [B, t, KVH, hd], in memory order: lane group q of block x
// carries row x·groups + q.
template <int HD, typename NT, typename PT, bool QUANT>
__global__ void __launch_bounds__(kStoreThreads) paged_store_kernel(
    const NT* __restrict__ k_new, const NT* __restrict__ v_new,
    PT* __restrict__ k_pool, PT* __restrict__ v_pool,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const int32_t* __restrict__ tables, const int32_t* __restrict__ starts,
    int n_rows, int t, int KVH, int n_blocks, int bs, int n_tables) {
  constexpr int kV = 16 / static_cast<int>(sizeof(NT));  // values a lane
  constexpr int kLanes = HD / kV;                          // lanes a row
  constexpr int kGroups = kStoreThreads / kLanes;
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "a group inside a warp");
  static_assert(QUANT || std::is_same_v<NT, PT>, "fp rows copy as bits");
  const int sub = threadIdx.x % kLanes;
  const int rr = blockIdx.x * kGroups + threadIdx.x / kLanes;
  const bool in = rr < n_rows;
  // Both loads first (their addresses need no lookup), then the table
  // entry, then the stores.
  const size_t src = static_cast<size_t>(in ? rr : 0) * HD + sub * kV;
  const uint4 raws[2] = {
      in ? *reinterpret_cast<const uint4*>(k_new + src) : uint4{},
      in ? *reinterpret_cast<const uint4*>(v_new + src) : uint4{}};
  int64_t dst = -1;  // the pool row, or -1: dropped
  if (in) {
    const int h = rr % KVH, bi = rr / KVH;
    const int b = bi / t, pos = starts[b] + bi % t;
    // Rows before the slot, past its table or in a sentinel entry drop.
    if (pos >= 0 && pos / bs < n_tables) {
      const int blk = tables[static_cast<size_t>(b) * n_tables + pos / bs];
      if (blk >= 0 && blk < n_blocks)
        dst = (static_cast<int64_t>(blk) * bs + pos % bs) * KVH + h;
    }
  }
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    PT* pool = kv ? v_pool : k_pool;
    if constexpr (QUANT) {
      const NT* e = reinterpret_cast<const NT*>(&raws[kv]);
      float x[kV], amax = 0.f;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        x[j] = to_f32(e[j]);
        amax = fmaxf(amax, fabsf(x[j]));
      }
      // The row's amax over its group's lanes (every lane shuffles,
      // dropped rows too, so the warp stays converged).
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
      if (dst < 0) continue;
      uint32_t packed[kV / 4];
#pragma unroll
      for (int j = 0; j < kV / 4; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int qv = static_cast<int>(rintf(__fdiv_rn(x[4 * j + k], scale)));
          word |= static_cast<uint32_t>(qv & 0xff) << (8 * k);
        }
        packed[j] = word;
      }
      int8_t* row = reinterpret_cast<int8_t*>(pool) + dst * HD + sub * kV;
      if constexpr (kV == 8)
        *reinterpret_cast<uint2*>(row) = make_uint2(packed[0], packed[1]);
      else
        *reinterpret_cast<uint32_t*>(row) = packed[0];
      if (sub == 0) (kv ? v_scale : k_scale)[dst] = scale;
    } else {
      if (dst < 0) continue;
      *reinterpret_cast<uint4*>(pool + dst * HD + sub * kV) = raws[kv];
    }
  }
}

template <int HD, typename NT, typename PT, bool QUANT>
cudaError_t launch_store(const void* k_new, const void* v_new, void* k_pool,
                         void* v_pool, float* k_scale, float* v_scale,
                         const int32_t* tables, const int32_t* starts, int B,
                         int t, int KVH, int n_blocks, int bs, int n_tables,
                         cudaStream_t stream) {
  constexpr int kRowsABlock = kStoreThreads / (HD * sizeof(NT) / 16);
  const int64_t n_rows = static_cast<int64_t>(B) * t * KVH;
  if (n_rows > (int64_t{1} << 30)) return cudaErrorInvalidValue;
  const unsigned blocks =
      static_cast<unsigned>((n_rows + kRowsABlock - 1) / kRowsABlock);
  paged_store_kernel<HD, NT, PT, QUANT><<<blocks, kStoreThreads, 0, stream>>>(
      static_cast<const NT*>(k_new), static_cast<const NT*>(v_new),
      static_cast<PT*>(k_pool), static_cast<PT*>(v_pool), k_scale, v_scale,
      tables, starts, static_cast<int>(n_rows), t, KVH, n_blocks, bs,
      n_tables);
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

extern "C" int oim_paged_prefill_tc(
    const void* q, int q_dtype, const void* k_pool, const void* v_pool,
    int kv_dtype, const float* k_scale, const float* v_scale,
    const int32_t* tables, const int32_t* starts, float* out,
    float* partials, int B, int t, int H, int KVH, int hd, int n_blocks,
    int block_size, int n_tables, int window, int entries, void* stream) {
  if (B == 0 || t == 0) return cudaSuccess;
  if (q_dtype != kOimBF16 || block_size < 1 ||
      block_size > kMaxBlockSize || H % KVH != 0 || entries < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return dispatch_prefill_tc<64>(q, k_pool, v_pool, kv_dtype, k_scale,
                                   v_scale, tables, starts, out, partials, B,
                                   t, H, KVH, n_blocks, block_size, n_tables,
                                   entries, window, s);
  if (hd == 128)
    return dispatch_prefill_tc<128>(q, k_pool, v_pool, kv_dtype, k_scale,
                                    v_scale, tables, starts, out, partials, B,
                                    t, H, KVH, n_blocks, block_size, n_tables,
                                    entries, window, s);
  return cudaErrorInvalidValue;
}

extern "C" int oim_paged_kv_store(
    const void* k_new, const void* v_new, int new_dtype, void* k_pool,
    void* v_pool, int pool_dtype, float* k_scale, float* v_scale,
    const int32_t* tables, const int32_t* starts, int B, int t, int KVH,
    int hd, int n_blocks, int block_size, int n_tables, void* stream) {
  if (B == 0 || t == 0) return cudaSuccess;
  if (block_size < 1 || KVH < 1) return cudaErrorInvalidValue;
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
