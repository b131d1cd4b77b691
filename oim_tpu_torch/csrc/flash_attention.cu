// Flash attention for Hopper (sm_90a), written by hand in CUDA C++:
// forward, dq and dkv.
//
// flash_fwd_tc_kernel (bf16) and flash_fwd_kernel (f32) replace
// oim_tpu/ops/flash_attention.py _fwd_kernel;
// flash_dq_tc_kernel (bf16) and flash_dq_kernel (f32) replace _dq_kernel;
// flash_dkv_tc_kernel (bf16, with dkv_sum_kernel) and flash_dkv_kernel
// (f32) replace _dkv_kernel.  They compute what the TPU kernels compute,
// not block for block:
//
//   - The TPU walks key tiles as a sequential grid dimension and carries
//     (m, l, acc) in VMEM scratch across grid steps.  Here a thread block
//     owns its output tile and walks the tiles it needs in a loop, with
//     the running state in registers.
//   - GQA reads each q head's kv head in place from [B, T, KVH, hd] (the
//     reference's _kv_row_map), with no repeat of K/V.
//   - Any T: tiles past the end are zero-filled and masked, so no ragged
//     fallback exists; the per-row lse is [B*H, T] f32, not the TPU's
//     8-lane row tile.
//   - Causal and window skipping is per tile, as on the TPU (key tiles
//     wholly above the diagonal or wholly left of the window are not
//     visited).  Inside a tile, masked pairs contribute exactly 0 (the
//     probability is set to 0, not exp(-1e30 - m)).
//   - No float atomics anywhere: every sum runs in a fixed order, so two
//     launches on the same inputs give the same bits.
//
// Bound on this card: operations.  At the training shape (B=4, T=1024,
// H=12, KVH=2, hd=128, causal: 25.2 M attended (query, key) pairs) the
// forward does 4*hd flops a pair, dq 6*hd (S = Q K^T, dP = dO V^T, dQ =
// dS K) and dkv 8*hd (S, dP, dV = P^T dO, dK = dS^T Q), against reading
// q/k/v/dO once (a few MB).  In bf16 against the tensor cores' 989
// TFLOP/s the bounds are 13, 20 and 26 microseconds.
//
// The bf16 route (the training path: forward and backward) runs on the
// tensor cores:
//
//   - Every product is mma.sync m16n8k16 on bf16 fragments with f32
//     accumulators (common.cuh), operands fetched with ldmatrix (.trans
//     where the product needs the tile transposed).  P and dS are
//     rounded to bf16 only as operands of the next product, as the TPU's
//     MXU rounds f32 operands at default precision; the scores, the
//     softmax, its row sums and dS are f32.  wgmma on 64-row warpgroup
//     tiles (with TMA and a producer warp) is the route to the full rate
//     and is left for a later change: dq and dkv run at about 160
//     TFLOP/s.
//   - 4 warps (128 threads), each owning 16 rows of the block's output,
//     so P and dS never leave registers: in the forward and in dq the
//     accumulator layout of S (and dP) is the A-fragment layout of P V
//     (and dS K), and the forward holds Q's A fragments for the whole
//     walk; dkv computes the
//     transposed scores S^T = K Q^T and dP^T = V dO^T with keys as the
//     fragment rows, so P^T and dS^T are the A operands of dV and dK
//     straight from the accumulators, and lse and delta are per column.
//     dS rounded once to bf16 keeps the first training step's gradients
//     within the parity test's limits (the k-bias gradient, the residue
//     of sum_j dS_ij = 0, is the closest), so dK takes no extra
//     precision.
//   - Tiles: the forward and dq own 64 q rows and stream 32-key K/V tiles;
//     dkv owns 64 keys and streams 32-row q/dO tiles (with their lse, delta
//     and segment ids).  The forward's online softmax runs on the
//     accumulators in base 2 (max and sum over a quad's four lanes).  A
//     warp holds its 16 x hd output accumulators (64 f32 registers at hd
//     128; dkv holds dK and dV, 128) plus a 16 x 32 score and dP tile (32),
//     and the forward also holds Q's A fragments for all of hd (32): ptxas
//     gives the forward and dq 200 registers and dkv 246 at hd 128, no
//     spill, so two blocks (8 warps) fit an SM's 65,536.  Larger tiles
//     would spill dkv or drop to one block an SM.  Operands stay bf16 in
//     shared memory with rows padded to hd + 8 elements (272 bytes at hd
//     128), so the eight row addresses of an ldmatrix fall in distinct
//     banks.
//   - A three-stage ring filled with cp.async: the streamed tiles of step i
//     + 2 load while step i is multiplied, with one __syncthreads a step
//     (the stage being refilled was last read a step earlier).  Shared
//     memory at hd 128: 2 x 64 rows resident + 3 stages x 2 x 32 rows = 86
//     KB for dq and dkv, 69 KB for the forward (one resident tile), two
//     blocks an SM.
//   - dkv's grid is (B * KVH * split, key tiles), key tiles slowest, so the
//     blocks of key tile 0 (under causal attention the heaviest: they see
//     every q tile) launch first; the forward's and dq's q tiles launch
//     last-first for the same reason.  `split` cuts each kv head's group of
//     q heads into partitions of group / split heads: a block walks only
//     its partition's heads, so no block owns a long chain while the others
//     idle (at the training shape the key-tile-0 block of the whole group
//     walks 6 x 32 q tiles, the mean block 102).  With split > 1 each block
//     writes f32 partial dk/dv and dkv_sum_kernel adds the split partials
//     in partition order and casts to k's dtype; with split 1 the block
//     writes dk/dv directly.  The wrapper chooses split
//     (ops/flash_attention.py dkv_split: the smallest that gives 4 blocks
//     an SM, 6 at the training shape, 768 blocks).  There splits 3 and 6
//     time the same and 2 and 1 take 1.3 and 2.1 times as long: split 6's
//     50 MB of f32 partials, written and read back, cost less than the idle
//     tail of a grid with fewer, longer blocks (PERF.md).
//
// The f32 route keeps exact f32 arithmetic (no TF32): flash_fwd_kernel,
// flash_dq_kernel and flash_dkv_kernel on CUDA cores, 256 threads as a
// 16 x 16 grid, each thread holding a register tile of scores and of its
// output rows; operand tiles staged in shared memory as f32 with rows
// padded to hd + 1 floats; dkv walks the whole group in one block
// (split 1).
#include "flash_attention.cuh"

#include <math.h>

#include <type_traits>

namespace {

using namespace oim;

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kFwdBQ = 64;     // forward and dq: query rows per block
constexpr int kBK = 32;        // key rows per tile (every kernel)
constexpr int kDkvBQ = 32;     // dkv: query rows per inner step

// Shared-memory floats of each kernel (a padded row is hd + 1 floats).
template <int HD>
constexpr int fwd_floats() {
  return kFwdBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kFwdBQ * (kBK + 1) +
         kFwdBQ + kBK;  // + segment ids
}
template <int HD>
constexpr int dq_floats() {
  return 2 * kFwdBQ * (HD + 1) + 2 * kBK * (HD + 1) + kFwdBQ * (kBK + 1) +
         kFwdBQ + kBK;
}
template <int HD>
constexpr int dkv_floats() {
  return 2 * kBK * (HD + 1) + 2 * kDkvBQ * (HD + 1) +
         2 * kDkvBQ * (kBK + 1) + 3 * kDkvBQ + kBK;  // + lse, delta, seg
}

// Stage ROWS rows (row0 ...) of one head of a [B, T, NH, HD] tensor in
// shared memory as f32 times `scale`, rows `stride` floats apart; rows
// past T are zeros.  Each thread moves 16-byte chunks.
template <typename DT, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const DT* __restrict__ src, int b,
                                          int row0, int T, int NH, int h,
                                          float scale) {
  constexpr int kE = kChunk<DT>;
  constexpr int kPerRow = HD / kE;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = idx % kPerRow;
    const int row = row0 + r;
    float vals[kE];
    if (row < T) {
      const DT* p =
          src + ((static_cast<size_t>(b) * T + row) * NH + h) * HD + c * kE;
      unpack_chunk<DT>(load_chunk(p), scale, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kE; ++i) vals[i] = 0.f;
    }
    float* out = dst + r * stride + c * kE;
#pragma unroll
    for (int i = 0; i < kE; ++i) out[i] = vals[i];
  }
}

// Segment ids of rows row0 ... row0 + n - 1 of batch b (`fill` past T).
__device__ __forceinline__ void load_segments(int* dst, const int32_t* seg,
                                              int b, int row0, int n, int T,
                                              int fill) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = row0 + i < T ? seg[static_cast<size_t>(b) * T + row0 + i] : fill;
}

// Whether query row qr attends key kc.
__device__ __forceinline__ bool attends(int qr, int kc, int T, int causal,
                                        int window, const int* segq,
                                        const int* segk, int iq, int ik) {
  bool ok = qr < T && kc < T;
  if (causal) ok = ok && kc <= qr;
  if (window) ok = ok && qr - kc < window;
  if (segq != nullptr) ok = ok && segq[iq] == segk[ik];
  return ok;
}

// The key range [begin, end) that query rows q0 ... q0 + rows - 1 attend.
__device__ __forceinline__ void key_range(int q0, int rows, int T, int causal,
                                          int window, int* begin, int* end) {
  *begin = causal && window ? max(0, q0 - window + 1) : 0;
  *end = causal ? min(T, q0 + rows) : T;
}

// Reductions over the 16 threads (one tx row) that share a ty.
__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Forward on the CUDA cores (the f32 route): one block per (64-row q
// tile, b*H + h).  Thread (ty, tx) owns
// q rows ty + 16i (i < 4): scores of keys tx + 16j (j < 2) and output
// columns tx + 16c (c < hd / 16).

template <int HD, typename DT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const DT* __restrict__ q, const DT* __restrict__ k,
    const DT* __restrict__ v, const int32_t* __restrict__ seg,
    DT* __restrict__ out, float* __restrict__ lse, int T, int H, int KVH,
    int causal, int window, float scale) {
  constexpr int BQ = kFwdBQ, BK = kBK, NC = HD / 16, RS = HD + 1;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][RS], pre-scaled
  float* ks = qs + BQ * RS;   // [BK][RS]
  float* vs = ks + BK * RS;   // [BK][HD]
  float* ps = vs + BK * HD;   // [BQ][PS]
  int* segq = reinterpret_cast<int*>(ps + BQ * PS);  // [BQ]
  int* segk = segq + BQ;                             // [BK]
  const bool segmented = seg != nullptr;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * BQ;

  load_tile<DT, HD, BQ>(qs, RS, q, b, q0, T, H, h, scale);
  if (segmented) load_segments(segq, seg, b, q0, BQ, T, -1);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int k_begin, k_end;
  key_range(q0, BQ, T, causal, window, &k_begin, &k_end);
  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<DT, HD, BK>(ks, RS, k, b, k0, T, KVH, kvh, 1.f);
    load_tile<DT, HD, BK>(vs, HD, v, b, k0, T, KVH, kvh, 1.f);
    if (segmented) load_segments(segk, seg, b, k0, BK, T, -2);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * RS + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ks[(tx + 16 * j) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iq = ty + 16 * i;
      bool ok[2];
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ik = tx + 16 * j;
        ok[j] = attends(q0 + iq, k0 + ik, T, causal, window,
                        segmented ? segq : nullptr, segk, iq, ik);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = row16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[iq * PS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = alpha * l[i] + row16_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    const float lv = fmaxf(l[i], 1e-30f);
    DT* o = out + ((static_cast<size_t>(b) * T + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) from_f32(acc[i][c] / lv, o + tx + 16 * c);
    if (tx == 0) lse[static_cast<size_t>(bh) * T + row] = m[i] + logf(lv);
  }
}

// ---------------------------------------------------------------------------
// dq on the CUDA cores (the f32 route): one block per (64-row q tile,
// b*H + h); the score mapping of the forward, and dq rows ty + 16i,
// columns tx + 16c in registers.

template <int HD, typename DT>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const DT* __restrict__ q, const DT* __restrict__ k,
    const DT* __restrict__ v, const DT* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ seg, DT* __restrict__ dq, int T, int H,
    int KVH, int causal, int window, float scale) {
  constexpr int BQ = kFwdBQ, BK = kBK, NC = HD / 16, RS = HD + 1;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][RS], pre-scaled
  float* dos = qs + BQ * RS;   // [BQ][RS]
  float* ks = dos + BQ * RS;   // [BK][RS]
  float* vs = ks + BK * RS;    // [BK][RS]
  float* dss = vs + BK * RS;   // [BQ][PS]
  int* segq = reinterpret_cast<int*>(dss + BQ * PS);
  int* segk = segq + BQ;
  const bool segmented = seg != nullptr;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * BQ;

  load_tile<DT, HD, BQ>(qs, RS, q, b, q0, T, H, h, scale);
  load_tile<DT, HD, BQ>(dos, RS, dout, b, q0, T, H, h, 1.f);
  if (segmented) load_segments(segq, seg, b, q0, BQ, T, -1);
  float lr[4], dr[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t at = static_cast<size_t>(bh) * T + row;
    lr[i] = row < T ? lse[at] : 0.f;
    dr[i] = row < T ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int k_begin, k_end;
  key_range(q0, BQ, T, causal, window, &k_begin, &k_end);
  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<DT, HD, BK>(ks, RS, k, b, k0, T, KVH, kvh, 1.f);
    load_tile<DT, HD, BK>(vs, RS, v, b, k0, T, KVH, kvh, 1.f);
    if (segmented) load_segments(segk, seg, b, k0, BK, T, -2);
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], dv[4], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * RS + d];
        dv[i] = dos[(ty + 16 * i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = ks[(tx + 16 * j) * RS + d];
        vv[j] = vs[(tx + 16 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iq = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ik = tx + 16 * j;
        const bool ok = attends(q0 + iq, k0 + ik, T, causal, window,
                                segmented ? segq : nullptr, segk, iq, ik);
        const float p = ok ? expf(s[i][j] - lr[i]) : 0.f;
        dss[iq * PS + ik] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = ks[kk * RS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    DT* o = dq + ((static_cast<size_t>(b) * T + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) from_f32(acc[i][c] * scale, o + tx + 16 * c);
  }
}

// ---------------------------------------------------------------------------
// dkv on the CUDA cores (the f32 route): one block per (32-key tile,
// b*KVH + kv head), walking the whole group.  Per inner step (q
// head of the group, 32-row q tile) thread (ty, tx) scores q rows
// ty + 16i (i < 2) against keys tx + 16j (j < 2); it accumulates dk and
// dv for key rows ty + 16i (i < 2), columns tx + 16c.

template <int HD, typename DT>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const DT* __restrict__ q, const DT* __restrict__ k,
    const DT* __restrict__ v, const DT* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ seg, DT* __restrict__ dk,
    DT* __restrict__ dv, int T, int H, int KVH, int causal, int window,
    float scale) {
  constexpr int BQ = kDkvBQ, BK = kBK, NC = HD / 16, RS = HD + 1;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* ks = smem;            // [BK][RS]
  float* vs = ks + BK * RS;    // [BK][RS]
  float* qs = vs + BK * RS;    // [BQ][RS], pre-scaled
  float* dos = qs + BQ * RS;   // [BQ][RS]
  float* ps = dos + BQ * RS;   // [BQ][PS]
  float* dss = ps + BQ * PS;   // [BQ][PS]
  float* lses = dss + BQ * PS; // [BQ]
  float* deltas = lses + BQ;   // [BQ]
  int* segq = reinterpret_cast<int*>(deltas + BQ);  // [BQ]
  int* segk = segq + BQ;                            // [BK]
  const bool segmented = seg != nullptr;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bkv = blockIdx.y, b = bkv / KVH, kvh = bkv % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.x * BK;

  load_tile<DT, HD, BK>(ks, RS, k, b, k0, T, KVH, kvh, 1.f);
  load_tile<DT, HD, BK>(vs, RS, v, b, k0, T, KVH, kvh, 1.f);
  if (segmented) load_segments(segk, seg, b, k0, BK, T, -2);
  float dka[2][NC], dva[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // The query rows [q_begin, q_end) that attend any key of this tile.
  const int q_begin = causal ? k0 : 0;
  const int q_end =
      causal && window ? min(T, k0 + BK - 1 + window) : T;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t bh = static_cast<size_t>(b) * H + h;
    for (int q0 = (q_begin / BQ) * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();
      load_tile<DT, HD, BQ>(qs, RS, q, b, q0, T, H, h, scale);
      load_tile<DT, HD, BQ>(dos, RS, dout, b, q0, T, H, h, 1.f);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const int row = q0 + i;
        lses[i] = row < T ? lse[bh * T + row] : 0.f;
        deltas[i] = row < T ? delta[bh * T + row] : 0.f;
      }
      if (segmented) load_segments(segq, seg, b, q0, BQ, T, -1);
      __syncthreads();

      float s[2][2], dp[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[2], dov[2], kv[2], vv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          qv[i] = qs[(ty + 16 * i) * RS + d];
          dov[i] = dos[(ty + 16 * i) * RS + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          kv[j] = ks[(tx + 16 * j) * RS + d];
          vv[j] = vs[(tx + 16 * j) * RS + d];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int iq = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ik = tx + 16 * j;
          const bool ok = attends(q0 + iq, k0 + ik, T, causal, window,
                                  segmented ? segq : nullptr, segk, iq, ik);
          const float p = ok ? expf(s[i][j] - lses[iq]) : 0.f;
          ps[iq * PS + ik] = p;
          dss[iq * PS + ik] = p * (dp[i][j] - deltas[iq]);
        }
      }
      __syncthreads();

      // dv += p^T dout, dk += ds^T (q * scale), over this tile's rows.
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pa[2], da[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pa[i] = ps[qq * PS + ty + 16 * i];
          da[i] = dss[qq * PS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = dos[qq * RS + tx + 16 * c];
          const float qv = qs[qq * RS + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dva[i][c] = fmaf(pa[i], dov, dva[i][c]);
            dka[i][c] = fmaf(da[i], qv, dka[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= T) continue;
    const size_t at = ((static_cast<size_t>(b) * T + row) * KVH + kvh) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      from_f32(dka[i][c], dk + at + tx + 16 * c);
      from_f32(dva[i][c], dv + at + tx + 16 * c);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 route on the tensor cores (design in the note at the top).

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps, 16 output rows each
constexpr int kTcRows = 64;      // rows a block owns: dq's q, dkv's keys
constexpr int kTcStep = 32;      // rows a stage streams: dq's keys, dkv's q
constexpr int kStages = 3;       // cp.async ring depth

// Shared-memory bytes of either kernel: two resident row tiles, the
// ring's two streamed tiles per stage, and 32-bit words: per stage three
// a streamed row (dkv's lse, delta and segment ids; dq uses one, the key
// segment ids) and one a resident row (segment ids).
template <int HD>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * kRowStride<HD> * (2 * kTcRows + kStages * 2 * kTcStep) +
         sizeof(float) * (kStages * 3 * kTcStep + kTcRows);
}

// Start cp.async copies of rows row0 ... row0 + ROWS - 1 of head h of a
// [B, T, NH, HD] bf16 tensor into a [ROWS][HD + 8] tile; rows past T are
// zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* __restrict__ src,
                                          int b, int row0, int T, int NH,
                                          int h) {
  constexpr int kPerRow = HD / 8;  // 16-byte chunks
  static_assert(ROWS * kPerRow % kTcThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kPerRow / kTcThreads; ++i) {
    const int idx = threadIdx.x + i * kTcThreads;
    const int r = idx / kPerRow, c = idx % kPerRow, row = row0 + r;
    const bool ok = row < T;
    const bf16* from =
        ok ? src + ((static_cast<size_t>(b) * T + row) * NH + h) * HD + c * 8
           : src;
    cp_async16(dst + r * kRowStride<HD> + c * 8, from, ok);
  }
}

// Start cp.async copies of words row0 ... row0 + n - 1 of a row of T
// 32-bit words (lse, delta or segment ids); zeros past T.
__device__ __forceinline__ void copy_words(void* dst, const void* row, int row0,
                                           int n, int T) {
  for (int i = threadIdx.x; i < n; i += kTcThreads) {
    const bool ok = row0 + i < T;
    cp_async4(static_cast<uint32_t*>(dst) + i,
              static_cast<const uint32_t*>(row) + (ok ? row0 + i : 0), ok);
  }
}

// Whether every (query, key) pair of q rows q0 ... q0 + nq - 1 and keys
// k0 ... k0 + nk - 1 is attended with no segments, so a tile can skip the
// per-pair mask.
__device__ __forceinline__ bool tile_unmasked(int q0, int nq, int k0, int nk,
                                              int T, int causal, int window) {
  bool all = q0 + nq <= T && k0 + nk <= T;
  if (causal) all = all && k0 + nk - 1 <= q0;
  if (window) all = all && q0 + nq - 1 - k0 < window;
  return all;
}

// acc[16 x NT*8] += A (16 rows x HD, rows `a` of a [.][HD + 8] tile) @
// B^T, B the NT*8 rows at `b` of such a tile: the score-shaped products
// (S = Q K^T, dP = dO V^T and their transposes).  Two products that share
// B's rows run together.
template <int HD, int NT>
__device__ __forceinline__ void rows_product(const bf16* a0, const bf16* b0,
                                             const bf16* a1, const bf16* b1,
                                             float (&c0)[NT][4],
                                             float (&c1)[NT][4]) {
  constexpr int RS = kRowStride<HD>;
  const int lane = threadIdx.x % 32;
  // ldmatrix row addresses: A's four matrices are (rows 0-7 | 8-15) x
  // (k 0-7 | 8-15), column-major in the fragment; B's are two n tiles'
  // (k 0-7, k 8-15).
  const int a_off = (lane % 16) * RS + (lane / 16) * 8;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * RS + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t fa0[4], fa1[4];
    ldmatrix_x4(fa0, a0 + a_off + kk * 16);
    ldmatrix_x4(fa1, a1 + a_off + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t fb0[4], fb1[4];
      ldmatrix_x4(fb0, b0 + np * 16 * RS + b_off + kk * 16);
      ldmatrix_x4(fb1, b1 + np * 16 * RS + b_off + kk * 16);
      const uint32_t b00[2] = {fb0[0], fb0[1]}, b01[2] = {fb0[2], fb0[3]};
      const uint32_t b10[2] = {fb1[0], fb1[1]}, b11[2] = {fb1[2], fb1[3]};
      mma_bf16(c0[2 * np], fa0, b00);
      mma_bf16(c0[2 * np + 1], fa0, b01);
      mma_bf16(c1[2 * np], fa1, b10);
      mma_bf16(c1[2 * np + 1], fa1, b11);
    }
  }
}

// Shared-memory bytes of the forward: the q tile, the ring's K and V
// tiles, and the segment ids of each stage's keys and of the q rows.
template <int HD>
constexpr size_t fwd_tc_smem_bytes() {
  return sizeof(bf16) * kRowStride<HD> * (kTcRows + kStages * 2 * kTcStep) +
         sizeof(int) * (kStages * kTcStep + kTcRows);
}

// Forward: one block per (b*H + h, 64-row q tile), q tiles last-first
// under causal attention (the heaviest start first); warp w owns q rows
// 16w ... 16w + 15.  Q's A fragments are loaded once; per 32-key step S =
// Q K^T lands in f32 accumulators, the online softmax runs on them in
// base 2 (row max and sum over the four lanes of a quad, masked pairs
// exactly 0), and O += P V takes P rounded to bf16 as its A operand, V
// through ldmatrix .trans.  The row sum l is of the f32 probabilities.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2) flash_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int32_t* __restrict__ seg,
    bf16* __restrict__ out, float* __restrict__ lse, int T, int H, int KVH,
    int causal, int window, float scale) {
  constexpr int BQ = kTcRows, BK = kTcStep, RS = kRowStride<HD>;
  constexpr int NT = BK / 8, ND = HD / 8, KK = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][RS]
  bf16* ring = qs + BQ * RS;  // stage s: K, V [BK][RS] at ring + 2 s BK RS
  int* segk_ring = reinterpret_cast<int*>(ring + kStages * 2 * BK * RS);
  int* segq = segk_ring + kStages * BK;  // [BQ]
  const bool segmented = seg != nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;

  copy_tile<HD, BQ>(qs, q, b, q0, T, H, h);
  if (segmented) copy_words(segq, seg + static_cast<size_t>(b) * T, q0, BQ, T);

  int k_begin, k_end;
  key_range(q0, BQ, T, causal, window, &k_begin, &k_end);
  const int kt0 = k_begin / BK;
  const int n = (k_end + BK - 1) / BK - kt0;
  auto prefetch = [&](int i) {  // start step i's copies; one group a step
    if (i < n) {
      const int st = i % kStages, k0 = (kt0 + i) * BK;
      bf16* ks = ring + st * 2 * BK * RS;
      copy_tile<HD, BK>(ks, k, b, k0, T, KVH, kvh);
      copy_tile<HD, BK>(ks + BK * RS, v, b, k0, T, KVH, kvh);
      if (segmented)
        copy_words(segk_ring + st * BK, seg + static_cast<size_t>(b) * T, k0,
                   BK, T);
    }
    cp_async_commit();
  };
  prefetch(0);  // the same group as the q tile
  prefetch(1);

  // Q's A fragments for the warp's 16 rows, all of hd, once.
  cp_async_wait<1>();
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
  // Rows r0 + g and r0 + g + 8: running max (of scores times scale·log2 e)
  // and this lane's share of the row sum.
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  const float c2 = scale * kLog2e;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * RS + 8 * ((lane / 8) % 2);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<1>();  // step i's tiles landed
    __syncthreads();     // ... for every thread; step i - 1's reads done
    prefetch(i + 2);     // into the stage step i - 1 read
    const int st = i % kStages, k0 = (kt0 + i) * BK;
    const bf16* ks = ring + st * 2 * BK * RS;
    const bf16* vs = ks + BK * RS;
    const int* segk = segk_ring + st * BK;

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

    // Scores in base 2, masked pairs at kNegBig; the rows' new maxima.
    const bool unmasked =
        !segmented && tile_unmasked(q0 + r0, 16, k0, BK, T, causal, window);
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int iq = r0 + g + 8 * (e / 2), ik = j * 8 + 2 * t + (e % 2);
        const bool ok =
            unmasked || attends(q0 + iq, k0 + ik, T, causal, window,
                                segmented ? segq : nullptr, segk, iq, ik);
        s[j][e] = ok ? s[j][e] * c2 : kNegBig;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_next = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_next);
      m[r] = m_next;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[j][e] == kNegBig ? 0.f : exp2f(s[j][e] - m[e / 2]);
        s[j][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha[e / 2];
    // O += P V, P as bf16 A fragments straight from the accumulators.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(s, kk, a);
      out_product<HD>(a, vs, kk, acc);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + g + 8 * r;
    if (row >= T) continue;
    const float lv = fmaxf(l[r], 1e-30f);
    bf16* o = out + ((static_cast<size_t>(b) * T + row) * H + h) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      *reinterpret_cast<uint32_t*>(o + c * 8) =
          pack_bf16(acc[c][2 * r] / lv, acc[c][2 * r + 1] / lv);
    if (t == 0)
      lse[static_cast<size_t>(bh) * T + row] = (m[r] + log2f(lv)) * kLn2;
  }
}

// dq: one block per (b*H + h, 64-row q tile), q tiles last-first; warp w
// owns q rows 16w ... 16w + 15 and streams the 32-key K/V tiles the
// rows attend.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2) flash_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ seg, bf16* __restrict__ dq, int T, int H,
    int KVH, int causal, int window, float scale) {
  constexpr int BQ = kTcRows, BK = kTcStep, RS = kRowStride<HD>;
  constexpr int NT = BK / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][RS]
  bf16* dos = qs + BQ * RS;                      // [BQ][RS]
  bf16* ring = dos + BQ * RS;  // stage s: K, V [BK][RS] at ring + 2 s BK RS
  int* segk_ring = reinterpret_cast<int*>(ring + kStages * 2 * BK * RS);
  int* segq = segk_ring + kStages * BK;  // [BQ]
  const bool segmented = seg != nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;

  copy_tile<HD, BQ>(qs, q, b, q0, T, H, h);
  copy_tile<HD, BQ>(dos, dout, b, q0, T, H, h);
  if (segmented) copy_words(segq, seg + static_cast<size_t>(b) * T, q0, BQ, T);
  // This thread's rows r0 + g and r0 + g + 8: lse in base 2, delta.
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    const size_t at = static_cast<size_t>(bh) * T + row;
    lr[i] = row < T ? lse[at] * kLog2e : 0.f;
    dr[i] = row < T ? delta[at] : 0.f;
  }

  int k_begin, k_end;
  key_range(q0, BQ, T, causal, window, &k_begin, &k_end);
  const int kt0 = k_begin / BK;
  const int n = (k_end + BK - 1) / BK - kt0;
  auto prefetch = [&](int i) {  // start step i's copies; one group a step
    if (i < n) {
      const int st = i % kStages, k0 = (kt0 + i) * BK;
      bf16* ks = ring + st * 2 * BK * RS;
      copy_tile<HD, BK>(ks, k, b, k0, T, KVH, kvh);
      copy_tile<HD, BK>(ks + BK * RS, v, b, k0, T, KVH, kvh);
      if (segmented)
        copy_words(segk_ring + st * BK, seg + static_cast<size_t>(b) * T, k0,
                   BK, T);
    }
    cp_async_commit();
  };
  prefetch(0);
  prefetch(1);

  float acc[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const float c2 = scale * kLog2e;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<1>();  // step i's tiles (and the q tiles) landed
    __syncthreads();     // ... for every thread; step i - 1's reads done
    prefetch(i + 2);     // into the stage step i - 1 read
    const int st = i % kStages, k0 = (kt0 + i) * BK;
    const bf16* ks = ring + st * 2 * BK * RS;
    const bf16* vs = ks + BK * RS;
    const int* segk = segk_ring + st * BK;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_product<HD, NT>(qs + r0 * RS, ks, dos + r0 * RS, vs, s, dp);

    // dS = P (dP - delta) in place of S, P = exp(S scale - lse).
    const bool unmasked =
        !segmented && tile_unmasked(q0, BQ, k0, BK, T, causal, window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int iq = r0 + g + 8 * (e / 2), ik = j * 8 + 2 * t + (e % 2);
        float p = exp2f(s[j][e] * c2 - lr[e / 2]);
        if (!unmasked && !attends(q0 + iq, k0 + ik, T, causal, window,
                                  segmented ? segq : nullptr, segk, iq, ik))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - dr[e / 2]);
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(s, kk, a);
      out_product<HD>(a, ks, kk, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= T) continue;
    bf16* o = dq + ((static_cast<size_t>(b) * T + row) * H + h) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      *reinterpret_cast<uint32_t*>(o + c * 8) =
          pack_bf16(acc[c][2 * i] * scale, acc[c][2 * i + 1] * scale);
  }
}

// dkv: one block per (b*KVH + kv head, partition of the group's q heads,
// 64-key tile), key tiles slowest; warp w owns keys 16w ... 16w + 15 and
// streams the 32-row q/dO tiles (with lse, delta and segment ids) of
// every q head of the partition that attend the block's keys.  With
// `part` null the block writes dk and dv; otherwise f32 partials at
// part[0 or 1][partition][B, T, KVH, HD] (dk, then dv).
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2) flash_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ seg, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ part, int T, int H, int KVH,
    int split, int causal, int window, float scale) {
  constexpr int BK = kTcRows, BQ = kTcStep, RS = kRowStride<HD>;
  constexpr int NT = BQ / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kss = reinterpret_cast<bf16*>(smem_raw);  // [BK][RS]
  bf16* vss = kss + BK * RS;                      // [BK][RS]
  bf16* ring = vss + BK * RS;  // stage s: q, dO [BQ][RS] at ring + 2 s BQ RS
  float* words = reinterpret_cast<float*>(ring + kStages * 2 * BQ * RS);
  // stage s: lse at words + 3 s BQ, delta after it, then segment ids.
  int* segk = reinterpret_cast<int*>(words + kStages * 3 * BQ);  // [BK]
  const bool segmented = seg != nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int bkv = blockIdx.x / split, partition = blockIdx.x % split;
  const int b = bkv / KVH, kvh = bkv % KVH;
  const int group = H / KVH, heads = group / split;
  const int h0 = kvh * group + partition * heads;
  const int k0 = blockIdx.y * BK;

  copy_tile<HD, BK>(kss, k, b, k0, T, KVH, kvh);
  copy_tile<HD, BK>(vss, v, b, k0, T, KVH, kvh);
  if (segmented) copy_words(segk, seg + static_cast<size_t>(b) * T, k0, BK, T);

  // The q rows [q_begin, q_end) that attend any key of this tile.
  const int q_begin = causal ? k0 : 0;
  const int q_end = causal && window ? min(T, k0 + BK - 1 + window) : T;
  const int qt0 = q_begin / BQ;
  const int n_qt = (q_end + BQ - 1) / BQ - qt0;
  const int n = heads * n_qt;
  auto prefetch = [&](int i) {  // start step i's copies; one group a step
    if (i < n) {
      const int st = i % kStages;
      const int h = h0 + i / n_qt, q0 = (qt0 + i % n_qt) * BQ;
      const size_t bh = static_cast<size_t>(b) * H + h;
      bf16* qs = ring + st * 2 * BQ * RS;
      float* w = words + st * 3 * BQ;
      copy_tile<HD, BQ>(qs, q, b, q0, T, H, h);
      copy_tile<HD, BQ>(qs + BQ * RS, dout, b, q0, T, H, h);
      copy_words(w, lse + bh * T, q0, BQ, T);
      copy_words(w + BQ, delta + bh * T, q0, BQ, T);
      if (segmented)
        copy_words(w + 2 * BQ, seg + static_cast<size_t>(b) * T, q0, BQ, T);
    }
    cp_async_commit();
  };
  prefetch(0);
  prefetch(1);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;
  const float c2 = scale * kLog2e;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<1>();  // step i's tiles (and the key tiles) landed
    __syncthreads();     // ... for every thread; step i - 1's reads done
    prefetch(i + 2);     // into the stage step i - 1 read
    const int st = i % kStages, q0 = (qt0 + i % n_qt) * BQ;
    const bf16* qs = ring + st * 2 * BQ * RS;
    const bf16* dos = qs + BQ * RS;
    const float* lse_s = words + st * 3 * BQ;
    const float* delta_s = lse_s + BQ;
    const int* segq = reinterpret_cast<const int*>(lse_s + 2 * BQ);

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns q rows.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_product<HD, NT>(kss + r0 * RS, qs, vss + r0 * RS, dos, s, dp);

    // P^T in place of S^T, dS^T = P^T (dP^T - delta) in place of dP^T.
    const bool unmasked =
        !segmented && tile_unmasked(q0, BQ, k0, BK, T, causal, window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ik = r0 + g + 8 * (e / 2), iq = j * 8 + 2 * t + (e % 2);
        float p = exp2f(s[j][e] * c2 - lse_s[iq] * kLog2e);
        if (!unmasked && !attends(q0 + iq, k0 + ik, T, causal, window,
                                  segmented ? segq : nullptr, segk, iq, ik))
          p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_s[iq]);
      }
    // dV += P^T dO, dK += dS^T Q (scaled at the end).
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(s, kk, a);
      out_product<HD>(a, dos, kk, dva);
      acc_to_a(dp, kk, a);
      out_product<HD>(a, qs, kk, dka);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + g + 8 * i;
    if (row >= T) continue;
    const size_t at =
        ((static_cast<size_t>(b) * T + row) * KVH + kvh) * HD + 2 * t;
    if (part == nullptr) {
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        *reinterpret_cast<uint32_t*>(dk + at + c * 8) =
            pack_bf16(dka[c][2 * i] * scale, dka[c][2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at + c * 8) =
            pack_bf16(dva[c][2 * i], dva[c][2 * i + 1]);
      }
    } else {
      const size_t n_out = static_cast<size_t>(gridDim.x / split) * T * HD;
      float* pk = part + static_cast<size_t>(partition) * n_out + at;
      float* pv = pk + static_cast<size_t>(split) * n_out;
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        *reinterpret_cast<float2*>(pk + c * 8) =
            make_float2(dka[c][2 * i] * scale, dka[c][2 * i + 1] * scale);
        *reinterpret_cast<float2*>(pv + c * 8) =
            make_float2(dva[c][2 * i], dva[c][2 * i + 1]);
      }
    }
  }
}

// dk, dv = the sums of the split partials, in partition order, as bf16:
// four elements a thread (n, the elements of dk, is a multiple of hd).
__global__ void __launch_bounds__(256) dkv_sum_kernel(
    const float* __restrict__ part, int split, size_t n,
    bf16* __restrict__ dk, bf16* __restrict__ dv) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* p = part + static_cast<size_t>(which) * split * n + i;
    float4 acc = *reinterpret_cast<const float4*>(p);
    for (int s = 1; s < split; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(p + s * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 out;
    out.x = pack_bf16(acc.x, acc.y);
    out.y = pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>((which ? dv : dk) + i) = out;
  }
}

// ---------------------------------------------------------------------------
// Launchers

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

float softmax_scale(int hd) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
}

template <int HD, typename DT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int32_t* seg, void* out, float* lse, int B,
                       int T, int H, int KVH, int causal, int window,
                       cudaStream_t stream) {
  if constexpr (std::is_same_v<DT, bf16>) {
    const size_t smem = fwd_tc_smem_bytes<HD>();
    auto kernel = flash_fwd_tc_kernel<HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (T + kTcRows - 1) / kTcRows);
    kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), seg, static_cast<bf16*>(out), lse, T, H,
        KVH, causal, window, softmax_scale(HD));
  } else {
    const size_t smem = sizeof(float) * fwd_floats<HD>();
    auto kernel = flash_fwd_kernel<HD, DT>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T + kFwdBQ - 1) / kFwdBQ, B * H);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const DT*>(q), static_cast<const DT*>(k),
        static_cast<const DT*>(v), seg, static_cast<DT*>(out), lse, T, H, KVH,
        causal, window, softmax_scale(HD));
  }
  return cudaGetLastError();
}

template <int HD, typename DT>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int32_t* seg, void* dq, int B, int T, int H,
                      int KVH, int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same_v<DT, bf16>) {
    const size_t smem = tc_smem_bytes<HD>();
    auto kernel = flash_dq_tc_kernel<HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (T + kTcRows - 1) / kTcRows);
    kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, seg, static_cast<bf16*>(dq), T, H, KVH, causal, window,
        softmax_scale(HD));
  } else {
    const size_t smem = sizeof(float) * dq_floats<HD>();
    auto kernel = flash_dq_kernel<HD, DT>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T + kFwdBQ - 1) / kFwdBQ, B * H);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const DT*>(q), static_cast<const DT*>(k),
        static_cast<const DT*>(v), static_cast<const DT*>(dout), lse, delta,
        seg, static_cast<DT*>(dq), T, H, KVH, causal, window,
        softmax_scale(HD));
  }
  return cudaGetLastError();
}

// split partitions of each group (bf16 only; f32 takes split 1): with
// split > 1, `part` holds 2 * split * B * T * KVH * HD floats.
template <int HD, typename DT>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const int32_t* seg, void* dk,
                       void* dv, float* part, int B, int T, int H, int KVH,
                       int causal, int window, int split,
                       cudaStream_t stream) {
  if constexpr (std::is_same_v<DT, bf16>) {
    if (split > 1 && part == nullptr) return cudaErrorInvalidValue;
    const size_t smem = tc_smem_bytes<HD>();
    auto kernel = flash_dkv_tc_kernel<HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * KVH * split, (T + kTcRows - 1) / kTcRows);
    kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, seg, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        split > 1 ? part : nullptr, T, H, KVH, split, causal, window,
        softmax_scale(HD));
    if (split > 1) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      const size_t n = static_cast<size_t>(B) * T * KVH * HD;
      const unsigned blocks = static_cast<unsigned>((n / 4 + 255) / 256);
      dkv_sum_kernel<<<blocks, 256, 0, stream>>>(
          part, split, n, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
    }
  } else {
    if (split != 1) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * dkv_floats<HD>();
    auto kernel = flash_dkv_kernel<HD, DT>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T + kBK - 1) / kBK, B * KVH);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const DT*>(q), static_cast<const DT*>(k),
        static_cast<const DT*>(v), static_cast<const DT*>(dout), lse, delta,
        seg, static_cast<DT*>(dk), static_cast<DT*>(dv), T, H, KVH, causal,
        window, softmax_scale(HD));
  }
  return cudaGetLastError();
}

bool valid_geometry(int B, int T, int H, int KVH, int hd) {
  return B > 0 && T > 0 && KVH > 0 && H % KVH == 0 && (hd == 64 || hd == 128);
}

// Call launch(hd as a compile-time constant, (DT*)nullptr) for the
// (hd, dtype) pair the kernels are instantiated for.
template <typename Launch>
cudaError_t dispatch(int hd, int dtype, Launch launch) {
  using Hd64 = std::integral_constant<int, 64>;
  using Hd128 = std::integral_constant<int, 128>;
  if (hd == 64 && dtype == kOimF32) return launch(Hd64(), (float*)nullptr);
  if (hd == 64 && dtype == kOimBF16)
    return launch(Hd64(), (__nv_bfloat16*)nullptr);
  if (hd == 128 && dtype == kOimF32) return launch(Hd128(), (float*)nullptr);
  if (hd == 128 && dtype == kOimBF16)
    return launch(Hd128(), (__nv_bfloat16*)nullptr);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int oim_flash_fwd(const void* q, const void* k, const void* v,
                             int dtype, const int32_t* segments, void* out,
                             float* lse, int B, int T, int H, int KVH, int hd,
                             int causal, int window, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (!valid_geometry(B, T, H, KVH, hd)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(hd, dtype, [&](auto hd_c, auto* dt) {
    using DT = std::remove_pointer_t<decltype(dt)>;
    return launch_fwd<decltype(hd_c)::value, DT>(
        q, k, v, segments, out, lse, B, T, H, KVH, causal, window, s);
  });
}

extern "C" int oim_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, int dtype,
                            const int32_t* segments, void* dq, int B, int T,
                            int H, int KVH, int hd, int causal, int window,
                            void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (!valid_geometry(B, T, H, KVH, hd)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(hd, dtype, [&](auto hd_c, auto* dt) {
    using DT = std::remove_pointer_t<decltype(dt)>;
    return launch_dq<decltype(hd_c)::value, DT>(q, k, v, dout, lse, delta,
                                                 segments, dq, B, T, H, KVH,
                                                 causal, window, s);
  });
}

extern "C" int oim_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, int dtype,
                             const int32_t* segments, void* dk, void* dv,
                             float* partials, int B, int T, int H, int KVH,
                             int hd, int causal, int window, int split,
                             void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (!valid_geometry(B, T, H, KVH, hd) || split < 1 ||
      (H / KVH) % split != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(hd, dtype, [&](auto hd_c, auto* dt) {
    using DT = std::remove_pointer_t<decltype(dt)>;
    return launch_dkv<decltype(hd_c)::value, DT>(
        q, k, v, dout, lse, delta, segments, dk, dv, partials, B, T, H, KVH,
        causal, window, split, s);
  });
}
