// Flash attention for Hopper (sm_90a), written by hand in CUDA C++:
// forward, dq and dkv.
//
// flash_fwd_kernel replaces oim_tpu/ops/flash_attention.py _fwd_kernel,
// flash_dq_kernel _dq_kernel, flash_dkv_kernel _dkv_kernel.  They compute
// what the TPU kernels compute, not block for block:
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
//   - dkv gives a block one (b*KVH + kv head, 32-key tile) and loops over
//     the group's q heads and the q tiles in order, so dk/dv accumulate
//     in registers with no atomics and sum in a fixed order
//     (deterministic), where the TPU revisited the output block over an
//     inner grid axis.  32-key tiles give Qwen's B*KVH = 8 rows 256
//     blocks for the 132 SMs.
//
// Bound on this card: operations.  At the training shape (B=4, T=1024,
// H=12, KVH=2, hd=128, causal) the forward does 4*hd flops per attended
// (query, key) pair, dq 6*hd and dkv 8*hd (three and four products),
// against reading q/k/v/out once (a few MB).  In bf16 against the tensor
// cores' 989 TFLOP/s the bound is tens of microseconds.
//
// Design, simple first: f32 CUDA-core arithmetic (no tensor cores yet),
// 256 threads as a 16 x 16 grid, each thread holding a register tile of
// scores and of its output rows; operand tiles staged in shared memory
// as f32 with rows padded to hd + 1 floats so the column walks are free
// of bank conflicts; global loads in 16-byte chunks.  Left on the table:
// wgmma/mma.sync on bf16 tiles, TMA/cp.async double buffering, and dkv's
// load imbalance (the first key tile of a causal row sees every q tile,
// the last one a single tile).
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
// Forward: one block per (64-row q tile, b*H + h).  Thread (ty, tx) owns
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
// dq: one block per (64-row q tile, b*H + h); the score mapping of the
// forward, and dq rows ty + 16i, columns tx + 16c in registers.

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
// dkv: one block per (32-key tile, b*KVH + kv head).  Per inner step (q
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
  const size_t smem = sizeof(float) * fwd_floats<HD>();
  auto kernel = flash_fwd_kernel<HD, DT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kFwdBQ - 1) / kFwdBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const DT*>(q), static_cast<const DT*>(k),
      static_cast<const DT*>(v), seg, static_cast<DT*>(out), lse, T, H, KVH,
      causal, window, softmax_scale(HD));
  return cudaGetLastError();
}

template <int HD, typename DT>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int32_t* seg, void* dq, int B, int T, int H,
                      int KVH, int causal, int window, cudaStream_t stream) {
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
  return cudaGetLastError();
}

template <int HD, typename DT>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const int32_t* seg, void* dk,
                       void* dv, int B, int T, int H, int KVH, int causal,
                       int window, cudaStream_t stream) {
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
                             int B, int T, int H, int KVH, int hd, int causal,
                             int window, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (!valid_geometry(B, T, H, KVH, hd)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(hd, dtype, [&](auto hd_c, auto* dt) {
    using DT = std::remove_pointer_t<decltype(dt)>;
    return launch_dkv<decltype(hd_c)::value, DT>(q, k, v, dout, lse, delta,
                                                  segments, dk, dv, B, T, H,
                                                  KVH, causal, window, s);
  });
}
