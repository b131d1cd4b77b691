// The weight-quantized product for Hopper (sm_90a), written by hand in
// CUDA C++.
//
// Replaces no Pallas kernel.  The reference serves weight-only int8 and
// int4 params by dequantizing them in plain JAX and relies on XLA to fuse
// the convert and the scale into the consuming product's operand read, so
// that device-memory traffic stays int8 (oim_tpu/ops/quant.py:53-55) or
// packed int4 (:113-114).  PyTorch fuses nothing: dequantizing to bf16 and
// then calling torch.matmul would move 1 + 2 + 2 bytes a weight where bf16
// weights move 2, and quantized decode would be slower than unquantized.
// This kernel is that fused convert+scale: the product reads the int8 or
// packed int4 payload and dequantizes it in registers.
//
// What it computes (ops/wquant.py quant_matmul_plain): out = x @ W, W =
// round(float(q) * scale) rounded to x's dtype, as the reference's
// dequantize_named(..., dtype=compute_dtype) does, sums in f32, the output
// in x's dtype or f32 (the unembedding's f32 logits).  The rounding is
// kept element by element (float(q) · scale with one f32 rounding, then
// round half to even to bf16), so the kernel and the plain version read
// the same operand values and differ in summation order only.
//
// quant_matmul_kernel, for decode-shaped rows of bf16 x (the wrapper
// sends at most 64 rows an expert here: every decode pass, the
// admission's one-row unembedding, the MoE expert passes at decode).
// Bound: the payload's bytes, read once (a Qwen2.5-1.5B decode pass reads
// 1.5 GB of bf16 weights, 0.78 GB int8; a Mixtral-8x7B layer's experts
// 1.41 GB int8).  Design: a block owns 128 output columns of one expert,
// one range of the reduction and 16 rows of x; its four warps each take a
// contiguous share of the range and run it as 16-row steps of mma.sync
// m16n8k16 (bf16 in, f32 sums), x as the A operand (staged once in shared
// memory, rows padded so an A fragment's eight rows sit in distinct
// banks) and the weights as B.  Lane (g, t) owns 16 columns — column g of
// each of the warp's 16 n8 tiles — so one 16-byte load of a payload row,
// along dout and coalesced with its neighbours', is the lane's row of all
// 16 tiles: int8 rows 2t, 2t + 1, 2t + 8 and 2t + 9 are its B fragments'
// rows, packed int4 rows t and t + 4 hold the same reduction rows as
// nibble pairs.  Each step's loads are issued before the step before is
// used.  The weights are widened in registers (a byte or nibble into the
// mantissa of 2^23 and one subtraction: no integer conversion), scaled
// and rounded to bf16 two at a time into the B registers, so the CUDA
// cores do about four operations a weight and the tensor cores the
// products.  The four warps' sums meet through shared memory in warp
// order.  The reduction is also split across blocks (ops/wquant.py
// quant_split: about four blocks an SM, and few enough rows of x a block
// to stage); quant_merge_kernel then sums the splits' f32 partials in
// split order.  No atomics: two launches give the same bits.  A first
// version summed on the CUDA cores (eight FMAs a weight at 8 rows) and
// ran at 35-38 % of the byte bound on Mixtral's experts, slower than
// torch.matmul on bf16 weights (PERF.md).
//
// Left on the table: the payload goes global memory -> registers with
// plain 16-byte loads (no TMA or cp.async ring, no warp specialisation);
// a decode step pads its 8 rows to the mma's 16.
//
// dequant_kernel, for taller products (admission waves and segments): W
// in x's dtype, written once for torch.matmul to read — the reference
// computes that product outside any Pallas kernel.  Bound: the payload
// read and W written once.  Each thread widens 16 payload bytes of a row
// (16 int8 weights, or 16 columns of two int4 rows) from one 16-byte
// load into 16-byte stores, with 32-bit index arithmetic (a first
// version, a byte a thread with 64-bit divisions, ran at a third of the
// bytes' rate).
#include "wquant.cuh"

#include <algorithm>

namespace {

using namespace oim;

constexpr int kQThreads = 128;
constexpr int kQWarps = kQThreads / 32;  // reduction slices, one a warp
constexpr int kTiles = 16;               // n8 tiles a warp (a lane's columns)
constexpr int kTileCols = 8 * kTiles;    // columns a block owns: 128
constexpr int kStepK = 16;               // reduction rows an mma step

// Two int8 weights (bytes `byte` of words a and b, xor 0x80 applied) as
// f32: each byte into the mantissa of 2^23, less 2^23 + 128.  Exact.
__device__ __forceinline__ float widen8(uint32_t word, int byte) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + byte)) -
         8388736.f;
}

// A packed int4 nibble (xor 8 applied, shifted to the low 4 bits) as f32.
__device__ __forceinline__ float widen4(uint32_t bits) {
  return __uint_as_float(0x4B000000u | (bits & 0xfu)) - 8388616.f;
}

// The B fragment register of two weights: each round(v * scale) to bf16
// (as torch's .to(bfloat16) rounds the reference's f32 dequant), the
// lower reduction row in the low half.
__device__ __forceinline__ uint32_t weight_pair(float lo, float hi,
                                                float scale) {
  return pack_bf16(__fmul_rn(lo, scale), __fmul_rn(hi, scale));
}

__device__ __forceinline__ void load_scales(const float* p, float (&sc)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 s = __ldg(reinterpret_cast<const float4*>(p) + i);
    sc[4 * i] = s.x;
    sc[4 * i + 1] = s.y;
    sc[4 * i + 2] = s.z;
    sc[4 * i + 3] = s.w;
  }
}

// Payload rows a 16-row mma step reads: 16 int8 rows, 8 packed int4 ones.
template <bool INT4>
constexpr int kStepRows = INT4 ? kStepK / 2 : kStepK;
// The 16-byte payload loads a lane makes a step (int8 rows 2t, 2t + 1,
// 2t + 8, 2t + 9; int4 rows t and t + 4).
template <bool INT4>
constexpr int kLoads = INT4 ? 2 : 4;

// Shared memory of a block: x's ROWS rows of the block's reduction range
// as bf16, each padded by 8 (so the 8 rows an A fragment reads sit in
// distinct banks), or the warps' sums for the final reduction, whichever
// is larger.
template <bool INT4, int ROWS>
size_t qmm_smem_bytes(int per_split) {
  const size_t span = static_cast<size_t>(per_split) * (INT4 ? 2 : 1) + 8;
  const size_t xs = ROWS * span * sizeof(__nv_bfloat16);
  const size_t red = sizeof(float) * kQWarps * 16 * kTileCols;
  return xs > red ? xs : red;
}

// Grid (N / 128, splits x row tiles of 16, E); 4 warps, each a
// contiguous share of the block's reduction range over the block's 128
// columns.  Lane (g, t) of a warp owns columns 16g ... 16g + 15 of the
// block: column 16g + j is column g of the warp's n8 tile j, so one
// 16-byte load of a payload row gives the lane its row of all 16 tiles.
// ROWS: the A rows read (8: rows 8-15 of the mma are zeros).  `part`
// null: write out; otherwise part[split][E][M][N] holds the split's f32
// sums.
template <typename OT, bool INT4, int ROWS>
__global__ void __launch_bounds__(kQThreads) quant_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, long long x_es,
    const uint8_t* __restrict__ q, const float* __restrict__ scale,
    OT* __restrict__ out, float* __restrict__ part, int M, int K, int N,
    int G, int per_split, int row_tiles) {
  using bf16 = __nv_bfloat16;
  constexpr int SR = kStepRows<INT4>, NL = kLoads<INT4>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int e = blockIdx.z, split = blockIdx.y / row_tiles;
  const int m0 = (blockIdx.y % row_tiles) * 16;
  const int nrows = min(16, M - m0);
  const int n_blk = blockIdx.x * kTileCols;
  const int P = INT4 ? K / 2 : K;  // payload rows (K % 16 == 0)
  // The block's payload rows [p_lo, p_hi) (reduction rows from k_lo),
  // this warp's contiguous share of its mma steps.
  const int p_lo = split * per_split, p_hi = min(P, p_lo + per_split);
  const int k_lo = INT4 ? 2 * p_lo : p_lo;
  const int steps = (p_hi - p_lo) / SR;
  const int per = (steps + kQWarps - 1) / kQWarps;
  const int s_lo = min(steps, warp * per), s_hi = min(steps, s_lo + per);
  const uint8_t* qe =
      q + static_cast<size_t>(e) * P * N + n_blk + 16 * g;

  // The lane's payload rows of step s (16 bytes each).
  auto load_step = [&](int s, uint4 (&raw)[NL]) {
    const int p0 = p_lo + s * SR;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      // int8: rows 2t, 2t + 1, 2t + 8, 2t + 9; int4: rows t, t + 4.
      const int row = INT4 ? t + 4 * i : 2 * t + (i & 1) + 8 * (i >> 1);
      raw[i] = s < s_hi ? __ldg(reinterpret_cast<const uint4*>(
                              qe + static_cast<size_t>(p0 + row) * N))
                        : make_uint4(0, 0, 0, 0);
    }
  };
  uint4 raw[NL];
  load_step(s_lo, raw);  // in flight while x is staged

  // x's rows of the block's range, [ROWS][span] (rows past the last are
  // zeros), read once in 16-byte vectors along k.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  const int span = (p_hi - p_lo) * (INT4 ? 2 : 1), stride = span + 8;
  {
    constexpr int kBatch = 8;
    const bf16* xe = x + e * x_es + static_cast<size_t>(m0) * K + k_lo;
    const int chunks = span / 8, total = ROWS * chunks;
    for (int base = threadIdx.x; base < total; base += kQThreads * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kQThreads, r = i / max(chunks, 1);
        v[j] = i < total && r < nrows
                   ? __ldg(reinterpret_cast<const uint4*>(
                         xe + static_cast<size_t>(r) * K + (i % chunks) * 8))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kQThreads;
        if (i >= total) break;
        *reinterpret_cast<uint4*>(xs + (i / chunks) * stride +
                                  (i % chunks) * 8) = v[j];
      }
    }
  }
  __syncthreads();

  float acc[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  // int8: one scale a column; int4: the group's, reloaded when a step
  // leaves it (the wrapper sends groups of a multiple of 16 rows here).
  const float* se = scale + static_cast<size_t>(e) * (INT4 ? K / G : 1) * N +
                    n_blk + 16 * g;
  float sc[16];
  int g_end = 0;
  if constexpr (!INT4) load_scales(se, sc);
  for (int s = s_lo; s < s_hi; ++s) {
    uint4 cur[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) cur[i] = raw[i];
    load_step(s + 1, raw);  // the next step's loads overlap this one
    const int k0 = k_lo + s * kStepK;
    if constexpr (INT4) {
      if (k0 >= g_end) {
        const int grp = k0 / G;
        g_end = (grp + 1) * G;
        load_scales(se + static_cast<size_t>(grp) * N, sc);
      }
    }
    // A: x rows g (and g + 8) at reduction rows 2t, 2t + 1 (a0, a1) and
    // 2t + 8, 2t + 9 (a2, a3) of the step.
    const bf16* xr = xs + g * stride + (k0 - k_lo) + 2 * t;
    uint32_t a[4] = {ld32(xr), 0u, ld32(xr + 8), 0u};
    if constexpr (ROWS == 16) {
      a[1] = ld32(xr + 8 * stride);
      a[3] = ld32(xr + 8 * stride + 8);
    }
    // The payload words offset as widen8/widen4 take them.
    uint32_t w[4 * NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const uint32_t off = INT4 ? 0x88888888u : 0x80808080u;
      w[4 * i] = cur[i].x ^ off;
      w[4 * i + 1] = cur[i].y ^ off;
      w[4 * i + 2] = cur[i].z ^ off;
      w[4 * i + 3] = cur[i].w ^ off;
    }
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      uint32_t b[2];
      if constexpr (INT4) {
        // Byte j of rows t and t + 4: reduction rows (2t, 2t + 1) and
        // (2t + 8, 2t + 9), the low nibble first.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t byte = w[4 * h + j / 4] >> (8 * (j % 4));
          b[h] = weight_pair(widen4(byte), widen4(byte >> 4), sc[j]);
        }
      } else {
        // Byte j of rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1).
#pragma unroll
        for (int h = 0; h < 2; ++h)
          b[h] = weight_pair(widen8(w[8 * h + j / 4], j % 4),
                             widen8(w[8 * h + 4 + j / 4], j % 4), sc[j]);
      }
      mma_bf16(acc[j], a, b);
    }
  }

  // The warps' sums in warp order: tile j's column c is block column
  // 16c + j, so acc[j] holds columns 32t + j and 32t + 16 + j of rows g
  // and g + 8.
  __syncthreads();  // every warp is done with xs
  float* red = reinterpret_cast<float*>(smem_raw);  // [warp][16][128]
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    float* r = red + (warp * 16 + g) * kTileCols + 32 * t + j;
    r[0] = acc[j][0];
    r[16] = acc[j][1];
    r[8 * kTileCols] = acc[j][2];
    r[8 * kTileCols + 16] = acc[j][3];
  }
  __syncthreads();
  const size_t EMN = static_cast<size_t>(gridDim.z) * M * N;
  for (int i = threadIdx.x; i < nrows * kTileCols; i += kQThreads) {
    const int m = i / kTileCols, c = i % kTileCols;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kQWarps; ++wi)
      sum += red[(wi * 16 + m) * kTileCols + c];
    const size_t o = (static_cast<size_t>(e) * M + m0 + m) * N + n_blk + c;
    if (part == nullptr)
      from_f32(sum, out + o);
    else
      part[split * EMN + o] = sum;
  }
}

// out[i] = the splits' partials of element i summed in split order.
template <typename OT>
__global__ void __launch_bounds__(256) quant_merge_kernel(
    const float* __restrict__ part, OT* __restrict__ out, int splits,
    size_t total) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += part[s * total + i];
    from_f32(sum, out + i);
  }
}

template <typename OT, bool INT4, int ROWS>
cudaError_t launch_qmm(const void* x, long long x_es, const uint8_t* q,
                       const float* scale, void* out, float* part, int E,
                       int M, int K, int N, int G, int splits,
                       cudaStream_t stream) {
  constexpr int SR = kStepRows<INT4>;
  const int P = INT4 ? K / 2 : K;
  // Ranges of whole mma steps (so x's staging starts on a 16-byte
  // boundary and each step lies in one int4 group).
  const int per_split = ((P + splits - 1) / splits + SR - 1) / SR * SR;
  splits = (P + per_split - 1) / per_split;
  const int row_tiles = (M + 15) / 16;
  if (static_cast<long long>(splits) * row_tiles > 65535 || E > 65535)
    return cudaErrorInvalidValue;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = qmm_smem_bytes<INT4, ROWS>(per_split);
  auto kernel = quant_matmul_kernel<OT, INT4, ROWS>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kTileCols, splits * row_tiles, E);
  kernel<<<grid, kQThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), x_es, q, scale,
      static_cast<OT*>(out), splits > 1 ? part : nullptr, M, K, N, G,
      per_split, row_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = static_cast<size_t>(E) * M * N;
  const unsigned blocks =
      static_cast<unsigned>(std::min<size_t>((total + 255) / 256, 4096));
  quant_merge_kernel<OT><<<blocks, 256, 0, stream>>>(
      part, static_cast<OT*>(out), splits, total);
  return cudaGetLastError();
}

template <typename OT>
cudaError_t dispatch_quant(const void* x, long long x_es, const void* q,
                           int q_dtype, const float* scale, void* out,
                           float* part, int E, int M, int K, int N, int G,
                           int splits, cudaStream_t stream) {
  const uint8_t* qb = static_cast<const uint8_t*>(q);
#define OIM_QMM(INT4, ROWS)                                                \
  return launch_qmm<OT, INT4, ROWS>(x, x_es, qb, scale, out, part, E, M, K, \
                                    N, G, splits, stream)
  if (q_dtype == kOimI8) {
    if (M <= 8) OIM_QMM(false, 8);
    OIM_QMM(false, 16);
  }
  if (q_dtype == kOimI4) {
    if (M <= 8) OIM_QMM(true, 8);
    OIM_QMM(true, 16);
  }
#undef OIM_QMM
  return cudaErrorInvalidValue;
}

// W[e, k, n] = round(float(q) * scale) in WT.  VEC: 16 payload bytes of a
// row a thread (N % 16 == 0: one 16-byte load, one or two rows of 16
// values stored in 16-byte vectors); else one byte a thread.  Indices
// are 32-bit (the wrapper checks the payload's size).
template <typename WT, bool INT4, bool VEC>
__global__ void __launch_bounds__(256) dequant_kernel(
    const uint8_t* __restrict__ q, const float* __restrict__ scale,
    WT* __restrict__ w, int K, int N, int G, uint32_t rows) {
  constexpr int kV = VEC ? 16 : 1;  // payload bytes a thread
  const uint32_t P = INT4 ? (K + 1) / 2 : K, per_row = N / kV;
  const uint32_t total = rows * per_row;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const uint32_t row = i / per_row, n = (i % per_row) * kV;
    const uint32_t e = row / P, p = row % P;
    __align__(16) uint8_t bytes[kV];
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(bytes) =
          __ldg(reinterpret_cast<const uint4*>(q + size_t{row} * N + n));
    } else {
      bytes[0] = q[size_t{row} * N + n];
    }
    // One reduction row of kV values: round(value * scale) in WT.
    auto put = [&](uint32_t k, const float* sc, auto value) {
      __align__(16) WT out[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j)
        from_f32(__fmul_rn(value(bytes[j]), sc[j]), out + j);
      WT* dst = w + (size_t{e} * K + k) * N + n;
      if constexpr (VEC) {
#pragma unroll
        for (int c = 0; c < static_cast<int>(sizeof(out)) / 16; ++c)
          reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<uint4*>(out)[c];
      } else {
        dst[0] = out[0];
      }
    };
    if constexpr (INT4) {
      const float* se = scale + size_t{e} * (K / G) * N + n;
      const uint32_t k0 = 2 * p;
      put(k0, se + size_t{k0 / G} * N,
          [](uint32_t b) { return int4_lo(b); });
      if (k0 + 1 < static_cast<uint32_t>(K))
        put(k0 + 1, se + size_t{(k0 + 1) / G} * N,
            [](uint32_t b) { return int4_hi(b); });
    } else {
      put(p, scale + size_t{e} * N + n, [](uint32_t b) {
        return static_cast<float>(static_cast<int8_t>(b));
      });
    }
  }
}

template <typename WT, bool INT4>
cudaError_t launch_dequant_as(const uint8_t* q, const float* scale, void* w,
                              int E, int K, int N, int G,
                              cudaStream_t stream) {
  const size_t P = INT4 ? (K + 1) / 2 : K;
  const size_t rows = static_cast<size_t>(E) * P;
  const bool vec = N % 16 == 0;
  const size_t total = rows * (vec ? N / 16 : N);
  if (total >= (size_t{1} << 32)) return cudaErrorInvalidValue;
  const unsigned blocks =
      static_cast<unsigned>(std::min<size_t>((total + 255) / 256, 1 << 16));
  if (vec)
    dequant_kernel<WT, INT4, true><<<blocks, 256, 0, stream>>>(
        q, scale, static_cast<WT*>(w), K, N, G, static_cast<uint32_t>(rows));
  else
    dequant_kernel<WT, INT4, false><<<blocks, 256, 0, stream>>>(
        q, scale, static_cast<WT*>(w), K, N, G, static_cast<uint32_t>(rows));
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_dequant(const void* q, int q_dtype, const float* scale,
                           void* w, int E, int K, int N, int G,
                           cudaStream_t stream) {
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  if (q_dtype == kOimI8)
    return launch_dequant_as<WT, false>(qb, scale, w, E, K, N, G, stream);
  if (q_dtype == kOimI4)
    return launch_dequant_as<WT, true>(qb, scale, w, E, K, N, G, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int oim_quant_matmul(const void* x, int x_dtype,
                                long long x_expert_stride, const void* q,
                                int q_dtype, const float* scale, void* out,
                                int out_dtype, float* partials, int E, int M,
                                int K, int N, int group, int splits,
                                void* stream) {
  if (E == 0 || M == 0 || N == 0) return cudaSuccess;
  if (x_dtype != kOimBF16 || K < kStepK || K % kStepK != 0 ||
      N % kTileCols != 0 || splits < 1 ||
      (q_dtype == kOimI4 && (group < kStepK || group % kStepK != 0 ||
                             K % group != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == kOimBF16)
    return dispatch_quant<__nv_bfloat16>(x, x_expert_stride, q, q_dtype,
                                         scale, out, partials, E, M, K, N,
                                         group, splits, s);
  if (out_dtype == kOimF32)
    return dispatch_quant<float>(x, x_expert_stride, q, q_dtype, scale, out,
                                 partials, E, M, K, N, group, splits, s);
  return cudaErrorInvalidValue;
}

extern "C" int oim_dequant_weight(const void* q, int q_dtype,
                                  const float* scale, void* w, int w_dtype,
                                  int E, int K, int N, int group,
                                  void* stream) {
  if (E == 0 || K == 0 || N == 0) return cudaSuccess;
  if (q_dtype == kOimI4 && (group < 1 || K % group != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == kOimBF16)
    return launch_dequant<__nv_bfloat16>(q, q_dtype, scale, w, E, K, N,
                                         group, s);
  if (w_dtype == kOimF32)
    return launch_dequant<float>(q, q_dtype, scale, w, E, K, N, group, s);
  return cudaErrorInvalidValue;
}
