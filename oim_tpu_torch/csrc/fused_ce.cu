// Fused unembedding + cross-entropy for Hopper (sm_90a), written by hand
// in CUDA C++: the forward (lse and target logit), dx and dw.
//
// oim_fused_ce_fwd / oim_fused_ce_tc_fwd replace oim_tpu/ops/fused_ce.py
// _fwd_kernel; oim_fused_ce_dx, oim_fused_ce_dw and oim_fused_ce_tc_bwd
// replace _dx_kernel and _dw_kernel.  They compute what the TPU kernels
// compute, not block for block:
//
//   - The TPU walks the vocabulary as a sequential grid axis and carries
//     the online (m, l, target) and the f32 dx / dw accumulators in VMEM
//     across it.  A (128-row, 1536) f32 dx accumulator is 768 KiB, and
//     an H100 block has 227 KB of shared memory, so nothing here carries
//     a whole row of D.  Instead every piece is a tiled product on the
//     tensor cores with its own epilogue:
//       forward:  per (128 rows, BN vocab columns) tile of s = x @ w, the
//                 epilogue reduces the tile to a per-row (max, sum of
//                 exp) pair, and ce_lse_kernel combines a row's pairs in
//                 order into lse.  The one thread that holds a row's
//                 label column writes its score as the target (no
//                 atomics, no masked row-sum).
//       backward: the vocabulary is cut into chunks of chunk_v columns.
//                 Per chunk, one product computes s for the chunk and
//                 writes the dlogits ((exp(s - lse) - onehot) * g,
//                 rounded to the compute dtype: the one definition both
//                 gradients share, as _dlogits_block is on the TPU) to a
//                 scratch [N, chunk_v]; then dx += dlogits @ w_chunk^T
//                 into an f32 [N, D] sum (the last chunk writes dx in x's
//                 dtype), and/or dw[:, chunk] = x^T @ dlogits, written
//                 once in f32.
//     Chunks run in order on one stream and each product sums its K axis
//     in order, so every output is deterministic: no float atomics.
//   - Any N: tiles past an edge are zero-filled and masked, so nothing
//     falls back to the materialized-logits path (the TPU's tiling needs
//     N with a power-of-two divisor >= 8 and V with a multiple-of-128
//     divisor).
//
// Bound on this card: operations.  At the training shape (N = 4096,
// D = 1536, V = 151936, bf16) the forward does 2 N D V = 1.9e12
// operations (1.93 ms at 989 TFLOP/s); the backward of a full step 6 N D
// V (the scores once, then the dx and the dw products), against 0.5 GB
// of w read once and 1.2 GB of dlogits written and read back.
//
// Two routes, chosen by the wrapper from the shape:
//
//   - The wgmma route (ce_tc_kernel; bf16 with D and V multiples of 8, so
//     every row is a 16-byte multiple as TMA requires): one persistent
//     block an SM walks the output tiles.  A producer warpgroup (its
//     registers lowered with setmaxnreg) has one thread issue TMA loads of
//     64-deep K steps, 128-byte swizzled, into a four-stage ring guarded
//     by full and empty mbarriers; two consumer warpgroups each own 64
//     rows of the 128-row tile and issue wgmma m64n128k16 from shared
//     memory with f32 accumulators in registers, one K step's group in
//     flight while the previous stage is released.  The producer runs
//     ahead into the next tile while the consumers run an epilogue.  The
//     three products take their operands in the majorness they lie in
//     memory, through wgmma's transpose bits: the forward and the
//     dlogits A = x K-major and B = w MN-major; dx A = dlogits and B =
//     w_chunk^T both K-major; dw A = x^T and B = dlogits both MN-major.
//     When both gradients are wanted (a full training step) each chunk's
//     dlogits are computed once and feed both products: three N D V
//     products in the backward, not four.
//   - The mma.sync route (ce_gemm_kernel; f32, and bf16 rows that TMA
//     cannot take): warp-level mma.sync m16n8k16 on 128 x 128 tiles (f32
//     inputs take a CUDA-core path with the same fragment layout), K
//     steps of 32 through two shared-memory buffers filled by
//     register-staged loads; any D and V (unaligned rows are read element
//     by element); dx and dw each recompute the dlogits.
#include "fused_ce.cuh"

#include <cuda.h>
#include <math.h>

#include <type_traits>

namespace {

using namespace oim;

constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 32;        // K per shared-memory step
constexpr int kWM = 64;        // a warp's output rows
constexpr int kWN = 32;        // a warp's output columns
constexpr int kMI = kWM / 16;  // m16 tiles per warp
constexpr int kNI = kWN / 8;   // n8 tiles per warp

// Shared-memory row stride in elements: kBK plus 16 bytes of padding, so
// the fragment reads of a warp fall in distinct banks.
template <typename T>
constexpr int kSK = kBK + 16 / static_cast<int>(sizeof(T));
// One operand tile: kBM (== kBN) rows of kSK elements.
template <typename T>
constexpr int kTile = kBM * kSK<T>;
// 16-byte chunks each thread moves per operand tile.
template <typename T>
constexpr int kLoads = kBM * kBK / kChunk<T> / kThreads;

template <typename T>
constexpr size_t smem_bytes() {
  return 2ull * 2 * kTile<T> * sizeof(T);  // two buffers of A and B
}

// An operand of the product as [rows][K]: element (r, k) at
// base[r * sr + k * sk], with k (kcontig) or r the unit-stride axis.
template <typename T>
struct Operand {
  const T* base;
  long long sr, sk;
  int rows;
  int kcontig;
  int vec;  // 16-byte chunk loads are aligned
};

enum Epilogue : int {
  kEpiStats = 0,    // forward: per-row (max, sum of exp) of the tile
  kEpiDlogits = 1,  // (exp(s - lse) - onehot) * g in T
  kEpiAccum = 2,    // dx: f32 sum over chunks, T at the last
  kEpiStore = 3,    // dw: f32
};

// C [a.rows, b.rows] = A [a.rows, K] @ B [b.rows, K]^T and what the
// epilogue does with it.
template <typename T>
struct Params {
  Operand<T> a, b;
  int K;
  int col0;  // vocabulary column of output column 0
  const int32_t* labels;
  const float* lse;
  const float* g;
  float* pm;  // stats: [gridDim.y][a.rows] maxima
  float* pl;  // stats: [gridDim.y][a.rows] sums of exp
  float* target;
  T* dl;  // dlogits: [a.rows][ldd]
  int ldd;
  float* acc;  // accum: f32 running sum [a.rows][ldo]
  T* out;      // accum: output at the last chunk
  int ldo, first, last;
  float* dw;  // store: [a.rows][ldw]
  int ldw;
};

// Tile coordinates (r, k) of the first element of this thread's chunk
// i; a chunk runs along k (kcontig) or along r.  Along k, neighbouring
// threads read neighbouring chunks of a row; along r, neighbouring
// threads take neighbouring k, so the transposing stores to shared
// memory fall in distinct banks.
template <typename T>
__device__ __forceinline__ void chunk_coords(int kcontig, int i, int* r,
                                             int* k) {
  constexpr int kE = kChunk<T>;
  const int q = threadIdx.x + i * kThreads;
  if (kcontig) {
    *r = q / (kBK / kE);
    *k = (q % (kBK / kE)) * kE;
  } else {
    *k = q % kBK;
    *r = (q / kBK) * kE;
  }
}

// The chunk at operand coordinates (r, k); zeros past the edges.
template <typename T>
__device__ __forceinline__ uint4 load_operand_chunk(const Operand<T>& op,
                                                    int r, int k, int K) {
  constexpr int kE = kChunk<T>;
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  const int left = op.kcontig ? K - k : op.rows - r;
  const bool inside = op.kcontig ? r < op.rows : k < K;
  if (!inside || left <= 0) return raw;
  const T* p = op.base + static_cast<long long>(r) * op.sr +
               static_cast<long long>(k) * op.sk;
  if (op.vec && left >= kE) return *reinterpret_cast<const uint4*>(p);
  T* e = reinterpret_cast<T*>(&raw);
  const int n = left < kE ? left : kE;
  for (int i = 0; i < n; ++i) e[i] = p[i];  // the chunk's axis has stride 1
  return raw;
}

template <typename T>
__device__ __forceinline__ void fetch(const Operand<T>& op, int k0, int K,
                                      uint4* regs) {
#pragma unroll
  for (int i = 0; i < kLoads<T>; ++i) {
    int r, k;
    chunk_coords<T>(op.kcontig, i, &r, &k);
    regs[i] = load_operand_chunk(op, r, k0 + k, K);
  }
}

// Write the fetched chunks into a [kBM][kSK] tile, k contiguous.
template <typename T>
__device__ __forceinline__ void stash(const Operand<T>& op,
                                      const uint4* regs, T* tile) {
#pragma unroll
  for (int i = 0; i < kLoads<T>; ++i) {
    int r, k;
    chunk_coords<T>(op.kcontig, i, &r, &k);
    if (op.kcontig) {
      *reinterpret_cast<uint4*>(tile + r * kSK<T> + k) = regs[i];
    } else {
      const T* e = reinterpret_cast<const T*>(&regs[i]);
#pragma unroll
      for (int j = 0; j < kChunk<T>; ++j) tile[(r + j) * kSK<T> + k] = e[j];
    }
  }
}

// One kBK step of the warp's 64 x 32 output on the tensor cores
// (fragment layout: common.cuh).
__device__ __forceinline__ void tile_product(const __nv_bfloat16* as,
                                             const __nv_bfloat16* bs, int wm,
                                             int wn, int g, int t,
                                             float (&acc)[kMI][kNI][4]) {
  constexpr int S = kSK<__nv_bfloat16>;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    uint32_t af[kMI][4], bf[kNI][2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const __nv_bfloat16* r0 = as + (wm * kWM + mi * 16 + g) * S + ks + 2 * t;
      af[mi][0] = ld32(r0);
      af[mi][1] = ld32(r0 + 8 * S);
      af[mi][2] = ld32(r0 + 8);
      af[mi][3] = ld32(r0 + 8 * S + 8);
    }
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
      const __nv_bfloat16* c0 = bs + (wn * kWN + ni * 8 + g) * S + ks + 2 * t;
      bf[ni][0] = ld32(c0);
      bf[ni][1] = ld32(c0 + 8);
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
  }
}

// The same step for f32 inputs on the CUDA cores, into the same
// accumulator layout (full f32 products: the plain version's numbers).
__device__ __forceinline__ void tile_product(const float* as, const float* bs,
                                             int wm, int wn, int g, int t,
                                             float (&acc)[kMI][kNI][4]) {
  constexpr int S = kSK<float>;
#pragma unroll 4
  for (int kk = 0; kk < kBK; ++kk) {
    float av[kMI][2], bv[kNI][2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int r = wm * kWM + mi * 16 + g;
      av[mi][0] = as[r * S + kk];
      av[mi][1] = as[(r + 8) * S + kk];
    }
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
      const int c = wn * kWN + ni * 8 + 2 * t;
      bv[ni][0] = bs[c * S + kk];
      bv[ni][1] = bs[(c + 1) * S + kk];
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        acc[mi][ni][0] = fmaf(av[mi][0], bv[ni][0], acc[mi][ni][0]);
        acc[mi][ni][1] = fmaf(av[mi][0], bv[ni][1], acc[mi][ni][1]);
        acc[mi][ni][2] = fmaf(av[mi][1], bv[ni][0], acc[mi][ni][2]);
        acc[mi][ni][3] = fmaf(av[mi][1], bv[ni][1], acc[mi][ni][3]);
      }
  }
}

// Merge two (max, sum of exp) pairs.
__device__ __forceinline__ void merge_stats(float* m, float* l, float om,
                                            float ol) {
  const float nm = fmaxf(*m, om);
  *l = *l * expf(*m - nm) + ol * expf(om - nm);
  *m = nm;
}

// One block per 128 x 128 output tile: grid (row tiles, column tiles),
// so the blocks that share a tile of B (w, the large operand) run
// together and find it in L2.
template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads) ce_gemm_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int M = p.a.rows, Nc = p.b.rows;

  // The operands from this block's corner.
  Operand<T> a = p.a, b = p.b;
  a.base += static_cast<long long>(m0) * a.sr;
  a.rows -= m0;
  b.base += static_cast<long long>(n0) * b.sr;
  b.rows -= n0;

  float acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  uint4 ra[kLoads<T>], rb[kLoads<T>];
  fetch(a, 0, p.K, ra);
  fetch(b, 0, p.K, rb);
  stash(a, ra, smem);
  stash(b, rb, smem + kTile<T>);
  __syncthreads();
  const int nk = (p.K + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const T* as = smem + (kt & 1) * 2 * kTile<T>;
    const bool more = kt + 1 < nk;
    if (more) {  // the next step's loads fly while the tensor cores work
      fetch(a, (kt + 1) * kBK, p.K, ra);
      fetch(b, (kt + 1) * kBK, p.K, rb);
    }
    tile_product(as, as + kTile<T>, wm, wn, g, t, acc);
    if (more) {
      T* next = smem + ((kt + 1) & 1) * 2 * kTile<T>;
      stash(a, ra, next);
      stash(b, rb, next + kTile<T>);
    }
    __syncthreads();
  }

  if constexpr (EPI == kEpiStats) {
    // Per row: each thread's 8 columns, then its quad (shuffles), then
    // the 4 warps along the columns (shared memory), in a fixed order.
    float* red = reinterpret_cast<float*>(smem_raw);  // [2][4][kBM]
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * kWM + mi * 16 + g + 8 * h;
        const int row = m0 + rl;
        const int label = row < M ? p.labels[row] : -1;
        float mx = kNegBig, l = 0.f;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n0 + wn * kWN + ni * 8 + 2 * t + e < Nc)
              mx = fmaxf(mx, acc[mi][ni][2 * h + e]);
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + wn * kWN + ni * 8 + 2 * t + e;
            if (col >= Nc) continue;
            const float s = acc[mi][ni][2 * h + e];
            l += expf(s - mx);
            if (p.col0 + col == label) p.target[row] = s;
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          merge_stats(&mx, &l, __shfl_xor_sync(0xffffffffu, mx, off),
                      __shfl_xor_sync(0xffffffffu, l, off));
        if (t == 0) {
          red[wn * kBM + rl] = mx;
          red[(4 + wn) * kBM + rl] = l;
        }
      }
    __syncthreads();
    if (threadIdx.x < kBM && m0 + static_cast<int>(threadIdx.x) < M) {
      const int rl = threadIdx.x;
      float mx = red[rl], l = red[4 * kBM + rl];
      for (int w = 1; w < 4; ++w)
        merge_stats(&mx, &l, red[w * kBM + rl], red[(4 + w) * kBM + rl]);
      const size_t at = static_cast<size_t>(blockIdx.y) * M + m0 + rl;
      p.pm[at] = mx;
      p.pl[at] = l;
    }
  } else {
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * kWM + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        float row_lse = 0.f, row_g = 0.f;
        int label = -1;
        if constexpr (EPI == kEpiDlogits) {
          row_lse = p.lse[row];
          row_g = p.g[row];
          label = p.labels[row];
        }
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + wn * kWN + ni * 8 + 2 * t + e;
            if (col >= Nc) continue;
            const float s = acc[mi][ni][2 * h + e];
            if constexpr (EPI == kEpiDlogits) {
              const float onehot = p.col0 + col == label ? 1.f : 0.f;
              from_f32((expf(s - row_lse) - onehot) * row_g,
                       p.dl + static_cast<long long>(row) * p.ldd + col);
            } else if constexpr (EPI == kEpiAccum) {
              const long long at = static_cast<long long>(row) * p.ldo + col;
              const float v = p.first ? s : p.acc[at] + s;
              if (p.last)
                from_f32(v, p.out + at);
              else
                p.acc[at] = v;
            } else {
              p.dw[static_cast<long long>(row) * p.ldw + col] = s;
            }
          }
      }
  }
}

// lse per row from the forward's per-tile (max, sum of exp) pairs,
// merged in tile order: m + log(max(l, 1e-30)), as the TPU kernel ends.
__global__ void ce_lse_kernel(const float* __restrict__ pm,
                              const float* __restrict__ pl, int n_tiles,
                              int N, float* __restrict__ lse) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float mx = kNegBig;
  for (int i = 0; i < n_tiles; ++i)
    mx = fmaxf(mx, pm[static_cast<size_t>(i) * N + row]);
  float l = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const size_t at = static_cast<size_t>(i) * N + row;
    l += pl[at] * expf(pm[at] - mx);
  }
  lse[row] = mx + logf(fmaxf(l, 1e-30f));
}

template <typename T>
Operand<T> operand(const void* base, long long sr, long long sk, int rows,
                   bool kcontig) {
  Operand<T> op;
  op.base = static_cast<const T*>(base);
  op.sr = sr;
  op.sk = sk;
  op.rows = rows;
  op.kcontig = kcontig;
  const long long stride = kcontig ? sr : sk;
  op.vec = (reinterpret_cast<uintptr_t>(base) % 16 == 0) &&
           stride % kChunk<T> == 0;
  return op;
}

template <typename T, int EPI>
cudaError_t launch(const Params<T>& p, cudaStream_t stream) {
  const int M = p.a.rows, Nc = p.b.rows;
  if (M <= 0 || Nc <= 0) return cudaSuccess;
  const dim3 grid((M + kBM - 1) / kBM, (Nc + kBN - 1) / kBN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  auto kernel = ce_gemm_kernel<T, EPI>;
  const size_t smem = smem_bytes<T>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, const int32_t* labels,
                float* lse, float* target, float* partial, int N, int D,
                int V, cudaStream_t stream) {
  Params<T> p{};
  p.a = operand<T>(x, D, 1, N, true);   // x [N, D]
  p.b = operand<T>(w, 1, V, V, false);  // (v, k) = w[k, v]
  p.K = D;
  p.labels = labels;
  p.target = target;
  const int n_tiles = (V + kBN - 1) / kBN;
  p.pm = partial;
  p.pl = partial + static_cast<size_t>(n_tiles) * N;
  cudaError_t err = launch<T, kEpiStats>(p, stream);
  if (err != cudaSuccess) return err;
  ce_lse_kernel<<<(N + 255) / 256, 256, 0, stream>>>(p.pm, p.pl, n_tiles, N,
                                                      lse);
  return cudaGetLastError();
}

// The dlogits of vocabulary columns [c0, c0 + cw) into dl [N, chunk_v].
template <typename T>
cudaError_t dlogits(const void* x, const void* w, const int32_t* labels,
                    const float* lse, const float* g, T* dl, int N, int D,
                    int V, int c0, int cw, int chunk_v, cudaStream_t stream) {
  Params<T> p{};
  p.a = operand<T>(x, D, 1, N, true);
  p.b = operand<T>(static_cast<const T*>(w) + c0, 1, V, cw, false);
  p.K = D;
  p.col0 = c0;
  p.labels = labels;
  p.lse = lse;
  p.g = g;
  p.dl = dl;
  p.ldd = chunk_v;
  return launch<T, kEpiDlogits>(p, stream);
}

template <typename T>
cudaError_t dx_chunks(const void* x, const void* w, const int32_t* labels,
                      const float* lse, const float* g, void* scratch,
                      float* acc, void* dx, int N, int D, int V, int chunk_v,
                      cudaStream_t stream) {
  T* dl = static_cast<T*>(scratch);
  float* sum = acc != nullptr ? acc : static_cast<float*>(dx);  // f32: dx
  for (int c0 = 0; c0 < V; c0 += chunk_v) {
    const int cw = min(chunk_v, V - c0);
    cudaError_t err =
        dlogits<T>(x, w, labels, lse, g, dl, N, D, V, c0, cw, chunk_v, stream);
    if (err != cudaSuccess) return err;
    Params<T> p{};
    p.a = operand<T>(dl, chunk_v, 1, N, true);  // dlogits [N, cw]
    // (d, v) = w[d, c0 + v]: w_chunk^T as [D][cw], k contiguous.
    p.b = operand<T>(static_cast<const T*>(w) + c0, V, 1, D, true);
    p.K = cw;
    p.acc = sum;
    p.out = static_cast<T*>(dx);
    p.ldo = D;
    p.first = c0 == 0;
    p.last = c0 + cw >= V;
    err = launch<T, kEpiAccum>(p, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dw_chunks(const void* x, const void* w, const int32_t* labels,
                      const float* lse, const float* g, void* scratch,
                      float* dw, int N, int D, int V, int chunk_v,
                      cudaStream_t stream) {
  T* dl = static_cast<T*>(scratch);
  for (int c0 = 0; c0 < V; c0 += chunk_v) {
    const int cw = min(chunk_v, V - c0);
    cudaError_t err =
        dlogits<T>(x, w, labels, lse, g, dl, N, D, V, c0, cw, chunk_v, stream);
    if (err != cudaSuccess) return err;
    Params<T> p{};
    p.a = operand<T>(x, 1, D, D, false);         // (d, n) = x[n, d]
    p.b = operand<T>(dl, 1, chunk_v, cw, false);  // (v, n) = dl[n, v]
    p.K = N;
    p.dw = dw + c0;
    p.ldw = V;
    err = launch<T, kEpiStore>(p, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The wgmma route: bf16 operands through TMA, wgmma and mbarriers.

namespace tc {

constexpr int kBM = 128;        // tile rows: 64 for each consumer warpgroup
constexpr int kBK = 64;         // K per stage: 64 bf16, one 128-byte row
constexpr int kStages = 4;      // the shared-memory ring
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kAtom = 64 * 64;  // elements of one 64 x 64 TMA box (8 KiB)
constexpr float kLog2e = 1.4426950408889634f;

template <int BN>
constexpr int kStageElems = (kBM + BN) * kBK;

// The ring, its 2 kStages mbarriers, and 1 KiB to align the ring to the
// 128-byte swizzle's 1024-byte period.
template <int BN>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kStages) * kStageElems<BN> * 2 +
         2 * kStages * sizeof(uint64_t) + 1024;
}

// C [M, N] = A [M, K] @ B [K, N] and what the epilogue does with it.
// Output (row, col) is vocabulary column col0 + col where that applies.
struct Params {
  int M, N, K;
  int bn_off, bk_off;  // B's tensor-map coordinates of its (n 0, k 0)
  int col0;
  int n_fastest;       // tile order: neighbouring blocks share A (else B)
  const int32_t* labels;
  const float* lse;
  const float* g;
  float* pm;  // stats: [tiles along N][M] maxima
  float* pl;  // stats: [tiles along N][M] sums of exp
  float* target;
  __nv_bfloat16* dl;  // dlogits: [M][ldd]
  int ldd;
  float* acc;  // accum: f32 running sum [M][ldo]
  __nv_bfloat16* out;  // accum: output at the last chunk
  int ldo, first, last;
  float* dw;  // store: [M][ldw]
  int ldw;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of this parity.  A
// pipeline that stops making progress traps after ten seconds, so a
// fault shows as a failed launch instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// A 2-D box of `map` at coordinates (c0 inner, c1 outer) into shared
// memory, completing on `bar`.  Elements past the tensor are zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: rows
// of 128 bytes, 8-row groups 1024 bytes apart (the stride byte offset);
// `lbo` bytes between 64-element groups along M or N (MN-major only).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d [64 x 128] += A [64 x 16] @ B [16 x 128], bf16 from shared memory, f32
// in registers: thread (warp w, lane 4 g + q) holds d[4 j + 2 h + e] =
// (row 16 w + g + 8 h, column 8 j + 2 q + e).  TA / TB: the operand is
// MN-major (its M or N axis contiguous) rather than K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Merge two (max, sum of exp) pairs.
__device__ __forceinline__ void merge_stats2(float* m, float* l, float om,
                                             float ol) {
  const float nm = fmaxf(*m, om);
  *l = *l * ex2((*m - nm) * kLog2e) + ol * ex2((om - nm) * kLog2e);
  *m = nm;
}

// The epilogue of one thread: rows r and r + 8 of the tile (r = 16 warp
// + g within its warpgroup's 64), columns 128 h + 8 j + 2 q + e.
template <int EPI, int BN>
__device__ __forceinline__ void epilogue(const Params& p,
                                         float (&acc)[BN / 128][64], int r0,
                                         int n0, int q) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if constexpr (EPI == kEpiStats) {
      // Rows past M still take part in the quad's shuffles.
      const int label = row < p.M ? p.labels[row] : -1;
      float mx = kNegBig, l = 0.f;
#pragma unroll
      for (int h = 0; h < BN / 128; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n0 + 128 * h + 8 * j + 2 * q + e < p.N)
              mx = fmaxf(mx, acc[h][4 * j + 2 * hr + e]);
      const float nm = -mx * kLog2e;
#pragma unroll
      for (int h = 0; h < BN / 128; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + 128 * h + 8 * j + 2 * q + e;
            if (col >= p.N) continue;
            const float s = acc[h][4 * j + 2 * hr + e];
            l += ex2(fmaf(s, kLog2e, nm));
            if (p.col0 + col == label) p.target[row] = s;
          }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        merge_stats2(&mx, &l, __shfl_xor_sync(0xffffffffu, mx, off),
                     __shfl_xor_sync(0xffffffffu, l, off));
      if (q == 0 && row < p.M) {
        const size_t at = static_cast<size_t>(n0 / BN) * p.M + row;
        p.pm[at] = mx;
        p.pl[at] = l;
      }
    } else {
      if (row >= p.M) continue;
      float nl = 0.f, gr = 0.f;
      int label = -1;
      if constexpr (EPI == kEpiDlogits) {
        nl = -p.lse[row] * kLog2e;
        gr = p.g[row];
        label = p.labels[row];
      }
#pragma unroll
      for (int h = 0; h < BN / 128; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          // N is a multiple of 8 on this route: both columns or neither.
          const int col = n0 + 128 * h + 8 * j + 2 * q;
          if (col >= p.N) continue;
          const float s0 = acc[h][4 * j + 2 * hr];
          const float s1 = acc[h][4 * j + 2 * hr + 1];
          if constexpr (EPI == kEpiDlogits) {
            const int v = p.col0 + col;
            const float d0 = (ex2(fmaf(s0, kLog2e, nl)) -
                              (v == label ? 1.f : 0.f)) * gr;
            const float d1 = (ex2(fmaf(s1, kLog2e, nl)) -
                              (v + 1 == label ? 1.f : 0.f)) * gr;
            *reinterpret_cast<__nv_bfloat162*>(
                p.dl + static_cast<size_t>(row) * p.ldd + col) =
                __floats2bfloat162_rn(d0, d1);
          } else if constexpr (EPI == kEpiAccum) {
            const size_t at = static_cast<size_t>(row) * p.ldo + col;
            float2 v = make_float2(s0, s1);
            if (!p.first) {
              const float2 o = *reinterpret_cast<const float2*>(p.acc + at);
              v.x = o.x + s0;
              v.y = o.y + s1;
            }
            if (p.last)
              *reinterpret_cast<__nv_bfloat162*>(p.out + at) =
                  __floats2bfloat162_rn(v.x, v.y);
            else
              *reinterpret_cast<float2*>(p.acc + at) = v;
          } else {
            *reinterpret_cast<float2*>(
                p.dw + static_cast<size_t>(row) * p.ldw + col) =
                make_float2(s0, s1);
          }
        }
    }
  }
}

// One persistent block an SM.  Warpgroup 0 is the producer (thread 0
// issues every TMA load), warpgroups 1 and 2 the consumers.  A_MN / B_MN:
// A [M, K] or B [K, N] lies MN-major in memory (its M or N axis
// contiguous), loaded as 64 x 64 boxes; a K-major operand is one box of
// its rows by 64.  Either way a consumer's 64 rows of A start kAtom
// elements apart and B's 128-column halves 128 x 64 elements apart.
template <bool A_MN, bool B_MN, int EPI, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    ce_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageElems<BN>);
  uint64_t* empty = full + kStages;
  const int tiles_m = (p.M + kBM - 1) / kBM;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int n_tiles = tiles_m * tiles_n;
  const int nk = (p.K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int tm = p.n_fastest ? tile / tiles_n : tile % tiles_m;
        const int tn = p.n_fastest ? tile % tiles_n : tile / tiles_m;
        const int m0 = tm * kBM, n0 = tn * BN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          __nv_bfloat16* sa = ring + stage * kStageElems<BN>;
          __nv_bfloat16* sb = sa + kBM * kBK;
          uint64_t* bar = &full[stage];
          mbar_expect_tx(bar, kStageElems<BN> * 2);
          const int k0 = kt * kBK;
          if constexpr (A_MN) {
            tma_load(sa, &map_a, bar, m0, k0);
            tma_load(sa + kAtom, &map_a, bar, m0 + 64, k0);
          } else {
            tma_load(sa, &map_a, bar, k0, m0);
          }
          if constexpr (B_MN) {
#pragma unroll
            for (int i = 0; i < BN / 64; ++i)
              tma_load(sb + i * kAtom, &map_b, bar, p.bn_off + n0 + 64 * i,
                       p.bk_off + k0);
          } else {
            tma_load(sb, &map_b, bar, p.bk_off + k0, p.bn_off + n0);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cg = threadIdx.x / 128 - 1;  // consumer warpgroup: rows 64 cg
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    constexpr uint32_t kLboA = A_MN ? kAtom * 2 : 16;
    constexpr uint32_t kLboB = B_MN ? kAtom * 2 : 16;
    // Elements between K steps of 16: 32 bytes along a K-major row, 16
    // rows of 128 bytes MN-major.
    constexpr int kStepA = A_MN ? 16 * 64 : 16;
    constexpr int kStepB = B_MN ? 16 * 64 : 16;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int tm = p.n_fastest ? tile / tiles_n : tile % tiles_m;
      const int tn = p.n_fastest ? tile % tiles_n : tile / tiles_m;
      float acc[BN / 128][64];
#pragma unroll
      for (int h = 0; h < BN / 128; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const __nv_bfloat16* sa = ring + stage * kStageElems<BN> + cg * kAtom;
        const __nv_bfloat16* sb = ring + stage * kStageElems<BN> + kBM * kBK;
#pragma unroll
        for (int h = 0; h < BN / 128; ++h) fence_regs(acc[h]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          const uint64_t da = sw128_desc(sa + j * kStepA, kLboA);
#pragma unroll
          for (int h = 0; h < BN / 128; ++h)
            wgmma_m64n128<A_MN, B_MN>(
                acc[h], da, sw128_desc(sb + h * 128 * kBK + j * kStepB, kLboB));
        }
        wgmma_commit();
#pragma unroll
        for (int h = 0; h < BN / 128; ++h) fence_regs(acc[h]);
        if (prev >= 0) {  // the previous step's products are done
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < BN / 128; ++h) fence_regs(acc[h]);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      epilogue<EPI, BN>(p, acc, tm * kBM + 64 * cg + 16 * warp + lane / 4,
                        tn * BN, lane % 4);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is
// reached through the runtime's entry-point query, so the library links
// no libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A bf16 matrix of `outer` rows of `inner` elements, rows `ld` elements
// apart, read in boxes of box_outer rows by box_inner (<= 64) elements
// with the 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* base, int inner, int outer,
              long long ld, int box_inner, int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <bool A_MN, bool B_MN, int EPI, int BN>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
                   const Params& p, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0) return cudaSuccess;
  const int tiles = ((p.M + kBM - 1) / kBM) * ((p.N + BN - 1) / BN);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  auto kernel = ce_tc_kernel<A_MN, B_MN, EPI, BN>;
  constexpr size_t smem = smem_bytes<BN>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<tiles < sms ? tiles : sms, kThreads, smem, stream>>>(map_a, map_b,
                                                                p);
  return cudaGetLastError();
}

// Tile widths: BN = 256 where the product's N is the vocabulary (or a
// chunk of it); 128 for dx, whose N = D = 1536 would give 256-wide
// tiles 1.45 waves of the card at N = 4096 rows.
constexpr int kBnVocab = 256;
constexpr int kBnDx = 128;

bool tc_geometry(int N, int D, int V) {
  return N >= 0 && D > 0 && V > 0 && D % 8 == 0 && V % 8 == 0;
}

cudaError_t fwd(const void* x, const void* w, const int32_t* labels,
                float* lse, float* target, float* partial, int N, int D,
                int V, cudaStream_t stream) {
  CUtensorMap ma, mb;
  if (!make_map(&ma, x, D, N, D, 64, kBM) ||  // x [N, D]: K-major A
      !make_map(&mb, w, V, D, V, 64, 64))     // w [D, V]: MN-major B
    return cudaErrorInvalidValue;
  const int n_tiles = (V + kBnVocab - 1) / kBnVocab;
  Params p{};
  p.M = N;
  p.N = V;
  p.K = D;
  p.labels = labels;
  p.target = target;
  p.pm = partial;
  p.pl = partial + static_cast<size_t>(n_tiles) * N;
  cudaError_t err =
      launch<false, true, kEpiStats, kBnVocab>(ma, mb, p, stream);
  if (err != cudaSuccess) return err;
  ce_lse_kernel<<<(N + 255) / 256, 256, 0, stream>>>(p.pm, p.pl, n_tiles, N,
                                                      lse);
  return cudaGetLastError();
}

// Per chunk of the vocabulary: the dlogits once, then the dx product
// (when dx is not null) and the dw product (when dw is not null).
cudaError_t bwd(const void* x, const void* w, const int32_t* labels,
                const float* lse, const float* g, __nv_bfloat16* dl,
                float* acc, void* dx, float* dw, int N, int D, int V,
                int chunk_v, cudaStream_t stream) {
  CUtensorMap x_k, w_mn, x_mn, w_k;
  if (!make_map(&x_k, x, D, N, D, 64, kBM) ||    // dlogits A: x
      !make_map(&w_mn, w, V, D, V, 64, 64) ||    // dlogits B: w
      (dw != nullptr && !make_map(&x_mn, x, D, N, D, 64, 64)) ||  // dw A
      (dx != nullptr && !make_map(&w_k, w, V, D, V, 64, kBnDx)))  // dx B
    return cudaErrorInvalidValue;
  for (int c0 = 0; c0 < V; c0 += chunk_v) {
    const int cw = min(chunk_v, V - c0);
    Params p{};
    p.M = N;
    p.N = cw;
    p.K = D;
    p.bn_off = c0;
    p.col0 = c0;
    p.labels = labels;
    p.lse = lse;
    p.g = g;
    p.dl = dl;
    p.ldd = chunk_v;
    cudaError_t err =
        launch<false, true, kEpiDlogits, kBnVocab>(x_k, w_mn, p, stream);
    if (err != cudaSuccess) return err;
    if (dx != nullptr) {
      // (n, v) = dl[n, v] K-major; (v, d) = w[d, c0 + v] K-major.  The
      // map ends at cw, so a ragged last step reads zeros, not the
      // previous chunk's columns.
      CUtensorMap dl_k;
      if (!make_map(&dl_k, dl, cw, N, chunk_v, 64, kBM))
        return cudaErrorInvalidValue;
      Params q{};
      q.M = N;
      q.N = D;
      q.K = cw;
      q.bk_off = c0;
      q.n_fastest = 1;  // a row band of dlogits feeds D / 128 tiles
      q.acc = acc;
      q.out = static_cast<__nv_bfloat16*>(dx);
      q.ldo = D;
      q.first = c0 == 0;
      q.last = c0 + cw >= V;
      err = launch<false, false, kEpiAccum, kBnDx>(dl_k, w_k, q, stream);
      if (err != cudaSuccess) return err;
    }
    if (dw != nullptr) {
      // (d, n) = x[n, d] MN-major; (n, v) = dl[n, v] MN-major.
      CUtensorMap dl_mn;
      if (!make_map(&dl_mn, dl, cw, N, chunk_v, 64, 64))
        return cudaErrorInvalidValue;
      Params q{};
      q.M = D;
      q.N = cw;
      q.K = N;
      q.dw = dw + c0;
      q.ldw = V;
      err = launch<true, true, kEpiStore, kBnVocab>(x_mn, dl_mn, q, stream);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace tc

// Call f((T*)nullptr) for the dtype the kernels are instantiated for.
template <typename F>
cudaError_t by_dtype(int dtype, F f) {
  if (dtype == kOimF32) return f(static_cast<float*>(nullptr));
  if (dtype == kOimBF16) return f(static_cast<__nv_bfloat16*>(nullptr));
  return cudaErrorInvalidValue;
}

bool valid_geometry(int N, int D, int V) { return N >= 0 && D > 0 && V > 0; }

bool valid_chunk(int chunk_v) { return chunk_v > 0 && chunk_v % kBN == 0; }

}  // namespace

extern "C" int oim_fused_ce_fwd(const void* x, const void* w, int dtype,
                                const int32_t* labels, float* lse,
                                float* target, float* partial, int N, int D,
                                int V, void* stream) {
  if (!valid_geometry(N, D, V)) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto* dt) {
    using T = std::remove_pointer_t<decltype(dt)>;
    return fwd<T>(x, w, labels, lse, target, partial, N, D, V, s);
  });
}

extern "C" int oim_fused_ce_dx(const void* x, const void* w, int dtype,
                               const int32_t* labels, const float* lse,
                               const float* g, void* dlogits, float* acc,
                               void* dx, int N, int D, int V, int chunk_v,
                               void* stream) {
  if (!valid_geometry(N, D, V) || !valid_chunk(chunk_v))
    return cudaErrorInvalidValue;
  if (dtype != kOimF32 && acc == nullptr) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto* dt) {
    using T = std::remove_pointer_t<decltype(dt)>;
    return dx_chunks<T>(x, w, labels, lse, g, dlogits, acc, dx, N, D, V,
                        chunk_v, s);
  });
}

extern "C" int oim_fused_ce_dw(const void* x, const void* w, int dtype,
                               const int32_t* labels, const float* lse,
                               const float* g, void* dlogits, float* dw,
                               int N, int D, int V, int chunk_v,
                               void* stream) {
  if (!valid_geometry(N, D, V) || !valid_chunk(chunk_v))
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto* dt) {
    using T = std::remove_pointer_t<decltype(dt)>;
    return dw_chunks<T>(x, w, labels, lse, g, dlogits, dw, N, D, V, chunk_v,
                        s);
  });
}

extern "C" int oim_fused_ce_tc_fwd(const void* x, const void* w,
                                   const int32_t* labels, float* lse,
                                   float* target, float* partial, int N,
                                   int D, int V, void* stream) {
  if (!tc::tc_geometry(N, D, V)) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  return tc::fwd(x, w, labels, lse, target, partial, N, D, V,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int oim_fused_ce_tc_bwd(const void* x, const void* w,
                                   const int32_t* labels, const float* lse,
                                   const float* g, void* dlogits, float* acc,
                                   void* dx, float* dw, int N, int D, int V,
                                   int chunk_v, void* stream) {
  if (!tc::tc_geometry(N, D, V) || !valid_chunk(chunk_v) ||
      (dx == nullptr && dw == nullptr) || (dx != nullptr && acc == nullptr))
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  return tc::bwd(x, w, labels, lse, g, static_cast<__nv_bfloat16*>(dlogits),
                 acc, dx, dw, N, D, V, chunk_v,
                 static_cast<cudaStream_t>(stream));
}
