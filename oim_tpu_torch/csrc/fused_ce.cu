// Fused unembedding + cross-entropy for Hopper (sm_90a), written by hand
// in CUDA C++: the forward (lse and target logit), dx and dw.
//
// oim_fused_ce_fwd replaces oim_tpu/ops/fused_ce.py _fwd_kernel,
// oim_fused_ce_dx _dx_kernel, oim_fused_ce_dw _dw_kernel.  They compute
// what the TPU kernels compute, not block for block:
//
//   - The TPU walks the vocabulary as a sequential grid axis and carries
//     the online (m, l, target) and the f32 dx / dw accumulators in VMEM
//     across it.  A (128-row, 1536) f32 dx accumulator is 768 KiB, and
//     an H100 block has 227 KB of shared memory, so nothing here carries
//     a whole row of D.  Instead every piece is a tiled product on the
//     tensor cores with its own epilogue (ce_gemm_kernel):
//       forward:  one block per (128 rows, 128 vocab columns) of
//                 s = x @ w; its epilogue reduces the tile to a per-row
//                 (max, sum of exp) pair, and ce_lse_kernel combines the
//                 ceil(V / 128) pairs of a row in order into lse.  The
//                 one thread that holds a row's label column writes its
//                 score as the target (no atomics, no masked row-sum).
//       dx, dw:   the vocabulary is cut into chunks of chunk_v columns.
//                 Per chunk, one product recomputes s for the chunk and
//                 writes the dlogits ((exp(s - lse) - onehot) * g,
//                 rounded to the compute dtype: the one definition both
//                 gradients share, as _dlogits_block is on the TPU) to a
//                 scratch [N, chunk_v]; a second product consumes it:
//                 dx += dlogits @ w_chunk^T into an f32 [N, D] sum (the
//                 last chunk writes dx in x's dtype), or
//                 dw[:, chunk] = x^T @ dlogits, written once in f32.
//     Chunks run in order on one stream and each product sums its K axis
//     in order, so every output is deterministic: no float atomics.
//   - Any N, D and V: tiles past an edge are zero-filled and masked, and
//     rows that are not 16-byte multiples are read element by element,
//     so nothing falls back to the materialized-logits path (the TPU's
//     tiling needs N with a power-of-two divisor >= 8 and V with a
//     multiple-of-128 divisor; Qwen's V = 151936 = 128 * 1187 only has
//     128-wide tiles there).
//   - 128-column forward tiles give N = 4096 rows 32 x 1187 blocks for
//     the 132 SMs, so no split of the vocabulary per row is needed.
//
// Bound on this card: operations.  At the training shape (N = 4096,
// D = 1536, V = 151936, bf16) the forward does 2 N D V = 1.9e12
// operations (1.93 ms at 989 TFLOP/s) and dx and dw 4 N D V each (the
// scores again, then the product), against 0.5 GB of w read once.
//
// Design, simple first: warp-level mma.sync m16n8k16 on bf16 tiles with
// f32 accumulators (f32 inputs take a CUDA-core path with the same
// fragment layout), 128 x 128 block tiles, 8 warps of 64 x 32, K steps
// of 32 staged through two shared-memory buffers with the next step's
// global loads held in registers while the tensor cores work.  Left for
// later: wgmma and TMA, ldmatrix, persistent blocks, and keeping the
// scores of a chunk for both gradients (dx and dw each recompute them,
// as the TPU kernels do, so a LoRA step can skip dw entirely).
#include "fused_ce.cuh"

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
