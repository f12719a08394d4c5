// GCN message passing, Y[n, :] = sum over the in-edges e of n of
// coeff[e] * X[col[e], :], for Hopper (sm_90a), in float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_mm/kernel.py
// (_segment_mm_kernel, line 30; entry segment_mm_pallas). The TPU kernel
// took destination-sorted blocks of 512 edges with X[src] gathered ahead of
// it by XLA, and summed each block into a 256-row node tile as a one-hot
// matrix product on the MXU. Here the layout is a CSR over destinations
// (edges sorted by (dst, src), ops.py): row_ptr int64 [N + 1], col int32
// [E] (the sorted sources), coeff float32 [E] in the same order, and x
// float32 [N_src, D]; the output y is float32 [N, D], every row written
// (0 where a row has no in-edge). There is no one-hot matrix and no staged
// X[src]: the kernel gathers x[col[e], :] itself (at ogb_products, layer 1,
// a staged X[src] would be 3.96 GB).
//
// Design (simple and right first; not tuned):
//   * One warp per destination row. Lanes cover the features: for D <= 32
//     the next power of two P >= D lanes per edge, so G = 32 / P edges are
//     in flight per warp step (lane = g * P + f); for D > 32, P = 32, G = 1
//     and each lane covers features f, f + 32, ... (NF <= 8 of them, so
//     D <= 256). The warp loads 32 (col, coeff) pairs at a time, coalesced,
//     and hands them round by __shfl_sync; the P steps of a tile are
//     unrolled so the gathers of x are in flight together. Edge group g
//     sums edges g, g + G, g + 2G, ... of the row in order (float32 FMA);
//     the G group sums are then added by a fixed xor-shuffle tree.
//   * Long rows are split. A row with more than `chunk` in-edges (1,024 by
//     default; at ogb_products 372 rows, the largest 39,485) is not a
//     warp's job: one block of 16 warps takes it, warp w summing chunks
//     w, w + 16, w + 32, ... of `chunk` edges in order, and the 16 warp
//     sums are added in warp order through shared memory. So no warp walks
//     more than ceil(K / (16 chunk)) chunks (3 at the hub, not 39), and
//     there are no float atomics. The long-row blocks come first in the
//     grid, so the longest jobs start first. The rows that are long are
//     listed by the layout (long_rows); a row warp skips a row longer than
//     `chunk`.
//   * Deterministic: every sum has one fixed order, so two launches on the
//     same inputs give the same bits.
//   * Offsets into x and y are 64-bit (E * D reaches 7.9e9 at ogb_products
//     with D = 128).
//
// Bound (chip_smoke.py computes it from the run's inputs): bytes. The
// compulsory bytes, each input read once and y written once, are
// 8 (N + 1) + 8 E + 4 D (N_src + N): 0.828 GB at ogb_products with
// D = 16, 0.247 ms at 3.35 TB/s. A gather reads x once per edge unless
// the row is still in L2 (50 MB; x is 157 MB there, and the sources are
// skewed toward low ids): 4.63 GB, 1.38 ms, if nothing hits. The
// arithmetic, 2 E D flops, is far below either. TMA or cp.async staging of
// col and coeff and L2 residency hints for the hot rows of x are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;             // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;             // NF = 8 feature chunks of 32
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const long long* row_ptr;  // [n_rows + 1]
  const int* col;            // [E]
  const float* coeff;        // [E]
  const float* x;            // [N_src, D]
  const int* long_rows;      // [n_long]
  float* y;                  // [n_rows, D]
  long long n_rows;
  long long chunk;
  int n_long;
  int D;
};

// Adds coeff[e] * x[col[e], :] for e in [lo, hi) into this lane's
// accumulators, edge group g taking edges lo + g, lo + g + G, ... in order.
// [lo, hi) is the same for every lane of the warp.
template <int P, int NF>
__device__ __forceinline__ void accumulate(const Params& p, long long lo,
                                           long long hi, int lane,
                                           float (&acc)[NF]) {
  constexpr int G = 32 / P;
  const int g = lane / P;
  const int f0 = lane % P;
  const int D = p.D;
  for (long long base = lo; base < hi; base += 32) {
    const long long left = hi - base;
    const int cnt = left < 32 ? static_cast<int>(left) : 32;
    int my_c = 0;
    float my_w = 0.f;
    if (lane < cnt) {
      my_c = __ldg(p.col + base + lane);
      my_w = __ldg(p.coeff + base + lane);
    }
#pragma unroll
    for (int s = 0; s < P; ++s) {  // P steps of G edges cover the 32
      const int j = s * G + g;
      const int c = __shfl_sync(kFull, my_c, j);
      const float w = __shfl_sync(kFull, my_w, j);
      if (j < cnt) {
        const float* xr = p.x + static_cast<long long>(c) * D;
#pragma unroll
        for (int k = 0; k < NF; ++k) {
          const int f = k * 32 + f0;
          if (f < D) acc[k] = fmaf(w, __ldg(xr + f), acc[k]);
        }
      }
    }
  }
}

// Adds the G edge groups' sums by a fixed xor tree: every lane ends with
// the same bits (each level adds the same two values, in either order).
template <int P, int NF>
__device__ __forceinline__ void reduce_groups(float (&acc)[NF]) {
#pragma unroll
  for (int off = 16; off >= P; off >>= 1)
#pragma unroll
    for (int k = 0; k < NF; ++k)
      acc[k] += __shfl_xor_sync(kFull, acc[k], off);
}

template <int P, int NF>
__global__ void __launch_bounds__(kThreads) segment_mm_kernel(Params p) {
  __shared__ float part[kWarps][kMaxD];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int f0 = lane % P;
  const int D = p.D;
  float acc[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k] = 0.f;

  if (static_cast<int>(blockIdx.x) < p.n_long) {
    // a long row: the block's warps take its chunks in turn
    const long long r = p.long_rows[blockIdx.x];
    const long long lo = p.row_ptr[r], hi = p.row_ptr[r + 1];
    const long long stride = static_cast<long long>(kWarps) * p.chunk;
    for (long long c0 = lo + warp * p.chunk; c0 < hi; c0 += stride) {
      const long long c1 = c0 + p.chunk < hi ? c0 + p.chunk : hi;
      accumulate<P, NF>(p, c0, c1, lane, acc);
    }
    reduce_groups<P, NF>(acc);
    if (lane < P) {
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const int f = k * 32 + f0;
        if (f < D) part[warp][f] = acc[k];
      }
    }
    __syncthreads();
    for (int f = threadIdx.x; f < D; f += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][f];
      p.y[r * D + f] = s;
    }
    return;
  }

  const long long row =
      static_cast<long long>(blockIdx.x - p.n_long) * kWarps + warp;
  if (row >= p.n_rows) return;
  const long long lo = p.row_ptr[row], hi = p.row_ptr[row + 1];
  if (hi - lo > p.chunk) return;  // a long row: its own block writes it
  accumulate<P, NF>(p, lo, hi, lane, acc);
  reduce_groups<P, NF>(acc);
  if (lane < P) {
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const int f = k * 32 + f0;
      if (f < D) p.y[row * D + f] = acc[k];
    }
  }
}

template <int P, int NF>
cudaError_t launch(const Params& p, unsigned blocks, cudaStream_t stream) {
  segment_mm_kernel<P, NF><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// row_ptr int64 [n_rows + 1], col int32 [E], coeff float32 [E], x float32
// [N_src, D] (contiguous), long_rows int32 [n_long] (the rows with more
// than `chunk` in-edges, each once), y float32 [n_rows, D]: all on one
// device. Requires 1 <= D <= 256 and chunk >= 1 (the wrapper, kernel.py,
// checks shapes, types and devices first). Launches on `stream` without
// synchronising and returns the CUDA error of the launch (0 on success;
// n_rows = 0 launches nothing).
extern "C" int segment_mm_launch(const long long* row_ptr, const int* col,
                                 const float* coeff, const float* x,
                                 const int* long_rows, float* y,
                                 long long n_rows, long long chunk,
                                 int n_long, int D, void* stream_ptr) {
  if (n_rows == 0) return 0;
  if (D < 1 || D > kMaxD || chunk < 1 || n_long < 0 || n_long > n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = n_long + (n_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.row_ptr = row_ptr;
  p.col = col;
  p.coeff = coeff;
  p.x = x;
  p.long_rows = long_rows;
  p.y = y;
  p.n_rows = n_rows;
  p.chunk = chunk;
  p.n_long = n_long;
  p.D = D;
  const unsigned nb = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (D == 1) err = launch<1, 1>(p, nb, s);
  else if (D <= 2) err = launch<2, 1>(p, nb, s);
  else if (D <= 4) err = launch<4, 1>(p, nb, s);
  else if (D <= 8) err = launch<8, 1>(p, nb, s);
  else if (D <= 16) err = launch<16, 1>(p, nb, s);
  else if (D <= 32) err = launch<32, 1>(p, nb, s);
  else if (D <= 64) err = launch<32, 2>(p, nb, s);
  else if (D <= 128) err = launch<32, 4>(p, nb, s);
  else err = launch<32, 8>(p, nb, s);
  return static_cast<int>(err);
}
