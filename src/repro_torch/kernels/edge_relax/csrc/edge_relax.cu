// Fused Δ-growing relaxation superstep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_relax/kernel.py
// (_relax_kernel, line 78; entry edge_relax_pallas). It computes the same
// function: per in-edge of a destination, the live/relay candidate rule of
// kernel.py:95-105 (ref.py:40-48), and per destination the lexicographic
// (d, c, pathw) tuple-min of kernel.py:108-133, INF where a node has no
// candidate.
//
// Layout: a destination-sorted CSR, edges ordered by (dst, src): row_ptr
// int32 [n+1], src int32 [E], w int32 [E], and long_rows int32 [L], the
// rows with more than kLongRow (1,024) in-edges, longest first (ops.py
// builds it on the device with the CSR). No padding edges and no mask. The TPU
// kernel took six pre-gathered [n_blocks, 512] source planes materialised
// in HBM; here the lanes gather what they need at src[e] themselves.
//
// Design: edge-parallel rows (relax_scan.cuh), two launches on the stream.
//   * pack_planes packs the six planes into one (d, rw0, c, pathw) int4
//     and one (rc, rp) int2 per node, so that an edge's candidate costs one
//     gather (two for a relay edge): with six separate planes every gathered
//     value cost a 32-byte sector of its own.
//   * Short rows (<= kLongRow edges): a group of G lanes (4, 8, 16 or 32:
//     the least with 4 G >= the mean in-degree, each lane taking 4 edges a
//     step) takes one row. Its lanes read consecutive edges, so the src and
//     w loads coalesce and up to 4 G gathers of the row are in flight; the
//     group's partial tuples meet in an xor-shuffle tree.
//   * Long rows: one block of 256 threads per row, the long-row blocks
//     first in the grid so the longest jobs start first. The block's
//     partials meet through shared memory. No atomics. At the 39,514-edge
//     hub of RMAT social_like(20) a thread scans about 155 edges instead of
//     one thread scanning all of them.
//   * Deterministic: the tuple-min is exact, so any split gives the plain
//     version's bits, and two launches give the same bits.
//
// Bound (bytes over 3.35 TB/s; chip_smoke.py's relax_bytes is the one
// definition): one superstep must read the CSR (4(n+1) + 8E bytes), d and
// rw0 (8n), c and pathw of each source with an admissible live edge and rc
// and rp of each source with an admissible relay edge (8 bytes per such
// source), and write three planes (12n). With no admissible edge that is
// 4(n+1) + 8E + 20n, 136 MB at the n = 1,890,815 road graph (E =
// 11,344,878), 41 us. What holds the kernel above it is the gathers: the
// road graph numbers its nodes at random, so a row's sources are scattered
// over the records (30 MB of int4), and each gather moves a 32-byte sector
// for the 16 bytes it uses, from L2 at best; the packing pass adds 72 bytes
// a node.

#include <cuda_runtime.h>
#include <stdint.h>

#include "relax_scan.cuh"

namespace {

using relax::kBlock;
using relax::Tuple;

struct RelaxArgs {
  const int32_t* row_ptr;
  const int32_t* src;
  const int32_t* w;
  const int32_t* long_rows;
  relax::Planes s;   // packed by pack_planes first
  int32_t* d_out;
  int32_t* c_out;
  int32_t* p_out;
  int32_t delta, n, n_long;
};

// The six node planes packed into (d, rw0, c, pathw) and (rc, rp).
__global__ void __launch_bounds__(kBlock)
pack_planes(const int32_t* __restrict__ d, const int32_t* __restrict__ c,
            const int32_t* __restrict__ p, const int32_t* __restrict__ rw0,
            const int32_t* __restrict__ rc, const int32_t* __restrict__ rp,
            int32_t n, int4* __restrict__ dc, int2* __restrict__ rr) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (v >= n) return;
  dc[v] = make_int4(d[v], rw0[v], c[v], p[v]);
  rr[v] = make_int2(rc[v], rp[v]);
}

__device__ __forceinline__ void store(const RelaxArgs& a, int32_t v,
                                      const Tuple& t) {
  a.d_out[v] = t.d;
  a.c_out[v] = t.c;
  a.p_out[v] = t.p;
}

template <int G>
__global__ void __launch_bounds__(kBlock) edge_relax_kernel(const RelaxArgs a) {
  __shared__ Tuple sh[relax::kWarps];
  if (static_cast<int>(blockIdx.x) < a.n_long) {
    // a long row: the whole block scans it
    const int32_t v = a.long_rows[blockIdx.x];
    Tuple t = relax::none();
    relax::scan_row<false>(a.src, a.w, a.s, a.delta,
                           static_cast<int64_t>(__ldg(a.row_ptr + v)) +
                               threadIdx.x,
                           __ldg(a.row_ptr + v + 1), kBlock, t);
    t = relax::block_min(t, sh);
    if (threadIdx.x == 0) store(a, v, t);
    return;
  }
  // short rows: G lanes per row; every lane reaches the shuffles
  const int64_t slot =
      static_cast<int64_t>(blockIdx.x - a.n_long) * kBlock + threadIdx.x;
  const int64_t v = slot / G;
  const int32_t lane = static_cast<int32_t>(slot % G);
  Tuple t = relax::none();
  bool mine = false;
  if (v < a.n) {
    const int32_t e0 = __ldg(a.row_ptr + v);
    const int32_t e1 = __ldg(a.row_ptr + v + 1);
    mine = e1 - e0 <= relax::kLongRow;   // else its own block writes it
    if (mine) relax::scan_row<false>(a.src, a.w, a.s, a.delta, e0 + lane, e1,
                                     G, t);
  }
  relax::group_min<G>(t);
  if (mine && lane == 0) store(a, static_cast<int32_t>(v), t);
}

template <int G>
cudaError_t launch(const RelaxArgs& a, cudaStream_t stream) {
  const long long rows_per_block = kBlock / G;
  const long long blocks =
      a.n_long + (a.n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  edge_relax_kernel<G><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. row_ptr int32 [n+1], src and w
// int32 [n_edges], the six planes int32 [n], long_rows int32 [n_long] (each
// row with more than kLongRow in-edges, once), the three outputs int32 [n],
// and `packed`, int32 [6n] scratch for the packed planes: all on one device
// (the wrapper, kernel.py, checks them). Launches the packing and the relax
// on `stream` and returns the CUDA error of the launches (0 = success; n = 0
// launches nothing).
extern "C" int edge_relax_launch(const void* row_ptr, const void* src,
                                 const void* w, const void* d, const void* c,
                                 const void* p, const void* rw0,
                                 const void* rc, const void* rp,
                                 const void* long_rows, int n_long,
                                 int delta, int n, int n_edges,
                                 void* d_out, void* c_out, void* p_out,
                                 void* packed, void* stream) {
  if (n <= 0) return 0;
  if (n_long < 0 || n_long > n || n_edges < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* dc = static_cast<int4*>(packed);
  int2* rr = reinterpret_cast<int2*>(dc + n);
  pack_planes<<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      static_cast<const int32_t*>(d), static_cast<const int32_t*>(c),
      static_cast<const int32_t*>(p), static_cast<const int32_t*>(rw0),
      static_cast<const int32_t*>(rc), static_cast<const int32_t*>(rp), n,
      dc, rr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  RelaxArgs a;
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.src = static_cast<const int32_t*>(src);
  a.w = static_cast<const int32_t*>(w);
  a.long_rows = static_cast<const int32_t*>(long_rows);
  a.s = relax::Planes{dc, rr};
  a.d_out = static_cast<int32_t*>(d_out);
  a.c_out = static_cast<int32_t*>(c_out);
  a.p_out = static_cast<int32_t*>(p_out);
  a.delta = delta;
  a.n = n;
  a.n_long = n_long;
  switch (relax::lanes_per_row(n_edges, n, relax::kUnroll)) {
    case 4: return static_cast<int>(launch<4>(a, s));
    case 8: return static_cast<int>(launch<8>(a, s));
    case 16: return static_cast<int>(launch<16>(a, s));
    default: return static_cast<int>(launch<32>(a, s));
  }
}
