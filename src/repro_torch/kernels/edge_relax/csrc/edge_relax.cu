// Fused Δ-growing relaxation superstep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_relax/kernel.py
// (_relax_kernel, line 78; entry edge_relax_pallas). It computes the same
// function: per in-edge of a destination, the live/relay candidate rule of
// kernel.py:95-105 (ref.py:40-48), and per destination the lexicographic
// (d, c, pathw) tuple-min of kernel.py:108-133, INF where a node has no
// candidate.
//
// Design (right and simple first):
//   * Layout: a destination-sorted CSR, edges ordered by (dst, src):
//     row_ptr int32 [n+1], src int32 [E], w int32 [E]. No padding edges and
//     no mask. The TPU kernel took six pre-gathered [n_blocks, 512] source
//     planes materialised in HBM before the launch; here each thread reads
//     d, c, pathw, rw0, rc, rp at src[e] itself, so nothing is gathered
//     ahead of the launch.
//   * One thread per destination node scans its in-edges and keeps the
//     running lexicographic min in registers. No atomics: the result is
//     deterministic and bit-equal to the plain PyTorch version (three
//     chained scatter_reduce "amin" passes). The TPU kernel's
//     [node_tile, edge_block] match matrix was a VPU trick and is dropped.
//   * c, pathw, rc and rp are read only for an edge whose candidate is
//     admissible, so a superstep with a small frontier reads little more
//     than row_ptr, src, w, d[src] and rw0[src].
//
// Bound (bytes over 3.35 TB/s; chip_smoke.py's relax_bytes is the one
// definition): one superstep must read the CSR (4(n+1) + 8E bytes), d and
// rw0 (8n), c and pathw of each source with an admissible live edge and rc
// and rp of each source with an admissible relay edge (8 bytes per such
// source), and write three planes (12n). With no admissible edge that is
// 4(n+1) + 8E + 20n, 136 MB at the n = 1,890,815 road graph (E =
// 11,344,878), 41 us; the admissible sources add at most 16n (30 MB).
// The source-plane reads are gathers, so the kernel runs below that
// rate; the neighbouring nodes of a road graph are close in id, which keeps
// most gathers in L2.
//
// Known limit: a hub destination (RMAT graphs) is scanned by one thread,
// which load-imbalances its warp. A warp- or block-per-row split for long
// rows is later work.
//
// Overflow: int32 arithmetic exactly as the reference. An admitted live
// source has d_src < delta <= 2^30 and w < delta, so d_src + w fits; the
// relay term clamps rw0 >= BIG to BIG before the add (w <= 2^30 - 1);
// p_safe < 2^30 and w <= 2^30 - 1, so the path add fits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kInf = 0x7fffffff;   // 2^31 - 1
constexpr int32_t kBig = 1 << 30;      // 2^30

__global__ void __launch_bounds__(256)
edge_relax_kernel(const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ w,
                  const int32_t* __restrict__ d,
                  const int32_t* __restrict__ c,
                  const int32_t* __restrict__ p,
                  const int32_t* __restrict__ rw0,
                  const int32_t* __restrict__ rc,
                  const int32_t* __restrict__ rp,
                  int32_t delta, int32_t n,
                  int32_t* __restrict__ d_out,
                  int32_t* __restrict__ c_out,
                  int32_t* __restrict__ p_out) {
  const int32_t v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  int32_t bd = kInf, bc = kInf, bp = kInf;
  const int32_t e0 = row_ptr[v];
  const int32_t e1 = row_ptr[v + 1];
  for (int32_t e = e0; e < e1; ++e) {
    const int32_t u = __ldg(src + e);
    const int32_t we = __ldg(w + e);
    const int32_t ds = __ldg(d + u);
    const int32_t r0 = __ldg(rw0 + u);
    const bool live_ok = (ds < delta) && (we < delta);
    int32_t w_red = we + (r0 >= kBig ? kBig : r0);
    w_red = w_red < 0 ? 0 : w_red;
    const bool relay_ok = (r0 < kBig) && (w_red < delta);
    if (!relay_ok && !live_ok) continue;   // candidate (INF, INF, INF)
    int32_t cd, cc, pb;
    if (relay_ok) {
      cd = w_red;
      cc = __ldg(rc + u);
      pb = __ldg(rp + u);
    } else {
      cd = ds + we;
      cc = __ldg(c + u);
      pb = __ldg(p + u);
    }
    const int32_t cp = (pb >= kBig ? 0 : pb) + we;
    if (cd < bd || (cd == bd && (cc < bc || (cc == bc && cp < bp)))) {
      bd = cd;
      bc = cc;
      bp = cp;
    }
  }
  d_out[v] = bd;
  c_out[v] = bc;
  p_out[v] = bp;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = success); the caller raises on anything else.
extern "C" int edge_relax_launch(const void* row_ptr, const void* src,
                                 const void* w, const void* d, const void* c,
                                 const void* p, const void* rw0,
                                 const void* rc, const void* rp,
                                 int delta, int n, void* d_out, void* c_out,
                                 void* p_out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    edge_relax_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(w), static_cast<const int32_t*>(d),
        static_cast<const int32_t*>(c), static_cast<const int32_t*>(p),
        static_cast<const int32_t*>(rw0), static_cast<const int32_t*>(rc),
        static_cast<const int32_t*>(rp), delta, n,
        static_cast<int32_t*>(d_out), static_cast<int32_t*>(c_out),
        static_cast<int32_t*>(p_out));
  }
  return static_cast<int>(cudaGetLastError());
}
