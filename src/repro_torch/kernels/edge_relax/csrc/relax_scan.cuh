// The edge-parallel row scan shared by edge_relax.cu and megakernel.cu.
//
// A destination row's candidates (the live/relay rule of the reference's
// kernel.py:95-105, ref.py:40-48) are folded into the lexicographic
// (d, c, pathw) tuple-min. That min is associative, commutative and exact
// (it returns one of its inputs), so a row may be split across the lanes
// of a sub-warp, or across a whole block, and the partial mins combined in
// any order: the result has the same bits as the plain version's three
// chained scatter_reduce passes. No atomics touch the tuple.
//
// Each lane scans edges first, first + stride, ... of its row, U at a
// time: U (src, w) pairs are loaded together (neighbouring lanes read
// neighbouring edges, so the loads coalesce), then U gathers of the
// sources' (d, rw0, c, pathw), then (rc, rp) only for relay edges. So up
// to U x lanes gather chains of one row are in flight at once.
//
// Overflow: int32 arithmetic exactly as the reference. An admitted live
// source has d_src < delta <= 2^30 and w < delta, so d_src + w fits; the
// relay term clamps rw0 >= BIG to BIG before the add (w <= 2^30 - 1);
// p_safe < 2^30 and w <= 2^30 - 1, so the path add fits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace relax {

constexpr int32_t kInf = 0x7fffffff;   // 2^31 - 1
constexpr int32_t kBig = 1 << 30;      // 2^30
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;            // threads per block, both kernels
constexpr int kWarps = kBlock / 32;
constexpr int kUnroll = 4;             // edges per lane per step
// A row with more in-edges than this is scanned by a whole block, and a
// row with more out-edges is marked by one (kernel.py's LONG_ROW, which
// the graph layout lists the long rows by).
constexpr int kLongRow = 1024;

struct Tuple {
  int32_t d, c, p;
};

__device__ __forceinline__ Tuple none() { return Tuple{kInf, kInf, kInf}; }

__device__ __forceinline__ void fold(Tuple& acc, const Tuple& t) {
  if (t.d < acc.d ||
      (t.d == acc.d && (t.c < acc.c || (t.c == acc.c && t.p < acc.p))))
    acc = t;
}

// The CSR's edge arrays, read once per scan: evict-first (ld.global.cs) so
// that they do not push the gathered node records out of L2.
__device__ __forceinline__ int32_t ld_edge(const int32_t* ptr) {
  return __ldcs(ptr);
}

// The node planes a candidate reads, packed so that one gather brings what
// an edge needs: (d, rw0, c, pathw) as one int4, and (rc, rp) as one int2
// for relay edges. (Six separate planes cost a 32-byte sector per plane
// gathered, for 4 useful bytes.) dc is read through L2 (ld.global.cg) when
// kCoherent: the megakernel writes it during its launch, and L1 is not
// coherent across blocks.
struct Planes {
  const int4* dc;
  const int2* rr;
};

template <bool kCoherent>
__device__ __forceinline__ int4 ld_dc(const int4* ptr) {
  if constexpr (kCoherent) return __ldcg(ptr);
  else return __ldg(ptr);
}

// Folds the candidates of edges first, first + stride, ... < hi into acc.
// With kFront, also sets `hit` when a source of those edges is on the
// frontier `front` (bytes). (64-bit edge offsets: E may come within
// kUnroll * stride of 2^31.)
template <bool kCoherent, bool kFront = false>
__device__ __forceinline__ void scan_row(const int32_t* __restrict__ src,
                                         const int32_t* __restrict__ w,
                                         const Planes& s, int32_t delta,
                                         int64_t first, int64_t hi,
                                         int32_t stride, Tuple& acc,
                                         const uint8_t* front = nullptr,
                                         bool* hit = nullptr) {
  for (int64_t e = first; e < hi; e += kUnroll * stride) {
    int32_t u[kUnroll], we[kUnroll];
    int4 q[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = e + k * stride;
      ok[k] = i < hi;
      u[k] = ok[k] ? ld_edge(src + i) : 0;
      we[k] = ok[k] ? ld_edge(w + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      q[k] = ok[k] ? ld_dc<kCoherent>(s.dc + u[k])
                   : make_int4(kInf, kBig, kInf, kInf);
      if constexpr (kFront)
        if (ok[k] && __ldg(front + u[k])) *hit = true;
    }
    Tuple t[kUnroll];
    bool relay[kUnroll], live[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int32_t ds = q[k].x, r0 = q[k].y;
      live[k] = ok[k] && ds < delta && we[k] < delta;
      int32_t w_red = we[k] + (r0 >= kBig ? kBig : r0);
      w_red = w_red < 0 ? 0 : w_red;
      relay[k] = ok[k] && r0 < kBig && w_red < delta;
      t[k].d = relay[k] ? w_red : (live[k] ? ds + we[k] : kInf);
      t[k].c = q[k].z;
      t[k].p = q[k].w;
      if (relay[k]) {               // relay beats live on the same edge
        const int2 r = __ldg(s.rr + u[k]);
        t[k].c = r.x;
        t[k].p = r.y;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (relay[k] || live[k]) {
        t[k].p = (t[k].p >= kBig ? 0 : t[k].p) + we[k];
        fold(acc, t[k]);
      }
    }
  }
}

// Min over aligned groups of G lanes by xor shuffles; every lane of the
// warp must call it, and every lane of a group ends with the group's min.
template <int G>
__device__ __forceinline__ void group_min(Tuple& t) {
#pragma unroll
  for (int off = G >> 1; off > 0; off >>= 1) {
    const Tuple o{__shfl_xor_sync(kFull, t.d, off),
                  __shfl_xor_sync(kFull, t.c, off),
                  __shfl_xor_sync(kFull, t.p, off)};
    fold(t, o);
  }
}

// Whether any lane of each aligned group of G lanes has h; every lane of
// the warp must call it.
template <int G>
__device__ __forceinline__ bool group_any(bool h) {
  int x = h;
#pragma unroll
  for (int off = G >> 1; off > 0; off >>= 1)
    x |= __shfl_xor_sync(kFull, x, off);
  return x != 0;
}

// Min over the block; the result is valid in thread 0. Every thread of the
// block must call it; sh is reused at once by the next call.
__device__ __forceinline__ Tuple block_min(Tuple t, Tuple* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  group_min<32>(t);
  if (lane == 0) sh[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = lane < kWarps ? sh[lane] : none();
    group_min<kWarps>(t);
  }
  __syncthreads();
  return t;
}

// Lanes per short row, from the mean degree at the launch (cuSPARSE's
// CSR-vector rule, counting the edges a lane takes per step): the least
// power of two G in [4, max_lanes] with G per_lane >= the mean.
inline int lanes_per_row(long long n_edges, long long n_rows, int per_lane,
                         int max_lanes = 32) {
  int g = 4;
  while (g < max_lanes &&
         n_edges > static_cast<long long>(g) * per_lane * n_rows)
    g *= 2;
  return g;
}

}  // namespace relax
