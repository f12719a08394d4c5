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
// float32 [N_src, D] with unit column stride and a row stride >= D (rows
// may be padded); y is float32 [N, D], every row written exactly once (0
// where a row has no in-edge). The kernel gathers x[col[e], :] itself.
//
// What bounds it. The compulsory bytes, each input read once and y written
// once, are 8 (N + 1) + 8 E + 4 D (N_src + N): 0.828 GB at ogb_products
// with D = 16, 0.247 ms at 3.35 TB/s. Every gather that misses L2 costs
// the 32-byte sectors its row spans (2 at D = 16; at D = 7, 28-byte rows,
// 1.75 on average; 1 for rows padded to 32 bytes): 4.63 GB, 1.38 ms at
// D = 16 if none hits. x is 157 MB at D = 16 against a 50 MB L2; the
// sources are skewed (mean out-degree 25), but their reuse distance in
// the CSR order is too long for L2 to keep more than the hottest rows.
// The arithmetic, 2 E D flops, is far below either. The kernel this one
// replaces (a warp per row, then exit) ran a chain of three
// dependent loads (row_ptr, then col and coeff, then x) per warp for a
// median row of 19 edges, with 2 edges in flight at D = 16, and a block
// waited for its longest row.
//
// Design.
//   * Merge-path pieces (Merrill & Garland, SC'16). The N row ends and E
//     edges form one merged sequence (row r's edges, then its end); it is
//     cut into pieces of `tile` items (kTile by default), so every piece
//     holds the same work whatever the degree skew. Item position of edge
//     e of row r is e + r, of r's end row_ptr[r + 1] + r. A piece starts
//     at row X = #{i : row_ptr[i + 1] + i < d} and edge Y = d - X for its
//     first item d: one binary search over row_ptr. A persistent grid
//     (kBlocksPerSm blocks per SM, checked with
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor) gives each block a
//     contiguous run of pieces; the block's threads find the starts of up
//     to kRound pieces at once, one search each.
//   * The index stream is staged by TMA. A producer warp copies each
//     piece's slices of row_ptr, col and coeff into a ring of kStages
//     stages in shared memory with 1-D bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx) under an L2 evict-first
//     policy (these bytes are read once). A copy is widened to 16-byte
//     aligned ends inside the array, so plain loads are needed only at
//     the arrays' own ends. Full/empty mbarriers let the consumer warps
//     gather x for one piece while the next piece's indices arrive: of
//     the three dependent latencies only the gather of x is left on their
//     path.
//   * Gathers. A group of P lanes covers one edge's row; where x's base
//     and row stride are multiples of 16 bytes each lane reads 16 bytes
//     (float4: at D = 16, 4 lanes an edge, 8 edges per warp instruction;
//     at D = 7 padded to 8, 2 lanes, 16 edges), else 4. A group loads a
//     batch of 8 edges' indices and issues their 8 gathers before it adds
//     any: the batch is branch-free up to the sums (the ragged last batch
//     repeats its last edge, loaded and never added). The gathers carry an L2
//     evict-last policy (createpolicy + ld.global.nc.L2::cache_hint) and y
//     is stored with st.global.cs. No stream attribute is set.
//   * A deterministic segmented sum, no float atomics. The consumer warps
//     split a piece into L groups' runs of items by the same merge-path
//     search over the staged row_ptr. A group sums its edges in order;
//     a row that ends in its run and began there is written to y at once
//     (the next row's end is loaded ahead, so a write waits on no load).
//     Each group leaves the partial of the row open at its end (its tail)
//     and of the row it began inside (its head) in shared memory; a row
//     that began in an earlier group adds those groups' tails in group
//     order, then its head. A row that crosses a piece boundary is never
//     written by this kernel: the piece writes its part of it to a carry
//     buffer (one head slot, for the row open at its start, and one tail
//     slot, for the row open at its end, per piece), and a second short
//     launch (segment_mm_fixup) adds each crossing row's slots in piece
//     order and writes its row of y. Every sum has one fixed order: two
//     launches give the same bits.
//   * Offsets into x and y are 64-bit (E * D reaches 7.9e9 at ogb_products
//     with D = 128).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;            // merged items per piece, at most
constexpr int kStages = 2;             // ring stages of staged indices
constexpr int kBlocksPerSm = 2;        // register bound: 2 blocks per SM
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kRound = kThreads - 1;   // pieces whose starts are found at once
constexpr int kMaxD = 256;
constexpr int kMaxGroups = kConsumers; // P = 1
constexpr int kHdr = 64;               // stage header: 7 int64

struct Params {
  const long long* row_ptr;  // [n_rows + 1]
  const int* col;            // [E]
  const float* coeff;        // [E]
  const float* x;            // [N_src, D], row stride x_stride
  float* y;                  // [n_rows, D]
  float* carry;              // [2 n_pieces, dc]: head, tail slot per piece
  long long n_rows;
  long long n_edges;
  int x_stride;              // < 2^31
  long long tile;
  long long n_pieces;
  int D;
  int dc;                    // D rounded up to a multiple of 4
};

// Dynamic shared memory: the mbarriers, kStages stages (header, row_ptr
// slice, col slice, coeff slice), the groups' tails and open rows (two
// buffers, by piece parity) and the piece starts of one round.
struct Smem {
  int stage0, stage, rp, col, cf, tails, groups, bound, total;
};

__host__ __device__ inline Smem smem_layout(long long tile, int vnf) {
  Smem s;
  const int n_rp = static_cast<int>((tile + 5) & ~1LL);  // >= tile + 2, even
  const int n_e = static_cast<int>((tile + 11) & ~3LL);  // >= tile + 3, 4k
  s.rp = kHdr;
  s.col = s.rp + 8 * n_rp;
  s.cf = s.col + 4 * n_e;
  s.stage = s.cf + 4 * n_e;
  s.stage0 = 64;  // 2 kStages mbarriers of 8 bytes
  s.tails = s.stage0 + kStages * s.stage;
  s.groups = s.tails + 2 * 2 * kConsumers * vnf * 4;  // tails, heads
  s.bound = s.groups + 2 * kMaxGroups * 4;
  s.total = s.bound + ((kRound + 1) * 4 + 15) / 16 * 16;
  return s;
}

// -- mbarriers, bulk copies, cache policies (PTX) ---------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrive once and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// some seconds can only be a fault of the kernel (a deadlock): it traps,
// so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// `bytes` contiguous bytes global -> shared by the TMA engine under the L2
// policy `pol`; completion is counted in `bar`'s transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(pol)
      : "memory");
}

// A gather of x under the L2 policy `pol`. Volatile, so that a batch's
// gathers are issued in program order, all before the first use of any.
template <int V>
__device__ __forceinline__ void gather(const float* p, uint64_t pol,
                                       float (&v)[V]) {
  if constexpr (V == 4) {
    asm volatile(
        "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
        : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
        : "l"(p), "l"(pol));
  } else {
    asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n"
                 : "=f"(v[0])
                 : "l"(p), "l"(pol));
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Rows whose end lies before merged item d: #{i : row_ptr[i + 1] + i < d}.
__device__ long long rows_before(const long long* rp, long long n_rows,
                                 long long n_edges, long long d) {
  long long lo = d - n_edges > 0 ? d - n_edges : 0;
  long long hi = d < n_rows ? d : n_rows;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(rp + mid + 1) + mid < d) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// -- the producer warp -------------------------------------------------------

// The staged copy of [lo, hi) of an array of `len` 4- or 8-byte elements:
// its element i at buffer index i - base, base = lo rounded down to an index
// whose address is 16-byte aligned. One bulk copy takes [a, b), [lo, hi)
// widened to aligned ends inside the array; what it cannot take, [lo, a)
// and [b, hi), is non-empty only at the array's own ends (a misaligned
// base, a length not a multiple of 16 bytes) and goes by plain loads.
struct Span {
  long long base, lo, hi, a, b;
};

template <typename T>
__device__ __forceinline__ Span span_of(const T* arr, long long len,
                                        long long lo, long long hi) {
  constexpr long long A = 16 / sizeof(T);
  const long long off =
      static_cast<long long>(reinterpret_cast<uintptr_t>(arr) % 16) /
      static_cast<long long>(sizeof(T));
  const long long first = (A - off) % A;       // first aligned index
  const long long last = len - (len + off) % A;  // last aligned end
  Span s;
  s.base = lo - (lo + off) % A;
  s.lo = lo;
  s.hi = hi;
  s.a = s.base > first ? s.base : first;
  const long long up = hi + (A - (hi + off) % A) % A;
  s.b = up < last ? up : last;
  if (s.a >= s.b) s.a = s.b = hi;  // no aligned run: all plain
  return s;
}

template <typename T>
__device__ __forceinline__ void stage_ends(const T* arr, const Span& s,
                                           T* buf, int lane) {
  for (long long i = s.lo + lane; i < s.a && i < s.hi; i += 32)
    buf[i - s.base] = arr[i];
  for (long long i = (s.b > s.lo ? s.b : s.lo) + lane; i < s.hi; i += 32)
    buf[i - s.base] = arr[i];
}

__device__ void produce(const Params& p, const Smem& lay, unsigned char* smem,
                        const int* bound, long long q0, int nq, int cnt,
                        int lane) {
  const uint64_t pol = policy_evict_first();
  const uint32_t bars = smem_addr(smem);
  const long long ne = p.n_rows + p.n_edges;
  for (int t = 0; t < nq; ++t, ++cnt) {
    const int s = cnt % kStages;
    const uint32_t use = static_cast<uint32_t>(cnt / kStages);
    const uint32_t full = bars + 8 * s, empty = bars + 8 * (kStages + s);
    const long long pc = q0 + t;
    const long long xp = bound[t], xq = bound[t + 1];
    const long long dp = pc * p.tile;
    const long long dq = dp + p.tile < ne ? dp + p.tile : ne;
    const long long yp = dp - xp, yq = dq - xq;
    const Span r = span_of(p.row_ptr, p.n_rows + 1, xp, xq + 1);
    const Span c = span_of(p.col, p.n_edges, yp, yq);
    const Span w = span_of(p.coeff, p.n_edges, yp, yq);
    unsigned char* st = smem + lay.stage0 + s * lay.stage;
    long long* srp = reinterpret_cast<long long*>(st + lay.rp);
    int* scol = reinterpret_cast<int*>(st + lay.col);
    float* scf = reinterpret_cast<float*>(st + lay.cf);
    mbar_wait(empty, (use & 1) ^ 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) {
      long long* hdr = reinterpret_cast<long long*>(st);
      hdr[0] = xp;
      hdr[1] = xq;
      hdr[2] = yp;
      hdr[3] = yq;
      hdr[4] = r.base;
      hdr[5] = c.base;
      hdr[6] = w.base;
    }
    if (r.a > r.lo || r.b < r.hi) stage_ends(p.row_ptr, r, srp, lane);
    if (c.a > c.lo || c.b < c.hi) stage_ends(p.col, c, scol, lane);
    if (w.a > w.lo || w.b < w.hi) stage_ends(p.coeff, w, scf, lane);
    __threadfence_block();
    __syncwarp();
    if (lane == 0) {
      const uint32_t br = static_cast<uint32_t>(8 * (r.b - r.a));
      const uint32_t bc = static_cast<uint32_t>(4 * (c.b - c.a));
      const uint32_t bw = static_cast<uint32_t>(4 * (w.b - w.a));
      mbar_expect_tx(full, br + bc + bw);
      if (br) bulk_load(smem_addr(srp + (r.a - r.base)), p.row_ptr + r.a, br,
                        full, pol);
      if (bc) bulk_load(smem_addr(scol + (c.a - c.base)), p.col + c.a, bc,
                        full, pol);
      if (bw) bulk_load(smem_addr(scf + (w.a - w.base)), p.coeff + w.a, bw,
                        full, pol);
    }
    __syncwarp();
  }
}

// -- the consumer warps ------------------------------------------------------

// Row `a` (this lane's chunks) to y (streaming stores) or to a carry slot.
template <int V, int P, int NF>
__device__ __forceinline__ void store_y(float* yr, const float (&a)[NF][V],
                                        int f, int D) {
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    const int ch = k * P + f;
    if (ch * V >= D) continue;
    if constexpr (V == 4) {
      if ((D & 3) == 0) {
        __stcs(reinterpret_cast<float4*>(yr + ch * 4),
               make_float4(a[k][0], a[k][1], a[k][2], a[k][3]));
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < V; ++c)
      if (ch * V + c < D) __stcs(yr + ch * V + c, a[k][c]);
  }
}

template <int V, int P, int NF>
__device__ __forceinline__ void store_carry(float* cr,
                                            const float (&a)[NF][V], int f,
                                            int D) {
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    const int ch = k * P + f;
    if (ch * V >= D) continue;
#pragma unroll
    for (int c = 0; c < V; ++c) cr[ch * V + c] = a[k][c];
  }
}

template <int V, int NF>
__device__ __forceinline__ void zero(float (&a)[NF][V]) {
#pragma unroll
  for (int k = 0; k < NF; ++k)
#pragma unroll
    for (int c = 0; c < V; ++c) a[k][c] = 0.f;
}

// Adds the tails of groups [m, k) (this lane's chunks) into `a`, in order.
template <int V, int P, int NF>
__device__ __forceinline__ void add_tails(float (&a)[NF][V], const float* tb,
                                          int m, int k, int f) {
  for (int g = m; g < k; ++g) {
    const float* t = tb + (g * P + f) * (V * NF);
#pragma unroll
    for (int q = 0; q < NF; ++q)
#pragma unroll
      for (int c = 0; c < V; ++c) a[q][c] += t[q * V + c];
  }
}

template <int V, int P, int NF>
__device__ void consume(const Params& p, const Smem& lay, unsigned char* smem,
                        long long q0, int nq, int cnt, int cw, int lane) {
  constexpr int G = 32 / P;                  // groups per warp
  constexpr int L = kConsumerWarps * G;      // groups per piece
  constexpr int VNF = V * NF;
  constexpr int U = VNF >= 8 ? 4 : 8;        // gathers in flight per group
  const int g = lane / P, f = lane % P;
  const int k = cw * G + g;
  const int D = p.D;
  const uint64_t pol = policy_evict_last();
  const uint32_t bars = smem_addr(smem);
  // this lane's chunks of a row of x; a lane past D reads chunk 0 (its sums
  // are never stored)
  const float* xl[NF];
#pragma unroll
  for (int q = 0; q < NF; ++q)
    xl[q] = p.x + ((q * P + f) * V < D ? (q * P + f) * V : 0);
  float* tails = reinterpret_cast<float*>(smem + lay.tails);
  int* open = reinterpret_cast<int*>(smem + lay.groups);
  for (int t = 0; t < nq; ++t, ++cnt) {
    const int s = cnt % kStages;
    const uint32_t use = static_cast<uint32_t>(cnt / kStages);
    mbar_wait(bars + 8 * s, use & 1);
    const unsigned char* st = smem + lay.stage0 + s * lay.stage;
    const long long* hdr = reinterpret_cast<const long long*>(st);
    const long long xp = hdr[0], xq = hdr[1], yp = hdr[2], yq = hdr[3];
    // the staged slices, by piece-local row i (row xp + i, i <= nr) and
    // edge j (edge yp + j)
    const long long* rp = reinterpret_cast<const long long*>(st + lay.rp) +
                          (xp - hdr[4]);
    const int* col = reinterpret_cast<const int*>(st + lay.col) + (yp - hdr[5]);
    const float* cf = reinterpret_cast<const float*>(st + lay.cf) +
                      (yp - hdr[6]);
    const long long pc = q0 + t;
    const int nr = static_cast<int>(xq - xp);
    // row i's end as a piece-local edge offset; its item is end_of(i) + i
    auto end_of = [&](int i) { return static_cast<int>(rp[i + 1] - yp); };

    // this group's run of items [g0, g1) of the piece, found by merge path
    const int n_items = static_cast<int>(xq + yq - xp - yp);
    const int g0 = n_items * k / L, g1 = n_items * (k + 1) / L;
    // the two searches side by side: their loads overlap
    int x0 = 0, x1 = 0;
    {
      int hi0 = nr, hi1 = nr;
      while (x0 < hi0 || x1 < hi1) {
        const int m0 = (x0 + hi0) >> 1, m1 = (x1 + hi1) >> 1;
        const int e0 = x0 < hi0 ? end_of(m0) + m0 : 0;
        const int e1 = x1 < hi1 ? end_of(m1) + m1 : 0;
        if (x0 < hi0) {
          if (e0 < g0) x0 = m0 + 1;
          else hi0 = m0;
        }
        if (x1 < hi1) {
          if (e1 < g1) x1 = m1 + 1;
          else hi1 = m1;
        }
      }
    }
    const int y0 = g0 - x0, y1 = g1 - x1;
    const bool x0_began_before = rp[x0] - yp < y0;

    // this piece's buffers: the groups' tails and heads, by piece parity
    const int buf = cnt & 1;
    float* tb = tails + buf * 2 * kConsumers * VNF;
    float* hb = tb + kConsumers * VNF;
    int* ob = open + buf * kMaxGroups;

    float acc[NF][V];
    zero<V, NF>(acc);
    bool has_head = false;
    // row i is open; next_end is its end, after the end of row i + 1
    // (loaded ahead, so that an emit waits on no load)
    int i = x0;
    int next_end = i < x1 ? end_of(i) : 0x7fffffff;
    int after = i + 1 < x1 ? end_of(i + 1) : 0x7fffffff;
    float* yr = p.y + (xp + x0) * D;
    auto emit = [&]() {
      if (i == x0 && x0_began_before) {  // the group's head: kept for later
        float* mine = hb + (k * P + f) * VNF;
#pragma unroll
        for (int q = 0; q < NF; ++q)
#pragma unroll
          for (int c = 0; c < V; ++c) mine[q * V + c] = acc[q][c];
        has_head = true;
      } else {
        store_y<V, P, NF>(yr, acc, f, D);
      }
      zero<V, NF>(acc);
      yr += D;
      ++i;
      next_end = after;
      after = i + 1 < x1 ? end_of(i + 1) : 0x7fffffff;
    };
    // A batch of U edges, branch-free up to the sums: the ragged last
    // batch repeats its last edge (loaded, never added), so that every
    // index load and gather of the batch issues before any is used.
    for (int j = y0; j < y1; j += U) {
      const int n = y1 - j < U ? y1 - j : U;
      int c[U];
      float w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = j + (u < n ? u : n - 1);
        c[u] = col[e];
        w[u] = cf[e];
      }
      float v[U][NF][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < NF; ++q)
          gather<V>(xl[q] + static_cast<long long>(c[u]) * p.x_stride, pol,
                    v[u][q]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        while (next_end <= j + u) emit();
        if (u < n) {
#pragma unroll
          for (int q = 0; q < NF; ++q)
#pragma unroll
            for (int c2 = 0; c2 < V; ++c2)
              acc[q][c2] = fmaf(w[u], v[u][q][c2], acc[q][c2]);
        }
      }
    }
    while (i < x1) emit();

    // tails: the partial of the row open at each group's end
    {
      float* mine = tb + (k * P + f) * VNF;
#pragma unroll
      for (int q = 0; q < NF; ++q)
#pragma unroll
        for (int c = 0; c < V; ++c) mine[q * V + c] = acc[q][c];
      if (f == 0) ob[k] = x1;
    }
    __syncwarp();
    consumers_sync();
    if (has_head) {
      // row x0 ended here and began in an earlier group: add the tails of
      // the groups it spans, in order, then this group's part
      int m = k;
      while (m > 0 && ob[m - 1] == x0) --m;
      float sum[NF][V];
      zero<V, NF>(sum);
      add_tails<V, P, NF>(sum, tb, m, k, f);
      const float* head = hb + (k * P + f) * VNF;
#pragma unroll
      for (int q = 0; q < NF; ++q)
#pragma unroll
        for (int c = 0; c < V; ++c) sum[q][c] += head[q * V + c];
      if (rp[x0] >= yp)
        store_y<V, P, NF>(p.y + (xp + x0) * D, sum, f, D);
      else  // began in an earlier piece: the piece's head slot
        store_carry<V, P, NF>(p.carry + 2 * pc * p.dc, sum, f, D);
    }
    if (k == L - 1 && xq < p.n_rows) {
      // the row open at the piece's end: the piece's tail slot
      int m = L - 1;
      while (m > 0 && ob[m - 1] == nr) --m;
      float sum[NF][V];
      zero<V, NF>(sum);
      add_tails<V, P, NF>(sum, tb, m, L, f);
      store_carry<V, P, NF>(p.carry + (2 * pc + 1) * p.dc, sum, f, D);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
  }
}

template <int V, int P, int NF>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    segment_mm_pieces(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay = smem_layout(p.tile, V * NF);
  int* bound = reinterpret_cast<int*>(smem + lay.bound);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(smem);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long ne = p.n_rows + p.n_edges;
  const long long pb = p.n_pieces * blockIdx.x / gridDim.x;
  const long long pe = p.n_pieces * (blockIdx.x + 1) / gridDim.x;
  int cnt = 0;
  for (long long q0 = pb; q0 < pe; q0 += kRound) {
    const int nq = static_cast<int>(pe - q0 < kRound ? pe - q0 : kRound);
    for (int t = threadIdx.x; t <= nq; t += kThreads) {
      const long long d = (q0 + t) * p.tile;
      bound[t] = static_cast<int>(
          rows_before(p.row_ptr, p.n_rows, p.n_edges, d < ne ? d : ne));
    }
    __syncthreads();
    if (warp == 0) produce(p, lay, smem, bound, q0, nq, cnt, lane);
    else consume<V, P, NF>(p, lay, smem, q0, nq, cnt, warp - 1, lane);
    cnt += nq;
    __syncthreads();
  }
}

// Each crossing row's carry slots, in piece order: the tails of the pieces
// it began in or spans, then the head of the piece it ends in.
__global__ void segment_mm_fixup(const long long* __restrict__ rp,
                                 const int* __restrict__ cross,
                                 long long n_cross,
                                 const float* __restrict__ carry,
                                 float* __restrict__ y, long long tile, int D,
                                 int dc) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_cross * D) return;
  const long long r = cross[idx / D];
  const int f = static_cast<int>(idx % D);
  const long long first = (rp[r] + r) / tile, last = (rp[r + 1] + r) / tile;
  float s = 0.f;
  for (long long q = first; q < last; ++q) s += carry[(2 * q + 1) * dc + f];
  s += carry[2 * last * dc + f];
  y[r * D + f] = s;
}

// Blocks per SM of one instance at `smem` bytes and the device's SM count,
// cached per instance and device for the last size asked.
template <int V, int P, int NF>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int cached_dev = -1, cached_smem = -1, cached_grid = 0;
  const Smem lay = smem_layout(p.tile, V * NF);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev || lay.total != cached_smem) {
    err = cudaFuncSetAttribute(segment_mm_pieces<V, P, NF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               lay.total);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, segment_mm_pieces<V, P, NF>, kThreads, lay.total);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_smem = lay.total;
    cached_grid = per_sm * sms;
  }
  const long long grid =
      p.n_pieces < cached_grid ? p.n_pieces : static_cast<long long>(cached_grid);
  segment_mm_pieces<V, P, NF>
      <<<static_cast<unsigned>(grid), kThreads, lay.total, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_pieces(const Params& p, bool vec, cudaStream_t s) {
  const int D = p.D;
  if (vec) {  // 16-byte gathers: ceil(D / 4) chunks over P lanes
    if (D <= 4) return launch<4, 1, 1>(p, s);
    if (D <= 8) return launch<4, 2, 1>(p, s);
    if (D <= 16) return launch<4, 4, 1>(p, s);
    if (D <= 32) return launch<4, 8, 1>(p, s);
    if (D <= 64) return launch<4, 16, 1>(p, s);
    if (D <= 128) return launch<4, 32, 1>(p, s);
    return launch<4, 32, 2>(p, s);
  }
  if (D == 1) return launch<1, 1, 1>(p, s);
  if (D <= 2) return launch<1, 2, 1>(p, s);
  if (D <= 4) return launch<1, 4, 1>(p, s);
  if (D <= 8) return launch<1, 8, 1>(p, s);
  if (D <= 16) return launch<1, 16, 1>(p, s);
  if (D <= 32) return launch<1, 32, 1>(p, s);
  if (D <= 64) return launch<1, 32, 2>(p, s);
  if (D <= 128) return launch<1, 32, 4>(p, s);
  return launch<1, 32, 8>(p, s);
}

}  // namespace

// row_ptr int64 [n_rows + 1], col int32 [E], coeff float32 [E], crossing
// int32 [n_cross] (the rows whose items lie in more than one piece of
// `tile` items, each once), x float32 [N_src, D] with unit column stride
// and row stride x_stride >= D, y float32 [n_rows, D] (contiguous,
// uninitialised) and carry float32 [2 ceil((n_rows + E) / tile), ceil4(D)]
// (uninitialised), all on one device. `vec` = 1 lets the kernel read x in
// 16-byte chunks: x's base is 16-byte aligned, x_stride is a multiple of 4
// and a read of ceil4(D) floats from the last row stays inside x's
// storage; with `vec` = 0 it reads a float at a time. Requires
// 1 <= D <= 256, 1 <= tile <= kTile, n_rows < 2^31 (the wrapper, kernel.py,
// checks shapes, types and devices first). Launches the piece kernel and,
// when n_cross > 0, the fix-up on `stream` without synchronising; returns
// the CUDA error of the launches (0 on success; n_rows = 0 launches
// nothing).
extern "C" int segment_mm_launch(const long long* row_ptr, const int* col,
                                 const float* coeff, const float* x,
                                 const int* crossing, float* y, float* carry,
                                 long long n_rows, long long n_edges,
                                 long long x_stride, long long n_cross,
                                 long long tile, int D, int vec,
                                 void* stream_ptr) {
  if (n_rows == 0) return 0;
  if (D < 1 || D > kMaxD || tile < 1 || tile > kTile || n_rows < 0 ||
      n_rows > 0x7fffffffLL || n_edges < 0 || x_stride < D ||
      x_stride > 0x7fffffffLL || n_cross < 0 ||
      n_cross > n_rows ||
      (vec && (x_stride % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.row_ptr = row_ptr;
  p.col = col;
  p.coeff = coeff;
  p.x = x;
  p.y = y;
  p.carry = carry;
  p.n_rows = n_rows;
  p.n_edges = n_edges;
  p.x_stride = static_cast<int>(x_stride);
  p.tile = tile;
  p.n_pieces = (n_rows + n_edges + tile - 1) / tile;
  p.D = D;
  p.dc = (D + 3) & ~3;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = launch_pieces(p, vec != 0, s);
  if (err != cudaSuccess || n_cross == 0) return static_cast<int>(err);
  const long long threads = n_cross * D;
  const long long blocks = (threads + 255) / 256;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_mm_fixup<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      row_ptr, crossing, n_cross, carry, y, tile, D, p.dc);
  return static_cast<int>(cudaGetLastError());
}
