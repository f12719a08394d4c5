// Persistent fused grow-superstep megakernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_relax/megakernel.py
// (_mega_kernel, line 93; entry fused_grow_supersteps, line 239). It runs up
// to K Δ-growing relax supersteps in ONE cooperative launch and computes
// what the TPU kernel computes:
//   * before every superstep, the growth_loop stop rule of megakernel.py:
//     121-128: changed & steps_base + k < num_it & (complete | reached <
//     half_target); once it fails, the remaining slots do nothing;
//   * per destination row, the candidate rule and lexicographic (d, c,
//     pathw) tuple-min of edge_relax.cu, then the merge rule upd = !frozen &
//     acc_d < d (megakernel.py:205), compared on d only;
//   * the frontier bitmap front (1 where the row's tuple changed in the
//     previous superstep), carried in and out of the launch;
//   * one stats row per executed superstep (1, nodes changed, reached after
//     the merge, cumulative skipped rows, continue flag) and the summary row
//     K (supersteps executed, changed flag, reached, skipped rows, continue
//     flag), the column layout of megakernel.py:58-68. Rows of slots that
//     did not run stay 0.
//
// Frontier skip (the unit is a destination ROW): a row runs in superstep j
// only when it is not frozen and some in-edge source changed in superstep
// j - 1 (in superstep 0: is on the carried frontier). Soundness
// (megakernel.py:29-35): a candidate of edge (u, v) depends only on u's
// (d, c, pathw), the relay planes and Δ, which are constant within a grow
// call except for u's tuple; a row none of whose sources changed has the
// candidates whose min was merged already. Rows that do not run are counted
// in the stats' column 3; the plain version (megakernel.py's port) counts
// the same unit from front[src].
//
// Design: a device worklist, so that a superstep costs the edges of the
// rows that run (and of the rows that change) plus two grid barriers, not a
// pass over all n rows.
//   * State. Phase 0 packs the carried planes into one (d, rw0, c, pathw)
//     int4 record per row and an (rc, rp) int2, so an edge's candidate is
//     one gather (two for a relay) instead of a 32-byte sector per plane.
//     The outputs are unpacked from the records at the end.
//   * Worklist. The rows that run in superstep j + 1 are the non-frozen
//     out-neighbours of the rows that changed in superstep j, found through
//     the out-edge CSR (out_ptr, out_dst: the same edges ordered by (src,
//     dst)), so the set is exactly the plain version's. A row is listed
//     once: a bitmap of one bit per row (one per superstep parity), set with
//     atomicOr, lists it only when the bit was 0 (an L2 read first skips the
//     atomic for rows listed already). A frozen row keeps its bit and is
//     never listed. A block gathers the rows it lists in shared memory and
//     appends them with one atomicAdd (lists are in no particular order;
//     every result is order-free).
//   * Superstep 0's list comes from the carried frontier: phase 0 counts the
//     frontier's out-edges; when they are more than a quarter of the
//     graph's (the first launch of a grow call, whose frontier is all ones)
//     superstep 0 runs over every row instead and tests the frontier per
//     in-edge (a byte gather), rather than marking a quarter of the edges or
//     more. Otherwise G lanes per frontier row (compacted within each warp)
//     mark its out-neighbours, and a block per out-hub after a barrier.
//   * Phase A scans the listed rows with edge_relax.cu's split: G lanes per
//     row of at most kLongRow (1,024) in-edges (G from the mean degree, at
//     most 8); each row of the graph's long-row list on a block (block b takes
//     long rows b, b + gridDim, ...), run when its bit is set. Each row's
//     candidate record goes to the slot of its list position (d INF where
//     it does not improve d); a row that changes marks its out-neighbours
//     for the next superstep at once with the same lanes, except a short
//     row with more than kLongRow out-edges (an out-hub), which is listed
//     for phase B (the hub list has a slot per row, so it holds every
//     changed out-hub whatever the graph). Phase A writes no state, so every candidate sees the
//     state after the previous superstep (Jacobi, as the TPU kernel's
//     accumulate-then-merge). grid.sync().
//   * Phase B writes the changed slots' records into the state, and a block
//     per listed out-hub marks its out-list. grid.sync().
//   * Counts (listed, changed, ran, reached's increase, hubs) go to one row
//     of `counts` per stage, block-reduced and atomically added; every block
//     reads the same counts after a barrier and takes the same stop
//     decision. `reached` is kept incrementally: d only decreases, so a
//     superstep adds exactly the changed rows that crossed below Δ. The
//     output frontier is the last executed superstep's changed slots, or
//     front_in when none ran.
//   * Everything written during the launch (records, lists, slots, bitmaps,
//     counts) is read with ld.global.cg (L2, not the incoherent L1 /
//     read-only path); what is constant (CSRs, frozen, (rc, rp)) with
//     __ldg. No thread returns early: every thread reaches every grid.sync().
//
// Bound (bytes over 3.35 TB/s; chip_smoke.py's mega_launch_bytes is the
// one definition): a launch reads d, c, pathw and the frontier of every
// row and writes them once (26n); per executed superstep, a row that runs
// reads row_ptr, src and w of its in-edges, d and rw0 of its sources,
// c/pathw (live) or rc/rp (relay) of the admissible ones, and its own d; a
// row that changes writes d, c, pathw and reads its out-edge list, and
// each row it marks has its frozen byte read once.
//
// Overflow: the candidate arithmetic is edge_relax.cu's (int32, exact as the
// reference). Counts are int32: n * (K + 1) < 2^31 is checked by the
// wrapper; a list holds at most n rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "relax_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using relax::kBlock;
using relax::kFull;
using relax::kInf;
using relax::kWarps;
using relax::Tuple;

constexpr int kStatsW = 8;       // STATS_W
constexpr int kCountW = 8;       // one row of counts per stage
constexpr int kStageCap = 2048;  // rows a block gathers before one append
constexpr int kMinBlocks = 4;    // resident blocks per SM (64 registers)
constexpr int kMaxLanes = 8;     // lanes per row at most (skewed graphs)
constexpr int kPerLane = 2;      // mean in-edges a lane of a row takes
// the columns of a stage's row of counts
constexpr int kListed = 0;   // rows listed for the next superstep
constexpr int kChanged = 1;  // rows the superstep changed
constexpr int kReached = 2;  // reached (stage 0) or its increase
constexpr int kHubs = 3;     // rows whose > kLongRow out-edges a block marks
constexpr int kRan = 4;      // rows the superstep ran
constexpr int kFrontEdges = 5;  // stage 0: out-edges of the carried frontier

struct MegaArgs {
  const int32_t* row_ptr;
  const int32_t* src;
  const int32_t* w;
  const int32_t* long_rows;  // [n_long]: the rows with > kLongRow in-edges
  const int32_t* d_in;
  const int32_t* c_in;
  const int32_t* p_in;
  const uint8_t* front_in;
  const int32_t* rw0;
  const int32_t* rc;
  const int32_t* rp;
  const uint8_t* frozen;
  const int32_t* out_ptr;   // out-edge CSR: [n + 1], edges ordered by src
  const int32_t* out_dst;   // [E]
  int32_t* d;               // outputs [n]
  int32_t* c;
  int32_t* p;
  uint8_t* front;
  int4* dc;                 // [n] (d, rw0, c, pathw): the state scanned
  int2* rr;                 // [n] (rc, rp)
  int4* cand;               // [n + n_long] (d, rw0, c, pathw) by slot: list
                            // entry i at i, long row i at n + i; d INF
                            // when the row did not change
  int32_t* work[2];         // [n] each: the rows listed for even, odd
                            // supersteps
  int32_t* hubs;            // [n]: the changed out-hubs of a stage
  uint32_t* bitmap[2];      // [ceil(n / 32)] each, zeroed by the caller:
                            // the rows listed for even, odd supersteps
  int32_t* counts;          // [K + 1, kCountW], zeroed by the caller
  int32_t* stats;           // [K + 1, kStatsW], zeroed by the caller
  int32_t delta, half_target, num_it, steps_base, stop_variant, n, k_fused,
      n_long, n_edges;
};

__device__ __forceinline__ int32_t ld_cg(const int32_t* ptr) {
  return __ldcg(ptr);
}

// The lanes of the warp that run this together: their mask, the lowest
// of them, and the calling lane's rank among them.
__device__ __forceinline__ void active_rank(unsigned& mask, int& leader,
                                            int& rank) {
  mask = __activemask();
  const int lane = threadIdx.x & 31;
  leader = __ffs(mask) - 1;
  rank = __popc(mask & ((1u << lane) - 1u));
}

// Appends v to `list` at the next free slot of *count. The lanes of the
// warp that append together share one atomicAdd.
__device__ __forceinline__ void append(int32_t* count, int32_t* list,
                                       int32_t v) {
  unsigned mask;
  int leader, rank;
  active_rank(mask, leader, rank);
  int32_t base = 0;
  if ((threadIdx.x & 31) == leader) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  list[base + rank] = v;
}

// A block's rows for the worklist, gathered in shared memory and appended
// with one atomicAdd per block (stage_flush); past kStageCap rows they go
// to the list directly.
struct Stage {
  int32_t n, base;
  int32_t rows[kStageCap];
};

__device__ __forceinline__ void stage_push(Stage& st, int32_t v,
                                           int32_t* count, int32_t* list) {
  unsigned mask;
  int leader, rank;
  active_rank(mask, leader, rank);
  int32_t base = 0;
  if ((threadIdx.x & 31) == leader) base = atomicAdd(&st.n, __popc(mask));
  const int32_t slot = __shfl_sync(mask, base, leader) + rank;
  if (slot < kStageCap)
    st.rows[slot] = v;
  else
    append(count, list, v);
}

// Appends the block's gathered rows to `list`. Every thread of the block
// must call it; the stage is empty again after it.
__device__ __forceinline__ void stage_flush(Stage& st, int32_t* count,
                                            int32_t* list) {
  __syncthreads();
  const int32_t m = st.n < kStageCap ? st.n : kStageCap;
  if (threadIdx.x == 0) st.base = m ? atomicAdd(count, m) : 0;
  __syncthreads();
  for (int32_t i = threadIdx.x; i < m; i += kBlock)
    list[st.base + i] = st.rows[i];
  __syncthreads();
  if (threadIdx.x == 0) st.n = 0;
  __syncthreads();
}

// Lists row v for superstep parity `next` (counted in the stage row `cnt`)
// unless it is listed already or frozen. A frozen row keeps its bit, so the
// first test turns it away from then on.
__device__ __forceinline__ void mark(const MegaArgs& a, Stage& st, int32_t v,
                                     int32_t* cnt, int next) {
  uint32_t* word = a.bitmap[next] + (v >> 5);
  const uint32_t bit = 1u << (v & 31);
  if (__ldcg(word) & bit) return;         // listed already: no atomic
  if (atomicOr(word, bit) & bit) return;
  if (__ldg(a.frozen + v)) return;
  stage_push(st, v, cnt + kListed, a.work[next]);
}

// Marks the out-neighbours of v (out-edges [o0, o1)) with the lanes
// first, first + step, ...
__device__ __forceinline__ void mark_out(const MegaArgs& a, Stage& st,
                                         int32_t o0, int32_t o1,
                                         int32_t first, int32_t step,
                                         int32_t* cnt, int next) {
  for (int32_t e = o0 + first; e < o1; e += step)
    mark(a, st, __ldg(a.out_dst + e), cnt, next);
}

// The out-hubs the stage `cnt` listed, a block each (block b takes hubs b,
// b + gridDim, ...).
__device__ void mark_hubs(const MegaArgs& a, Stage& st, int32_t* cnt,
                          int next) {
  const int32_t n_hubs = ld_cg(cnt + kHubs);
  for (int32_t h = blockIdx.x; h < n_hubs; h += gridDim.x) {
    const int32_t v = ld_cg(a.hubs + h);
    mark_out(a, st, __ldg(a.out_ptr + v), __ldg(a.out_ptr + v + 1),
             threadIdx.x, kBlock, cnt, next);
  }
}

// Row v's candidate tuple t against its record r (as the superstep found
// it), into slot s: the slot keeps (t, rw0) when t improves v's d, d INF
// when not. Adds to the changed and reached counts (reached: v crosses
// below Δ). Returns whether v changed.
__device__ __forceinline__ bool finish_row(const MegaArgs& a, const int4& r,
                                           int64_t s, const Tuple& t,
                                           int32_t& n_changed,
                                           int32_t& reached_add) {
  if (!(t.d < r.x)) {
    a.cand[s].x = kInf;
    return false;
  }
  a.cand[s] = make_int4(t.d, r.y, t.c, t.p);
  ++n_changed;
  reached_add += r.x >= a.delta && t.d < a.delta;
  return true;
}

// Adds x[k] over the block into cnt[col[k]] for k < 3 (one atomic each
// per block). Every thread of the block must call it.
__device__ void block_add3(int32_t x0, int32_t x1, int32_t x2, int32_t* cnt,
                           int c0, int c1, int c2) {
  __shared__ int32_t sh[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t x[3] = {x0, x1, x2};
  const int col[3] = {c0, c1, c2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = __reduce_add_sync(kFull, x[k]);
    if (lane == 0) sh[k][warp] = x[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x[k] = __reduce_add_sync(kFull, lane < kWarps ? sh[k][lane] : 0);
      if (lane == 0 && x[k]) atomicAdd(cnt + col[k], x[k]);
    }
  }
  __syncthreads();   // sh is reused by the next call
}

__device__ __forceinline__ bool cond_flag(const MegaArgs& a, bool changed,
                                          int32_t steps_done,
                                          int32_t reached) {
  return changed && (a.steps_base + steps_done < a.num_it) &&
         (a.stop_variant == 0 || reached < a.half_target);
}

// Phase A of one superstep: the rows at positions [0, n_pos) (`work`, or
// every row when kDense: then a row runs only if it is not frozen and some
// in-edge source is on front_in), and the long rows, a block each. Each
// row that runs gets its candidate in its slot and clears its bit; a row
// that changes lists its out-neighbours for the next superstep.
template <int G, bool kDense>
__device__ __forceinline__ void phase_a(const MegaArgs& a, Tuple* sh,
                                        bool& sh_flag, Stage& st,
                                        int64_t n_pos, const int32_t* work,
                                        uint32_t* bits, int32_t* cnt,
                                        int next, int64_t tid,
                                        int64_t stride) {
  const int32_t lane = threadIdx.x & 31;
  const int32_t glane = lane % G;
  const int32_t n = a.n;
  const relax::Planes planes{a.dc, a.rr};
  int32_t n_changed = 0, reached_add = 0, n_ran = 0;
  // the long rows, a block each (their bits are read and cleared only here)
  for (int32_t i = blockIdx.x; i < a.n_long; i += gridDim.x) {
    const int32_t v = a.long_rows[i];
    const uint32_t bit = 1u << (v & 31);
    bool run = !__ldg(a.frozen + v);
    if (!kDense) run = run && (__ldcg(bits + (v >> 5)) & bit);
    if (run) {   // uniform over the block
      const int4 r = __ldcg(a.dc + v);
      const int32_t o0 = __ldg(a.out_ptr + v), o1 = __ldg(a.out_ptr + v + 1);
      Tuple t = relax::none();
      bool hit = false;
      relax::scan_row<true, kDense>(
          a.src, a.w, planes, a.delta,
          static_cast<int64_t>(__ldg(a.row_ptr + v)) + threadIdx.x,
          __ldg(a.row_ptr + v + 1), kBlock, t, a.front_in, &hit);
      t = relax::block_min(t, sh);
      if (kDense) run = __syncthreads_or(hit);
      if (run) {
        if (threadIdx.x == 0) {
          if (!kDense) atomicAnd(bits + (v >> 5), ~bit);
          ++n_ran;
          sh_flag = finish_row(a, r, n + i, t, n_changed, reached_add);
        }
        __syncthreads();
        if (sh_flag)
          mark_out(a, st, o0, o1, threadIdx.x, kBlock, cnt, next);
      }
    }
    if (!run && threadIdx.x == 0) a.cand[n + i].x = kInf;
  }
  // the other rows, G lanes each; a warp takes 32 / G positions at a time
  constexpr int kRowsPerWarp = 32 / G;
  const int64_t n_warps = stride >> 5;
  for (int64_t base = (tid >> 5) * kRowsPerWarp; base < n_pos;
       base += n_warps * kRowsPerWarp) {   // uniform over the warp
    const int64_t i = base + lane / G;
    Tuple t = relax::none();
    int32_t v = -1;
    int4 r;
    bool hit = !kDense;
    if (i < n_pos) {
      v = kDense ? static_cast<int32_t>(i) : ld_cg(work + i);
      const int32_t e0 = __ldg(a.row_ptr + v), e1 = __ldg(a.row_ptr + v + 1);
      if (e1 - e0 > relax::kLongRow || (kDense && __ldg(a.frozen + v))) {
        v = -1;   // a long row runs on its block; a frozen one never
      } else {
        r = __ldcg(a.dc + v);
        relax::scan_row<true, kDense>(a.src, a.w, planes, a.delta,
                                      e0 + glane, e1, G, t, a.front_in, &hit);
      }
    }
    relax::group_min<G>(t);   // every lane of the group holds the min
    if (kDense) hit = relax::group_any<G>(hit);
    if (v < 0 || !hit) {
      if (i < n_pos && glane == 0) a.cand[i].x = kInf;
      continue;
    }
    const int32_t o0 = __ldg(a.out_ptr + v), o1 = __ldg(a.out_ptr + v + 1);
    if (glane == 0) {
      if (!kDense) atomicAnd(bits + (v >> 5), ~(1u << (v & 31)));
      ++n_ran;
      if (finish_row(a, r, i, t, n_changed, reached_add) &&
          o1 - o0 > relax::kLongRow)
        append(cnt + kHubs, a.hubs, v);
    }
    // a changed row lists its out-neighbours now (an out-hub: a block, in
    // phase B)
    if (t.d < r.x && o1 - o0 <= relax::kLongRow)
      mark_out(a, st, o0, o1, glane, G, cnt, next);
  }
  block_add3(n_changed, reached_add, n_ran, cnt, kChanged, kReached, kRan);
  stage_flush(st, cnt + kListed, a.work[next]);
}

// The row at position q of a superstep's slots: the list (every row when
// dense), then the long rows.
__device__ __forceinline__ int32_t row_at(const MegaArgs& a, bool dense,
                                          const int32_t* work, int64_t n_pos,
                                          int64_t q) {
  if (q >= n_pos) return a.long_rows[q - n_pos];
  return dense ? static_cast<int32_t>(q) : ld_cg(work + q);
}

__device__ __forceinline__ int64_t slot_at(const MegaArgs& a, int64_t n_pos,
                                           int64_t q) {
  return q < n_pos ? q : a.n + (q - n_pos);
}

template <int G>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
megakernel(const MegaArgs a) {
  __shared__ Tuple sh[kWarps];
  __shared__ Stage st;
  __shared__ bool sh_flag;
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlock;
  const int32_t lane = threadIdx.x & 31;
  const int32_t glane = lane % G;           // rank in the lane group
  const int32_t n = a.n;
  const int32_t delta = a.delta;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  if (threadIdx.x == 0) st.n = 0;
  __syncthreads();

  // ---- phase 0: the carried planes packed; reached on entry; the
  //      carried frontier's out-edges counted -----------------------------
  int32_t* cnt0 = a.counts;
  int32_t r0 = 0, front_edges = 0;
  for (int64_t v = tid; v < n; v += stride) {
    const int32_t dv = a.d_in[v];
    a.dc[v] = make_int4(dv, __ldg(a.rw0 + v), a.c_in[v], a.p_in[v]);
    a.rr[v] = make_int2(__ldg(a.rc + v), __ldg(a.rp + v));
    r0 += (__ldg(a.frozen + v) == 0 && dv < delta);
    if (a.front_in[v])
      front_edges += __ldg(a.out_ptr + v + 1) - __ldg(a.out_ptr + v);
  }
  block_add3(r0, front_edges, 0, cnt0, kReached, kFrontEdges, kRan);
  grid.sync();
  // A frontier whose out-edges are more than a quarter of the graph's is
  // not listed: superstep 0 runs over every row and tests the frontier
  // itself (it reads a byte per edge instead of marking a quarter or more
  // of the edges).
  const bool dense0 = 4LL * ld_cg(cnt0 + kFrontEdges) > a.n_edges;
  if (!dense0) {
    // the out-neighbours of the carried frontier listed for superstep 0: G
    // lanes per frontier row, compacted within each warp; a block per
    // out-hub after the barrier
    for (int64_t base = tid - lane; base < n; base += stride) {  // 32 rows
      const int64_t v = base + lane;
      unsigned rows = __ballot_sync(kFull, v < n && a.front_in[v]);
      while (rows) {   // the warp's groups take its frontier rows in turn
        unsigned mine = rows;
        for (int k = 0; k < lane / G; ++k) mine &= mine - 1;
        if (mine) {
          const int32_t u = static_cast<int32_t>(base + __ffs(mine) - 1);
          const int32_t o0 = __ldg(a.out_ptr + u);
          const int32_t o1 = __ldg(a.out_ptr + u + 1);
          if (o1 - o0 > relax::kLongRow) {
            if (glane == 0) append(cnt0 + kHubs, a.hubs, u);
          } else {
            mark_out(a, st, o0, o1, glane, G, cnt0, 0);
          }
        }
        for (int k = 0; k < 32 / G && rows; ++k) rows &= rows - 1;
      }
    }
    stage_flush(st, cnt0 + kListed, a.work[0]);
    grid.sync();
    mark_hubs(a, st, cnt0, 0);
    stage_flush(st, cnt0 + kListed, a.work[0]);
    grid.sync();
  }

  int32_t reached = ld_cg(cnt0 + kReached);
  bool changed = true;
  int32_t executed = 0;
  int32_t skipped_total = 0;

  for (int32_t j = 0; j < a.k_fused; ++j) {
    // the stop rule, from grid-wide counts every block read after a barrier
    if (!cond_flag(a, changed, j, reached)) break;
    const int cur = j & 1, next = cur ^ 1;
    const bool dense = j == 0 && dense0;
    // superstep j scans list j (counted in row j) and is stage j + 1
    const int64_t n_pos =
        dense ? n : ld_cg(a.counts + j * kCountW + kListed);
    int32_t* cnt = a.counts + (j + 1) * kCountW;
    const int32_t* work = a.work[cur];

    // ---- phase A: candidates into slots; changed rows list their
    //      out-neighbours for superstep j + 1 ------------------------------
    if (dense)
      phase_a<G, true>(a, sh, sh_flag, st, n_pos, work, a.bitmap[cur], cnt,
                       next, tid, stride);
    else
      phase_a<G, false>(a, sh, sh_flag, st, n_pos, work, a.bitmap[cur], cnt,
                        next, tid, stride);
    grid.sync();

    // ---- phase B: merge the changed rows; the changed out-hubs' marks ----
    mark_hubs(a, st, cnt, next);
    for (int64_t q = tid; q < n_pos + a.n_long; q += stride) {
      const int4 r = __ldcg(a.cand + slot_at(a, n_pos, q));
      if (r.x != kInf) a.dc[row_at(a, dense, work, n_pos, q)] = r;
    }
    stage_flush(st, cnt + kListed, a.work[next]);
    grid.sync();
    const int32_t n_changed = ld_cg(cnt + kChanged);

    reached += ld_cg(cnt + kReached);
    skipped_total += n - ld_cg(cnt + kRan);
    changed = n_changed > 0;
    executed = j + 1;
    if (leader) {
      int32_t* row = a.stats + j * kStatsW;
      row[0] = 1;
      row[1] = n_changed;
      row[2] = reached;
      row[3] = skipped_total;
      row[4] = cond_flag(a, changed, executed, reached) ? 1 : 0;
    }
  }

  // ---- the outputs: the planes unpacked; the frontier (the rows the last
  //      superstep changed, or the carried one when none ran) -------------
  for (int64_t v = tid; v < n; v += stride) {
    const int4 r = __ldcg(a.dc + v);
    a.d[v] = r.x;
    a.c[v] = r.z;
    a.p[v] = r.w;
    a.front[v] = executed == 0 ? a.front_in[v] : 0;
  }
  if (executed > 0) {
    grid.sync();   // the frontier cleared before it is set
    const int32_t last = executed - 1;
    const bool dense = last == 0 && dense0;
    const int32_t* work = a.work[last & 1];
    const int64_t n_pos =
        dense ? n : ld_cg(a.counts + last * kCountW + kListed);
    for (int64_t q = tid; q < n_pos + a.n_long; q += stride)
      if (__ldcg(a.cand + slot_at(a, n_pos, q)).x != kInf)
        a.front[row_at(a, dense, work, n_pos, q)] = 1;
  }
  if (leader) {
    int32_t* row = a.stats + a.k_fused * kStatsW;
    row[0] = executed;
    row[1] = changed ? 1 : 0;
    row[2] = reached;
    row[3] = skipped_total;
    row[4] = cond_flag(a, changed, executed, reached) ? 1 : 0;
  }
}

using KernelFn = void (*)(MegaArgs);

KernelFn kernel_for(int lanes) {
  return lanes == 4 ? megakernel<4> : megakernel<kMaxLanes>;
}

// Resident grid size of the kernel for `lanes` on this device, cached per
// device: 0 when the device cannot launch cooperatively or the kernel does
// not fit on an SM.
int resident_blocks(int lanes, int* out) {
  static int cached[64][2];
  static bool known[64][2];
  const int li = lanes == 4 ? 0 : 1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && known[dev][li]) {
    *out = cached[dev][li];
    return 0;
  }
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_for(lanes), kBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = coop ? per_sm * sms : 0;
  if (dev < 64) {
    cached[dev][li] = blocks;
    known[dev][li] = true;
  }
  *out = blocks;
  return 0;
}

}  // namespace

// The resident capacity (blocks) a launch over n rows and n_edges edges
// would use, or a negative CUDA error code. Lets the wrapper report the
// grid in its error message.
extern "C" int megakernel_resident_blocks(int n, int n_edges) {
  int blocks = 0;
  const int lanes = relax::lanes_per_row(n_edges, n, kPerLane, kMaxLanes);
  const int err = resident_blocks(lanes, &blocks);
  return err ? -err : blocks;
}

// Plain C entry point, loaded with ctypes. long_rows int32 [n_long]: each
// row with more than kLongRow in-edges, once. `scratch` is int32
// [13n + 4 n_long] (uninitialised), 16-byte aligned: the packed (d, rw0,
// c, pathw) records, the slots' records, the packed (rc, rp), the two
// worklists and the hub list. `zeroed` is int32 [(K + 1) x (kStatsW +
// kCountW) + 2 ceil(n / 32)], zero: the stats, the counts and the two
// bitmaps. Launches cooperatively on `stream` and returns the CUDA error
// (0 = success); the caller raises on anything else.
// cudaErrorCooperativeLaunchTooLarge is returned when the device cannot
// hold even one block resident per SM.
extern "C" int megakernel_launch(
    const void* row_ptr, const void* src, const void* w,
    const void* long_rows, const void* d_in,
    const void* c_in, const void* p_in, const void* front_in,
    const void* rw0, const void* rc, const void* rp, const void* frozen,
    const void* out_ptr, const void* out_dst, void* d, void* c, void* p,
    void* front, void* scratch, void* zeroed, int delta, int half_target,
    int num_it, int steps_base, int stop_variant, int n, int n_edges,
    int k_fused, int n_long, void* stream) {
  if (n < 0 || k_fused < 1 || n_edges < 0 || n_long < 0 || n_long > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = relax::lanes_per_row(n_edges, n, kPerLane, kMaxLanes);
  int capacity = 0;
  int err = resident_blocks(lanes, &capacity);
  if (err) return err;
  if (capacity <= 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int want = n > 0 ? (n + kBlock - 1) / kBlock : 1;
  const int blocks = want < capacity ? want : capacity;
  MegaArgs a;
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.src = static_cast<const int32_t*>(src);
  a.w = static_cast<const int32_t*>(w);
  a.long_rows = static_cast<const int32_t*>(long_rows);
  a.d_in = static_cast<const int32_t*>(d_in);
  a.c_in = static_cast<const int32_t*>(c_in);
  a.p_in = static_cast<const int32_t*>(p_in);
  a.front_in = static_cast<const uint8_t*>(front_in);
  a.rw0 = static_cast<const int32_t*>(rw0);
  a.rc = static_cast<const int32_t*>(rc);
  a.rp = static_cast<const int32_t*>(rp);
  a.frozen = static_cast<const uint8_t*>(frozen);
  a.out_ptr = static_cast<const int32_t*>(out_ptr);
  a.out_dst = static_cast<const int32_t*>(out_dst);
  a.d = static_cast<int32_t*>(d);
  a.c = static_cast<int32_t*>(c);
  a.p = static_cast<int32_t*>(p);
  a.front = static_cast<uint8_t*>(front);
  a.dc = static_cast<int4*>(scratch);
  a.cand = a.dc + n;
  a.rr = reinterpret_cast<int2*>(a.cand + n + n_long);
  a.work[0] = reinterpret_cast<int32_t*>(a.rr + n);
  a.work[1] = a.work[0] + n;
  a.hubs = a.work[1] + n;
  int32_t* z = static_cast<int32_t*>(zeroed);
  a.stats = z;
  a.counts = z + static_cast<int64_t>(k_fused + 1) * kStatsW;
  a.bitmap[0] = reinterpret_cast<uint32_t*>(
      z + static_cast<int64_t>(k_fused + 1) * (kStatsW + kCountW));
  a.bitmap[1] = a.bitmap[0] + (n + 31) / 32;
  a.delta = delta;
  a.half_target = half_target;
  a.num_it = num_it;
  a.steps_base = steps_base;
  a.stop_variant = stop_variant;
  a.n = n;
  a.k_fused = k_fused;
  a.n_long = n_long;
  a.n_edges = n_edges;
  void* args[] = {&a};
  err = static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel_for(lanes)), dim3(blocks),
      dim3(kBlock), args, 0, static_cast<cudaStream_t>(stream)));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
