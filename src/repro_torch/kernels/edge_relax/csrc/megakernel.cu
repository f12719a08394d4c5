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
//     pathw) tuple-min of edge_relax.cu (one thread per row over the
//     (dst, src)-sorted CSR), then the merge rule upd = !frozen & acc_d < d
//     (megakernel.py:205), compared on d only;
//   * the frontier bitmap front (1 where the row's tuple changed in the
//     previous superstep), carried in and out of the launch;
//   * one stats row per executed superstep (1, nodes changed, reached after
//     the merge, cumulative skipped rows, continue flag) and the summary row
//     K (supersteps executed, changed flag, reached, skipped rows, continue
//     flag), the column layout of megakernel.py:58-68. Rows of slots that
//     did not run stay 0.
//
// Design (right and simple first):
//   * One cooperative launch: grid = blocks resident per SM (occupancy API)
//     x SMs, capped at ceil(n / 256); threads grid-stride over rows.
//     cooperative_groups::this_grid().sync() separates supersteps. No thread
//     returns early: every thread reaches every grid.sync().
//   * Jacobi semantics by ping-pong planes. Superstep j reads set j % 2 and
//     writes set (j + 1) % 2, so every candidate of superstep j sees the
//     planes exactly as they stood after superstep j - 1 (the TPU kernel's
//     accumulate-then-merge). Phase 0 copies the input planes into set 0.
//     Superstep 0 writes every row of set 1; later supersteps write a row
//     only when it changes now or changed in the previous superstep (set
//     (j + 1) % 2 then holds the state of superstep j - 2, which differs from
//     that of j - 1 only on those rows). After the last superstep, if the
//     result sits in set 1, the rows updated in that superstep are copied
//     into set 0, so the output is always set 0.
//   * Grid-wide counts (nodes changed, reached, skipped) are block-reduced
//     and atomically added into that superstep's own scratch row; after the
//     barrier every block reads the same sums and takes the same stop
//     decision. `reached` is kept incrementally: d only decreases, so a
//     superstep adds exactly the updated rows that crossed below Δ.
//   * Planes written during the launch (d, c, pathw, front, dirty) are read
//     with ld.global.cg (L2, not the incoherent L1 / read-only path); planes
//     constant during the launch (CSRs, relay planes, frozen) with __ldg.
//
// Frontier skip (the unit is a destination ROW): a row is skipped when it
// is frozen (it never updates) or when none of its in-edge sources is on
// the frontier. Soundness (megakernel.py:29-35): a candidate of edge (u, v)
// depends only on u's (d, c, pathw), the relay planes and Δ, which are
// constant within a grow call except for u's tuple. If no source of row v
// changed in superstep j - 1, row v's candidates equal those of superstep
// j - 1, whose min was merged then, so it cannot update now. The frontier
// starts all-ones in each grow call. Skipped rows are counted in the stats'
// column 3; the plain version (megakernel.py's port) counts the same unit.
//
// The skip test costs one byte per row: a `dirty` byte plane (ping-pong)
// holds "some in-edge source is on the frontier". Phase 0 marks the
// out-neighbour rows of the carried frontier through the out-edge CSR
// (out_ptr, out_dst: the same edges ordered by (src, dst)); in superstep j
// the thread that updates row u marks u's out-neighbour rows dirty for
// superstep j + 1, and every thread clears the dirty byte of the row it
// reads, so the plane is all zero again when it is next marked. Marking is
// the exact transpose of the in-edge predicate, so the skipped rows are the
// same set the plain version computes from front[src]. Concurrent marks of
// one byte all store 1, a benign race.
//
// Bound (bytes over 3.35 TB/s; chip_smoke.py's mega_bytes is the one
// definition), per executed superstep: every row reads its frozen and
// dirty bytes; a row that runs reads row_ptr, src and w of its in-edges, d
// and rw0 of its sources, c/pathw (live) or rc/rp (relay) of the
// admissible ones, and its own d; a row that changes writes d, c, pathw,
// reads its out-edge list and writes the dirty bytes of its out-neighbours;
// every row writes its front byte. In a superstep where few rows run that
// is a few bytes per row (~8 MB at the road graph's n = 1,890,815, ~2.5 us),
// so the grid barrier and the per-row flag pass set the time.
//
// Known limit: like edge_relax.cu, one thread scans a hub's whole in-list
// (RMAT), and a hub that changes marks its whole out-list alone.
//
// Overflow: the candidate arithmetic is edge_relax.cu's (int32, exact as the
// reference). Counts are int32: n * K < 2^31 is checked by the wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kInf = 0x7fffffff;   // 2^31 - 1
constexpr int32_t kBig = 1 << 30;      // 2^30
constexpr int kThreads = 256;
constexpr int kStatsW = 8;             // STATS_W
constexpr int kScratchW = 4;           // (changed, reached delta, skipped, -)

struct MegaArgs {
  const int32_t* row_ptr;
  const int32_t* src;
  const int32_t* w;
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
  int32_t* d[2];
  int32_t* c[2];
  int32_t* p[2];
  uint8_t* f[2];
  uint8_t* dirty[2];  // zeroed by the caller
  int32_t* stats;     // [K + 1, kStatsW], zeroed by the caller
  int32_t* scratch;   // [K + 1, kScratchW], zeroed by the caller
  int32_t delta, half_target, num_it, steps_base, stop_variant, n, k_fused;
};

__device__ __forceinline__ int32_t ld_cg(const int32_t* ptr) {
  return __ldcg(ptr);
}

__device__ __forceinline__ bool ld_cg_flag(const uint8_t* ptr) {
  return __ldcg(ptr) != 0;
}

// Sum a, b, c over the block and add the sums into dst[0..2] (one atomic
// per value per block). Every thread of the block must call it.
__device__ void block_add3(int32_t a, int32_t b, int32_t c, int32_t* dst) {
  __shared__ int32_t sh[3][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = __reduce_add_sync(0xffffffffu, a);
  b = __reduce_add_sync(0xffffffffu, b);
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) {
    sh[0][warp] = a;
    sh[1][warp] = b;
    sh[2][warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (kThreads / 32);
    a = __reduce_add_sync(0xffffffffu, in ? sh[0][lane] : 0);
    b = __reduce_add_sync(0xffffffffu, in ? sh[1][lane] : 0);
    c = __reduce_add_sync(0xffffffffu, in ? sh[2][lane] : 0);
    if (lane == 0) {
      if (a) atomicAdd(dst + 0, a);
      if (b) atomicAdd(dst + 1, b);
      if (c) atomicAdd(dst + 2, c);
    }
  }
  __syncthreads();   // sh is reused by the next call
}

// Mark the out-neighbour rows of u dirty.
__device__ __forceinline__ void mark_out(const int32_t* __restrict__ out_ptr,
                                         const int32_t* __restrict__ out_dst,
                                         int64_t u, uint8_t* dirty) {
  const int32_t e1 = __ldg(out_ptr + u + 1);
  for (int32_t e = __ldg(out_ptr + u); e < e1; ++e)
    dirty[__ldg(out_dst + e)] = 1;
}

__device__ __forceinline__ bool cond_flag(const MegaArgs& a, bool changed,
                                          int32_t steps_done,
                                          int32_t reached) {
  return changed && (a.steps_base + steps_done < a.num_it) &&
         (a.stop_variant == 0 || reached < a.half_target);
}

__global__ void __launch_bounds__(kThreads)
megakernel(const MegaArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int32_t n = a.n;
  const int32_t delta = a.delta;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;

  // ---- phase 0: land the carried planes in set 0; reached on entry;
  //      the rows the carried frontier makes dirty ----------------------
  int32_t r0 = 0;
  for (int64_t v = tid; v < n; v += stride) {
    const int32_t dv = a.d_in[v];
    const uint8_t fv = a.front_in[v];
    a.d[0][v] = dv;
    a.c[0][v] = a.c_in[v];
    a.p[0][v] = a.p_in[v];
    a.f[0][v] = fv;
    r0 += (__ldg(a.frozen + v) == 0 && dv < delta);
    if (fv) mark_out(a.out_ptr, a.out_dst, v, a.dirty[0]);
  }
  block_add3(r0, 0, 0, a.scratch);
  grid.sync();

  int32_t reached = ld_cg(a.scratch);
  bool changed = true;
  int32_t executed = 0;
  int32_t skipped_total = 0;

  for (int32_t j = 0; j < a.k_fused; ++j) {
    // the stop rule, from grid-wide sums every block read after the barrier
    if (!cond_flag(a, changed, j, reached)) break;
    // selects, not a.d[j & 1]: an indexed parameter array goes to local memory
    const bool odd = j & 1;
    const int32_t* dc = odd ? a.d[1] : a.d[0];
    const int32_t* cc = odd ? a.c[1] : a.c[0];
    const int32_t* pc = odd ? a.p[1] : a.p[0];
    const uint8_t* fc = odd ? a.f[1] : a.f[0];
    int32_t* dn = odd ? a.d[0] : a.d[1];
    int32_t* cn = odd ? a.c[0] : a.c[1];
    int32_t* pn = odd ? a.p[0] : a.p[1];
    uint8_t* fn = odd ? a.f[0] : a.f[1];
    uint8_t* dirty_cur = odd ? a.dirty[1] : a.dirty[0];
    uint8_t* dirty_nxt = odd ? a.dirty[0] : a.dirty[1];
    int32_t n_changed = 0, reached_add = 0, n_skipped = 0;

    for (int64_t v = tid; v < n; v += stride) {
      const bool dirty = ld_cg_flag(dirty_cur + v);
      if (dirty) dirty_cur[v] = 0;   // all zero again before it is re-marked
      const bool run = dirty && __ldg(a.frozen + v) == 0;
      const bool was_front = ld_cg_flag(fc + v);
      if (!run && j > 0 && !was_front) {   // skipped, nothing to copy
        ++n_skipped;
        fn[v] = 0;
        continue;
      }
      const int32_t dv = ld_cg(dc + v);
      int32_t bd = kInf, bc = kInf, bp = kInf;
      if (run) {
        const int32_t e1 = __ldg(a.row_ptr + v + 1);
        for (int32_t e = __ldg(a.row_ptr + v); e < e1; ++e) {
          const int32_t u = __ldg(a.src + e);
          const int32_t we = __ldg(a.w + e);
          const int32_t ds = ld_cg(dc + u);
          const int32_t r0u = __ldg(a.rw0 + u);
          const bool live_ok = (ds < delta) && (we < delta);
          int32_t w_red = we + (r0u >= kBig ? kBig : r0u);
          w_red = w_red < 0 ? 0 : w_red;
          const bool relay_ok = (r0u < kBig) && (w_red < delta);
          if (!relay_ok && !live_ok) continue;
          int32_t cd, ccand, pb;
          if (relay_ok) {
            cd = w_red;
            ccand = __ldg(a.rc + u);
            pb = __ldg(a.rp + u);
          } else {
            cd = ds + we;
            ccand = ld_cg(cc + u);
            pb = ld_cg(pc + u);
          }
          const int32_t cp = (pb >= kBig ? 0 : pb) + we;
          if (cd < bd || (cd == bd && (ccand < bc ||
                                       (ccand == bc && cp < bp)))) {
            bd = cd;
            bc = ccand;
            bp = cp;
          }
        }
      } else {
        ++n_skipped;
      }
      const bool upd = run && bd < dv;   // run implies !frozen
      if (upd) {
        dn[v] = bd;
        cn[v] = bc;
        pn[v] = bp;
        ++n_changed;
        reached_add += (dv >= delta && bd < delta);
        mark_out(a.out_ptr, a.out_dst, v, dirty_nxt);
      } else if (j == 0 || was_front) {
        dn[v] = dv;
        cn[v] = ld_cg(cc + v);
        pn[v] = ld_cg(pc + v);
      }
      fn[v] = upd ? 1 : 0;
    }

    int32_t* red = a.scratch + (j + 1) * kScratchW;
    block_add3(n_changed, reached_add, n_skipped, red);
    grid.sync();
    const int32_t nc = ld_cg(red + 0);
    reached += ld_cg(red + 1);
    skipped_total += ld_cg(red + 2);
    changed = nc > 0;
    executed = j + 1;
    if (leader) {
      int32_t* row = a.stats + j * kStatsW;
      row[0] = 1;
      row[1] = nc;
      row[2] = reached;
      row[3] = skipped_total;
      row[4] = cond_flag(a, changed, executed, reached) ? 1 : 0;
    }
  }

  // ---- the result into set 0 --------------------------------------------
  if (executed & 1) {
    for (int64_t v = tid; v < n; v += stride) {
      const bool fv = ld_cg_flag(a.f[1] + v);
      if (fv) {
        a.d[0][v] = ld_cg(a.d[1] + v);
        a.c[0][v] = ld_cg(a.c[1] + v);
        a.p[0][v] = ld_cg(a.p[1] + v);
      }
      a.f[0][v] = fv ? 1 : 0;
    }
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

// Resident grid size for this device, cached per device: 0 when the device
// cannot launch cooperatively or the kernel does not fit on an SM.
int resident_blocks(int* out) {
  static int cached[64];
  static bool known[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && known[dev]) {
    *out = cached[dev];
    return 0;
  }
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, megakernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = coop ? per_sm * sms : 0;
  if (dev < 64) {
    cached[dev] = blocks;
    known[dev] = true;
  }
  *out = blocks;
  return 0;
}

}  // namespace

// The resident capacity the launch would use (blocks), or a negative CUDA
// error code. Lets the wrapper report the grid in its error message.
extern "C" int megakernel_resident_blocks() {
  int blocks = 0;
  const int err = resident_blocks(&blocks);
  return err ? -err : blocks;
}

// Plain C entry point, loaded with ctypes. Launches cooperatively on
// `stream` and returns the CUDA error (0 = success); the caller raises on
// anything else. cudaErrorCooperativeLaunchTooLarge is returned when the
// device cannot hold even one block resident per SM.
extern "C" int megakernel_launch(
    const void* row_ptr, const void* src, const void* w, const void* d_in,
    const void* c_in, const void* p_in, const void* front_in,
    const void* rw0, const void* rc, const void* rp, const void* frozen,
    const void* out_ptr, const void* out_dst, void* d0, void* c0, void* p0,
    void* f0, void* d1, void* c1, void* p1, void* f1, void* dirty0,
    void* dirty1, void* stats, void* scratch, int delta, int half_target,
    int num_it, int steps_base, int stop_variant, int n, int k_fused,
    void* stream) {
  int capacity = 0;
  int err = resident_blocks(&capacity);
  if (err) return err;
  if (capacity <= 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int want = (n + kThreads - 1) / kThreads;
  const int blocks = want < 1 ? 1 : (want < capacity ? want : capacity);
  MegaArgs a;
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.src = static_cast<const int32_t*>(src);
  a.w = static_cast<const int32_t*>(w);
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
  a.dirty[0] = static_cast<uint8_t*>(dirty0);
  a.dirty[1] = static_cast<uint8_t*>(dirty1);
  a.d[0] = static_cast<int32_t*>(d0);
  a.c[0] = static_cast<int32_t*>(c0);
  a.p[0] = static_cast<int32_t*>(p0);
  a.f[0] = static_cast<uint8_t*>(f0);
  a.d[1] = static_cast<int32_t*>(d1);
  a.c[1] = static_cast<int32_t*>(c1);
  a.p[1] = static_cast<int32_t*>(p1);
  a.f[1] = static_cast<uint8_t*>(f1);
  a.stats = static_cast<int32_t*>(stats);
  a.scratch = static_cast<int32_t*>(scratch);
  a.delta = delta;
  a.half_target = half_target;
  a.num_it = num_it;
  a.steps_base = steps_base;
  a.stop_variant = stop_variant;
  a.n = n;
  a.k_fused = k_fused;
  void* args[] = {&a};
  err = static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(megakernel), dim3(blocks), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream)));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
