// Online-softmax attention forward (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, line 36; entry flash_attention_pallas). It computes the
// same function: o = softmax(mask(softcap(scale * q k^T))) v over
// q [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D], with
//   * GQA: query head h reads kv head h / (Hq / Hkv);
//   * causal masking at global query position q_offset + i (q_offset is a
//     device scalar, read by the kernel);
//   * a sliding window: keys in (qpos - window, qpos] (window 0 = full);
//   * a logit softcap: cap * tanh(s / cap) (cap 0 = off);
//   * a device kv_len, [1] or one per batch row: keys at or past it are
//     masked;
//   * a row with no valid key emits 0, not NaN (kernel.py:110-114).
// The score is scaled after the q.k product, in float32, as the plain
// version does (ref.py:40); the TPU kernel scaled q first (kernel.py:79).
//
// Two kernels, chosen by the input type:
//   * flash_fwd_wgmma<D> (bf16, D in {16, 32, 64, 128, 256}): Hopper's
//     warpgroup tensor-core products (wgmma, bf16 in, float32 sums) fed by
//     the Tensor Memory Accelerator (TMA), in a warp-specialised block of
//     three warpgroups (384 threads) per (b, hq, 128-row q tile):
//       - warpgroup 0, the producer, gives up registers (setmaxnreg 24);
//         one of its threads issues every copy: the q tile once, then the
//         K and V tiles of kBK = 64 keys through a ring of kStages = 2
//         stages in dynamic shared memory, each stage guarded by a "full"
//         mbarrier (TMA's transaction bytes) and an "empty" one (one
//         arrival per consumer warp);
//       - warpgroups 1 and 2, the consumers, take registers (setmaxnreg
//         240) and own 64 query rows each. Per kv tile: S = Q K^T by
//         wgmma m64n64k16 with both operands in shared memory (K-major:
//         D is contiguous in both); the online softmax on the float32
//         accumulator registers; P rounded to bf16 in registers as the A
//         operand of O += P V (wgmma m64nDk16, V from shared memory
//         through the descriptor's transpose); the 64 x D float32 output
//         accumulator (128 registers a thread at D = 256) never leaves
//         registers until the end. Each consumer pipelines its tiles: the
//         scores of tile t are issued together with P V of tile t - 1, and
//         tile t's softmax runs while that product finishes.
//     The softmax works in the base-2 domain on the raw scores: the row
//     maximum is taken over the raw q.k (scale and softcap are increasing,
//     so the maximum's image is the images' maximum), and each entry costs
//     one fused multiply-add and one ex2 without a softcap (with one, an
//     ex2 and a fast divide more: cap tanh(y) = cap (1 - 2 / (e^{2y} + 1))).
//     Only a tile that a mask cuts (a causal diagonal, a window's edge,
//     kv_len) tests each entry, and a masked entry gets p = 0 explicitly
//     (a live tile may hold a fully masked row, whose exp(s - m) would be
//     1, kernel.py:98). The fast ex2 and divide err far below bf16.
//     The TMA tensor maps are 4-d, [B, H, S, D] with the caller's strides
//     (the model passes [B, S, H, D] projections seen as [B, H, S, D]
//     views), built on the host per launch (cuTensorMapEncodeTiled); keys
//     past Skv and q rows past Sq are zero-filled by the hardware, never
//     read from the next head. Tiles are stored in the 128-byte swizzle
//     (64-byte at D = 32, 32-byte at D = 16) that the wgmma descriptors
//     name, in panels of 64 columns. Shared memory at D = 256: Q 64 KB +
//     2 x (32 + 32) KB = 192 KB. The TPU's sequential kv grid axis becomes
//     the loop over the kv tiles that hold an unmasked entry of the block
//     (the skip rule of kernel.py:67-76 as a loop range); both consumers
//     take each of them. The q tiles with the most keys under a causal
//     mask (the last ones) are scheduled first, which shortens the grid's
//     tail.
//   * flash_fwd_rows (float32, any D <= 256 that is a multiple of 8): one
//     warp per query row, visiting exactly the row's unmasked keys, in
//     float32 throughout. It keeps the float32 path exact enough for the
//     tests (no bf16 rounding of P). bf16 at another D is refused.
//
// Bound (operations over the tensor cores' 989 TFLOP/s, chip_smoke.py
// computes it from the run's shapes): 4 * D flops per unmasked (q, k) pair
// and query head. At gemma2-9b's prefill (Hq 16, D 256, S 8192) a global
// layer has 33,558,528 unmasked pairs per head (550 GFLOP, 0.556 ms) and a
// local layer (window 4096) 25,167,872 (412 GFLOP, 0.417 ms); reading
// q, k, v and writing o once is 0.2 GB (0.060 ms). Streaming K and V
// (64 KB a tile at D = 256) from L2 into each 128-row block moves 4.4 GB
// at a global layer; with the products and the softmax overlapped, those
// two and the copies are what is left to balance.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 128;       // query rows per block (64 per consumer)
constexpr int kBK = 64;        // keys per kv tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kWgThreads = 384;  // producer + two consumer warpgroups
constexpr int kRowWarps = 8;   // warps (= query rows) per block of the row kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* kv_len;
  int kv_len_stride;           // 1: one per batch row; 0: one for all
  const int32_t* q_offset;
  int Hq, Hkv, Sq, Skv, D;
  long long q_sb, q_sh, q_ss;  // element strides (the d stride is 1)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window;
  float softcap, scale;
  float inv_softcap;           // 1 / softcap (0 when off)
};

// The TMA descriptors of q, k and v: kernel parameters (__grid_constant__),
// so that the copy engine reads them from parameter space.
struct Maps {
  CUtensorMap q, k, v;
};

__device__ __forceinline__ int valid_kv(const Params& p, int b) {
  return min(max(p.kv_len[b * p.kv_len_stride], 0), p.Skv);
}

// Keys [lo, hi) hold every unmasked key of the query positions
// [q_first, q_last].
__device__ __forceinline__ void key_range(const Params& p, int kvl,
                                          int q_first, int q_last, int* lo,
                                          int* hi) {
  int h = kvl;
  if (p.causal) h = min(h, q_last + 1);
  *hi = h;
  *lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
}

__device__ __forceinline__ bool unmasked(const Params& p, int kvl, int qpos,
                                         int kpos) {
  return kpos < kvl && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

__device__ __forceinline__ float cap_score(const Params& p, float dot) {
  float s = dot * p.scale;
  if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- mbarriers, TMA and wgmma (PTX) -----------------------------------------

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

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode (0 none, 1 128-byte,
// 2 64-byte, 3 32-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(mode) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the registers across
// the asynchronous products (their asm statements order these).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d += A B, m64n64k16: bf16 in, float32 sums; A and B from shared memory
// (descriptors), both K-major. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n16k16: bf16 in, float32 sums; A from registers, B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d += A B, m64n32k16: bf16 in, float32 sums; A from registers, B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d += A B, m64n64k16: bf16 in, float32 sums; A from registers, B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d += A B, m64n128k16: bf16 in, float32 sums; A from registers, B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d += A B, m64n256k16: bf16 in, float32 sums; A from registers, B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


// Shared-memory tile geometry at head dim D. A tile row is stored in
// panels of 64 columns (128 bytes: the 128-byte swizzle), or whole when
// D < 64 (64- or 32-byte swizzle). Layout: Q [kBQ rows], then per stage
// K and V [kBK rows each], then the mbarriers; every tile starts on a
// 1024-byte boundary, as the swizzle's period requires.
template <int D>
struct Tile {
  static constexpr int RB = D * 2 < 128 ? D * 2 : 128;  // panel row bytes
  static constexpr int COLS = RB / 2;                   // columns per panel
  static constexpr int NP = D / COLS;                   // panels per row
  static constexpr uint32_t MODE = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = kBK * D * 2;
  static constexpr int BAR_BYTES = 8 * (2 * kStages + 1);
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * kStages * KV_BYTES +
                              BAR_BYTES;
};


// The mask and position facts of one consumer's rows that the softmax of
// a tile reads.
struct Rows {
  int q_first, q_last;  // the consumer's first and last live query positions
  int qp0, qp1;         // this thread's two rows' positions
  int kvl;              // valid keys of the batch row
  int t4;               // lane % 4: the thread's column pair in a chunk
  float c1;             // log2(e) scale
  float c2;             // 2 log2(e) scale / cap (softcap)
  float c3;             // log2(e) cap (softcap)
};

// S = Q K^T of one kv tile, over D in steps of 16 (32 bytes of a panel
// row): 64 rows of this consumer's Q against the tile's 64 keys.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[32], uint64_t dq,
                                             uint64_t dk) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int pn = kk * 16 / T::COLS, col = kk * 16 % T::COLS;
    const uint32_t offq = pn * kBQ * T::RB + col * 2;
    const uint32_t offk = pn * kBK * T::RB + col * 2;
    wgmma_ss(sc, dq + (offq >> 4), dk + (offk >> 4), kk > 0);
  }
}

// O += P V over the tile's keys in steps of 16 (16 rows of V); o holds
// D / 2 accumulators a thread.
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N],
                                         const uint32_t (&pa)[4][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs(o, pa[kk], dv + ((kk * 16 * Tile<2 * N>::RB) >> 4), 1);
}

// base-2 exponential on the special function unit (-1e30 gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A raw score q.k in the base-2 domain of the softmax: log2(e) times the
// scaled (and, with CAP, softcapped) score. The softcap is
// cap tanh(y) = cap (1 - 2 / (e^{2y} + 1)), y = scale q.k / cap, with the
// fast exponential and divide (e^{2y} = inf gives cap, 0 gives -cap).
template <bool CAP>
__device__ __forceinline__ float score2(const Rows& rw, float dot) {
  if (!CAP) return dot * rw.c1;
  return rw.c3 - __fdividef(2.f * rw.c3, ex2(dot * rw.c2) + 1.f);
}

// The online softmax of one tile, on the raw scores in sc: the row maxima
// (of the raw scores: scale and softcap are increasing, so the maximum's
// image is the images' maximum), the running max m and sum l (in the
// base-2 domain), the factor alpha that rescales O, and the probabilities P
// left in sc. On an EDGE tile (one a mask cuts) each entry is tested and a
// masked one gets p = 0 explicitly (a live tile may hold a fully masked
// row, kernel.py:98); no other tile tests anything.
template <bool EDGE, bool CAP>
__device__ __forceinline__ void softmax_tile(const Params& p, const Rows& rw,
                                             float (&sc)[32], int k0,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0,
                                             float& alpha1) {
  float mt0 = kNegInf, mt1 = kNegInf;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (EDGE) {
      const int kpos = k0 + 8 * (i / 4) + 2 * rw.t4 + (i & 1);
      if (!unmasked(p, rw.kvl, (i & 2) ? rw.qp1 : rw.qp0, kpos))
        sc[i] = kNegInf;
    }
    if (i & 2) mt1 = fmaxf(mt1, sc[i]);
    else mt0 = fmaxf(mt0, sc[i]);
  }
  mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffff, mt0, 1));
  mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffff, mt0, 2));
  mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffff, mt1, 1));
  mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffff, mt1, 2));
  const float mn0 = fmaxf(m0, mt0 == kNegInf ? kNegInf : score2<CAP>(rw, mt0));
  const float mn1 = fmaxf(m1, mt1 == kNegInf ? kNegInf : score2<CAP>(rw, mt1));
  alpha0 = ex2(m0 - mn0);
  alpha1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float pe = ex2(score2<CAP>(rw, sc[i]) - ((i & 2) ? mn1 : mn0));
    if (EDGE && sc[i] == kNegInf) pe = 0.f;
    sc[i] = pe;
    if (i & 2) ls1 += pe;
    else ls0 += pe;
  }
  l0 = l0 * alpha0 + ls0;  // this thread's share of the row sum
  l1 = l1 * alpha1 + ls1;
}

// P rounded to bf16 as the A operand of P V: accumulator chunks 2kk and
// 2kk + 1 are the operand of keys 16kk .. 16kk + 15.
__device__ __forceinline__ void pack_p(const float (&sc)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j / 2][2 * (j & 1)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[j / 2][2 * (j & 1) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// Fragment layout of the wgmma accumulator (warp w of the warpgroup, lane
// l, g = l / 4, t = l % 4): element 4j + e of a thread is row 16w + g
// (e < 2) or 16w + g + 8 (e >= 2) and column 8j + 2t + (e & 1). The A
// operand from registers takes a 16 x 16 bf16 slice per warp as
// a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]:
// so the scores of columns 16kk .. 16kk+15 (accumulator chunks 2kk and
// 2kk+1) are the A operand of keys 16kk .. 16kk+15 of P V.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ Params p,
                const __grid_constant__ Maps maps) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + T::Q_BYTES;  // stage s: K, then V
  const uint32_t bars = sKV + 2 * kStages * T::KV_BYTES;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kStages + s), q = qbar
  const uint32_t qbar = bars + 16 * kStages;

  // the last q tiles (the most keys under a causal mask) are scheduled first
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_off = *p.q_offset;
  const int kvl = valid_kv(p, b);
  int k_lo, k_hi;  // the block's keys: every tile the producer loads
  key_range(p, kvl, q_off + q0, q_off + min(q0 + kBQ, p.Sq) - 1, &k_lo,
            &k_hi);
  const int k_begin = (k_lo / kBK) * kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), 8);  // one per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && k_begin < k_hi) {
      mbar_expect_tx(qbar, T::Q_BYTES);
      for (int pn = 0; pn < T::NP; ++pn)
        tma_load_4d(sQ + pn * kBQ * T::RB, &maps.q, pn * T::COLS, q0, h, b,
                    qbar);
      int t = 0;
      for (int k0 = k_begin; k0 < k_hi; k0 += kBK, ++t) {
        const int s = t % kStages;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (kStages + s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * T::KV_BYTES);
        const uint32_t sK = sKV + 2 * s * T::KV_BYTES;
        const uint32_t sV = sK + T::KV_BYTES;
        for (int pn = 0; pn < T::NP; ++pn) {
          tma_load_4d(sK + pn * kBK * T::RB, &maps.k, pn * T::COLS, k0, hk,
                      b, full);
          tma_load_4d(sV + pn * kBK * T::RB, &maps.v, pn * T::COLS, k0, hk,
                      b, full);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int c0 = q0 + 64 * c;           // this consumer's first row
    const int rows = min(64, p.Sq - c0);  // may be <= 0 (a ragged last tile)
    const int r0 = 16 * warp + g;         // this thread's rows: r0 and r0 + 8
    Rows rw;
    rw.q_first = q_off + c0;
    rw.q_last = rw.q_first + rows - 1;
    rw.qp0 = rw.q_first + r0;
    rw.qp1 = rw.qp0 + 8;
    rw.kvl = kvl;
    rw.t4 = t4;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    constexpr float kLog2e = 1.4426950408889634f;
    rw.c1 = p.scale * kLog2e;
    rw.c2 = p.softcap > 0.f ? 2.f * p.scale * kLog2e * p.inv_softcap : 0.f;
    rw.c3 = p.softcap * kLog2e;
    const bool cap = p.softcap > 0.f;
    // a tile that a mask cuts for some row of this consumer
    auto softmax = [&](float (&s)[32], int k0, float& a0, float& a1) {
      const bool edge = !(k0 + kBK <= kvl &&
                          (!p.causal || k0 + kBK - 1 <= rw.q_first) &&
                          (p.window <= 0 || rw.q_last - k0 < p.window));
      if (edge) {
        if (cap) softmax_tile<true, true>(p, rw, s, k0, m0, m1, l0, l1, a0, a1);
        else softmax_tile<true, false>(p, rw, s, k0, m0, m1, l0, l1, a0, a1);
      } else {
        if (cap) softmax_tile<false, true>(p, rw, s, k0, m0, m1, l0, l1, a0, a1);
        else softmax_tile<false, false>(p, rw, s, k0, m0, m1, l0, l1, a0, a1);
      }
    };
    // the block's kv tiles are t = 0 .. n_tiles - 1 (keys k_begin + 64 t ..);
    // both consumers take every one (a tile that none of a consumer's rows
    // sees, at a causal diagonal or a window's edge, gives p = 0 there)
    const int n_tiles = k_begin < k_hi ? (k_hi - k_begin + kBK - 1) / kBK : 0;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    const uint64_t dq = smem_desc(sQ + 64 * c * T::RB, 16, 8 * T::RB, T::MODE);
    auto wait_full = [&](int t) {
      mbar_wait(bars + 8 * (t % kStages), (t / kStages) & 1);
    };
    auto release = [&](int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + t % kStages));
    };
    auto k_desc = [&](int t) {
      return smem_desc(sKV + 2 * (t % kStages) * T::KV_BYTES, 16, 8 * T::RB,
                       T::MODE);
    };
    auto v_desc = [&](int t) {
      return smem_desc(sKV + (2 * (t % kStages) + 1) * T::KV_BYTES,
                       kBK * T::RB, 8 * T::RB, T::MODE);
    };
    if (n_tiles > 0) {
      // Software pipeline: the scores of tile t are computed while the
      // tensor cores add P V of tile t - 1, and tile t's softmax runs
      // while that product finishes. O is rescaled to tile t - 1's maximum
      // just before P V of tile t - 1 is issued.
      float sc[32];
      uint32_t pa[4][4];
      float alpha0, alpha1;
      mbar_wait(qbar, 0);
      wait_full(0);
      reg_fence(sc);
      wgmma_fence();
      issue_scores<D>(sc, dq, k_desc(0));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      softmax(sc, k_begin, alpha0, alpha1);
      pack_p(sc, pa);
      for (int t = 1; t < n_tiles; ++t) {
        wait_full(t);
        rescale(o, alpha0, alpha1);
          reg_fence(sc);
        reg_fence(o);
        wgmma_fence();
        issue_scores<D>(sc, dq, k_desc(t));
        wgmma_commit();
        issue_pv(o, pa, v_desc(t - 1));
        wgmma_commit();
          wgmma_wait<1>();  // the scores of tile t
        reg_fence(sc);
        softmax(sc, k_begin + t * kBK, alpha0, alpha1);
        wgmma_wait<0>();  // P V of tile t - 1
        reg_fence(o);
        release(t - 1);
        pack_p(sc, pa);
      }
      rescale(o, alpha0, alpha1);
      reg_fence(o);
      wgmma_fence();
      issue_pv(o, pa, v_desc(n_tiles - 1));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      release(n_tiles - 1);
    }

    l0 += __shfl_xor_sync(0xffffffff, l0, 1);
    l0 += __shfl_xor_sync(0xffffffff, l0, 2);
    l1 += __shfl_xor_sync(0xffffffff, l1, 1);
    l1 += __shfl_xor_sync(0xffffffff, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f;  // l = 0: no valid key, o = 0
    const float inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
    auto* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (r0 < rows)
        *reinterpret_cast<uint32_t*>(og + (c0 + r0) * p.o_ss + col) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r0 + 8 < rows)
        *reinterpret_cast<uint32_t*>(og + (c0 + r0 + 8) * p.o_ss + col) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// One warp per query row; lane l holds dims l, l + 32, ... (D <= 256).
__global__ void __launch_bounds__(kRowWarps * 32)
flash_fwd_rows(const Params p) {
  constexpr int MAXC = 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= p.Sq) return;  // whole warps only; no block barrier follows
  const int hk = h / (p.Hq / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + row * p.q_ss;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;

  const int qpos = *p.q_offset + row;
  int k_lo, k_hi;
  key_range(p, valid_kv(p, b), qpos, qpos, &k_lo, &k_hi);
  float qv[MAXC], acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int d = lane + 32 * c;
    qv[c] = d < p.D ? qg[d] : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  for (int kpos = k_lo; kpos < k_hi; ++kpos) {  // every key here is unmasked
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D) part += qv[c] * kg[kpos * p.k_ss + d];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffff, part, off);
    const float s = cap_score(p, part);
    const float mn = fmaxf(m, s);
    const float alpha = expf(m - mn), pe = expf(s - mn);
    l = l * alpha + pe;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D) acc[c] = acc[c] * alpha + pe * vg[kpos * p.v_ss + d];
    }
    m = mn;
  }
  const float inv = l > 0.f ? 1.f / l : 1.f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int d = lane + 32 * c;
    if (d < p.D) og[d] = acc[c] * inv;
  }
}

// A 4-d TMA map of a [B, H, S, D] bf16 tensor with element strides
// (sb, sh, ss) and a unit d stride (innermost first: d, s, h, b), in boxes
// of `rows` rows by one panel of columns, swizzled as Tile<D> stores them.
// Rows past S are zero-filled by the hardware.
CUresult encode_map(CUtensorMap* map, const void* ptr, int B, int H, int S,
                    int D, long long sb, long long sh, long long ss,
                    int rows) {
  const int rb = D * 2 < 128 ? D * 2 : 128;
  // the stride of an extent-1 dimension is never used, but the encoder
  // wants a multiple of 16 bytes: give it the packed one
  const cuuint64_t st_s = S > 1 ? ss * 2 : D * 2;
  const cuuint64_t st_h = H > 1 ? sh * 2 : st_s * S;
  const cuuint64_t st_b = B > 1 ? sb * 2 : st_h * H;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(S),
                        static_cast<cuuint64_t>(H),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {st_s, st_h, st_b};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(rb / 2),
                       static_cast<cuuint32_t>(rows), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B);
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                const_cast<void*>(ptr), dims, strides, box,
                                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
cudaError_t launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  Maps maps;
  // Skv = 0 leaves no key to load; k and v then get a valid map of one row
  // of q that is never read
  const bool no_kv = p.Skv == 0;
  const void* kp = no_kv ? p.q : p.k;
  const void* vp = no_kv ? p.q : p.v;
  const int skv = no_kv ? 1 : p.Skv;
  if (encode_map(&maps.q, p.q, B, p.Hq, p.Sq, D, p.q_sb, p.q_sh, p.q_ss,
                 kBQ) != CUDA_SUCCESS ||
      encode_map(&maps.k, kp, B, p.Hkv, skv, D, no_kv ? p.q_sb : p.k_sb,
                 no_kv ? p.q_sh : p.k_sh, no_kv ? p.q_ss : p.k_ss,
                 kBK) != CUDA_SUCCESS ||
      encode_map(&maps.v, vp, B, p.Hkv, skv, D, no_kv ? p.q_sb : p.v_sb,
                 no_kv ? p.q_sh : p.v_sh, no_kv ? p.q_ss : p.v_ss,
                 kBK) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  constexpr int smem = Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  flash_fwd_wgmma<D><<<grid, kWgThreads, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

cudaError_t launch_rows(const Params& p, int B, cudaStream_t stream) {
  dim3 grid((p.Sq + kRowWarps - 1) / kRowWarps, p.Hq, B);
  flash_fwd_rows<<<grid, kRowWarps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = float32. strides: 12 element strides, (b, h, s) of
// q, k, v and o in that order; the d stride is 1. Returns the CUDA error of
// the launch (0 on success; a tensor map the driver refuses gives
// cudaErrorInvalidValue). The wrapper (kernel.py) checks shapes, types,
// alignment and devices before calling.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    const int32_t* kv_len, int kv_len_stride, const int32_t* q_offset,
    int B, int Hq, int Hkv, int Sq, int Skv, int D,
    const long long* strides, int causal, int window, float softcap,
    float scale, int dtype, void* stream_ptr) {
  if (Sq == 0 || B == 0 || Hq == 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_len = kv_len;
  p.kv_len_stride = kv_len_stride;
  p.q_offset = q_offset;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.inv_softcap = softcap > 0.f ? 1.f / softcap : 0.f;
  p.scale = scale;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 1) return static_cast<int>(launch_rows(p, B, stream));
  switch (D) {
    case 16: return static_cast<int>(launch_wgmma<16>(p, B, stream));
    case 32: return static_cast<int>(launch_wgmma<32>(p, B, stream));
    case 64: return static_cast<int>(launch_wgmma<64>(p, B, stream));
    case 128: return static_cast<int>(launch_wgmma<128>(p, B, stream));
    case 256: return static_cast<int>(launch_wgmma<256>(p, B, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
