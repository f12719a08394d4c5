// Online-softmax attention forward (flash attention) for Hopper (sm_90a),
// with its log-sum-exp, and the backward (at the end of the file).
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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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
  float* lse;                  // [B, Hq, Sq] m + log(l), natural log; or null
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
    if (p.lse != nullptr && t4 == 0) {
      // m is kept in log2 units: lse = ln 2 (m + log2 l); a row with no
      // valid key gets the reference's m = NEG_INF, l -> 1
      float* lg = p.lse + (static_cast<long long>(b) * p.Hq + h) * p.Sq + c0;
      if (r0 < rows) lg[r0] = l0 > 0.f ? kLn2 * (m0 + log2f(l0)) : kNegInf;
      if (r0 + 8 < rows)
        lg[r0 + 8] = l1 > 0.f ? kLn2 * (m1 + log2f(l1)) : kNegInf;
    }
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
  if (p.lse != nullptr && lane == 0)
    p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row] =
        l > 0.f ? m + logf(l) : kNegInf;
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


// ---------------------------------------------------------------------------
// The backward (no TPU kernel: the reference trains through attention_mef's
// custom VJP in jnp, src/repro/kernels/flash_attention/ops.py:189-245,
// which recomputes each kv block from the residuals (q, k, v, o, lse)).
// Three launches, no atomics, so two backward calls are bit-equal:
//   * flash_bwd_delta: delta = rowsum(dO . O) and lse in log2 units, float32
//     [B, Hq, Sqp] (rows padded with zeros to a multiple of kRowPad, so that
//     a block's rows are one aligned bulk copy);
//   * flash_bwd_dkdv_wgmma<D>: a block per (key tile, b, kv head) walks the
//     64-row query tiles that the mask lets see its keys, for each of the
//     group's query heads (the GQA sum stays in registers), the tiles with
//     the most queries (the first, under a causal mask) scheduled first;
//   * flash_bwd_dq_wgmma<D, NC>: a block per (query tile, b, q head) walks
//     the 64-key tiles of its rows (the forward's range), the last query
//     tiles first, and recomputes S and dP there: 14 D flops a pair against
//     the useful 10 D. That is the price of no atomics (float32 atomicAdd
//     into a dQ sum would break bit-equality; a dS written to memory and
//     read back would move up to 0.5 GB each way a call at B 1).
// Both are built as the forward is. Warpgroup 0, the producer, gives up
// registers; one of its threads issues every copy: the tiles the block
// keeps (K and V; Q and dO) once, the streamed tiles through a ring of
// stages guarded by "full" (TMA's transaction bytes) and "empty" (one
// arrival per consumer warp) mbarriers, from 4-d [B, H, S, D] tensor maps
// over the caller's strides, in the 128-byte swizzle the wgmma descriptors
// name (rows past S zero-filled by the hardware); the rows' lse and delta
// by 1-d bulk copies. The consumer warpgroups multiply with wgmma (bf16 in,
// float32 sums): S^T = K Q^T and dP^T = V dO^T (dK/dV), S = Q K^T and dP =
// dO V^T (dQ) as m64n64k16 with both operands in shared memory; dV += P^T
// dO, dK += dS^T Q and dQ += dS K as m64nDk16 with the A operand (P or dS
// rounded to bf16) in registers and B read through the descriptor's
// transpose, as the forward's P V.
//   * dK/dV at D = 128: a 128-key tile, each consumer owns 64 keys with
//     both float32 sums in registers (64 + 64 a thread); Q, dO, lse and
//     delta stream through a ring of 4 stages (195 KB of shared memory).
//   * dK/dV at D = 256: one warpgroup's dK and dV would take 256 registers
//     a thread, so the two consumers share a 64-key tile. Consumer 0
//     computes S^T, P and dV += P^T dO and hands P times the softcap's
//     factor (float32, 16 KB) to consumer 1 through shared memory under two
//     mbarriers; consumer 1 computes dP^T, dS and dK += dS^T Q. No product
//     is done twice. K, V 64 KB + 2 stages of 64 KB + 16 KB = 210 KB.
//   * dQ: 64 query rows a consumer, dQ's sums (D / 2 a thread) in
//     registers; at D = 128 two consumers and 4 K/V stages (194 KB), at
//     D = 256 one consumer and 2 stages (194 KB; Q and dO of 128 rows would
//     leave room for one stage).
// The order of a consumer's products follows the ring's depth. With 4
// stages (dQ at D = 128) a consumer issues S and dP of tile t together with
// dQ += dS K of tile t - 1 and forms dS of tile t while that product runs.
// With 2 stages (every launch at D = 256), and where registers are short
// (dK/dV at D = 128), it issues tile t's last products at the end of tile
// t, waits for them at the start of tile t + 1 and releases tile t's stage
// there, so that the producer has a whole tile's time to bring in tile
// t + 2: holding a stage into the next tile, as the 4-stage order does,
// leaves the copies of a 2-stage ring exposed, and on the card the D-256
// launches were markedly slower that way. There the two consumers of a
// block overlap each other's products and element-wise work; dQ's one
// consumer at D = 256 does not. A tile that no mask cuts (most of them)
// tests no element.
// Numerics: P and dS in float32 from the float32 score and dP, rounded to
// bf16 only where they become an operand; float32 sums; dK and dQ take the
// score's scale at the end, in float32.
// Bound (operations, chip_smoke.py computes it): the backward's useful work
// is 2.5 times the forward's, 10 D flops per unmasked pair and query head.
// The mma.sync version this replaces was held back by shared memory: each
// warp loaded its operands by ldmatrix, about 690 KB a 64 x 64 tile at
// D = 256 (5,400 cycles at 128 bytes a cycle) for 2,048 cycles of
// products. wgmma reads a shared operand once per warpgroup, about 210 KB
// a tile, under the products' time; then the recomputed products, the
// special function unit (with the softcap, three ex2 or divides a pair)
// and dQ's one consumer at D = 256 (its element-wise work overlaps no
// product) are what is left.

constexpr int kBR = 64;       // rows of a streamed tile: the queries of a
                              // dK/dV stage, the keys of a dQ stage
constexpr int kRowPad = 128;  // lse2 and delta rows: a multiple of this

struct BwdParams {
  const void *q, *k, *v;                // for the tensor maps (host side)
  const __nv_bfloat16 *o, *dout;
  const float* lse;
  float* lse2;                   // [B, Hq, Sqp]: lse log2(e), 0 past Sq
  float* delta;                  // [B, Hq, Sqp]: rowsum(dO . O), 0 past Sq
  __nv_bfloat16 *dq, *dk, *dv;   // contiguous [B, H, S, D]
  const int32_t* kv_len;
  int kv_len_stride;
  const int32_t* q_offset;
  int B, Hq, Hkv, Sq, Skv, Sqp;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  int causal, window;
  float softcap, scale;
  float c1, c2, c3;              // scale log2 e; 2 scale log2 e / cap; cap log2 e
};

// The TMA descriptors of the backward's bf16 operands (kernel parameters).
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

// Shared memory of the dK/dV launch at head dim D: K and V [KT rows], then
// per stage Q and dO [64 rows], then per stage lse2 and delta [64], then
// (D = 256) the P handover [64 x 64 float32], then the mbarriers.
template <int D>
struct DkdvGeo {
  static constexpr bool SPLIT = D == 256;
  static constexpr int KT = SPLIT ? 64 : 128;  // keys a block
  static constexpr int NS = SPLIT ? 2 : 4;     // ring stages
  static constexpr int KV_BYTES = KT * D * 2;
  static constexpr int QS_BYTES = kBR * D * 2;
  static constexpr int P_BYTES = SPLIT ? 64 * 64 * 4 : 0;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * NS * QS_BYTES +
                              NS * 2 * kBR * 4 + P_BYTES + 8 * (2 * NS + 3);
};

// Shared memory of the dQ launch: Q and dO [QR rows], then per stage K and
// V [64 rows], then lse2 and delta [QR], then the mbarriers.
template <int D, int NC>
struct DqGeo {
  static constexpr int QR = 64 * NC;           // query rows a block
  static constexpr int NS = NC == 2 ? 4 : 2;   // ring stages
  static constexpr int Q_BYTES = QR * D * 2;
  static constexpr int KV_BYTES = kBR * D * 2;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * NS * KV_BYTES +
                              2 * QR * 4 + 8 * (2 * NS + 1);
};

// `bytes` contiguous bytes global -> shared by the TMA engine; completion
// is counted in `bar`'s transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A tile as the K-major operand of an SS product (D contiguous), and a
// 64-row tile as the B operand of an RS product read through the transpose
// (its rows the product's k, D its n).
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, 8 * Tile<D>::RB, Tile<D>::MODE);
}
template <int D>
__device__ __forceinline__ uint64_t trans_desc(uint32_t addr) {
  return smem_desc(addr, kBR * Tile<D>::RB, 8 * Tile<D>::RB, Tile<D>::MODE);
}

// acc = A B^T over D in m64n64k16 steps: A the 64 rows at da of a tile of
// AR rows, B the 64 rows at db of a tile of BR rows, both stored in panels
// of COLS columns (a panel of a tile of R rows is R * RB bytes).
template <int D, int AR, int BR>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint64_t da,
                                         uint64_t db) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int pn = kk * 16 / T::COLS, col = kk * 16 % T::COLS;
    wgmma_ss(acc, da + ((pn * AR * T::RB + col * 2) >> 4),
             db + ((pn * BR * T::RB + col * 2) >> 4), kk > 0);
  }
}

__device__ __forceinline__ int bwd_valid_kv(const BwdParams& p, int b) {
  return min(max(p.kv_len[b * p.kv_len_stride], 0), p.Skv);
}

// Whether query row qi (q_offset + qi its position) sees key kpos.
__device__ __forceinline__ bool bwd_unmasked(const BwdParams& p, int kvl,
                                             int q_off, int qi, int kpos) {
  const int qpos = q_off + qi;
  return qi < p.Sq && kpos < kvl && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// Whether every pair of query rows [qa, qb] and keys [ka, kb] is unmasked.
__device__ __forceinline__ bool bwd_interior(const BwdParams& p, int kvl,
                                             int q_off, int qa, int qb,
                                             int ka, int kb) {
  return qb < p.Sq && kb < kvl && (!p.causal || q_off + qa >= kb) &&
         (p.window <= 0 || q_off + qb - ka < p.window);
}

// P = exp(s - lse) of a raw q.k in the base-2 domain (L: lse log2 e), and
// the softcap's chain-rule factor cf = 1 - (s / cap)^2 (1 without a cap);
// tanh(y) = 1 - 2 / (e^{2y} + 1), as the forward computes it.
template <bool CAP>
__device__ __forceinline__ float bwd_p(const BwdParams& p, float dot,
                                       float L, float& cf) {
  if (CAP) {
    const float t = 1.f - __fdividef(2.f, ex2(dot * p.c2) + 1.f);
    cf = 1.f - t * t;
    return ex2(p.c3 * t - L);
  }
  cf = 1.f;
  return ex2(dot * p.c1 - L);
}

// One 64 x 64 tile of S^T and dP^T of the dK/dV launch, in accumulator
// order (element i of a thread: key kr0 + 8 ((i >> 1) & 1), query
// q0 + 8 (i / 4) + 2 t4 + (i & 1)), with the stage's lse2 (sL) and delta
// (sD) of the tile's 64 queries: P into s and dS = P (dP - delta) cf into
// dp; or (PCF) P into s and P cf to pcf, a float4 a thread and 4 elements
// (pcf[128 j] holds elements 4j .. 4j + 3), dp untouched.
template <bool EDGE, bool CAP, bool PCF>
__device__ __forceinline__ void tile_kv(const BwdParams& p, float (&s)[32],
                                        float (&dp)[32], float4* pcf,
                                        const float* sL, const float* sD,
                                        int kr0, int q0, int t4, int kvl,
                                        int q_off) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const float2 L = *reinterpret_cast<const float2*>(sL + col);
    float2 dl = make_float2(0.f, 0.f);
    if constexpr (!PCF) dl = *reinterpret_cast<const float2*>(sD + col);
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float cf;
      float pe = bwd_p<CAP>(p, s[i], (e & 1) ? L.y : L.x, cf);
      if (EDGE && !bwd_unmasked(p, kvl, q_off, q0 + col + (e & 1),
                                kr0 + 8 * (e >> 1)))
        pe = 0.f;
      s[i] = pe;
      if constexpr (PCF) f[e] = pe * cf;
      else dp[i] = pe * (dp[i] - ((e & 1) ? dl.y : dl.x)) * cf;
    }
    if constexpr (PCF) pcf[128 * j] = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// dS = P cf (dP - delta) of a tile_kv<..., PCF> tile, into dp.
__device__ __forceinline__ void tile_kv_ds(float (&dp)[32], const float4* pcf,
                                           const float* sD, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(sD + 8 * j + 2 * t4);
    const float4 f = pcf[128 * j];
    dp[4 * j] = f.x * (dp[4 * j] - dl.x);
    dp[4 * j + 1] = f.y * (dp[4 * j + 1] - dl.y);
    dp[4 * j + 2] = f.z * (dp[4 * j + 2] - dl.x);
    dp[4 * j + 3] = f.w * (dp[4 * j + 3] - dl.y);
  }
}

// One 64 x 64 tile of S and dP of the dQ launch (element i of a thread:
// query row qi0 + 8 ((i >> 1) & 1), key k0 + 8 (i / 4) + 2 t4 + (i & 1);
// L0, D0 the lse2 and delta of its first row, L1, D1 of its second): dS =
// P (dP - delta) cf into dp.
template <bool EDGE, bool CAP>
__device__ __forceinline__ void tile_q(const BwdParams& p, const float (&s)[32],
                                       float (&dp)[32], float L0, float L1,
                                       float D0, float D1, int qi0, int k0,
                                       int t4, int kvl, int q_off) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool hi = (i & 2) != 0;
    float cf;
    float pe = bwd_p<CAP>(p, s[i], hi ? L1 : L0, cf);
    if (EDGE && !bwd_unmasked(p, kvl, q_off, qi0 + (hi ? 8 : 0),
                              k0 + 8 * (i / 4) + 2 * t4 + (i & 1)))
      pe = 0.f;
    dp[i] = pe * (dp[i] - (hi ? D1 : D0)) * cf;
  }
}

// A thread's float32 sums (N = D / 2: rows row0 and row0 + 8, columns
// 8 j + 2 t4 + {0, 1}), times `mul`, as bf16 rows of a contiguous [S, D]
// matrix at dst; rows at or past S are not written.
template <int N>
__device__ __forceinline__ void bwd_store(__nv_bfloat16* dst,
                                          const float (&acc)[N], float mul,
                                          int row0, int S, int t4) {
  constexpr int D = 2 * N;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(row0) * D +
                                   col) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (row0 + 8 < S)
      *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(row0 + 8) * D +
                                   col) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// delta = rowsum(dO . O) in float32 and lse2 = lse log2(e), one warp a
// query row; the padding rows [Sq, Sqp) get zeros.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const __grid_constant__ BwdParams p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= p.Sqp) return;
  const long long at = (static_cast<long long>(b) * p.Hq + h) * p.Sqp + row;
  if (row >= p.Sq) {
    if (lane == 0) p.lse2[at] = p.delta[at] = 0.f;
    return;
  }
  const __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
  const __nv_bfloat16* dg = p.dout + b * p.do_sb + h * p.do_sh + row * p.do_ss;
  float acc = 0.f;
  for (int d = 8 * lane; d < D; d += 256) {
    const uint4 ov = *reinterpret_cast<const uint4*>(og + d);
    const uint4 dv = *reinterpret_cast<const uint4*>(dg + d);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]);
      const float2 df = __bfloat1622float2(d2[i]);
      acc += of.x * df.x + of.y * df.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffff, acc, off);
  if (lane == 0) {
    p.delta[at] = acc;
    p.lse2[at] =
        p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row] * kLog2e;
  }
}

// dK and dV of one key tile of (b, kv head); blocks are numbered with the
// key tile slowest.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ BwdParams p,
                     const __grid_constant__ BwdMaps maps) {
  using T = Tile<D>;
  using Gm = DkdvGeo<D>;
  constexpr int KT = Gm::KT, NS = Gm::NS, QS = Gm::QS_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023) & ~1023u;
  const uint32_t sV = sK + Gm::KV_BYTES;
  const uint32_t sQ0 = sV + Gm::KV_BYTES;              // stage s: Q, then dO
  const uint32_t sRows = sQ0 + 2 * NS * QS;            // stage s: lse2, delta
  const uint32_t sP = sRows + NS * 2 * kBR * 4;        // the P handover
  const uint32_t bars = sP + Gm::P_BYTES;
  // kv, full[NS], empty[NS], pfull, pempty
  const uint32_t kvbar = bars, full0 = bars + 8, empty0 = bars + 8 * (1 + NS);
  const uint32_t pfull = bars + 8 * (1 + 2 * NS), pempty = pfull + 8;

  const int per = p.Hkv * p.B;
  const int kt = blockIdx.x / per;
  const int hk = (blockIdx.x % per) % p.Hkv, b = (blockIdx.x % per) / p.Hkv;
  const int k0 = kt * KT;
  const int G = p.Hq / p.Hkv;
  const int q_off = *p.q_offset;
  const int kvl = bwd_valid_kv(p, b);
  // the 64-row query tiles that see a key of [k0, k_last], per query head
  int q_start = 0, n_q = 0;
  if (k0 < kvl) {
    const int k_last = min(k0 + KT, kvl) - 1;
    const int i_lo = p.causal ? max(0, k0 - q_off) : 0;
    const int i_hi = p.window > 0 ? min(p.Sq, k_last + p.window - q_off)
                                  : p.Sq;
    q_start = i_lo / kBR * kBR;
    n_q = i_hi > q_start ? (i_hi - q_start + kBR - 1) / kBR : 0;
  }
  const int n_it = G * n_q;   // iteration it: head hk G + it / n_q
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one per consumer warp
    }
    mbar_init(pfull, 128);
    mbar_init(pempty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_it > 0) {
      mbar_expect_tx(kvbar, 2 * Gm::KV_BYTES);
      for (int pn = 0; pn < T::NP; ++pn) {
        tma_load_4d(sK + pn * KT * T::RB, &maps.k, pn * T::COLS, k0, hk, b,
                    kvbar);
        tma_load_4d(sV + pn * KT * T::RB, &maps.v, pn * T::COLS, k0, hk, b,
                    kvbar);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % NS;
        const int h = hk * G + it / n_q, q0 = q_start + (it % n_q) * kBR;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((it / NS) & 1) ^ 1);
        mbar_expect_tx(full, 2 * QS + 2 * kBR * 4);
        const uint32_t sQ = sQ0 + 2 * s * QS;
        for (int pn = 0; pn < T::NP; ++pn) {
          tma_load_4d(sQ + pn * kBR * T::RB, &maps.q, pn * T::COLS, q0, h, b,
                      full);
          tma_load_4d(sQ + QS + pn * kBR * T::RB, &maps.dout, pn * T::COLS,
                      q0, h, b, full);
        }
        const long long row = (static_cast<long long>(b) * p.Hq + h) * p.Sqp + q0;
        const uint32_t sr = sRows + s * 2 * kBR * 4;
        bulk_load(sr, p.lse2 + row, kBR * 4, full);
        bulk_load(sr + kBR * 4, p.delta + row, kBR * 4, full);
      }
    }
  } else {
    // ---- consumers -----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int r0 = 16 * warp + g;      // this thread's keys: r0 and r0 + 8
    const int kc0 = Gm::SPLIT ? k0 : k0 + 64 * c;   // this consumer's keys
    const bool cap = p.softcap > 0.f;
    const long long head = static_cast<long long>(b) * p.Hkv + hk;
    auto stage = [&](int it) { return sQ0 + 2 * (it % NS) * QS; };
    auto rows = [&](int it) {
      return reinterpret_cast<const float*>(
          smem_raw + (sRows + (it % NS) * 2 * kBR * 4 - base));
    };
    auto wait_full = [&](int it) {
      mbar_wait(full0 + 8 * (it % NS), (it / NS) & 1);
    };
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * (it % NS));
    };
    auto q_of = [&](int it) { return q_start + (it % n_q) * kBR; };
    auto edge = [&](int it) {
      const int q0 = q_of(it);
      return !bwd_interior(p, kvl, q_off, q0, q0 + kBR - 1, kc0, kc0 + 63);
    };
    if constexpr (!Gm::SPLIT) {
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
      if (n_it > 0) {
        mbar_wait(kvbar, 0);
        const uint64_t ak = kmajor_desc<D>(sK + 64 * c * T::RB);
        const uint64_t av = kmajor_desc<D>(sV + 64 * c * T::RB);
        float sc[32], dp[32];
        uint32_t pa[4][4], da[4][4];
        for (int it = 0; it < n_it; ++it) {
          const uint32_t sQ = stage(it);
          wait_full(it);
          reg_fence(sc);
          reg_fence(dp);
          wgmma_fence();
          issue_ss<D, KT, kBR>(sc, ak, kmajor_desc<D>(sQ));
          issue_ss<D, KT, kBR>(dp, av, kmajor_desc<D>(sQ + QS));
          wgmma_commit();
          wgmma_wait<0>();   // and dV, dK of the tile before
          reg_fence(sc);
          reg_fence(dp);
          reg_fence(dk);
          reg_fence(dv);
          if (it > 0) release(it - 1);
          const float* rw = rows(it);
          const int q0 = q_of(it);
          if (edge(it)) {
            if (cap) tile_kv<true, true, false>(p, sc, dp, nullptr, rw, rw + kBR, kc0 + r0, q0, t4, kvl, q_off);
            else tile_kv<true, false, false>(p, sc, dp, nullptr, rw, rw + kBR, kc0 + r0, q0, t4, kvl, q_off);
          } else {
            if (cap) tile_kv<false, true, false>(p, sc, dp, nullptr, rw, rw + kBR, kc0 + r0, q0, t4, kvl, q_off);
            else tile_kv<false, false, false>(p, sc, dp, nullptr, rw, rw + kBR, kc0 + r0, q0, t4, kvl, q_off);
          }
          pack_p(sc, pa);
          pack_p(dp, da);
          wgmma_fence();
          issue_pv(dv, pa, trans_desc<D>(sQ + QS));
          issue_pv(dk, da, trans_desc<D>(sQ));
          wgmma_commit();
        }
        wgmma_wait<0>();
        reg_fence(dk);
        reg_fence(dv);
        release(n_it - 1);
      }
      bwd_store(p.dk + head * p.Skv * D, dk, p.scale, kc0 + r0, p.Skv, t4);
      bwd_store(p.dv + head * p.Skv * D, dv, 1.f, kc0 + r0, p.Skv, t4);
    } else if (c == 0) {
      // S^T, P, dV; P cf handed to consumer 1
      float dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dv[i] = 0.f;
      if (n_it > 0) {
        mbar_wait(kvbar, 0);
        const uint64_t ak = kmajor_desc<D>(sK);
        float4* pcf = reinterpret_cast<float4*>(smem_raw + (sP - base)) + tid;
        float sc[32];
        uint32_t pa[4][4];
        for (int it = 0; it < n_it; ++it) {
          const uint32_t sQ = stage(it);
          wait_full(it);
          reg_fence(sc);
          reg_fence(dv);
          wgmma_fence();
          issue_ss<D, KT, kBR>(sc, ak, kmajor_desc<D>(sQ));
          wgmma_commit();
          wgmma_wait<0>();   // and dV of the tile before
          reg_fence(sc);
          reg_fence(dv);
          if (it > 0) release(it - 1);
          mbar_wait(pempty, (it & 1) ^ 1);   // consumer 1 read the last one
          const float* rw = rows(it);
          const int q0 = q_of(it);
          if (edge(it)) {
            if (cap) tile_kv<true, true, true>(p, sc, sc, pcf, rw, rw + kBR, k0 + r0, q0, t4, kvl, q_off);
            else tile_kv<true, false, true>(p, sc, sc, pcf, rw, rw + kBR, k0 + r0, q0, t4, kvl, q_off);
          } else {
            if (cap) tile_kv<false, true, true>(p, sc, sc, pcf, rw, rw + kBR, k0 + r0, q0, t4, kvl, q_off);
            else tile_kv<false, false, true>(p, sc, sc, pcf, rw, rw + kBR, k0 + r0, q0, t4, kvl, q_off);
          }
          mbar_arrive(pfull);
          pack_p(sc, pa);
          wgmma_fence();
          issue_pv(dv, pa, trans_desc<D>(sQ + QS));
          wgmma_commit();
        }
        wgmma_wait<0>();
        reg_fence(dv);
        release(n_it - 1);
      }
      bwd_store(p.dv + head * p.Skv * D, dv, 1.f, k0 + r0, p.Skv, t4);
    } else {
      // dP^T, dS from consumer 0's P cf, dK
      float dk[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
      if (n_it > 0) {
        mbar_wait(kvbar, 0);
        const uint64_t av = kmajor_desc<D>(sV);
        const float4* pcf =
            reinterpret_cast<const float4*>(smem_raw + (sP - base)) + tid;
        float dp[32];
        uint32_t da[4][4];
        for (int it = 0; it < n_it; ++it) {
          const uint32_t sQ = stage(it);
          wait_full(it);
          reg_fence(dp);
          reg_fence(dk);
          wgmma_fence();
          issue_ss<D, KT, kBR>(dp, av, kmajor_desc<D>(sQ + QS));
          wgmma_commit();
          wgmma_wait<0>();   // and dK of the tile before
          reg_fence(dp);
          reg_fence(dk);
          if (it > 0) release(it - 1);
          mbar_wait(pfull, it & 1);
          tile_kv_ds(dp, pcf, rows(it) + kBR, t4);
          mbar_arrive(pempty);
          pack_p(dp, da);
          wgmma_fence();
          issue_pv(dk, da, trans_desc<D>(sQ));
          wgmma_commit();
        }
        wgmma_wait<0>();
        reg_fence(dk);
        release(n_it - 1);
      }
      bwd_store(p.dk + head * p.Skv * D, dk, p.scale, k0 + r0, p.Skv, t4);
    }
  }
}

// dQ of one query tile of (b, q head); the last tiles (the most keys under
// a causal mask) are scheduled first.
template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_bwd_dq_wgmma(const __grid_constant__ BwdParams p,
                   const __grid_constant__ BwdMaps maps) {
  using T = Tile<D>;
  using Gm = DqGeo<D, NC>;
  constexpr int QR = Gm::QR, NS = Gm::NS, KVB = Gm::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sQ = (base + 1023) & ~1023u;
  const uint32_t sDO = sQ + Gm::Q_BYTES;
  const uint32_t sKV = sDO + Gm::Q_BYTES;      // stage s: K, then V
  const uint32_t sRows = sKV + 2 * NS * KVB;   // lse2 [QR], delta [QR]
  const uint32_t bars = sRows + 2 * QR * 4;    // full[NS], empty[NS], q
  const uint32_t qbar = bars + 16 * NS;

  const int n_qt = (p.Sq + QR - 1) / QR;
  const int per = p.Hq * p.B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = (blockIdx.x % per) % p.Hq, b = (blockIdx.x % per) / p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * QR;
  const int q_off = *p.q_offset;
  const int kvl = bwd_valid_kv(p, b);
  // the keys of the block's rows, as the forward's key_range
  const int q_first = q_off + q0, q_last = q_off + min(q0 + QR, p.Sq) - 1;
  int k_hi = kvl;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  const int k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int k_begin = k_lo / kBR * kBR;
  const int n_tiles = k_begin < k_hi ? (k_hi - k_begin + kBR - 1) / kBR : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (NS + s), 4 * NC);  // one per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy --------------------------
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(qbar, 2 * Gm::Q_BYTES + 2 * QR * 4);
      for (int pn = 0; pn < T::NP; ++pn) {
        tma_load_4d(sQ + pn * QR * T::RB, &maps.q, pn * T::COLS, q0, h, b,
                    qbar);
        tma_load_4d(sDO + pn * QR * T::RB, &maps.dout, pn * T::COLS, q0, h,
                    b, qbar);
      }
      const long long row = (static_cast<long long>(b) * p.Hq + h) * p.Sqp + q0;
      bulk_load(sRows, p.lse2 + row, QR * 4, qbar);
      bulk_load(sRows + QR * 4, p.delta + row, QR * 4, qbar);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NS, kt0 = k_begin + t * kBR;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (NS + s), ((t / NS) & 1) ^ 1);
        mbar_expect_tx(full, 2 * KVB);
        const uint32_t sK = sKV + 2 * s * KVB;
        for (int pn = 0; pn < T::NP; ++pn) {
          tma_load_4d(sK + pn * kBR * T::RB, &maps.k, pn * T::COLS, kt0, hk,
                      b, full);
          tma_load_4d(sK + KVB + pn * kBR * T::RB, &maps.v, pn * T::COLS,
                      kt0, hk, b, full);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------------
    if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int c0 = q0 + 64 * c;   // this consumer's first row
    const int r0 = 16 * warp + g;   // this thread's rows: r0 and r0 + 8
    const bool cap = p.softcap > 0.f;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    if (n_tiles > 0) {
      auto wait_full = [&](int t) {
        mbar_wait(bars + 8 * (t % NS), (t / NS) & 1);
      };
      auto release = [&](int t) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (NS + t % NS));
      };
      auto k_at = [&](int t) { return sKV + 2 * (t % NS) * KVB; };
      const uint64_t aq = kmajor_desc<D>(sQ + 64 * c * T::RB);
      const uint64_t ado = kmajor_desc<D>(sDO + 64 * c * T::RB);
      mbar_wait(qbar, 0);
      const float* rw = reinterpret_cast<const float*>(smem_raw + (sRows - base));
      const float L0 = rw[64 * c + r0], L1 = rw[64 * c + r0 + 8];
      const float D0 = rw[QR + 64 * c + r0], D1 = rw[QR + 64 * c + r0 + 8];
      float sc[32], dp[32];
      uint32_t da[4][4];
      auto ds = [&](int t) {
        const int kt0 = k_begin + t * kBR;
        const bool edge = !bwd_interior(p, kvl, q_off, c0, c0 + 63, kt0, kt0 + kBR - 1);
        if (edge) {
          if (cap) tile_q<true, true>(p, sc, dp, L0, L1, D0, D1, c0 + r0, kt0, t4, kvl, q_off);
          else tile_q<true, false>(p, sc, dp, L0, L1, D0, D1, c0 + r0, kt0, t4, kvl, q_off);
        } else {
          if (cap) tile_q<false, true>(p, sc, dp, L0, L1, D0, D1, c0 + r0, kt0, t4, kvl, q_off);
          else tile_q<false, false>(p, sc, dp, L0, L1, D0, D1, c0 + r0, kt0, t4, kvl, q_off);
        }
      };
      if constexpr (NC == 1) {
        // one consumer, two stages: tile t - 1's stage is released as soon
        // as tile t's products are issued and waited for, so that the
        // producer has a whole tile's time to bring in tile t + 1
        for (int t = 0; t < n_tiles; ++t) {
          wait_full(t);
          reg_fence(sc);
          reg_fence(dp);
          reg_fence(dq);
          wgmma_fence();
          issue_ss<D, QR, kBR>(sc, aq, kmajor_desc<D>(k_at(t)));
          issue_ss<D, QR, kBR>(dp, ado, kmajor_desc<D>(k_at(t) + KVB));
          wgmma_commit();
          wgmma_wait<0>();   // and dQ += dS K of tile t - 1
          reg_fence(sc);
          reg_fence(dp);
          reg_fence(dq);
          if (t > 0) release(t - 1);
          ds(t);
          pack_p(dp, da);
          wgmma_fence();
          issue_pv(dq, da, trans_desc<D>(k_at(t)));
          wgmma_commit();
        }
      } else {
        wait_full(0);
        reg_fence(sc);
        reg_fence(dp);
        wgmma_fence();
        issue_ss<D, QR, kBR>(sc, aq, kmajor_desc<D>(k_at(0)));
        issue_ss<D, QR, kBR>(dp, ado, kmajor_desc<D>(k_at(0) + KVB));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        reg_fence(dp);
        ds(0);
        pack_p(dp, da);
        for (int t = 1; t < n_tiles; ++t) {
          wait_full(t);
          reg_fence(sc);
          reg_fence(dp);
          reg_fence(dq);
          wgmma_fence();
          issue_ss<D, QR, kBR>(sc, aq, kmajor_desc<D>(k_at(t)));
          issue_ss<D, QR, kBR>(dp, ado, kmajor_desc<D>(k_at(t) + KVB));
          wgmma_commit();
          issue_pv(dq, da, trans_desc<D>(k_at(t - 1)));
          wgmma_commit();
          wgmma_wait<1>();   // S and dP of tile t
          reg_fence(sc);
          reg_fence(dp);
          ds(t);
          wgmma_wait<0>();   // dQ += dS K of tile t - 1
          reg_fence(dq);
          release(t - 1);
          pack_p(dp, da);
        }
        reg_fence(dq);
        wgmma_fence();
        issue_pv(dq, da, trans_desc<D>(k_at(n_tiles - 1)));
        wgmma_commit();
      }
      wgmma_wait<0>();
      reg_fence(dq);
      release(n_tiles - 1);
    }
    const long long head = static_cast<long long>(b) * p.Hq + h;
    bwd_store(p.dq + head * p.Sq * D, dq, p.scale, c0 + r0, p.Sq, t4);
  }
}

// parts: bit 0 the delta launch, bit 1 dK/dV, bit 2 dQ (7: the backward).
template <int D>
cudaError_t launch_bwd(const BwdParams& p, int parts, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (parts & 1) {
    dim3 gd(p.Sqp / 8, p.Hq, p.B);
    flash_bwd_delta<D><<<gd, 256, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Skv == 0)   // no key: dQ is zero (dK and dV are empty)
    return (parts & 4) ? cudaMemsetAsync(p.dq, 0,
                                         static_cast<size_t>(p.B) * p.Hq *
                                             p.Sq * D * 2,
                                         stream)
                       : cudaSuccess;
  using A = DkdvGeo<D>;
  constexpr int NC = D == 256 ? 1 : 2;
  using Q = DqGeo<D, NC>;
  BwdMaps ma, mq;   // the dK/dV launch's boxes, the dQ launch's
  const bool ok =
      encode_map(&ma.q, p.q, p.B, p.Hq, p.Sq, D, p.q_sb, p.q_sh, p.q_ss,
                 kBR) == CUDA_SUCCESS &&
      encode_map(&ma.dout, p.dout, p.B, p.Hq, p.Sq, D, p.do_sb, p.do_sh,
                 p.do_ss, kBR) == CUDA_SUCCESS &&
      encode_map(&ma.k, p.k, p.B, p.Hkv, p.Skv, D, p.k_sb, p.k_sh, p.k_ss,
                 A::KT) == CUDA_SUCCESS &&
      encode_map(&ma.v, p.v, p.B, p.Hkv, p.Skv, D, p.v_sb, p.v_sh, p.v_ss,
                 A::KT) == CUDA_SUCCESS &&
      encode_map(&mq.q, p.q, p.B, p.Hq, p.Sq, D, p.q_sb, p.q_sh, p.q_ss,
                 Q::QR) == CUDA_SUCCESS &&
      encode_map(&mq.dout, p.dout, p.B, p.Hq, p.Sq, D, p.do_sb, p.do_sh,
                 p.do_ss, Q::QR) == CUDA_SUCCESS &&
      encode_map(&mq.k, p.k, p.B, p.Hkv, p.Skv, D, p.k_sb, p.k_sh, p.k_ss,
                 kBR) == CUDA_SUCCESS &&
      encode_map(&mq.v, p.v, p.B, p.Hkv, p.Skv, D, p.v_sb, p.v_sh, p.v_ss,
                 kBR) == CUDA_SUCCESS;
  if (!ok) return cudaErrorInvalidValue;
  if (parts & 2) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               A::SMEM);
    if (err != cudaSuccess) return err;
    const int n_kt = (p.Skv + A::KT - 1) / A::KT;
    flash_bwd_dkdv_wgmma<D><<<n_kt * p.Hkv * p.B, kWgThreads, A::SMEM,
                              stream>>>(p, ma);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & 4) {
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<D, NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Q::SMEM);
    if (err != cudaSuccess) return err;
    const int n_qt = (p.Sq + Q::QR - 1) / Q::QR;
    flash_bwd_dq_wgmma<D, NC><<<n_qt * p.Hq * p.B, 128 * (NC + 1), Q::SMEM,
                                 stream>>>(p, mq);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// dtype: 0 = bf16, 1 = float32. strides: 12 element strides, (b, h, s) of
// q, k, v and o in that order; the d stride is 1. lse: a contiguous float32
// [B, Hq, Sq] written with each row's log-sum-exp (the backward's
// residual), or null. Returns the CUDA error of
// the launch (0 on success; a tensor map the driver refuses gives
// cudaErrorInvalidValue). The wrapper (kernel.py) checks shapes, types,
// alignment and devices before calling.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
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
  p.lse = lse;
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

// The backward of the bf16 forward at D 128 or 256: dq [B, Hq, Sq, D] and
// dk, dv [B, Hkv, Skv, D] (contiguous, bf16) from q, k, v, o and dO (the
// caller's strides; 15 element strides, (b, h, s) of q, k, v, o and dO) and
// the forward's lse (contiguous float32 [B, Hq, Sq]). rows is float32
// scratch of 2 x [B, Hq, Sqp], Sqp = Sq rounded up to a multiple of 128
// (lse in log2 units, then delta). Three launches on `stream` (parts 7; a
// part alone, bits as launch_bwd's, times one launch); returns the first
// CUDA error (cudaErrorInvalidValue at another D, or for a tensor map the
// driver refuses).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* rows, void* dq, void* dk,
    void* dv, const int32_t* kv_len, int kv_len_stride,
    const int32_t* q_offset, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    const long long* strides, int causal, int window, float softcap,
    float scale, int parts, void* stream_ptr) {
  if (Sq == 0 || B == 0 || Hq == 0) return 0;
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.Sqp = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  p.lse2 = rows;
  p.delta = rows + static_cast<long long>(B) * Hq * p.Sqp;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.kv_len = kv_len;
  p.kv_len_stride = kv_len_stride;
  p.q_offset = q_offset;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.do_sb = strides[12]; p.do_sh = strides[13]; p.do_ss = strides[14];
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.c1 = scale * kLog2e;
  p.c2 = softcap > 0.f ? 2.f * scale * kLog2e / softcap : 0.f;
  p.c3 = softcap * kLog2e;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (D) {
    case 128: return static_cast<int>(launch_bwd<128>(p, parts, stream));
    case 256: return static_cast<int>(launch_bwd<256>(p, parts, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
