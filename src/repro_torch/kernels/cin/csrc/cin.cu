// One xDeepFM CIN layer (Compressed Interaction Network) for Hopper
// (sm_90a), float32 in and out, on the tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cin/kernel.py
// (_cin_kernel, line 26; entry cin_layer_pallas). It computes the same
// function,
//
//   out[b, n, d] = sum_{h, m} W[n, h, m] * (xk[b, h, d] * x0[b, m, d]),
//
// over x0 [B, m, D], xk [B, H, D] and W [H2, H, m], all contiguous float32,
// into out [B, H2, D], and never writes the outer product
// Z[b, h, m, d] = xk[b, h, d] * x0[b, m, d] to device memory (81.8 GB at
// xdeepfm's widths and a batch of 262,144). The TPU kernel formed one
// batch row's Z pane in VMEM and multiplied it on the MXU; here the layer
// is the GEMM
//
//   out^T[(b, d), n] = Z^T[(b, d), (h, m)] . W_flat^T,
//
// M = B*D rows (b, d), N = H2, K = H*m, with its left operand made on the
// fly in registers.
//
// Arithmetic: 3xTF32, so that the float32 rule of kernels/cin/cases.py
// (|o - r| <= 2^-16 A, A the layer on absolute values) holds. Each operand
// x is split into hi = tf32(x) (round to nearest, cvt.rna) and
// lo = tf32(x - hi), and the products A_hi B_hi + A_hi B_lo + A_lo B_hi are
// summed in wgmma's float32 accumulators; the dropped A_lo B_lo and the
// rounding of lo leave about 2^-21 of each term. One pass of TF32 would err
// by about 2^-11 per term, too close to the rule over K = 7,800 terms.
// The tensor cores' float32 sums round less well than float32 adds over a
// long K (summed by them alone, K = 7,800 read about 0.6 of the rule on
// the card): each stage's 16 values of k are summed by wgmma from zero and
// then added to a second accumulator by ordinary float32 adds, which
// brings the reading to about 0.04.
//
// Design:
//   * Three kernels per layer: cin_split_w writes W's hi and lo parts
//     into a scratch buffer the wrapper allocates, in the order and tile
//     layout the main kernel's stages read (below); cin_layer_wgmma does
//     the products; cin_sum_parts adds the K parts when K was split.
//   * K order: (h, m) with m padded to mp, a multiple of 8 (40 at m = 39;
//     W is 0 at the padding), so that each k8 step of wgmma has one h. K is
//     walked in stages of 2 k8 steps (16 values of k).
//   * cin_layer_wgmma: a warp-specialised block of three warpgroups (384
//     threads) per 128-row M tile (rows (b, d) = 128 t .. 128 t + 127,
//     flattened as b*D + d), per K part and per N tile.
//       - warpgroup 0, the producer (setmaxnreg 24): one thread streams
//         the stages of W_hi and W_lo (2 x 16 x NI floats, 25,600 bytes at
//         NI = 200) by TMA bulk copies through a ring of 6 stages in
//         shared memory, with full/empty mbarriers.
//       - warpgroups 1 and 2, the consumers (setmaxnreg 240), own 64 rows
//         each. A consumer stages its rows' x0 values in shared memory once
//         (x0s[m][64], rows padded to 72 floats: conflict-free), then per
//         stage forms its A fragments in registers, z = xk[b, h, d] *
//         x0[b, m, d] (xk read through the read-only cache, the product
//         in the reference's order), splits them into hi and lo, waits for
//         the stage and issues 3 wgmma m64nNIk8 per k8 step (tf32 in,
//         float32 sums, B = W from shared memory, K-major) into the stage
//         accumulator, then adds it to the running one (64 x NI each, 100
//         registers at NI = 200). The sum is written once, at the end,
//         straight to out[b, n, d] with 64-bit offsets (B*H2*D is 2e9 at
//         the retrieval batch of 10^6 candidates).
//   * N tile: NI = 200 (xdeepfm's H2 = 200, one wgmma), 64 or 16, padded
//     with W rows of 0 and masked at the store; H2 > 200 takes several N
//     tiles.
//   * Filling the card: when the M and N tiles are fewer than the SMs
//     (B = 512 gives 40), K is split into a fixed number of parts (at most
//     SMs / tiles: 3 at B = 512 on 132 SMs), each written to its own
//     partial output, summed in a fixed order by cin_sum_parts. The split
//     depends only on the shapes and the card, so two launches are bit
//     for bit identical.
//   * Shared memory at NI = 200, m = 39: 6 x 25,600 + 2 x 40 x 72 x 4 =
//     176,640 bytes; the staged rows take 576 bytes per field, so m may
//     reach 136 at NI = 200 and 312 at NI = 64 (the launch refuses what
//     does not fit the card's opt-in limit; kernel.py checks it first).
//
// Bound (chip_smoke.py computes it from the run's shapes): operations.
// 2*H2*H*m*D flops per batch row and layer, three times over in 3xTF32, at
// the tensor cores' 495 TFLOP/s of TF32: 49.6 ms for a layer with H = 200
// at a serve_bulk batch (262,144 rows), 9.67 ms for layer 1 (H = 39). The
// bytes (x0, xk and W read once, out written once) are about 4.6 GB on a
// layer with H = 200 at that batch, 1.4 ms at 3.35 TB/s. Every M tile
// streams the whole split W (12.8 MB at H = 200) from the 50 MB L2; 128
// rows per tile keep that stream near the L2's rate at the tensor cores'.

// The layer's gradients (cin_dw_wgmma and cin_dx_wgmma, below the layer
// kernel) replace no TPU kernel: the reference trains through the plain CIN
// and takes its gradients by autodiff of its einsums
// (src/repro/kernels/cin/ref.py). Both run on the tensor cores in 3xTF32,
// warp-specialised as the layer kernel is (a producer streaming B stages by
// bulk TMA through a ring of stages, two consumer warpgroups of 64 rows
// forming A in registers), so they share its helpers and its bound: one
// layer's 2*H2*H*m*D flops per batch row, three TF32 passes at 495 TFLOP/s
// (12.39 ms for an H-200 layer at the training batch of 65,536, 2.416 ms for
// layer 1), far above their bytes.
//
// cin_dw_wgmma: dW[n, h, m] = sum_{b, d} dy[b, n, d] xk[b, h, d] x0[b, m, d]
// as the GEMM
//
//   dW^T[(h, mm), n] = Z^T[(h, mm), (b, d)] . dy[(b, d), n],
//
// M = H*mp rows (h, mm) (m padded to mp as the layer pads it), N = H2 (one
// m64n200k8 at xdeepfm's 200), K = B*D (655,360 at the training batch).
//   * A is made in registers: z = xk[b, h, d] * x0[b, mm, d], the
//     reference's product, split into hi and lo. A warp's 16 rows are 8
//     fields mm of two filters h, h + 1 (rows g and g + 8 of the fragment
//     share mm), so a thread reads three values per k (x0 once, xk twice).
//     They come from shared memory: 80 lanes of the producer warpgroup copy
//     each stage's x0 and xk values (the block's 64 field and 16 filter
//     columns at 16 values of k, 5 KB) into the stage's slot beside its dy
//     tile by 4-byte cp.async, arriving on the stage's barrier when the
//     copies land, so several stages are in flight per lane and the
//     consumers never wait on a global load (consumers loading their own
//     values one stage ahead, or loaders holding them in registers, kept
//     one L2 latency a stage on the critical path and were slower on the
//     card). Z never reaches device memory.
//   * B is dy, K-major. tf32 wgmma takes K-major shared-memory operands only
//     and D = 10 is not a multiple of 4, so dy's rows as they lie ([b][n][d],
//     a 40-byte pitch) are no valid operand. A pre-pass (cin_split_dy) writes
//     dy's hi and lo parts in the stage tiles the main kernel copies, the
//     layer's W layout with k = (b, d): 2 x 4 bytes per dy value (1.05 GB of
//     scratch at the training batch; 1.57 GB moved, 0.47 ms at 3.35 TB/s),
//     which buys one contiguous bulk copy per stage and no split in the
//     main loop; rearranging each stage in shared memory would cost the
//     consumers a second barrier per stage.
//   * dy through L2: unlike W in the layer, dy is the operand all M tiles
//     share, and its split (1.05 GB) does not fit the 50 MB L2. The grid runs
//     the M tiles fastest, so the M tiles of one K part (63 at an H-200 layer,
//     13 at layer 1) are resident together and walk the same stages in step:
//     each byte of the split crosses from device memory about once in all and
//     from L2 once per M tile.
//   * The long K: each stage's 16 values of k are summed by wgmma from zero
//     and added to a second accumulator by float32 adds, as the layer does.
//     K is split into parts (contiguous ranges of stages, as many as fill the
//     SMs: 2 at an H-200 layer, 10 at layer 1) that depend only on the shapes
//     and the card, summed in order by cin_sum_parts. No float atomics: two
//     launches are bit for bit equal.
//
// cin_dx_wgmma: dxk and dx0 in one launch, reassociated around
//
//   U[b, (h, mm), d] = sum_n W[n, h, mm] dy[b, n, d],
//   dx0[b, mm, d] = sum_h xk[b, h, d] U,
//   dxk[b, h, d] = sum_mm x0[b, mm, d] U,
//
// so the pair does one layer's flops (computed as two layers of their own,
// they take twice that). U is the GEMM U[(b, d), (h, mm)] = dy[(b, d), n] . W_flat[n, (h,
// mm)], M = B*D, N = H*mp, K = H2 (200, padded to 208).
//   * A is dy: each consumer stages its 64 rows (b, d) at all of K in
//     shared memory once (58 KB at H2 200, 0 past H2), and every N tile
//     splits them in registers stage by stage, so the block reads dy from
//     device memory once. That leaves room for a W^T ring of 4 stages and
//     K = H2 of at most 224 (the wrapper refuses more).
//   * B is W^T, split once per launch by cin_split_wt into the stage tiles
//     (13.3 MB at xdeepfm's widths), read by every M tile from L2 as the
//     layer reads W.
//   * U never leaves the block. An N tile is NI / mp whole filters h (5 x 40
//     = 200 at m = 39), so by the fragment layout thread t's accumulator
//     column 8j + 2t + e holds h = j div (mp/8) and mm = 8 (j mod mp/8) + 2t
//     + e. The epilogue of each N tile folds it in: dx0's partial sums over h
//     stay in registers across the N tiles (mp/4 fields for each of the
//     thread's two rows), added in h order; dxk's sum over mm is in-thread in
//     mm order, then a fixed butterfly over the quad. Every output element is
//     written once. At K = 208 the tensor cores' own sums serve (no second
//     accumulator): U's rounding is averaged again by the sums over h and mm.
//   * Batches of fewer M tiles than SMs split the N tiles into parts; each
//     part writes dxk for its own filters and a partial dx0, summed in order
//     by cin_sum_parts. No atomics: two launches are bit for bit equal.
//   * Fields: mp 40 (N tile 200) or 8 (N tile 16, 64 or 200); the wrapper
//     refuses other m, and H2 over 224, before anything is built.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // (b, d) rows per block: 64 per consumer
constexpr int kKS = 2;          // k8 steps per stage (16 values of k)
constexpr int kStages = 6;      // W ring depth
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr int kX0Stride = 72;   // floats per staged x0 row (64 + 8)

struct Params {
  const float* x0;
  const float* xk;
  const float* ws;         // split W: [n tile][stage][hi | lo][k/4][NI][4]
  float* out;              // out, or the K parts' partial outputs
  long long M;             // B * D
  long long part_stride;   // floats between partial outputs (B * H2 * D)
  long long T;             // stages over the padded K (H * mp)
  int m, H, H2, D, mp, parts;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// x rounded to TF32 (10 explicit mantissa bits, to nearest, ties away from
// zero), as float32 bits with the low 13 bits 0.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));  // x - hi is exact
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

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode (0: none).
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the registers across
// the asynchronous products (their asm statements order these).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d += A B, m64n16k8: tf32 in, float32 sums; A from registers, B from
// shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d += A B, m64n64k8: tf32 in, float32 sums; A from registers, B from
// shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

// d += A B, m64n200k8: tf32 in, float32 sums; A from registers, B from
// shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[100],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99"
      "}, {%100, %101, %102, %103}, %104, p, 1, 1;\n}\n"
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
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


// Floats of one stage of the split W at N tile width ni: hi, then lo, each
// [k/4 = 2 kKS][ni][4] (the wgmma core matrices: 8 rows n of 4 values of
// k).
__host__ __device__ constexpr long long stage_floats(int ni) {
  return 2LL * kKS * 8 * ni;
}

// ws[((nt * T + st) * stage_floats(ni)) + part * (stage/2) + (q * ni + n) * 4
// + j] = part (hi or lo) of W[nt*ni + n, h, mm] at padded k = 8 kKS st + 4q
// + j = h*mp + mm; 0 past H2, at mm >= m and past H.
__global__ void cin_split_w(const float* __restrict__ w, float* __restrict__ ws,
                            int m, int H, int H2, int mp, long long T, int ni,
                            long long total) {
  const long long sf = stage_floats(ni), half = sf / 2;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long sid = i / sf;
    const long long e = i - sid * sf;
    const int nt = static_cast<int>(sid / T);
    const long long st = sid - nt * T;
    const bool lo_part = e >= half;
    const int f = static_cast<int>(lo_part ? e - half : e);
    const int q = f / (ni * 4);
    const int rem = f - q * ni * 4;
    const int n = nt * ni + (rem >> 2);
    const long long kp = st * (kKS * 8) + q * 4 + (rem & 3);
    const long long h = kp / mp;
    const int mm = static_cast<int>(kp - h * mp);
    float v = 0.f;
    if (h < H && mm < m && n < H2) v = w[(n * static_cast<long long>(H) + h) * m + mm];
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    ws[i] = __uint_as_float(lo_part ? lo : hi);
  }
}

// out[i] = sum over the K parts of part[q][i], q in order.
__global__ void cin_sum_parts(const float* __restrict__ part,
                              float* __restrict__ out, long long n,
                              int parts) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int q = 1; q < parts; ++q) s += part[q * n + i];
    out[i] = s;
  }
}

// Fragment layout (warp w of the warpgroup, lane l, g = l / 4, t = l % 4):
// the A operand of a k8 step is a0 = A[g][t], a1 = A[g+8][t],
// a2 = A[g][t+4], a3 = A[g+8][t+4] of the warp's 16 rows; element 4j + e
// of the accumulator is row 16w + g (e < 2) or 16w + g + 8 and column
// 8j + 2t + (e & 1).
template <int NI>
__global__ void __launch_bounds__(kThreads, 1)
cin_layer_wgmma(const __grid_constant__ Params p) {
  constexpr uint32_t STAGE_BYTES = stage_floats(NI) * 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 127) & ~127u) - raw;
  const uint32_t sW = raw + pad;  // stage s at sW + s * STAGE_BYTES
  float* x0s_all = reinterpret_cast<float*>(smem_raw + pad +
                                            kStages * STAGE_BYTES);
  const uint32_t bars = sW + kStages * STAGE_BYTES + 2 * p.mp * kX0Stride * 4;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (kStages + s)

  const long long tile = blockIdx.x;
  const int part = blockIdx.y, nt = blockIdx.z;
  const long long st0 = p.T * part / p.parts;
  const long long st1 = p.T * (part + 1) / p.parts;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread streams the stages of W ---------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const float* src = p.ws + (nt * p.T + st0) * stage_floats(NI);
      int t = 0;
      for (long long st = st0; st < st1; ++st, ++t) {
        const int s = t % kStages;
        mbar_wait(bars + 8 * (kStages + s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * s, STAGE_BYTES);
        bulk_load(sW + s * STAGE_BYTES, src, STAGE_BYTES, bars + 8 * s);
        src += stage_floats(NI);
      }
    }
  } else {
    // ---- consumers: 64 rows (b, d) each ------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const long long R0 = tile * kBM + 64 * c;  // this consumer's first row
    float* x0s = x0s_all + c * p.mp * kX0Stride;
    const long long mD = static_cast<long long>(p.m) * p.D;
    // x0s[mm][r] = x0[b, mm, d] of row R0 + r = b*D + d; 0 past M and m
    for (int i = tid; i < p.mp * 64; i += 128) {
      const int mm = i >> 6, r = i & 63;
      const long long R = R0 + r;
      float v = 0.f;
      if (R < p.M && mm < p.m) {
        const long long b = R / p.D;
        v = p.x0[b * mD + mm * p.D + (R - b * p.D)];
      }
      x0s[mm * kX0Stride + r] = v;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

    const int r1 = 16 * warp + g, r2 = r1 + 8;  // this thread's rows
    const long long R1 = R0 + r1, R2 = R0 + r2;
    const bool v1 = R1 < p.M, v2 = R2 < p.M;
    const long long b1 = v1 ? R1 / p.D : 0, b2 = v2 ? R2 / p.D : 0;
    const int d1 = static_cast<int>(v1 ? R1 - b1 * p.D : 0);
    const int d2 = static_cast<int>(v2 ? R2 - b2 * p.D : 0);
    const long long HD = static_cast<long long>(p.H) * p.D;
    const float* xk1 = p.xk + b1 * HD + d1;  // + h * D
    const float* xk2 = p.xk + b2 * HD + d2;
    const int steps_per_h = p.mp / 8;

    // Each stage's products are summed by the tensor cores into acc and
    // then added to tot by the float32 adders (round to nearest): the
    // tensor cores' own long sums round less well.
    float acc[NI / 2], tot[NI / 2];
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) tot[i] = 0.f;

    int t = 0;
    for (long long st = st0; st < st1; ++st, ++t) {
      // this stage's A fragments: z = xk[b, h, d] * x0[b, mm, d] at
      // mm = mm0 + t and mm0 + t + 4 of k8 step (h, mm0), split in hi, lo
      const long long J = st * kKS;
      int h = static_cast<int>(J / steps_per_h);
      int mm0 = static_cast<int>(J - static_cast<long long>(h) * steps_per_h) * 8;
      uint32_t ahi[kKS][4], alo[kKS][4];
#pragma unroll
      for (int j = 0; j < kKS; ++j) {
        const bool hv = h < p.H;
        const float xa = hv && v1 ? __ldg(xk1 + static_cast<long long>(h) * p.D) : 0.f;
        const float xb = hv && v2 ? __ldg(xk2 + static_cast<long long>(h) * p.D) : 0.f;
        const float* xr = x0s + (mm0 + t4) * kX0Stride;
        split_tf32(xa * xr[r1], ahi[j][0], alo[j][0]);
        split_tf32(xb * xr[r2], ahi[j][1], alo[j][1]);
        split_tf32(xa * xr[4 * kX0Stride + r1], ahi[j][2], alo[j][2]);
        split_tf32(xb * xr[4 * kX0Stride + r2], ahi[j][3], alo[j][3]);
        mm0 += 8;
        if (mm0 == p.mp) {
          mm0 = 0;
          ++h;
        }
      }

      const int s = t % kStages;
      mbar_wait(bars + 8 * s, (t / kStages) & 1);
      const uint32_t s_hi = sW + s * STAGE_BYTES;
      const uint32_t s_lo = s_hi + STAGE_BYTES / 2;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKS; ++j) {
        // k8 step j: core-matrix columns 2j (k 0-3) and 2j + 1 (k 4-7),
        // NI rows each: LBO (k) = NI * 16 bytes, SBO (8 rows n) = 128
        const uint32_t off = j * 2 * NI * 16;
        const uint64_t dh = smem_desc(s_hi + off, NI * 16, 128, 0);
        const uint64_t dl = smem_desc(s_lo + off, NI * 16, 128, 0);
        wgmma_tf32(acc, ahi[j], dh, j > 0);  // the stage's first overwrites
        wgmma_tf32(acc, ahi[j], dl, 1);
        wgmma_tf32(acc, alo[j], dh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) tot[i] += acc[i];
    }

    float* out = p.out + part * p.part_stride;
    const long long H2D = static_cast<long long>(p.H2) * p.D;
#pragma unroll
    for (int j = 0; j < NI / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = nt * NI + 8 * j + 2 * t4 + (e & 1);
        const bool ok = n < p.H2 && (e < 2 ? v1 : v2);
        if (ok)
          out[(e < 2 ? b1 : b2) * H2D + static_cast<long long>(n) * p.D +
              (e < 2 ? d1 : d2)] = tot[4 * j + e];
      }
    }
  }
}

struct Plan {
  int ni;           // N tile width (the wgmma's N): 16, 64 or 200
  int nt;           // N tiles
  int mp;           // m rounded up to a multiple of 8
  long long T;      // stages over the padded K
  long long tiles;  // M tiles of kBM rows
  int parts;        // K parts (1: no second pass)
};

// The N tile an output of H2 fields takes.
int n_tile(int H2) { return H2 <= 16 ? 16 : (H2 <= 64 ? 64 : 200); }

// Dynamic shared memory of one layer launch at N tile ni with mp staged
// rows: 128 of alignment, the W ring, the staged rows (hi and lo) and the
// ring's barriers.
long long layer_smem(int ni, int mp) {
  return 128 + kStages * stage_floats(ni) * 4 + 2LL * mp * kX0Stride * 4 +
         16 * kStages;
}

cudaError_t make_plan(long long B, int m, int H, int H2, int D, Plan* pl) {
  pl->ni = n_tile(H2);
  pl->nt = (H2 + pl->ni - 1) / pl->ni;
  pl->mp = (m + 7) / 8 * 8;
  pl->T = (static_cast<long long>(H) * (pl->mp / 8) + kKS - 1) / kKS;
  pl->tiles = (B * D + kBM - 1) / kBM;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long blocks = pl->tiles * pl->nt;
  long long parts = blocks < sms ? sms / blocks : 1;
  if (parts > pl->T) parts = pl->T;
  pl->parts = static_cast<int>(parts < 1 ? 1 : parts);
  if (pl->tiles > 0x7fffffffLL || pl->nt > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

long long split_w_floats(const Plan& pl) {
  return pl.nt * pl.T * stage_floats(pl.ni);
}

// The card's opt-in limit of dynamic shared memory a block may use.
cudaError_t smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

template <int NI>
cudaError_t launch_layer(const Params& p, const Plan& pl,
                         cudaStream_t stream) {
  const long long smem = layer_smem(NI, pl.mp);
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  if (smem > limit) return cudaErrorInvalidValue;   // too many fields m
  err = cudaFuncSetAttribute(
      cin_layer_wgmma<NI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(pl.tiles), pl.parts, pl.nt);
  cin_layer_wgmma<NI><<<grid, kThreads, static_cast<size_t>(smem),
                        stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The most staged rows m (a multiple of 8) a layer launch beside an output
// of H2 fields takes on the current device: its shared memory's limit.
// Returns a CUDA error (0 on success).
extern "C" int cin_layer_max_fields(int H2, int* m) {
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ni = n_tile(H2);
  int most = 0;
  while (layer_smem(ni, most + 8) <= limit) most += 8;
  *m = most;
  return 0;
}

// Scratch the wrapper allocates for one layer (float32 elements):
// sizes[0] for W's split parts, sizes[1] for the K parts' partial outputs
// (0 when K is not split). Returns a CUDA error (0 on success).
extern "C" int cin_layer_workspace(long long B, int m, int H, int H2, int D,
                                   long long* sizes) {
  Plan pl;
  cudaError_t err = make_plan(B, m, H, H2, D, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  sizes[0] = split_w_floats(pl);
  sizes[1] = pl.parts > 1 ? pl.parts * B * H2 * D : 0;
  return 0;
}

// x0 [B, m, D], xk [B, H, D], w [H2, H, m] and out [B, H2, D]: contiguous
// float32 on one device; ws and part: the scratch of cin_layer_workspace.
// Requires 1 <= m <= cin_layer_max_fields(H2) and 1 <= D <= 128 (the
// wrapper, kernel.py, checks shapes, types, strides, devices and that limit
// first; a launch over it is refused). Launches on `stream` without
// synchronising and returns the CUDA error of the launches (0 on success;
// B = 0 launches nothing).
extern "C" int cin_layer_launch(const float* x0, const float* xk,
                                const float* w, float* out, float* ws,
                                float* part, long long B, int m, int H,
                                int H2, int D, void* stream_ptr) {
  if (B == 0) return 0;
  if (m < 1 || D < 1 || D > 128 || H < 1 || H2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t err = make_plan(B, m, H, H2, D, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  const long long total = split_w_floats(pl);
  const long long want = (total + 255) / 256;
  cin_split_w<<<static_cast<unsigned>(want < 4096 ? want : 4096), 256, 0,
                stream>>>(w, ws, m, H, H2, pl.mp, pl.T, pl.ni, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Params p;
  p.x0 = x0;
  p.xk = xk;
  p.ws = ws;
  p.out = pl.parts > 1 ? part : out;
  p.M = B * D;
  p.part_stride = B * H2 * D;
  p.T = pl.T;
  p.m = m;
  p.H = H;
  p.H2 = H2;
  p.D = D;
  p.mp = pl.mp;
  p.parts = pl.parts;
  switch (pl.ni) {
    case 16: err = launch_layer<16>(p, pl, stream); break;
    case 64: err = launch_layer<64>(p, pl, stream); break;
    default: err = launch_layer<200>(p, pl, stream); break;
  }
  if (err != cudaSuccess || pl.parts == 1) return static_cast<int>(err);

  const long long n = B * H2 * D;
  const long long blocks = (n + 255) / 256;
  cin_sum_parts<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256,
                  0, stream>>>(part, out, n, pl.parts);
  return static_cast<int>(cudaGetLastError());
}


// ---- the gradients ---------------------------------------------------------

namespace {

constexpr int kStageK = kKS * 8;   // values of k per stage (16)

// One stage's products into acc: per k8 step, wgmma m64nNIk8 of A_hi B_hi,
// A_hi B_lo and A_lo B_hi, B the stage's hi tile at s_hi and its lo tile
// after it (the layer's stage layout); `first`: the stage's first product
// overwrites acc.
template <int NI>
__device__ __forceinline__ void stage_products(float (&acc)[NI / 2],
                                               const uint32_t (&ahi)[kKS][4],
                                               const uint32_t (&alo)[kKS][4],
                                               uint32_t s_hi, bool first) {
  constexpr uint32_t kHalf = stage_floats(NI) * 2;   // bytes of the hi tile
#pragma unroll
  for (int j = 0; j < kKS; ++j) {
    // k8 step j: core-matrix columns 2j (k 0-3) and 2j + 1 (k 4-7), NI rows
    // each: LBO (k) = NI * 16 bytes, SBO (8 rows n) = 128
    const uint32_t off = j * 2 * NI * 16;
    const uint64_t dh = smem_desc(s_hi + off, NI * 16, 128, 0);
    const uint64_t dl = smem_desc(s_hi + kHalf + off, NI * 16, 128, 0);
    wgmma_tf32(acc, ahi[j], dh, first && j == 0 ? 0 : 1);
    wgmma_tf32(acc, ahi[j], dl, 1);
    wgmma_tf32(acc, alo[j], dh, 1);
  }
}

// A ring of S slots' barriers (full[s] = bars + 8 s: `full` arrivals, the
// copy's among them, and the copy's bytes; empty[s] = bars + 8 (S + s), one
// arrival per consumer warp), initialised by thread 0 before the block's
// first barrier.
template <int S>
__device__ __forceinline__ void ring_init(uint32_t bars, uint32_t full) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, full);
      mbar_init(bars + 8 * (S + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer: one thread streams `count` consecutive stages of `bytes`
// each from `src` into the S-slot ring of `slot` bytes a slot at sW.
template <int S>
__device__ __forceinline__ void produce(const float* src, long long count,
                                        uint32_t sW, uint32_t bars,
                                        uint32_t bytes, uint32_t slot) {
  for (long long t = 0; t < count; ++t) {
    const int s = static_cast<int>(t % S);
    mbar_wait(bars + 8 * (S + s), ((t / S) & 1) ^ 1);
    mbar_expect_tx(bars + 8 * s, bytes);
    bulk_load(sW + s * slot, src, bytes, bars + 8 * s);
    src += bytes / 4;
  }
}

// 4 bytes global -> shared by cp.async, or 4 zero bytes where !valid (no
// read of src).
__device__ __forceinline__ void copy4(uint32_t dst, const float* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// A consumer warp is done with slot s of an S-slot ring.
template <int S>
__device__ __forceinline__ void release(uint32_t bars, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bars + 8 * (S + s));
}

// dy's hi and lo parts in cin_dw_wgmma's stage tiles: the layer's W layout
// with dy's n for W's rows and k = (b, d) for its columns,
// ds[(sid sf) + part sf/2 + (q ni + n') 4 + j] = part of dy[b, nt ni + n',
// d] at k = 16 st + 4 q + j = b D + d, sid = nt T + st; 0 past K = B D and
// past H2. A block per stage tile (grid-strided), a thread per value.
__global__ void cin_split_dy(const float* __restrict__ dy,
                             float* __restrict__ ds, unsigned K, int H2,
                             int D, int T, int ni, int tiles) {
  const int sf = static_cast<int>(stage_floats(ni)), half = sf / 2;
  for (int sid = blockIdx.x; sid < tiles; sid += gridDim.x) {
    const int nt = sid / T, st = sid - nt * T;
    float* dst = ds + static_cast<long long>(sid) * sf;
    for (int e = threadIdx.x; e < sf; e += blockDim.x) {
      const bool lo_part = e >= half;
      const int f = lo_part ? e - half : e;
      const int q = f / (ni * 4), rem = f - q * ni * 4;
      const int n = nt * ni + (rem >> 2);
      const unsigned k = static_cast<unsigned>(kStageK) * st + 4u * q +
                         (rem & 3);
      float v = 0.f;
      if (k < K && n < H2) {
        const unsigned b = k / D;
        v = dy[(static_cast<long long>(b) * H2 + n) * D + (k - b * D)];
      }
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      dst[e] = __uint_as_float(lo_part ? lo : hi);
    }
  }
}

// W^T's hi and lo parts in cin_dx_wgmma's stage tiles: columns c = h mp + mm
// of U, k = n: ws[(sid sf) + part sf/2 + (q ni + c') 4 + j] = part of W[n,
// h, mm] at c = nt ni + c', n = 16 st + 4 q + j, sid = nt T + st; 0 at n >=
// H2, h >= H and mm >= m.
__global__ void cin_split_wt(const float* __restrict__ w,
                             float* __restrict__ ws, int m, int H, int H2,
                             int mp, int T, int ni, int tiles) {
  const int sf = static_cast<int>(stage_floats(ni)), half = sf / 2;
  for (int sid = blockIdx.x; sid < tiles; sid += gridDim.x) {
    const int nt = sid / T, st = sid - nt * T;
    float* dst = ws + static_cast<long long>(sid) * sf;
    for (int e = threadIdx.x; e < sf; e += blockDim.x) {
      const bool lo_part = e >= half;
      const int f = lo_part ? e - half : e;
      const int q = f / (ni * 4), rem = f - q * ni * 4;
      const int c = nt * ni + (rem >> 2);
      const int n = kStageK * st + 4 * q + (rem & 3);
      const int h = c / mp, mm = c - h * mp;
      float v = 0.f;
      if (n < H2 && h < H && mm < m)
        v = w[(static_cast<long long>(n) * H + h) * m + mm];
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      dst[e] = __uint_as_float(lo_part ? lo : hi);
    }
  }
}

struct DwParams {
  const float* x0;
  const float* xk;
  const float* ds;         // split dy: [n tile][stage][hi | lo][k/4][NI][4]
  float* out;              // dW, or the K parts' partial outputs
  long long part_stride;   // floats between partial outputs (H2 * H * m)
  int B, T;                // batch rows; stages over K = B * D
  int m, H, H2, D, mp;
  int groups;              // 16-row groups: ceil(H / 2) * mp / 8
  int parts;
};

// A stage's A inputs in shared memory beside its dy tile: per k (16 rows
// of kDwCols floats), x0 at the fields of the block's 8 groups (column 8 gi
// + g: group gi's field g) and xk at their filters (column 64 + 2 gi + hh).
// The row pitch of 88 floats makes a warp's reads (8 fields of one group
// at 4 values of k) conflict-free. The full barrier of a stage counts the
// dy copy's arrival and one per loader lane.
constexpr int kDwCols = 80;       // 64 fields + 16 filters: a loader each
constexpr int kDwPitch = 88;
constexpr uint32_t kDwSliceBytes = kStageK * kDwPitch * 4;

// M tile t holds 16-row groups 8 t .. 8 t + 7, consumer c the four from 8 t +
// 4 c, warp w one. Group G is filters h = 2 (G div (mp/8)) and h + 1 at
// fields mm = 8 (G mod (mp/8)) + g: fragment rows g and g + 8.
template <int NI>
__global__ void __launch_bounds__(kThreads, 1)
cin_dw_wgmma(const __grid_constant__ DwParams p) {
  constexpr uint32_t STAGE_BYTES = stage_floats(NI) * 4;
  constexpr uint32_t SLOT_BYTES = STAGE_BYTES + kDwSliceBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 127) & ~127u) - raw;
  const uint32_t sW = raw + pad;   // slot s: dy tile, then the A slice
  float* slots = reinterpret_cast<float*>(smem_raw + pad);
  const uint32_t bars = sW + kStages * SLOT_BYTES;
  const int tile = blockIdx.x, part = blockIdx.y, nt = blockIdx.z;
  const int st0 = static_cast<int>(static_cast<long long>(p.T) * part /
                                   p.parts);
  const int st1 = static_cast<int>(static_cast<long long>(p.T) * (part + 1) /
                                   p.parts);
  const int wg = threadIdx.x / 128;
  const int per_pair = p.mp / 8;
  ring_init<kStages>(bars, 1 + kDwCols);   // the dy copy, each loader

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      // ---- producer: one thread streams this part's stages of split dy ----
      produce<kStages>(p.ds + (static_cast<long long>(nt) * p.T + st0) *
                                  stage_floats(NI),
                       st1 - st0, sW, bars, STAGE_BYTES, SLOT_BYTES);
    } else if (threadIdx.x >= 32 && threadIdx.x < 32 + kDwCols) {
      // ---- loaders: lane col copies column col of each stage's A slice by
      // cp.async (4 bytes, zero-filled where there is no value) and arrives
      // on the stage's full barrier when its copies land: several stages
      // in flight per lane, no registers held
      const int col = threadIdx.x - 32;
      const bool fld = col < 64;
      const int gi = fld ? col >> 3 : (col - 64) >> 1;
      const int G = 8 * tile + gi;
      const int hp = G / per_pair;
      const int h = 2 * hp + (fld ? 0 : (col - 64) & 1);
      const int mm = 8 * (G - hp * per_pair) + (fld ? col & 7 : 0);
      const bool ok = G < p.groups && (fld ? mm < p.m : h < p.H);
      const long long row = fld ? static_cast<long long>(p.m) * p.D
                                : static_cast<long long>(p.H) * p.D;
      const float* base = (fld ? p.x0 : p.xk) +
                          (ok ? static_cast<long long>(fld ? mm : h) * p.D
                              : 0);
      const unsigned k0 = static_cast<unsigned>(kStageK) * st0;
      int b = static_cast<int>(k0 / p.D), d = static_cast<int>(k0 % p.D);
      for (int t = 0; t < st1 - st0; ++t) {
        const int s = t % kStages;
        mbar_wait(bars + 8 * (kStages + s), ((t / kStages) & 1) ^ 1);
        const uint32_t dst = sW + s * SLOT_BYTES + STAGE_BYTES + 4 * col;
#pragma unroll
        for (int kk = 0; kk < kStageK; ++kk) {
          const bool in = ok && b < p.B;
          copy4(dst + kk * kDwPitch * 4, in ? base + b * row + d : p.x0, in);
          if (++d == p.D) {
            d = 0;
            ++b;
          }
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     ::"r"(bars + 8 * s) : "memory");
      }
    }
  } else {
    // ---- consumers: 64 rows (h, mm) each -----------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int gi = 4 * c + warp, G = 8 * tile + gi;
    const int hp = G / per_pair;
    const int h1 = 2 * hp, h2 = h1 + 1, mm = 8 * (G - hp * per_pair) + g;
    const bool gv = G < p.groups && mm < p.m;
    const bool v1 = gv && h1 < p.H, v2 = gv && h2 < p.H;

    float acc[NI / 2], tot[NI / 2];
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) tot[i] = 0.f;
    int t = 0;
    for (int st = st0; st < st1; ++st, ++t) {
      const int s = t % kStages;
      mbar_wait(bars + 8 * s, (t / kStages) & 1);
      // A[r][k] = xk[b, h_r, d] * x0[b, mm, d]: a0, a1 at k = t4 (rows g,
      // g + 8), a2, a3 at k = t4 + 4 of k8 step j
      const float* slice = slots + (s * SLOT_BYTES + STAGE_BYTES) / 4;
      uint32_t ahi[kKS][4], alo[kKS][4];
#pragma unroll
      for (int j = 0; j < kKS; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* r = slice + (8 * j + 4 * e + t4) * kDwPitch;
          const float x0v = r[8 * gi + g];
          split_tf32(r[64 + 2 * gi] * x0v, ahi[j][2 * e], alo[j][2 * e]);
          split_tf32(r[65 + 2 * gi] * x0v, ahi[j][2 * e + 1],
                     alo[j][2 * e + 1]);
        }
      }
      reg_fence(acc);
      wgmma_fence();
      stage_products<NI>(acc, ahi, alo, sW + s * SLOT_BYTES, true);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      release<kStages>(bars, s, lane);
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) tot[i] += acc[i];
    }

    // element 4j + e: row g (e < 2: h1) or g + 8 (h2), column n = 8j + 2 t4
    // + (e & 1)
    float* out = p.out + part * p.part_stride;
#pragma unroll
    for (int j = 0; j < NI / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = nt * NI + 8 * j + 2 * t4 + (e & 1);
        if (n < p.H2 && (e < 2 ? v1 : v2))
          out[(static_cast<long long>(n) * p.H + (e < 2 ? h1 : h2)) * p.m +
              mm] = tot[4 * j + e];
      }
    }
  }
}

struct DxParams {
  const float* x0;
  const float* xk;
  const float* dy;
  const float* ws;         // split W^T: [n tile][stage][hi | lo][k/4][NI][4]
  float* dx0;              // dx0, or the N parts' partial dx0
  float* dxk;
  long long M;             // B * D
  long long part_stride;   // floats between partial dx0 (B * m * D)
  int T;                   // stages over K = H2
  int pitch;               // floats per staged dy row (dx_pitch)
  int ntn;                 // N tiles over H * mp
  int m, H, H2, D, parts;
  int need_x0, need_xk;
};

constexpr int kDxStages = 4;   // W^T ring: the staged dy rows take the rest

// Floats per row of the staged dy: the T stages' 16 T values of n, rounded
// to 32 T' + 4 so that a warp's reads (rows g at 4 values of n) hit 32
// banks.
__host__ __device__ constexpr int dx_pitch(int T) {
  return 32 * ((T + 1) / 2) + 4;
}

// Dynamic shared memory of a dx launch: 128 of alignment, the W^T ring, the
// two consumers' staged dy rows and the ring's barriers.
long long dx_smem(int ni, int T) {
  return 128 + kDxStages * stage_floats(ni) * 4 + 4LL * kBM * dx_pitch(T) +
         16 * kDxStages;
}

// Rows (b, d) as in the layer kernel: M tile t, consumer c, rows 128 t + 64 c
// + 16 w + g and + 8. An N tile is HS = NI / MP whole filters.
template <int NI, int MP>
__global__ void __launch_bounds__(kThreads, 1)
cin_dx_wgmma(const __grid_constant__ DxParams p) {
  constexpr uint32_t STAGE_BYTES = stage_floats(NI) * 4;
  constexpr int HS = NI / MP, J8 = MP / 8;
  static_assert(NI % MP == 0 && MP % 8 == 0, "an N tile of whole filters");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 127) & ~127u) - raw;
  const uint32_t sW = raw + pad;
  float* dys_all = reinterpret_cast<float*>(smem_raw + pad +
                                            kDxStages * STAGE_BYTES);
  const uint32_t bars = sW + kDxStages * STAGE_BYTES + 4 * kBM * p.pitch;
  const long long tile = blockIdx.x;
  const int part = blockIdx.y;
  const int nt0 = p.ntn * part / p.parts, nt1 = p.ntn * (part + 1) / p.parts;
  const int wg = threadIdx.x / 128;
  ring_init<kDxStages>(bars, 1);

  if (wg == 0) {
    // ---- producer: one thread streams this part's N tiles of split W^T ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      produce<kDxStages>(
          p.ws + static_cast<long long>(nt0) * p.T * stage_floats(NI),
          static_cast<long long>(nt1 - nt0) * p.T, sW, bars, STAGE_BYTES,
          STAGE_BYTES);
  } else {
    // ---- consumers: 64 rows (b, d) each ------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const long long R0 = tile * kBM + 64 * c;   // this consumer's first row
    const long long H2D = static_cast<long long>(p.H2) * p.D;
    const long long HD = static_cast<long long>(p.H) * p.D;
    const long long mD = static_cast<long long>(p.m) * p.D;

    // dys[r][n] = dy[b, n, d] of row R0 + r = b D + d, once for all N
    // tiles; 0 past M and H2. Thread tid fills row tid % 64.
    float* dys = dys_all + c * 64 * p.pitch;
    {
      const int r = tid & 63;
      const long long R = R0 + r;
      const bool ok = R < p.M;
      const long long b = ok ? R / p.D : 0;
      const float* src = p.dy + b * H2D + (ok ? R - b * p.D : 0);
      for (int n = tid >> 6; n < kStageK * p.T; n += 2)
        dys[r * p.pitch + n] = ok && n < p.H2 ? src[n * p.D] : 0.f;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

    const int r1 = 16 * warp + g, r2 = r1 + 8;   // this thread's rows
    const long long R1 = R0 + r1, R2 = R0 + r2;
    const bool v1 = R1 < p.M, v2 = R2 < p.M;
    const long long b1 = v1 ? R1 / p.D : 0, b2 = v2 ? R2 / p.D : 0;
    const int d1 = static_cast<int>(v1 ? R1 - b1 * p.D : 0);
    const int d2 = static_cast<int>(v2 ? R2 - b2 * p.D : 0);
    const float* xk1 = p.xk + b1 * HD + d1;
    const float* xk2 = p.xk + b2 * HD + d2;
    const float* dy1 = dys + r1 * p.pitch + t4;   // + n - t4
    const float* dy2 = dys + r2 * p.pitch + t4;

    // x0 at this thread's fields mm = 8 i + 2 t4 + e, and dx0's sums there
    float x0v[2][2 * J8], dx0a[2][2 * J8];
#pragma unroll
    for (int i = 0; i < J8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int mm = 8 * i + 2 * t4 + e;
        x0v[0][2 * i + e] = v1 && mm < p.m ? p.x0[b1 * mD + mm * p.D + d1]
                                           : 0.f;
        x0v[1][2 * i + e] = v2 && mm < p.m ? p.x0[b2 * mD + mm * p.D + d2]
                                           : 0.f;
        dx0a[0][2 * i + e] = 0.f;
        dx0a[1][2 * i + e] = 0.f;
      }
    }

    int t = 0;   // ring position over all of this part's stages
    for (int nt = nt0; nt < nt1; ++nt) {
      float acc[NI / 2];
      for (int st = 0; st < p.T; ++st, ++t) {
        // A[r][n] = dy[b_r, n, d_r]: a0, a1 at n = 16 st + 8 j + t4 (rows
        // r1, r2), a2, a3 at n + 4
        uint32_t ahi[kKS][4], alo[kKS][4];
#pragma unroll
        for (int j = 0; j < kKS; ++j) {
          const int n = kStageK * st + 8 * j;
          split_tf32(dy1[n], ahi[j][0], alo[j][0]);
          split_tf32(dy2[n], ahi[j][1], alo[j][1]);
          split_tf32(dy1[n + 4], ahi[j][2], alo[j][2]);
          split_tf32(dy2[n + 4], ahi[j][3], alo[j][3]);
        }
        const int s = t % kDxStages;
        mbar_wait(bars + 8 * s, (t / kDxStages) & 1);
        reg_fence(acc);
        wgmma_fence();
        stage_products<NI>(acc, ahi, alo, sW + s * STAGE_BYTES, st == 0);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
        release<kDxStages>(bars, s, lane);
      }

      // the epilogue: element 4j + e of acc is row g (e < 2) or g + 8 at
      // column 8j + 2 t4 + (e & 1) = filter h0 + j / J8, field 8 (j % J8) +
      // 2 t4 + (e & 1)
      const int h0 = nt * HS;
#pragma unroll
      for (int hl = 0; hl < HS; ++hl) {
        const int h = h0 + hl;
        const float xa = v1 && h < p.H ? xk1[static_cast<long long>(h) * p.D]
                                       : 0.f;
        const float xb = v2 && h < p.H ? xk2[static_cast<long long>(h) * p.D]
                                       : 0.f;
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < J8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float u1 = acc[4 * (hl * J8 + i) + e];
            const float u2 = acc[4 * (hl * J8 + i) + 2 + e];
            dx0a[0][2 * i + e] = fmaf(xa, u1, dx0a[0][2 * i + e]);
            dx0a[1][2 * i + e] = fmaf(xb, u2, dx0a[1][2 * i + e]);
            s1 = fmaf(x0v[0][2 * i + e], u1, s1);
            s2 = fmaf(x0v[1][2 * i + e], u2, s2);
          }
        }
        if (p.need_xk) {
          // the quad's four partial sums: (s0 + s1) + (s2 + s3) in every lane
          s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
          s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
          s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
          if (t4 == (hl & 3) && h < p.H) {
            if (v1) p.dxk[b1 * HD + static_cast<long long>(h) * p.D + d1] = s1;
            if (v2) p.dxk[b2 * HD + static_cast<long long>(h) * p.D + d2] = s2;
          }
        }
      }
    }

    if (p.need_x0) {
      float* out = p.dx0 + part * p.part_stride;
#pragma unroll
      for (int i = 0; i < J8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mm = 8 * i + 2 * t4 + e;
          if (mm >= p.m) continue;
          if (v1) out[b1 * mD + mm * p.D + d1] = dx0a[0][2 * i + e];
          if (v2) out[b2 * mD + mm * p.D + d2] = dx0a[1][2 * i + e];
        }
      }
    }
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Blocks of a launch over `blocks` tiles that fill the card: `sms / blocks`
// parts where the tiles are fewer than the SMs, at most `most`, at least 1.
int fill_parts(long long blocks, int sms, long long most) {
  long long parts = blocks < sms ? sms / blocks : 1;
  if (parts > most) parts = most;
  return static_cast<int>(parts < 1 ? 1 : parts);
}

// The dW launch: N tile ni (n_tile) over nt tiles, mp, 16-row groups, M
// tiles of 8 groups, stages T over K = B D, K parts; scratch floats of the
// split dy and of the partial outputs.
struct DwPlan {
  int ni, nt, mp, groups, tiles, T, parts;
  long long split_floats, part_floats;
};

cudaError_t make_dw_plan(long long B, int m, int H, int H2, int D,
                         DwPlan* pl) {
  const long long K = B * D;
  if (B < 1 || m < 1 || H < 1 || H2 < 1 || D < 1 || D > 128 ||
      K > 0x7fffffffLL - kStageK)
    return cudaErrorInvalidValue;
  pl->ni = n_tile(H2);
  pl->nt = (H2 + pl->ni - 1) / pl->ni;
  pl->mp = (m + 7) / 8 * 8;
  pl->groups = (H + 1) / 2 * (pl->mp / 8);
  pl->tiles = (pl->groups + 7) / 8;
  pl->T = static_cast<int>((K + kStageK - 1) / kStageK);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  pl->parts = fill_parts(static_cast<long long>(pl->tiles) * pl->nt, sms,
                         pl->T);
  if (pl->nt > 65535 || pl->parts > 65535) return cudaErrorInvalidValue;
  pl->split_floats = static_cast<long long>(pl->nt) * pl->T *
                     stage_floats(pl->ni);
  pl->part_floats = pl->parts > 1
                        ? static_cast<long long>(pl->parts) * H2 * H * m
                        : 0;
  return cudaSuccess;
}

// The dx launch: N tile ni of ni / mp whole filters over ntn tiles, mp (8 or
// 40), stages T over K = H2, M tiles of kBM rows (b, d), N parts; scratch
// floats of the split W^T and of the partial dx0.
struct DxPlan {
  int ni, mp, ntn, T, parts;
  long long tiles, split_floats, part_floats;
};

cudaError_t make_dx_plan(long long B, int m, int H, int H2, int D,
                         DxPlan* pl) {
  if (B < 1 || m < 1 || H < 1 || H2 < 1 || D < 1 || D > 128)
    return cudaErrorInvalidValue;
  pl->mp = (m + 7) / 8 * 8;
  if (pl->mp == 40) {
    pl->ni = 200;
  } else if (pl->mp == 8) {
    // the tile that pads H * 8 columns least (the wider on a tie)
    const int cand[3] = {200, 64, 16};
    long long best = -1;
    for (int i = 0; i < 3; ++i) {
      const long long cols = (8LL * H + cand[i] - 1) / cand[i] * cand[i];
      if (best < 0 || cols < best) {
        best = cols;
        pl->ni = cand[i];
      }
    }
  } else {
    return cudaErrorInvalidValue;   // fields the kernel does not take
  }
  const int hs = pl->ni / pl->mp;
  pl->ntn = (H + hs - 1) / hs;
  pl->T = (H2 + kStageK - 1) / kStageK;
  pl->tiles = (B * D + kBM - 1) / kBM;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  pl->parts = fill_parts(pl->tiles, sms, pl->ntn);
  if (pl->tiles > 0x7fffffffLL || pl->parts > 65535)
    return cudaErrorInvalidValue;
  pl->split_floats = static_cast<long long>(pl->ntn) * pl->T *
                     stage_floats(pl->ni);
  pl->part_floats = pl->parts > 1 ? pl->parts * B * m * D : 0;
  return cudaSuccess;
}

// Grid of a split pass over `tiles` stage tiles.
unsigned split_grid(long long tiles) {
  return static_cast<unsigned>(tiles < 2048 ? tiles : 2048);
}

cudaError_t sum_parts(const float* part, float* out, long long n, int parts,
                      cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  cin_sum_parts<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256,
                  0, stream>>>(part, out, n, parts);
  return cudaGetLastError();
}

template <int NI>
cudaError_t launch_dw(const DwParams& p, const DwPlan& pl,
                      cudaStream_t stream) {
  // 128 of alignment, the ring's slots (dy tile and A slice), barriers
  const long long smem = 128 + kStages * (stage_floats(NI) * 4 +
                                          kDwSliceBytes) + 16 * kStages;
  cudaError_t err = cudaFuncSetAttribute(
      cin_dw_wgmma<NI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(pl.tiles, pl.parts, pl.nt);
  cin_dw_wgmma<NI><<<grid, kThreads, static_cast<size_t>(smem), stream>>>(p);
  return cudaGetLastError();
}

template <int NI, int MP>
cudaError_t launch_dx(const DxParams& p, const DxPlan& pl,
                      cudaStream_t stream) {
  const long long smem = dx_smem(NI, pl.T);
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  if (smem > limit) return cudaErrorInvalidValue;   // too long a K = H2
  err = cudaFuncSetAttribute(
      cin_dx_wgmma<NI, MP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(pl.tiles), pl.parts);
  cin_dx_wgmma<NI, MP><<<grid, kThreads, static_cast<size_t>(smem),
                         stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The dW launch's plan on the current device: out[0..8] = N tile, N tiles,
// mp, 16-row groups, M tiles, stages, K parts, and the scratch floats of the
// split dy and of the partial outputs (the wrapper allocates both). Returns
// a CUDA error (0 on success).
extern "C" int cin_dw_plan(long long B, int m, int H, int H2, int D,
                           long long* out) {
  DwPlan pl;
  cudaError_t err = make_dw_plan(B, m, H, H2, D, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long v[9] = {pl.ni, pl.nt, pl.mp, pl.groups, pl.tiles, pl.T,
                          pl.parts, pl.split_floats, pl.part_floats};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// dW [H2, H, m] = sum over the batch of dy[b, n, d] xk[b, h, d] x0[b, m, d]
// for x0 [B, m, D], xk [B, H, D] and dy [B, H2, D], contiguous float32 on
// one device; ds and part: the scratch of cin_dw_plan. Requires B >= 1,
// 1 <= D <= 128 and m, H, H2 >= 1 (the wrapper, kernel.py, checks first).
// Launches on `stream` without synchronising and returns the CUDA error of
// the launches (0 on success).
extern "C" int cin_dw_launch(const float* x0, const float* xk,
                             const float* dy, float* dw, float* ds,
                             float* part, long long B, int m, int H, int H2,
                             int D, void* stream_ptr) {
  DwPlan pl;
  cudaError_t err = make_dw_plan(B, m, H, H2, D, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tiles = pl.nt * pl.T;
  cin_split_dy<<<split_grid(tiles), 256, 0, stream>>>(
      dy, ds, static_cast<unsigned>(B * D), H2, D, pl.T, pl.ni, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  DwParams p;
  p.x0 = x0;
  p.xk = xk;
  p.ds = ds;
  p.out = pl.parts > 1 ? part : dw;
  p.part_stride = static_cast<long long>(H2) * H * m;
  p.B = static_cast<int>(B);
  p.T = pl.T;
  p.m = m;
  p.H = H;
  p.H2 = H2;
  p.D = D;
  p.mp = pl.mp;
  p.groups = pl.groups;
  p.parts = pl.parts;
  switch (pl.ni) {
    case 16: err = launch_dw<16>(p, pl, stream); break;
    case 64: err = launch_dw<64>(p, pl, stream); break;
    default: err = launch_dw<200>(p, pl, stream); break;
  }
  if (err != cudaSuccess || pl.parts == 1) return static_cast<int>(err);
  return static_cast<int>(sum_parts(part, dw, p.part_stride, pl.parts,
                                    stream));
}

// The dx launch's plan on the current device: out[0..8] = N tile, mp, N
// tiles, stages, N parts, M tiles, and the scratch floats of the split W^T
// and of the partial dx0. Returns a CUDA error (0 on success; m whose mp is
// neither 8 nor 40 is cudaErrorInvalidValue).
extern "C" int cin_dx_plan(long long B, int m, int H, int H2, int D,
                           long long* out) {
  DxPlan pl;
  cudaError_t err = make_dx_plan(B, m, H, H2, D, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long v[8] = {pl.ni, pl.mp, pl.ntn, pl.T, pl.parts, pl.tiles,
                          pl.split_floats, pl.part_floats};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// dx0 [B, m, D] and dxk [B, H, D] of a layer on x0 [B, m, D] and xk [B, H,
// D] with filters w [H2, H, m], for dy [B, H2, D], contiguous float32 on one
// device; ws and part: the scratch of cin_dx_plan; need_x0 / need_xk: write
// that gradient (its pointer is not read otherwise). Requires B >= 1, 1 <= D
// <= 128, m, H, H2 >= 1 and m padded to 8 or 40 (the wrapper, kernel.py,
// checks first). Launches on `stream` without synchronising and returns the
// CUDA error of the launches (0 on success).
extern "C" int cin_dx_launch(const float* x0, const float* xk,
                             const float* dy, const float* w, float* dx0,
                             float* dxk, float* ws, float* part, long long B,
                             int m, int H, int H2, int D, int need_x0,
                             int need_xk, void* stream_ptr) {
  DxPlan pl;
  cudaError_t err = make_dx_plan(B, m, H, H2, D, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tiles = pl.ntn * pl.T;
  cin_split_wt<<<split_grid(tiles), 256, 0, stream>>>(w, ws, m, H, H2, pl.mp,
                                                      pl.T, pl.ni, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  DxParams p;
  p.x0 = x0;
  p.xk = xk;
  p.dy = dy;
  p.ws = ws;
  p.dx0 = pl.parts > 1 ? part : dx0;
  p.dxk = dxk;
  p.M = B * D;
  p.part_stride = B * m * D;
  p.T = pl.T;
  p.pitch = dx_pitch(pl.T);
  p.ntn = pl.ntn;
  p.m = m;
  p.H = H;
  p.H2 = H2;
  p.D = D;
  p.parts = pl.parts;
  p.need_x0 = need_x0;
  p.need_xk = need_xk;
  if (pl.mp == 40) err = launch_dx<200, 40>(p, pl, stream);
  else if (pl.ni == 200) err = launch_dx<200, 8>(p, pl, stream);
  else if (pl.ni == 64) err = launch_dx<64, 8>(p, pl, stream);
  else err = launch_dx<16, 8>(p, pl, stream);
  if (err != cudaSuccess || pl.parts == 1 || !need_x0)
    return static_cast<int>(err);
  return static_cast<int>(sum_parts(part, dx0, p.part_stride, pl.parts,
                                    stream));
}
