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
//     176,640 bytes; at m = 128 (the wrapper's limit) 227,328.
//
// Bound (chip_smoke.py computes it from the run's shapes): operations.
// 2*H2*H*m*D flops per batch row and layer, three times over in 3xTF32, at
// the tensor cores' 495 TFLOP/s of TF32: 49.6 ms for a layer with H = 200
// at a serve_bulk batch (262,144 rows), 9.67 ms for layer 1 (H = 39). The
// bytes (x0, xk and W read once, out written once) are about 4.6 GB on a
// layer with H = 200 at that batch, 1.4 ms at 3.35 TB/s. Every M tile
// streams the whole split W (12.8 MB at H = 200) from the 50 MB L2; 128
// rows per tile keep that stream near the L2's rate at the tensor cores'.

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

cudaError_t make_plan(long long B, int m, int H, int H2, int D, Plan* pl) {
  pl->ni = H2 <= 16 ? 16 : (H2 <= 64 ? 64 : 200);
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

template <int NI>
cudaError_t launch_layer(const Params& p, const Plan& pl,
                         cudaStream_t stream) {
  const int smem = static_cast<int>(128 + kStages * stage_floats(NI) * 4 +
                                    2 * pl.mp * kX0Stride * 4 +
                                    16 * kStages);
  cudaError_t err = cudaFuncSetAttribute(
      cin_layer_wgmma<NI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(pl.tiles), pl.parts, pl.nt);
  cin_layer_wgmma<NI><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

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
// Requires 1 <= m <= 128 and 1 <= D <= 128 (the wrapper, kernel.py, checks
// shapes, types, strides and devices first). Launches on `stream` without
// synchronising and returns the CUDA error of the launches (0 on success;
// B = 0 launches nothing).
extern "C" int cin_layer_launch(const float* x0, const float* xk,
                                const float* w, float* out, float* ws,
                                float* part, long long B, int m, int H,
                                int H2, int D, void* stream_ptr) {
  if (B == 0) return 0;
  if (m < 1 || m > 128 || D < 1 || D > 128 || H < 1 || H2 < 1)
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
