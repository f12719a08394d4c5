// One xDeepFM CIN layer (Compressed Interaction Network) for Hopper
// (sm_90a), in float32.
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
// is a GEMM whose right operand is made on the fly:
//   M = H2 rows of W_flat [H2, H*m], K = H*m, N = B*D columns (b, d).
//
// Design (simple and right first; not tuned):
//   * One block of 128 threads owns a 64-row M tile (rows n0 .. n0+63) and
//     the R = 128 / D whole batch rows b0 .. b0+R-1, i.e. R*D <= 128
//     column slots (120 at D = 10; the block masks the rest). Its slices
//     of x0, xk and out are then contiguous in memory. Grid:
//     (ceil(B / R), ceil(H2 / 64)).
//   * x0's slice is staged in shared memory once, transposed to
//     x0s[m][c] (c = r*D + d), so that a fixed field m is contiguous over
//     the columns.
//   * K is walked in chunks of 4 values of h (4*m values of k): the chunk's
//     W values are staged as ws[k][n] (n contiguous, rows padded to 68
//     floats, which keeps each float4 aligned and the coalesced stores
//     4-way at worst) and the chunk's xk values as xks[h][c].
//   * Each thread owns an 8 x 8 register tile of outputs: rows
//     n0 + ty*4 + {0..3} and n0 + 32 + ty*4 + {0..3}, columns
//     tx*4 + {0..3} and 64 + tx*4 + {0..3} (ty = 0..7, tx = 0..15). So a
//     warp's float4 reads of x0s are conflict-free and its reads of ws are
//     broadcasts. For each k = (h, m) it forms z = xk[h] * x0[m] for its 8
//     columns in registers (the product in the reference's order) and adds
//     W[n, h, m] * z into the 64 sums by float32 FMA, k in increasing
//     order.
//   * The last M tile of H2 = 200 holds 8 live rows: threads whose rows
//     all lie past H2 (whole warps) load but skip the FMAs. Columns past
//     the block's live R*D and rows past H2 are never written.
//   * Shared memory: (m*128 + 4*128 + 4*m*68) floats, 64,448 bytes at
//     m = 39 (set with cudaFuncSetAttribute; the wrapper allows m <= 128,
//     206,848 bytes). Offsets into x0, xk and out are 64-bit: B*H2*D is
//     2e9 at the retrieval batch of 10^6 candidates.
//
// Bound (chip_smoke.py computes it from the run's shapes): operations.
// 2*H2*H*m*D flops per batch row and layer, 68,484,000 per row over
// xdeepfm's three layers (H = 39, 200, 200), at the H100 SXM's 67 TFLOP/s
// of float32 FMA outside the tensor cores: 268 ms for a serve_bulk batch
// (262,144 rows). The bytes (x0, xk and W read once, out written once) are
// about 4.6 GB on a layer with H = 200 at that batch, 1.4 ms at 3.35 TB/s:
// the layer is compute-bound by about 100x. W_flat (6.24 MB) is read by
// every block and stays in the 50 MB L2. TF32 or 3xTF32 tensor cores
// (wgmma) are later work, with what TF32's 10-bit mantissa does to the
// float32 rule of cases.py to settle first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;          // output rows (n) per block
constexpr int kBN = 128;         // column slots (b, d) per block
constexpr int kKH = 4;           // values of h per K chunk
constexpr int kThreads = 128;    // 8 (ty, rows) x 16 (tx, columns)
constexpr int kWStride = kBM + 4;  // floats per staged W row

struct Params {
  const float* x0;
  const float* xk;
  const float* w;
  float* out;
  long long B;
  int m, H, H2, D, R;  // R = batch rows per block = kBN / D
};

__host__ __device__ constexpr int smem_floats(int m) {
  return m * kBN + kKH * kBN + kKH * m * kWStride;
}

__global__ void __launch_bounds__(kThreads) cin_layer_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* x0s = reinterpret_cast<float*>(smem4);  // [m][kBN]
  float* xks = x0s + p.m * kBN;                  // [kKH][kBN]
  float* ws = xks + kKH * kBN;                   // [kKH * m][kWStride]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m = p.m, H = p.H, H2 = p.H2, D = p.D;
  const long long b0 = static_cast<long long>(blockIdx.x) * p.R;
  const int n0 = blockIdx.y * kBM;
  const long long rows_left = p.B - b0;
  const int rows = rows_left < p.R ? static_cast<int>(rows_left) : p.R;
  const int cols = rows * D;  // live column slots of this block
  const long long HD = static_cast<long long>(H) * D;
  const long long mD = static_cast<long long>(m) * D;
  const long long Hm = static_cast<long long>(H) * m;

  // x0s[mm][c] = x0[b0 + c / D, mm, c % D], 0 past the live columns
  for (int i = tid; i < m * kBN; i += kThreads) {
    const int mm = i / kBN, c = i % kBN;
    float v = 0.f;
    if (c < cols) v = p.x0[(b0 + c / D) * mD + mm * D + c % D];
    x0s[i] = v;
  }

  // a thread's rows are n0 + ty*4 + {0..3} and n0 + 32 + ty*4 + {0..3}:
  // when the first lies past H2 so do all eight
  const bool active = n0 + ty * 4 < H2;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kKH) {
    const int kh = H - h0 < kKH ? H - h0 : kKH;
    const int kc = kh * m;  // k values in this chunk
    __syncthreads();        // the previous chunk is consumed (and x0s set)
    for (int i = tid; i < kKH * kBN; i += kThreads) {
      const int hh = i / kBN, c = i % kBN;
      float v = 0.f;
      if (c < cols && hh < kh)
        v = p.xk[(b0 + c / D) * HD + static_cast<long long>(h0 + hh) * D +
                 c % D];
      xks[i] = v;
    }
    // ws[kk][nl] = W[n0 + nl, h0 + kk / m, kk % m]: consecutive threads
    // read consecutive kk, which are contiguous in W
    for (int i = tid; i < kBM * kc; i += kThreads) {
      const int nl = i / kc, kk = i % kc;
      const int n = n0 + nl;
      float v = 0.f;
      if (n < H2) v = p.w[n * Hm + static_cast<long long>(h0) * m + kk];
      ws[kk * kWStride + nl] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int hh = 0; hh < kh; ++hh) {
      const float4 xa = *reinterpret_cast<const float4*>(xks + hh * kBN +
                                                         tx * 4);
      const float4 xb = *reinterpret_cast<const float4*>(xks + hh * kBN + 64 +
                                                         tx * 4);
      const float* wrow = ws + hh * m * kWStride;
#pragma unroll 3
      for (int mm = 0; mm < m; ++mm) {
        const float4 a = *reinterpret_cast<const float4*>(x0s + mm * kBN +
                                                          tx * 4);
        const float4 b = *reinterpret_cast<const float4*>(x0s + mm * kBN +
                                                          64 + tx * 4);
        const float z[8] = {xa.x * a.x, xa.y * a.y, xa.z * a.z, xa.w * a.w,
                            xb.x * b.x, xb.y * b.y, xb.z * b.z, xb.w * b.w};
        const float4 wa = *reinterpret_cast<const float4*>(
            wrow + mm * kWStride + ty * 4);
        const float4 wb = *reinterpret_cast<const float4*>(
            wrow + mm * kWStride + 32 + ty * 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(wv[i], z[j], acc[i][j]);
      }
    }
  }

  if (!active) return;
  const long long H2D = static_cast<long long>(H2) * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + (i - 4));
    if (n >= H2) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      if (c >= cols) continue;
      p.out[(b0 + c / D) * H2D + static_cast<long long>(n) * D + c % D] =
          acc[i][j];
    }
  }
}

}  // namespace

// x0 [B, m, D], xk [B, H, D], w [H2, H, m] and out [B, H2, D]: contiguous
// float32 on one device. Requires 1 <= m <= 128 and 1 <= D <= 128 (the
// wrapper, kernel.py, checks shapes, types, strides and devices first).
// Launches on `stream` without synchronising and returns the CUDA error of
// the launch (0 on success; B = 0 launches nothing).
extern "C" int cin_layer_launch(const float* x0, const float* xk,
                                const float* w, float* out, long long B,
                                int m, int H, int H2, int D,
                                void* stream_ptr) {
  if (B == 0) return 0;
  if (m < 1 || m > 128 || D < 1 || D > kBN || H < 1 || H2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x0 = x0;
  p.xk = xk;
  p.w = w;
  p.out = out;
  p.B = B;
  p.m = m;
  p.H = H;
  p.H2 = H2;
  p.D = D;
  p.R = kBN / D;
  const int smem = smem_floats(m) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      cin_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + p.R - 1) / p.R;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), (H2 + kBM - 1) / kBM);
  cin_layer_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream_ptr)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
