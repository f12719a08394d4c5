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
//   * flash_fwd_mma<D> (bf16, D in {16, 32, 64, 128, 256}): tensor cores
//     through mma.sync m16n8k16 (bf16 in, float32 accumulate). One block of
//     4 warps per (b, hq, 64-row q tile); each warp owns 16 query rows. The
//     TPU's sequential kv grid axis becomes a loop inside the block over
//     64-key tiles, limited to the tiles that hold an unmasked entry (the
//     skip rule of kernel.py:67-76 turned into a loop range). Q, K and V
//     tiles sit row-major in dynamic shared memory (101,376 bytes at
//     D = 256, set with cudaFuncSetAttribute; rows padded by 16 bytes so
//     that ldmatrix reads them without bank conflicts) and reach the
//     fragments through ldmatrix (.trans for V). cp.async brings the V tile
//     while the scores are computed and the next K tile while P V is. The
//     running max m, sum l and the 16 x D output accumulator live in
//     registers in the mma fragment layout, and the probabilities P go from
//     the score fragment straight into the A fragment of the P V product,
//     rounded to bf16. Masked scores get p = 0 explicitly (a live tile may
//     hold a fully masked row, whose exp(s - m) would be 1, kernel.py:98);
//     only tiles on a mask edge test each entry. exp and the softcap's tanh
//     use the fast exp and divide (__expf, __fdividef), whose errors are
//     far below bf16's. The q tiles with the most keys under a causal mask
//     (the last ones) are scheduled first, which shortens the grid's tail.
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
// q, k, v and writing o once is 0.2 GB (0.060 ms). mma.sync reaches a
// fraction of the tensor cores' rate; wgmma with TMA and warp
// specialisation (the shape of a fast Hopper kernel) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block (16 per warp)
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // bf16 row padding: conflict-free ldmatrix
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

// tanh(y) = 1 - 2 / (e^{2y} + 1) with the fast exp and divide: e^{2y} =
// inf gives 1 and 0 gives -1.
__device__ __forceinline__ float cap_score_fast(const Params& p, float dot) {
  float s = dot * p.scale;
  if (p.softcap > 0.f)
    s = p.softcap *
        (1.f - __fdividef(2.f, __expf(2.f * s * p.inv_softcap) + 1.f));
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b for one m16n8k16 tile: bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int D>
constexpr int mma_smem_bytes() {
  return 3 * kBQ * (D + kPad) * 2;  // Q, K and V tiles (kBQ == kBK)
}

// Rows [row0, row0 + 64) of a [S, D] bf16 matrix with row stride `stride`
// into a padded shared tile, by cp.async; rows at or past `rows` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int rows, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < kBK * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * (D + kPad) + c, src + (ok ? row0 + r : 0) * stride + c,
               ok);
  }
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = A[g][2t..], a1 = A[g+8][2t..],
//                           a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B (16 x 8, k by n):     b0 = B[2t..][g], b1 = B[2t+8..][g]
//   C (16 x 8):             c0,c1 = C[g][2t, 2t+1], c2,c3 = C[g+8][2t, 2t+1]
// ldmatrix gives A from the Q tile and, for the scores S = Q K^T, B[k][n] =
// K[n][k] from the K tile (both row-major); for O = P V, B[k][n] = V[k][n]
// comes from the row-major V tile through ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const Params p) {
  constexpr int QS = D + kPad;   // tile row stride (elements)
  constexpr int NT = kBK / 8;    // score n-tiles per warp
  constexpr int DT = D / 8;      // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * QS;
  __nv_bfloat16* Vs = Ks + kBK * QS;

  // the last q tiles (the most keys under a causal mask) are scheduled first
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int l8 = lane & 7, l8b = (lane >> 3) & 1, l16 = lane >> 4;
  const auto* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const auto* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const auto* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int q_off = *p.q_offset;
  const int kvl = valid_kv(p, b);
  const int q_first = q_off + q0;
  const int q_last = q_off + min(q0 + kBQ, p.Sq) - 1;
  int k_lo, k_hi;
  key_range(p, kvl, q_first, q_last, &k_lo, &k_hi);
  const int k_begin = (k_lo / kBK) * kBK;

  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int qp0 = q_off + q0 + r0, qp1 = qp0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float oacc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;

  if (k_begin < k_hi) {
    load_tile<D>(Qs, qg + q0 * p.q_ss, p.q_ss, 0, p.Sq - q0, tid);
    load_tile<D>(Ks, kg, p.k_ss, k_begin, p.Skv, tid);
    cp_async_commit();
  }
  // Per tile: V loads while the scores are computed, and the next K tile
  // loads while P V is computed.
  for (int k0 = k_begin; k0 < k_hi; k0 += kBK) {
    load_tile<D>(Vs, vg, p.v_ss, k0, p.Skv, tid);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this K tile have landed
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (warp * 16 + l8 + 8 * l8b) * QS + kk + 8 * l16);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, Ks + (8 * j + l8 + 8 * l16) * QS + kk + 8 * l8b);
        mma16816(s[j], a, bb);
        mma16816(s[j + 1], a, bb + 2);
      }
    }

    // scale, softcap and mask (only a tile on a mask edge checks each
    // entry); row maxima over the quad of each row
    const bool edge = !(k0 + kBK <= kvl &&
                        (!p.causal || k0 + kBK - 1 <= q_first) &&
                        (p.window <= 0 || q_last - k0 < p.window));
    uint32_t live = 0;
    float mt0 = kNegInf, mt1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = !edge || unmasked(p, kvl, e < 2 ? qp0 : qp1, kpos);
        s[j][e] = ok ? cap_score_fast(p, s[j][e]) : kNegInf;
        live |= (ok ? 1u : 0u) << (4 * j + e);
        if (e < 2) mt0 = fmaxf(mt0, s[j][e]);
        else mt1 = fmaxf(mt1, s[j][e]);
      }
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffff, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffff, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffff, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffff, mt1, 2));
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (live >> (4 * j + e)) & 1u;
        const float pe = ok ? __expf(s[j][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        s[j][e] = pe;
        if (e < 2) ls0 += pe;
        else ls1 += pe;
      }
    }
    l0 = l0 * alpha0 + ls0;  // this thread's share of the row sum
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      oacc[j][0] *= alpha0;
      oacc[j][1] *= alpha0;
      oacc[j][2] *= alpha1;
      oacc[j][3] *= alpha1;
    }

    cp_async_wait<0>();  // this V tile has landed
    __syncthreads();     // and every warp is done with the K tile
    if (k0 + kBK < k_hi) {
      load_tile<D>(Ks, kg, p.k_ss, k0 + kBK, p.Skv, tid);
      cp_async_commit();
    }

    // O += P V: the score fragments of n-tiles 2kk and 2kk+1 are the A
    // fragment of the 16 keys 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, Vs + (16 * kk + l8 + 8 * l8b) * QS + 8 * j + 8 * l16);
        mma16816(oacc[j], a, bb);
        mma16816(oacc[j + 1], a, bb + 2);
      }
    }
    __syncthreads();  // every warp is done with the V tile
  }

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f;  // l = 0: no valid key, o = 0
  const float inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = 8 * j + 2 * t;
    if (q0 + r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + (q0 + r0) * p.o_ss + col) =
          pack_bf16(oacc[j][0] * inv0, oacc[j][1] * inv0);
    if (q0 + r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + (q0 + r1) * p.o_ss + col) =
          pack_bf16(oacc[j][2] * inv1, oacc[j][3] * inv1);
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

template <int D>
cudaError_t launch_mma(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  flash_fwd_mma<D><<<grid, kThreads, smem, stream>>>(p);
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
// the launch (0 on success). The wrapper (kernel.py) checks shapes, types,
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
    case 16: return static_cast<int>(launch_mma<16>(p, B, stream));
    case 32: return static_cast<int>(launch_mma<32>(p, B, stream));
    case 64: return static_cast<int>(launch_mma<64>(p, B, stream));
    case 128: return static_cast<int>(launch_mma<128>(p, B, stream));
    case 256: return static_cast<int>(launch_mma<256>(p, B, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

