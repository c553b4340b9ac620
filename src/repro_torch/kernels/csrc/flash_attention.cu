// flash_attention: causal (or full) streaming-softmax attention, forward,
// for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
//           flash_attention_fwd (the pallas_call of _fa_kernel).
//
// What it computes: o[b, s, h, :] = softmax_k((q[b,s,h,:] . k[b,k,h/G,:]) *
// scale, masked to k <= s when causal) @ v[b, :, h/G, :] for q [B,S,Hq,D],
// k/v [B,S,Hkv,D], G = Hq / Hkv (GQA, MQA at Hkv = 1).  The TPU kernel's
// numerics are kept: q, k and v are read in their own type (bf16 or f32)
// and the scores s = (q.k) * scale, the running max m, the normaliser l,
// p = exp(s - m_new) and the accumulator are f32; masked scores are -1e30
// as there, and m starts at -1e30; o = acc / max(l, 1e-20) is rounded
// once to q's type.  The plain version is flash_attention_ref in
// src/repro_torch/kernels/flash_attention/flash_attention.py.
//
// What bounds it on this card: operations.  At the serving slice's shape
// (B = 4, S = 2048, Hq = Hkv = 32, D = 64, causal) the products are about
// 4 * B * Hq * D * S^2 / 2 = 6.9e10 FLOP against 134 MB of bf16 q, k, v
// and o: 0.069 ms at the bf16 tensor-core peak against 0.040 ms of bytes.
//
// Two variants, chosen by the input's type and head dim alone:
//
// * bf16 with D in {64, 128}: the tensor-core kernel (flash_fwd_wgmma).
//   One block of one warpgroup (128 threads) per (64-row q tile, q head,
//   batch), the heaviest causal tiles launched first.  The q tile is
//   loaded once by TMA; 64-row k and v tiles stream through a two-stage
//   shared-memory ring, loaded by TMA (descriptors over the [B,S,H,D]
//   layout, 128-byte swizzle, zero fill past S) and completed on
//   mbarriers, the next tile's load in flight while this one computes.
//   S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//   memory: products of bf16 operands are exact in f32, so only the
//   summation order differs from the TPU kernel.  The softmax runs on the
//   accumulator fragment in registers in the TPU kernel's order (m_new,
//   p, alpha, l = alpha l + rowsum p, acc *= alpha); a row's 4 threads
//   combine with shuffles.  P V keeps p in f32 precision on bf16 tensor
//   cores by splitting it in registers, p_hi = bf16(p) and p_lo =
//   bf16(p - p_hi), and issuing two register-A wgmmas on the same v tile
//   (v is an MN-major B operand).  Rounding p itself to bf16 would miss
//   the bf16 output limit some 80-fold; the split leaves p's error near
//   2^-17 of p, below the output's one rounding.  The accumulator
//   fragment of S maps onto the A-operand fragment of P V element for
//   element (rows lane/4 and lane/4 + 8 of the warp's 16, columns
//   2 (lane % 4) + {0, 1} and + 8), so no shuffle is needed.
// * f32, or D in {16, 32, 256}: the FP32-pipe kernel (flash_fwd_fp32),
//   one block of 256 threads per (q tile, q head, batch) with q, k, v and
//   p as f32 in shared memory and scalar FMAs; the reduced configs' D =
//   16, f32 inputs and paligemma-3b's D = 256 (MQA, Hq 8, Hkv 1) take it.
//   At D = 256 a block holds (64 * 257 + 64 * 257 + 64 * 256 + 64 * 65) *
//   4 = 213,760 bytes of shared memory (one block an SM, under the 227 KB
//   opt-in) and a thread 4 x 16 accumulators.
//
// Both skip causal tiles above the diagonal, mask k > q on the diagonal
// tile and k >= S on a ragged last tile.
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // q rows per block
constexpr int kBK = 64;         // k/v rows per streamed tile
constexpr int kThreads = 256;   // 16 x 16; thread (ty, tx) owns rows ty+16i
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// FP32-pipe variant (f32, or D in {16, 32})
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Hq, int Hkv,
          int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);        // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);        // [kBK][D]
  float* Ps = Vs + kBK * D;              // [kBQ][kBK + 1]

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;   // heaviest tiles first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  constexpr int kCols = D / 16;

  // element (b, s, h, d) lies at ((b * S + s) * H + h) * D + d
  const size_t q_row = (size_t)Hq * D, kv_row = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * S * q_row + (size_t)hq * D;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)hk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * (D + 1) + c] = s < S ? to_f32(qb[(size_t)s * q_row + c]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int nk_all = (S + kBK - 1) / kBK;
  const int nk = causal ? min(nk_all, (q0 + kBQ - 1) / kBK + 1) : nk_all;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the last tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, s = k0 + r;
      const bool ok = s < S;
      Ks[r * (D + 1) + c] = ok ? to_f32(kb[(size_t)s * kv_row + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f32(vb[(size_t)s * kv_row + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if (kpos >= S || (causal && kpos > qpos)) s = kNegInf;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      // a row's 16 threads are one half-warp: xor offsets below 16
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(kFull, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int s = 0; s < kBK; ++s) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (kBK + 1) + s];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[s * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* ob = o + ((size_t)b * S + s) * q_row + (size_t)hq * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(ob + tx + 16 * c, acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        void* o, int B, int S, int Hq, int Hkv, int causal,
                        float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_fp32<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fp32(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int Hq, int Hkv, int D,
                          int causal, float scale, cudaStream_t st) {
#define FA_CASE(d) \
  case d:           \
    return launch_fp32<T, d>(q, k, v, o, B, S, Hq, Hkv, causal, scale, st);
  switch (D) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

// ---------------------------------------------------------------------------
// Hopper variant: TMA ring + wgmma (bf16, D in {64, 128})
// ---------------------------------------------------------------------------
constexpr int kTile = 64;            // q rows per block; k/v rows per stage
constexpr int kStages = 2;           // k/v ring depth
constexpr int kWgThreads = 128;      // one warpgroup
constexpr int kBlockBytes = kTile * 64 * 2;   // [64 rows][64 bf16]: 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 (B128)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// A wait that never completes is a fault of the kernel: after about 2^26
// polls it traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma's issue and wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_ss_bf16_n64(float (&d)[32], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16_n64_tb(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
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

__device__ __forceinline__ void wgmma_rs_bf16_n128_tb(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
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

// acc [64, D] += a (registers, 64 x 16) . b (shared memory, MN-major)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                        const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_bf16_n64_tb(d, a, db, 1);
  else
    wgmma_rs_bf16_n128_tb(d, a, db, 1);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
constexpr int wgmma_smem_bytes() {
  // 1 KB of alignment slack, the q tile, the k and v rings, 3 mbarriers
  return 1024 + (1 + 2 * kStages) * (D / 64) * kBlockBytes + 64;
}

// Shared memory holds each [64 rows][D] tile as D / 64 blocks of
// [64 rows][64 bf16], 128 bytes a row, in TMA's 128-byte swizzle.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv,
                int causal, float scale) {
  constexpr int kCB = D / 64;                  // 64-column blocks per row
  constexpr int kTileBytes = kCB * kBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + kTileBytes;               // [kStages] tiles
  uint8_t* Vs = Ks + kStages * kTileBytes;     // [kStages] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * kTileBytes);
  const uint32_t bar_q = smem_u32(&bars[0]);

  const int nq = (S + kTile - 1) / kTile;
  const int qt = nq - 1 - (int)blockIdx.x;     // heaviest tiles first
  const int q0 = qt * kTile;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nk = causal ? qt + 1 : nq;

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto load_kv = [=](int kt, int st) {
    const uint32_t bar = smem_u32(&bars[1 + st]);
    mbar_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) {
      tma_load_4d(smem_u32(Ks + st * kTileBytes + cb * kBlockBytes), mk, bar,
                  cb * 64, hk, kt * kTile, b);
      tma_load_4d(smem_u32(Vs + st * kTileBytes + cb * kBlockBytes), mv, bar,
                  cb * 64, hk, kt * kTile, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(smem_u32(&bars[1 + st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, kTileBytes);
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
      tma_load_4d(smem_u32(Qs + cb * kBlockBytes), &tq, bar_q, cb * 64, hq,
                  q0, b);
    load_kv(0, 0);
  }

  // accumulator fragments: element 4 j + i of a thread lies in row
  // warp * 16 + lane / 4 + 8 (i / 2), column 8 j + 2 (lane % 4) + i % 2
  const int r0 = warp * 16 + lane / 4;
  float oacc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) oacc[e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (tid == 0 && kt + 1 < nk) load_kv(kt + 1, st ^ 1);
    mbar_wait(smem_u32(&bars[1 + st]), (kt >> 1) & 1);
    const uint8_t* Kst = Ks + st * kTileBytes;
    const uint8_t* Vst = Vs + st * kTileBytes;

    // S = Q K^T, both K-major: a k16 step is 32 bytes along a 128-byte row
    float sacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kBlockBytes + (kk % 4) * 32;
      wgmma_ss_bf16_n64(sacc, desc_sw128(smem_u32(Qs) + off, 16, 1024),
                        desc_sw128(smem_u32(Kst) + off, 16, 1024), 1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sacc);

    // the TPU kernel's online softmax, on the fragment; only the diagonal
    // tile and a ragged last tile hold masked scores
    const int k0 = kt * kTile;
    const bool masked = (causal && kt == qt) || k0 + kTile > S;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int half = (e >> 1) & 1;
      float s = sacc[e] * scale;
      if (masked) {
        const int qpos = q0 + r0 + 8 * half;
        const int kpos = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (kpos >= S || (causal && kpos > qpos)) s = kNegInf;
      }
      sacc[e] = s;
      mx[half] = fmaxf(mx[half], s);
    }
    float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      m_new[h] = fmaxf(m_r[h], mx[h]);
      alpha[h] = expf(m_r[h] - m_new[h]);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int half = (e >> 1) & 1;
      sacc[e] = expf(sacc[e] - m_new[half]);
      rs[half] += sacc[e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(kFull, rs[h], 1);
      rs[h] += __shfl_xor_sync(kFull, rs[h], 2);
      l_r[h] = alpha[h] * l_r[h] + rs[h];
      m_r[h] = m_new[h];
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) oacc[e] *= alpha[(e >> 1) & 1];

    // p = p_hi + p_lo, each bf16; A fragment register h of k16 step kk
    // holds accumulator elements 8 kk + 2 h and 8 kk + 2 h + 1
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float x0 = sacc[8 * kk + 2 * h], x1 = sacc[8 * kk + 2 * h + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            x0 - __low2float(hi), x1 - __high2float(hi));
        phi[kk][h] = bf16x2_bits(hi);
        plo[kk][h] = bf16x2_bits(lo);
      }

    // acc += p_hi V + p_lo V; V is MN-major: a k16 step is 16 rows of 128
    // bytes, the next 64 columns of D are the next 8 KB block (LBO)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db =
          desc_sw128(smem_u32(Vst) + kk * 16 * 128, kBlockBytes, 1024);
      wgmma_pv<D>(oacc, phi[kk], db);
      wgmma_pv<D>(oacc, plo[kk], db);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(oacc);
    __syncthreads();   // every warp is done with stage st before its reload
  }

  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) den[h] = fmaxf(l_r[h], 1e-20f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = q0 + r0 + 8 * h;
    if (s >= S) continue;
    __nv_bfloat16* ob = o + ((size_t)b * S + s) * Hq * D + (size_t)hq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(ob + col) = __floats2bfloat162_rn(
          oacc[4 * j + 2 * h] / den[h], oacc[4 * j + 2 * h + 1] / den[h]);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (cudaGetDriverEntryPoint), so that the library needs no link against
// libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a TMA descriptor over x [B, S, H, D] bf16, boxes of [64 rows][64 cols]
// at one (b, h), 128-byte swizzle, zero fill past the edges
bool make_map(CUtensorMap* map, const void* x, int B, int S, int H, int D) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int Hq, int Hkv, int causal,
                         float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, Hq, D) || !make_map(&tk, k, B, S, Hkv, D) ||
      !make_map(&tv, v, B, S, Hkv, D))
    return cudaErrorInvalidValue;
  constexpr int smem = wgmma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, Hq, B);
  flash_fwd_wgmma<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B,S,Hq,D], k/v [B,S,Hkv,D], o [B,S,Hq,D], all contiguous and of one
// type: bf16 when is_bf16, else f32.  D in {16, 32, 64, 128, 256};
// Hq % Hkv == 0.
// use_wgmma (bf16 with D in {64, 128} only) picks the tensor-core variant,
// else the FP32-pipe one runs; the caller chooses by type and D alone.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Hq, int Hkv, int D, int causal,
                                      float scale, int is_bf16, int use_wgmma,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_wgmma) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    if (D == 64)
      err = launch_wgmma<64>(q, k, v, o, B, S, Hq, Hkv, causal, scale, st);
    else if (D == 128)
      err = launch_wgmma<128>(q, k, v, o, B, S, Hq, Hkv, causal, scale, st);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    err = is_bf16 ? dispatch_fp32<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv,
                                                  D, causal, scale, st)
                  : dispatch_fp32<float>(q, k, v, o, B, S, Hq, Hkv, D, causal,
                                         scale, st);
  }
  return (int)err;
}
