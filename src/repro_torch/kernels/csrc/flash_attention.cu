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
// and every product, the scores s = (q.k) * scale, the running max m, the
// normaliser l, p = exp(s - m_new) and the accumulator are f32; masked
// scores are -1e30 as there; the output is rounded once to q's type.  The
// plain version is flash_attention_ref in
// src/repro_torch/kernels/flash_attention/flash_attention.py.
//
// What bounds it on this card: operations.  At the serving slice's shape
// (B = 4, S = 2048, Hq = Hkv = 32, D = 64, causal) the products are about
// 4 * B * Hq * D * S^2 / 2 = 6.9e10 FLOP against 134 MB of bf16 q, k, v
// and o: 0.069 ms at the bf16 tensor-core peak against 0.040 ms of bytes.
//
// What the design does: one block of 256 threads per (q tile of 64 rows,
// q head, batch).  The q tile is converted to f32 into shared memory once;
// k/v tiles of 64 rows stream through shared memory (f32), and the block
// walks them in order, keeping m, l and the [64, D] accumulator in
// registers (each thread owns 4 rows x D/16 columns; a row's 16 threads
// sit in one half-warp and reduce with shuffles).  Causal tiles above the
// diagonal are skipped; the heaviest q tiles are launched first.  A ragged
// last tile (S % 64 != 0) is masked, not asserted away.  The products run
// on the FP32 pipes, not the tensor cores: this first kernel is simple and
// right, and stays far from the bf16 bound (PERF.md has the gap).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Hq, int Hkv, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Hq, int Hkv, int D, int causal,
                       float scale, cudaStream_t st) {
#define FA_CASE(d) \
  case d: return launch<T, d>(q, k, v, o, B, S, Hq, Hkv, causal, scale, st);
  switch (D) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// q [B,S,Hq,D], k/v [B,S,Hkv,D], o [B,S,Hq,D], all contiguous and of one
// type: bf16 when is_bf16, else f32.  D in {16, 32, 64, 128}; Hq % Hkv == 0.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Hq, int Hkv, int D, int causal,
                                      float scale, int is_bf16,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, D,
                                          causal, scale, st)
              : dispatch_d<float>(q, k, v, o, B, S, Hq, Hkv, D, causal,
                                  scale, st);
  return (int)err;
}
