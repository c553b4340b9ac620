// ssd_scan: Mamba2 SSD chunk scan (state-space duality), forward, for
// NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py, ssd_chunked_kernel
//           (the pallas_call of _ssd_kernel).
//
// What it computes, for each batch b and head h, chunk by chunk of Q steps
// (cum = cumsum over the chunk of A * dt, A = -exp(A_log[h])):
//   y[q]  = sum_{s <= q} (C_q . B_s) exp(cum_q - cum_s) dt_s xs_s
//         + exp(cum_q) C_q . h                       (h: the [P, N] state)
//   h    <- exp(cum_last) h + sum_s xs_s (x) (exp(cum_last - cum_s) dt_s B_s)
// with xs [B,S,H,P], B/C [B,S,N], dt [B,S,H], A_log [H] and h starting at
// 0; it returns y [B,S,H,P] and the final state [B,H,P,N].  Everything is
// f32, in the TPU kernel's order of operations.  A ragged last chunk
// (S % Q != 0) is the zero-padded chunk without its padding.  The plain
// version is ssd_scan_ref in src/repro_torch/kernels/ssd_scan/ssd_scan.py.
//
// What bounds it on this card: operations.  At the serving slice's shape
// (B = 4, S = 2048, H = 64, P = 64, N = 64, Q = 256) the function needs
// about 1.7e10 FLOP of f32 work: the causal half of C.B^T once per
// (b, chunk), since B and C have one group, and per head the causal half
// of M.xs plus the C.h and state-update products.  Against about 0.28 GB
// of inputs and outputs that is 0.26 ms at the FP32 peak outside the
// tensor cores, 0.08 ms of bytes.
//
// What the design does: one block of 256 threads per (b, h).  The TPU's
// sequential chunk axis becomes a loop inside the block, with the [P, N]
// state in shared memory for the whole sequence.  A [Q, Q] tile of
// C.B^T does not fit in shared memory at Q = 256 beside B, C and xs, so
// the chunk is cut into 64-row q tiles and 64-row s tiles: per (q, s)
// tile pair on or below the diagonal, the block computes the 64 x 64
// C.B^T tile, scales it into M = G * exp(cum_q - cum_s) * dt_s in shared
// memory, and accumulates M . xs into registers (each thread owns a 4 x 4
// piece of a 64 x 64 output tile; P <= 64).  The C.h term joins the same
// registers; then the state update walks the s tiles once more, with
// w * B staged in shared memory, for each 64-column slice of N.  The
// chunk's cumulative sum is one warp's scan.  The products run on the FP32
// pipes: this first kernel is simple and right, and recomputes C.B^T for
// every head (it depends only on b and the chunk); PERF.md has the gap.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // rows of a q or s tile; columns of P / N
constexpr int kThreads = 256;   // 16 x 16; thread (ty, tx) owns ty+16i, tx+16j
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t smem_floats(int N, int Q) {
  const size_t np = (size_t)N + 1;
  return 3 * (size_t)kT * np           // state, C tile, B tile
         + 2 * (size_t)Q               // cum, dt of the chunk
         + (size_t)kT * kT             // xs tile
         + (size_t)kT * (kT + 1);      // M tile / w*B tile
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xs, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A_log, float* __restrict__ y,
                float* __restrict__ h_out, int S, int H, int P, int N,
                int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1;                 // padded row stride of N-wide tiles
  float* hs = smem;                     // [kT][NP]  state h[p][n], p < P
  float* Ct = hs + kT * NP;             // [kT][NP]  C rows of a q tile
  float* Bt = Ct + kT * NP;             // [kT][NP]  B rows of an s tile
  float* cum = Bt + kT * NP;            // [Q]
  float* dts = cum + Q;                 // [Q]
  float* Xt = dts + Q;                  // [kT][kT]  xs rows of an s tile
  float* Mt = Xt + kT * kT;             // [kT][kT+1]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float A = -expf(A_log[h]);

  const size_t x_row = (size_t)H * P;   // stride of s in xs and y
  const float* xb = xs + (size_t)b * S * x_row + (size_t)h * P;
  float* yb = y + (size_t)b * S * x_row + (size_t)h * P;
  const float* Bb = Bm + (size_t)b * S * N;
  const float* Cb = Cm + (size_t)b * S * N;
  const float* dtb = dt + (size_t)b * S * H + h;

  for (int i = tid; i < kT * NP; i += kThreads) hs[i] = 0.f;

  // xs rows [c0 + s0, +kT) into Xt (zeros past the chunk or past P)
  auto load_x = [&](int c0, int s0, int Qc) {
    for (int i = tid; i < kT * kT; i += kThreads) {
      const int r = i / kT, p = i % kT, s = s0 + r;
      Xt[i] = (s < Qc && p < P) ? xb[(size_t)(c0 + s) * x_row + p] : 0.f;
    }
  };

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int Qc = min(Q, S - c0);
    __syncthreads();   // the last chunk's readers of cum/dts/hs are done
    for (int i = tid; i < Qc; i += kThreads)
      dts[i] = dtb[(size_t)(c0 + i) * H];
    __syncthreads();
    if (tid < 32) {    // cum = cumsum(A * dt): runs per lane, then a scan
      const int per = (Qc + 31) / 32;
      const int lo = min(tid * per, Qc), hi = min(lo + per, Qc);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += A * dts[i];
        cum[i] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, incl, off);
        if (tid >= off) incl += t;
      }
      float pre = __shfl_up_sync(kFull, incl, 1);
      if (tid == 0) pre = 0.f;
      for (int i = lo; i < hi; ++i) cum[i] += pre;
    }
    __syncthreads();
    const float total = cum[Qc - 1];

    // ---- y, one 64-row q tile at a time --------------------------------
    for (int q0 = 0; q0 < Qc; q0 += kT) {
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N, n = i % N, q = q0 + r;
        Ct[r * NP + n] = q < Qc ? Cb[(size_t)(c0 + q) * N + n] : 0.f;
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int s0 = 0; s0 <= q0; s0 += kT) {   // tiles on/below the diagonal
        for (int i = tid; i < kT * N; i += kThreads) {
          const int r = i / N, n = i % N, s = s0 + r;
          Bt[r * NP + n] = s < Qc ? Bb[(size_t)(c0 + s) * N + n] : 0.f;
        }
        load_x(c0, s0, Qc);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float a[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Ct[(ty + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = Bt[(tx + 16 * j) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(a[i], bb[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float mv = 0.f;
            if (s <= q && q < Qc)
              mv = g[i][j] * expf(cum[q] - cum[s]) * dts[s];
            Mt[(ty + 16 * i) * (kT + 1) + tx + 16 * j] = mv;
          }
        }
        __syncthreads();
        for (int s = 0; s < kT; ++s) {
          float mv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = Mt[(ty + 16 * i) * (kT + 1) + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xt[s * kT + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
        }
        __syncthreads();   // Bt, Xt and Mt are refilled next
      }

      // + exp(cum_q) * C_q . h  (the state carried in from earlier chunks)
      float ch[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ch[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float a[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Ct[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = hs[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ch[i][j] = fmaf(a[i], hv[j], ch[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= Qc) continue;
        const float e = expf(cum[q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P)
            yb[(size_t)(c0 + q) * x_row + p] = acc[i][j] + e * ch[i][j];
        }
      }
      __syncthreads();   // Ct is refilled by the next q tile
    }

    // ---- state update: h = exp(total) h + xs^T (w * B) ------------------
    const float decay = expf(total);
    for (int n0 = 0; n0 < N; n0 += kT) {
      float u[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) u[i][j] = 0.f;
      for (int s0 = 0; s0 < Qc; s0 += kT) {
        load_x(c0, s0, Qc);
        for (int i = tid; i < kT * kT; i += kThreads) {
          const int r = i / kT, nn = i % kT, s = s0 + r, n = n0 + nn;
          float wb = 0.f;
          if (s < Qc && n < N)
            wb = expf(total - cum[s]) * dts[s] * Bb[(size_t)(c0 + s) * N + n];
          Mt[r * (kT + 1) + nn] = wb;
        }
        __syncthreads();
        for (int s = 0; s < kT; ++s) {
          float xv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = Xt[s * kT + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = Mt[s * (kT + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) u[i][j] = fmaf(xv[i], wv[j], u[i][j]);
        }
        __syncthreads();   // Xt and Mt are refilled next
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx + 16 * j;
          if (p < P && n < N)
            hs[p * NP + n] = decay * hs[p * NP + n] + u[i][j];
        }
      }
    }
  }

  __syncthreads();
  float* hb = h_out + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    hb[i] = hs[(i / N) * NP + i % N];
}

}  // namespace

// xs [B,S,H,P], Bm/Cm [B,S,N], dt [B,S,H], A_log [H] -> y [B,S,H,P],
// h_out [B,H,P,N]; all f32 and contiguous; P <= 64.  Returns
// cudaGetLastError() after the launch (0 on success), or the error of
// cudaFuncSetAttribute when (N, Q) needs more shared memory than a block
// may have.
extern "C" int ssd_scan_launch(const void* xs, const void* Bm, const void* Cm,
                               const void* dt, const void* A_log, void* y,
                               void* h_out, int B, int S, int H, int P,
                               int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kT || N <= 0 || Q <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(N, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(
      stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<float*>(y),
      static_cast<float*>(h_out), S, H, P, N, Q);
  return (int)cudaGetLastError();
}
