// fw_minplus: blocked min-plus Floyd-Warshall (all-pairs shortest paths)
// for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fw_minplus/fw_minplus.py, floyd_warshall
//           (pallas_calls of _phase1_kernel, _phase2_row_kernel,
//           _phase2_col_kernel and _phase3_kernel).
//
// What it computes: D = APSP of the padded adjacency D (in place), by the
// classic 3-phase blocked Floyd-Warshall with 32 x 32 tiles.  For each
// pivot block k: phase 1 closes the pivot tile with an in-tile FW, phase 2
// updates the pivot row and column panels against it, phase 3 relaxes
// every other tile through them, D[i,j] = min(D[i,j], D[i,k] (+) D[k,j]).
// The plain version is floyd_warshall_ref in
// src/repro_torch/core/network.py.
//
// What bounds it on this card: operations.  Min-plus has no tensor-core
// form, so the n^3 add+min pairs run on the FP32 CUDA cores; at n = 2402
// that is about 2.8e10 operations against about 46 MB of bytes.
//
// What the design does about that: phase 3, which does nearly all of the
// work, keeps the pivot-column and pivot-row tiles in shared memory and
// its 32 x 32 output tile in registers (32 x 8 threads, 4 rows each), so
// each p step costs one shared load of the row value, four broadcast
// loads of the column values, and 4 adds + 4 mins; the panels are read
// from device memory once per tile and pivot.  Phases 1 and 2 carry a true
// dependency along p inside the tile, so they read their operands, sync,
// then write (the same read-then-update semantics as the TPU kernel's
// jnp.minimum over the whole tile).  One launch per phase per pivot block.
// Every add is one rounding and min is exact, so on dyadic weights the
// result equals the plain version bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;      // tile edge
constexpr int kRows = 8;    // threadIdx.y extent; each thread owns 4 rows
constexpr int kPer = kT / kRows;

__device__ __forceinline__ void load_tile(float (*t)[kT + 1], const float* D,
                                          int n, int ti, int tj) {
  for (int i = 0; i < kPer; ++i) {
    const int r = threadIdx.y + kRows * i;
    t[r][threadIdx.x] = D[(size_t)(ti * kT + r) * n + tj * kT + threadIdx.x];
  }
}

__device__ __forceinline__ void store_tile(const float (*t)[kT + 1], float* D,
                                           int n, int ti, int tj) {
  for (int i = 0; i < kPer; ++i) {
    const int r = threadIdx.y + kRows * i;
    D[(size_t)(ti * kT + r) * n + tj * kT + threadIdx.x] = t[r][threadIdx.x];
  }
}

// Phase 1: in-tile FW of the pivot tile (k, k).
__global__ void __launch_bounds__(kT * kRows)
fw_phase1(float* D, int n, int k) {
  __shared__ float t[kT][kT + 1];
  load_tile(t, D, n, k, k);
  __syncthreads();
  const int c = threadIdx.x;
  for (int p = 0; p < kT; ++p) {
    float a[kPer];
    const float b = t[p][c];
    for (int i = 0; i < kPer; ++i) a[i] = t[threadIdx.y + kRows * i][p];
    __syncthreads();
    for (int i = 0; i < kPer; ++i) {
      const int r = threadIdx.y + kRows * i;
      t[r][c] = fminf(t[r][c], a[i] + b);
    }
    __syncthreads();
  }
  store_tile(t, D, n, k, k);
}

// Phase 2: blockIdx.y == 0 updates the row panel tile (k, x) as
// d = min(d, kk[:, p] + d[p, :]); blockIdx.y == 1 the column panel tile
// (x, k) as d = min(d, d[:, p] + kk[p, :]).  The pivot tile is skipped
// (already closed by phase 1).
__global__ void __launch_bounds__(kT * kRows)
fw_phase2(float* D, int n, int k) {
  const int x = blockIdx.x;
  if (x == k) return;
  const bool row = blockIdx.y == 0;
  __shared__ float kk[kT][kT + 1];
  __shared__ float d[kT][kT + 1];
  load_tile(kk, D, n, k, k);
  if (row) load_tile(d, D, n, k, x); else load_tile(d, D, n, x, k);
  __syncthreads();
  const int c = threadIdx.x;
  for (int p = 0; p < kT; ++p) {
    float a[kPer];
    const float b = row ? d[p][c] : kk[p][c];
    for (int i = 0; i < kPer; ++i) {
      const int r = threadIdx.y + kRows * i;
      a[i] = row ? kk[r][p] : d[r][p];
    }
    __syncthreads();
    for (int i = 0; i < kPer; ++i) {
      const int r = threadIdx.y + kRows * i;
      d[r][c] = fminf(d[r][c], a[i] + b);
    }
    __syncthreads();
  }
  if (row) store_tile(d, D, n, k, x); else store_tile(d, D, n, x, k);
}

// Phase 3: every tile (i, j) off the pivot row and column,
// D[i,j] = min(D[i,j], min_p D[i,k][:, p] + D[k,j][p, :]).
__global__ void __launch_bounds__(kT * kRows)
fw_phase3(float* D, int n, int k) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  if (ti == k || tj == k) return;
  __shared__ float col[kT][kT + 1];
  __shared__ float rowt[kT][kT + 1];
  load_tile(col, D, n, ti, k);
  load_tile(rowt, D, n, k, tj);
  const int c = threadIdx.x;
  float acc[kPer];
  for (int i = 0; i < kPer; ++i) {
    const int r = threadIdx.y + kRows * i;
    acc[i] = D[(size_t)(ti * kT + r) * n + tj * kT + c];
  }
  __syncthreads();
#pragma unroll 8
  for (int p = 0; p < kT; ++p) {
    const float b = rowt[p][c];
    for (int i = 0; i < kPer; ++i)
      acc[i] = fminf(acc[i], col[threadIdx.y + kRows * i][p] + b);
  }
  for (int i = 0; i < kPer; ++i) {
    const int r = threadIdx.y + kRows * i;
    D[(size_t)(ti * kT + r) * n + tj * kT + c] = acc[i];
  }
}

}  // namespace

// D: n_pad x n_pad row-major f32, n_pad a multiple of 32, padded by the
// caller with 1e9 off the diagonal and 0 on it.  Updated in place.
extern "C" int fw_minplus_launch(float* D, int n_pad, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_pad % kT != 0) return (int)cudaErrorInvalidValue;
  const int nb = n_pad / kT;
  const dim3 block(kT, kRows);
  for (int k = 0; k < nb; ++k) {
    fw_phase1<<<1, block, 0, stream>>>(D, n_pad, k);
    fw_phase2<<<dim3(nb, 2), block, 0, stream>>>(D, n_pad, k);
    fw_phase3<<<dim3(nb, nb), block, 0, stream>>>(D, n_pad, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
