// fw_minplus: blocked min-plus Floyd-Warshall (all-pairs shortest paths)
// for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fw_minplus/fw_minplus.py, floyd_warshall
//           (pallas_calls of _phase1_kernel, _phase2_row_kernel,
//           _phase2_col_kernel and _phase3_kernel).
//
// What it computes: D = APSP of the padded adjacency D (in place) by the
// 3-phase blocked Floyd-Warshall over 64 x 64 tiles.  For each pivot block
// K: close the pivot tile (in-tile FW), update the pivot row and column
// panels against the closed tile, then relax every other tile,
// D[i,j] = min(D[i,j], D[i,K] (+) D[K,j]).  The plain version is
// floyd_warshall_ref in src/repro_torch/core/network.py.
//
// What bounds it on this card: operations.  Min-plus has no tensor-core
// form: each relaxation is one FADD and one FMNMX, n_pad^3 of each (1.4e10
// at n_pad = 2432), against ~24 MB of matrix that stays in the 50 MB L2
// across pivots.  The bound is the issue of 2 n_pad^3 FP32 instructions
// at 128 lanes a clock an SM (0.86 ms on 132 SMs at 1980 MHz); FMNMX
// issues at 64 lanes a clock, half the FADD's rate, so the FMNMX pipe
// alone gives the same time.
//
// What the design does about that:
// * Phase 3 (nearly all the work) is register-tiled like an SGEMM.  A
//   block of 128 threads owns one 64 x 64 output tile; each thread holds
//   8 x 4 outputs in registers (rows ty*4+{0..3} and 32+ty*4+{0..3},
//   columns tx*4+{0..3}, so that a quarter-warp's 128-bit shared loads hit
//   32 distinct banks or one broadcast address).  The block stages the
//   pivot-column tile D[i,K] and the pivot-row tile D[K,j] in shared
//   memory once per pivot (cp.async, no registers); every 4 steps of p
//   cost a thread 8 + 4 128-bit shared loads for 256 FP32 instructions,
//   with no barrier in the loop, so shared loads do not bound it (the
//   earlier 32-node-tile kernel spent 5 scalar shared loads per 8 FP32
//   instructions).
// * The fragment shape was chosen on the card among 8 x 8, 8 x 4, 4 x 8
//   and 4 x 4: 8 x 8 (64 threads) spills under the register cap of 6
//   blocks a SM and leaves too few warps under 4; 4 x 4 doubles the
//   shared loads per instruction; 8 x 4 at 4 blocks a SM (120 registers,
//   no spill, 16 warps) was the fastest.
// * Two launches per pivot block instead of three.  Launch A (fw_panels)
//   updates the 2 (nb - 1) panel tiles; with the pivot tile already closed
//   that update is a min-plus product with the closed tile (a path from
//   the pivot block leaves it from its last pivot-block node), so it has
//   no sequential dependency and runs as the same register-tiled product.
//   Launch B (fw_tiles) runs phase 3 over the (nb - 1)^2 other tiles; its
//   first block is tile (K+1, K+1), which after its phase-3 update closes
//   itself (phase 1 of the next pivot) and is stored closed.  No other
//   block of launch B reads that tile, and launch A of pivot K+1 reads it
//   after launch B ends.  Pivot 0 has no launch before it: launch A closes
//   its own shared-memory copy of tile (0, 0) in every block, and launch B
//   gets one extra block that closes and stores that tile.
// * Every launch is a programmatic dependent launch: it is scheduled while
//   the one before drains, and its blocks wait on griddepcontrol.wait, so
//   the 2 nb dependent launches do not pay their launch latency in series.
// * 64-edge tiles: n_pad = 2432 gives 37^2 = 1369 phase-3 blocks a pivot,
//   ~10 a SM, so the last wave is a small part of the launch; 128-edge
//   tiles would give 18^2 = 324 blocks at 1-2 resident a SM, ~1.2 waves
//   with much of the last idle.
// * The closure steps are the only serial part: at step p the owners of
//   row p and column p put them in a double-buffered shared row/column
//   (one barrier a step), and every thread relaxes its outputs against the
//   old row and column, as the plain version does.  Every copy of a tile's
//   closure does the same adds and mins in the same order from the same
//   bits, whatever its thread layout, so the result is deterministic.
// Every add is one rounding and min is exact, so on dyadic weights, where
// every path sum is exact, the result equals the plain version bit for
// bit; otherwise the blocked association differs by a few ulps.  No fast
// math, and no DPX (its min-plus instructions are integer-only).
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;   // tile edge

// A thread's fragment of a 64 x 64 tile: RG groups of 4 rows and CG groups
// of 4 columns; with TY = 16 / RG by TX = 16 / CG threads, local row
// a = 4 g + i is tile row (g TY + ty) 4 + i, and local column likewise.
template <int RG, int CG>
struct Frag {
  static constexpr int TY = 16 / RG, TX = 16 / CG, kThreads = TY * TX;
  float v[4 * RG][4 * CG];
  int ty, tx;

  __device__ Frag() : ty(threadIdx.x / TX), tx(threadIdx.x % TX) {}
  __device__ int row(int a) const { return ((a / 4) * TY + ty) * 4 + a % 4; }
  __device__ int col(int h) const { return (h * TX + tx) * 4; }

  // from / to a tile with row stride ld (device or shared memory)
  __device__ void load(const float* t, int ld) {
#pragma unroll
    for (int a = 0; a < 4 * RG; ++a)
#pragma unroll
      for (int h = 0; h < CG; ++h) {
        const float4 q = *reinterpret_cast<const float4*>(
            t + (size_t)row(a) * ld + col(h));
        v[a][4 * h] = q.x; v[a][4 * h + 1] = q.y;
        v[a][4 * h + 2] = q.z; v[a][4 * h + 3] = q.w;
      }
  }
  __device__ void store(float* t, int ld) const {
#pragma unroll
    for (int a = 0; a < 4 * RG; ++a)
#pragma unroll
      for (int h = 0; h < CG; ++h)
        *reinterpret_cast<float4*>(t + (size_t)row(a) * ld + col(h)) =
            make_float4(v[a][4 * h], v[a][4 * h + 1], v[a][4 * h + 2],
                        v[a][4 * h + 3]);
  }

  // v = min(v, A (+) B) over the 64 steps of p: A, B 64 x 64 in shared
  // memory, v[r][c] = fminf(v[r][c], A[r][p] + B[p][c]), p ascending.
  __device__ void minplus(const float* A, const float* B) {
#pragma unroll 2
    for (int p0 = 0; p0 < kT; p0 += 4) {
      float4 a[4 * RG];
#pragma unroll
      for (int r = 0; r < 4 * RG; ++r)
        a[r] = *reinterpret_cast<const float4*>(A + row(r) * kT + p0);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float b[4 * CG];
#pragma unroll
        for (int h = 0; h < CG; ++h) {
          const float4 q = *reinterpret_cast<const float4*>(
              B + (p0 + s) * kT + col(h));
          b[4 * h] = q.x; b[4 * h + 1] = q.y;
          b[4 * h + 2] = q.z; b[4 * h + 3] = q.w;
        }
#pragma unroll
        for (int r = 0; r < 4 * RG; ++r) {
          const float ar = s == 0 ? a[r].x : s == 1 ? a[r].y
                         : s == 2 ? a[r].z : a[r].w;
#pragma unroll
          for (int c = 0; c < 4 * CG; ++c) v[r][c] = fminf(v[r][c], ar + b[c]);
        }
      }
    }
  }

  // In-tile Floyd-Warshall of the tile this fragment holds (the whole
  // block holds it): step p relaxes every output against the old row p
  // and column p, which their owners put in buf[p & 1] (buf[s][0] the
  // row, buf[s][1] the column).  The caller makes buf free to write.
  __device__ void close(float (*buf)[2][kT]) {
#pragma unroll
    for (int p = 0; p < kT; ++p) {
      float (*out)[kT] = buf[p & 1];
      const int a = (p / (4 * TY)) * 4 + p % 4;   // local row of row p
      const int b = (p / (4 * TX)) * 4 + p % 4;   // local column of col p
      if (ty == (p / 4) % TY)
#pragma unroll
        for (int h = 0; h < CG; ++h)
          *reinterpret_cast<float4*>(&out[0][col(h)]) =
              make_float4(v[a][4 * h], v[a][4 * h + 1], v[a][4 * h + 2],
                          v[a][4 * h + 3]);
      if (tx == (p / 4) % TX)
#pragma unroll
        for (int g = 0; g < RG; ++g)
          *reinterpret_cast<float4*>(&out[1][row(4 * g)]) =
              make_float4(v[4 * g][b], v[4 * g + 1][b], v[4 * g + 2][b],
                          v[4 * g + 3][b]);
      __syncthreads();
      float rw[4 * CG], cl[4 * RG];
#pragma unroll
      for (int h = 0; h < CG; ++h) {
        const float4 q = *reinterpret_cast<const float4*>(&out[0][col(h)]);
        rw[4 * h] = q.x; rw[4 * h + 1] = q.y;
        rw[4 * h + 2] = q.z; rw[4 * h + 3] = q.w;
      }
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const float4 q = *reinterpret_cast<const float4*>(&out[1][row(4 * g)]);
        cl[4 * g] = q.x; cl[4 * g + 1] = q.y;
        cl[4 * g + 2] = q.z; cl[4 * g + 3] = q.w;
      }
#pragma unroll
      for (int r = 0; r < 4 * RG; ++r)
#pragma unroll
        for (int c = 0; c < 4 * CG; ++c)
          v[r][c] = fminf(v[r][c], cl[r] + rw[c]);
    }
  }
};

using PanelFrag = Frag<1, 1>;   // 256 threads, 4 x 4 outputs each
using TileFrag = Frag<2, 1>;    // 128 threads, 8 x 4 outputs each
constexpr int kTileBlocks = 4;  // fw_tiles blocks a SM: <= 128 registers

// Programmatic dependent launch: every launch of fw_minplus_launch may
// start while the launch before it drains; its blocks wait here for that
// launch to finish and its writes to be visible, then let the next launch
// start to be scheduled.
__device__ __forceinline__ void wait_for_previous_launch() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ float* tile(float* D, int n, int ti, int tj) {
  return D + (size_t)ti * kT * n + (size_t)tj * kT;
}

// Copy the 64 x 64 tile at g (row stride n) into s, 16 bytes a copy,
// asynchronously (cp.async, through L2 only); wait with cp_async_wait().
template <int kThreads>
__device__ __forceinline__ void cp_async_tile(float (*s)[kT], const float* g,
                                              int n) {
  for (int q = threadIdx.x; q < kT * kT / 4; q += kThreads) {
    const int r = q / (kT / 4), c = (q % (kT / 4)) * 4;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(&s[r][c]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(g + (size_t)r * n + c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Launch A of pivot k: block b < nb - 1 updates row-panel tile (k, x),
// block b >= nb - 1 column-panel tile (x, k), x the b-th tile index other
// than k: row tile = min(row, kk (+) row), column tile = min(col,
// col (+) kk), kk the closed pivot tile.  With close != 0 (pivot 0) the
// block first closes its own copy of tile (k, k).  Never writes (k, k).
__global__ void __launch_bounds__(PanelFrag::kThreads)
fw_panels(float* D, int n, int k, int close) {
  __shared__ __align__(16) float kk[kT][kT];
  __shared__ __align__(16) float pan[kT][kT];
  __shared__ __align__(16) float buf[2][2][kT];
  wait_for_previous_launch();
  const int nb = n / kT;
  const bool row = blockIdx.x < nb - 1;
  const int x0 = blockIdx.x % (nb - 1);
  const int x = x0 + (x0 >= k);
  float* pg = row ? tile(D, n, k, x) : tile(D, n, x, k);
  cp_async_tile<PanelFrag::kThreads>(pan, pg, n);
  PanelFrag f;
  if (close) {
    f.load(tile(D, n, k, k), n);
    f.close(buf);
    f.store(&kk[0][0], kT);
  } else {
    cp_async_tile<PanelFrag::kThreads>(kk, tile(D, n, k, k), n);
  }
  cp_async_wait();
  __syncthreads();
  f.load(&pan[0][0], kT);
  if (row) f.minplus(&kk[0][0], &pan[0][0]);
  else f.minplus(&pan[0][0], &kk[0][0]);
  f.store(pg, n);
}

// Launch B of pivot k: phase 3 over the (nb - 1)^2 tiles (i, j), i, j != k,
// ordered from (k + 1, k + 1) so that the tile to close comes first.
// Tile (k + 1, k + 1) is stored closed (phase 1 of pivot k + 1).  At
// pivot 0 block 0 closes and stores tile (0, 0) instead.
__global__ void __launch_bounds__(TileFrag::kThreads, kTileBlocks)
fw_tiles(float* D, int n, int k) {
  __shared__ __align__(16) float colp[kT][kT];   // D[i,k]
  __shared__ __align__(16) float rowp[kT][kT];   // D[k,j]
  auto buf = reinterpret_cast<float (*)[2][kT]>(&colp[0][0]);
  wait_for_previous_launch();
  const int nb = n / kT;
  int t = blockIdx.x;
  TileFrag f;
  if (k == 0) {
    if (t == 0) {
      f.load(D, n);
      f.close(buf);
      f.store(D, n);
      return;
    }
    --t;
  }
  const int i = (k + 1 + t / (nb - 1)) % nb;
  const int j = (k + 1 + t % (nb - 1)) % nb;
  cp_async_tile<TileFrag::kThreads>(colp, tile(D, n, i, k), n);
  cp_async_tile<TileFrag::kThreads>(rowp, tile(D, n, k, j), n);
  float* out = tile(D, n, i, j);
  f.load(out, n);
  cp_async_wait();
  __syncthreads();
  f.minplus(&colp[0][0], &rowp[0][0]);
  if (t == 0 && k + 1 < nb) {
    __syncthreads();   // every thread is done with colp: buf reuses it
    f.close(buf);
  }
  f.store(out, n);
}

}  // namespace

// D: n_pad x n_pad row-major f32, n_pad a multiple of 64, padded by the
// caller with 1e9 off the diagonal and 0 on it.  Updated in place, in two
// launches per pivot block (one where n_pad = 64), each a programmatic
// dependent launch on the stream.
extern "C" int fw_minplus_launch(float* D, int n_pad, void* stream_ptr) {
  if (n_pad <= 0 || n_pad % kT != 0) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  static bool carveout = false;
  if (!carveout) {   // the largest shared-memory carve-out for fw_tiles
    const cudaError_t err = cudaFuncSetAttribute(
        fw_tiles, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    carveout = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.stream = static_cast<cudaStream_t>(stream_ptr);
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const int nb = n_pad / kT;
  for (int k = 0; k < nb; ++k) {
    cudaError_t err = cudaSuccess;
    if (nb > 1) {
      cfg.gridDim = dim3(2 * (nb - 1));
      cfg.blockDim = dim3(PanelFrag::kThreads);
      err = cudaLaunchKernelEx(&cfg, fw_panels, D, n_pad, k, (int)(k == 0));
      if (err != cudaSuccess) return (int)err;
    }
    cfg.gridDim = dim3((nb - 1) * (nb - 1) + (k == 0));
    cfg.blockDim = dim3(TileFrag::kThreads);
    err = cudaLaunchKernelEx(&cfg, fw_tiles, D, n_pad, k);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
