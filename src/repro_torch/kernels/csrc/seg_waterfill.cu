// seg_waterfill: ECMP max-min-fair flow allocation + Mathis cap + per-link
// load, for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/seg_waterfill/seg_waterfill.py,
//           seg_waterfill (pallas_call with body _waterfill_kernel).
//
// What it computes (the plain version is seg_waterfill_ref in
// src/repro_torch/kernels/seg_waterfill/seg_waterfill.py): all n_rounds
// progressive-filling rounds of the max-min-fair allocation with the freeze
// rule bound <= m*1.000001 + 1e-6, the leftover-flow tail, the Mathis min
// rates = min(fair, tcp) * active, and the per-link load.
//
// What bounds it on this card: neither bytes (about 1 MB at F = 12000,
// E = 2800) nor operations (a few hundred thousand adds and mins), but
// latency.  Each round is a chain of dependent steps (per-link share ->
// per-flow bound -> global min -> freeze -> per-link used capacity), so
// the time is the rounds times the latency of the longest per-link list
// walk, plus launch overhead.
//
// What the design does about that:
//  * The TPU kernel's [bf, be] one-hot contraction (a workaround for the
//    TPU's lack of a vectorised scatter) is not carried over.  Instead one
//    pass builds a link -> slot CSR of the valid (link >= 0 and active)
//    slots, ordered by slot index within each link: a stable counting sort
//    (per-tile histograms, one scan, one fill in which each warp ranks its
//    slots with __match_any_sync).  The CSR lives in global memory / L2:
//    at F*4 = 48k slots it would nearly fill one block's shared memory.
//  * Every per-link sum is then one thread walking its link's list in
//    ascending slot order — the order jax.ops.segment_sum and index_add_
//    add in on the CPU — with no atomics, so the result is deterministic
//    and the rates equal the plain version bit for bit.  Per-flow bounds
//    are a min over at most 4 shares; the global min is a block reduction
//    (min is order-free).
//  * All rounds run in ONE block of 1024 threads, so a round's phases are
//    separated by __syncthreads() instead of kernel launches.
//  * Rounding: built without --use_fast_math, and the freeze threshold,
//    fair share and sums use __fmul_rn/__fadd_rn/__fdiv_rn/__fsub_rn so
//    nvcc cannot contract m*1.000001f + 1e-6f into one FMA (which rounds
//    once and could freeze a different set of flows).
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 1024;

// K1: per-tile link histogram of the valid slots (integer atomics: the
// counts do not depend on the order of the adds).
__global__ void csr_count(const int* __restrict__ links,
                          const int* __restrict__ active, int n_slots,
                          int tile, int E, int* __restrict__ hist) {
  const int b = blockIdx.x;
  const int end = min(n_slots, (b + 1) * tile);
  for (int s = b * tile + threadIdx.x; s < end; s += blockDim.x) {
    const int e = links[s];
    if (e >= 0 && active[s >> 2] != 0) atomicAdd(&hist[b * E + e], 1);
  }
}

// K2 (one block): turn the histograms into each tile's start offset per
// link, and ptr[] into the CSR row pointer.
__global__ void __launch_bounds__(kBlock)
csr_scan(int* __restrict__ hist, int n_tiles, int E, int* __restrict__ ptr) {
  __shared__ int part[kBlock];
  const int tid = threadIdx.x;
  // per link: exclusive running sum over the tiles, total into ptr[e+1]
  for (int e = tid; e < E; e += kBlock) {
    int run = 0;
    for (int b = 0; b < n_tiles; ++b) {
      const int c = hist[b * E + e];
      hist[b * E + e] = run;
      run += c;
    }
    ptr[e + 1] = run;
  }
  __syncthreads();
  // inclusive scan of the totals in place over ptr[1..E], which makes ptr
  // the row pointer (ptr[0] = 0 from the memset): each thread scans one
  // contiguous chunk, after thread 0 has scanned the chunk sums
  const int chunk = (E + kBlock - 1) / kBlock;
  const int lo = min(E, tid * chunk), hi = min(E, lo + chunk);
  int sum = 0;
  for (int e = lo; e < hi; ++e) sum += ptr[e + 1];
  part[tid] = sum;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int i = 0; i < kBlock; ++i) {
      const int c = part[i];
      part[i] = run;
      run += c;
    }
  }
  __syncthreads();
  int run = part[tid];
  for (int e = lo; e < hi; ++e) {
    run += ptr[e + 1];
    ptr[e + 1] = run;
  }
}

// K3 (one warp per tile): stable fill.  The warp walks its tile 32 slots
// at a time; lanes holding the same link rank themselves by lane order
// (__match_any_sync), so slots land in ascending slot order within each
// link's list.
__global__ void csr_fill(const int* __restrict__ links,
                         const int* __restrict__ active, int n_slots,
                         int tile, int E, int* __restrict__ hist,
                         const int* __restrict__ ptr, int* __restrict__ list) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int end = min(n_slots, (b + 1) * tile);
  int* cursor = hist + b * E;
  const unsigned lt = (1u << lane) - 1u;
  for (int base = b * tile; base < end; base += kWarp) {
    const int s = base + lane;
    int e = -1;
    if (s < end) {
      const int l = links[s];
      if (l >= 0 && active[s >> 2] != 0) e = l;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    int start = 0;
    if (e >= 0) start = cursor[e];
    __syncwarp();
    if (e >= 0) {
      list[ptr[e] + start + __popc(peers & lt)] = s >> 2;
      if ((peers & lt) == 0u) cursor[e] = start + __popc(peers);
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float block_min(float v, float* red) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
    for (int off = kWarp / 2; off > 0; off >>= 1)
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float m = red[0];
  __syncthreads();   // red[] is reused by the next call
  return m;
}

// Per-link fair share of the unfrozen flows: cap_rem / count (inf when
// the link carries none).  Counts of 1.0f are exact, so the order of the
// walk does not matter here.
__device__ void link_shares(const int* __restrict__ ptr,
                            const int* __restrict__ list,
                            const int* __restrict__ frozen,
                            const float* __restrict__ cap_rem,
                            float* __restrict__ share, int E, float inf) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int cnt = 0;
    for (int s = ptr[e]; s < ptr[e + 1]; ++s) cnt += frozen[list[s]] == 0;
    share[e] = cnt > 0 ? __fdiv_rn(cap_rem[e], fmaxf((float)cnt, 1.0f))
                       : inf;
  }
}

__device__ __forceinline__ float flow_bound(const int* __restrict__ links,
                                            const float* __restrict__ share,
                                            int f, float inf) {
  float b = inf;
  for (int j = 0; j < 4; ++j) {
    const int l = links[4 * f + j];
    if (l >= 0) b = fminf(b, share[l]);
  }
  return b;
}

// K4 (one block of 1024 threads): every round, the tail, the Mathis min
// and the load.  Per-flow and per-link state lives in the workspace.
__global__ void __launch_bounds__(kBlock)
waterfill(const int* __restrict__ links, const int* __restrict__ active,
          const float* __restrict__ cap, const float* __restrict__ tcp,
          const int* __restrict__ ptr, const int* __restrict__ list,
          float* __restrict__ rates, float* __restrict__ load,
          float* __restrict__ cap_rem, float* __restrict__ share,
          float* __restrict__ alloc, float* __restrict__ bound,
          int* __restrict__ frozen, int* __restrict__ newly,
          int F, int E, int n_rounds, float local_rate, float inf) {
  __shared__ float red[kWarp];
  const int tid = threadIdx.x;
  for (int f = tid; f < F; f += kBlock) {
    const bool act = active[f] != 0;
    bool any = false;
    for (int j = 0; j < 4; ++j) any |= links[4 * f + j] >= 0;
    alloc[f] = act ? local_rate : 0.0f;
    frozen[f] = act && !any;   // no-link flows keep the loopback rate
  }
  for (int e = tid; e < E; e += kBlock) cap_rem[e] = cap[e];
  __syncthreads();

  for (int r = 0; r < n_rounds; ++r) {
    link_shares(ptr, list, frozen, cap_rem, share, E, inf);
    __syncthreads();
    float lmin = inf;
    for (int f = tid; f < F; f += kBlock) {
      float b = inf;
      if (active[f] != 0 && frozen[f] == 0) b = flow_bound(links, share, f, inf);
      bound[f] = b;
      lmin = fminf(lmin, b);
    }
    const float m = block_min(lmin, red);
    const float thr = __fadd_rn(__fmul_rn(m, 1.000001f), 1e-6f);
    for (int f = tid; f < F; f += kBlock) {
      const bool nw = active[f] != 0 && frozen[f] == 0 && bound[f] <= thr;
      newly[f] = nw;
      if (nw) {
        alloc[f] = fminf(bound[f], local_rate);
        frozen[f] = 1;
      }
    }
    __syncthreads();
    for (int e = tid; e < E; e += kBlock) {
      float used = 0.0f;
      for (int s = ptr[e]; s < ptr[e + 1]; ++s) {
        const int f = list[s];
        if (newly[f]) used = __fadd_rn(used, alloc[f]);
      }
      cap_rem[e] = fmaxf(__fsub_rn(cap_rem[e], used), 0.0f);
    }
    __syncthreads();
  }

  // leftover tail: flows still unfrozen take their current fair share
  link_shares(ptr, list, frozen, cap_rem, share, E, inf);
  __syncthreads();
  for (int f = tid; f < F; f += kBlock) {
    const bool act = active[f] != 0;
    float a = alloc[f];
    if (act && frozen[f] == 0) a = fminf(flow_bound(links, share, f, inf), local_rate);
    const float fair = act ? a : 0.0f;
    rates[f] = __fmul_rn(fminf(fair, tcp[f]), act ? 1.0f : 0.0f);
  }
  __syncthreads();
  for (int e = tid; e < E; e += kBlock) {
    float sum = 0.0f;
    for (int s = ptr[e]; s < ptr[e + 1]; ++s) sum = __fadd_rn(sum, rates[list[s]]);
    load[e] = sum;
  }
}

}  // namespace

// Workspace sizes the caller allocates (element counts):
//   ws_i: n_tiles*E + (E+1) + 4F + F + F   ints
//   ws_f: E + E + F + F                    floats
extern "C" int seg_waterfill_launch(const int* links, const int* active,
                                    const float* cap, const float* tcp,
                                    float* rates, float* load, int* ws_i,
                                    float* ws_f, int F, int E, int n_tiles,
                                    int tile, int n_rounds, float local_rate,
                                    float inf, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_slots = 4 * F;
  int* hist = ws_i;
  int* ptr = hist + n_tiles * E;
  int* list = ptr + (E + 1);
  int* frozen = list + n_slots;
  int* newly = frozen + F;
  float* cap_rem = ws_f;
  float* share = cap_rem + E;
  float* alloc = share + E;
  float* bound = alloc + F;

  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)n_tiles * E, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(ptr, 0, sizeof(int) * (size_t)(E + 1), stream);
  if (err != cudaSuccess) return (int)err;
  csr_count<<<n_tiles, 256, 0, stream>>>(links, active, n_slots, tile, E, hist);
  csr_scan<<<1, kBlock, 0, stream>>>(hist, n_tiles, E, ptr);
  csr_fill<<<n_tiles, kWarp, 0, stream>>>(links, active, n_slots, tile, E, hist, ptr, list);
  waterfill<<<1, kBlock, 0, stream>>>(links, active, cap, tcp, ptr, list, rates, load,
                                      cap_rem, share, alloc, bound, frozen, newly,
                                      F, E, n_rounds, local_rate, inf);
  return (int)cudaGetLastError();
}
