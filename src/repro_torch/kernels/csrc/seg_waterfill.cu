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
// E = 2800) nor operations (a few hundred thousand adds and mins), but a
// chain of dependent, block-wide phases on one SM: a CSR build, then per
// round a per-link update (used capacity, share), a per-flow bound, a
// global min and a freeze — three barriers a round — where every per-link
// sum is a chain of f32 adds that must run in ascending slot order, one
// rounding per add, to equal the plain version.
//
// The TPU kernel's [bf, be] one-hot contraction (a workaround for the TPU's
// lack of a vectorised scatter) is not carried over.  Both variants build a
// link -> slot CSR of the valid (link >= 0 and active) slots, ordered by
// slot index within each link: a stable counting sort (per-tile link
// histograms, a running sum over the tiles, a scan of the link totals, and
// a fill in which one warp walks each tile 32 slots a step and ranks the
// lanes that share a link by lane order).  Every per-link sum then walks
// its list in ascending slot order — the order index_add_ adds in on the
// CPU and segment_sum in the JAX package — with no float atomics, so the
// rates equal the plain version bit for bit.  Per-flow bounds are a min
// over at most P shares; the global min is a block reduction (min is
// order-free).
//
// P, the path width (a flow's link ids, -1 padded), is a compile-time
// parameter, built for P = 4 (the spine-leaf fabric) and P = 6 (the k-ary
// fat tree).  Flow f's ids are slots P f .. P f + P - 1.  At P = 4 a thread
// reads them as one int4 and a slot's flow is s >> 2; at P = 6 as three
// int2 (8-byte aligned: no unaligned vector load) and s / 6.
//
// Two variants, chosen by size alone (variant() in the wrapper):
//
//  * waterfill_smem: one launch of one 1024-thread block whose whole state
//    lives in dynamic shared memory ((2P + 5)F + 17E + 132 bytes <= 232448
//    and F <= 16383, so that every count, offset and flow id fits 16 bits):
//      red[32] f32 | ptr[E+1] i32 | list[PF] u16 | cnt[E] i32 |
//      cap_rem[E] f32 | share[E] f32 | alloc[F] f32 | newly[F] u8 |
//      touched[E] u8
//    Every dependent load of a list walk is a shared-memory load instead
//    of an L2 load, and the memsets and three of the four launches go.
//    The CSR build runs in the same launch, its per-tile u16 histograms in
//    the bytes that cnt..touched take afterwards: one shared atomic per
//    slot counts; the fill writes each lane's id into the next free entry
//    of its link's list and reads it back, and only where two lanes met
//    ranks them, with one ballot per key bit (__match_any_sync costs more
//    here).  A round walks only the lists of the links a newly frozen
//    flow crosses (touched), for their used capacity and to take those
//    flows from the link's unfrozen count; every other link keeps its
//    share.  A live flow's bound waits for the freeze in its alloc slot,
//    which only a frozen flow's allocation needs.  A list longer than
//    kWarpWalkMin is walked by the whole warp (the lanes load 32 slots,
//    then every lane adds the values in slot order from registers), a
//    shorter one by its lane.  Each thread owns flows f = k*1024 + tid and
//    keeps their link ids in registers as u16 pairs.  (Past 4 flows a
//    thread they spill; re-reading them from global memory in each pass
//    measured no faster at 12 flows a thread and slower at 1.)  What
//    bounds it now is issue and latency on the one SM: the build's
//    per-slot work and each round's per-flow and per-link work, behind the
//    barriers.
//  * for sizes that do not fit, the first design: the CSR and the per-flow
//    and per-link state in a global-memory workspace, four launches (count,
//    scan, fill, rounds) and two memsets.
//
// Rounding: built without --use_fast_math, and the freeze threshold, fair
// share and sums use __fmul_rn/__fadd_rn/__fdiv_rn/__fsub_rn so nvcc cannot
// contract m*1.000001f + 1e-6f into one FMA (which rounds once and could
// freeze a different set of flows).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The flow of slot s >= 0.
template <int P>
__device__ __forceinline__ int slot_flow(int s) {
  if constexpr (P == 4) return s >> 2;
  else return s / P;
}

constexpr int kWarp = 32;
constexpr int kBlock = 1024;
constexpr unsigned kFull = 0xffffffffu;

// ===========================================================================
// Global-memory variant (four launches)
// ===========================================================================

// K1: per-tile link histogram of the valid slots (integer atomics: the
// counts do not depend on the order of the adds).
template <int P>
__global__ void csr_count(const int* __restrict__ links,
                          const unsigned char* __restrict__ active,
                          int n_slots, int tile, int E, int* __restrict__ hist) {
  const int b = blockIdx.x;
  const int end = min(n_slots, (b + 1) * tile);
  for (int s = b * tile + threadIdx.x; s < end; s += blockDim.x) {
    const int e = links[s];
    if (e >= 0 && active[slot_flow<P>(s)] != 0) atomicAdd(&hist[b * E + e], 1);
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
template <int P>
__global__ void csr_fill(const int* __restrict__ links,
                         const unsigned char* __restrict__ active, int n_slots,
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
      if (l >= 0 && active[slot_flow<P>(s)] != 0) e = l;
    }
    const unsigned peers = __match_any_sync(kFull, e);
    int start = 0;
    if (e >= 0) start = cursor[e];
    __syncwarp();
    if (e >= 0) {
      list[ptr[e] + start + __popc(peers & lt)] = slot_flow<P>(s);
      if ((peers & lt) == 0u) cursor[e] = start + __popc(peers);
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float block_min(float v, float* red) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
    for (int off = kWarp / 2; off > 0; off >>= 1)
      v = fminf(v, __shfl_xor_sync(kFull, v, off));
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

template <int P>
__device__ __forceinline__ float flow_bound(const int* __restrict__ links,
                                            const float* __restrict__ share,
                                            int f, float inf) {
  float b = inf;
  for (int j = 0; j < P; ++j) {
    const int l = links[P * f + j];
    if (l >= 0) b = fminf(b, share[l]);
  }
  return b;
}

// K4 (one block of 1024 threads): every round, the tail, the Mathis min
// and the load.  Per-flow and per-link state lives in the workspace.
template <int P>
__global__ void __launch_bounds__(kBlock)
waterfill(const int* __restrict__ links, const unsigned char* __restrict__ active,
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
    for (int j = 0; j < P; ++j) any |= links[P * f + j] >= 0;
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
      if (active[f] != 0 && frozen[f] == 0) b = flow_bound<P>(links, share, f, inf);
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
    if (act && frozen[f] == 0) a = fminf(flow_bound<P>(links, share, f, inf), local_rate);
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

// ===========================================================================
// Shared-memory variant (one launch)
// ===========================================================================

constexpr int kSmemLimit = 232448;     // dynamic shared memory of one block
constexpr int kSmemMaxFlows = 16383;   // flow ids and tile counts fit u16
constexpr int kMaxFlowsPerThread = (kSmemMaxFlows + kBlock - 1) / kBlock;  // 16
constexpr int kMaxKeyBits = 14;        // link ids + 1 <= E < 2^14 here
constexpr int kPrefetch = 8;           // 32-slot groups loaded at once
constexpr unsigned kNoLink = 0xffffu;
// lists longer than this are walked by a whole warp (picked on the card;
// PERF.md has the sweep)
constexpr int kWarpWalkMin = 128;

size_t smem_bytes(int F, int E, int P) {
  return 132 + (2 * (size_t)P + 5) * (size_t)F + 17 * (size_t)E;
}

// The state's arrays in dynamic shared memory, in this order.  hist (the
// CSR build's per-tile u16 link histograms, n_tiles * E of them) lies in
// the 13E + 5F bytes of cnt..touched, which it leaves before they are
// first written.
template <int P>
struct Smem {
  float* red;              // [32]   block reductions
  int* ptr;                // [E+1]  CSR row pointer
  unsigned short* list;    // [PF]   flow ids, ascending slot order per link
  int* cnt;                // [E]    unfrozen flows on the link
  float* cap_rem;          // [E]
  float* share;            // [E]
  float* alloc;            // [F]    a live flow's current bound instead
  unsigned char* newly;    // [F]    froze in the last round
  unsigned char* touched;  // [E]    crossed by a flow that froze
  unsigned short* hist;

  __device__ __forceinline__ Smem(unsigned char* base, int F, int E) {
    red = reinterpret_cast<float*>(base);
    ptr = reinterpret_cast<int*>(red + kWarp);
    list = reinterpret_cast<unsigned short*>(ptr + E + 1);
    cnt = reinterpret_cast<int*>(list + P * F);
    cap_rem = reinterpret_cast<float*>(cnt + E);
    share = cap_rem + E;
    alloc = share + E;
    newly = reinterpret_cast<unsigned char*>(alloc + F);
    touched = newly + F;
    hist = reinterpret_cast<unsigned short*>(cnt);
  }
};

// The valid link of slot s: its link id when s < n_slots names one and its
// flow is active, else -1.  n_slots >= 1.  The loads take a clamped index
// rather than a branch, so that a loop's loads issue together.
template <int P>
__device__ __forceinline__ int slot_link(const int* __restrict__ links,
                                         const unsigned char* __restrict__ active,
                                         int s, int n_slots) {
  const int sc = min(s, n_slots - 1);
  const int l = __ldg(links + sc);
  const unsigned char a = __ldg(active + slot_flow<P>(sc));
  return (s < n_slots && l >= 0 && a != 0) ? l : -1;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x % kWarp;
  for (int off = 1; off < kWarp; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// The lanes of the warp whose key equals this lane's (what __match_any_sync
// returns, which costs more on this card), from one ballot per key bit: a
// lane matches where every bit agrees.  Keys are below 2^bits, bits <= 14.
__device__ __forceinline__ unsigned warp_peers(unsigned key, int bits) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < kMaxKeyBits; ++b) {
    if (b >= bits) break;
    const unsigned m = __ballot_sync(kFull, (key >> b) & 1u);
    peers &= ((key >> b) & 1u) ? m : ~m;
  }
  return peers;
}

// sum + the 32 lanes' v, added one at a time in lane order (the same in
// every lane).  Eight shuffles issue before their adds, so that the adds
// do not each wait out a shuffle's latency.
__device__ __forceinline__ float add_in_lane_order(float sum, float v) {
#pragma unroll
  for (int j0 = 0; j0 < kWarp; j0 += 8) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __shfl_sync(kFull, v, j0 + j);
#pragma unroll
    for (int j = 0; j < 8; ++j) sum = __fadd_rn(sum, x[j]);
  }
  return sum;
}

// Block min with one barrier: each warp writes its min, then every warp
// reduces all 32.  red is written again only after two more barriers.
__device__ __forceinline__ float block_min_1(float v, float* red) {
  v = warp_min(v);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  return warp_min(red[threadIdx.x % kWarp]);
}

// The link ids of a thread's flows f = k*kBlock + tid (k < K), read once
// and kept in registers as u16 pairs (kNoLink for none), and which flows
// are active.
template <int K, int P>
struct FlowLinks {
  static_assert(P == 4 || P == 6, "built for paths of 4 and 6 links");
  uint32_t pair[K][P / 2];
  uint32_t act;

  __device__ __forceinline__ void load(const int* __restrict__ links,
                                       const unsigned char* __restrict__ active,
                                       int F) {
    act = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {   // F >= 1; links is 16-byte aligned
      const int f = k * kBlock + threadIdx.x, fc = min(f, F - 1);
      if constexpr (P == 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(links) + fc);
        const unsigned char a = __ldg(active + fc);
        const bool in = f < F;
        pair[k][0] = (in && v.x >= 0 ? (uint32_t)v.x : kNoLink) |
                     ((in && v.y >= 0 ? (uint32_t)v.y : kNoLink) << 16);
        pair[k][1] = (in && v.z >= 0 ? (uint32_t)v.z : kNoLink) |
                     ((in && v.w >= 0 ? (uint32_t)v.w : kNoLink) << 16);
        if (in && a != 0) act |= 1u << k;
      } else {   // 8-byte aligned rows of P ids
        const int2* row = reinterpret_cast<const int2*>(links) + (P / 2) * fc;
        int2 v[P / 2];
#pragma unroll
        for (int i = 0; i < P / 2; ++i) v[i] = __ldg(row + i);
        const unsigned char a = __ldg(active + fc);
        const bool in = f < F;
#pragma unroll
        for (int i = 0; i < P / 2; ++i)
          pair[k][i] = (in && v[i].x >= 0 ? (uint32_t)v[i].x : kNoLink) |
                       ((in && v[i].y >= 0 ? (uint32_t)v[i].y : kNoLink) << 16);
        if (in && a != 0) act |= 1u << k;
      }
    }
  }
  __device__ __forceinline__ uint32_t link(int k, int j) const {
    return (pair[k][j >> 1] >> (16 * (j & 1))) & kNoLink;
  }
  // whether flow k names a link
  __device__ __forceinline__ bool any(int k) const {
    if constexpr (P == 4) return (pair[k][0] & pair[k][1]) != 0xffffffffu;
    else return (pair[k][0] & pair[k][1] & pair[k][2]) != 0xffffffffu;
  }
  // min over the flow's links of share (inf for none)
  __device__ __forceinline__ float bound(int k, const float* share,
                                         float inf) const {
    float b = inf;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (link(k, j) != kNoLink) b = fminf(b, share[link(k, j)]);
    return b;
  }
};

// The link -> slot CSR of the valid slots, in ascending slot order within
// each link: sh.ptr[0..E] and sh.list[0..ptr[E]).  Ends with a barrier.
template <int P>
__device__ __forceinline__ void build_csr(const Smem<P>& sh,
                                          const int* __restrict__ links,
                                          const unsigned char* __restrict__ active,
                                          int F, int E, int n_tiles, int tile) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n_slots = P * F;
  unsigned* hist32 = reinterpret_cast<unsigned*>(sh.hist);
  for (int i = tid; i < (n_tiles * E + 1) / 2; i += kBlock) hist32[i] = 0u;
  __syncthreads();

  // per-tile counts, one atomic per valid slot on the 32-bit word that
  // holds the u16 count (integer adds: their order does not matter; no
  // count exceeds the tile, so nothing carries into the other half)
  for (int s0 = tid; s0 < n_slots; s0 += kBlock * kPrefetch) {
    int e[kPrefetch];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i)
      e[i] = slot_link<P>(links, active, s0 + i * kBlock, n_slots);
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      if (e[i] >= 0) {
        const int h = ((s0 + i * kBlock) / tile) * E + e[i];
        atomicAdd(hist32 + (h >> 1), 1u << (16 * (h & 1)));
      }
    }
  }
  __syncthreads();

  // per link: exclusive running sum over the tiles; totals into ptr[1..E]
  for (int e = tid; e < E; e += kBlock) {
    int run = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int c = sh.hist[t * E + e];
      sh.hist[t * E + e] = (unsigned short)run;
      run += c;
    }
    sh.ptr[e + 1] = run;
  }
  __syncthreads();

  // inclusive scan of the totals in place over ptr[1..E]: each thread sums
  // one contiguous chunk, the chunk sums are scanned by warp shuffles
  {
    int* wsum = reinterpret_cast<int*>(sh.red);
    const int chunk = (E + kBlock - 1) / kBlock;
    const int lo = min(E, tid * chunk), hi = min(E, lo + chunk);
    int sum = 0;
    for (int e = lo; e < hi; ++e) sum += sh.ptr[e + 1];
    const int incl = warp_inclusive_sum(sum);
    if (lane == kWarp - 1) wsum[warp] = incl;
    __syncthreads();
    const int w = wsum[lane];
    const int wexcl = __shfl_sync(kFull, warp_inclusive_sum(w) - w, warp);
    int run = wexcl + incl - sum;
    for (int e = lo; e < hi; ++e) {
      run += sh.ptr[e + 1];
      sh.ptr[e + 1] = run;
    }
    if (tid == 0) sh.ptr[0] = 0;
  }
  __syncthreads();

  // stable fill, one warp per tile, 32 slots a step, so slots land in
  // ascending slot order.  Each lane first writes its lane id into the
  // next free entry of its link's list (this tile's, so no other warp
  // writes there) and reads it back: when every lane reads its own id, no
  // two lanes share a link and each takes that entry; otherwise the lanes
  // of one link rank themselves by lane order (warp_peers).
  if (warp < n_tiles) {
    const int key_bits = 32 - __clz(E);   // keys e + 1 lie in [0, E]
    const unsigned lt = (1u << lane) - 1u;
    unsigned short* cursor = sh.hist + warp * E;
    const int end = min(n_slots, (warp + 1) * tile);
    for (int base = warp * tile; base < end; base += kWarp * kPrefetch) {
      int e[kPrefetch];
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i)
        e[i] = slot_link<P>(links, active, base + i * kWarp + lane, end);
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) {
        if (base + i * kWarp >= end) break;
        int start = 0, pos = 0;
        if (e[i] >= 0) {
          start = cursor[e[i]];
          pos = sh.ptr[e[i]] + start;
          sh.list[pos] = (unsigned short)lane;
        }
        __syncwarp();
        const bool shared = e[i] >= 0 && sh.list[pos] != lane;
        int rank = 0, count = 1;
        if (__any_sync(kFull, shared)) {
          const unsigned peers = warp_peers(e[i] + 1, key_bits);
          rank = __popc(peers & lt);
          count = __popc(peers);
        }
        if (e[i] >= 0) {
          sh.list[pos + rank] =
              (unsigned short)slot_flow<P>(base + i * kWarp + lane);
          if (rank == 0) cursor[e[i]] = (unsigned short)(start + count);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// The start of round r >= 1 (r == n_rounds: the tail).  On each link that
// a flow frozen in round r-1 crosses (touched): the unfrozen count drops
// by those flows (counted on the walk), cap_rem -= the used capacity, their
// allocations added in slot order, clamped at 0; share = cap_rem /
// unfrozen count (inf for none).  No other link's share changes, except
// that the first update (all) clamps every link: cap_rem starts as the
// unclamped bandwidth, and max(x - 0, 0) is idempotent after that.  Warp w
// takes links 32w + lane, 32w + 1024 + lane, ...: a lane walks its own
// touched list; one longer than kWarpWalkMin is walked by the whole warp,
// 32 slots a step, adding the newly frozen flows' allocations in slot
// order from registers (the others add +0.0 in the plain version, which
// changes no sum: a step with few of them adds those alone, one with many
// adds all 32).  The caller clears touched after the barrier.
template <int P>
__device__ __forceinline__ void update_links(const Smem<P>& sh, int E, bool all,
                                             float inf) {
  const int lane = threadIdx.x % kWarp;
  for (int e0 = threadIdx.x - lane; e0 < E; e0 += kBlock) {
    const int e = e0 + lane;
    const bool t = e < E && sh.touched[e] != 0;
    const int lo = t ? sh.ptr[e] : 0, hi = t ? sh.ptr[e + 1] : 0;
    const bool wide = hi - lo > kWarpWalkMin;
    float used = 0.0f;
    int froze = 0;
    if (!wide) {
#pragma unroll 4
      for (int s = lo; s < hi; ++s) {
        const int f = sh.list[s];
        if (sh.newly[f]) {
          used = __fadd_rn(used, sh.alloc[f]);
          ++froze;
        }
      }
    }
    for (unsigned w = __ballot_sync(kFull, wide); w; w &= w - 1u) {
      const int src = __ffs(w) - 1;
      const int l0 = __shfl_sync(kFull, lo, src);
      const int l1 = __shfl_sync(kFull, hi, src);
      float sum = 0.0f;
      int n = 0;
      for (int b = l0; b < l1; b += kWarp) {
        float v = 0.0f;
        bool adds = false;
        if (b + lane < l1) {
          const int f = sh.list[b + lane];
          adds = sh.newly[f] != 0;
          if (adds) v = sh.alloc[f];
        }
        unsigned m = __ballot_sync(kFull, adds);
        n += __popc(m);
        if (__popc(m) > kWarp / 4) {
          sum = add_in_lane_order(sum, v);
        } else {
          for (; m; m &= m - 1u)
            sum = __fadd_rn(sum, __shfl_sync(kFull, v, __ffs(m) - 1));
        }
      }
      if (lane == src) {
        used = sum;
        froze = n;
      }
    }
    if (t || (all && e < E)) {
      const float c = fmaxf(__fsub_rn(sh.cap_rem[e], used), 0.0f);
      const int n = sh.cnt[e] - froze;
      sh.cnt[e] = n;
      sh.cap_rem[e] = c;
      sh.share[e] = n > 0 ? __fdiv_rn(c, fmaxf((float)n, 1.0f)) : inf;
    }
  }
}

// load[e] = the sum of the rates (held in alloc) over link e's list, in
// slot order.  A list longer than kWarpWalkMin is walked by the whole
// warp instead of its lane: the lanes load 32 slots, then every lane adds
// the 32 values in slot order from registers (the lanes past the end add
// +0.0, which changes no sum), so the sum rounds exactly as one thread's
// walk.
template <int P>
__device__ __forceinline__ void load_pass(const Smem<P>& sh, int E,
                                          float* __restrict__ load) {
  const int lane = threadIdx.x % kWarp;
  for (int e0 = threadIdx.x - lane; e0 < E; e0 += kBlock) {
    const int e = e0 + lane;
    const int lo = e < E ? sh.ptr[e] : 0, hi = e < E ? sh.ptr[e + 1] : 0;
    const bool wide = hi - lo > kWarpWalkMin;
    float sum = 0.0f;
    if (!wide) {
#pragma unroll 4
      for (int s = lo; s < hi; ++s) sum = __fadd_rn(sum, sh.alloc[sh.list[s]]);
    }
    for (unsigned w = __ballot_sync(kFull, wide); w; w &= w - 1u) {
      const int src = __ffs(w) - 1;
      const int l0 = __shfl_sync(kFull, lo, src);
      const int l1 = __shfl_sync(kFull, hi, src);
      float ws = 0.0f;
      for (int b = l0; b < l1; b += kWarp) {
        const float v = b + lane < l1 ? sh.alloc[sh.list[b + lane]] : 0.0f;
        ws = add_in_lane_order(ws, v);
      }
      if (lane == src) sum = ws;
    }
    if (e < E) load[e] = sum;
  }
}

// One block of 1024 threads: the CSR build, every round, the tail, the
// Mathis min and the load, with the state in dynamic shared memory.
template <int K, int P>
__global__ void __launch_bounds__(kBlock, 1)
waterfill_smem(const int* __restrict__ links,
               const unsigned char* __restrict__ active,
               const float* __restrict__ cap, const float* __restrict__ tcp,
               float* __restrict__ rates, float* __restrict__ load, int F,
               int E, int n_tiles, int tile, int n_rounds, float local_rate,
               float inf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<P> sh(smem, F, E);
  const int tid = threadIdx.x;
  if (F == 0) {   // no flow: nothing on any link
    for (int e = tid; e < E; e += kBlock) load[e] = 0.0f;
    return;
  }
  build_csr(sh, links, active, F, E, n_tiles, tile);

  FlowLinks<K, P> fl;
  fl.load(links, active, F);
  uint32_t live = 0;            // bit k: flow k*kBlock + tid active, unfrozen
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int f = k * kBlock + tid;
    if (f >= F) continue;
    const bool act = (fl.act >> k) & 1u;
    const bool any = fl.any(k);
    sh.alloc[f] = act ? local_rate : 0.0f;   // no-link flows keep it, frozen
    sh.newly[f] = 0;
    if (act && any) live |= 1u << k;
  }
  // every listed flow is active and has a link, so it starts unfrozen
  for (int e = tid; e < E; e += kBlock) {
    const int n = sh.ptr[e + 1] - sh.ptr[e];
    const float c = cap[e];
    sh.cnt[e] = n;
    sh.cap_rem[e] = c;
    sh.share[e] = n > 0 ? __fdiv_rn(c, fmaxf((float)n, 1.0f)) : inf;
    sh.touched[e] = 0;
  }
  __syncthreads();

  uint32_t was_newly = 0;
  for (int r = 0; r < n_rounds; ++r) {
    if (r > 0) {
      update_links(sh, E, r == 1, inf);
      __syncthreads();
    }
    for (int e = tid; e < E; e += kBlock) sh.touched[e] = 0;
    // each live flow's bound, kept for the freeze in its alloc slot
    // (which only a frozen flow's allocation needs)
    float lmin = inf;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!((live >> k) & 1u)) continue;
      const float b = fl.bound(k, sh.share, inf);
      sh.alloc[k * kBlock + tid] = b;
      lmin = fminf(lmin, b);
    }
    const float m = block_min_1(lmin, sh.red);
    const float thr = __fadd_rn(__fmul_rn(m, 1.000001f), 1e-6f);
    uint32_t now_newly = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int f = k * kBlock + tid;
      if ((live >> k) & 1u) {
        const float b = sh.alloc[f];
        if (b <= thr) {               // freezes: touches its links
          sh.alloc[f] = fminf(b, local_rate);
          now_newly |= 1u << k;
#pragma unroll
          for (int j = 0; j < P; ++j)
            if (fl.link(k, j) != kNoLink) sh.touched[fl.link(k, j)] = 1;
        }
      }
      if (((now_newly ^ was_newly) >> k) & 1u) sh.newly[f] = (now_newly >> k) & 1u;
    }
    live &= ~now_newly;
    was_newly = now_newly;
    __syncthreads();
  }

  // leftover tail: flows still unfrozen take their current fair share
  if (n_rounds > 0) {
    update_links(sh, E, n_rounds == 1, inf);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int f = k * kBlock + tid;
    const float t = __ldg(tcp + min(f, F - 1));   // unconditional: loads overlap
    if (f >= F) continue;
    const bool act = (fl.act >> k) & 1u;
    float a = sh.alloc[f];
    if ((live >> k) & 1u) a = fminf(fl.bound(k, sh.share, inf), local_rate);
    const float fair = act ? a : 0.0f;
    const float rate = __fmul_rn(fminf(fair, t), act ? 1.0f : 0.0f);
    rates[f] = rate;
    sh.alloc[f] = rate;
  }
  __syncthreads();
  load_pass(sh, E, load);
}

template <int K, int P>
int launch_smem(const int* links, const unsigned char* active,
                const float* cap, const float* tcp, float* rates, float* load,
                int F, int E, int n_rounds, float local_rate, float inf,
                cudaStream_t stream) {
  auto kernel = waterfill_smem<K, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  // per-tile u16 histograms in the 13E + 5F bytes of cnt..touched (zeroed
  // as 32-bit words); at least 6 tiles for F >= 1, so a tile holds at most
  // F + 31 slots and every count fits 16 bits
  const int n_slots = P * F;
  int n_tiles = E > 0 ? (13 * E + 5 * F - 2) / (2 * E) : 1;
  if (n_tiles > kWarp) n_tiles = kWarp;
  const int tile = ((n_slots + n_tiles - 1) / n_tiles + kWarp - 1) / kWarp * kWarp;
  kernel<<<1, kBlock, smem_bytes(F, E, P), stream>>>(
      links, active, cap, tcp, rates, load, F, E, n_tiles, tile, n_rounds,
      local_rate, inf);
  return (int)cudaGetLastError();
}

// The one-launch variant at K flows a thread, K the least built that
// holds F.
template <int P>
int launch_smem_for(const int* links, const unsigned char* active,
                    const float* cap, const float* tcp, float* rates,
                    float* load, int F, int E, int n_rounds, float local_rate,
                    float inf, cudaStream_t stream) {
  const int per = (F + kBlock - 1) / kBlock;   // flows per thread
#define SEG_WATERFILL_ARGS \
  links, active, cap, tcp, rates, load, F, E, n_rounds, local_rate, inf, \
      stream
  if (per <= 1) return launch_smem<1, P>(SEG_WATERFILL_ARGS);
  if (per <= 2) return launch_smem<2, P>(SEG_WATERFILL_ARGS);
  if (per <= 4) return launch_smem<4, P>(SEG_WATERFILL_ARGS);
  if (per <= 8) return launch_smem<8, P>(SEG_WATERFILL_ARGS);
  if (per <= 12) return launch_smem<12, P>(SEG_WATERFILL_ARGS);
  return launch_smem<kMaxFlowsPerThread, P>(SEG_WATERFILL_ARGS);
#undef SEG_WATERFILL_ARGS
}

template <int P>
int launch_global(const int* links, const unsigned char* active,
                  const float* cap, const float* tcp, float* rates,
                  float* load, int* ws_i, float* ws_f, int F, int E,
                  int n_tiles, int tile, int n_rounds, float local_rate,
                  float inf, cudaStream_t stream) {
  const int n_slots = P * F;
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
  csr_count<P><<<n_tiles, 256, 0, stream>>>(links, active, n_slots, tile, E, hist);
  csr_scan<<<1, kBlock, 0, stream>>>(hist, n_tiles, E, ptr);
  csr_fill<P><<<n_tiles, kWarp, 0, stream>>>(links, active, n_slots, tile, E, hist, ptr,
                                             list);
  waterfill<P><<<1, kBlock, 0, stream>>>(links, active, cap, tcp, ptr, list, rates, load,
                                         cap_rem, share, alloc, bound, frozen, newly,
                                         F, E, n_rounds, local_rate, inf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch, no workspace, over paths of P = 4 or 6 link ids; needs
// smem_bytes(F, E, P) = (2P + 5)F + 17E + 132 <= 232448 and F <= 16383,
// and links 16-byte aligned.
int seg_waterfill_smem_launch(const int* links, const unsigned char* active,
                              const float* cap, const float* tcp,
                              float* rates, float* load, int F, int E, int P,
                              int n_rounds, float local_rate, float inf,
                              void* stream_ptr) {
  if (F < 0 || E < 0 || F > kSmemMaxFlows || (P != 4 && P != 6) ||
      smem_bytes(F, E, P) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (P == 4)
    return launch_smem_for<4>(links, active, cap, tcp, rates, load, F, E,
                              n_rounds, local_rate, inf, stream);
  return launch_smem_for<6>(links, active, cap, tcp, rates, load, F, E,
                            n_rounds, local_rate, inf, stream);
}

// Workspace sizes the caller allocates (element counts):
//   ws_i: n_tiles*E + (E+1) + PF + F + F   ints
//   ws_f: E + E + F + F                    floats
int seg_waterfill_launch(const int* links, const unsigned char* active,
                         const float* cap, const float* tcp, float* rates,
                         float* load, int* ws_i, float* ws_f, int F, int E,
                         int P, int n_tiles, int tile, int n_rounds,
                         float local_rate, float inf, void* stream_ptr) {
  if (P != 4 && P != 6) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (P == 4)
    return launch_global<4>(links, active, cap, tcp, rates, load, ws_i, ws_f,
                            F, E, n_tiles, tile, n_rounds, local_rate, inf,
                            stream);
  return launch_global<6>(links, active, cap, tcp, rates, load, ws_i, ws_f, F,
                          E, n_tiles, tile, n_rounds, local_rate, inf, stream);
}

}  // extern "C"
