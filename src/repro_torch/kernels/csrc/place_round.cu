// place_round: the admit round's candidate loop of the batched placement
// round (engine._place_batched) in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The JAX package runs this loop as the
// lax.scan `admit` of src/repro/core/engine.py, _place_batched, which XLA
// compiles into one device loop.  The port ran it in eager PyTorch, about
// a hundred launches of a few hundred threads a candidate, so the host's
// dispatch, not the card, set the round's time.  The plain version is
// place_round_ref in src/repro_torch/kernels/place_round/place_round.py.
//
// What it computes: for candidates k = 0 .. n_valid-1 in order, the
// feasible hosts, the eleven placement feature columns (F_* order) and
// their weighted sum, the argmin over the feasible hosts (-1 where none),
// and the admit: the host's `used` and slot count, the rotating pointer,
// and the co-location and same-leaf counts of the later same-job
// candidates.  Outputs: chosen[K] (-1 past n_valid), used, ncont, rr, and
// for tests each candidate's score row where `scores` is not null.
//
// What bounds it on this card: latency.  The K argmins depend on one
// another (each sees the admits before it), and each is an H-element row
// and the comm column's multiply-adds over the hosts that hold the
// candidate's job (a few; the other rows add exact zeros): tens of KB read
// in a round at K = 64, H = 100, nothing for the card's bandwidth or FLOP
// rate.
//
// What the design does about that:
// * One thread block does the whole round, the candidates in a loop inside
//   the kernel; hosts are spread over the threads (h = tid, tid + nt, ...).
// * The live state (used, slot counts, pointer, each candidate's job,
//   type and same-job total) sits in shared memory, and the [K, H] count
//   rows too where they fit (rows_in_smem); else the rows stay in device
//   memory, which the kernel then updates in place.
// * Two barriers a candidate: one after the admit, one after the warps'
//   partial argmins (shuffles within a warp; every thread then reduces the
//   warps' partials itself, so no third barrier hands the choice round);
//   a third where the candidate's job is placed somewhere, after warp 0
//   lists the rows the comm column adds.
// * The same-job candidates are chained once (next[k]), so an admit walks
//   only the rows it changes; the rows' totals are kept by +1 per admit
//   (integer-valued floats, exact) instead of a block sum a candidate.
//
// Exactness: decisions, used, ncont and rr equal the plain loop's on the
// card bit for bit.  Every elementwise op rounds on its own as PyTorch's
// eager ops do (__fadd_rn / __fmul_rn / __fdiv_rn, nothing contracted to
// an FMA, no fast math); clamp, maximum, where, remainder and the argmin's
// order (NaN first, lowest index on a tie) are PyTorch's.  The comm column
// (cnt[:, None] * comm_cost).sum(0) adds its products in the order of
// ATen's reduce kernel (ATen/native/cuda/Reduce.cuh) for a float32 [H, H]
// sum over dim 0, which the wrapper works out from H and the card
// (place_round.comm_split) and passes as Y and C:
// * the source rows are dealt to Y x C reducing threads, thread
//   t = y + c Y taking rows t, t + Y C, t + 2 Y C, ...; each thread adds
//   its rows in four interleaved chains (its m-th row into chain m mod 4)
//   and combines them ((c0 + c1) + c2) + c3;
// * the Y threads of a block are combined by ATen's shared-memory tree
//   (block_y_reduce: p[y] += p[y + o] for o = Y/2, ..., 1);
// * where C > 1 the blocks' results b[c] are folded as ATen's last block
//   does: v[y] = b[y] + b[y + Y] + ... in order, then the same tree.
// Y = C = 1 (every H below 128 on this card) is one thread a column.
// A product whose count is 0 is an exact zero, and adding an exact zero
// changes no sum, so each column adds only the rows whose count is not 0,
// each in its place in that order: the block lists them once a candidate
// (nz, in the order perm gives every row).  A column with a non-finite
// cost, where 0 * inf would make ATen's sum NaN, adds every row.
#include <cuda_runtime.h>

namespace {

constexpr int kF = 11;            // NUM_ROW_FEATURES
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxY = 16;         // ATen's block height for float sums
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* cap;        // [H, 3]
  const float* speed;      // [H, 3]
  const int* leaf;         // [H]
  const float* link_util;  // [H] (host h's access link is link h)
  const float* comm_cost;  // [H, H]
  const float* used_in;    // [H, 3]
  const int* ncont_in;     // [H]
  const int* rr_in;        // []
  float* counts;           // [K, H] same-job containers per host
  float* leafpeers;        // [K, H] same-job peers on the host's leaf
  const long long* cand;   // [K]
  const int* job;          // [C]
  const int* ctype;        // [C]
  const float* req_k;      // [K, 3]
  const float* weights;    // [NUM_POLICY_WEIGHTS]
  float* used_out;         // [H, 3]
  int* ncont_out;          // [H]
  int* rr_out;             // []
  long long* chosen;       // [K]
  float* scores;           // [K, H] each row the argmin took, or null
  int H, K, n_valid, max_per_host, row0, rr_track, rows_in_smem;
  int Y, C;                // the comm sum's reducing threads (see above)
};

// torch.clamp(v, min=lo)
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// torch.maximum
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// Whether (a, ia) comes before (b, ib) in torch.argmin's order: NaN first,
// then the smaller value, then the lower index; an index of -1 is empty.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (ib < 0) return true;
  if (ia < 0) return false;
  if (a != a) return b != b ? ia < ib : true;
  return a == b ? ia < ib : a < b;
}

// ATen's block_y_reduce over p[0 .. Y-1], Y a power of two; p is spent.
__device__ __forceinline__ float y_tree(float* p, int Y) {
  for (int o = Y >> 1; o > 0; o >>= 1)
    for (int y = 0; y < o; ++y) p[y] = __fadd_rn(p[y], p[y + o]);
  return p[0];
}

// Block c's result (the tree over its threads' partials p) folded into the
// last block's partial v[c mod Y]; p is zeroed for the next block.
__device__ __forceinline__ void fold_block(float* p, float* v, int Y, int c) {
  const float b = y_tree(p, Y);
  for (int y = 0; y < Y; ++y) p[y] = 0.0f;
  v[c % Y] = __fadd_rn(v[c % Y], b);
}

// One column's sum over the rows rows[0 .. n-1] (in perm's order) of
// cnt[s] * cost[s H], in ATen's order (see the note at the top).
__device__ float aten_column_sum(const int* rows, int n, const float* cnt,
                                 const float* cost, int H, int Y, int step) {
  float p[kMaxY], v[kMaxY];
  for (int y = 0; y < Y; ++y) { p[y] = 0.0f; v[y] = 0.0f; }
  float chain = 0.0f, part = 0.0f;
  int ct = -1, ci = -1;              // the current thread and chain
  for (int e = 0; e < n; ++e) {
    const int s = rows[e];
    const int t = s % step, i = (s / step) & 3;
    if (t != ct || i != ci) {
      if (ct >= 0) part = __fadd_rn(part, chain);   // ((c0 + c1) + c2) + c3
      if (t != ct && ct >= 0) {
        p[ct % Y] = part;
        part = 0.0f;
        if (t / Y != ct / Y) fold_block(p, v, Y, ct / Y);
      }
      chain = 0.0f;
      ct = t;
      ci = i;
    }
    chain = __fadd_rn(chain, __fmul_rn(cnt[s], cost[(long long)s * H]));
  }
  if (ct >= 0) {
    p[ct % Y] = __fadd_rn(part, chain);
    fold_block(p, v, Y, ct / Y);
  }
  return y_tree(v, Y);
}

// Shared-memory words ahead of the count rows.
__host__ __device__ inline int head_words(int H, int K) {
  return 7 * H + 4 * K + 3 * kMaxWarps + 4;
}

__global__ void __launch_bounds__(kMaxThreads) place_round_kernel(const Args a) {
  extern __shared__ float smem[];
  const int H = a.H, K = a.K, nv = a.n_valid;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  float* used = smem;                            // [H * 3]
  int* ncont = reinterpret_cast<int*>(used + 3 * H);   // [H]
  int* leaf = ncont + H;                         // [H]
  float* total = reinterpret_cast<float*>(leaf + H);   // [K]
  int* jobk = reinterpret_cast<int*>(total + K); // [K]
  int* ctk = jobk + K;                           // [K]
  int* next = ctk + K;                           // [K]
  float* red_v = reinterpret_cast<float*>(next + K);   // [kMaxWarps]
  int* red_i = reinterpret_cast<int*>(red_v + kMaxWarps);
  int* red_any = red_i + kMaxWarps;
  int* rr_s = red_any + kMaxWarps;               // [4]: rr, the nz count
  int* perm = rr_s + 4;                          // [H] rows in ATen's order
  int* nz = perm + H;                            // [H] those with a count
  float* rows = smem + head_words(H, K);         // [2 K H] if rows_in_smem
  float* cnt_rows = a.rows_in_smem ? rows : a.counts;
  float* lp_rows = a.rows_in_smem ? rows + K * H : a.leafpeers;

  for (int i = tid; i < 3 * H; i += nt) used[i] = a.used_in[i];
  for (int h = tid; h < H; h += nt) {
    ncont[h] = a.ncont_in[h];
    leaf[h] = a.leaf[h];
  }
  for (int k = tid; k < K; k += nt) {
    const long long c = a.cand[k];
    jobk[k] = a.job[c];
    ctk[k] = a.ctype[c];
    if (k >= nv) a.chosen[k] = -1;
  }
  if (a.rows_in_smem) {
    for (int i = tid; i < nv * H; i += nt) {
      rows[i] = a.counts[i];
      rows[K * H + i] = a.leafpeers[i];
    }
  }
  if (tid == 0) rr_s[0] = *a.rr_in;
  // perm: the rows by reducing thread t = s mod step, then by chain
  // i = (s / step) mod 4, then in order (the order each column adds them)
  const int step = a.Y * a.C;
  for (int s = tid; s < H; s += nt) {
    const int t = s % step, q = s / step, i = q & 3;
    const int A = H / step, B = H % step;
    const int Q = A + (t < B ? 1 : 0);          // rows of thread t
    int off = t * A + min(t, B);
    for (int j = 0; j < i; ++j) off += (Q - j + 3) >> 2;
    perm[off + (q >> 2)] = s;
  }
  __syncthreads();
  for (int k = tid; k < nv; k += nt) {   // the next same-job candidate
    int nx = -1;
    for (int k2 = k + 1; k2 < nv; ++k2) {
      if (jobk[k2] == jobk[k]) { nx = k2; break; }
    }
    next[k] = nx;
  }
  for (int k = warp; k < nv; k += nw) {  // integer-valued: exact in any order
    float s = 0.0f;
    for (int h = lane; h < H; h += 32) s += cnt_rows[k * H + h];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) total[k] = s;
  }

  float w[kF];
#pragma unroll
  for (int i = 0; i < kF; ++i) w[i] = a.weights[a.row0 + i];
  const bool track = a.weights[a.rr_track] > 0.0f;
  const float big = static_cast<float>(1e18);    // scheduling.BIG
  const float tiny = static_cast<float>(1e-6);   // the capacity clamp
  unsigned dense = 0;      // bit j: column tid + j nt has a non-finite cost
  bool dense_known = false;

  for (int k = 0; k < nv; ++k) {
    __syncthreads();   // the admit before this one, and the prologue
    const float tot = total[k];
    const bool has = tot > 0.0f;                 // the same in every thread
    if (has) {
      if (!dense_known) {
        for (int h = tid, j = 0; h < H; h += nt, ++j) {
          bool fin = true;
          for (int s = 0; s < H; ++s)
            fin = fin && isfinite(a.comm_cost[(long long)s * H + h]);
          if (!fin) dense |= 1u << j;
        }
        dense_known = true;
      }
      if (warp == 0) {   // nz: the rows with a count, in perm's order
        const float* crow = cnt_rows + k * H;
        int n = 0;
        for (int r0 = 0; r0 < H; r0 += 32) {
          const int r = r0 + lane;
          const int s = r < H ? perm[r] : 0;
          const bool on = r < H && crow[s] != 0.0f;
          const unsigned m = __ballot_sync(kFull, on);
          if (on) nz[n + __popc(m & ((1u << lane) - 1u))] = s;
          n += __popc(m);
        }
        if (lane == 0) rr_s[1] = n;
      }
      __syncthreads();
    }
    const float tden = clamp_min(tot, 1.0f);
    const int ct = ctk[k];
    const float r0 = a.req_k[3 * k], r1 = a.req_k[3 * k + 1],
                r2 = a.req_k[3 * k + 2];
    const long long rr = rr_s[0];
    const float* crow = cnt_rows + k * H;
    const float* lrow = lp_rows + k * H;
    float bv = 0.0f;
    int bi = -1, anyf = 0;
    for (int h = tid, j = 0; h < H; h += nt, ++j) {
      const float u0 = used[3 * h], u1 = used[3 * h + 1], u2 = used[3 * h + 2];
      const float c0 = a.cap[3 * h], c1 = a.cap[3 * h + 1],
                  c2 = a.cap[3 * h + 2];
      const bool feas = __fadd_rn(u0, r0) <= c0 && __fadd_rn(u1, r1) <= c1
                        && __fadd_rn(u2, r2) <= c2 && ncont[h] < a.max_per_host;
      long long rem = (h - rr - 1) % H;          // torch.remainder
      if (rem < 0) rem += H;
      const float k0 = clamp_min(c0, tiny), k1 = clamp_min(c1, tiny),
                  k2 = clamp_min(c2, tiny);
      const float f0 = __fdiv_rn(__fsub_rn(c0, u0), k0);
      const float f1 = __fdiv_rn(__fsub_rn(c1, u1), k1);
      const float f2 = __fdiv_rn(__fsub_rn(c2, u2), k2);
      const float worst = -__fadd_rn(__fadd_rn(f0, f1), f2);
      float comm = 0.0f;
      if (has) {
        const bool all = (dense >> j) & 1u;
        comm = __fdiv_rn(aten_column_sum(all ? perm : nz, all ? H : rr_s[1],
                                         crow, a.comm_cost + h, H, a.Y, step),
                         tden);
      }
      const float cnt = crow[h];
      const float col[kF] = {
          static_cast<float>(rem),                         // recency
          -a.speed[3 * h + ct],                            // neg_speed
          worst,                                           // worst_fit
          has ? -cnt : 0.0f,                               // coloc
          comm,                                            // comm
          has ? 0.0f : worst,                              // fallback_worst
          maximum(maximum(__fdiv_rn(u0, k0), __fdiv_rn(u1, k1)),
                  __fdiv_rn(u2, k2)),                      // host_util
          f0,                                              // free_cpu
          f1,                                              // free_mem
          a.link_util[h],                                  // uplink_util
          has ? __fdiv_rn(__fsub_rn(tot, lrow[h]), tden) : 0.0f};  // cross_leaf
      float score = __fmul_rn(col[0], w[0]);
#pragma unroll
      for (int i = 1; i < kF; ++i)
        score = __fadd_rn(score, __fmul_rn(col[i], w[i]));
      if (a.scores != nullptr) a.scores[k * H + h] = score;
      const float v = feas ? score : big;
      if (before(v, h, bv, bi)) { bv = v; bi = h; }
      anyf |= feas;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(kFull, bv, o);
      const int oi = __shfl_down_sync(kFull, bi, o);
      if (before(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    anyf = __any_sync(kFull, anyf);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
      red_any[warp] = anyf;
    }
    __syncthreads();
    bv = red_v[0];
    bi = red_i[0];
    anyf = red_any[0];
    for (int i = 1; i < nw; ++i) {
      if (before(red_v[i], red_i[i], bv, bi)) { bv = red_v[i]; bi = red_i[i]; }
      anyf |= red_any[i];
    }
    const int pick = anyf ? bi : -1;
    if (pick >= 0) {   // the admit
      const int lf = leaf[pick];
      for (int k2 = next[k]; k2 >= 0; k2 = next[k2]) {
        float* cr = cnt_rows + k2 * H;
        float* lr = lp_rows + k2 * H;
        for (int h = tid; h < H; h += nt) {
          if (h == pick) cr[h] += 1.0f;
          if (leaf[h] == lf) lr[h] += 1.0f;
        }
        if (tid == 0) total[k2] += 1.0f;
      }
      if (tid == 0) {
        used[3 * pick] = __fadd_rn(used[3 * pick], r0);
        used[3 * pick + 1] = __fadd_rn(used[3 * pick + 1], r1);
        used[3 * pick + 2] = __fadd_rn(used[3 * pick + 2], r2);
        ncont[pick] += 1;
        if (track) rr_s[0] = pick;
      }
    }
    if (tid == 0) a.chosen[k] = pick;
  }
  __syncthreads();
  for (int i = tid; i < 3 * H; i += nt) a.used_out[i] = used[i];
  for (int h = tid; h < H; h += nt) a.ncont_out[h] = ncont[h];
  if (tid == 0) *a.rr_out = rr_s[0];
}

// Dynamic shared memory of a launch: the head, plus the 2 K H count rows
// where rows_in_smem (place_round.smem_bytes).
long long smem_bytes(int H, int K, int rows_in_smem) {
  return 4LL * (head_words(H, K) + (rows_in_smem ? 2LL * K * H : 0));
}

}  // namespace

extern "C" int place_round_launch(
    const float* cap, const float* speed, const int* leaf,
    const float* link_util, const float* comm_cost, const float* used_in,
    const int* ncont_in, const int* rr_in, float* counts, float* leafpeers,
    const long long* cand, const int* job, const int* ctype,
    const float* req_k, const float* weights, float* used_out,
    int* ncont_out, int* rr_out, long long* chosen, float* scores, int H,
    int K, int n_valid, int max_per_host, int row0, int rr_track,
    int threads, int rows_in_smem, int Y, int C, void* stream_ptr) {
  if (H <= 0 || K <= 0 || n_valid < 0 || n_valid > K || threads < 32
      || threads > kMaxThreads || threads % 32 != 0
      || (H + threads - 1) / threads > 32 || Y < 1 || Y > kMaxY
      || (Y & (Y - 1)) != 0 || C < 1)
    return (int)cudaErrorInvalidValue;
  const long long bytes = smem_bytes(H, K, rows_in_smem);
  if (bytes > kDefaultSmem) {   // the opt-in is the current device's
    const cudaError_t err = cudaFuncSetAttribute(
        place_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const Args a{cap, speed, leaf, link_util, comm_cost, used_in, ncont_in,
               rr_in, counts, leafpeers, cand, job, ctype, req_k, weights,
               used_out, ncont_out, rr_out, chosen, scores, H, K, n_valid,
               max_per_host, row0, rr_track, rows_in_smem, Y, C};
  place_round_kernel<<<1, threads, (size_t)bytes,
                       static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
