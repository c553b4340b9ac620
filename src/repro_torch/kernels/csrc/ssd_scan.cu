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
// f32, as in the TPU kernel.  A ragged last chunk (S % Q != 0) is the
// zero-padded chunk without its padding.  The plain version is
// ssd_scan_ref in src/repro_torch/kernels/ssd_scan/ssd_scan.py.
//
// What bounds it on this card: bytes, once the products run on the
// tensor cores.  At the serving slice's shape (B = 4, S = 2048, H = 64,
// P = N = 64, Q = 256) the function needs about 1.73e10 FLOP (the causal
// half of C.B^T once per (b, chunk), since B and C have one group; per
// head the causal half of M.xs, C.h and the state update) against about
// 0.28 GB of inputs and outputs: 0.035 ms at the TF32 tensor-core peak,
// 0.083 ms of bytes.
//
// What the design does.  The TPU kernel walks the chunks in order with the
// state in VMEM; here the scan is cut into passes that are parallel over
// chunks, as the public Mamba2 implementation cuts it (chunk cumsum,
// C.B^T, chunk state, state passing, chunk output), launched in order on
// one stream:
//   1. ssd_cum   per (b, chunk, 4 heads): cum, one warp's scan per head;
//   2. ssd_cb    per (b, chunk, 64 x 64 tile on or below the diagonal):
//                G = C.B^T, once for all heads, into a [B,Cn,Qp,Qp]
//                scratch (Qp = Q rounded up to 64; 8.4 MB at the slice's
//                shape, which L2 holds);
//   3. ssd_state per (b, chunk, h, 64 columns of N): the chunk's state
//                update xs^T (w * B), w = exp(cum_last - cum) dt, into a
//                [B,Cn,H,P,N] scratch;
//   4. ssd_pass  per (b, h, 256 state elements): the chunks in order,
//                h_prev[c] = h (over the scratch of pass 3, in place),
//                h <- exp(cum_last) h + upd[c]; writes the final state;
//   5. ssd_out   per (b, chunk, h, pair of 64-row q tiles), one
//                warpgroup per q tile: y = (exp(cum_q) C_q) . h_prev^T +
//                (G o L o dt) . xs; the B operands (h_prev, xs^T) are
//                converted once for the pair, and an s tile reaches only
//                the q tiles on or below it.
// That is 2 B Cn H blocks of 256 threads in the last pass (4096 at the
// slice's shape).  Passes 2, 3 and 5 are one loop over k chunks of
// 64: a [64 x 64] f32 accumulator per warpgroup in registers += A (64 x
// 64) . B (64 x 64)^T by wgmma m64n64k16 on operand tiles in shared
// memory, each K-major or MN-major as its source rows lie (xs and B enter
// as their [s][p] and [s][n] rows: the 16-bit wgmma transposes them).
// The contract is f32 (rtol/atol 1e-4) and one bf16 or TF32 pass misses
// it (TF32 tenfold), so every operand is split, a = a_hi + a_lo with a_hi
// = bf16(a) and a_lo = bf16(a - a_hi), and each product is three wgmmas
// on the bf16 tensor cores, a_lo b_hi + a_hi b_lo + a_hi b_hi (3xbf16:
// error near 2^-16 of the product, 0.2-0.3 of the limit at the slice's
// shapes on the card).  Three TF32 passes (3xTF32) are ten times as
// precise but were slower on the card: TF32 has no transposed operand and
// half the depth per instruction.  The split needs the operand
// in registers, so the next chunk's raw f32 tiles come in by cp.async
// while this chunk multiplies, and the block turns each into its hi and
// lo tiles in the 128-byte swizzle wgmma reads, applying the elementwise
// factors (the decay mask of M, w, exp(cum_q)) on the way.  Sums have a
// fixed order and no atomics: a second run is bit-identical.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;           // rows of an output tile (q, s, p or n)
constexpr int kK = 64;           // depth of a k chunk: a 128-byte bf16 row
constexpr int kThreads = 128;    // one warpgroup
constexpr int kMaxChunk = 256;   // Q: at most four 64-row q tiles
// q tiles (one warpgroup each) per block of the output pass: two blocks
// of two fit an SM (blocks of one or of four were slower on the card)
constexpr int kOutWarpgroups = 2;
constexpr int kTileElems = kT * kK;           // one [64][64] tile
constexpr size_t kOpBytes = kTileElems * 2;   // bf16 operand tile: 8 KB
constexpr size_t kRawBytes = kTileElems * 4;  // f32 raw tile: 16 KB
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (unused within one 64-wide tile), stride byte offset of 8
// rows (1024 bytes), layout type 1 (B128)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// element (row, k) of a [64][64] bf16 tile in the 128-byte swizzle: the
// 16-byte group k / 8 of row r is stored at group (k / 8) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int k) {
  return r * kK + ((((k >> 3) ^ (r & 7)) << 3) | (k & 7));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// v = hi + lo + O(2^-17 |v|), hi = bf16(v) and lo = bf16(v - hi): four
// consecutive k of one row, half a 16-byte group of each operand tile
__device__ __forceinline__ void split_store(__nv_bfloat16* hi,
                                            __nv_bfloat16* lo, int off,
                                            float4 v) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
  const __nv_bfloat162 l0 = __floats2bfloat162_rn(v.x - __low2float(h0),
                                                  v.y - __high2float(h0));
  const __nv_bfloat162 l1 = __floats2bfloat162_rn(v.z - __low2float(h1),
                                                  v.w - __high2float(h1));
  *reinterpret_cast<uint2*>(hi + off) =
      make_uint2(bf16x2_bits(h0), bf16x2_bits(h1));
  *reinterpret_cast<uint2*>(lo + off) =
      make_uint2(bf16x2_bits(l0), bf16x2_bits(l1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row_lo, rows) of a raw [rows][cols] f32 tile (cols = 64)
// from rows of stride `stride` floats starting at src, zero past
// (valid_rows, valid_cols); valid_cols and stride are multiples of 4
__device__ __forceinline__ void fetch_tile(float* dst, const float* src,
                                           size_t stride, int row_lo,
                                           int rows, int cols, int valid_rows,
                                           int valid_cols) {
  const int groups = cols / 4;
  for (int i = row_lo * groups + threadIdx.x; i < rows * groups;
       i += blockDim.x) {
    const int r = i / groups, c = (i % groups) * 4;
    const bool ok = r < valid_rows && c < valid_cols;
    cp_async16(dst + r * cols + c, ok ? src + r * stride + c : src, ok);
  }
}

// acc += a . b^T; kTA / kTB: the operand is MN-major (else K-major)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss_bf16_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, %34, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(kTA), "n"(kTB), "r"(1));
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
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared memory of passes 2, 3 and 5, for W warpgroups: the hi and lo
// bf16 operand tiles (A: W tiles of 64 rows, one per warpgroup; B: one
// tile), the raw f32 tiles of the next chunk (A: W tiles, B: one), then
// the pass's vectors.  Every tile starts on a 1024-byte boundary, as the
// swizzle needs.
struct Smem {
  __nv_bfloat16* a_hi;
  __nv_bfloat16* a_lo;
  __nv_bfloat16* b_hi;
  __nv_bfloat16* b_lo;
  float* raw_a;
  float* raw_b;
  float* vec;
};

__host__ __device__ constexpr size_t smem_base(int W) {
  return 1024 + (2 * W + 2) * kOpBytes + (W + 1) * kRawBytes;
}

__device__ __forceinline__ Smem carve_smem(uint8_t* raw, int W) {
  uint8_t* p = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  auto op = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(p + i * kOpBytes);
  };
  float* r = reinterpret_cast<float*>(p + (2 * W + 2) * kOpBytes);
  return Smem{op(0), op(W), op(2 * W), op(2 * W + 1), r,
              r + W * kTileElems, r + (W + 1) * kTileElems};
}

// acc += the three products of one k chunk, a_lo b_hi + a_hi b_lo + a_hi
// b_hi.  Each operand tile holds 64 rows of 128 bytes: a K-major operand
// (kTA / kTB = 0) has its 64 k along a row, so a k16 step is 32 bytes; an
// MN-major one (1) has one k per row, so a k16 step is 16 rows.
template <int kTA, int kTB>
__device__ __forceinline__ void chunk_mma(float (&acc)[32], const Smem& sm,
                                          uint32_t a_off) {
  constexpr uint32_t step_a = kTA ? 16 * 128 : 32;
  constexpr uint32_t step_b = kTB ? 16 * 128 : 32;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    const uint64_t ah = desc_sw128(smem_u32(sm.a_hi) + a_off + step_a * kk);
    const uint64_t al = desc_sw128(smem_u32(sm.a_lo) + a_off + step_a * kk);
    const uint64_t bh = desc_sw128(smem_u32(sm.b_hi) + step_b * kk);
    const uint64_t bl = desc_sw128(smem_u32(sm.b_lo) + step_b * kk);
    wgmma_ss_bf16_n64<kTA, kTB>(acc, al, bh);
    wgmma_ss_bf16_n64<kTA, kTB>(acc, ah, bl);
    wgmma_ss_bf16_n64<kTA, kTB>(acc, ah, bh);
  }
  wg_commit();
  wg_wait_all();
  fence_acc(acc);
}

// Warpgroup wg's accumulator acc (64 x 64) += sum over k chunks of
// A_k[64 wg .. 64 wg + 63] (64 x 64) . B_k (64 x 64)^T, for the chunks where
// ps.active(k, wg), each product as a_lo b_hi + a_hi b_lo + a_hi b_hi on
// the bf16 tensor cores.  ps.fetch(k, raw_a, raw_b) issues chunk k's
// cp.async copies, which land while chunk k - 1 multiplies;
// ps.convert(k, raw_a, raw_b, sm) writes its hi / lo operand tiles (with
// all the block's threads); ps.majors(k) says which operands are MN-major
// (0: neither, 1: B, 3: both).
template <class Pass>
__device__ __forceinline__ void mma_loop(const Pass& ps, int nk,
                                         const Smem& sm, float (&acc)[32]) {
  const int wg = threadIdx.x / 128;
  const uint32_t a_off = wg * kOpBytes;
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  if (nk > 0) ps.fetch(0, sm.raw_a, sm.raw_b);
  cp_async_commit();
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_all();   // chunk k has landed
    __syncthreads();       // ... for every thread; the last wgmma is done
    ps.convert(k, sm.raw_a, sm.raw_b, sm);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();       // the raw tiles are free: fetch chunk k + 1
    if (k + 1 < nk) ps.fetch(k + 1, sm.raw_a, sm.raw_b);
    cp_async_commit();
    if (ps.active(k, wg)) {
      switch (ps.majors(k)) {
        case 0: chunk_mma<0, 0>(acc, sm, a_off); break;
        case 1: chunk_mma<0, 1>(acc, sm, a_off); break;
        default: chunk_mma<1, 1>(acc, sm, a_off); break;
      }
    }
  }
}

// operand rows [r_lo, r_hi) of a [rows][64] tile: (r, k) = f(r) raw[r][k].
// Four k per thread: eight threads read one 128-byte half row of raw and
// sixteen write one 128-byte operand row, so neither has bank conflicts.
template <class F>
__device__ __forceinline__ void convert_rows(const float* raw,
                                             __nv_bfloat16* hi,
                                             __nv_bfloat16* lo, int r_lo,
                                             int r_hi, F row_factor) {
  constexpr int G = kK / 4;
#pragma unroll 4
  for (int i = r_lo * G + threadIdx.x; i < r_hi * G; i += blockDim.x) {
    const int r = i / G, k = (i % G) * 4;
    float4 v = *reinterpret_cast<const float4*>(raw + r * kK + k);
    const float f = row_factor(r);
    v.x *= f; v.y *= f; v.z *= f; v.w *= f;
    split_store(hi, lo, swz(r, k), v);
  }
}

// accumulator element 4 j + i of a thread: row (warp % 4) * 16 + lane / 4
// + 8 (i / 2) of its warpgroup's tile, column 8 j + 2 (lane % 4) + i % 2
template <class F>
__device__ __forceinline__ void store_acc(const float (&acc)[32], F store2) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(warp * 16 + lane / 4 + 8 * h, 8 * j + 2 * (lane & 3),
             acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

struct Dims {
  int B, S, H, P, N, Q, Cn, Qp;
  __device__ int chunk_len(int c) const { return min(Q, S - c * Q); }
};

// ---- pass 1: cum[b, c, h, i] = cumsum_i A_h dt (past the chunk: its
// total); one warp per (b, c, h)
__global__ void __launch_bounds__(kThreads)
ssd_cum(const float* __restrict__ dt, const float* __restrict__ A_log,
        float* __restrict__ cum, Dims d) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int h = blockIdx.z * (kThreads / 32) + threadIdx.x / 32;
  if (h >= d.H) return;
  const int c0 = c * d.Q, Qc = d.chunk_len(c);
  const int lane = threadIdx.x % 32;
  const int per = (Qc + 31) / 32;
  const int lo = min(lane * per, Qc), hi = min(lo + per, Qc);
  const float A = -expf(A_log[h]);
  float* out = cum + (((size_t)b * d.Cn + c) * d.H + h) * d.Qp;
  const float* dtb = dt + ((size_t)b * d.S + c0) * d.H + h;
  float run = 0.f;         // runs per lane, then a scan of the lanes' sums
  for (int i = lo; i < hi; ++i) {
    run += A * dtb[(size_t)i * d.H];
    out[i] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  float pre = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) pre = 0.f;
  for (int i = lo; i < hi; ++i) out[i] += pre;
  const float total = __shfl_sync(kFull, incl, 31);
  for (int i = Qc + lane; i < d.Qp; i += 32) out[i] = total;
}

// ---- pass 2: G[b, c, q, s] = C_q . B_s on the tiles with s-tile <= q-tile
struct CbPass {
  const float* Cb;    // C row of the q tile's first row
  const float* Bb;    // B row of the s tile's first row
  int N, vq, vs;      // valid rows of the two tiles
  __device__ bool active(int, int) const { return true; }
  __device__ int majors(int) const { return 0; }     // C, B: K-major
  __device__ void fetch(int k, float* ra, float* rb) const {
    fetch_tile(ra, Cb + k * kK, N, 0, kT, kK, vq, N - k * kK);
    fetch_tile(rb, Bb + k * kK, N, 0, kT, kK, vs, N - k * kK);
  }
  __device__ void convert(int, const float* ra, const float* rb,
                          const Smem& sm) const {
    convert_rows(ra, sm.a_hi, sm.a_lo, 0, kT, [](int) { return 1.f; });
    convert_rows(rb, sm.b_hi, sm.b_lo, 0, kT, [](int) { return 1.f; });
  }
};

__global__ void __launch_bounds__(kThreads)
ssd_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
       float* __restrict__ G, Dims d) {
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.x) ++qt;
  const int st = blockIdx.x - qt * (qt + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * d.Q, Qc = d.chunk_len(c);
  if (qt * kT >= Qc) return;                     // past a ragged chunk
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve_smem(smem_raw, 1);
  const size_t row0 = (size_t)b * d.S + c0;
  const CbPass ps{Cm + (row0 + qt * kT) * d.N, Bm + (row0 + st * kT) * d.N,
                  d.N, Qc - qt * kT, Qc - st * kT};
  float acc[32];
  mma_loop(ps, (d.N + kK - 1) / kK, sm, acc);
  float* Gt = G + ((((size_t)b * d.Cn + c) * d.Qp + qt * kT) * d.Qp) +
              st * kT;
  store_acc(acc, [&](int r, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(Gt + (size_t)r * d.Qp + col) =
        make_float2(v0, v1);
  });
}

// ---- pass 3: upd[b, c, h, p, n] = sum_s xs[s, p] w_s B[s, n]
struct StatePass {
  const float* xb;    // xs row of the chunk's first step, head h
  const float* Bb;    // B row of the chunk's first step, column n0
  const float* w;     // w_s in shared memory
  size_t x_stride;
  int P, N, n0, Qc;
  __device__ bool active(int, int) const { return true; }
  // xs^T and (w B)^T from their [s][p] and [s][n] rows: both MN-major
  __device__ int majors(int) const { return 3; }
  __device__ void fetch(int k, float* ra, float* rb) const {
    const int s0 = k * kK;
    fetch_tile(ra, xb + s0 * x_stride, x_stride, 0, kK, kT, Qc - s0, P);
    fetch_tile(rb, Bb + (size_t)s0 * N, N, 0, kK, kT, Qc - s0, N - n0);
  }
  __device__ void convert(int k, const float* ra, const float* rb,
                          const Smem& sm) const {
    const float* wk = w + k * kK;
    convert_rows(ra, sm.a_hi, sm.a_lo, 0, kK, [](int) { return 1.f; });
    convert_rows(rb, sm.b_hi, sm.b_lo, 0, kK, [wk](int s) { return wk[s]; });
  }
};

__global__ void __launch_bounds__(kThreads)
ssd_state(const float* __restrict__ xs, const float* __restrict__ Bm,
          const float* __restrict__ dt, const float* __restrict__ cum,
          float* __restrict__ upd, Dims d) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve_smem(smem_raw, 1);
  const int n0 = blockIdx.x * kT, c = blockIdx.y;
  const int b = blockIdx.z / d.H, h = blockIdx.z % d.H;
  const int c0 = c * d.Q, Qc = d.chunk_len(c);
  const size_t bch = ((size_t)b * d.Cn + c) * d.H + h;
  const float* cu = cum + bch * d.Qp;
  const float total = cu[Qc - 1];
  float* w = sm.vec;                             // [Qp]
  for (int i = threadIdx.x; i < d.Qp; i += kThreads)
    w[i] = i < Qc ? expf(total - cu[i]) *
                        dt[((size_t)b * d.S + c0 + i) * d.H + h]
                  : 0.f;
  __syncthreads();
  const size_t x_stride = (size_t)d.H * d.P;
  const StatePass ps{xs + ((size_t)b * d.S + c0) * x_stride + (size_t)h * d.P,
                     Bm + ((size_t)b * d.S + c0) * d.N + n0, w, x_stride,
                     d.P, d.N, n0, Qc};
  float acc[32];
  mma_loop(ps, (Qc + kK - 1) / kK, sm, acc);
  float* ub = upd + bch * d.P * d.N;
  store_acc(acc, [&](int p, int col, float v0, float v1) {
    const int n = n0 + col;
    if (p < d.P && n < d.N)
      *reinterpret_cast<float2*>(ub + (size_t)p * d.N + n) =
          make_float2(v0, v1);
  });
}

// ---- pass 4: state passing over the chunks, in order (eight chunks'
// loads issued together, then their dependent updates)
__global__ void __launch_bounds__(256)
ssd_pass(const float* __restrict__ cum, float* __restrict__ upd,
         float* __restrict__ h_out, Dims d) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int b = blockIdx.y / d.H, h = blockIdx.y % d.H;
  const int PN = d.P * d.N;
  if (e >= PN) return;
  float state = 0.f;
  for (int c0 = 0; c0 < d.Cn; c0 += 8) {
    float add[8], decay[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + i;
      if (c < d.Cn) {
        const size_t bch = ((size_t)b * d.Cn + c) * d.H + h;
        add[i] = upd[bch * PN + e];
        decay[i] = expf(cum[bch * d.Qp + d.chunk_len(c) - 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + i;
      if (c < d.Cn) {
        upd[(((size_t)b * d.Cn + c) * d.H + h) * PN + e] = state;  // h_prev
        state = decay[i] * state + add[i];
      }
    }
  }
  h_out[((size_t)b * d.H + h) * PN + e] = state;
}

// ---- pass 5: y = (exp(cum_q) C_q) . h_prev^T + (G o L o dt) . xs, one
// block per (b, chunk, h) with one warpgroup per 64-row q tile: the
// B operands (h_prev, then xs^T) are converted once for all q tiles, and
// an s chunk only reaches the q tiles on or below its diagonal
struct OutPass {
  const float* Cb;    // C row of the chunk's first step
  const float* hp;    // h_prev [P, N] of (b, c, h)
  const float* Gc;    // G [Qp, Qp] of (b, c)
  const float* xb;    // xs row of the chunk's first step, head h
  const float* cu;    // cum of the chunk in shared memory
  const float* dts;   // dt of the chunk in shared memory
  const float* ecum;  // exp(cum) of the chunk in shared memory
  size_t x_stride;
  int P, N, Qp, Qc, nch;
  int qb, rows;       // the block's q rows: [qb, qb + rows) of the chunk
  // the first of the block's rows an s chunk reaches (its 64-row tile's)
  __device__ int row_lo(int k) const {
    return k < nch ? 0 : max(0, ((k - nch) * kK) / kT * kT - qb);
  }
  __device__ bool active(int k, int wg) const {
    return wg * kT < rows && (wg + 1) * kT > row_lo(k);
  }
  // C.h: C and h K-major; M.xs: M K-major, xs from its [s][p] rows
  __device__ int majors(int k) const { return k < nch ? 0 : 1; }
  __device__ void fetch(int k, float* ra, float* rb) const {
    if (k < nch) {
      fetch_tile(ra, Cb + k * kK, N, 0, rows, kK, Qc - qb, N - k * kK);
      fetch_tile(rb, hp + k * kK, N, 0, kT, kK, P, N - k * kK);
    } else {
      const int s0 = (k - nch) * kK;
      fetch_tile(ra, Gc + s0, Qp, row_lo(k), rows, kK, rows, kK);
      fetch_tile(rb, xb + s0 * x_stride, x_stride, 0, kK, kT, Qc - s0, P);
    }
  }
  __device__ void convert(int k, const float* ra, const float* rb,
                          const Smem& sm) const {
    if (k < nch) {
      const float* ec = ecum + qb;
      convert_rows(ra, sm.a_hi, sm.a_lo, 0, rows,
                   [ec](int r) { return ec[r]; });
      convert_rows(rb, sm.b_hi, sm.b_lo, 0, kT, [](int) { return 1.f; });
      return;
    }
    const int s0 = (k - nch) * kK;
    // M[q, s] = G[q, s] exp(cum_q - cum_s) dt_s on s <= q, else 0
    constexpr int Gk = kK / 4;
#pragma unroll 4
    for (int i = row_lo(k) * Gk + threadIdx.x; i < rows * Gk;
         i += blockDim.x) {
      const int r = i / Gk, kk = (i % Gk) * 4, q = qb + r, s = s0 + kk;
      const float4 g = *reinterpret_cast<const float4*>(ra + r * kK + kk);
      const float4 c = *reinterpret_cast<const float4*>(cu + s);
      const float4 d = *reinterpret_cast<const float4*>(dts + s);
      const float cq = cu[q];
      auto m = [&](float gv, float cs, float ds, int t) {
        return (s + t <= q && s + t < Qc) ? gv * expf(cq - cs) * ds : 0.f;
      };
      split_store(sm.a_hi, sm.a_lo, swz(r, kk),
                  make_float4(m(g.x, c.x, d.x, 0), m(g.y, c.y, d.y, 1),
                              m(g.z, c.z, d.z, 2), m(g.w, c.w, d.w, 3)));
    }
    convert_rows(rb, sm.b_hi, sm.b_lo, 0, kK, [](int) { return 1.f; });
  }
};

template <int W>
__global__ void __launch_bounds__(W * 128)
ssd_out(const float* __restrict__ xs, const float* __restrict__ Cm,
        const float* __restrict__ dt, const float* __restrict__ cum,
        const float* __restrict__ G, const float* __restrict__ h_prev,
        float* __restrict__ y, Dims d) {
  // block x: chunk c, and which W q tiles of it (the lower ones first)
  const int parts = (d.Qp / kT + W - 1) / W;
  const int c = blockIdx.x / parts;
  const int qb = (parts - 1 - (int)blockIdx.x % parts) * W * kT;
  const int b = blockIdx.y / d.H, h = blockIdx.y % d.H;
  const int c0 = c * d.Q, Qc = d.chunk_len(c);
  const int rows = min(W * kT, (Qc + kT - 1) / kT * kT - qb);
  if (rows <= 0) return;                         // past a ragged chunk
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve_smem(smem_raw, W);
  const size_t bch = ((size_t)b * d.Cn + c) * d.H + h;
  float* cu = sm.vec;                            // [Qp]
  float* dts = cu + d.Qp;                        // [Qp]
  float* ecum = dts + d.Qp;                      // [Qp]
  for (int i = threadIdx.x; i < d.Qp; i += blockDim.x) {
    cu[i] = cum[bch * d.Qp + i];
    ecum[i] = expf(cu[i]);
    dts[i] = i < Qc ? dt[((size_t)b * d.S + c0 + i) * d.H + h] : 0.f;
  }
  __syncthreads();
  const size_t x_stride = (size_t)d.H * d.P;
  const size_t row0 = (size_t)b * d.S + c0;
  // the state is zero in the first chunk: no C.h term there
  const int nch = c > 0 ? (d.N + kK - 1) / kK : 0;
  const OutPass ps{Cm + (row0 + qb) * d.N, h_prev + bch * d.P * d.N,
                   G + (((size_t)b * d.Cn + c) * d.Qp + qb) * d.Qp,
                   xs + row0 * x_stride + (size_t)h * d.P,
                   cu, dts, ecum, x_stride, d.P, d.N, d.Qp, Qc, nch,
                   qb, rows};
  const int s_end = min(qb + rows, Qc);          // s <= q < s_end
  float acc[32];
  mma_loop(ps, nch + (s_end + kK - 1) / kK, sm, acc);
  const int q0 = qb + (threadIdx.x / 128) * kT;
  store_acc(acc, [&](int r, int p, float v0, float v1) {
    const int q = q0 + r;
    if (q < Qc && p < d.P)
      *reinterpret_cast<float2*>(y + (row0 + q) * x_stride +
                                 (size_t)h * d.P + p) = make_float2(v0, v1);
  });
}

// dynamic shared memory of each pass at the largest chunk (Qp = 256)
constexpr size_t kSmemCb = smem_base(1);
constexpr size_t kSmemState = smem_base(1) + kMaxChunk * sizeof(float);
template <int W>
constexpr size_t smem_out() {
  return smem_base(W) + 3 * kMaxChunk * sizeof(float);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// raise each kernel's dynamic shared memory limit, once per process
cudaError_t allow_all_smem() {
  cudaError_t err;
  if ((err = allow_smem(ssd_cb, kSmemCb)) != cudaSuccess ||
      (err = allow_smem(ssd_state, kSmemState)) != cudaSuccess ||
      (err = allow_smem(ssd_out<1>, smem_out<1>())) != cudaSuccess ||
      (err = allow_smem(ssd_out<2>, smem_out<2>())) != cudaSuccess ||
      (err = allow_smem(ssd_out<3>, smem_out<3>())) != cudaSuccess)
    return err;
  return allow_smem(ssd_out<4>, smem_out<4>());
}

template <int W>
cudaError_t launch_out(const float* xs, const float* Cm, const float* dt,
                       const float* cum, const float* G, const float* h_prev,
                       float* y, const Dims& d, cudaStream_t st) {
  const int parts = (d.Qp / kT + W - 1) / W;
  ssd_out<W><<<dim3(d.Cn * parts, d.B * d.H), W * 128, smem_out<W>(), st>>>(
      xs, Cm, dt, cum, G, h_prev, y, d);
  return cudaGetLastError();
}

}  // namespace

// xs [B,S,H,P], Bm/Cm [B,S,N], dt [B,S,H], A_log [H] -> y [B,S,H,P],
// h_out [B,H,P,N]; all f32 and contiguous; P <= 64, P and N multiples of
// 4, 0 < Q <= min(S, 256).  Scratch from the caller, Cn = ceil(S / Q) and
// Qp = Q rounded up to 64: B Cn (H Qp + Qp Qp + H P N) floats, holding
// cum [B,Cn,H,Qp], G [B,Cn,Qp,Qp] and upd [B,Cn,H,P,N] in turn.  Five
// launches on `stream`; returns the first launch error (0 on success).
extern "C" int ssd_scan_launch(const void* xs, const void* Bm, const void* Cm,
                               const void* dt, const void* A_log, void* y,
                               void* h_out, void* scratch, int B, int S,
                               int H, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kT || P % 4 != 0 ||
      N <= 0 || N % 4 != 0 || Q <= 0 || Q > S || Q > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t smem_err = allow_all_smem();
  if (smem_err != cudaSuccess) return (int)smem_err;
  const Dims d{B, S, H, P, N, Q, (S + Q - 1) / Q, (Q + kT - 1) / kT * kT};
  const int T = d.Qp / kT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_xs = static_cast<const float*>(xs);
  const float* f_B = static_cast<const float*>(Bm);
  const float* f_C = static_cast<const float*>(Cm);
  const float* f_dt = static_cast<const float*>(dt);
  float* f_cum = static_cast<float*>(scratch);
  float* f_G = f_cum + (size_t)B * d.Cn * H * d.Qp;
  float* f_upd = f_G + (size_t)B * d.Cn * d.Qp * d.Qp;

  cudaError_t err;
  ssd_cum<<<dim3(d.Cn, B, (H + 3) / 4), kThreads, 0, st>>>(
      f_dt, static_cast<const float*>(A_log), f_cum, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_cb<<<dim3(T * (T + 1) / 2, d.Cn, B), kThreads, kSmemCb, st>>>(
      f_B, f_C, f_G, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_state<<<dim3((N + kT - 1) / kT, d.Cn, B * H), kThreads, kSmemState,
              st>>>(f_xs, f_B, f_dt, f_cum, f_upd, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_pass<<<dim3((P * N + 255) / 256, B * H), 256, 0, st>>>(
      f_cum, f_upd, static_cast<float*>(h_out), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  float* f_y = static_cast<float*>(y);
  switch (min(T, kOutWarpgroups)) {
    case 1: return (int)launch_out<1>(f_xs, f_C, f_dt, f_cum, f_G, f_upd,
                                      f_y, d, st);
    case 2: return (int)launch_out<2>(f_xs, f_C, f_dt, f_cum, f_G, f_upd,
                                      f_y, d, st);
    case 3: return (int)launch_out<3>(f_xs, f_C, f_dt, f_cum, f_G, f_upd,
                                      f_y, d, st);
    default: return (int)launch_out<4>(f_xs, f_C, f_dt, f_cum, f_G, f_upd,
                                       f_y, d, st);
  }
}
