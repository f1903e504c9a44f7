// K7 SSD scan (Mamba2 prefill), for Hopper (sm_90a).
//
// Replaces repro/kernels/ssm_scan.py::ssm_scan_ssd (_ssd_kernel): per
// (batch row, SSM head) the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t,   y_t = C_t . h_t
// in float32, evaluated in chunks of T <= 64 tokens as the TPU kernel does.
// With P the inclusive prefix sum of dt*A inside a chunk and
// L[i, j] = exp(P_i - P_j) for i >= j, else 0:
//   S_c    = B^T (w . X),  w_j = dt_j exp(P_last - P_j)   chunk-local state
//   s_c+1  = exp(P_last) s_c + S_c                         carried state
//   y      = (L o C B^T)(dt . X) + diag(exp P) C s_c
// The recurrence is the same for any T; only the rounding differs from the
// TPU kernel's T = 128.
//
// Bound: bytes.  At zamba2-2.7b's prefill (1, 200, 80 heads, hd 64, N 64,
// one B/C group) the inputs and outputs are ~9.7 MB (2.9 us at 3.35 TB/s);
// the chunked form does ~0.39 GFLOP, 5.8 us on the CUDA cores' float32 FMA
// but 2.4 us as 3xTF32 on the tensor cores, which is how the products run
// here.
//
// Parallelism.  The TPU walks the chunks in order inside one grid; here the
// scan is three launches, each parallel over (chunk, head, batch row):
//   ssd_state_kernel   (a) S_c transposed to (hd, N) and exp(P_last), one
//                      block per (chunk, 32 state rows, head, row);
//   ssd_pass_kernel    (b) a short pass over the chunks, parallel over the
//                      state's elements, that turns each S_c into the state
//                      entering chunk c (in place) and writes the final
//                      state in the cache layout (B, H, hd, N);
//   ssd_output_kernel  (c) y for 32 query rows of one chunk: M = L o C B^T
//                      for those rows (computed once per (chunk, head), never
//                      per column block), then y = M (dt . X) + diag(exp P)
//                      C s_c on one set of accumulators.
// One chunk (L <= T: the chunked prefill's call) needs no pass: (a) writes
// the final state directly and (c) has no carried state.  At (1, 64) that
// is 160 + 160 blocks for 132 SMs.
//
// Products: mma.sync m16n8k8 TF32 with the 3xTF32 split (a = a_hi + a_lo,
// a_hi the float truncated to TF32, a_lo the rest rounded to TF32;
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi accumulated in float32), which keeps
// float32 accuracy: the port never runs a float32 product in plain TF32.
// The kernels are built for a padded width W = 32, 64 or 128 that covers
// hd and N (zamba2: 64), so each warp's tiles are a compile-time count and
// its product loop has no branch inside: the independent mma chains of
// its tiles interleave (guarding each tile by the runtime width serialised
// them).  Shared tiles sit at pitches of 4 or 8 floats past a multiple of
// 32, so every fragment load is conflict-free.  The prefix sum of dt*A is a warp scan.  Tiles arrive by
// cp.async in two groups: C and B, which the C B^T product needs first,
// then X and the carried state while it runs; and ~70 KB of shared memory
// at W = 64 leaves three blocks an SM to hide each other's loads.
//
// Ragged L: no fallback.  Rows past L (or past the chunk) load as zeros, so
// P stops at P[L-1] and the state's decay ends there; nothing is stored past
// L.  Overflow: exp(P_i - P_j) is built only under i >= j, by select (for
// i < j the exponent is positive and may overflow to inf, and inf * 0 is
// NaN).  x, dt, B and C are read in the model layout through strides (a
// head stride of 0 for one B/C group); rows on 16-byte boundaries arrive as
// 16-byte copies, others element by element.  N and hd are zero-padded to W
// in shared memory (at most 128 each).
#include "common.cuh"

namespace {

constexpr int SSD_TP = 64;         // tile rows: a chunk, zero-filled past T
constexpr int SSD_QT = 32;         // query rows of an output block
constexpr int SSD_DG = 32;         // state rows (hd) of a state block
constexpr int SSD_CG = 2;          // column sets of a block's warps
constexpr int SSD_THREADS = 64 * SSD_CG;   // 2 row tiles x SSD_CG warps
constexpr int SSD_MAXW = 128;      // largest N and hd
constexpr int PASS_THREADS = 128;
constexpr int PASS_BATCH = 8;      // chunks' loads in flight in the pass

__host__ __device__ constexpr int rup(int x, int m) {
  return (x + m - 1) / m * m;
}
// row pitches: fragment loads that walk rows with the lane's group index
// (row-major A, [n][k] B) want pitch = 4 mod 32, those that walk rows with
// the index in the group ([k][m] A, [k][n] B) want pitch = 8 mod 32
__host__ __device__ constexpr int pitch4(int cols) {
  return rup(cols, 32) + 4;
}
__host__ __device__ constexpr int pitch8(int cols) {
  return rup(cols, 32) + 8;
}
// the padded width W a kernel instance is built for
constexpr int width_of(int hd, int N) {
  return hd <= 32 && N <= 32 ? 32 : hd <= 64 && N <= 64 ? 64 : 128;
}

constexpr size_t state_smem_bytes(int W) {
  return (size_t)(SSD_TP * pitch8(SSD_DG) + SSD_TP * pitch8(W) + 3 * SSD_TP) *
         sizeof(float);
}

constexpr size_t output_smem_bytes(int W) {
  return (size_t)((SSD_QT + SSD_TP + W) * pitch4(W) + SSD_QT * pitch4(SSD_TP) +
                  SSD_TP * pitch8(W) + 2 * SSD_TP) *
         sizeof(float);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one cp.async of BYTES (4 or 16); ok == false zero-fills the destination
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, nrows) x columns [0, ncols) of a tile into shared memory at
// `pitch`; source element (r, c) at src[r * stride + c], zero where
// r >= valid_rows or c >= valid_cols.  vec: every row starts on 16 bytes
// and valid_cols is a multiple of 4 (ncols always is).
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, long long stride,
                                          int nrows, int valid_rows,
                                          int ncols, int valid_cols,
                                          bool vec) {
  if (vec) {
    const int q = ncols >> 2;
    for (int e = threadIdx.x; e < nrows * q; e += SSD_THREADS) {
      const int r = e / q, c = (e - r * q) * 4;
      const bool ok = r < valid_rows && c < valid_cols;
      cp_async<16>(dst + r * pitch + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * ncols; e += SSD_THREADS) {
      const int r = e / ncols, c = e - r * ncols;
      const bool ok = r < valid_rows && c < valid_cols;
      cp_async<4>(dst + r * pitch + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// dt of the tile's rows (zero past the chunk) into shared memory
__device__ __forceinline__ void load_dt(float* dts, const float* dtb,
                                        long long dt_sl, int nt) {
  if (threadIdx.x < SSD_TP)
    dts[threadIdx.x] =
        threadIdx.x < nt ? dtb[(long long)threadIdx.x * dt_sl] : 0.f;
}

// inclusive prefix sums of dt_j * A over the 64 tile rows, by one warp:
// lane l owns rows 2l and 2l + 1.  __fmul_rn keeps the products out of
// FMA contraction, so every kernel rounds P alike.
__device__ __forceinline__ void chunk_prefix(const float* dts, float A,
                                             float* Ps, int lane) {
  const float v0 = __fmul_rn(dts[2 * lane], A);
  const float v1 = __fmul_rn(dts[2 * lane + 1], A);
  float s = v0 + v1;
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  float ex = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) ex = 0.f;
  Ps[2 * lane] = ex + v0;
  Ps[2 * lane + 1] = s;
}

// ---- 3xTF32 mma.sync m16n8k8 -------------------------------------------
// Fragment coordinates (gid = lane / 4, tig = lane % 4): A (16 x 8) holds
// (gid, tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4); B (8 x 8)
// holds (tig, gid), (tig + 4, gid); D (16 x 8) holds (gid, 2 tig + e) and
// (gid + 8, 2 tig + e), e = 0, 1.

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi: x truncated to TF32 (one mask); lo: the exact rest, rounded
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at float32 accuracy: the small cross terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// A from a row-major [m][k] tile, rows m0.., columns k0..
__device__ __forceinline__ FragA frag_a(const float* s, int p, int m0, int k0,
                                        int gid, int tig) {
  const float* r0 = s + (m0 + gid) * p + k0 + tig;
  const float* r1 = r0 + 8 * p;
  FragA f;
  split_tf32(r0[0], f.hi[0], f.lo[0]);
  split_tf32(r1[0], f.hi[1], f.lo[1]);
  split_tf32(r0[4], f.hi[2], f.lo[2]);
  split_tf32(r1[4], f.hi[3], f.lo[3]);
  return f;
}

// A from a [k][m] tile (A^T stored row-major), each k row scaled by w[k]
__device__ __forceinline__ FragA frag_a_t(const float* s, int p,
                                          const float* w, int m0, int k0,
                                          int gid, int tig) {
  const float* c0 = s + (k0 + tig) * p + m0 + gid;
  const float* c1 = c0 + 4 * p;
  const float w0 = w[k0 + tig], w1 = w[k0 + tig + 4];
  FragA f;
  split_tf32(c0[0] * w0, f.hi[0], f.lo[0]);
  split_tf32(c0[8] * w0, f.hi[1], f.lo[1]);
  split_tf32(c1[0] * w1, f.hi[2], f.lo[2]);
  split_tf32(c1[8] * w1, f.hi[3], f.lo[3]);
  return f;
}

// B from a [k][n] tile, rows k0.., columns n0..
__device__ __forceinline__ FragB frag_b(const float* s, int p, int k0, int n0,
                                        int gid, int tig) {
  const float* c = s + (k0 + tig) * p + n0 + gid;
  FragB f;
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[4 * p], f.hi[1], f.lo[1]);
  return f;
}

// B from an [n][k] tile (B^T stored row-major)
__device__ __forceinline__ FragB frag_b_t(const float* s, int p, int k0,
                                          int n0, int gid, int tig) {
  const float* r = s + (n0 + gid) * p + k0 + tig;
  FragB f;
  split_tf32(r[0], f.hi[0], f.lo[0]);
  split_tf32(r[4], f.hi[1], f.lo[1]);
  return f;
}

// ---- (a) chunk-local states ---------------------------------------------
// S_c^T[d][n] = sum_j w_j x[j][d] B[j][n] for the block's 32 rows d; warp
// (mt, ng) takes 16 rows and the n tiles ng, ng + SSD_CG, ... of W.  Writes
// S_c^T into ws (B, H, nc, DW, NK) and exp(P_last) into decay (B, H, nc);
// or, for one chunk, the final state straight into h_out (B, H, hd, N).
template <int W>
__global__ void __launch_bounds__(SSD_THREADS) ssd_state_kernel(
    const float* __restrict__ x, long long x_sb, long long x_sl,
    long long x_sh, const float* __restrict__ dt, long long dt_sb,
    long long dt_sl, long long dt_sh, const float* __restrict__ A,
    const float* __restrict__ Bm, long long b_sb, long long b_sl,
    long long b_sh, float* __restrict__ ws, float* __restrict__ decay,
    float* __restrict__ h_out, int L, int H, int hd, int N, int T, int nc,
    int vec_x, int vec_b) {
  const int ndg = (hd + SSD_DG - 1) / SSD_DG;
  const int c = blockIdx.x / ndg, d0 = (blockIdx.x - c * ndg) * SSD_DG;
  const int h = blockIdx.y, b = blockIdx.z;
  if (c >= nc) return;  // the whole block: before any barrier
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = c * T, nt = min(T, L - c0), kr = rup(nt, 8);
  const int NK = rup(N, 8);
  constexpr int px = pitch8(SSD_DG), pb = pitch8(W), NT = W / 8 / SSD_CG;

  extern __shared__ float smem[];
  float* Xs = smem;               // TP x px   x[j][d0 + d]
  float* Bs = Xs + SSD_TP * px;   // TP x pb   B[j][n]
  float* dts = Bs + SSD_TP * pb;  // TP
  float* Ps = dts + SSD_TP;       // TP        prefix sums of dt*A
  float* wj = Ps + SSD_TP;        // TP        dt_j exp(P_last - P_j)

  load_tile(Xs, px, x + b * x_sb + c0 * x_sl + h * x_sh + d0, x_sl, kr, nt,
            SSD_DG, hd - d0, vec_x);
  load_tile(Bs, pb, Bm + b * b_sb + c0 * b_sl + h * b_sh, b_sl, kr, nt, W, N,
            vec_b);
  cp_async_commit();
  load_dt(dts, dt + b * dt_sb + c0 * dt_sl + h * dt_sh, dt_sl, nt);
  __syncthreads();
  if (warp == 0) chunk_prefix(dts, A[h], Ps, lane);
  __syncthreads();
  const float P_last = Ps[SSD_TP - 1];
  if (tid < SSD_TP) wj[tid] = dts[tid] * expf(P_last - Ps[tid]);
  if (decay != nullptr && d0 == 0 && tid == 0)
    decay[((long long)b * H + h) * nc + c] = expf(P_last);
  cp_async_wait<0>();
  __syncthreads();

  const int mt = warp & 1, ng = warp >> 1;
  float acc[NT][4] = {};
  for (int k0 = 0; k0 < kr; k0 += 8) {
    const FragA a = frag_a_t(Xs, px, wj, 16 * mt, k0, gid, tig);
#pragma unroll
    for (int t = 0; t < NT; ++t)
      mma3(acc[t], a, frag_b(Bs, pb, k0, 8 * (ng + SSD_CG * t), gid, tig));
  }

  const long long bh = (long long)b * H + h;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n = 8 * (ng + SSD_CG * t) + 2 * tig;  // even; NK is too
    if (n >= NK) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = d0 + 16 * mt + gid + 8 * half;
      const float v0 = acc[t][2 * half], v1 = acc[t][2 * half + 1];
      if (h_out != nullptr) {
        float* o = h_out + (bh * hd + d) * N + n;
        if (d < hd && n < N) o[0] = v0;
        if (d < hd && n + 1 < N) o[1] = v1;
      } else {
        const int DW = ndg * SSD_DG;
        *reinterpret_cast<float2*>(ws + ((bh * nc + c) * DW + d) * NK + n) =
            make_float2(v0, v1);
      }
    }
  }
}

// ---- (b) the pass over chunks -------------------------------------------
// Per element of the (DW, NK) state: s_0 = 0, s_{c+1} = exp(P_last,c) s_c +
// S_c; ws[c] becomes s_c (the state entering chunk c), and h_out, when
// given, gets s_nc in the cache layout.  PASS_BATCH chunks' loads are issued
// before their FMAs.
__global__ void __launch_bounds__(PASS_THREADS) ssd_pass_kernel(
    float* __restrict__ ws, const float* __restrict__ decay,
    float* __restrict__ h_out, int H, int hd, int N, int DW, int NK, int nc) {
  const int per = DW * NK / 4;
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= per) return;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  float4* w = reinterpret_cast<float4*>(ws) + bh * nc * per + e;
  const float* dc = decay + bh * nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cb = 0; cb < nc; cb += PASS_BATCH) {
    float4 v[PASS_BATCH];
    float a[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (cb + k < nc) {
        v[k] = w[(long long)(cb + k) * per];
        a[k] = dc[cb + k];
      }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (cb + k < nc) {
        if (cb + k > 0) w[(long long)(cb + k) * per] = s;
        s.x = fmaf(a[k], s.x, v[k].x);
        s.y = fmaf(a[k], s.y, v[k].y);
        s.z = fmaf(a[k], s.z, v[k].z);
        s.w = fmaf(a[k], s.w, v[k].w);
      }
  }
  if (h_out != nullptr) {
    const int d = 4 * e / NK, n = 4 * e - d * NK;
    if (d >= hd) return;
    float* o = h_out + (bh * hd + d) * N + n;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (n + k < N) o[k] = sv[k];
  }
}

// ---- (c) outputs ----------------------------------------------------------
// M = (C B^T)[i][j] exp(P_i - P_j) dt_j under j <= i, for the block's 32
// query rows and the JT * SSD_CG * 8 keys they can see (32 for rows 0..31,
// 64 for rows 32..63); warp (mt, cg) takes 16 rows and the key tiles cg,
// cg + SSD_CG, ...
template <int W, int JT>
__device__ __forceinline__ void build_m(const float* Cs, const float* Bs,
                                        float* Ms, const float* Ps,
                                        const float* dts, int q0, int mt,
                                        int cg, int gid, int tig) {
  constexpr int pn = pitch4(W), pm = pitch4(SSD_TP);
  float am[JT][4] = {};
  for (int k0 = 0; k0 < W; k0 += 8) {
    const FragA a = frag_a(Cs, pn, 16 * mt, k0, gid, tig);
#pragma unroll
    for (int t = 0; t < JT; ++t)
      mma3(am[t], a, frag_b_t(Bs, pn, k0, 8 * (cg + SSD_CG * t), gid, tig));
  }
#pragma unroll
  for (int t = 0; t < JT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int il = 16 * mt + gid + 8 * (e >> 1), i = q0 + il;
      const int j = 8 * (cg + SSD_CG * t) + 2 * tig + (e & 1);
      Ms[il * pm + j] = j <= i ? am[t][e] * expf(Ps[i] - Ps[j]) * dts[j] : 0.f;
    }
}

// Query rows q0 .. q0 + 31 of chunk c: M (build_m), then y = diag(exp P)
// C s_c + M X.  Warp (mt, cg) takes 16 rows and the column tiles cg,
// cg + SSD_CG, ... of W.
template <int W>
__global__ void __launch_bounds__(SSD_THREADS) ssd_output_kernel(
    const float* __restrict__ x, long long x_sb, long long x_sl,
    long long x_sh, const float* __restrict__ dt, long long dt_sb,
    long long dt_sl, long long dt_sh, const float* __restrict__ A,
    const float* __restrict__ Bm, long long b_sb, long long b_sl,
    long long b_sh, const float* __restrict__ Cm, long long c_sb,
    long long c_sl, long long c_sh, const float* __restrict__ ws,
    float* __restrict__ y, int L, int H, int hd, int N, int T, int nc,
    int DW, int vec_x, int vec_bc) {
  const int c = blockIdx.x >> 1, q0 = (blockIdx.x & 1) * SSD_QT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * T, nt = min(T, L - c0);
  if (q0 >= nt) return;  // the whole block: before any barrier
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int kr = rup(min(q0 + SSD_QT, nt), 8);  // keys any row here sees
  const int jr = q0 + SSD_QT;                   // keys build_m covers
  const int NK = rup(N, 8);
  constexpr int pn = pitch4(W), pm = pitch4(SSD_TP), px = pitch8(W);
  constexpr int DT = W / 8 / SSD_CG;
  const bool carried = c > 0;
  const long long bh = (long long)b * H + h;

  extern __shared__ float smem[];
  float* Cs = smem;                // QT x pn   C[q0 + i][n]
  float* Bs = Cs + SSD_QT * pn;    // TP x pn   B[j][n]
  float* St = Bs + SSD_TP * pn;    // W x pn    s_c^T[d][n]
  float* Ms = St + W * pn;         // QT x pm   M[i][j]
  float* Xs = Ms + SSD_QT * pm;    // TP x px   x[j][d]
  float* dts = Xs + SSD_TP * px;   // TP
  float* Ps = dts + SSD_TP;        // TP

  const float* Bb = Bm + b * b_sb + c0 * b_sl + h * b_sh;
  load_tile(Cs, pn, Cm + b * c_sb + (c0 + q0) * c_sl + h * c_sh, c_sl, SSD_QT,
            nt - q0, W, N, vec_bc);
  load_tile(Bs, pn, Bb, b_sl, jr, nt, W, N, vec_bc);
  cp_async_commit();
  load_tile(Xs, px, x + b * x_sb + c0 * x_sl + h * x_sh, x_sl, kr, nt, W, hd,
            vec_x);
  if (carried)
    load_tile(St, pn, ws + (bh * nc + c) * DW * NK, NK, W, DW, W, NK, true);
  cp_async_commit();
  load_dt(dts, dt + b * dt_sb + c0 * dt_sl + h * dt_sh, dt_sl, nt);
  __syncthreads();
  if (warp == 0) chunk_prefix(dts, A[h], Ps, lane);
  cp_async_wait<1>();  // C and B landed
  __syncthreads();

  const int mt = warp & 1, cg = warp >> 1;
  const int r0 = 16 * mt + gid;  // this lane's accumulator rows: r0, r0 + 8
  if (q0 == 0)
    build_m<W, SSD_QT / 8 / SSD_CG>(Cs, Bs, Ms, Ps, dts, q0, mt, cg, gid, tig);
  else
    build_m<W, SSD_TP / 8 / SSD_CG>(Cs, Bs, Ms, Ps, dts, q0, mt, cg, gid, tig);
  cp_async_wait<0>();  // X and the carried state landed
  __syncthreads();

  float ay[DT][4] = {};
  if (carried) {
    for (int k0 = 0; k0 < W; k0 += 8) {
      const FragA a = frag_a(Cs, pn, 16 * mt, k0, gid, tig);
#pragma unroll
      for (int t = 0; t < DT; ++t)
        mma3(ay[t], a, frag_b_t(St, pn, k0, 8 * (cg + SSD_CG * t), gid, tig));
    }
    const float e0 = expf(Ps[q0 + r0]), e1 = expf(Ps[q0 + r0 + 8]);
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      ay[t][0] *= e0;
      ay[t][1] *= e0;
      ay[t][2] *= e1;
      ay[t][3] *= e1;
    }
  }
  for (int k0 = 0; k0 < kr; k0 += 8) {
    const FragA a = frag_a(Ms, pm, 16 * mt, k0, gid, tig);
#pragma unroll
    for (int t = 0; t < DT; ++t)
      mma3(ay[t], a, frag_b(Xs, px, k0, 8 * (cg + SSD_CG * t), gid, tig));
  }

#pragma unroll
  for (int t = 0; t < DT; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = q0 + r0 + 8 * half;
      const int d = 8 * (cg + SSD_CG * t) + 2 * tig;
      if (i >= nt) continue;
      float* o = y + (((long long)b * L + c0 + i) * H + h) * hd + d;
      if (d < hd) o[0] = ay[t][2 * half];
      if (d + 1 < hd) o[1] = ay[t][2 * half + 1];
    }
  }
}

// The three launches for one padded width W (see the head note), on the
// (x, H, B) grids whose x extents the wrapper's plan gives: a grid of 0
// blocks is not launched.
template <int W>
cudaError_t ssd_launch(const float* x, long long x_sb, long long x_sl,
                       long long x_sh, const float* dt, long long dt_sb,
                       long long dt_sl, long long dt_sh, const float* A,
                       const float* Bm, long long b_sb, long long b_sl,
                       long long b_sh, const float* Cm, long long c_sb,
                       long long c_sl, long long c_sh, float* y, float* h_out,
                       float* ws, int B, int L, int H, int hd, int N, int T,
                       int state_grid, int pass_grid, int out_grid, int vec_x,
                       int vec_bc, cudaStream_t st) {
  const int nc = (L + T - 1) / T;
  const int DW = rup(hd, SSD_DG), NK = rup(N, 8);
  constexpr size_t smem_a = state_smem_bytes(W), smem_c = output_smem_bytes(W);
  static size_t granted_state[RT_MAX_DEVICES] = {};
  static size_t granted_out[RT_MAX_DEVICES] = {};
  cudaError_t err = rt_allow_smem(ssd_state_kernel<W>, smem_a, granted_state);
  if (err == cudaSuccess)
    err = rt_allow_smem(ssd_output_kernel<W>, smem_c, granted_out);
  if (err != cudaSuccess) return err;

  float* decay = nc > 1 ? ws + (long long)B * H * nc * DW * NK : nullptr;
  if (state_grid > 0) {
    ssd_state_kernel<W><<<dim3(state_grid, H, B), SSD_THREADS, smem_a, st>>>(
        x, x_sb, x_sl, x_sh, dt, dt_sb, dt_sl, dt_sh, A, Bm, b_sb, b_sl, b_sh,
        nc > 1 ? ws : nullptr, decay, nc > 1 ? nullptr : h_out, L, H, hd, N,
        T, nc, vec_x, vec_bc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (pass_grid > 0) {
    ssd_pass_kernel<<<dim3(pass_grid, H, B), PASS_THREADS, 0, st>>>(
        ws, decay, h_out, H, hd, N, DW, NK, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssd_output_kernel<W><<<dim3(out_grid, H, B), SSD_THREADS, smem_c, st>>>(
      x, x_sb, x_sl, x_sh, dt, dt_sb, dt_sl, dt_sh, A, Bm, b_sb, b_sl, b_sh,
      Cm, c_sb, c_sl, c_sh, ws, y, L, H, hd, N, T, nc, DW, vec_x, vec_bc);
  return cudaGetLastError();
}

}  // namespace

// The wrapper's plan (kernels/ssm_scan.py::plan) gives the chunk T and the
// three grids: nc = ceil(L / T) chunks; the state's rows padded to
// DW = 32 * ceil(hd / 32), its columns to NK = 8 * ceil(N / 8).
// ws: B*H*nc*(DW*NK + 1) floats, needed when nc > 1.
extern "C" int rt_ssm_scan(
    int device, const void* x, long long x_sb, long long x_sl, long long x_sh,
    const void* dt, long long dt_sb, long long dt_sl, long long dt_sh,
    const void* A, const void* Bm, long long b_sb, long long b_sl,
    long long b_sh, const void* Cm, long long c_sb, long long c_sl,
    long long c_sh, void* y, void* h_out, void* ws, int B, int L, int H,
    int hd, int N, int T, int state_grid, int pass_grid, int out_grid,
    int vec_x, int vec_bc, void* stream) {
  if (T < 1 || T > SSD_TP || L < 1 || B < 1 || H < 1 || hd < 1 ||
      hd > SSD_MAXW || N < 1 || N > SSD_MAXW || state_grid < 0 ||
      pass_grid < 0 || out_grid < 1)
    return (int)cudaErrorInvalidValue;
  if (L > T && ws == nullptr) return (int)cudaErrorInvalidValue;
  RtDevice on(device);
  if (on.status() != cudaSuccess) return (int)on.status();
  const int W = width_of(hd, N);
  using Launch = decltype(&ssd_launch<64>);
  const Launch launch = W == 32   ? &ssd_launch<32>
                        : W == 64 ? &ssd_launch<64>
                                  : &ssd_launch<128>;
  return (int)launch((const float*)x, x_sb, x_sl, x_sh, (const float*)dt,
                     dt_sb, dt_sl, dt_sh, (const float*)A, (const float*)Bm,
                     b_sb, b_sl, b_sh, (const float*)Cm, c_sb, c_sl, c_sh,
                     (float*)y, (float*)h_out, (float*)ws, B, L, H, hd, N, T,
                     state_grid, pass_grid, out_grid, vec_x, vec_bc,
                     (cudaStream_t)stream);
}

// shared memory a block of each kernel takes: 0 the state kernel, 1 the
// output kernel (the pass uses none)
extern "C" long long rt_ssm_smem_bytes(int kernel, int hd, int N) {
  const int W = width_of(hd, N);
  return (long long)(kernel == 0 ? state_smem_bytes(W) : output_smem_bytes(W));
}
