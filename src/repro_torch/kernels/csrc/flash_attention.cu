// K4 flash attention (prefill), for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_bhsd
// (_flash_kernel): GQA attention, causal and optionally sliding-window,
// online softmax in float32, scale hd**-0.5; query head h reads kv head
// h // G.  Inputs are read in the model layout (B, S, H, hd) /
// (B, S, KV, hd) through strides; any Sq, Sk and hd are taken, the ragged
// edge masked by select.  Both bodies walk K/V tiles only inside the
// causal / window horizon, so fully masked tiles cost nothing, as in the
// TPU kernel's tile skip.
//
// Bound: operations at long prompts (the two products grow as
// Sq*Sk*hd), bytes at short ones; at qwen2.5-3b's 200-token prefill
// neither: 0.16 GFLOP and 1.8 MB are well under a microsecond of the card,
// so the kernel is bound by the latency of its key loop.
//
// bf16, hd <= 128 (every full-width config): FlashAttention-2 on the
// tensor cores.  One block of FA_MMA_WARPS = 2 warps takes FA_MMA_BQ = 32
// query rows of one head, each warp 16 rows, so qwen2.5-3b's
// (1, 200, 16, 128) prefill is 7 x 16 = 112 blocks, one per SM with 20
// SMs left (64 rows a block would leave 68 idle; 16 rows a block would
// load every K/V tile twice as often for the same critical path, which is
// the last query tile's walk over all keys).  Per 64-key tile:
//   * K and V arrive by cp.async, 16 bytes a thread, into a ring of three
//     bf16 tile stages (row pitch hd_pad + 8 elements, an odd multiple of
//     16 bytes, so every ldmatrix phase hits eight distinct bank groups),
//     so two tiles are in flight while one is multiplied: at a 200-token
//     prefill the walk is four tiles and the copies, not the products, set
//     its length.  One __syncthreads a tile both publishes a stage and
//     frees the one the next copy refills.
//   * S = Q K^T on mma.sync.m16n8k16 (bf16 in, float32 out): Q's fragments
//     are loaded once by ldmatrix and stay in registers, K's by ldmatrix.
//   * the online softmax runs on S in registers (exp2 with the scale and
//     log2 e folded in); masked scores are -inf by select; each thread owns
//     two rows and reduces their max over its quad by shuffles.
//   * P is rounded to bf16 straight from the score registers into the A
//     fragments of O += P V (the plain version rounds its probabilities to
//     the value dtype too); V's fragments come from ldmatrix.trans.
//   * the running max, sum and the (16, hd_pad) output accumulator stay in
//     registers for the whole key loop; nothing float32 is staged.
// hd is padded to a multiple of 16 with zeros in shared memory (cp.async's
// zero fill), so hd 8, 16, 64, 80 and 128 all run the tensor cores.  Rows
// that are not 16-byte aligned fall back to element loads into the same
// tiles.  Left for wgmma + TMA: at long prompts the products dominate and
// mma.sync reaches about two thirds of the tensor cores' rate; a producer
// warp with TMA and warpgroup consumers on 64-row tiles is the next step.
//
// float32 (and bf16 with hd > 128): exact float32 FMA from shared memory,
// no TF32: one block per (32 query rows, head, row) keeps its queries and
// the running (m, l, acc) in shared memory.  The float32 smoke configs
// hold their kernel streams equal to the CPU's plain streams through it.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------- float32

constexpr int FA_BQ = 32;       // query rows per block
constexpr int FA_BK = 64;       // keys per shared-memory tile
constexpr int FA_THREADS = 128;
static_assert(FA_BK == 64, "softmax pass reads two columns per lane");
static_assert(FA_BQ % 16 == 0 && FA_THREADS == 128, "score tiling");

template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_kernel(
    const T* __restrict__ q, long long q_sb, long long q_ss, long long q_sh,
    const T* __restrict__ k, const T* __restrict__ v, long long kv_sb,
    long long kv_ss, long long kv_sh, T* __restrict__ out, long long o_sb,
    long long o_ss, long long o_sh, int Sq, int Sk, int H, int KV, int hd,
    int causal, int window, float scale) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hdp = hd + 1;
  constexpr int SSP = FA_BK + 1;
  constexpr int ROWS_PER_WARP = FA_BQ / (FA_THREADS / 32);

  extern __shared__ float smem[];
  float* qs = smem;                   // FA_BQ * hdp, pre-scaled queries
  float* kvs = qs + FA_BQ * hdp;      // FA_BK * hdp, K then V tile
  float* ss = kvs + FA_BK * hdp;      // FA_BQ * SSP, scores then probs
  float* acc = ss + FA_BQ * SSP;      // FA_BQ * hd
  float* m_s = acc + FA_BQ * hd;      // FA_BQ
  float* l_s = m_s + FA_BQ;           // FA_BQ
  float* a_s = l_s + FA_BQ;           // FA_BQ

  const int q0 = qt * FA_BQ;
  const int nq = min(FA_BQ, Sq - q0);
  const T* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < FA_BQ * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    qs[r * hdp + d] =
        r < nq ? to_f32(qb[(long long)(q0 + r) * q_ss + d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  for (int i = tid; i < FA_BQ; i += blockDim.x) {
    m_s[i] = RT_NEG;
    l_s[i] = 0.f;
  }
  // keys any row of this tile can see: causal stops at the last row, a
  // window starts past the first row's reach
  const int k_end = causal ? min(Sk, q0 + nq) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / FA_BK) * FA_BK;
  __syncthreads();

  const T* kb = k + b * kv_sb + kvh * kv_sh;
  const T* vb = v + b * kv_sb + kvh * kv_sh;
  for (int k0 = k_begin; k0 < k_end; k0 += FA_BK) {
    const int nk = min(FA_BK, Sk - k0);
    for (int i = tid; i < FA_BK * hd; i += blockDim.x) {
      const int c = i / hd, d = i - c * hd;
      kvs[c * hdp + d] =
          c < nk ? to_f32(kb[(long long)(k0 + c) * kv_ss + d]) : 0.f;
    }
    __syncthreads();
    {  // scores: thread owns rows rr + 16 i and columns cc + 8 j
      const int rr = tid >> 3, cc = tid & 7;
      float sacc[FA_BQ / 16][FA_BK / 8];
#pragma unroll
      for (int i = 0; i < FA_BQ / 16; ++i)
#pragma unroll
        for (int j = 0; j < FA_BK / 8; ++j) sacc[i][j] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float qv[FA_BQ / 16], kv[FA_BK / 8];
#pragma unroll
        for (int i = 0; i < FA_BQ / 16; ++i) qv[i] = qs[(rr + 16 * i) * hdp + d];
#pragma unroll
        for (int j = 0; j < FA_BK / 8; ++j) kv[j] = kvs[(cc + 8 * j) * hdp + d];
#pragma unroll
        for (int i = 0; i < FA_BQ / 16; ++i)
#pragma unroll
          for (int j = 0; j < FA_BK / 8; ++j)
            sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < FA_BQ / 16; ++i)
#pragma unroll
        for (int j = 0; j < FA_BK / 8; ++j) {
          const int r = rr + 16 * i, c = cc + 8 * j;
          const int qp = q0 + r, kp = k0 + c;
          bool ok = r < nq && c < nk;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          ss[r * SSP + c] = ok ? sacc[i][j] : RT_NEG_INF;
        }
    }
    __syncthreads();
    for (int r = warp * ROWS_PER_WARP; r < (warp + 1) * ROWS_PER_WARP; ++r) {
      float* sr = ss + r * SSP;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float mx = warp_max(fmaxf(s0, s1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // masked scores are -inf: their probability is exactly 0
      const float p0 = s0 == RT_NEG_INF ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == RT_NEG_INF ? 0.f : expf(s1 - m_new);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < FA_BK * hd; i += blockDim.x) {
      const int c = i / hd, d = i - c * hd;
      kvs[c * hdp + d] =
          c < nk ? to_f32(vb[(long long)(k0 + c) * kv_ss + d]) : 0.f;
    }
    __syncthreads();
    for (int r = warp * ROWS_PER_WARP; r < (warp + 1) * ROWS_PER_WARP; ++r) {
      const float* pr = ss + r * SSP;
      const float alpha = a_s[r];
      for (int d = lane; d < hd; d += 32) {
        float o = 0.f;
        for (int c = 0; c < nk; ++c) o = fmaf(pr[c], kvs[c * hdp + d], o);
        acc[r * hd + d] = acc[r * hd + d] * alpha + o;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < FA_BQ * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    if (r < nq)
      out[b * o_sb + (long long)(q0 + r) * o_ss + h * o_sh + d] =
          from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

size_t fma_smem_bytes(int hd) {
  return (size_t)(FA_BQ * (hd + 1) + FA_BK * (hd + 1) + FA_BQ * (FA_BK + 1) +
                  FA_BQ * hd + 3 * FA_BQ) *
         sizeof(float);
}

// ------------------------------------------------------- bf16 tensor cores

constexpr int FA_MMA_WARPS = 2;
constexpr int FA_MMA_BQ = 16 * FA_MMA_WARPS;  // query rows per block
constexpr int FA_MMA_BK = 64;                 // keys per tile
constexpr int FA_MMA_STAGES = 3;              // K/V ring depth
constexpr int FA_MMA_MAX_HD = 128;
static_assert(FA_MMA_BK % 16 == 0, "P V steps over 16 keys");

// row pitch of a shared tile, in bf16 elements
__host__ __device__ constexpr int mma_pitch(int hdp) { return hdp + 8; }
size_t mma_smem_bytes(int hdp) {
  return (size_t)(FA_MMA_BQ + 2 * FA_MMA_STAGES * FA_MMA_BK) *
         mma_pitch(hdp) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 float32.  Not
// volatile: it touches registers only, so the compiler may interleave
// independent products (ldmatrix stays volatile: it reads shared memory).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<unsigned*>(&v);
}

// Copy rows [r0, r0 + NROWS) of a (·, hd) bf16 operand (row stride rs, in
// elements) into a (NROWS, HDP) shared tile of pitch mma_pitch(HDP): rows
// past n_valid and columns past hd are zeros.  vec: every row starts on a
// 16-byte boundary and hd % 8 == 0, so 16-byte cp.async copies apply.  A
// rolled loop: on an H100 it issued faster than an unrolled one whose
// addresses were hoisted (its copies then leave the SM back to back).
template <int HDP, int NTHREADS, int NROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int r0, int n_valid,
                                          int hd, bool vec) {
  constexpr int CH = HDP / 8;  // 16-byte chunks a row
  constexpr int P = mma_pitch(HDP);
  for (int i = threadIdx.x; i < NROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = i - r * CH;
    const int d = c * 8;
    __nv_bfloat16* to = dst + r * P + d;
    const bool row_ok = r < n_valid;
    const __nv_bfloat16* from = src + (row_ok ? (long long)(r0 + r) * rs : 0);
    if (vec) {
      cp_async16(to, from + (d < hd ? d : 0), row_ok && d < hd ? 16 : 0);
    } else {
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = row_ok && d + 2 * e < hd
                             ? __bfloat162float(from[d + 2 * e])
                             : 0.f;
        const float hi = row_ok && d + 2 * e + 1 < hd
                             ? __bfloat162float(from[d + 2 * e + 1])
                             : 0.f;
        w[e] = pack_bf16(lo, hi);  // exact: bf16 values round to themselves
      }
      *reinterpret_cast<uint4*>(to) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(32 * FA_MMA_WARPS) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, long long q_sb, long long q_ss,
    long long q_sh, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, long long kv_sb, long long kv_ss,
    long long kv_sh, __nv_bfloat16* __restrict__ out, long long o_sb,
    long long o_ss, long long o_sh, int Sq, int Sk, int H, int KV, int hd,
    int causal, int window, float scale_log2, int vec_q, int vec_kv) {
  constexpr int NT = 32 * FA_MMA_WARPS;
  constexpr int P = mma_pitch(HDP);
  constexpr int KSTEPS = HDP / 16;     // k-steps of Q K^T
  constexpr int NTILES = FA_MMA_BK / 8;  // 8-key column tiles of S
  constexpr int DTILES = HDP / 8;      // 8-column tiles of O
  constexpr int NS = FA_MMA_STAGES;
  static_assert(HDP % 16 == 0, "hd is padded to a multiple of 16");

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + FA_MMA_BQ * P;            // [stage][BK][P]
  __nv_bfloat16* vs = ks + NS * FA_MMA_BK * P;

  const int q0 = qt * FA_MMA_BQ;
  const int nq = min(FA_MMA_BQ, Sq - q0);
  const int k_end = causal ? min(Sk, q0 + nq) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / FA_MMA_BK) * FA_MMA_BK;
  const int ntiles =
      k_end > k_begin ? (k_end - k_begin + FA_MMA_BK - 1) / FA_MMA_BK : 0;

  const __nv_bfloat16* kb = k + b * kv_sb + kvh * kv_sh;
  const __nv_bfloat16* vb = v + b * kv_sb + kvh * kv_sh;
  auto issue_kv = [&](int t) {
    const int k0 = k_begin + t * FA_MMA_BK, st = t % NS;
    const int nk = min(FA_MMA_BK, Sk - k0);
    load_tile<HDP, NT, FA_MMA_BK>(ks + st * FA_MMA_BK * P, kb, kv_ss, k0, nk,
                                  hd, vec_kv);
    load_tile<HDP, NT, FA_MMA_BK>(vs + st * FA_MMA_BK * P, vb, kv_ss, k0, nk,
                                  hd, vec_kv);
  };

  load_tile<HDP, NT, FA_MMA_BQ>(qs, q + b * q_sb + h * q_sh, q_ss, q0, nq, hd,
                                vec_q);
  // one commit group a tile (the first also holds Q), NS - 1 in flight
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) issue_kv(t);
    cp_async_commit();
  }
  cp_async_wait<NS - 2>();  // Q and tile 0 landed
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, for the whole key loop
  unsigned qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 P + kk * 16 + (lane >> 4) * 8);

  float o[DTILES][4];
#pragma unroll
  for (int n = 0; n < DTILES; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {RT_NEG, RT_NEG}, l_run[2] = {0.f, 0.f};
  const int qp0 = q0 + warp * 16 + gid;  // this thread's rows: qp0, qp0 + 8

  for (int t = 0; t < ntiles; ++t) {
    if (t > 0) {
      cp_async_wait<NS - 2>();  // tile t landed
      __syncthreads();  // ... for every thread; tile t - 1's stage is free
    }
    if (t + NS - 1 < ntiles) issue_kv(t + NS - 1);  // into t - 1's stage
    cp_async_commit();
    const int st = t % NS;
    const __nv_bfloat16* kt = ks + st * FA_MMA_BK * P;
    const __nv_bfloat16* vt = vs + st * FA_MMA_BK * P;
    const int k0 = k_begin + t * FA_MMA_BK;

    float s[NTILES][4];
#pragma unroll
    for (int j = 0; j < NTILES; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // k-steps outside: the NTILES accumulators are independent chains
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int j = 0; j < NTILES; j += 2) {
        unsigned bfr[4];
        ldmatrix_x4(bfr, kt + (j * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                             kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], qf[kk], bfr[0], bfr[1]);
        mma_bf16(s[j + 1], qf[kk], bfr[2], bfr[3]);
      }

    // mask by select, scale into the log2 domain, running max per row
    float mx[2] = {RT_NEG_INF, RT_NEG_INF};
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = qp0 + (e >> 1) * 8;
        const int kp = k0 + j * 8 + 2 * tig + (e & 1);
        bool ok = qp < q0 + nq && kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[j][e] = ok ? s[j][e] * scale_log2 : RT_NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NTILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_run[e >> 1]);  // -inf -> exactly 0
        l_run[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < DTILES; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V over 16 keys a step; P's A fragments straight from S
#pragma unroll
    for (int kk = 0; kk < FA_MMA_BK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DTILES; n += 2) {
        unsigned bfr[4];
        ldmatrix_x4_trans(
            bfr, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                     n * 8 + (lane >> 4) * 8);
        mma_bf16(o[n], pa, bfr[0], bfr[1]);
        mma_bf16(o[n + 1], pa, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit (ntiles == 0 leaves Q)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = 1.f / fmaxf(l_run[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qp0 + r * 8;
    if (qp >= q0 + nq) continue;
    __nv_bfloat16* orow = out + b * o_sb + (long long)qp * o_ss + h * o_sh;
#pragma unroll
    for (int n = 0; n < DTILES; ++n) {
      const int d = n * 8 + 2 * tig;
      if (d < hd) orow[d] = __float2bfloat16_rn(o[n][2 * r] * l_run[r]);
      if (d + 1 < hd)
        orow[d + 1] = __float2bfloat16_rn(o[n][2 * r + 1] * l_run[r]);
    }
  }
}

int round16(int hd) { return (hd + 15) / 16 * 16; }
bool use_mma(int dtype, int hd) {
  return dtype == RT_BF16 && hd <= FA_MMA_MAX_HD;
}

template <int HDP>
cudaError_t launch_mma(const void* q, long long q_sb, long long q_ss,
                       long long q_sh, const void* k, const void* v,
                       long long kv_sb, long long kv_ss, long long kv_sh,
                       void* out, long long o_sb, long long o_ss,
                       long long o_sh, int B, int Sq, int Sk, int H, int KV,
                       int hd, int causal, int window, int vec_q, int vec_kv,
                       cudaStream_t stream) {
  static size_t granted[RT_MAX_DEVICES] = {};
  const size_t smem = mma_smem_bytes(HDP);
  cudaError_t err = rt_allow_smem(flash_mma_kernel<HDP>, smem, granted);
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  const dim3 grid((Sq + FA_MMA_BQ - 1) / FA_MMA_BQ, H, B);
  flash_mma_kernel<HDP><<<grid, 32 * FA_MMA_WARPS, smem, stream>>>(
      (const __nv_bfloat16*)q, q_sb, q_ss, q_sh, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, kv_sb, kv_ss, kv_sh, (__nv_bfloat16*)out, o_sb,
      o_ss, o_sh, Sq, Sk, H, KV, hd, causal, window, scale_log2, vec_q,
      vec_kv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_flash(const void* q, long long q_sb, long long q_ss,
                         long long q_sh, const void* k, const void* v,
                         long long kv_sb, long long kv_ss, long long kv_sh,
                         void* out, long long o_sb, long long o_ss,
                         long long o_sh, int B, int Sq, int Sk, int H, int KV,
                         int hd, int causal, int window,
                         cudaStream_t stream) {
  static size_t granted[RT_MAX_DEVICES] = {};
  const size_t smem = fma_smem_bytes(hd);
  cudaError_t err = rt_allow_smem(flash_kernel<T>, smem, granted);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)hd);
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
  flash_kernel<T><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, q_sb, q_ss, q_sh, (const T*)k, (const T*)v, kv_sb, kv_ss,
      kv_sh, (T*)out, o_sb, o_ss, o_sh, Sq, Sk, H, KV, hd, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes, for this dtype and hd
// (the Python wrapper mirrors it in flash_attention.smem_bytes).
extern "C" long long rt_flash_smem_bytes(int dtype, int hd) {
  return (long long)(use_mma(dtype, hd) ? mma_smem_bytes(round16(hd))
                                        : fma_smem_bytes(hd));
}

extern "C" int rt_flash_attention(
    int device, const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, const void* v, long long kv_sb, long long kv_ss,
    long long kv_sh, void* out, long long o_sb, long long o_ss,
    long long o_sh, int dtype, int B, int Sq, int Sk, int H, int KV, int hd,
    int causal, int window, int vec_q, int vec_kv, void* stream) {
  RtDevice on(device);
  if (on.status() != cudaSuccess) return (int)on.status();
  cudaStream_t st = (cudaStream_t)stream;
  if (use_mma(dtype, hd)) {
#define RT_FA_MMA(HDP)                                                       \
  case HDP:                                                                  \
    return launch_mma<HDP>(q, q_sb, q_ss, q_sh, k, v, kv_sb, kv_ss, kv_sh,   \
                           out, o_sb, o_ss, o_sh, B, Sq, Sk, H, KV, hd,      \
                           causal, window, vec_q, vec_kv, st);
    switch (round16(hd)) {
      RT_FA_MMA(16)
      RT_FA_MMA(32)
      RT_FA_MMA(48)
      RT_FA_MMA(64)
      RT_FA_MMA(80)
      RT_FA_MMA(96)
      RT_FA_MMA(112)
      RT_FA_MMA(128)
    }
#undef RT_FA_MMA
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case RT_F32:
      return launch_flash<float>(q, q_sb, q_ss, q_sh, k, v, kv_sb, kv_ss,
                                 kv_sh, out, o_sb, o_ss, o_sh, B, Sq, Sk, H,
                                 KV, hd, causal, window, st);
    case RT_BF16:
      return launch_flash<__nv_bfloat16>(q, q_sb, q_ss, q_sh, k, v, kv_sb,
                                         kv_ss, kv_sh, out, o_sb, o_ss, o_sh,
                                         B, Sq, Sk, H, KV, hd, causal, window,
                                         st);
  }
  return (int)cudaErrorInvalidValue;
}
