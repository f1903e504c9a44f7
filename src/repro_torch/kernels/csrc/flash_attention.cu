// K4 flash attention (prefill), for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_bhsd
// (_flash_kernel): GQA attention, causal and optionally sliding-window,
// online softmax in float32, scale hd**-0.5; query head h reads kv head
// h // G.
//
// Bound: operations at long prompts (the two products grow as Sq*Sk*hd),
// bytes at short ones.  This first version is plain float32 FMA from
// shared memory, not wgmma: one block per (q tile of FA_BQ rows, head,
// batch row) keeps its queries and the running (m, l, acc) in shared
// memory and walks K/V tiles only inside the causal / window horizon, so
// fully masked tiles cost nothing, as in the TPU kernel's tile skip.
// Inputs are read in the model layout (B, S, H, hd) / (B, S, KV, hd)
// through strides; any Sq, Sk and hd are taken, the ragged edge masked.
#include "common.cuh"

namespace {

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

template <typename T>
cudaError_t launch_flash(const void* q, long long q_sb, long long q_ss,
                         long long q_sh, const void* k, const void* v,
                         long long kv_sb, long long kv_ss, long long kv_sh,
                         void* out, long long o_sb, long long o_ss,
                         long long o_sh, int B, int Sq, int Sk, int H, int KV,
                         int hd, int causal, int window,
                         cudaStream_t stream) {
  static size_t granted = 0;
  const size_t smem = (size_t)(FA_BQ * (hd + 1) + FA_BK * (hd + 1) +
                               FA_BQ * (FA_BK + 1) + FA_BQ * hd + 3 * FA_BQ) *
                      sizeof(float);
  cudaError_t err = rt_allow_smem(flash_kernel<T>, smem, &granted);
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

extern "C" int rt_flash_attention(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, const void* v, long long kv_sb, long long kv_ss,
    long long kv_sh, void* out, long long o_sb, long long o_ss,
    long long o_sh, int dtype, int B, int Sq, int Sk, int H, int KV, int hd,
    int causal, int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
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
