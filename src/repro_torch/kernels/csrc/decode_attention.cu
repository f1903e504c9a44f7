// K1 decode attention, K2 ring-slot cache write, K5 paged decode attention
// and K6 paged cache write, for Hopper (sm_90a).
//
// K1 replaces repro/kernels/decode_attention.py::decode_attention_bkgd
// (_decode_kernel): one query token per row attends, GQA, over that row's
// live ring slots (slot <= index[b]; every slot once index >= Smax), online
// softmax in float32, scale hd**-0.5.  K5 replaces
// decode_attention_paged_bkgd (_decode_paged_kernel): K1 over a shared pool
// of (NB, bk, KV, hd) blocks, where logical key t of row b lives at
// pool[tbl[b, t / bk], t % bk].
//
// Bound: bytes.  Each live K/V row is read once and used for G = H/KV query
// heads, a handful of FLOPs per byte against the ~295 the card needs before
// its tensor cores limit.  At serving sizes the live K/V is a few MB (a
// microsecond at 3.35 TB/s), so what the kernel pays in practice is the
// latency of its dependent steps; the design keeps many key rows in flight
// and few steps in a row:
//   * B*KV blocks alone (16 at slots=8 on qwen2.5-3b) would leave most of
//     the 132 SMs idle, so Smax is cut into splits across blocks (split-K /
//     flash-decoding), by one plan of host-known shapes (split_plan in
//     decode_attention.py).  Splits past a row's horizon return at once.
//   * Inside a block, each warp lane holds 16 bytes of a key row (hd 128
//     bf16 = 16 lanes, hd 80 = 10 of 16), so a warp reads 32 / lanes-per-row
//     rows at once with one vector load a lane, in the model layout (or
//     through the table) and straight into registers: nothing is staged in
//     shared memory and there is no barrier in the key loop.  The G query
//     heads of the KV head sit in registers (pre-scaled by hd**-0.5 log2 e,
//     so the softmax runs on exp2), the dot products reduce by shuffles
//     within the row's lanes, and each row group of lanes runs its own
//     online softmax over its keys (interleaved across the block), U rows at
//     a step with one rescale.  The next step's K and V rows are loaded
//     while this step's dot products reduce.
//   * At the end the row groups of a warp merge by shuffles and the warps
//     of a block once in shared memory, in a fixed order.  With one split
//     the block writes the output; otherwise a combine kernel, one block per
//     (row, query head) and one thread per output element, merges the
//     splits' (m, l, acc) in split order with the log-sum-exp rule.  No
//     atomics: two identical calls give bitwise-equal outputs.
//   * Keys past a row's horizon are masked by select, never by multiplying
//     with 0: rewound speculative lanes leave stale K/V there, and inactive
//     rows read the trash block; a masked lane re-reads the split's first
//     key instead of the stale row.
// K1 and K5 are ONE partial kernel templated on the key-address policy
// (dense: row base + t*stride1; paged: pool + tbl[b, t/bk]*stride0 +
// (t%bk)*stride1), with one split plan and one combine: the same keys in
// the same lanes in the same order, so under an identity table K5 equals
// K1 bitwise.  The split's slice of the table row is loaded into shared
// memory once, so any bk >= 1 is taken.  The pool is read in the model
// layout through strides (the reference wrapper's swapaxes would copy the
// whole pool twice per layer and tick), offsets are 64-bit (NB*bk*KV*hd
// passes 2^31 on large pools), and block ids must lie in [0, NB): the model
// reduces them mod NB.  float32 and bf16 share the body (16 bytes a lane
// are 4 or 8 elements); rows that are not 16-byte aligned, or an hd that is
// not a multiple of those, are read element by element into the same
// registers.
//
// K2 replaces cache_ring_update_bs (_ring_update_kernel): cache[b, slot[b]]
// = new[b], cast to the cache dtype, in place.  K6 replaces
// cache_paged_update_bs (_paged_update_kernel): cache[blk[b], off[b]] =
// new[b] in the block pool, the same body with the row address taken from
// blk[b] instead of b.  Bound: bytes (B*KV*hd elements), in practice the
// launch itself; one block per row.  Inactive slots' table rows all name
// their partition's trash block, so several rows of one K6 launch can write
// the same (trash, off): which lands is undefined, as for the reference's
// scatter, and nothing live reads the trash block.
#include "common.cuh"

namespace {

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;

// the bits of element e of a 16-byte vector of T, in its 32-bit word
template <typename T>
__device__ __forceinline__ unsigned elem_bits(const T* p, int e) {
  if constexpr (sizeof(T) == 4)
    return __float_as_uint(p[e]);
  else
    return (unsigned)__bfloat16_as_ushort(p[e]) << (16 * (e & 1));
}

// Elements [0, 16 / sizeof(T)) of a row as 16 raw bytes; zeros past
// n_valid.  vec: the row is 16-byte aligned (one vector load).
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int n_valid, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec && n_valid >= VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if (e < n_valid) w[e * 4 / VEC] |= elem_bits(p, e);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void unpack16(uint4 r, float (&f)[16 / sizeof(T)]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(w[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(w[e] << 16);
      f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

// PAGED = false: k/v are (B, Smax, KV, hd) rings, kv_sb the row stride.
// PAGED = true: k/v are (NB, bk, KV, hd) pools, kv_sb the block stride, and
// tbl (B, nk) names row b's blocks; Smax = nk * bk.
// Block (split, kvh * gchunks + gc, b) takes query heads
// kvh*G + gc*GMAX ... (at most GMAX of them) over the split's keys.
template <typename T, bool PAGED, int GMAX>
__global__ void __launch_bounds__(DEC_THREADS) decode_partial_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh,
    const T* __restrict__ k, const T* __restrict__ v, long long kv_sb,
    long long kv_ss, long long kv_sh, const int* __restrict__ tbl,
    long long tbl_sb, int bk, const int* __restrict__ index,
    T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int KV, int G, int hd, int lpr_log2,
    int Smax, int split_len, int n_splits, float scale_log2, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = GMAX >= 8 ? 2 : 4;  // key rows a lane group has in flight
  const int split = blockIdx.x, b = blockIdx.z;
  const int gchunks = (G + GMAX - 1) / GMAX;
  const int kvh = blockIdx.y / gchunks;
  const int g0 = (blockIdx.y - kvh * gchunks) * GMAX;
  const int ng = min(GMAX, G - g0);
  const int H = KV * G, h0 = kvh * G + g0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = 1 << lpr_log2;            // lanes per key row
  const int rpw = 32 >> lpr_log2;           // key rows a warp reads at once
  const int sub = lane >> lpr_log2, d0 = (lane & (lpr - 1)) * VEC;
  const int nd = hd - d0;                   // this lane's valid elements

  extern __shared__ float smem[];
  float* ml_s = smem;                          // [DEC_WARPS][GMAX][2]
  float* acc_s = ml_s + DEC_WARPS * GMAX * 2;  // [DEC_WARPS][GMAX][hd]
  int* tbl_s = (int*)(acc_s + DEC_WARPS * GMAX * hd);  // PAGED: split's ids

  // q's loads first: they do not wait on the index
  float qv[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (g < ng && nd > 0)
      raw = load16(q + b * q_sb + (long long)(h0 + g) * q_sh + d0, nd, vec);
    unpack16<T>(raw, qv[g]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[g][e] *= scale_log2;
  }

  const int idx = index[b];
  const int n_live = idx < Smax ? idx + 1 : Smax;
  const int lo = split * split_len;
  const int hi = min(lo + split_len, n_live);
  const long long prow = (long long)b * H + h0;  // (b, h0) row of out/parts
  if (lo >= hi) {  // the whole split lies past this row's horizon
    for (int i = tid; i < ng * hd; i += DEC_THREADS) {
      const long long r = prow + i / hd;
      if (n_splits == 1)
        out[r * hd + i % hd] = from_f32<T>(0.f);
      else
        part_acc[(r * n_splits + split) * hd + i % hd] = 0.f;
    }
    if (n_splits > 1)
      for (int g = tid; g < ng; g += DEC_THREADS) {
        part_ml[((prow + g) * n_splits + split) * 2] = RT_NEG;
        part_ml[((prow + g) * n_splits + split) * 2 + 1] = 0.f;
      }
    return;
  }

  const int first = PAGED ? lo / bk : 0;
  if constexpr (PAGED) {
    for (int i = tid; i <= (hi - 1) / bk - first; i += DEC_THREADS)
      tbl_s[i] = tbl[b * tbl_sb + first + i];
    __syncthreads();
  }
  // key-address policy: the offset of key t's row in k and v, plus d0
  const long long base =
      (PAGED ? 0 : (long long)b * kv_sb) + (long long)kvh * kv_sh + d0;
  auto key_row = [&](int t) -> long long {
    if constexpr (PAGED)
      return base + (long long)tbl_s[t / bk - first] * kv_sb +
             (long long)(t % bk) * kv_ss;
    else
      return base + (long long)t * kv_ss;
  };

  float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = RT_NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // keys are dealt to lane groups in turn: group (warp, sub) takes
  // lo + warp*rpw + sub + i*stride; a step takes U of them
  const int stride = DEC_WARPS * rpw;
  const int step = U * stride;
  auto load_rows = [&](const T* src, int kbase, uint4 (&r)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = kbase + sub + u * stride;
      r[u] = make_uint4(0u, 0u, 0u, 0u);
      if (nd > 0) r[u] = load16(src + key_row(t < hi ? t : lo), nd, vec);
    }
  };
  uint4 kr[U], vr[U];
  int kbase = lo + warp * rpw;
  if (kbase < hi) {
    load_rows(k, kbase, kr);
    load_rows(v, kbase, vr);
  }
  for (; kbase < hi; kbase += step) {  // warp-uniform: shuffles below
    uint4 kn[U], vn[U];  // the next step's rows, in flight meanwhile
    if (kbase + step < hi) {
      load_rows(k, kbase + step, kn);
      load_rows(v, kbase + step, vn);
    }

    float s[U][GMAX];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      unpack16<T>(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[g][e], kf[e], dot);
        s[u][g] = dot;
      }
    }
    for (int off = 1; off < lpr; off <<= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);

#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (kbase + sub + u * stride >= hi) s[u][g] = RT_NEG_INF;
        mx = fmaxf(mx, s[u][g]);
      }
      const float alpha = exp2f(m[g] - mx);
      m[g] = mx;
      float p[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = exp2f(s[u][g] - mx);  // masked: exp2(-inf) = 0
        psum += p[u];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[VEC];
        unpack16<T>(vr[u], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p[u], vf[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // merge the warp's lane groups (butterfly over the group index)
  for (int off = lpr; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], mo);
      const float wa = exp2f(m[g] - M), wb = exp2f(mo - M);
      m[g] = M;
      l[g] = l[g] * wa + lo_ * wb;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * wa + ao * wb;
      }
    }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= ng) break;
      if (lane == 0) {
        ml_s[(warp * GMAX + g) * 2] = m[g];
        ml_s[(warp * GMAX + g) * 2 + 1] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (e < nd) acc_s[(warp * GMAX + g) * hd + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  // merge the block's warps in warp order
  for (int i = tid; i < ng * hd; i += DEC_THREADS) {
    const int g = i / hd, d = i - g * hd;
    float M = RT_NEG;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, ml_s[(w * GMAX + g) * 2]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float wt = exp2f(ml_s[(w * GMAX + g) * 2] - M);
      L += wt * ml_s[(w * GMAX + g) * 2 + 1];
      o += wt * acc_s[(w * GMAX + g) * hd + d];
    }
    const long long r = prow + g;
    if (n_splits == 1) {
      out[r * hd + d] = from_f32<T>(o / fmaxf(L, 1e-30f));
    } else {
      part_acc[(r * n_splits + split) * hd + d] = o;
      if (d == 0) {
        part_ml[(r * n_splits + split) * 2] = M;
        part_ml[(r * n_splits + split) * 2 + 1] = L;
      }
    }
  }
}

// One block per (query head, row), one thread per output element: the
// splits' (m, l) pairs are read once into shared memory, their weights
// exp2(m_s - M) computed once, and every element sums its splits in split
// order.  An empty split has m = RT_NEG and l = acc = 0.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int H, int hd,
                                      int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long r = (long long)b * H + h;
  extern __shared__ float cs[];
  float* ml = cs;                 // [n_splits][2]
  float* w = cs + 2 * n_splits;   // [n_splits]
  for (int i = threadIdx.x; i < 2 * n_splits; i += blockDim.x)
    ml[i] = part_ml[r * n_splits * 2 + i];
  __syncthreads();
  float M = RT_NEG;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, ml[2 * s]);
  for (int s = threadIdx.x; s < n_splits; s += blockDim.x)
    w[s] = exp2f(ml[2 * s] - M);
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < n_splits; ++s) L += w[s] * ml[2 * s + 1];
  const float inv = 1.f / fmaxf(L, 1e-30f);
  const float* pa = part_acc + r * n_splits * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) o = fmaf(w[s], pa[s * hd + d], o);
    out[r * hd + d] = from_f32<T>(o * inv);
  }
}

template <typename T, bool PAGED, int GMAX>
cudaError_t launch_decode(const void* q, long long q_sb, long long q_sh,
                          const void* k, const void* v, long long kv_sb,
                          long long kv_ss, long long kv_sh, const int* tbl,
                          long long tbl_sb, int bk, const int* index,
                          void* out, float* part_acc, float* part_ml, int B,
                          int KV, int G, int hd, int lpr_log2, int Smax,
                          int split_len, int n_splits, int vec,
                          cudaStream_t stream) {
  static size_t granted = 0;
  // a split of split_len keys spans at most split_len / bk + 2 blocks
  const int n_tbl = PAGED ? split_len / bk + 2 : 0;
  const size_t smem = (size_t)DEC_WARPS * GMAX * (hd + 2) * sizeof(float) +
                      (size_t)n_tbl * sizeof(int);
  cudaError_t err =
      rt_allow_smem(decode_partial_kernel<T, PAGED, GMAX>, smem, &granted);
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  const int gchunks = (G + GMAX - 1) / GMAX;
  decode_partial_kernel<T, PAGED, GMAX>
      <<<dim3(n_splits, KV * gchunks, B), DEC_THREADS, smem, stream>>>(
          (const T*)q, q_sb, q_sh, (const T*)k, (const T*)v, kv_sb, kv_ss,
          kv_sh, tbl, tbl_sb, bk, index, (T*)out, part_acc, part_ml, KV, G,
          hd, lpr_log2, Smax, split_len, n_splits, scale_log2, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  const int threads = min(256, max(32, (hd + 31) / 32 * 32));
  decode_combine_kernel<T><<<dim3(KV * G, B), threads,
                             3 * n_splits * sizeof(float), stream>>>(
      part_acc, part_ml, (T*)out, KV * G, hd, n_splits);
  return cudaGetLastError();
}

// cache[r, s] = src[b] for r = blk[b] (K6) or b (K2, blk == nullptr), s =
// pos[b]; a row whose (r, s) falls outside (n0, n1) is dropped, like an
// out-of-range scatter.  Each (KV*hd,) row is contiguous.
template <typename TC, typename TN>
__global__ void row_update_kernel(TC* __restrict__ cache, long long c_s0,
                                  long long c_s1, const TN* __restrict__ src,
                                  long long n_sb,
                                  const int* __restrict__ blk,
                                  const int* __restrict__ pos, int n0, int n1,
                                  int row) {
  const int b = blockIdx.x;
  const int r = blk == nullptr ? b : blk[b];
  const int s = pos[b];
  if (r < 0 || r >= n0 || s < 0 || s >= n1) return;
  TC* dst = cache + (long long)r * c_s0 + (long long)s * c_s1;
  const TN* in = src + b * n_sb;
  for (int i = threadIdx.x; i < row; i += blockDim.x)
    dst[i] = from_f32<TC>(to_f32(in[i]));
}

template <typename TC>
cudaError_t launch_rows(void* cache, long long c_s0, long long c_s1,
                        const void* src, int src_dtype, long long n_sb,
                        const int* blk, const int* pos, int B, int n0, int n1,
                        int row, cudaStream_t stream) {
  const int threads = row < 256 ? ((row + 31) / 32) * 32 : 256;
  switch (src_dtype) {
    case RT_F32:
      row_update_kernel<TC, float><<<B, threads, 0, stream>>>(
          (TC*)cache, c_s0, c_s1, (const float*)src, n_sb, blk, pos, n0, n1,
          row);
      break;
    case RT_BF16:
      row_update_kernel<TC, __nv_bfloat16><<<B, threads, 0, stream>>>(
          (TC*)cache, c_s0, c_s1, (const __nv_bfloat16*)src, n_sb, blk, pos,
          n0, n1, row);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, bool PAGED>
cudaError_t launch_decode_g(const void* q, long long q_sb, long long q_sh,
                            const void* k, const void* v, long long kv_sb,
                            long long kv_ss, long long kv_sh, const int* tbl,
                            long long tbl_sb, int bk, const int* index,
                            void* out, float* part_acc, float* part_ml, int B,
                            int KV, int G, int hd, int gmax, int lpr_log2,
                            int Smax, int split_len, int n_splits, int vec,
                            cudaStream_t stream) {
#define RT_DEC_G(GM)                                                          \
  case GM:                                                                    \
    return launch_decode<T, PAGED, GM>(                                       \
        q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sh, tbl, tbl_sb, bk, index, out, \
        part_acc, part_ml, B, KV, G, hd, lpr_log2, Smax, split_len, n_splits, \
        vec, stream);
  switch (gmax) {
    RT_DEC_G(1)
    RT_DEC_G(2)
    RT_DEC_G(4)
    RT_DEC_G(8)
  }
#undef RT_DEC_G
  return cudaErrorInvalidValue;
}

template <bool PAGED>
int decode_entry(const void* q, long long q_sb, long long q_sh, const void* k,
                 const void* v, long long kv_sb, long long kv_ss,
                 long long kv_sh, const int* tbl, long long tbl_sb, int bk,
                 const int* index, void* out, float* part_acc,
                 float* part_ml, int dtype, int B, int KV, int G, int hd,
                 int gmax, int lpr_log2, int Smax, int split_len,
                 int n_splits, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case RT_F32:
      return launch_decode_g<float, PAGED>(
          q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sh, tbl, tbl_sb, bk, index,
          out, part_acc, part_ml, B, KV, G, hd, gmax, lpr_log2, Smax,
          split_len, n_splits, vec, st);
    case RT_BF16:
      return launch_decode_g<__nv_bfloat16, PAGED>(
          q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sh, tbl, tbl_sb, bk, index,
          out, part_acc, part_ml, B, KV, G, hd, gmax, lpr_log2, Smax,
          split_len, n_splits, vec, st);
  }
  return (int)cudaErrorInvalidValue;
}

int rows_entry(void* cache, int cache_dtype, long long c_s0, long long c_s1,
               const void* src, int src_dtype, long long n_sb, const int* blk,
               const int* pos, int B, int n0, int n1, int row, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (cache_dtype) {
    case RT_F32:
      return launch_rows<float>(cache, c_s0, c_s1, src, src_dtype, n_sb, blk,
                                pos, B, n0, n1, row, st);
    case RT_BF16:
      return launch_rows<__nv_bfloat16>(cache, c_s0, c_s1, src, src_dtype,
                                        n_sb, blk, pos, B, n0, n1, row, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rt_decode_attention(
    const void* q, long long q_sb, long long q_sh, const void* k,
    const void* v, long long kv_sb, long long kv_ss, long long kv_sh,
    const int* index, void* out, float* part_acc, float* part_ml, int dtype,
    int B, int KV, int G, int hd, int gmax, int lpr_log2, int Smax,
    int split_len, int n_splits, int vec, void* stream) {
  return decode_entry<false>(q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sh,
                             nullptr, 0, 1, index, out, part_acc, part_ml,
                             dtype, B, KV, G, hd, gmax, lpr_log2, Smax,
                             split_len, n_splits, vec, stream);
}

extern "C" int rt_decode_attention_paged(
    const void* q, long long q_sb, long long q_sh, const void* k,
    const void* v, long long kv_s0, long long kv_s1, long long kv_sh,
    const int* tbl, long long tbl_sb, int bk, const int* index, void* out,
    float* part_acc, float* part_ml, int dtype, int B, int KV, int G, int hd,
    int gmax, int lpr_log2, int Smax, int split_len, int n_splits, int vec,
    void* stream) {
  return decode_entry<true>(q, q_sb, q_sh, k, v, kv_s0, kv_s1, kv_sh, tbl,
                            tbl_sb, bk, index, out, part_acc, part_ml, dtype,
                            B, KV, G, hd, gmax, lpr_log2, Smax, split_len,
                            n_splits, vec, stream);
}

extern "C" int rt_cache_ring_update(void* cache, int cache_dtype,
                                    long long c_sb, long long c_ss,
                                    const void* src, int src_dtype,
                                    long long n_sb, const int* slot, int B,
                                    int Smax, int row, void* stream) {
  return rows_entry(cache, cache_dtype, c_sb, c_ss, src, src_dtype, n_sb,
                    nullptr, slot, B, B, Smax, row, stream);
}

extern "C" int rt_cache_paged_update(void* cache, int cache_dtype,
                                     long long c_s0, long long c_s1,
                                     const void* src, int src_dtype,
                                     long long n_sb, const int* blk,
                                     const int* off, int B, int NB, int bk,
                                     int row, void* stream) {
  return rows_entry(cache, cache_dtype, c_s0, c_s1, src, src_dtype, n_sb, blk,
                    off, B, NB, bk, row, stream);
}
