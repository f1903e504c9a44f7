// K1 decode attention, K2 ring-slot cache write, K5 paged decode attention
// and K6 paged cache write, for Hopper (sm_90a).
//
// K1 replaces repro/kernels/decode_attention.py::decode_attention_bkgd
// (_decode_kernel): one query token per row attends, GQA, over that row's
// live ring slots (slot <= index[b]; every slot once index >= Smax), online
// softmax in float32, scale hd**-0.5.
//
// Bound: bytes.  Each live K/V row is read once and used for G = H/KV query
// heads, a handful of FLOPs per byte against the ~295 the card needs before
// its tensor cores limit.  The TPU kernel walks K blocks one after another
// in VMEM; here B*KV blocks alone (16 at slots=8 on qwen2.5-3b) would leave
// most of the 132 SMs idle, so the Smax range is split across blocks
// (split-K / flash-decoding): pass 1 writes per-split partial (m, l, acc),
// pass 2 merges them with the log-sum-exp rule.  Splits past a row's
// horizon return at once, so a short row reads only its own live slots.
// The caches are read in the model layout (B, Smax, KV, hd) through
// strides: no transposed copy of the cache per layer and tick.  Any Smax is
// taken; the ragged last tile is cut at the live range.
//
// K5 replaces decode_attention_paged_bkgd (_decode_paged_kernel): K1 over a
// shared pool of (NB, bk, KV, hd) blocks, where logical key t of row b lives
// at pool[tbl[b, t / bk], t % bk].  Bound: bytes, as K1 (live K/V rows plus
// the table).  K1 and K5 are ONE partial kernel templated on the key-address
// policy (dense: row base + t*stride1; paged: pool + tbl[b, t/bk]*stride0 +
// (t%bk)*stride1), with one split plan and one combine kernel: the same
// tiles, the same accumulation order, so under an identity table K5 equals
// K1 bitwise.  The split's slice of the table row is loaded into shared
// memory once, and every key row looks its block up there, so any bk >= 1
// (one that does not divide the 64-key tile too) and any nk are taken.  The
// pool is read in the model layout through strides (the reference wrapper's
// swapaxes would copy the whole pool twice per layer and tick), offsets are
// 64-bit (NB*bk*KV*hd passes 2^31 on large pools), and keys past a row's
// horizon are masked by select, never by multiplying with 0: rewound
// speculative lanes leave stale K/V there, and inactive rows read the trash
// block.  Block ids must lie in [0, NB): the model reduces them mod NB.
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

constexpr int DEC_THREADS = 128;
constexpr int DEC_TILE = 64;  // keys staged in shared memory at a time

// PAGED = false: k/v are (B, Smax, KV, hd) rings, kv_sb the row stride.
// PAGED = true: k/v are (NB, bk, KV, hd) pools, kv_sb the block stride, and
// tbl (B, nk) names row b's blocks; Smax = nk * bk.
template <typename T, bool PAGED>
__global__ void __launch_bounds__(DEC_THREADS) decode_partial_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh,
    const T* __restrict__ k, const T* __restrict__ v, long long kv_sb,
    long long kv_ss, long long kv_sh, const int* __restrict__ tbl,
    long long tbl_sb, int bk, const int* __restrict__ index,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int KV, int G,
    int hd, int Smax, int split_len, int n_splits, float scale) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int hdp = hd + 1;  // padded row: conflict-free column reads

  extern __shared__ float smem[];
  float* qs = smem;                   // G * hd, pre-scaled query heads
  float* kvs = qs + G * hd;           // DEC_TILE * hdp, K then V tile
  float* ss = kvs + DEC_TILE * hdp;   // G * DEC_TILE, scores then probs
  float* acc = ss + G * DEC_TILE;     // G * hd
  float* m_s = acc + G * hd;          // G running max
  float* l_s = m_s + G;               // G running sum
  float* a_s = l_s + G;               // G rescale of this tile
  int* tbl_s = (int*)(a_s + G);       // PAGED: the split's block ids

  const long long pbase = ((long long)b * KV + kvh) * n_splits + split;
  float* pacc = part_acc + pbase * G * hd;
  float* pml = part_ml + pbase * G * 2;

  const int idx = index[b];
  const int n_live = idx < Smax ? idx + 1 : Smax;
  const int lo = split * split_len;
  const int hi = min(lo + split_len, n_live);
  if (lo >= hi) {  // the whole split lies past this row's horizon
    for (int i = tid; i < G; i += blockDim.x) {
      pml[2 * i] = RT_NEG;
      pml[2 * i + 1] = 0.f;
    }
    for (int i = tid; i < G * hd; i += blockDim.x) pacc[i] = 0.f;
    return;
  }

  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    qs[i] = to_f32(q[b * q_sb + (long long)(kvh * G + g) * q_sh + d]) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < G; i += blockDim.x) {
    m_s[i] = RT_NEG;
    l_s[i] = 0.f;
  }
  // key-address policy: the offset of key t's (hd,) row in k and v
  const int first = lo / (PAGED ? bk : 1);
  if constexpr (PAGED) {
    for (int i = tid; i <= (hi - 1) / bk - first; i += blockDim.x)
      tbl_s[i] = tbl[b * tbl_sb + first + i];
  }
  __syncthreads();

  const long long base =
      (PAGED ? 0 : (long long)b * kv_sb) + (long long)kvh * kv_sh;
  auto key_row = [&](int t) -> long long {
    if constexpr (PAGED)
      return base + (long long)tbl_s[t / bk - first] * kv_sb +
             (long long)(t % bk) * kv_ss;
    else
      return base + (long long)t * kv_ss;
  };
  for (int t0 = lo; t0 < hi; t0 += DEC_TILE) {
    const int nt = min(DEC_TILE, hi - t0);  // every key of [lo, hi) is live
    for (int i = tid; i < nt * hd; i += blockDim.x) {
      const int c = i / hd, d = i - c * hd;
      kvs[c * hdp + d] = to_f32(k[key_row(t0 + c) + d]);
    }
    __syncthreads();
    for (int i = tid; i < G * DEC_TILE; i += blockDim.x) {
      const int g = i / DEC_TILE, c = i - g * DEC_TILE;
      float s = RT_NEG_INF;
      if (c < nt) {
        const float* qr = qs + g * hd;
        const float* kr = kvs + c * hdp;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      ss[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {  // one warp per query head
      float* sr = ss + g * DEC_TILE;
      float mx = RT_NEG;
      for (int c = lane; c < nt; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < DEC_TILE; c += 32) {
        const float p = c < nt ? expf(sr[c] - m_new) : 0.f;
        sr[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < nt * hd; i += blockDim.x) {
      const int c = i / hd, d = i - c * hd;
      kvs[c * hdp + d] = to_f32(v[key_row(t0 + c) + d]);
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += blockDim.x) {
      const int g = i / hd, d = i - g * hd;
      const float* pr = ss + g * DEC_TILE;
      float o = 0.f;
      for (int c = 0; c < nt; ++c) o = fmaf(pr[c], kvs[c * hdp + d], o);
      acc[i] = acc[i] * a_s[g] + o;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * hd; i += blockDim.x) pacc[i] = acc[i];
  for (int i = tid; i < G; i += blockDim.x) {
    pml[2 * i] = m_s[i];
    pml[2 * i + 1] = l_s[i];
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int KV, int G,
                                      int hd, int n_splits) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const long long base = ((long long)b * KV + kvh) * n_splits;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd;
    float M = RT_NEG;
    for (int s = 0; s < n_splits; ++s)
      M = fmaxf(M, part_ml[((base + s) * G + g) * 2]);
    float L = 0.f, o = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* ml = part_ml + ((base + s) * G + g) * 2;
      const float w = expf(ml[0] - M);  // an empty split has l = acc = 0
      L += w * ml[1];
      o += w * part_acc[(base + s) * G * hd + i];
    }
    out[((long long)b * KV + kvh) * G * hd + i] =
        from_f32<T>(o / fmaxf(L, 1e-30f));
  }
}

template <typename T, bool PAGED>
cudaError_t launch_decode(const void* q, long long q_sb, long long q_sh,
                          const void* k, const void* v, long long kv_sb,
                          long long kv_ss, long long kv_sh, const int* tbl,
                          long long tbl_sb, int bk, const int* index,
                          void* out, float* part_acc, float* part_ml, int B,
                          int KV, int G, int hd, int Smax, int split_len,
                          int n_splits, cudaStream_t stream) {
  static size_t granted = 0;
  // a split of split_len keys spans at most split_len / bk + 2 blocks
  const int n_tbl = PAGED ? split_len / bk + 2 : 0;
  const size_t smem =
      (size_t)(2 * G * hd + DEC_TILE * (hd + 1) + G * DEC_TILE + 3 * G) *
          sizeof(float) +
      (size_t)n_tbl * sizeof(int);
  cudaError_t err =
      rt_allow_smem(decode_partial_kernel<T, PAGED>, smem, &granted);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)hd);
  decode_partial_kernel<T, PAGED><<<dim3(n_splits, KV, B), DEC_THREADS, smem,
                                    stream>>>(
      (const T*)q, q_sb, q_sh, (const T*)k, (const T*)v, kv_sb, kv_ss, kv_sh,
      tbl, tbl_sb, bk, index, part_acc, part_ml, KV, G, hd, Smax, split_len,
      n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(KV, B), 128, 0, stream>>>(
      part_acc, part_ml, (T*)out, KV, G, hd, n_splits);
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

template <bool PAGED>
int decode_entry(const void* q, long long q_sb, long long q_sh, const void* k,
                 const void* v, long long kv_sb, long long kv_ss,
                 long long kv_sh, const int* tbl, long long tbl_sb, int bk,
                 const int* index, void* out, float* part_acc,
                 float* part_ml, int dtype, int B, int KV, int G, int hd,
                 int Smax, int split_len, int n_splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case RT_F32:
      return launch_decode<float, PAGED>(
          q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sh, tbl, tbl_sb, bk, index,
          out, part_acc, part_ml, B, KV, G, hd, Smax, split_len, n_splits, st);
    case RT_BF16:
      return launch_decode<__nv_bfloat16, PAGED>(
          q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sh, tbl, tbl_sb, bk, index,
          out, part_acc, part_ml, B, KV, G, hd, Smax, split_len, n_splits, st);
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
    int B, int KV, int G, int hd, int Smax, int split_len, int n_splits,
    void* stream) {
  return decode_entry<false>(q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sh,
                             nullptr, 0, 1, index, out, part_acc, part_ml,
                             dtype, B, KV, G, hd, Smax, split_len, n_splits,
                             stream);
}

extern "C" int rt_decode_attention_paged(
    const void* q, long long q_sb, long long q_sh, const void* k,
    const void* v, long long kv_s0, long long kv_s1, long long kv_sh,
    const int* tbl, long long tbl_sb, int bk, const int* index, void* out,
    float* part_acc, float* part_ml, int dtype, int B, int KV, int G, int hd,
    int Smax, int split_len, int n_splits, void* stream) {
  return decode_entry<true>(q, q_sb, q_sh, k, v, kv_s0, kv_s1, kv_sh, tbl,
                            tbl_sb, bk, index, out, part_acc, part_ml, dtype,
                            B, KV, G, hd, Smax, split_len, n_splits, stream);
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
