// K1 decode attention, K5 paged decode attention, each with an instance
// that also writes the row's new K/V (K2 and K6 folded into its launch),
// and K2 ring-slot and K6 paged cache writes standalone, for Hopper
// (sm_90a).
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
// The write instance (WRITE = true) is what decode runs.  Each decode layer
// first writes the row's new K and V (K2 or K6), then attends (K1 or K5).
// The write is B*KV*hd elements a cache, a few KB: its byte bound is
// nanoseconds, and on its own it costs a launch and a dependent index load
// (~6 us), twice per layer and tick, plus the host's dispatch of each.
// Folded in, it rides on loads K1/K5 make anyway:
//   * every block computes the written key from the index it already
//     loads: slot = index % Smax in the ring, logical position
//     index % (nk*bk) in the table row, whose block the split's table
//     slice in shared memory already holds;
//   * the block (or blocks, one per chunk of GMAX query heads) whose split
//     holds that key loads new[b, kvh, :] for K and V, before the index,
//     rounds it to the cache dtype as K2 does (from_f32(to_f32(x))) and
//     packs it as load16 packs a cache row; the chunk gc == 0 stores it to
//     both caches, 16 bytes a lane where the rows allow;
//   * in the key loop, the lanes that would load the written key take the
//     packed row from shared memory instead (the 249-251 registers of the
//     GMAX = 8 bf16 body leave no room to hold it in registers), the same
//     bits in the same lanes in the same order: the output equals K2, K2,
//     K1 (or K6, K6, K5) bit for bit, and so do the caches.
// The hazard: keys are read through __ldg, the read-only path, which is not
// coherent with stores made in the same launch.  So no block ever reads the
// written row back from the cache: the blocks that cover it substitute it,
// and a masked lane's re-read of the split's first key, which may be the
// written key, is substituted too and then discarded by select as before.
// The written bytes are never read through k or v in this launch, which is
// what keeps their __restrict__ true.
// Paged trash rows: inactive rows' table rows all name their partition's
// trash block, so their writes collide there.  Unfused, each such row
// attends with whichever write landed; fused, with its own new row, or with
// whatever an __ldg finds where another row writes.  Active rows never read
// the trash block, and the engine never reads inactive rows' outputs, so
// only active rows' outputs and the pool outside trash blocks are compared.
//
// K2 replaces cache_ring_update_bs (_ring_update_kernel): cache[b, slot[b]]
// = new[b], cast to the cache dtype, in place.  K6 replaces
// cache_paged_update_bs (_paged_update_kernel): cache[blk[b], off[b]] =
// new[b] in the block pool, the same body with the row address taken from
// blk[b] instead of b.  Kept standalone as the reference's API; serving
// uses the write instances.  One thread per 16-byte vector of the cache's
// (KV*hd,) row, a grid of rows x vector chunks, the new row's loads issued
// before the index loads they do not wait on; element stores only for a
// row that is not 16-byte aligned.  Rows naming the same (blk, off)
// collide: which lands is undefined, as for the reference's scatter.
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

// Elements [0, 16 / sizeof(T)) of a new K/V row at p + o (float32 when
// f32, else bf16), rounded to T as K2 rounds them (from_f32(to_f32(x))),
// packed as load16 packs a cache row that holds them: zeros past n_valid.
template <typename T>
__device__ __forceinline__ uint4 new_vec(const void* p, long long o,
                                         int n_valid, int f32) {
  constexpr int VEC = 16 / sizeof(T);
  T t[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float x = 0.f;
    if (e < n_valid)
      x = f32 ? static_cast<const float*>(p)[o + e]
              : to_f32(static_cast<const __nv_bfloat16*>(p)[o + e]);
    t[e] = from_f32<T>(x);
  }
  return load16(t, n_valid, false);
}

// Store the first n_valid elements of a packed 16-byte vector at p; one
// vector store when vec (p 16-byte aligned) and the vector is whole.
template <typename T>
__device__ __forceinline__ void store16(T* p, uint4 r, int n_valid, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec && n_valid >= VEC) {
    *reinterpret_cast<uint4*>(p) = r;
    return;
  }
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (e >= n_valid) break;
    if constexpr (sizeof(T) == 4)
      p[e] = __uint_as_float(w[e]);
    else
      p[e] = __ushort_as_bfloat16(
          (unsigned short)(w[e / 2] >> (16 * (e & 1))));
  }
}

// Words of the split's table slice in shared memory: a split of split_len
// keys spans at most split_len / bk + 2 blocks; rounded up to 4 words so
// the new rows after it start on 16 bytes.
__host__ __device__ constexpr int tbl_words(bool paged, int split_len,
                                            int bk) {
  return paged ? (split_len / bk + 2 + 3) / 4 * 4 : 0;
}

// PAGED = false: k/v are (B, Smax, KV, hd) rings, kv_sb the row stride.
// PAGED = true: k/v are (NB, bk, KV, hd) pools, kv_sb the block stride, and
// tbl (B, nk) names row b's blocks; Smax = nk * bk.
// WRITE = true: first write k_new[b, kvh] / v_new[b, kvh] (row stride n_sb,
// head stride n_sh; float32 when new_f32, else bf16) into key
// index[b] % Smax of row b, then attend with it (the head note).
// Block (split, kvh * gchunks + gc, b) takes query heads
// kvh*G + gc*GMAX ... (at most GMAX of them) over the split's keys.
template <typename T, bool PAGED, int GMAX, bool WRITE>
__global__ void __launch_bounds__(DEC_THREADS) decode_partial_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh,
    const T* __restrict__ k, const T* __restrict__ v, long long kv_sb,
    long long kv_ss, long long kv_sh, const int* __restrict__ tbl,
    long long tbl_sb, int bk, const int* __restrict__ index,
    const void* __restrict__ k_new, const void* __restrict__ v_new,
    long long n_sb, long long n_sh, int new_f32, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int KV, int G,
    int hd, int lpr_log2, int Smax, int split_len, int n_splits,
    float scale_log2, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = GMAX >= 8 ? 2 : 4;  // key rows a lane group has in flight
  const int split = blockIdx.x, b = blockIdx.z;
  const int gchunks = (G + GMAX - 1) / GMAX;
  const int kvh = blockIdx.y / gchunks;
  const int gc = blockIdx.y - kvh * gchunks;
  const int g0 = gc * GMAX;
  const int ng = min(GMAX, G - g0);
  const int H = KV * G, h0 = kvh * G + g0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = 1 << lpr_log2;            // lanes per key row
  const int rpw = 32 >> lpr_log2;           // key rows a warp reads at once
  const int sub = lane >> lpr_log2, d0 = (lane & (lpr - 1)) * VEC;
  const int nd = hd - d0;                   // this lane's valid elements

  extern __shared__ __align__(16) float smem[];
  float* ml_s = smem;                          // [DEC_WARPS][GMAX][2]
  float* acc_s = ml_s + DEC_WARPS * GMAX * 2;  // [DEC_WARPS][GMAX][hd]
  int* tbl_s = (int*)(acc_s + DEC_WARPS * GMAX * hd);  // PAGED: split's ids
  // WRITE: the new K row's lpr vectors, then the new V row's
  uint4* new_s = (uint4*)(tbl_s + tbl_words(PAGED, split_len, bk));

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
  // WRITE: lanes 0 .. lpr-1 (warp 0's first row group) load the new rows,
  // nor do they wait on the index
  uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
  if (WRITE && tid < lpr && nd > 0) {
    const long long o = b * n_sb + kvh * n_sh + d0;
    kw = new_vec<T>(k_new, o, nd, new_f32);
    vw = new_vec<T>(v_new, o, nd, new_f32);
  }

  const int idx = index[b];
  const int n_live = idx < Smax ? idx + 1 : Smax;
  const int lo = split * split_len;
  const int hi = min(lo + split_len, n_live);
  const int wkey = WRITE ? idx % Smax : -1;  // the key this launch writes
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

  // the split holding the written key (block-uniform; never an empty one)
  const bool covers = WRITE && lo <= wkey && wkey < hi;
  const int first = PAGED ? lo / bk : 0;
  if constexpr (PAGED)
    for (int i = tid; i <= (hi - 1) / bk - first; i += DEC_THREADS)
      tbl_s[i] = tbl[b * tbl_sb + first + i];
  if (covers && tid < lpr) {
    new_s[tid] = kw;
    new_s[lpr + tid] = vw;
  }
  if (PAGED || covers) __syncthreads();
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
  // the rows K2 (K6) would write, once per KV head; nothing in this launch
  // reads them back from the cache
  if (covers && gc == 0 && tid < lpr && nd > 0) {
    const long long r = key_row(wkey);
    store16(const_cast<T*>(k) + r, kw, nd, vec);
    store16(const_cast<T*>(v) + r, vw, nd, vec);
  }

  float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = RT_NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // keys are dealt to lane groups in turn: group (warp, sub) takes
  // lo + warp*rpw + sub + i*stride; a step takes U of them.  The written
  // key comes from new_s, never from the cache (the head note).
  const int stride = DEC_WARPS * rpw;
  const int step = U * stride;
  auto load_rows = [&](const T* src, const uint4* written, int kbase,
                       uint4 (&r)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = kbase + sub + u * stride;
      const int tt = t < hi ? t : lo;
      r[u] = make_uint4(0u, 0u, 0u, 0u);
      if (nd > 0) {
        if (WRITE && tt == wkey)
          r[u] = written[lane & (lpr - 1)];
        else
          r[u] = load16(src + key_row(tt), nd, vec);
      }
    }
  };
  uint4 kr[U], vr[U];
  int kbase = lo + warp * rpw;
  if (kbase < hi) {
    load_rows(k, new_s, kbase, kr);
    load_rows(v, new_s + lpr, kbase, vr);
  }
  for (; kbase < hi; kbase += step) {  // warp-uniform: shuffles below
    uint4 kn[U], vn[U];  // the next step's rows, in flight meanwhile
    if (kbase + step < hi) {
      load_rows(k, new_s, kbase + step, kn);
      load_rows(v, new_s + lpr, kbase + step, vn);
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

// Host-side arguments of one K1 / K5 call (with or without the write).
struct DecodeArgs {
  const void* q;
  long long q_sb, q_sh;
  const void* k;
  const void* v;
  long long kv_sb, kv_ss, kv_sh;
  const int* tbl;
  long long tbl_sb;
  int bk;
  const int* index;
  const void* k_new;  // nullptr: attend only
  const void* v_new;
  long long n_sb, n_sh;
  int new_dtype;
  void* out;
  float* part_acc;
  float* part_ml;
  int B, KV, G, hd, gmax, lpr_log2, Smax, split_len, n_splits, vec;
};

template <typename T, bool PAGED, int GMAX, bool WRITE>
cudaError_t launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  static size_t granted[RT_MAX_DEVICES] = {};
  const size_t smem =
      (size_t)DEC_WARPS * GMAX * (a.hd + 2) * sizeof(float) +
      (size_t)tbl_words(PAGED, a.split_len, a.bk) * sizeof(int) +
      (WRITE ? (size_t)2 * (16 << a.lpr_log2) : 0);  // new_s
  cudaError_t err = rt_allow_smem(decode_partial_kernel<T, PAGED, GMAX, WRITE>,
                                  smem, granted);
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)a.hd);
  const int gchunks = (a.G + GMAX - 1) / GMAX;
  decode_partial_kernel<T, PAGED, GMAX, WRITE>
      <<<dim3(a.n_splits, a.KV * gchunks, a.B), DEC_THREADS, smem, stream>>>(
          (const T*)a.q, a.q_sb, a.q_sh, (const T*)a.k, (const T*)a.v,
          a.kv_sb, a.kv_ss, a.kv_sh, a.tbl, a.tbl_sb, a.bk, a.index, a.k_new,
          a.v_new, a.n_sb, a.n_sh, a.new_dtype == RT_F32, (T*)a.out,
          a.part_acc, a.part_ml, a.KV, a.G, a.hd, a.lpr_log2, a.Smax,
          a.split_len, a.n_splits, scale_log2, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  const int threads = min(256, max(32, (a.hd + 31) / 32 * 32));
  decode_combine_kernel<T><<<dim3(a.KV * a.G, a.B), threads,
                             3 * a.n_splits * sizeof(float), stream>>>(
      a.part_acc, a.part_ml, (T*)a.out, a.KV * a.G, a.hd, a.n_splits);
  return cudaGetLastError();
}

template <typename T, bool PAGED, bool WRITE>
cudaError_t launch_decode_g(const DecodeArgs& a, cudaStream_t stream) {
  switch (a.gmax) {
    case 1: return launch_decode<T, PAGED, 1, WRITE>(a, stream);
    case 2: return launch_decode<T, PAGED, 2, WRITE>(a, stream);
    case 4: return launch_decode<T, PAGED, 4, WRITE>(a, stream);
    case 8: return launch_decode<T, PAGED, 8, WRITE>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <bool PAGED>
int decode_entry(int device, const DecodeArgs& a, int dtype, void* stream) {
  const bool write = a.k_new != nullptr;
  if (write && (a.v_new == nullptr ||
                (a.new_dtype != RT_F32 && a.new_dtype != RT_BF16)))
    return (int)cudaErrorInvalidValue;
  RtDevice on(device);
  if (on.status() != cudaSuccess) return (int)on.status();
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case RT_F32:
      return write ? launch_decode_g<float, PAGED, true>(a, st)
                   : launch_decode_g<float, PAGED, false>(a, st);
    case RT_BF16:
      return write ? launch_decode_g<__nv_bfloat16, PAGED, true>(a, st)
                   : launch_decode_g<__nv_bfloat16, PAGED, false>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// One thread per 16-byte vector of the cache's (row,) row (VC elements):
// cache[r, s, i0 .. i0+VC) = src[b, i0 .. i0+VC) for r = blk[b] (K6) or b
// (K2, blk == nullptr), s = pos[b]; a row whose (r, s) falls outside
// (n0, n1) is dropped, like an out-of-range scatter.  Grid (vector chunks,
// B).  vec: both rows aligned for whole-vector loads and stores.
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T x[N];
};

template <typename TC, typename TN>
__global__ void row_update_kernel(TC* __restrict__ cache, long long c_s0,
                                  long long c_s1, const TN* __restrict__ src,
                                  long long n_sb,
                                  const int* __restrict__ blk,
                                  const int* __restrict__ pos, int n0, int n1,
                                  int row, int vec) {
  constexpr int VC = 16 / sizeof(TC);
  const int b = blockIdx.y;
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * VC;
  if (i0 >= row) return;
  const int n = min(VC, row - i0);
  const TN* in = src + b * n_sb + i0;
  // the new row first: it does not wait on the index loads
  float f[VC];
  if (vec && n == VC) {
    const Pack<TN, VC> x = *reinterpret_cast<const Pack<TN, VC>*>(in);
#pragma unroll
    for (int e = 0; e < VC; ++e) f[e] = to_f32(x.x[e]);
  } else {
#pragma unroll
    for (int e = 0; e < VC; ++e) f[e] = e < n ? to_f32(in[e]) : 0.f;
  }
  const int r = blk == nullptr ? b : blk[b];
  const int s = pos[b];
  if (r < 0 || r >= n0 || s < 0 || s >= n1) return;
  TC* dst = cache + (long long)r * c_s0 + (long long)s * c_s1 + i0;
  if (vec && n == VC) {
    Pack<TC, VC> y;
#pragma unroll
    for (int e = 0; e < VC; ++e) y.x[e] = from_f32<TC>(f[e]);
    *reinterpret_cast<Pack<TC, VC>*>(dst) = y;
  } else {
#pragma unroll
    for (int e = 0; e < VC; ++e)
      if (e < n) dst[e] = from_f32<TC>(f[e]);
  }
}

template <typename TC>
cudaError_t launch_rows(void* cache, long long c_s0, long long c_s1,
                        const void* src, int src_dtype, long long n_sb,
                        const int* blk, const int* pos, int B, int n0, int n1,
                        int row, int vec, cudaStream_t stream) {
  constexpr int VC = 16 / sizeof(TC);
  const int vecs = (row + VC - 1) / VC;
  const int threads = min(128, (vecs + 31) / 32 * 32);
  const dim3 grid((vecs + threads - 1) / threads, B);
  switch (src_dtype) {
    case RT_F32:
      row_update_kernel<TC, float><<<grid, threads, 0, stream>>>(
          (TC*)cache, c_s0, c_s1, (const float*)src, n_sb, blk, pos, n0, n1,
          row, vec);
      break;
    case RT_BF16:
      row_update_kernel<TC, __nv_bfloat16><<<grid, threads, 0, stream>>>(
          (TC*)cache, c_s0, c_s1, (const __nv_bfloat16*)src, n_sb, blk, pos,
          n0, n1, row, vec);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int rows_entry(int device, void* cache, int cache_dtype, long long c_s0,
               long long c_s1, const void* src, int src_dtype, long long n_sb,
               const int* blk, const int* pos, int B, int n0, int n1, int row,
               int vec, void* stream) {
  if (B < 1 || row < 1) return (int)cudaErrorInvalidValue;
  RtDevice on(device);
  if (on.status() != cudaSuccess) return (int)on.status();
  cudaStream_t st = (cudaStream_t)stream;
  switch (cache_dtype) {
    case RT_F32:
      return launch_rows<float>(cache, c_s0, c_s1, src, src_dtype, n_sb, blk,
                                pos, B, n0, n1, row, vec, st);
    case RT_BF16:
      return launch_rows<__nv_bfloat16>(cache, c_s0, c_s1, src, src_dtype,
                                        n_sb, blk, pos, B, n0, n1, row, vec,
                                        st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// k_new == nullptr: attend only (K1); otherwise write k_new / v_new (B, KV,
// hd; strides n_sb, n_sh, 1; new_dtype) into slot index[b] % Smax first.
extern "C" int rt_decode_attention(
    int device, const void* q, long long q_sb, long long q_sh, const void* k,
    const void* v, long long kv_sb, long long kv_ss, long long kv_sh,
    const int* index, const void* k_new, const void* v_new, long long n_sb,
    long long n_sh, int new_dtype, void* out, float* part_acc,
    float* part_ml, int dtype, int B, int KV, int G, int hd, int gmax,
    int lpr_log2, int Smax, int split_len, int n_splits, int vec,
    void* stream) {
  const DecodeArgs a{q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sh,
                     nullptr, 0, 1, index,
                     k_new, v_new, n_sb, n_sh, new_dtype,
                     out, part_acc, part_ml,
                     B, KV, G, hd, gmax, lpr_log2, Smax, split_len, n_splits,
                     vec};
  return decode_entry<false>(device, a, dtype, stream);
}

// The same through a block table: key index[b] % (nk*bk) of row b is
// written at pool[tbl[b, t / bk], t % bk].
extern "C" int rt_decode_attention_paged(
    int device, const void* q, long long q_sb, long long q_sh, const void* k,
    const void* v, long long kv_s0, long long kv_s1, long long kv_sh,
    const int* tbl, long long tbl_sb, int bk, const int* index,
    const void* k_new, const void* v_new, long long n_sb, long long n_sh,
    int new_dtype, void* out, float* part_acc, float* part_ml, int dtype,
    int B, int KV, int G, int hd, int gmax, int lpr_log2, int Smax,
    int split_len, int n_splits, int vec, void* stream) {
  const DecodeArgs a{q, q_sb, q_sh, k, v, kv_s0, kv_s1, kv_sh,
                     tbl, tbl_sb, bk, index,
                     k_new, v_new, n_sb, n_sh, new_dtype,
                     out, part_acc, part_ml,
                     B, KV, G, hd, gmax, lpr_log2, Smax, split_len, n_splits,
                     vec};
  return decode_entry<true>(device, a, dtype, stream);
}

extern "C" int rt_cache_ring_update(int device, void* cache, int cache_dtype,
                                    long long c_sb, long long c_ss,
                                    const void* src, int src_dtype,
                                    long long n_sb, const int* slot, int B,
                                    int Smax, int row, int vec,
                                    void* stream) {
  return rows_entry(device, cache, cache_dtype, c_sb, c_ss, src, src_dtype,
                    n_sb, nullptr, slot, B, B, Smax, row, vec, stream);
}

extern "C" int rt_cache_paged_update(int device, void* cache,
                                     int cache_dtype, long long c_s0,
                                     long long c_s1, const void* src,
                                     int src_dtype, long long n_sb,
                                     const int* blk, const int* off, int B,
                                     int NB, int bk, int row, int vec,
                                     void* stream) {
  return rows_entry(device, cache, cache_dtype, c_s0, c_s1, src, src_dtype,
                    n_sb, blk, off, B, NB, bk, row, vec, stream);
}
