// K3 fused sampling, for Hopper (sm_90a).
//
// Replaces repro/kernels/sample.py::fused_sample_bv (_sample_kernel).  Per
// row: temperature 0 takes the first index of the float32 maximum (bit-equal
// to torch.argmax, which the engine's greedy streams rely on); otherwise the
// Gumbel-max of logits / t + g, with g from a murmur3-fmix32 hash of
// (seed, rid, pos, column) and u = ((bits >> 8) + 0.5) / 2**24.
//
// Bound: bytes — one read of the (B, V) float32 logits (8 x 151,936 on
// qwen2.5-3b's 8 slots, 4.9 MB: 1.5 us at 3.35 TB/s).  One block per row
// would stream them on B of the 132 SMs, latency-bound.  So each row is cut
// into n_splits contiguous ranges of split_len columns (a multiple of 4;
// the wrapper's split_plan aims at about 2 blocks an SM), and the grid is
// (n_splits, B).  A block streams its range with 16-byte loads, SAMPLE_UNROLL
// of them in flight per thread, each thread keeps its (score, first index)
// pair, warps reduce the pairs by shuffles and the block writes one pair per
// (row, split).  A one-warp merge kernel then reduces each row's pairs.  One
// split writes the token directly and launches no merge.
//
// Exactness: `better` is a total order on (score, index) pairs — NaN above
// everything, then the larger score, ties to the lower index (torch.argmax's
// order) — so neither the split plan nor the order of the reduction changes
// the answer, and no atomics touch the result: two identical calls agree bit
// for bit.  A row whose start is not on a 16-byte boundary (an unaligned
// base or row stride) takes scalar loads into the same reduction.  logf (not
// __logf) keeps g within an ulp of the plain version.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int SAMPLE_THREADS = 256;
constexpr int SAMPLE_UNROLL = 8;   // 16-byte loads in flight per thread
constexpr int MERGE_THREADS = 32;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t row_key(int seed, int rid, int pos) {
  uint32_t key = fmix32(0x9E3779B9u ^ (uint32_t)seed);
  key = fmix32(key ^ (uint32_t)rid);
  return fmix32(key ^ (uint32_t)pos);
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = ((float)(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
  return -logf(-logf(u));
}

// argmax order of torch: NaN above everything, ties to the lower index
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

struct Best {
  float s;
  int i;
  __device__ __forceinline__ void clear() {
    s = RT_NEG_INF;
    i = INT_MAX;
  }
  __device__ __forceinline__ void take(float s2, int i2) {
    if (better(s2, i2, s, i)) {
      s = s2;
      i = i2;
    }
  }
  __device__ __forceinline__ void warp_reduce() {
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, s, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      take(os, oi);
    }
  }
};

// one row's sampling rule: the logit itself (greedy) or logit / t + g
struct Rule {
  bool greedy;
  uint32_t key;
  float tc;
  __device__ __forceinline__ float operator()(float x, int c) const {
    return greedy ? x : x / tc + gumbel(fmix32(key ^ (uint32_t)c));
  }
};

__global__ void __launch_bounds__(SAMPLE_THREADS) sample_split_kernel(
    const float* __restrict__ logits, long long row_stride,
    const int* __restrict__ seed, const int* __restrict__ rid,
    const int* __restrict__ pos, const float* __restrict__ temp,
    int* __restrict__ out, float* __restrict__ part_s,
    int* __restrict__ part_i, int V, int split_len) {
  const int split = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* x = logits + b * row_stride;
  const float t = temp[b];
  Rule rule;
  rule.greedy = !(t > 0.f);
  rule.key = rule.greedy ? 0u : row_key(seed[b], rid[b], pos[b]);
  rule.tc = fmaxf(t, 1e-30f);

  const int c0 = split * split_len, c1 = min(V, c0 + split_len);
  Best best;
  best.clear();
  int tail = c0;  // first column the scalar loop takes
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    // c0 is a multiple of 4, so x + c0 is on a 16-byte boundary too
    const float4* xv = reinterpret_cast<const float4*>(x + c0);
    const int nv = (c1 - c0) >> 2;
    for (int v0 = tid; v0 < nv; v0 += SAMPLE_THREADS * SAMPLE_UNROLL) {
      float4 q[SAMPLE_UNROLL];
#pragma unroll
      for (int u = 0; u < SAMPLE_UNROLL; ++u) {
        const int v = v0 + u * SAMPLE_THREADS;
        if (v < nv) q[u] = __ldg(xv + v);
      }
#pragma unroll
      for (int u = 0; u < SAMPLE_UNROLL; ++u) {
        const int v = v0 + u * SAMPLE_THREADS;
        if (v < nv) {
          const int c = c0 + 4 * v;
          best.take(rule(q[u].x, c), c);
          best.take(rule(q[u].y, c + 1), c + 1);
          best.take(rule(q[u].z, c + 2), c + 2);
          best.take(rule(q[u].w, c + 3), c + 3);
        }
      }
    }
    tail = c0 + 4 * nv;
  }
  for (int c = tail + tid; c < c1; c += SAMPLE_THREADS)
    best.take(rule(__ldg(x + c), c), c);

  best.warp_reduce();
  __shared__ float ws[SAMPLE_THREADS / 32];
  __shared__ int wi[SAMPLE_THREADS / 32];
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    ws[warp] = best.s;
    wi[warp] = best.i;
  }
  __syncthreads();
  if (warp == 0) {
    Best w;
    w.clear();
    if (lane < SAMPLE_THREADS / 32) {
      w.s = ws[lane];
      w.i = wi[lane];
    }
    w.warp_reduce();
    if (lane == 0) {
      if (gridDim.x == 1) {
        out[b] = w.i;
      } else {
        part_s[b * gridDim.x + split] = w.s;
        part_i[b * gridDim.x + split] = w.i;
      }
    }
  }
}

// one warp per row reduces the row's n_splits pairs (a total order: the
// answer does not depend on the order)
__global__ void __launch_bounds__(MERGE_THREADS) sample_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i,
    int* __restrict__ out, int n_splits) {
  const int b = blockIdx.x, lane = threadIdx.x;
  Best best;
  best.clear();
  for (int s = lane; s < n_splits; s += MERGE_THREADS)
    best.take(part_s[b * n_splits + s], part_i[b * n_splits + s]);
  best.warp_reduce();
  if (lane == 0) out[b] = best.i;
}

// the hash bits and noise of every (row, column): lets a test hold the
// kernel's arithmetic against the plain version bit for bit
__global__ void sample_noise_kernel(const int* __restrict__ seed,
                                    const int* __restrict__ rid,
                                    const int* __restrict__ pos,
                                    int* __restrict__ bits,
                                    float* __restrict__ g, int V) {
  const int b = blockIdx.y;
  const uint32_t key = row_key(seed[b], rid[b], pos[b]);
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < V;
       c += gridDim.x * blockDim.x) {
    const uint32_t h = fmix32(key ^ (uint32_t)c);
    bits[(long long)b * V + c] = (int)h;
    g[(long long)b * V + c] = gumbel(h);
  }
}

}  // namespace

// part: 2 * B * n_splits words of scratch (scores, then indices); unused
// when n_splits == 1
extern "C" int rt_fused_sample(int device, const float* logits,
                               long long row_stride,
                               const int* seed, const int* rid,
                               const int* pos, const float* temp, int* out,
                               void* part, int B, int V, int split_len,
                               int n_splits, void* stream) {
  if (B < 1 || V < 1 || split_len < 4 || split_len % 4 != 0 || n_splits < 1 ||
      (long long)(n_splits - 1) * split_len >= V ||
      (long long)n_splits * split_len < V)
    return (int)cudaErrorInvalidValue;
  RtDevice on(device);
  if (on.status() != cudaSuccess) return (int)on.status();
  float* part_s = (float*)part;
  int* part_i = (int*)part + (long long)B * n_splits;
  sample_split_kernel<<<dim3(n_splits, B), SAMPLE_THREADS, 0,
                        (cudaStream_t)stream>>>(logits, row_stride, seed, rid,
                                                pos, temp, out, part_s, part_i,
                                                V, split_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  sample_merge_kernel<<<B, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      part_s, part_i, out, n_splits);
  return (int)cudaGetLastError();
}

extern "C" int rt_sample_noise(int device, const int* seed, const int* rid,
                               const int* pos, int* bits, float* g, int B,
                               int V, void* stream) {
  RtDevice on(device);
  if (on.status() != cudaSuccess) return (int)on.status();
  sample_noise_kernel<<<dim3(64, B), 256, 0, (cudaStream_t)stream>>>(
      seed, rid, pos, bits, g, V);
  return (int)cudaGetLastError();
}
