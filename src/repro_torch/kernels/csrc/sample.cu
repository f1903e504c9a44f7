// K3 fused sampling, for Hopper (sm_90a).
//
// Replaces repro/kernels/sample.py::fused_sample_bv (_sample_kernel).  Per
// row: temperature 0 takes the first index of the float32 maximum (bit-equal
// to torch.argmax, which the engine's greedy streams rely on); otherwise the
// Gumbel-max of logits / t + g, with g from a murmur3-fmix32 hash of
// (seed, rid, pos, column) and u = ((bits >> 8) + 0.5) / 2**24.
//
// Bound: bytes — one read of the (B, V) float32 logits (151,936 columns on
// qwen2.5-3b).  One block per row streams its row once with coalesced
// loads; each thread keeps its (best score, first index) and a block
// reduction breaks ties toward the lower index.  The TPU kernel holds the
// whole row in VMEM and reduces it at once; a block here cannot, and does
// not need to.  logf (not __logf) keeps g within an ulp of the plain
// version.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int SAMPLE_THREADS = 1024;

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

__global__ void __launch_bounds__(SAMPLE_THREADS) fused_sample_kernel(
    const float* __restrict__ logits, long long row_stride,
    const int* __restrict__ seed, const int* __restrict__ rid,
    const int* __restrict__ pos, const float* __restrict__ temp,
    int* __restrict__ out, int V) {
  const int b = blockIdx.x;
  const float* x = logits + b * row_stride;
  const float t = temp[b];
  const bool greedy = !(t > 0.f);
  const uint32_t key = greedy ? 0u : row_key(seed[b], rid[b], pos[b]);
  const float tc = fmaxf(t, 1e-30f);

  float best = RT_NEG_INF;
  int best_i = INT_MAX;
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    float s = x[c];
    if (!greedy) s = s / tc + gumbel(fmix32(key ^ (uint32_t)c));
    if (better(s, c, best, best_i)) {
      best = s;
      best_i = c;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ob, oi, best, best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  __shared__ float wb[SAMPLE_THREADS / 32];
  __shared__ int wi[SAMPLE_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wb[warp] = best;
    wi[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    best = lane < nwarps ? wb[lane] : RT_NEG_INF;
    best_i = lane < nwarps ? wi[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      if (better(ob, oi, best, best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    if (lane == 0) out[b] = best_i;
  }
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

extern "C" int rt_fused_sample(const float* logits, long long row_stride,
                               const int* seed, const int* rid,
                               const int* pos, const float* temp, int* out,
                               int B, int V, void* stream) {
  fused_sample_kernel<<<B, SAMPLE_THREADS, 0, (cudaStream_t)stream>>>(
      logits, row_stride, seed, rid, pos, temp, out, V);
  return (int)cudaGetLastError();
}

extern "C" int rt_sample_noise(const int* seed, const int* rid,
                               const int* pos, int* bits, float* g, int B,
                               int V, void* stream) {
  sample_noise_kernel<<<dim3(64, B), 256, 0, (cudaStream_t)stream>>>(
      seed, rid, pos, bits, g, V);
  return (int)cudaGetLastError();
}
