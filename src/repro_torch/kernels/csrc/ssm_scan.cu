// K7 SSD scan (Mamba2 prefill), for Hopper (sm_90a).
//
// Replaces repro/kernels/ssm_scan.py::ssm_scan_ssd (_ssd_kernel): per
// (batch row, SSM head) the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t,   y_t = C_t . h_t
// in float32, evaluated in chunks of T tokens as the TPU kernel does:
//   y_chunk = (L o C B^T)(dt . X) + C exp(P) state,
//   state  <- exp(P_last) state + B^T (dt exp(P_last - P) . X),
// with P the inclusive prefix sum of dt*A inside the chunk and
// L[i, j] = exp(P_i - P_j) for i >= j, else 0.
//
// Tile: T = min(chunk, 64) tokens.  The recurrence is the same for any T;
// only the rounding differs from the TPU kernel's T = 128.
//
// Bound: operations.  At zamba2-2.7b's prefill (1, 200, 80 heads, hd 64,
// N 64) the inputs and outputs are ~18 MB (5 us at 3.35 TB/s) but the
// chunked form does ~1 GFLOP, ~15 us at the 67 TFLOP/s float32 rate of the
// CUDA cores; only tensor-core products (a later version) reach the bytes
// bound.  This first version is plain float32 FMA from shared memory.
//
// Parallelism: the TPU grid's sequential chunk axis becomes a loop inside
// one block, the (N, hd) state carried in shared memory.  One block per
// (b, h) would give 80 blocks for 132 SMs at batch 1; the hd columns of y
// and of the state are independent, so the grid is (hd/32, H, B) and each
// block recomputes the cheap C B^T and decay matrix for its 32 columns.
//
// Ragged L: no fallback.  Positions >= L load dt = x = B = C = 0, so P stops
// at P[L-1] and the state's decay ends there; nothing is stored past L.
// Overflow: exp(P_i - P_j) is built only under i >= j, by select (for i < j
// the exponent is positive and may overflow to inf, and inf * 0 is NaN).
// With h_out set, the final carried state is written in the cache layout
// (B, H, hd, N): the shared-memory state is (N, hd), transposed on the way
// out.  x, dt, B and C are read in the model layout through strides.
#include "common.cuh"

namespace {

constexpr int SSD_TILE = 64;     // most tokens per chunk
constexpr int SSD_DC = 32;       // hd columns per block: one per lane
constexpr int SSD_THREADS = 256;
static_assert(SSD_DC == 32, "column index is the lane");

__global__ void __launch_bounds__(SSD_THREADS) ssd_kernel(
    const float* __restrict__ x, long long x_sb, long long x_sl,
    long long x_sh, const float* __restrict__ dt, long long dt_sb,
    long long dt_sl, long long dt_sh, const float* __restrict__ A,
    const float* __restrict__ Bm, long long b_sb, long long b_sl,
    long long b_sh, const float* __restrict__ Cm, long long c_sb,
    long long c_sl, long long c_sh, float* __restrict__ y,
    float* __restrict__ h_out, int L, int H, int hd, int N, int T) {
  const int d0 = blockIdx.x * SSD_DC, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int np = N + 1;  // padded rows: conflict-free column reads
  const int tp = T + 1;

  extern __shared__ float smem[];
  float* Bs = smem;             // T * np   B[j][n]
  float* Cs = Bs + T * np;      // T * np   C[i][n]
  float* Ms = Cs + T * np;      // T * tp   (L o C B^T)[i][j] * dt[j]
  float* xs = Ms + T * tp;      // T * DC   x[j][d]
  float* st = xs + T * SSD_DC;  // N * DC   state[n][d]
  float* dts = st + N * SSD_DC; // T
  float* Ps = dts + T;          // T  prefix sums of dt*A
  float* eP = Ps + T;           // T  exp(P_i)
  float* ws = eP + T;           // T  dt_j exp(P_last - P_j)

  const float Ah = A[h];
  const float* xb = x + b * x_sb + h * x_sh + d0;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const float* Bb = Bm + b * b_sb + h * b_sh;
  const float* Cb = Cm + b * c_sb + h * c_sh;
  const int ncol = min(SSD_DC, hd - d0);

  for (int i = tid; i < N * SSD_DC; i += blockDim.x) st[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += T) {
    const int nt = min(T, L - c0);
    for (int i = tid; i < T * N; i += blockDim.x) {
      const int r = i / N, n = i - r * N;
      const long long p = c0 + r;
      const bool ok = r < nt;
      Bs[r * np + n] = ok ? Bb[p * b_sl + n] : 0.f;
      Cs[r * np + n] = ok ? Cb[p * c_sl + n] : 0.f;
    }
    for (int i = tid; i < T * SSD_DC; i += blockDim.x) {
      const int r = i / SSD_DC, d = i - r * SSD_DC;
      xs[i] = (r < nt && d < ncol) ? xb[(long long)(c0 + r) * x_sl + d] : 0.f;
    }
    for (int i = tid; i < T; i += blockDim.x)
      dts[i] = i < nt ? dtb[(long long)(c0 + i) * dt_sl] : 0.f;
    __syncthreads();
    if (tid == 0) {  // inclusive prefix sum of the log-decay
      float P = 0.f;
      for (int i = 0; i < T; ++i) {
        P += dts[i] * Ah;
        Ps[i] = P;
      }
    }
    __syncthreads();
    const float P_last = Ps[T - 1];
    for (int i = tid; i < T; i += blockDim.x) {
      eP[i] = expf(Ps[i]);
      ws[i] = dts[i] * expf(P_last - Ps[i]);
    }
    // intra-chunk matrix: causal (C_i . B_j) exp(P_i - P_j) dt_j
    for (int idx = tid; idx < T * T; idx += blockDim.x) {
      const int i = idx / T, j = idx - i * T;
      float v = 0.f;
      if (j <= i) {
        const float* cr = Cs + i * np;
        const float* br = Bs + j * np;
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot = fmaf(cr[n], br[n], dot);
        v = dot * expf(Ps[i] - Ps[j]) * dts[j];
      }
      Ms[i * tp + j] = v;
    }
    __syncthreads();
    // y: intra-chunk product plus the carried state's contribution
    for (int idx = tid; idx < T * SSD_DC; idx += blockDim.x) {
      const int i = idx / SSD_DC, d = lane;
      const float* mr = Ms + i * tp;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(mr[j], xs[j * SSD_DC + d], acc);
      const float* cr = Cs + i * np;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(cr[n], st[n * SSD_DC + d], inter);
      acc = fmaf(eP[i], inter, acc);
      if (i < nt && d < ncol)
        y[(((long long)b * L + c0 + i) * H + h) * hd + d0 + d] = acc;
    }
    __syncthreads();
    // state update: decay over the whole chunk, then add its inputs
    const float decay = expf(P_last);
    for (int idx = tid; idx < N * SSD_DC; idx += blockDim.x) {
      const int n = idx / SSD_DC, d = lane;
      float acc = 0.f;
      for (int j = 0; j < T; ++j)
        acc = fmaf(Bs[j * np + n], ws[j] * xs[j * SSD_DC + d], acc);
      st[idx] = fmaf(decay, st[idx], acc);
    }
    __syncthreads();
  }
  if (h_out != nullptr) {
    float* hb = h_out + ((long long)b * H + h) * hd * N;
    for (int idx = tid; idx < N * SSD_DC; idx += blockDim.x) {
      const int n = idx / SSD_DC, d = idx - n * SSD_DC;
      if (d < ncol) hb[(long long)(d0 + d) * N + n] = st[idx];
    }
  }
}

}  // namespace

extern "C" int rt_ssm_scan(
    const void* x, long long x_sb, long long x_sl, long long x_sh,
    const void* dt, long long dt_sb, long long dt_sl, long long dt_sh,
    const void* A, const void* Bm, long long b_sb, long long b_sl,
    long long b_sh, const void* Cm, long long c_sb, long long c_sl,
    long long c_sh, void* y, void* h_out, int B, int L, int H, int hd, int N,
    int T, void* stream) {
  if (T < 1 || T > SSD_TILE || L < 1) return (int)cudaErrorInvalidValue;
  static size_t granted = 0;
  const size_t smem = (size_t)(2 * T * (N + 1) + T * (T + 1) + T * SSD_DC +
                               N * SSD_DC + 4 * T) *
                      sizeof(float);
  cudaError_t err = rt_allow_smem(ssd_kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hd + SSD_DC - 1) / SSD_DC, H, B);
  ssd_kernel<<<grid, SSD_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, x_sb, x_sl, x_sh, (const float*)dt, dt_sb, dt_sl, dt_sh,
      (const float*)A, (const float*)Bm, b_sb, b_sl, b_sh, (const float*)Cm,
      c_sb, c_sl, c_sh, (float*)y, (float*)h_out, L, H, hd, N, T);
  return (int)cudaGetLastError();
}
