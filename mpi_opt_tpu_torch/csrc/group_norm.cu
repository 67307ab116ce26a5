// Fused GroupNorm(+ReLU), forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mpi_opt_tpu/ops/pallas_gn.py:
// _fwd_kernel (launched by _forward) and _bwd_kernel (launched by
// _bwd_rule). Same contract: x is channel-last [N, S, C]; statistics
// per (sample, group) in f32 with var = E[x^2] - mean^2 and
// rsqrt(var + eps) inside; the backward recomputes the ReLU mask from x
// and the saved statistics (z = gamma * xhat + beta > 0) and never
// re-reads y; dgamma/dbeta leave as per-sample partials [N, C] f32 that
// the caller sums over N.
//
// What bounds it on this card: bytes. The forward must read x and write
// y, the backward read x and dy and write dx; everything else (gamma,
// beta, the [N, G] statistics, the [N, C] partials) is small beside
// them. The TPU kernel keeps a whole sample in VMEM; a population folded
// into channels makes one sample far larger than the 227 KB of shared
// memory a block may use, so here a block owns one sample and a slice of
// CB channels that holds whole groups (grid = C / CB by N). It reads its
// slice twice, once for the statistics and once to normalise (the
// second read may hit L2). This first version is simple and right: no
// vectorised loads, no TMA; on an H100 SXM it runs at about a third of
// its bytes bound (PERF.md).
//
// Layout of a block: blockDim = (CB, RL). Thread (tx, ty) owns channel
// c0 + tx and rows ty, ty + RL, ...; consecutive tx are consecutive
// addresses, so a warp reads a contiguous run of one row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// z = (x - mean) * rstd * gamma + beta, rounded after every operation
// (the _rn intrinsics are never contracted into FMAs): the backward
// recomputes the same z bit for bit to decide the ReLU mask, and so do
// the plain versions in torch ops.
__device__ __forceinline__ float norm_affine(float v, float m, float rs, float ga, float be) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, m), rs), ga), be);
}

template <typename T>
__global__ void gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                              const float* __restrict__ beta, T* __restrict__ y,
                              float* __restrict__ mean_out, float* __restrict__ rstd_out,
                              int S, int C, int G, float eps, int relu) {
  extern __shared__ float sh[];
  const int cb = blockDim.x, rl = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * cb + tx;
  const int n = blockIdx.y;
  const int c0 = blockIdx.x * cb;
  const int c = c0 + tx;
  const int gs = C / G;
  const int gib = cb / gs;  // groups in this block
  const size_t base = (size_t)n * S * C;
  float* sum1 = sh;                 // [rl * cb]
  float* sum2 = sh + rl * cb;       // [rl * cb]
  float* gstat = sh + 2 * rl * cb;  // [2 * gib]: mean, rstd

  float s1 = 0.f, s2 = 0.f;
  for (int r = ty; r < S; r += rl) {
    const float v = to_f(x[base + (size_t)r * C + c]);
    s1 += v;
    s2 += v * v;
  }
  sum1[tid] = s1;
  sum2[tid] = s2;
  __syncthreads();
  if (tid < gib) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < rl; ++j)
      for (int k = 0; k < gs; ++k) {
        a += sum1[j * cb + tid * gs + k];
        b += sum2[j * cb + tid * gs + k];
      }
    const float cnt = (float)S * (float)gs;
    const float m = a / cnt;
    const float var = b / cnt - m * m;
    const float rs = rsqrtf(var + eps);
    gstat[tid] = m;
    gstat[gib + tid] = rs;
    const size_t g = (size_t)n * G + c0 / gs + tid;
    mean_out[g] = m;
    rstd_out[g] = rs;
  }
  __syncthreads();
  const float m = gstat[tx / gs], rs = gstat[gib + tx / gs];
  const float ga = gamma[c], be = beta[c];
  for (int r = ty; r < S; r += rl) {
    const size_t i = base + (size_t)r * C + c;
    float z = norm_affine(to_f(x[i]), m, rs, ga, be);
    if (relu) z = z < 0.f ? 0.f : z;  // NaN passes through, as jnp.maximum
    y[i] = from_f<T>(z);
  }
}

template <typename T>
__global__ void gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                              const float* __restrict__ gamma, const float* __restrict__ beta,
                              const float* __restrict__ mean, const float* __restrict__ rstd,
                              T* __restrict__ dx, float* __restrict__ dgamma,
                              float* __restrict__ dbeta, int S, int C, int G, int relu) {
  extern __shared__ float sh[];
  const int cb = blockDim.x, rl = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * cb + tx;
  const int n = blockIdx.y;
  const int c0 = blockIdx.x * cb;
  const int c = c0 + tx;
  const int gs = C / G;
  const int gib = cb / gs;
  const size_t base = (size_t)n * S * C;
  float* part_g = sh;                // [rl * cb]: sum dy' * xhat
  float* part_b = sh + rl * cb;      // [rl * cb]: sum dy'
  float* chan = sh + 2 * rl * cb;    // [2 * cb]: gamma * dgamma_c, gamma * dbeta_c
  float* gstat = chan + 2 * cb;      // [2 * gib]: mean(dz * xhat), mean(dz)

  const size_t g = (size_t)n * G + c / gs;
  const float m = mean[g], rs = rstd[g];
  const float ga = gamma[c], be = beta[c];
  float pg = 0.f, pb = 0.f;
  for (int r = ty; r < S; r += rl) {
    const size_t i = base + (size_t)r * C + c;
    const float xh = __fmul_rn(__fsub_rn(to_f(x[i]), m), rs);
    float d = to_f(dy[i]);
    if (relu) d = (__fadd_rn(__fmul_rn(xh, ga), be) > 0.f) ? d : 0.f;
    pg += d * xh;
    pb += d;
  }
  part_g[tid] = pg;
  part_b[tid] = pb;
  __syncthreads();
  if (tid < cb) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < rl; ++j) {
      a += part_g[j * cb + tid];
      b += part_b[j * cb + tid];
    }
    dgamma[(size_t)n * C + c0 + tid] = a;
    dbeta[(size_t)n * C + c0 + tid] = b;
    const float gc = gamma[c0 + tid];
    chan[tid] = gc * a;       // sum over the channel of dz * xhat
    chan[cb + tid] = gc * b;  // sum over the channel of dz
  }
  __syncthreads();
  if (tid < gib) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < gs; ++k) {
      a += chan[tid * gs + k];
      b += chan[cb + tid * gs + k];
    }
    const float cnt = (float)S * (float)gs;
    gstat[tid] = a / cnt;
    gstat[gib + tid] = b / cnt;
  }
  __syncthreads();
  const float m2 = gstat[tx / gs], m1 = gstat[gib + tx / gs];
  for (int r = ty; r < S; r += rl) {
    const size_t i = base + (size_t)r * C + c;
    const float xh = __fmul_rn(__fsub_rn(to_f(x[i]), m), rs);
    float d = to_f(dy[i]);
    if (relu) d = (__fadd_rn(__fmul_rn(xh, ga), be) > 0.f) ? d : 0.f;
    dx[i] = from_f<T>(rs * (d * ga - m1 - xh * m2));
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError(): a refused launch never runs, and only this
// check reports it. cb channels per block (a multiple of C / G dividing
// C), rl row lanes; cb * rl <= 1024.
extern "C" int gn_fwd(const void* x, const float* gamma, const float* beta, void* y,
                      float* mean, float* rstd, int N, int S, int C, int G, int cb,
                      int rl, float eps, int relu, int is_bf16, void* stream) {
  const dim3 grid(C / cb, N), block(cb, rl);
  const int gib = cb / (C / G);
  const size_t smem = (size_t)(2 * rl * cb + 2 * gib) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    gn_fwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        (const __nv_bfloat16*)x, gamma, beta, (__nv_bfloat16*)y, mean, rstd, S, C, G, eps,
        relu);
  else
    gn_fwd_kernel<float><<<grid, block, smem, s>>>((const float*)x, gamma, beta, (float*)y,
                                                   mean, rstd, S, C, G, eps, relu);
  return (int)cudaGetLastError();
}

extern "C" int gn_bwd(const void* x, const void* dy, const float* gamma, const float* beta,
                      const float* mean, const float* rstd, void* dx, float* dgamma,
                      float* dbeta, int N, int S, int C, int G, int cb, int rl, int relu,
                      int is_bf16, void* stream) {
  const dim3 grid(C / cb, N), block(cb, rl);
  const int gib = cb / (C / G);
  const size_t smem = (size_t)(2 * rl * cb + 2 * cb + 2 * gib) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    gn_bwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, gamma, beta, mean, rstd,
        (__nv_bfloat16*)dx, dgamma, dbeta, S, C, G, relu);
  else
    gn_bwd_kernel<float><<<grid, block, smem, s>>>((const float*)x, (const float*)dy, gamma,
                                                   beta, mean, rstd, (float*)dx, dgamma,
                                                   dbeta, S, C, G, relu);
  return (int)cudaGetLastError();
}
