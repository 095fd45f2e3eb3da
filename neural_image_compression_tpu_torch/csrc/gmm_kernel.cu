// Discretized Gaussian-mixture log-likelihood for Hopper (sm_90a).
//
//   logp[n, m] = log(max(sum_k w[n,k,m] * (Phi(u) - Phi(l)), 1e-9))
//   u = (y[n,m] + 0.5 - mu[n,k,m]) / sigma[n,k,m],  l = (y[n,m] - 0.5 - mu) / sigma
//   Phi(t) = 0.5 * (1 + erf(t / sqrt(2)))
//
// Replaces the Pallas TPU kernel neural_image_compression_tpu/ops/pallas/
// gmm_kernel.py (`_kernel`, launched by `fused_mixture_log_likelihood`).
// That kernel had to bring its own clipped rational erf, which drifts by
// O(1) nat for 1e-9 < p < 1e-6. This one uses CUDA's erff and the exact
// operation order of the plain path (neural_image_compression_tpu/entropy/
// gaussian.py): 1/sigma by IEEE division, the argument scaled by 1/sqrt(2),
// 0.5 * (1 + erf), so its rates follow the JAX package's, tails included.
//
// What bounds it: device memory. Each position reads y once and w, mu, sigma
// K times and writes logp once, (3K + 2) * M * 4 bytes, against about 40
// operations per (position, component): far below the card's balance point.
//
// Design: one thread per (n, m); the K components are looped inside the
// thread so every input element is read exactly once and nothing but logp is
// written. Neighbouring threads take neighbouring m, so every load and the
// store are coalesced. K is a runtime argument.
//
// Backward (gmm_logp_backward): the JAX package has no Pallas backward; its
// training autodiffs the jnp path (entropy/gaussian.py mixture_likelihood,
// then jnp.log). With G = g / p where p >= 1e-9 and 0 below the floor (the
// floor's gradient), phi the standard normal density and s = sigma:
//   dw_k = G * (Phi(u_k) - Phi(l_k))
//   dmu_k = -G * w_k * (phi(u_k) - phi(l_k)) / s_k
//   dsigma_k = -G * w_k * (phi(u_k) * u_k - phi(l_k) * l_k) / s_k
//   dy = sum_k G * w_k * (phi(u_k) - phi(l_k)) / s_k
// One thread per (n, m) again: the first loop over k recomputes p exactly as
// the forward does (the floor test must agree with it), keeping Phi and the
// edges in registers (K <= 8), the second writes the gradients. Each input
// is read once and each output written once, (6K + 3) * M * 4 bytes a row:
// bound by device memory, and at the flagship's 4,096 rows by the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kFloor = 1e-9f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;
constexpr int MAX_K = 8;

__device__ __forceinline__ float gaussian_cdf(float t) {
  return 0.5f * (1.0f + erff(t * kInvSqrt2));
}

__global__ void __launch_bounds__(THREADS)
gmm_logp_kernel(const float* __restrict__ y, const float* __restrict__ w,
                const float* __restrict__ mu, const float* __restrict__ sigma,
                float* __restrict__ logp, int64_t total, int k, int m) {
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int64_t row = idx / m;
  const int col = (int)(idx - row * m);
  const float yv = y[idx];
  const float y_hi = yv + 0.5f;
  const float y_lo = yv - 0.5f;
  const int64_t base = row * k * m + col;
  float p = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int64_t e = base + (int64_t)j * m;
    const float mean = mu[e];
    const float inv_s = 1.0f / sigma[e];
    const float upper = gaussian_cdf(__fmul_rn(__fsub_rn(y_hi, mean), inv_s));
    const float lower = gaussian_cdf(__fmul_rn(__fsub_rn(y_lo, mean), inv_s));
    p = __fadd_rn(p, __fmul_rn(w[e], __fsub_rn(upper, lower)));
  }
  logp[idx] = logf(fmaxf(p, kFloor));
}

__global__ void __launch_bounds__(THREADS)
gmm_logp_backward_kernel(const float* __restrict__ y, const float* __restrict__ w,
                         const float* __restrict__ mu, const float* __restrict__ sigma,
                         const float* __restrict__ g, float* __restrict__ dy,
                         float* __restrict__ dw, float* __restrict__ dmu,
                         float* __restrict__ dsigma, int64_t total, int k, int m) {
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int64_t row = idx / m;
  const int col = (int)(idx - row * m);
  const float yv = y[idx];
  const float y_hi = yv + 0.5f;
  const float y_lo = yv - 0.5f;
  const int64_t base = row * k * m + col;
  float wv[MAX_K], inv_s[MAX_K], u[MAX_K], l[MAX_K], mass[MAX_K];
  float p = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    if (j < k) {
      const int64_t e = base + (int64_t)j * m;
      const float mean = mu[e];
      wv[j] = w[e];
      inv_s[j] = 1.0f / sigma[e];
      u[j] = __fmul_rn(__fsub_rn(y_hi, mean), inv_s[j]);
      l[j] = __fmul_rn(__fsub_rn(y_lo, mean), inv_s[j]);
      mass[j] = __fsub_rn(gaussian_cdf(u[j]), gaussian_cdf(l[j]));
      p = __fadd_rn(p, __fmul_rn(wv[j], mass[j]));
    }
  }
  const float gp = p >= kFloor ? g[idx] / p : 0.0f;
  float dyv = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    if (j < k) {
      const int64_t e = base + (int64_t)j * m;
      const float pu = kInvSqrt2Pi * expf(-0.5f * u[j] * u[j]);
      const float pl = kInvSqrt2Pi * expf(-0.5f * l[j] * l[j]);
      const float a = gp * wv[j] * inv_s[j];
      dw[e] = gp * mass[j];
      dmu[e] = -a * (pu - pl);
      dsigma[e] = -a * (pu * u[j] - pl * l[j]);
      dyv += a * (pu - pl);
    }
  }
  dy[idx] = dyv;
}

}  // namespace

// y, logp: (n, m); w, mu, sigma: (n, k, m); all float32 and contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue without launching when n, k or m is below 1 or the
// grid would exceed 2^31 - 1 blocks.
extern "C" int gmm_logp_forward(const void* y, const void* w, const void* mu,
                                const void* sigma, void* logp, long long n,
                                int k, int m, void* stream) {
  const int64_t total = (int64_t)n * m;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (n < 1 || k < 1 || m < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gmm_logp_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<const float*>(mu), static_cast<const float*>(sigma),
      static_cast<float*>(logp), total, k, m);
  return (int)cudaGetLastError();
}

// y, g (= dL/dlogp), dy: (n, m); w, mu, sigma, dw, dmu, dsigma: (n, k, m);
// all float32 and contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue without
// launching when n, k or m is below 1, k exceeds 8 or the grid would exceed
// 2^31 - 1 blocks.
extern "C" int gmm_logp_backward(const void* y, const void* w, const void* mu,
                                 const void* sigma, const void* g, void* dy, void* dw,
                                 void* dmu, void* dsigma, long long n, int k, int m,
                                 void* stream) {
  const int64_t total = (int64_t)n * m;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (n < 1 || k < 1 || k > MAX_K || m < 1 || blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  gmm_logp_backward_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<const float*>(mu), static_cast<const float*>(sigma),
      static_cast<const float*>(g), static_cast<float*>(dy), static_cast<float*>(dw),
      static_cast<float*>(dmu), static_cast<float*>(dsigma), total, k, m);
  return (int)cudaGetLastError();
}
