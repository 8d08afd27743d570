// Fused negative binomial NLL, forward (K1) and backward (K2), for Hopper.
//
// Both kernels take y, mu, theta as contiguous float32 arrays of n = B*G
// elements (theta full (B, G)), and compute what the JAX package's Pallas
// kernels compute with with_pi=False and no weights
// (dca_tpu/ops/fused_loss.py, _elem_terms / _elem_grads):
//   NaN targets are evaluated at y = 0, theta is clipped at 1e6,
//   eps = 1e-10, and the log(1 + mu/theta) term is log1pf.
// Plain C interface, loaded with ctypes by dca_tpu_torch/ops/_build.py.
// Each launcher returns cudaGetLastError() for the wrapper to check; the
// kernels run on the caller's stream, never synchronise and allocate
// nothing.

#include <cuda_runtime.h>
#include <math.h>

#include "special.cuh"

#define DCA_EPS 1e-10f
#define DCA_THETA_CLIP 1e6f

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
// K1 is a grid-stride loop over a block count fixed by n alone: 8 blocks of
// 256 threads per SM at most, so the summation order, and the loss, are the
// same on every run.
constexpr long long kFwdMaxBlocks = 132 * 8;
constexpr int kBwdThreads = 256;

// min(theta, 1e6) that keeps a NaN theta NaN, as jnp.minimum and
// torch.clamp do (fminf would return the clip)
__device__ __forceinline__ float clip_theta(float th_raw) {
    return th_raw > DCA_THETA_CLIP ? DCA_THETA_CLIP : th_raw;
}

__device__ __forceinline__ float nb_elem(float y, float mu, float th_raw) {
    const float y0 = isnan(y) ? 0.0f : y;
    const float th = clip_theta(th_raw);
    const float t1 = dca_lgamma(th + DCA_EPS) + dca_lgamma(y0 + 1.0f) -
                     dca_lgamma(y0 + th + DCA_EPS);
    const float t2 = (th + y0) * log1pf(mu / (th + DCA_EPS)) +
                     y0 * (logf(th + DCA_EPS) - logf(mu + DCA_EPS));
    return t1 + t2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
    }
    return v;
}

// K1: per block, the sum of the elementwise NLL and the number of non-NaN
// targets.  partials is (2, gridDim.x): row 0 the sums, row 1 the counts.
__global__ void __launch_bounds__(kFwdThreads)
nb_nll_fwd_kernel(const float* __restrict__ y, const float* __restrict__ mu,
                  const float* __restrict__ th, float* __restrict__ partials,
                  long long n) {
    float s = 0.0f;
    float c = 0.0f;
    const long long stride = (long long)gridDim.x * kFwdThreads;
    for (long long i = (long long)blockIdx.x * kFwdThreads + threadIdx.x; i < n;
         i += stride) {
        const float yv = y[i];
        s += nb_elem(yv, mu[i], th[i]);
        c += isnan(yv) ? 0.0f : 1.0f;
    }
    s = warp_sum(s);
    c = warp_sum(c);

    __shared__ float ws[kFwdWarps];
    __shared__ float wc[kFwdWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        ws[warp] = s;
        wc[warp] = c;
    }
    __syncthreads();
    if (warp == 0) {
        s = lane < kFwdWarps ? ws[lane] : 0.0f;
        c = lane < kFwdWarps ? wc[lane] : 0.0f;
        s = warp_sum(s);
        c = warp_sum(c);
        if (lane == 0) {
            partials[blockIdx.x] = s;
            partials[gridDim.x + blockIdx.x] = c;
        }
    }
}

// K2: d loss / d mu and d loss / d theta, each times *scale (= g / denom,
// read from device memory).  d theta is 0 where theta was clipped.
__global__ void __launch_bounds__(kBwdThreads)
nb_nll_bwd_kernel(const float* __restrict__ y, const float* __restrict__ mu,
                  const float* __restrict__ th, const float* __restrict__ scale,
                  float* __restrict__ dmu, float* __restrict__ dth, long long n) {
    const long long i = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
    if (i >= n) return;
    const float s = *scale;
    const float yv = y[i];
    const float m = mu[i];
    const float th_raw = th[i];
    const float y0 = isnan(yv) ? 0.0f : yv;
    const float t = clip_theta(th_raw);
    const float th_e = t + DCA_EPS;
    const float mu_e = m + DCA_EPS;
    const float thmu = th_e + m;

    const float dmu_nb = (t + y0) / thmu - y0 / mu_e;
    const float dth_nb = dca_digamma(th_e) - dca_digamma(y0 + th_e) +
                         log1pf(m / th_e) +
                         (t + y0) * (1.0f / thmu - 1.0f / th_e) + y0 / th_e;
    const float dth_v = th_raw > DCA_THETA_CLIP ? 0.0f : dth_nb;
    dmu[i] = dmu_nb * s;
    dth[i] = dth_v * s;
}

}  // namespace

extern "C" {

const char* dca_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Number of blocks K1 uses for n elements: the length of each row of the
// partials buffer the caller allocates.
int dca_nb_nll_fwd_grid(long long n) {
    long long b = (n + kFwdThreads - 1) / kFwdThreads;
    if (b > kFwdMaxBlocks) b = kFwdMaxBlocks;
    return (int)(b < 1 ? 1 : b);
}

int dca_nb_nll_fwd(const float* y, const float* mu, const float* th,
                   float* partials, long long n, void* stream) {
    const int grid = dca_nb_nll_fwd_grid(n);
    nb_nll_fwd_kernel<<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
        y, mu, th, partials, n);
    return (int)cudaGetLastError();
}

int dca_nb_nll_bwd(const float* y, const float* mu, const float* th,
                   const float* scale, float* dmu, float* dth, long long n,
                   void* stream) {
    const long long grid = (n + kBwdThreads - 1) / kBwdThreads;
    nb_nll_bwd_kernel<<<(unsigned int)grid, kBwdThreads, 0,
                        (cudaStream_t)stream>>>(y, mu, th, scale, dmu, dth, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
