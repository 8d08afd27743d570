// Fused NB and ZINB negative log-likelihood, forward (K1) and backward (K2),
// for Hopper.
//
// Both kernels compute what the JAX package's Pallas kernels compute
// (dca_tpu/ops/fused_loss.py, _elem_terms / _elem_grads), for the NB loss
// and, templated on WITH_PI, the zero-inflated NB loss, and, templated on
// WITH_W, their per-row weighted means (the with_w variants, K1w and K2w):
//   NaN targets are evaluated at y = 0, while the ZINB zero branch tests the
//   original y (y < 1e-8), so a NaN target takes the NB case; theta is
//   clipped at 1e6; eps = 1e-10; the log(1 + mu/theta) term is log1pf; the
//   NB zero probability (theta / (theta + mu + eps))^theta is taken as
//   exp(theta * (log(max(theta, eps)) - log(theta + mu + eps))), and is 1 at
//   theta = 0; ridge * pi^2 is added to every element.
// y and mu are contiguous float32 (B, G) arrays of n = B*G elements.  theta
// and pi may be (B, G), (1, G), (B, 1) or (1, 1): each is read through its
// broadcast mode (bcast_index), so a broadcast operand is never expanded in
// device memory.  The weights w are a (B, 1) column, read through the same
// column index i / G.
// Plain C interface, loaded with ctypes by dca_tpu_torch/ops/_build.py.
// Each launcher returns cudaGetLastError() for the wrapper to check; the
// kernels run on the caller's stream, never synchronise and allocate
// nothing.

#include <cuda_runtime.h>
#include <math.h>

#include "special.cuh"

#define DCA_EPS 1e-10f
#define DCA_THETA_CLIP 1e6f
#define DCA_ZERO_THRESHOLD 1e-8f

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
// K1 is a grid-stride loop over a block count fixed by n alone: 8 blocks of
// 256 threads per SM at most, so the summation order, and the loss, are the
// same on every run.
constexpr long long kFwdMaxBlocks = 132 * 8;
// K1's workspace: the (2, kFwdMaxBlocks) per-block partials, then one
// unsigned ticket counter (the float's bits; 0 between launches).
constexpr long long kFwdWorkspaceFloats = 2 * kFwdMaxBlocks + 1;
constexpr int kBwdThreads = 256;

// Broadcast modes of theta and pi; the wrapper (ops/fused_loss.py) passes
// the same numbers.
constexpr int kFull = 0;    // (B, G): element i
constexpr int kRow = 1;     // (1, G): element i % G
constexpr int kColumn = 2;  // (B, 1): element i / G
// anything else: (1, 1), element 0

__device__ __forceinline__ long long bcast_index(long long i, long long G,
                                                 int mode) {
    if (mode == kFull) return i;
    if (mode == kRow) return i % G;
    if (mode == kColumn) return i / G;
    return 0;
}

// min(theta, 1e6) that keeps a NaN theta NaN, as jnp.minimum and
// torch.clamp do (fminf would return the clip)
__device__ __forceinline__ float clip_theta(float th_raw) {
    return th_raw > DCA_THETA_CLIP ? DCA_THETA_CLIP : th_raw;
}

// max(theta, eps) that keeps a NaN theta NaN, as jnp.maximum does
__device__ __forceinline__ float floor_theta(float th) {
    return th < DCA_EPS ? DCA_EPS : th;
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

// The elementwise NLL: NB, or with WITH_PI the ZINB case selected by y.
template <bool WITH_PI>
__device__ __forceinline__ float nll_elem(float y, float mu, float th_raw,
                                          float pi, float ridge) {
    const float nb = nb_elem(y, mu, th_raw);
    if (!WITH_PI) return nb;
    const float th = clip_theta(th_raw);
    const float nb_case = nb - logf(1.0f - pi + DCA_EPS);
    // expf/logf with the theta > 0 guard, as the JAX kernel: powf rounds
    // otherwise, and 0 * log(0) would be NaN at theta = 0
    const float zero_nb =
        th > 0.0f
            ? expf(th * (logf(floor_theta(th)) - logf(th + mu + DCA_EPS)))
            : 1.0f;
    const float zero_case = -logf(pi + (1.0f - pi) * zero_nb + DCA_EPS);
    // y < 1e-8, not !(y >= 1e-8): a NaN target takes the NB case
    const float res = y < DCA_ZERO_THRESHOLD ? zero_case : nb_case;
    return res + ridge * pi * pi;
}

// The analytic d/d mu, d/d theta and (WITH_PI) d/d pi of nll_elem.
template <bool WITH_PI>
__device__ __forceinline__ void nll_grads(float y, float m, float th_raw,
                                          float pi, float ridge, float* gmu,
                                          float* gth, float* gpi) {
    const float y0 = isnan(y) ? 0.0f : y;
    const float t = clip_theta(th_raw);
    const float th_e = t + DCA_EPS;
    const float mu_e = m + DCA_EPS;
    const float thmu = th_e + m;

    float dmu = (t + y0) / thmu - y0 / mu_e;
    float dth = dca_digamma(th_e) - dca_digamma(y0 + th_e) + log1pf(m / th_e) +
                (t + y0) * (1.0f / thmu - 1.0f / th_e) + y0 / th_e;
    if (WITH_PI) {
        const float safe_th = floor_theta(t);
        const float tme = t + m + DCA_EPS;
        const float z =
            t > 0.0f ? expf(t * (logf(safe_th) - logf(tme))) : 1.0f;
        const float denom = pi + (1.0f - pi) * z + DCA_EPS;
        const bool is_zero = y < DCA_ZERO_THRESHOLD;
        if (is_zero) {
            const float dz_dmu = -z * t / tme;
            const float dz_dth =
                z * (logf(safe_th) - logf(tme) + 1.0f - t / tme);
            dmu = -(1.0f - pi) * dz_dmu / denom;
            dth = -(1.0f - pi) * dz_dth / denom;
        }
        const float dpi = is_zero ? -(1.0f - z) / denom
                                  : 1.0f / (1.0f - pi + DCA_EPS);
        *gpi = dpi + 2.0f * ridge * pi;
    }
    *gmu = dmu;
    *gth = th_raw > DCA_THETA_CLIP ? 0.0f : dth;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
    }
    return v;
}

// K1: the sum of the elementwise NLL and the count for the denominator:
// non-NaN targets for NB, non-NaN results for ZINB (the JAX losses' _nelem
// and _reduce_mean_nan).  With WITH_W (K1w), the sum of res * w and the sum
// of w over the non-NaN targets (losses._apply_weights: a NaN target weighs
// 0; a non-finite res times a weight of 0 stays NaN, as in JAX).
//
// One launch gives the mean: each block sums its elements (a grid-stride
// loop, then the warp by shuffles and the block through shared memory) and
// writes its (sum, count) pair to the workspace; its thread 0 then makes the
// pair visible (__threadfence) and draws a ticket (atomicAdd on the
// counter).  The block that draws the last ticket sums the gridDim.x pairs
// in a fixed order (thread t takes blocks t, t + 256, ..., then the warp and
// block trees, as above), forms the denominator as the wrapper's
// _denominator does, max(count, 1), or weighted where(total == 0, 1, total),
// writes out = (sum, count, sum / denom, denom) and sets the counter back to
// 0.  This is CUDA's threadfence-reduction pattern: the ticket is the only
// atomic, and it orders nothing in the sum, so the loss is the same bits on
// every run.  The workspace is one per device, so two streams of one device
// must not run K1 at once (the port never does: its data-parallel ranks
// are separate processes).
template <bool WITH_PI, bool WITH_W>
__global__ void __launch_bounds__(kFwdThreads)
nll_fwd_kernel(const float* __restrict__ y, const float* __restrict__ mu,
               const float* __restrict__ th, const float* __restrict__ pi,
               const float* __restrict__ w, float* work,
               float* __restrict__ out, long long n, long long G, int th_mode,
               int pi_mode, float ridge) {
    float s = 0.0f;
    float c = 0.0f;
    const long long stride = (long long)gridDim.x * kFwdThreads;
    for (long long i = (long long)blockIdx.x * kFwdThreads + threadIdx.x; i < n;
         i += stride) {
        const float yv = y[i];
        const float piv = WITH_PI ? pi[bcast_index(i, G, pi_mode)] : 0.0f;
        const float r = nll_elem<WITH_PI>(
            yv, mu[i], th[bcast_index(i, G, th_mode)], piv, ridge);
        if (WITH_W) {
            const bool valid = !isnan(yv);
            const float wv = w[i / G];
            s += valid ? r * wv : 0.0f;
            c += valid ? wv : 0.0f;
        } else {
            s += r;
            c += isnan(WITH_PI ? r : yv) ? 0.0f : 1.0f;
        }
    }
    s = warp_sum(s);
    c = warp_sum(c);

    __shared__ float ws[kFwdWarps];
    __shared__ float wc[kFwdWarps];
    __shared__ bool last;
    unsigned int* ticket = reinterpret_cast<unsigned int*>(work + 2 * kFwdMaxBlocks);
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
            work[blockIdx.x] = s;
            work[kFwdMaxBlocks + blockIdx.x] = c;
            __threadfence();
            last = atomicAdd(ticket, 1u) == gridDim.x - 1;
        }
    }
    __syncthreads();
    if (!last) return;

    // the last block: every pair is written; read them past the L1
    __threadfence();
    s = 0.0f;
    c = 0.0f;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += kFwdThreads) {
        s += __ldcg(work + b);
        c += __ldcg(work + kFwdMaxBlocks + b);
    }
    s = warp_sum(s);
    c = warp_sum(c);
    if (lane == 0) {
        ws[warp] = s;
        wc[warp] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        s = 0.0f;
        c = 0.0f;
        for (int k = 0; k < kFwdWarps; ++k) {
            s += ws[k];
            c += wc[k];
        }
        const float denom = WITH_W ? (c == 0.0f ? 1.0f : c) : (c < 1.0f ? 1.0f : c);
        out[0] = s;
        out[1] = c;
        out[2] = s / denom;
        out[3] = denom;
        *ticket = 0u;
    }
}

// K2: the full (B, G) d loss / d mu, d theta and (WITH_PI) d pi, each times
// *scale (= g / denom, read from device memory).  d theta is 0 where theta
// was clipped.  With WITH_W (K2w), each times w * scale, formed in that
// order, where the target is not NaN, and exactly 0 where it is: a
// zero-weight (padding) row gets a gradient of exactly 0, and a NaN target
// no y = 0 gradient, unlike the unweighted K2.  A broadcast operand's
// gradient is summed to its shape by the wrapper.
template <bool WITH_PI, bool WITH_W>
__global__ void __launch_bounds__(kBwdThreads)
nll_bwd_kernel(const float* __restrict__ y, const float* __restrict__ mu,
               const float* __restrict__ th, const float* __restrict__ pi,
               const float* __restrict__ w, const float* __restrict__ scale,
               float* __restrict__ dmu, float* __restrict__ dth,
               float* __restrict__ dpi, long long n, long long G, int th_mode,
               int pi_mode, float ridge) {
    const long long i = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
    if (i >= n) return;
    const float yv = y[i];
    const float piv = WITH_PI ? pi[bcast_index(i, G, pi_mode)] : 0.0f;
    float gmu, gth, gpi;
    nll_grads<WITH_PI>(yv, mu[i], th[bcast_index(i, G, th_mode)], piv, ridge,
                       &gmu, &gth, &gpi);
    if (WITH_W) {
        const bool sel = !isnan(yv);
        const float f = w[i / G] * *scale;
        dmu[i] = sel ? gmu * f : 0.0f;
        dth[i] = sel ? gth * f : 0.0f;
        if (WITH_PI) dpi[i] = sel ? gpi * f : 0.0f;
        return;
    }
    const float s = *scale;
    dmu[i] = gmu * s;
    dth[i] = gth * s;
    if (WITH_PI) dpi[i] = gpi * s;
}

template <bool WITH_PI, bool WITH_W>
void launch_fwd(int grid, cudaStream_t st, const float* y, const float* mu,
                const float* th, const float* pi, const float* w, float* work,
                float* out, long long n, long long G, int th_mode, int pi_mode,
                float ridge) {
    nll_fwd_kernel<WITH_PI, WITH_W><<<grid, kFwdThreads, 0, st>>>(
        y, mu, th, pi, w, work, out, n, G, th_mode, pi_mode, ridge);
}

template <bool WITH_PI, bool WITH_W>
void launch_bwd(unsigned int grid, cudaStream_t st, const float* y,
                const float* mu, const float* th, const float* pi,
                const float* w, const float* scale, float* dmu, float* dth,
                float* dpi, long long n, long long G, int th_mode, int pi_mode,
                float ridge) {
    nll_bwd_kernel<WITH_PI, WITH_W><<<grid, kBwdThreads, 0, st>>>(
        y, mu, th, pi, w, scale, dmu, dth, dpi, n, G, th_mode, pi_mode, ridge);
}

}  // namespace

extern "C" {

const char* dca_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Floats of K1's workspace, which the caller allocates once per device,
// zeroed, and passes to every K1 launch on that device.
long long dca_nll_fwd_workspace_floats() { return kFwdWorkspaceFloats; }

// out: 4 floats, (sum, count, loss, denom).  pi is not read (and may be
// NULL) unless with_pi, nor w unless with_w.
int dca_nll_fwd(const float* y, const float* mu, const float* th,
                const float* pi, const float* w, float* work, float* out,
                long long n, long long G, int th_mode, int pi_mode, float ridge,
                int with_pi, int with_w, void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    long long grid = (n + kFwdThreads - 1) / kFwdThreads;
    if (grid > kFwdMaxBlocks) grid = kFwdMaxBlocks;
    const cudaStream_t st = (cudaStream_t)stream;
    auto launch = with_pi ? (with_w ? launch_fwd<true, true> : launch_fwd<true, false>)
                          : (with_w ? launch_fwd<false, true> : launch_fwd<false, false>);
    launch((int)grid, st, y, mu, th, pi, w, work, out, n, G, th_mode, pi_mode, ridge);
    return (int)cudaGetLastError();
}

// pi and dpi are not touched (and may be NULL) unless with_pi, nor w unless
// with_w.
int dca_nll_bwd(const float* y, const float* mu, const float* th,
                const float* pi, const float* w, const float* scale, float* dmu,
                float* dth, float* dpi, long long n, long long G, int th_mode,
                int pi_mode, float ridge, int with_pi, int with_w,
                void* stream) {
    const unsigned int grid =
        (unsigned int)((n + kBwdThreads - 1) / kBwdThreads);
    const cudaStream_t st = (cudaStream_t)stream;
    auto launch = with_pi ? (with_w ? launch_bwd<true, true> : launch_bwd<true, false>)
                          : (with_w ? launch_bwd<false, true> : launch_bwd<false, false>);
    launch(grid, st, y, mu, th, pi, w, scale, dmu, dth, dpi, n, G, th_mode,
           pi_mode, ridge);
    return (int)cudaGetLastError();
}

}  // extern "C"
