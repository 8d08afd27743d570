// Fused dense block (K4) for Hopper: Dense -> folded inference BatchNorm ->
// activation [-> size-factor multiply] in one pass,
//
//   out[m, n] = act((sum_k x[m, k] w[k, n] + b[n]) * s[n] + t[n]) * sf[m]
//
// with s = rsqrt(moving_var + 1e-3) and t = beta - moving_mean * s folded by
// the wrapper (ops/fused_dense.py), as the JAX package's Pallas kernel
// dca_tpu/ops/fused_dense.py::_kernel (driven by fused_dense_block) computes
// it: the product accumulates in float32, and the epilogue runs on the
// finished accumulator, so the (M, N) pre-activation never goes through
// device memory.  The BN affine and the size factors are optional (kernel
// arguments with_bn, with_sf); the activation is a template parameter, one
// of the 8 epilogues of the JAX kernel.  With BF16 the operands x and w are
// rounded to bfloat16 (round to nearest even) as they are loaded, and the
// accumulator stays float32: a product of two bfloat16 values is exact in
// float32, so this is JAX's bf16 dot with preferred_element_type=f32.
//
// Design, correct first: a block computes a BM x 64 tile of the output from
// BK = 16 deep slices of x and w staged in shared memory; each of its 256
// threads keeps TM x 4 accumulators in registers (rows ty + 16 i, columns
// tx + 16 j).  The ragged edges are masked by index (zeros are loaded past
// M, N and K; nothing past M or N is stored); nothing is padded in device
// memory.  The K loop runs inside the block: no split-K, no atomics, so the
// result is the same bits on every run.  The launcher picks BM = 64 when the
// 64 x 64 tiles give at least two blocks per SM, else BM = 16: the encoder
// layer (2730, 3451) @ (3451, 64) gives 43 tiles of 64 x 64 for 132 SMs,
// and 171 of 16 x 64.  The epilogue's additions and multiplications are
// written with explicit rounding (__fadd_rn, __fmul_rn) so that no fused
// multiply-add changes them: the pre-activation is the same bits for every
// activation, and the plain version's separate operations give the same
// epilogue bits.  Tensor cores, TMA and split-K are later work.
//
// Bound on the H100 (at the predict of the 2730 x 3451 main path): the
// operations, 2 M N K = 1.21 GFLOP per layer, at 67 TFLOP/s float32 outside
// the tensor cores (TF32 is off in the port), 18 us; the bytes (39 MB for a
// 64 -> 3451 head and for the 3451 -> 64 encoder) take 12 us at 3.35 TB/s.
//
// Plain C interface, loaded with ctypes by dca_tpu_torch/ops/_build.py.  The
// launcher returns cudaGetLastError() for the wrapper to check; the kernel
// runs on the caller's stream, never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kDenseThreads = 256;
constexpr int kDenseBN = 64;  // output columns per block
constexpr int kDenseBK = 16;  // depth of one shared-memory slice
constexpr int kDenseTN = 4;   // columns per thread, 16 apart
constexpr int kDenseSMs = 132;

// Activations, as ops/fused_dense.py's _ACT_CODES numbers them.
constexpr int kMean = 0;
constexpr int kDisp = 1;
constexpr int kSigmoid = 2;
constexpr int kRelu = 3;
constexpr int kSelu = 4;
constexpr int kElu = 5;
constexpr int kTanh = 6;
constexpr int kLinear = 7;

// jax.nn.selu's constants, rounded to float32
constexpr float kSeluScale = 1.0507009873554805f;
constexpr float kSeluAlpha = 1.6732632423543772f;

// clip(v, lo, hi) that keeps a NaN NaN, as jnp.clip and torch.clamp do
// (fminf/fmaxf would return a bound)
__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
    v = v < lo ? lo : v;
    return v > hi ? hi : v;
}

template <int ACT>
__device__ __forceinline__ float activate(float z) {
    if (ACT == kMean) {  // MeanAct: clip(exp(z), 1e-5, 1e6)
        return clip_keep_nan(expf(z), 1e-5f, 1e6f);
    }
    if (ACT == kDisp) {
        // DispAct: clip(softplus(z), 1e-4, 1e4), softplus as jax.nn.softplus
        // computes it, max(z, 0) + log1p(exp(-|z|)), which does not overflow
        // where exp(z) would (z > 88); z < 0 ? 0 : z keeps a NaN NaN
        const float sp = __fadd_rn(z < 0.0f ? 0.0f : z, log1pf(expf(-fabsf(z))));
        return clip_keep_nan(sp, 1e-4f, 1e4f);
    }
    if (ACT == kSigmoid) return 1.0f / __fadd_rn(1.0f, expf(-z));
    if (ACT == kRelu) return z < 0.0f ? 0.0f : z;  // NaN stays NaN
    if (ACT == kSelu) return kSeluScale * (z > 0.0f ? z : kSeluAlpha * expm1f(z));
    if (ACT == kElu) return z > 0.0f ? z : expm1f(z);
    if (ACT == kTanh) return tanhf(z);
    return z;  // kLinear
}

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <int ACT, bool BF16, int TM>
__global__ void __launch_bounds__(kDenseThreads)
fused_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ s,
                   const float* __restrict__ t, const float* __restrict__ sf,
                   float* __restrict__ out, int M, int K, int N, int with_bn,
                   int with_sf) {
    constexpr int BM = 16 * TM;
    // x slice stored transposed, [k][row]; the +1 spreads its column
    // writes over the banks
    __shared__ float xs[kDenseBK][BM + 1];
    __shared__ float ws[kDenseBK][kDenseBN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const long long m0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * kDenseBN;

    float acc[TM][kDenseTN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < kDenseTN; ++j) acc[i][j] = 0.0f;
    }

    for (int k0 = 0; k0 < K; k0 += kDenseBK) {
        // x: BM rows of 16 consecutive k; neighbouring threads read
        // neighbouring addresses along k
#pragma unroll
        for (int e = tid; e < BM * kDenseBK; e += kDenseThreads) {
            const int r = e / kDenseBK;
            const int kk = e % kDenseBK;
            const long long m = m0 + r;
            const int k = k0 + kk;
            float v = (m < M && k < K) ? x[m * K + k] : 0.0f;
            xs[kk][r] = BF16 ? round_bf16(v) : v;
        }
        // w: 16 rows of 64 consecutive columns
#pragma unroll
        for (int e = tid; e < kDenseBK * kDenseBN; e += kDenseThreads) {
            const int kk = e / kDenseBN;
            const int c = e % kDenseBN;
            const int k = k0 + kk;
            const int n = n0 + c;
            float v = (k < K && n < N) ? w[(long long)k * N + n] : 0.0f;
            ws[kk][c] = BF16 ? round_bf16(v) : v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kDenseBK; ++kk) {
            float a[TM];
            float b[kDenseTN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < kDenseTN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
#pragma unroll
                for (int j = 0; j < kDenseTN; ++j) {
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
                }
            }
        }
        __syncthreads();
    }

    // epilogue on the finished accumulators
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long m = m0 + ty + 16 * i;
        if (m >= M) continue;
        const float sfv = with_sf ? sf[m] : 1.0f;
#pragma unroll
        for (int j = 0; j < kDenseTN; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n >= N) continue;
            float z = __fadd_rn(acc[i][j], bias[n]);
            if (with_bn) z = __fadd_rn(__fmul_rn(z, s[n]), t[n]);
            z = activate<ACT>(z);
            if (with_sf) z = __fmul_rn(z, sfv);
            out[m * N + n] = z;
        }
    }
}

template <int ACT, bool BF16>
int launch(const float* x, const float* w, const float* b, const float* s,
           const float* t, const float* sf, float* out, int M, int K, int N,
           int with_bn, int with_sf, cudaStream_t st) {
    const long long col_blocks = (N + kDenseBN - 1) / kDenseBN;
    const long long tiles64 = ((M + 63LL) / 64) * col_blocks;
    if (tiles64 >= 2LL * kDenseSMs) {
        const dim3 grid((unsigned int)((M + 63LL) / 64), (unsigned int)col_blocks);
        fused_dense_kernel<ACT, BF16, 4><<<grid, kDenseThreads, 0, st>>>(
            x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf);
    } else {
        const dim3 grid((unsigned int)((M + 15LL) / 16), (unsigned int)col_blocks);
        fused_dense_kernel<ACT, BF16, 1><<<grid, kDenseThreads, 0, st>>>(
            x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf);
    }
    return (int)cudaGetLastError();
}

template <bool BF16>
int launch_act(int act, const float* x, const float* w, const float* b,
               const float* s, const float* t, const float* sf, float* out,
               int M, int K, int N, int with_bn, int with_sf, cudaStream_t st) {
    switch (act) {
        case kMean:
            return launch<kMean, BF16>(x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf, st);
        case kDisp:
            return launch<kDisp, BF16>(x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf, st);
        case kSigmoid:
            return launch<kSigmoid, BF16>(x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf, st);
        case kRelu:
            return launch<kRelu, BF16>(x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf, st);
        case kSelu:
            return launch<kSelu, BF16>(x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf, st);
        case kElu:
            return launch<kElu, BF16>(x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf, st);
        case kTanh:
            return launch<kTanh, BF16>(x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf, st);
        case kLinear:
            return launch<kLinear, BF16>(x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// x (M, K), w (K, N), b (N,), s and t (N,) when with_bn, sf (M,) when
// with_sf, out (M, N): contiguous float32.  s, t and sf are not read (and
// may be NULL) unless their flag is set.  M, N >= 1 and N <= 64 * 65535.
int dca_fused_dense(const float* x, const float* w, const float* b,
                    const float* s, const float* t, const float* sf, float* out,
                    int M, int K, int N, int act, int with_bn, int with_sf,
                    int bf16, void* stream) {
    if (M < 1 || N < 1 || K < 0 || (N + kDenseBN - 1) / kDenseBN > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {
        return launch_act<true>(act, x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf, st);
    }
    return launch_act<false>(act, x, w, b, s, t, sf, out, M, K, N, with_bn, with_sf, st);
}

}  // extern "C"
