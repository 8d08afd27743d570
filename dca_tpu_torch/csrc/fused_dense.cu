// Fused dense block (K4) for Hopper: Dense -> folded inference BatchNorm ->
// activation [-> size-factor multiply] in one pass,
//
//   out[m, n] = act((sum_k x[m, k] w[k, n] + b[n]) * s[n] + t[n]) * sf[m]
//
// with s = rsqrt(moving_var + 1e-3) and t = beta - moving_mean * s folded by
// the wrapper (ops/fused_dense.py).  It replaces the JAX package's Pallas
// kernel dca_tpu/ops/fused_dense.py::_kernel (driven by fused_dense_block):
// the product accumulates in float32 and the epilogue runs on the finished
// sum, so the (M, N) pre-activation never goes through device memory.  The
// BN affine and the size factors are optional (with_bn, with_sf); the
// activation is one of the JAX kernel's 8 epilogues (act).  With BF16 the
// operands x and w are rounded to bfloat16 (round to nearest even) as they
// are staged in shared memory, and the accumulator stays float32: a product
// of two bfloat16 values is exact in float32, so this is JAX's bf16 dot with
// preferred_element_type=f32.
//
// Bound on the H100, by operations at every main-path shape: 2 M N K flops
// at 67 TFLOP/s float32 on the CUDA cores (TF32 stays off, device.py), 18 us
// for the encoder (2730, 3451) @ (3451, 64) and for each head (2730, 64) @
// (64, 3451), against 11-12 us for their bytes at 3.35 TB/s (x or the
// output, 37.7 MB, dominates).  Both tilings therefore keep the FMA pipes
// fed from registers: 128 x 64 output tiles, 8 x 4 accumulators a thread
// (rows 8 ty .. 8 ty + 7, columns tx + 16 j), x staged transposed in shared
// memory ([k][row], rows padded to 132 floats) so that a thread's 8 rows
// are two float4 reads, w staged as [k][column] so that its 4 columns are
// scalar reads shared by both half-warps: 6 shared reads for 32 FMAs a k.
// A plan chosen in Python (ops/fused_dense.py::plan, from M, K, N and the
// device alone, never from the epilogue, so every epilogue sees the same
// sum order) picks the tiling; this file checks the plan against its
// constants.
//
// (1) Split-K across a thread-block cluster, for K > 64 (the encoder: thin
//     N, long K).  Its 22 row tiles would leave most of the 132 SMs idle,
//     so each tile's K range is cut into S slices of whole 32-deep steps,
//     one block a slice, and the S blocks of a tile form one cluster (S <=
//     8, the portable limit).  A block has 512 threads in two groups that
//     take the two 16-k halves of every step into their own accumulators,
//     16 warps an SM.  Steps are loaded through registers two steps ahead
//     (coalesced 4-byte loads: see the alignment trap below) into two
//     shared buffers, one barrier a step.  The partial tiles are then
//     summed through distributed shared memory: every block parks its two
//     partials in its own shared memory, the cluster synchronises, and
//     block r sums rows [128 r / S, 128 (r + 1) / S) of all 2 S partials in
//     fixed (rank, group) order and runs the epilogue on them.  Spreading
//     the sum over the S blocks, rather than one leader reading S - 1
//     remote tiles, spreads the remote reads over S SMs; the order of the
//     additions, and so the bits, are the same on every run.  No float
//     atomics, no global workspace; a row's partials hold only that row's
//     products, so a NaN in one row of x leaves the other rows' bits as
//     they were.  A cluster sits in one GPC, so the plan keeps all of a
//     launch's clusters resident at once (dca_fused_dense_max_clusters): on
//     the H100 the encoder runs S = 5, 110 blocks, because 22 clusters of 6
//     do not fit in one wave.
// (2) Whole K in shared memory, for K <= 64 (the heads and the decoder:
//     wide N, short K).  A block of 256 threads loads its x and w tiles
//     once, every load in flight at once, one barrier, and runs the k loop
//     from shared memory; three blocks an SM.  The finished tile goes
//     through shared memory so that a thread takes one column (its bias and
//     BN read once) and a warp stores 32 neighbouring columns of a row.  Its
//     epilogue covers every output of a head, so it is compiled for each
//     activation; split-K's, over a thin output, picks it at run time.
//
// Traps of the main-path shapes:
// - TMA cannot read x or a head's w as they are: a TMA tensor's global
//   stride must be a multiple of 16 bytes, and a 3451-float row is 13,804
//   bytes, 12 mod 16.  Only the encoder's w, (3451, 64) with 256-byte rows,
//   would qualify.  Nor can 16-byte cp.async or float4 loads take x's rows
//   at their own offsets, and 4-byte cp.async copies were slower than
//   loads through registers in a trial on the H100.  So x and w are read
//   with coalesced 4-byte loads into registers (a warp to 32 neighbouring
//   floats of a row) and stored to shared memory from there, where the
//   transpose and the bfloat16 rounding happen.  The same alignment rules out float4 stores
//   of the (2730, 3451) output, whose rows start at any 4-byte offset: it
//   is written as 32-bit words, 32 neighbouring columns to a warp.
// - The ragged edges are masked by index and nothing is padded in device
//   memory: M = 2730 is not a multiple of 128, K = 3451 not of 32 (the last
//   step of the last slice is ragged), N = 3451 not of 64.  Elements past
//   M, N or K are loaded as zeros and nothing past M or N is stored.
// - The epilogue's additions and multiplications are written with explicit
//   rounding (__fadd_rn, __fmul_rn) so that no fused multiply-add changes
//   them: the pre-activation is the same bits for every activation, and the
//   plain version's separate operations give the same epilogue bits.
//
// Plain C interface, loaded with ctypes by dca_tpu_torch/ops/_build.py.  The
// launcher returns cudaGetLastError() for the wrapper to check; the kernel
// runs on the caller's stream, never synchronises and allocates nothing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

// Plan kinds, as ops/fused_dense.py numbers them.
constexpr int kWide = 0;
constexpr int kSplitK = 1;

// Both tilings: 128 x 64 output tiles of 256 threads, 8 x 4 accumulators a
// thread (rows 8 ty .. 8 ty + 7, columns tx + 16 j).
constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kTM = 8;
constexpr int kTN = 4;
// x staged as [k][row]: 132 floats a row keeps the float4 reads of 8 ty
// aligned; w staged as [k][column]
constexpr int kXStride = kBM + 4;
// the finished tile as [row][column]: 66 floats a row puts rows 8 apart
// (one warp's two rows) on other banks
constexpr int kOutStride = kBN + 2;

// split-K: 32-deep steps in two shared buffers, loaded through registers
// two steps ahead; 512 threads in two groups of 256, group g taking k 16 g
// .. 16 g + 15 of every step into its own accumulators
constexpr int kSkThreads = 2 * kThreads;
constexpr int kSkBK = 32;
constexpr int kSkMaxSplits = 8;  // the portable cluster size
constexpr int kSkBuf = kSkBK * (kXStride + kBN);  // 6,272 floats
constexpr int kSkPart = kBM * kOutStride;          // 8,448 floats a group's partial
constexpr int kSkSmemBytes =
    (2 * kSkBuf > 2 * kSkPart ? 2 * kSkBuf : 2 * kSkPart) * 4;  // 67,584

// whole K: up to 64 deep, staged at once
constexpr int kWideMaxK = 64;
constexpr int kWideSmemBytes = kWideMaxK * (kXStride + kBN) * 4;  // 50,176

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
    if (ACT == kMean) return clip_keep_nan(expf(z), 1e-5f, 1e6f);  // MeanAct
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

// The activation chosen at run time, for the split-K epilogue, which
// touches few outputs; the whole-K kernel, whose epilogue covers every
// output of a head, is compiled for each activation (the eight inlined in
// one loop made it markedly slower at the heads' shape in a trial on an
// H100).
__device__ __forceinline__ float activate(int act, float z) {
    switch (act) {
        case kMean: return activate<kMean>(z);
        case kDisp: return activate<kDisp>(z);
        case kSigmoid: return activate<kSigmoid>(z);
        case kRelu: return activate<kRelu>(z);
        case kSelu: return activate<kSelu>(z);
        case kElu: return activate<kElu>(z);
        case kTanh: return activate<kTanh>(z);
        default: return z;  // kLinear
    }
}

// The epilogue on one finished sum of row m, column n.
struct Epilogue {
    const float* bias;
    const float* s;
    const float* t;
    const float* sf;
    int act;
    int with_bn;
    int with_sf;

    // with column n's bias b, BN scale sc and shift sh already read; the
    // activation act, or ACT when it is not -1
    template <int ACT = -1>
    __device__ __forceinline__ float apply(float acc, float b, float sc, float sh,
                                           long long m) const {
        float z = __fadd_rn(acc, b);
        if (with_bn) z = __fadd_rn(__fmul_rn(z, sc), sh);
        z = ACT < 0 ? activate(act, z) : activate<(ACT < 0 ? kLinear : ACT)>(z);
        if (with_sf) z = __fmul_rn(z, sf[m]);
        return z;
    }
};

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// the parts both tilings share
// ---------------------------------------------------------------------------

// One thread's part of a KW-deep slice of x (128 rows) and of w (64
// columns) when T threads share it, held in registers between its global
// loads and its shared stores.
template <int KW, int T>
struct Slice {
    float x[kBM * KW / T];
    float w[KW * kBN / T];
};

// Load a slice from k0 on: x with a warp to 32 neighbouring k of a row (or
// two rows of 16), w with a warp to 32 neighbouring columns of a k; zeros
// past M, N and K.  Every load of the slice is in flight at once.
template <int KW, int T>
__device__ __forceinline__ void fetch(Slice<KW, T>& sl, const float* __restrict__ x,
                                      const float* __restrict__ w, long long m0, int n0, int k0,
                                      int M, int K, int N) {
    const int tid = threadIdx.x;
    const int kx = k0 + tid % KW;
#pragma unroll
    for (int q = 0; q < kBM * KW / T; ++q) {
        const long long m = m0 + tid / KW + (T / KW) * q;
        sl.x[q] = (m < M && kx < K) ? x[m * K + kx] : 0.0f;
    }
    const int n = n0 + tid % kBN;
#pragma unroll
    for (int q = 0; q < KW * kBN / T; ++q) {
        const int k = k0 + tid / kBN + (T / kBN) * q;
        sl.w[q] = (k < K && n < N) ? w[(long long)k * N + n] : 0.0f;
    }
}

// Store a fetched slice: x transposed into xs ([k][row]), w into ws
// ([k][column]), rounded to bfloat16 with BF16.
template <int KW, int T, bool BF16>
__device__ __forceinline__ void stash(const Slice<KW, T>& sl, float* xs, float* ws) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < kBM * KW / T; ++q) {
        xs[(tid % KW) * kXStride + tid / KW + (T / KW) * q] =
            BF16 ? round_bf16(sl.x[q]) : sl.x[q];
    }
#pragma unroll
    for (int q = 0; q < KW * kBN / T; ++q) {
        ws[(tid / kBN + (T / kBN) * q) * kBN + tid % kBN] = BF16 ? round_bf16(sl.w[q]) : sl.w[q];
    }
}

// acc += x[:, k] w[k, :] over the staged k < depth, in increasing k: per k
// two float4 reads of x (one warp's two rows: 2 addresses, broadcast) and 4
// reads of w (16 neighbouring columns, broadcast to both half-warps) for 32
// FMAs.
__device__ __forceinline__ void multiply(const float* xs, const float* ws, int depth,
                                         float (&acc)[kTM][kTN], int tx, int ty) {
#pragma unroll 4
    for (int k = 0; k < depth; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(xs + k * kXStride + 8 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(xs + k * kXStride + 8 * ty + 4);
        const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = ws[k * kBN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
}

// The accumulators into a [row][column] tile of shared memory.
__device__ __forceinline__ void park(float* tile, const float (&acc)[kTM][kTN], int tx,
                                     int ty) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) tile[(8 * ty + i) * kOutStride + tx + 16 * j] = acc[i][j];
    }
}

// ---------------------------------------------------------------------------
// (1) split-K across a cluster
// ---------------------------------------------------------------------------


template <bool BF16>
__global__ void __launch_bounds__(kSkThreads, 1)
dense_splitk_kernel(const float* __restrict__ x, const float* __restrict__ w, Epilogue epi,
                    float* __restrict__ out, int M, int K, int N, int splits) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();  // the K slice: blockIdx.x % splits
    const long long m0 = (long long)(blockIdx.x / splits) * kBM;
    const int n0 = blockIdx.y * kBN;
    const int tid = threadIdx.x;
    const int group = tid / kThreads;  // k 16 group .. 16 group + 15 of each step
    const int tx = tid % 16;
    const int ty = (tid % kThreads) / 16;

    // this slice's 32-deep steps: [rank T / S, (rank + 1) T / S) of T
    const int steps = (K + kSkBK - 1) / kSkBK;
    const int s_begin = (int)((long long)rank * steps / splits);
    const int n_steps = (int)((long long)(rank + 1) * steps / splits) - s_begin;
    const int k_begin = s_begin * kSkBK;

    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    }
    // step s + 1 is in registers while step s's FMAs run: each step's loads
    // are issued a step before it is stored (deeper, up to 4, measured no
    // faster on the H100)
    constexpr int D = 2;
    Slice<kSkBK, kSkThreads> sl[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        if (d < n_steps) fetch(sl[d], x, w, m0, n0, k_begin + d * kSkBK, M, K, N);
    }
    if (n_steps > 0) stash<kSkBK, kSkThreads, BF16>(sl[0], smem, smem + kSkBK * kXStride);
    __syncthreads();
    for (int s = 0; s < n_steps; s += D) {
#pragma unroll
        for (int h = 0; h < D; ++h) {  // step s + h; sl[h] was stored in the step before
            const int st = s + h;
            if (st < n_steps) {
                if (st + D < n_steps) {
                    fetch(sl[h], x, w, m0, n0, k_begin + (st + D) * kSkBK, M, K, N);
                }
                const float* xs = smem + (st % 2) * kSkBuf;
                multiply(xs + 16 * group * kXStride, xs + kSkBK * kXStride + 16 * group * kBN, 16,
                         acc, tx, ty);
                // the other buffer was last read in step st - 1, before the
                // barrier that ended it
                if (st + 1 < n_steps) {
                    float* next = smem + ((st + 1) % 2) * kSkBuf;
                    stash<kSkBK, kSkThreads, BF16>(sl[(h + 1) % D], next, next + kSkBK * kXStride);
                }
                __syncthreads();
            }
        }
    }

    // this slice's two partial tiles in this block's shared memory
    float* part = smem + group * kSkPart;
    park(part, acc, tx, ty);
    cluster.sync();

    // rows [128 rank / S, 128 (rank + 1) / S) of the tile: the 2 S partials
    // summed in (rank, group) order, then the epilogue; a thread takes one
    // column and every eighth row, a warp 32 neighbouring columns
    const int c = tid % kBN;
    const int n = n0 + c;
    if (n < N) {
        const float bn = epi.bias[n];
        const float sn = epi.with_bn ? epi.s[n] : 1.0f;
        const float tn = epi.with_bn ? epi.t[n] : 0.0f;
        for (int r = rank * kBM / splits + tid / kBN; r < (rank + 1) * kBM / splits;
             r += kSkThreads / kBN) {
            const long long m = m0 + r;
            if (m >= M) break;
            float v = 0.0f;
            for (int q = 0; q < splits; ++q) {
                const float* pq = cluster.map_shared_rank(smem, q);
                v += pq[r * kOutStride + c];
                v += pq[kSkPart + r * kOutStride + c];
            }
            out[m * N + n] = epi.apply(v, bn, sn, tn, m);
        }
    }
    // no block leaves while another may still read its partials
    cluster.sync();
}

// ---------------------------------------------------------------------------
// (2) whole K in shared memory
// ---------------------------------------------------------------------------

template <int ACT, bool BF16>
__global__ void __launch_bounds__(kThreads, 3)
dense_wide_kernel(const float* __restrict__ x, const float* __restrict__ w, Epilogue epi,
                  float* __restrict__ out, int M, int K, int N) {
    extern __shared__ __align__(16) float smem[];
    float* xs = smem;
    float* ws = smem + kWideMaxK * kXStride;
    const long long m0 = (long long)blockIdx.x * kBM;
    const int n0 = blockIdx.y * kBN;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    {
        Slice<kWideMaxK, kThreads> sl;
        fetch(sl, x, w, m0, n0, 0, M, K, N);
        stash<kWideMaxK, kThreads, BF16>(sl, xs, ws);
    }
    __syncthreads();
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    }
    multiply(xs, ws, K, acc, tx, ty);

    // the finished tile through shared memory; then a thread takes one
    // column (its bias and BN read once) and every fourth row, a warp 32
    // neighbouring columns of a row
    __syncthreads();
    park(smem, acc, tx, ty);
    __syncthreads();
    const int c = tid % kBN;
    const int n = n0 + c;
    if (n >= N) return;
    const float bn = epi.bias[n];
    const float sn = epi.with_bn ? epi.s[n] : 1.0f;
    const float tn = epi.with_bn ? epi.t[n] : 0.0f;
#pragma unroll 8
    for (int r = tid / kBN; r < kBM; r += kThreads / kBN) {
        const long long m = m0 + r;
        if (m >= M) break;
        out[m * N + n] = epi.apply<ACT>(smem[r * kOutStride + c], bn, sn, tn, m);
    }
}


// Raise a kernel's dynamic shared memory limit (above 48 KB it must be asked
// for); set on every launch, so that it holds on whichever device is current.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool BF16>
int launch_splitk(const float* x, const float* w, const Epilogue& epi, float* out, int M, int K,
                  int N, int splits, cudaStream_t st) {
    cudaError_t err = allow_smem(dense_splitk_kernel<BF16>, kSkSmemBytes);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)(((M + kBM - 1) / kBM) * splits),
                       (unsigned int)((N + kBN - 1) / kBN));
    cfg.blockDim = dim3(kSkThreads);
    cfg.dynamicSmemBytes = kSkSmemBytes;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned int)splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, dense_splitk_kernel<BF16>, x, w, epi, out, M, K, N, splits);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <int ACT, bool BF16>
int launch_wide(const float* x, const float* w, const Epilogue& epi, float* out, int M, int K,
                int N, cudaStream_t st) {
    const cudaError_t err = allow_smem(dense_wide_kernel<ACT, BF16>, kWideSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned int)((M + kBM - 1) / kBM), (unsigned int)((N + kBN - 1) / kBN));
    dense_wide_kernel<ACT, BF16><<<grid, kThreads, kWideSmemBytes, st>>>(x, w, epi, out, M, K,
                                                                         N);
    return (int)cudaGetLastError();
}

template <bool BF16>
int launch_wide_act(const float* x, const float* w, const Epilogue& epi, float* out, int M, int K,
                    int N, cudaStream_t st) {
    switch (epi.act) {
        case kMean: return launch_wide<kMean, BF16>(x, w, epi, out, M, K, N, st);
        case kDisp: return launch_wide<kDisp, BF16>(x, w, epi, out, M, K, N, st);
        case kSigmoid: return launch_wide<kSigmoid, BF16>(x, w, epi, out, M, K, N, st);
        case kRelu: return launch_wide<kRelu, BF16>(x, w, epi, out, M, K, N, st);
        case kSelu: return launch_wide<kSelu, BF16>(x, w, epi, out, M, K, N, st);
        case kElu: return launch_wide<kElu, BF16>(x, w, epi, out, M, K, N, st);
        case kTanh: return launch_wide<kTanh, BF16>(x, w, epi, out, M, K, N, st);
        default: return launch_wide<kLinear, BF16>(x, w, epi, out, M, K, N, st);
    }
}

}  // namespace

extern "C" {

// How many clusters of `splits` split-K blocks the current device can hold
// at once (cudaOccupancyMaxActiveClusters): a cluster runs on SMs of one GPC,
// so the count is not the SM count over the cluster size.  The plan uses it
// to keep every cluster of a launch in one wave.
int dca_fused_dense_max_clusters(int splits, int* clusters) {
    if (splits < 1 || splits > kSkMaxSplits) return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem(dense_splitk_kernel<false>, kSkSmemBytes);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)splits);
    cfg.blockDim = dim3(kSkThreads);
    cfg.dynamicSmemBytes = kSkSmemBytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned int)splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(clusters, dense_splitk_kernel<false>, &cfg);
    return (int)err;
}




// x (M, K), w (K, N), b (N,), s and t (N,) when with_bn, sf (M,) when
// with_sf, out (M, N): contiguous float32.  s, t and sf are not read (and
// may be NULL) unless their flag is set.  M, N >= 1.  The plan (kind, bm, bn,
// bk, splits, cluster) is ops/fused_dense.py::plan's: the whole-K tiling
// (kind 0, 128 x 128, bk = K <= 64, 1, 1) or split-K (kind 1, 64 x 64, bk 32,
// 1 <= splits <= 8, cluster = splits); anything else is refused.
int dca_fused_dense(const float* x, const float* w, const float* b, const float* s,
                    const float* t, const float* sf, float* out, int M, int K, int N, int act,
                    int with_bn, int with_sf, int bf16, int kind, int bm, int bn, int bk,
                    int splits, int cluster, void* stream) {
    if (M < 1 || N < 1 || K < 0 || act < kMean || act > kLinear) {
        return (int)cudaErrorInvalidValue;
    }
    const Epilogue epi = {b, s, t, sf, act, with_bn, with_sf};
    const cudaStream_t st = (cudaStream_t)stream;
    if (bm != kBM || bn != kBN || (N + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
    if (kind == kWide) {
        if (bk != K || K > kWideMaxK || splits != 1 || cluster != 1) {
            return (int)cudaErrorInvalidValue;
        }
        return bf16 ? launch_wide_act<true>(x, w, epi, out, M, K, N, st)
                    : launch_wide_act<false>(x, w, epi, out, M, K, N, st);
    }
    if (kind == kSplitK) {
        if (bk != kSkBK || splits < 1 || splits > kSkMaxSplits || cluster != splits ||
            (long long)((M + kBM - 1) / kBM) * splits > 0x7fffffffLL) {
            return (int)cudaErrorInvalidValue;
        }
        return bf16 ? launch_splitk<true>(x, w, epi, out, M, K, N, splits, st)
                    : launch_splitk<false>(x, w, epi, out, M, K, N, splits, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
