// The RMSprop update of every parameter of a training step in one launch,
// for Hopper (K5).
//
// No TPU kernel corresponds to this one: the JAX package leaves the update
// to XLA, which fuses its elementwise operations inside the jitted step
// (dca_tpu/train/optim.py, rmsprop).  Written out leaf by leaf in PyTorch
// (dca_tpu_torch/train/optim.py, _rmsprop_loop) the update is 11 kernels a
// leaf: 143 of a step's ~320 in nb-conddisp, each moving a few floats to
// 0.9 MB, so the step's update is paced by launches and the gaps between
// graph nodes, not by the card.  This kernel does the whole update of up
// to 64 leaves in one launch (ops/fused_optim.py plans the launches).
//
// For each element, the float32 operations PyTorch performs in the plain
// loop, in its order, each rounded on its own (no contraction into FMA):
//   g = clamp(g, -clip, clip)             NaN stays NaN, as torch.clamp
//   a = rho * a + (1 - rho) * (g * g)
//   p = p - (lr * g) / (sqrt(a) + eps)
// rho, 1 - rho, eps, clip and a Python-float lr come as the floats PyTorch
// casts its Python scalars to; a tensor lr (the fit's 0-d float32 rate,
// which ReduceLROnPlateau rewrites in place between epochs) is read from its
// address at every launch, so a replayed CUDA graph uses the new rate.
//
// Bound: bytes.  Each element reads p, g and a and writes p and a: 20
// bytes for a dozen operations.  So each thread moves 16 bytes a load
// (float4) where a leaf's three pointers are 16-byte aligned, and every
// block has two such loads of each array in flight before it computes; a
// leaf whose gradient is a view at an odd offset (the gradients' flat
// all-reduce buffer under NCCL, an odd gene shard) takes scalar loads,
// still coalesced.  Blocks cover kChunk elements of one leaf each; the
// table of leaves, with the first block of each, goes by value in the
// launch's parameters (__grid_constant__: read in place, never copied to
// local memory), so the launch reads nothing the host wrote beforehand and
// allocates nothing.
// Plain C interface, loaded with ctypes by dca_tpu_torch/ops/_build.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// ops/fused_optim.py plans with the same numbers
constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kVecPerThread = 2;
constexpr int kChunk = kThreads * 4 * kVecPerThread;  // elements a block

struct Table {
    float* p[kMaxLeaves];
    const float* g[kMaxLeaves];
    float* a[kMaxLeaves];
    long long n[kMaxLeaves];
    int first_block[kMaxLeaves];  // leaf i: from its first block to leaf i + 1's
    unsigned long long vector;    // bit i: leaf i's p, g and a 16-byte aligned
    int n_leaves;
};

struct Hyper {
    const float* lr_ptr;  // the rate's address, or NULL for lr
    float lr;
    float clip;
    int clipped;
    float rho;
    float one_minus_rho;
    float eps;
};

__device__ __forceinline__ void update(float& p, float g, float& a, float lr,
                                       const Hyper& h) {
    if (h.clipped && !isnan(g)) g = fminf(fmaxf(g, -h.clip), h.clip);
    a = __fadd_rn(__fmul_rn(h.rho, a), __fmul_rn(h.one_minus_rho, __fmul_rn(g, g)));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(__fsqrt_rn(a), h.eps)));
}

__global__ void __launch_bounds__(kThreads)
rmsprop_kernel(const __grid_constant__ Table t, const __grid_constant__ Hyper h) {
    // the block's leaf: the last whose first block is at most this one
    const int b = blockIdx.x;
    int lo = 0, hi = t.n_leaves - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (t.first_block[mid] <= b) lo = mid;
        else hi = mid - 1;
    }
    const long long start = (long long)(b - t.first_block[lo]) * kChunk;
    const long long end = min(start + (long long)kChunk, t.n[lo]);
    float* p = t.p[lo];
    const float* g = t.g[lo];
    float* a = t.a[lo];
    const float lr = h.lr_ptr != nullptr ? *h.lr_ptr : h.lr;

    long long i = start + threadIdx.x;  // the scalar elements from here on
    if ((t.vector >> lo) & 1ull) {
        const long long v_end = end >> 2;
        float4 pv[kVecPerThread], gv[kVecPerThread], av[kVecPerThread];
#pragma unroll
        for (int k = 0; k < kVecPerThread; ++k) {
            const long long v = (start >> 2) + threadIdx.x + k * kThreads;
            if (v < v_end) {
                pv[k] = reinterpret_cast<const float4*>(p)[v];
                gv[k] = __ldg(reinterpret_cast<const float4*>(g) + v);
                av[k] = reinterpret_cast<const float4*>(a)[v];
            }
        }
#pragma unroll
        for (int k = 0; k < kVecPerThread; ++k) {
            const long long v = (start >> 2) + threadIdx.x + k * kThreads;
            if (v < v_end) {
                update(pv[k].x, gv[k].x, av[k].x, lr, h);
                update(pv[k].y, gv[k].y, av[k].y, lr, h);
                update(pv[k].z, gv[k].z, av[k].z, lr, h);
                update(pv[k].w, gv[k].w, av[k].w, lr, h);
                reinterpret_cast<float4*>(p)[v] = pv[k];
                reinterpret_cast<float4*>(a)[v] = av[k];
            }
        }
        i = (v_end << 2) + threadIdx.x;  // the last chunk's ragged tail
    }
    for (; i < end; i += kThreads) {
        float pi = p[i], ai = a[i];
        update(pi, __ldg(g + i), ai, lr, h);
        p[i] = pi;
        a[i] = ai;
    }
}

}  // namespace

extern "C" {

// One launch over n_leaves (1 to 64) leaves: p[i], g[i], a[i] each n[i]
// contiguous float32 elements; first_block[0..n_leaves] the blocks' starts
// (first_block[n_leaves] the launch's blocks), vector[i] non-zero where the
// leaf's three pointers are 16-byte aligned; chunk the elements a block,
// which must be this kernel's.  lr_ptr, when not NULL, is the rate's
// device address, read at the launch; otherwise lr is the rate.
int dca_rmsprop(int n_leaves, void* const* p, void* const* g, void* const* a,
                const long long* n, const int* first_block, const int* vector, int chunk,
                const void* lr_ptr, float lr, float clip, int clipped, float rho,
                float one_minus_rho, float eps, void* stream) {
    if (n_leaves < 1 || n_leaves > kMaxLeaves || chunk != kChunk)
        return (int)cudaErrorInvalidValue;
    Table t = {};
    t.n_leaves = n_leaves;
    for (int i = 0; i < n_leaves; ++i) {
        t.p[i] = (float*)p[i];
        t.g[i] = (const float*)g[i];
        t.a[i] = (float*)a[i];
        t.n[i] = n[i];
        t.first_block[i] = first_block[i];
        if (vector[i]) t.vector |= 1ull << i;
    }
    const int blocks = first_block[n_leaves];
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    Hyper h = {(const float*)lr_ptr, lr, clip, clipped, rho, one_minus_rho, eps};
    rmsprop_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(t, h);
    return (int)cudaGetLastError();
}

}  // extern "C"
