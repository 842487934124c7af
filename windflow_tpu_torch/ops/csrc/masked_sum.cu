// K6 — per-row masked sum: out[w] = sum over l of (mask[w, l] ? vals[w, l] : 0)
// for vals [W, L] (row-major) and a bool mask [W, L], in jnp.sum's dtype.
//
// Replaces windflow_tpu/ops/pallas_kernels.py::_pallas_masked_sum, the
// aggregation of Win_Seq's non-incremental sum windows (Iterable.sum under the
// window vmap: one row per fired window). The TPU kernel tiled 256 rows per
// grid step and wrote its [W] result through an [8, W] buffer to satisfy
// Mosaic's layouts; it took W % 256 == 0 and L % 128 == 0 only. None of that
// carries over: here any W >= 0 and L >= 1 is served, and the output is [W].
//
// Dtypes (input -> accumulator -> output), jnp.sum's with 32-bit defaults:
// float32 -> float -> float32; int32 -> uint32 -> int32; uint8, uint16 and
// uint32 -> uint32 -> uint32; float16 and bfloat16 -> float -> their own dtype (one
// rounding at the end); float64 -> double -> float64. bool, int8 and int16
// are widened to int32 by the caller.
//
// Bound on the H100: bytes. Each element is read once (its value, 1 B flag)
// and each row's result written once over 3.35 TB/s; the adds are W * L
// operations, far below the memory time.
//
// Design, chosen for determinism before speed:
// - L >= 32: one warp per row. A lane walks its share of the row in a fixed
//   order, with 16-byte loads of four values (and a 4-byte load of their four
//   flags) for the 4-byte dtypes when the row starts on such a boundary
//   (L % 4 == 0 and aligned bases), single loads otherwise; then a shuffle
//   tree with fixed partners (16, 8, 4, 2, 1) combines the 32 lane sums. The
//   same input gives the same bits on every run; there are no atomics.
// - L < 32: one thread per row, summing the row left to right (YSB-WMR's
//   REDUCE rows are [W, 4]).
// - Integer sums wrap modulo 2^32 (done in uint32, where overflow is
//   defined), as XLA's integer sum does. Float sums round after every add, in
//   the order above; that order differs from XLA's and torch's, so float
//   results agree with them within rounding, and exactly where every partial
//   sum is exact.
#include "common.cuh"
#include <cuda_bf16.h>
#include <cuda_fp16.h>

// WfSum<T>: the accumulator of input dtype T, how a value enters it (lift),
// and the output dtype it leaves as (out)
template <typename T, typename A, typename O> struct WfSumBase {
    typedef A acc_t;
    typedef O out_t;
    static __device__ __forceinline__ A add(A a, A b) { return a + b; }
};
template <typename T> struct WfSum;
template <> struct WfSum<float> : WfSumBase<float, float, float> {
    static __device__ __forceinline__ float lift(float v) { return v; }
    static __device__ __forceinline__ float out(float a) { return a; }
};
template <> struct WfSum<int> : WfSumBase<int, unsigned int, int> {
    static __device__ __forceinline__ unsigned int lift(int v) { return (unsigned int)v; }
    static __device__ __forceinline__ int out(unsigned int a) { return (int)a; }
};
template <> struct WfSum<unsigned char> : WfSumBase<unsigned char, unsigned int, unsigned int> {
    static __device__ __forceinline__ unsigned int lift(unsigned char v) { return v; }
    static __device__ __forceinline__ unsigned int out(unsigned int a) { return a; }
};
template <> struct WfSum<unsigned short> : WfSumBase<unsigned short, unsigned int, unsigned int> {
    static __device__ __forceinline__ unsigned int lift(unsigned short v) { return v; }
    static __device__ __forceinline__ unsigned int out(unsigned int a) { return a; }
};
template <> struct WfSum<unsigned int> : WfSumBase<unsigned int, unsigned int, unsigned int> {
    static __device__ __forceinline__ unsigned int lift(unsigned int v) { return v; }
    static __device__ __forceinline__ unsigned int out(unsigned int a) { return a; }
};
template <> struct WfSum<__half> : WfSumBase<__half, float, __half> {
    static __device__ __forceinline__ float lift(__half v) { return __half2float(v); }
    static __device__ __forceinline__ __half out(float a) { return __float2half_rn(a); }
};
template <> struct WfSum<__nv_bfloat16> : WfSumBase<__nv_bfloat16, float, __nv_bfloat16> {
    static __device__ __forceinline__ float lift(__nv_bfloat16 v) { return __bfloat162float(v); }
    static __device__ __forceinline__ __nv_bfloat16 out(float a) { return __float2bfloat16_rn(a); }
};
template <> struct WfSum<double> : WfSumBase<double, double, double> {
    static __device__ __forceinline__ double lift(double v) { return v; }
    static __device__ __forceinline__ double out(double a) { return a; }
};

// the 16-byte vector of four values, for the 4-byte dtypes only
template <typename T> struct WfVec4 { static const bool ok = false; typedef T type; };
template <> struct WfVec4<float> { static const bool ok = true; typedef float4 type; };
template <> struct WfVec4<int> { static const bool ok = true; typedef int4 type; };

template <typename T, bool VEC>
__global__ void wf_masked_sum_warp(const T* __restrict__ vals,
                                   const unsigned char* __restrict__ mask,
                                   typename WfSum<T>::out_t* __restrict__ out,
                                   long long W, int L) {
    typedef WfSum<T> S;
    typedef typename S::acc_t acc_t;
    const int lane = threadIdx.x & 31;
    long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (w >= W) return;                 // whole warps leave together
    const T* row = vals + w * L;
    const unsigned char* mrow = mask + w * L;
    acc_t acc = acc_t(0);
    if constexpr (VEC) {
        typedef typename WfVec4<T>::type vec_t;
        const vec_t* r4 = reinterpret_cast<const vec_t*>(row);
        const uchar4* m4 = reinterpret_cast<const uchar4*>(mrow);
        for (int c = lane; c < (L >> 2); c += 32) {
            vec_t v = r4[c];
            uchar4 m = m4[c];
            acc = S::add(acc, m.x ? S::lift(v.x) : acc_t(0));
            acc = S::add(acc, m.y ? S::lift(v.y) : acc_t(0));
            acc = S::add(acc, m.z ? S::lift(v.z) : acc_t(0));
            acc = S::add(acc, m.w ? S::lift(v.w) : acc_t(0));
        }
    } else {
        for (int l = lane; l < L; l += 32)
            acc = S::add(acc, mrow[l] ? S::lift(row[l]) : acc_t(0));
    }
    for (int off = 16; off > 0; off >>= 1)
        acc = S::add(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) out[w] = S::out(acc);
}

template <typename T>
__global__ void wf_masked_sum_thread(const T* __restrict__ vals,
                                     const unsigned char* __restrict__ mask,
                                     typename WfSum<T>::out_t* __restrict__ out,
                                     long long W, int L) {
    typedef WfSum<T> S;
    long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= W) return;
    typename S::acc_t acc = 0;
    for (int l = 0; l < L; ++l)
        acc = S::add(acc, mask[w * L + l] ? S::lift(vals[w * L + l])
                                          : typename S::acc_t(0));
    out[w] = S::out(acc);
}

template <typename T>
static int wf_masked_sum_launch(const void* vals_, const unsigned char* mask,
                                void* out_, long long W, int L, cudaStream_t s) {
    typedef typename WfSum<T>::out_t O;
    const T* vals = static_cast<const T*>(vals_);
    O* out = static_cast<O*>(out_);
    if (L < 32) {
        const int threads = 256;
        long long blocks = (W + threads - 1) / threads;
        wf_masked_sum_thread<T><<<(unsigned)blocks, threads, 0, s>>>(vals, mask, out, W, L);
    } else {
        const int threads = 256, rows = threads / 32;
        long long blocks = (W + rows - 1) / rows;
        bool vec = WfVec4<T>::ok && (L % 4 == 0) && ((uintptr_t)vals % 16 == 0) &&
                   ((uintptr_t)mask % 4 == 0);
        if (vec)
            wf_masked_sum_warp<T, WfVec4<T>::ok><<<(unsigned)blocks, threads, 0, s>>>(
                vals, mask, out, W, L);
        else
            wf_masked_sum_warp<T, false><<<(unsigned)blocks, threads, 0, s>>>(vals, mask, out, W, L);
    }
    return (int)cudaGetLastError();
}

// vals: contiguous [W, L]; mask: contiguous bool [W, L]; out: [W] of the
// output dtype above. dtype_code: 0 float32, 1 int32, 2 uint8, 3 uint16,
// 4 float16, 5 bfloat16, 6 float64, 7 uint32. W >= 1, L >= 1.
WF_EXPORT int wf_masked_window_reduce(const void* vals, int dtype_code,
                                      const unsigned char* mask, void* out,
                                      long long W, int L, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype_code) {
        case 0: return wf_masked_sum_launch<float>(vals, mask, out, W, L, s);
        case 1: return wf_masked_sum_launch<int>(vals, mask, out, W, L, s);
        case 2: return wf_masked_sum_launch<unsigned char>(vals, mask, out, W, L, s);
        case 3: return wf_masked_sum_launch<unsigned short>(vals, mask, out, W, L, s);
        case 4: return wf_masked_sum_launch<__half>(vals, mask, out, W, L, s);
        case 5: return wf_masked_sum_launch<__nv_bfloat16>(vals, mask, out, W, L, s);
        case 6: return wf_masked_sum_launch<double>(vals, mask, out, W, L, s);
        case 7: return wf_masked_sum_launch<unsigned int>(vals, mask, out, W, L, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
