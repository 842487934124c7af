// K6 — per-row masked sum: out[w] = sum over l of (mask[w, l] ? vals[w, l] : 0)
// for vals [W, L] (float32 or int32, row-major) and a bool mask [W, L].
//
// Replaces windflow_tpu/ops/pallas_kernels.py::_pallas_masked_sum, the
// aggregation of Win_Seq's non-incremental sum windows (Iterable.sum under the
// window vmap: one row per fired window). The TPU kernel tiled 256 rows per
// grid step and wrote its [W] result through an [8, W] buffer to satisfy
// Mosaic's layouts; it took W % 256 == 0 and L % 128 == 0 only. None of that
// carries over: here any W >= 0 and L >= 1 is served, and the output is [W].
//
// Bound on the H100: bytes. Each element is read once (4 B value, 1 B flag)
// and each row's 4 B result written once: W * L * 5 + W * 4 bytes over
// 3.35 TB/s; the adds are W * L operations, far below the memory time.
//
// Design, chosen for determinism before speed:
// - L >= 32: one warp per row. A lane walks its share of the row in a fixed
//   order, with 16-byte loads of four values (and a 4-byte load of their four
//   flags) when the row starts on such a boundary (L % 4 == 0 and aligned
//   bases), single loads otherwise; then a shuffle tree with fixed partners
//   (16, 8, 4, 2, 1) combines the 32 lane sums. The same input gives the same
//   bits on every run; there are no atomics.
// - L < 32: one thread per row, summing the row left to right (YSB-WMR's
//   REDUCE rows are [W, 4]).
// - int32 sums wrap modulo 2^32 (done in uint32, where overflow is defined),
//   as XLA's integer sum does. float32 sums round after every add, in the
//   order above; that order differs from XLA's and torch's, so float results
//   agree with them within rounding, and exactly where every partial sum is
//   an integer below 2^24.
#include "common.cuh"

template <typename T> struct WfSum;
template <> struct WfSum<float> {
    typedef float acc_t;
    static __device__ __forceinline__ float add(float a, float b) { return a + b; }
    static __device__ __forceinline__ float out(float a) { return a; }
};
template <> struct WfSum<int> {
    typedef unsigned int acc_t;
    static __device__ __forceinline__ unsigned int add(unsigned int a, int b) {
        return a + (unsigned int)b;
    }
    static __device__ __forceinline__ int out(unsigned int a) { return (int)a; }
};

template <typename T> struct WfVec4;
template <> struct WfVec4<float> { typedef float4 type; };
template <> struct WfVec4<int> { typedef int4 type; };

template <typename T, bool VEC>
__global__ void wf_masked_sum_warp(const T* __restrict__ vals,
                                   const unsigned char* __restrict__ mask,
                                   T* __restrict__ out, long long W, int L) {
    typedef typename WfSum<T>::acc_t acc_t;
    const int lane = threadIdx.x & 31;
    long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (w >= W) return;                 // whole warps leave together
    const T* row = vals + w * L;
    const unsigned char* mrow = mask + w * L;
    acc_t acc = acc_t(0);
    if (VEC) {
        typedef typename WfVec4<T>::type vec_t;
        const vec_t* r4 = reinterpret_cast<const vec_t*>(row);
        const uchar4* m4 = reinterpret_cast<const uchar4*>(mrow);
        for (int c = lane; c < (L >> 2); c += 32) {
            vec_t v = r4[c];
            uchar4 m = m4[c];
            acc = WfSum<T>::add(acc, m.x ? v.x : T(0));
            acc = WfSum<T>::add(acc, m.y ? v.y : T(0));
            acc = WfSum<T>::add(acc, m.z ? v.z : T(0));
            acc = WfSum<T>::add(acc, m.w ? v.w : T(0));
        }
    } else {
        for (int l = lane; l < L; l += 32)
            acc = WfSum<T>::add(acc, mrow[l] ? row[l] : T(0));
    }
    for (int off = 16; off > 0; off >>= 1) {
        acc_t other = __shfl_xor_sync(0xffffffffu, acc, off);
        acc = WfSum<T>::add(acc, (T)other);
    }
    if (lane == 0) out[w] = WfSum<T>::out(acc);
}

template <typename T>
__global__ void wf_masked_sum_thread(const T* __restrict__ vals,
                                     const unsigned char* __restrict__ mask,
                                     T* __restrict__ out, long long W, int L) {
    long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= W) return;
    typename WfSum<T>::acc_t acc = 0;
    for (int l = 0; l < L; ++l)
        acc = WfSum<T>::add(acc, mask[w * L + l] ? vals[w * L + l] : T(0));
    out[w] = WfSum<T>::out(acc);
}

template <typename T>
static int wf_masked_sum_launch(const void* vals_, const unsigned char* mask,
                                void* out_, long long W, int L, cudaStream_t s) {
    const T* vals = static_cast<const T*>(vals_);
    T* out = static_cast<T*>(out_);
    if (L < 32) {
        const int threads = 256;
        long long blocks = (W + threads - 1) / threads;
        wf_masked_sum_thread<T><<<(unsigned)blocks, threads, 0, s>>>(vals, mask, out, W, L);
    } else {
        const int threads = 256, rows = threads / 32;
        long long blocks = (W + rows - 1) / rows;
        bool vec = (L % 4 == 0) && ((uintptr_t)vals % 16 == 0) && ((uintptr_t)mask % 4 == 0);
        if (vec)
            wf_masked_sum_warp<T, true><<<(unsigned)blocks, threads, 0, s>>>(vals, mask, out, W, L);
        else
            wf_masked_sum_warp<T, false><<<(unsigned)blocks, threads, 0, s>>>(vals, mask, out, W, L);
    }
    return (int)cudaGetLastError();
}

// vals: contiguous [W, L]; mask: contiguous bool [W, L]; out: [W] of vals'
// dtype. dtype_code: 0 float32, 1 int32. W >= 1, L >= 1.
WF_EXPORT int wf_masked_window_reduce(const void* vals, int dtype_code,
                                      const unsigned char* mask, void* out,
                                      long long W, int L, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype_code) {
        case 0: return wf_masked_sum_launch<float>(vals, mask, out, W, L, s);
        case 1: return wf_masked_sum_launch<int>(vals, mask, out, W, L, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
