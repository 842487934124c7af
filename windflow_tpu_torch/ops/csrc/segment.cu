// K3 — masked integer segment sum: out[s] = sum of values[i] over valid lanes
// with seg[i] == s, in wrapping int32 arithmetic; segment ids outside
// [0, S) are dropped.
//
// Replaces windflow_tpu/ops/segment.py::_pallas_segment_fold (the fold behind
// Win_SeqFFAT's additive non-count lifts, win_seqffat.py:221 via
// segment_reduce). The TPU kernel split each value into 11-bit limbs so that
// f32 one-hot matmuls stayed exact, then recombined with wrapping adds.
// Here the hardware does it: atomicAdd on int wraps in two's complement, and
// mod-2^32 addition is associative and commutative, so the result equals
// XLA's integer segment_sum bit for bit, overflow included, whatever order
// the atomics land in. Narrower inputs (int8, int16, uint8) widen to int32
// here and the wrapper casts the int32 sum back, as segment.py:147 does.
//
// Bound on the H100: bytes. Each lane reads its value, a 4 B segment id and
// a 1 B flag; the [S] i32 output is written once (C = 2^20 int32 values:
// 9.4 MB in). The JAX kernel stopped at S = 4096 (FOLD_MAX_SEGMENTS); this
// one serves any S, because Win_SeqFFAT folds into S = K * P = 409,600.
//
// Design: one global atomicAdd per lane, unless the S partials fit in 48 KB
// of shared memory (S <= 12288) AND there are enough lanes for every SM's
// block to cover at least 4 * S of them (C >= 4 * S * 132). Then each block
// accumulates block-private partials with shared-memory atomics and adds its
// nonzero partials to the output once, so the flush costs at most a quarter
// of its lanes in global atomics. (At C = 2^20 and S = 4096 the private path
// ran only 64 blocks, fewer than the SMs, and took 37.6 us, against 13.6 us
// for global atomics at S = 409,600; H100 80GB HBM3, 700 W, chip_smoke.py.)
#include "common.cuh"

constexpr int WF_FOLD_SMEM_SEGMENTS = 48 * 1024 / 4;

template <typename T>
__global__ void wf_fold_smem(const T* __restrict__ v, const int* __restrict__ seg,
                             const unsigned char* __restrict__ valid,
                             int* __restrict__ out, long long n, int S) {
    extern __shared__ int wf_fold_part[];
    for (int j = threadIdx.x; j < S; j += blockDim.x) wf_fold_part[j] = 0;
    __syncthreads();
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        if (!valid[i]) continue;
        int s = seg[i];
        if (s >= 0 && s < S) atomicAdd(wf_fold_part + s, (int)v[i]);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
        int p = wf_fold_part[j];
        if (p != 0) atomicAdd(out + j, p);
    }
}

template <typename T>
__global__ void wf_fold_global(const T* __restrict__ v, const int* __restrict__ seg,
                               const unsigned char* __restrict__ valid,
                               int* __restrict__ out, long long n, int S) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        if (!valid[i]) continue;
        int s = seg[i];
        if (s >= 0 && s < S) atomicAdd(out + s, (int)v[i]);
    }
}

template <typename T>
static int wf_fold_launch(const void* values, const int* seg,
                          const unsigned char* valid, int* out, long long n,
                          int S, cudaStream_t stream) {
    const int threads = 256;
    const T* v = static_cast<const T*>(values);
    long long per_block = 4LL * (S > 256 ? S : 256);
    if (S <= WF_FOLD_SMEM_SEGMENTS && n >= per_block * WF_SMS) {
        int blocks = wf_blocks(n, 1, (int)per_block, WF_SMS * 2);
        wf_fold_smem<T><<<blocks, 512, (size_t)S * sizeof(int), stream>>>(
            v, seg, valid, out, n, S);
    } else {
        int blocks = wf_blocks(n, threads, 4, WF_SMS * 16);
        wf_fold_global<T><<<blocks, threads, 0, stream>>>(v, seg, valid, out, n, S);
    }
    return (int)cudaGetLastError();
}

// dtype_code: 0 int32, 1 int16, 2 int8, 3 uint8. out: zeroed int32 [S].
WF_EXPORT int wf_segment_fold(const void* values, int dtype_code, const int* seg,
                              const unsigned char* valid, int* out, long long n,
                              int S, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype_code) {
        case 0: return wf_fold_launch<int32_t>(values, seg, valid, out, n, S, s);
        case 1: return wf_fold_launch<int16_t>(values, seg, valid, out, n, S, s);
        case 2: return wf_fold_launch<int8_t>(values, seg, valid, out, n, S, s);
        case 3: return wf_fold_launch<uint8_t>(values, seg, valid, out, n, S, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// Float segment sums in a fixed order (not a TPU kernel; registry name
// "segment_fold_float"). The JAX package sums floats with XLA's segment_sum,
// and on the CPU the port's index_add_ gives the same bits: each segment is
// summed from +0.0 in stream order. On the card index_add_ uses float
// atomics, which land in no fixed order. Here the wrapper sorts the lanes by
// segment (a stable sort, so each segment's lanes stay in stream order) and
// finds each segment's run; one thread per (segment, column) then walks its
// run in order, rounding to the value dtype after every add as the CPU's
// index_add_ does. The bits equal the CPU's on every run.
//
// Bound: bytes (each value read once, [S, D] written once); the walk is
// serial within a segment, so a few long segments leave the card idle. It
// runs only where a float fold is asked for on the card; no Nexmark or YSB
// path folds floats.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename T> struct WfAcc {
    static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};
template <> struct WfAcc<__half> {
    static __device__ __forceinline__ __half add(__half a, __half b) {
        return __float2half_rn(__half2float(a) + __half2float(b));
    }
};
template <> struct WfAcc<__nv_bfloat16> {
    static __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
        return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
    }
};

template <typename T>
__global__ void wf_fold_ordered(const T* __restrict__ v, const long long* __restrict__ starts,
                                T* __restrict__ out, int S, int D) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)S * D) return;
    int s = (int)(t / D), col = (int)(t % D);
    T acc = T(0.0f);
    for (long long r = starts[s]; r < starts[s + 1]; ++r)
        acc = WfAcc<T>::add(acc, v[r * D + col]);
    out[t] = acc;
}

// sorted_vals: [rows, D] values ordered by segment (stable); starts: int64
// [S + 1], segment s owning rows starts[s] .. starts[s+1]-1; out: [S, D].
// dtype_code: 0 float32, 1 float64, 2 float16, 3 bfloat16.
WF_EXPORT int wf_segment_fold_ordered(const void* sorted_vals, const long long* starts,
                                      void* out, int S, int D, int dtype_code,
                                      void* stream) {
    const int threads = 256;
    long long n = (long long)S * D;
    if (n == 0) return (int)cudaGetLastError();
    int blocks = (int)((n + threads - 1) / threads);
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype_code) {
        case 0: wf_fold_ordered<float><<<blocks, threads, 0, st>>>(
                    (const float*)sorted_vals, starts, (float*)out, S, D); break;
        case 1: wf_fold_ordered<double><<<blocks, threads, 0, st>>>(
                    (const double*)sorted_vals, starts, (double*)out, S, D); break;
        case 2: wf_fold_ordered<__half><<<blocks, threads, 0, st>>>(
                    (const __half*)sorted_vals, starts, (__half*)out, S, D); break;
        case 3: wf_fold_ordered<__nv_bfloat16><<<blocks, threads, 0, st>>>(
                    (const __nv_bfloat16*)sorted_vals, starts, (__nv_bfloat16*)out, S, D);
                break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
