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
