// K2 — table lookup: out[i] = table[idx[i]] for 0 <= idx[i] < K, else 0,
// in the table's own dtype (any element size: the gather copies bits).
// With zero_fix set (a float table of K >= 2 rows) a -0.0 entry comes back
// as +0.0: the JAX forms sum a one-hot product, and -0.0 + 0.0 is +0.0 (XLA
// drops the sum of a one-row table, so K == 1 keeps -0.0). The fix compares
// bits with the dtype's sign bit alone, so a NaN keeps its bits.
//
// Replaces windflow_tpu/ops/lookup.py::_pallas_factored_lookup, and serves
// every table_lookup whose JAX result is "table[idx], 0 out of range": the
// select branch and the factored branch (lookup.py:72-100).
//
// Bound on the H100: bytes. Each lane reads a 4 B index and writes one
// element (YSB: C = 2^20, a 1000-row i32 table — 8.4 MB, about 2.5 us at
// 3.35 TB/s). The TPU kernel turned the gather into two one-hot matmuls
// because its gather is serial; Hopper gathers directly.
//
// Design: the table is staged in shared memory when it fits in 48 KB (the
// YSB table is 4 KB), so every random read hits shared memory; a larger
// table is read through L2 with __ldg. Grid-stride over the lanes, with
// enough lanes per block to amortise the staging.
#include "common.cuh"

constexpr int WF_LOOKUP_SMEM_BYTES = 48 * 1024;

template <typename T, bool STAGE>
__global__ void wf_lookup_kernel(const T* __restrict__ table,
                                 const int* __restrict__ idx,
                                 T* __restrict__ out, long long n, int K,
                                 bool zero_fix) {
    const T neg_zero = T(1) << (8 * sizeof(T) - 1);
    extern __shared__ __align__(16) unsigned char wf_lookup_smem[];
    T* staged = reinterpret_cast<T*>(wf_lookup_smem);
    if constexpr (STAGE) {
        for (int j = threadIdx.x; j < K; j += blockDim.x) staged[j] = table[j];
        __syncthreads();
    }
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        int j = __ldg(idx + i);
        T v = T(0);
        if (j >= 0 && j < K) {
            if constexpr (STAGE) v = staged[j];
            else v = __ldg(table + j);
        }
        if (zero_fix && v == neg_zero) v = T(0);
        out[i] = v;
    }
}

template <typename T>
static int wf_lookup_launch(const void* table, const int* idx, void* out,
                            long long n, int K, bool zero_fix,
                            cudaStream_t stream) {
    const int threads = 256;
    size_t bytes = (size_t)K * sizeof(T);
    const T* t = static_cast<const T*>(table);
    T* o = static_cast<T*>(out);
    if (bytes <= WF_LOOKUP_SMEM_BYTES) {
        int blocks = wf_blocks(n, threads, 8, WF_SMS * 8);
        wf_lookup_kernel<T, true><<<blocks, threads, bytes, stream>>>(t, idx, o, n, K,
                                                                     zero_fix);
    } else {
        int blocks = wf_blocks(n, threads, 4, WF_SMS * 16);
        wf_lookup_kernel<T, false><<<blocks, threads, 0, stream>>>(t, idx, o, n, K,
                                                                  zero_fix);
    }
    return (int)cudaGetLastError();
}

// elem_bytes: 1, 2, 4 or 8. Returns cudaErrorInvalidValue for any other size.
// zero_fix: nonzero for a float table of K >= 2 rows (-0.0 -> +0.0).
WF_EXPORT int wf_table_lookup(const void* table, const int* idx, void* out,
                              long long n, int K, int elem_bytes, int zero_fix,
                              void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    bool z = zero_fix != 0;
    switch (elem_bytes) {
        case 1: return wf_lookup_launch<uint8_t>(table, idx, out, n, K, z, s);
        case 2: return wf_lookup_launch<uint16_t>(table, idx, out, n, K, z, s);
        case 4: return wf_lookup_launch<uint32_t>(table, idx, out, n, K, z, s);
        case 8: return wf_lookup_launch<unsigned long long>(table, idx, out, n, K, z, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
