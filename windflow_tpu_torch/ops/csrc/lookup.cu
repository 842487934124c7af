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
// element a table (YSB: C = 2^20, a 1000-row i32 table — 8.4 MB, about
// 2.5 us at 3.35 TB/s). The TPU kernel turned the gather into two one-hot
// matmuls because its gather is serial; Hopper gathers directly.
//
// Design (redesigned for Hopper): the tables are read where they lie,
// through the read-only path (__ldg), whose L1 keeps a small table (the YSB
// table is 4 KB, q5's are 32 B) after its first lines are touched. An
// earlier design staged each table in every block's shared memory behind a
// barrier; on an H100 SXM at 700 W, chip_smoke.py's split (lookup_split)
// and an A/B of both designs in one run found the staging slower at every
// main-path shape (YSB 0.00374 against 0.00361-0.00369 ms, q5's nine
// tables 0.00466 against 0.0041).
// Where the lanes fill a resident grid (two blocks of 256 threads a SM)
// with a vector a thread, they stream as 16-byte vectors: one load brings
// four indices and each table's four values leave in one store as wide as
// they fill (16 B for 4-byte elements, two of 16 B for 8-byte, 8 B for
// 2-byte, 4 B for 1-byte), and each thread issues its next vector's index
// load before the current vector's gathers (unrolled by two). Fewer lanes
// (q5's 2^14), the ragged tail, and an index vector or an output that is
// not 16-byte aligned (an offset view) take the scalar loop, one lane a
// thread: there a launch costs the latency of one index load, gather and
// store.
//
// One launch serves up to WF_LOOKUP_MAX_TABLES tables read through the same
// index (wf_table_lookup_many): each lane's index is loaded once for all of
// them. The tables travel in a descriptor passed by value (a
// __grid_constant__ kernel parameter), so a CUDA graph captures it whole:
// no host staging buffer, no host-to-device copy.
#include "common.cuh"

constexpr int WF_LOOKUP_MAX_TABLES = 16;
constexpr int WF_LOOKUP_THREADS = 256;
constexpr int WF_LOOKUP_BLOCKS_PER_SM = 2;

struct WfLookupTable {
    const void* table;
    void* out;
    int K;
    int elem;       // element bytes: 1, 2, 4 or 8
    int zero_fix;   // -0.0 -> +0.0 (a float table of K >= 2 rows)
};

struct WfLookupMany {
    WfLookupTable t[WF_LOOKUP_MAX_TABLES];
    int count;
    int vec;        // 1: lanes in vectors of 4 (idx and every out 16-byte aligned)
};

template <typename T>
__device__ __forceinline__ T wf_get(const WfLookupTable& d, int j) {
    T v = (unsigned)j < (unsigned)d.K ? __ldg(static_cast<const T*>(d.table) + j) : T(0);
    if (d.zero_fix && v == T(T(1) << (8 * sizeof(T) - 1))) v = T(0);
    return v;
}

// Four lanes' values from one table, stored at lanes i .. i + 3 (i a
// multiple of 4, out 16-byte aligned) in the widest store they fill.
template <typename T>
__device__ __forceinline__ void wf_put4(const WfLookupTable& d, int4 j, long long i) {
    const T a = wf_get<T>(d, j.x), b = wf_get<T>(d, j.y), c = wf_get<T>(d, j.z),
            e = wf_get<T>(d, j.w);
    T* o = static_cast<T*>(d.out) + i;
    if constexpr (sizeof(T) == 8) {
        ulonglong2* p = reinterpret_cast<ulonglong2*>(o);
        p[0] = make_ulonglong2(a, b);
        p[1] = make_ulonglong2(c, e);
    } else if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<uint4*>(o) = make_uint4(a, b, c, e);
    } else if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint2*>(o) = make_uint2((uint32_t)a | ((uint32_t)b << 16),
                                                  (uint32_t)c | ((uint32_t)e << 16));
    } else {
        *reinterpret_cast<uint32_t*>(o) = (uint32_t)a | ((uint32_t)b << 8) |
                                          ((uint32_t)c << 16) | ((uint32_t)e << 24);
    }
}

// Lanes i .. i + 3 (VEC, indices j) or lane i alone (index j.x) of one
// table. ELEM: every table's element size (1, 2, 4 or 8), or 0: its own.
template <int ELEM, bool VEC>
__device__ __forceinline__ void wf_lanes(const WfLookupTable& d, int4 j, long long i) {
    auto go = [&](auto z) {
        using T = decltype(z);
        if constexpr (VEC) wf_put4<T>(d, j, i);
        else static_cast<T*>(d.out)[i] = wf_get<T>(d, j.x);
    };
    switch (ELEM ? ELEM : d.elem) {
        case 1: go(uint8_t(0)); break;
        case 2: go(uint16_t(0)); break;
        case 4: go(uint32_t(0)); break;
        default: go((unsigned long long)0); break;
    }
}

// ONE: a single table (p.t[0]); else p.count tables.
template <int ELEM, bool ONE>
__global__ void __launch_bounds__(WF_LOOKUP_THREADS)
wf_lookup_kernel(const __grid_constant__ WfLookupMany p, const int* __restrict__ idx,
                 long long n) {
    const int count = ONE ? 1 : p.count;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nv = p.vec ? n / 4 : 0;
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    for (long long v = tid; v < nv; v += 2 * stride) {
        const int4 a = __ldg(idx4 + v);
        const bool more = v + stride < nv;
        const int4 b = more ? __ldg(idx4 + v + stride) : a;
        for (int k = 0; k < count; ++k) wf_lanes<ELEM, true>(p.t[k], a, 4 * v);
        if (more)
            for (int k = 0; k < count; ++k) wf_lanes<ELEM, true>(p.t[k], b, 4 * (v + stride));
    }
    for (long long i = 4 * nv + tid; i < n; i += stride) {
        const int4 j = make_int4(__ldg(idx + i), 0, 0, 0);
        for (int k = 0; k < count; ++k) wf_lanes<ELEM, false>(p.t[k], j, i);
    }
}

template <bool ONE>
static void wf_lookup_start(int elem, int blocks, cudaStream_t stream,
                            const WfLookupMany& p, const int* idx, long long n) {
    switch (elem) {
        case 1: wf_lookup_kernel<1, ONE><<<blocks, WF_LOOKUP_THREADS, 0, stream>>>(p, idx, n); break;
        case 2: wf_lookup_kernel<2, ONE><<<blocks, WF_LOOKUP_THREADS, 0, stream>>>(p, idx, n); break;
        case 4: wf_lookup_kernel<4, ONE><<<blocks, WF_LOOKUP_THREADS, 0, stream>>>(p, idx, n); break;
        case 8: wf_lookup_kernel<8, ONE><<<blocks, WF_LOOKUP_THREADS, 0, stream>>>(p, idx, n); break;
        default: wf_lookup_kernel<0, false><<<blocks, WF_LOOKUP_THREADS, 0, stream>>>(p, idx, n); break;
    }
}

// Checks the tables, picks the lanes' form and grid, and launches one kernel.
static int wf_lookup_launch(WfLookupMany& p, const int* idx, long long n,
                            cudaStream_t stream) {
    if (p.count < 1 || p.count > WF_LOOKUP_MAX_TABLES || n < 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    int common_elem = p.t[0].elem;
    bool aligned = reinterpret_cast<uintptr_t>(idx) % 16 == 0;
    for (int k = 0; k < p.count; ++k) {
        const WfLookupTable& d = p.t[k];
        if ((d.elem != 1 && d.elem != 2 && d.elem != 4 && d.elem != 8) || d.K < 0)
            return (int)cudaErrorInvalidValue;
        if (d.elem != common_elem) common_elem = 0;
        aligned = aligned && reinterpret_cast<uintptr_t>(d.out) % 16 == 0;
    }
    int dev = 0, sms = WF_SMS;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    // Vectors where the lanes fill the resident grid with at least one
    // vector a thread: two vectors a thread, two blocks a SM. Fewer lanes
    // (q5's 2^14) are bound by the latency of one lane's index, gather and
    // store, not by bytes: one lane a thread, as many blocks as that takes
    // (and the unaligned lanes the same way, up to eight blocks a SM).
    const int resident = WF_LOOKUP_BLOCKS_PER_SM * sms;
    p.vec = aligned && n >= 4LL * WF_LOOKUP_THREADS * resident ? 1 : 0;
    const int blocks = p.vec ? wf_blocks(n, WF_LOOKUP_THREADS, 8, resident)
                             : wf_blocks(n, WF_LOOKUP_THREADS, 1, 4 * resident);
    if (p.count == 1) wf_lookup_start<true>(common_elem, blocks, stream, p, idx, n);
    else wf_lookup_start<false>(common_elem, blocks, stream, p, idx, n);
    return (int)cudaGetLastError();
}

// elem_bytes: 1, 2, 4 or 8. Returns cudaErrorInvalidValue for any other size.
// zero_fix: nonzero for a float table of K >= 2 rows (-0.0 -> +0.0).
WF_EXPORT int wf_table_lookup(const void* table, const int* idx, void* out,
                              long long n, int K, int elem_bytes, int zero_fix,
                              void* stream) {
    WfLookupMany p{};
    p.count = 1;
    p.t[0] = {table, out, K, elem_bytes, zero_fix != 0};
    return wf_lookup_launch(p, idx, n, (cudaStream_t)stream);
}

// count tables (1 .. WF_LOOKUP_MAX_TABLES) read through one idx [n] in one
// launch: out[k][i] = tables[k][idx[i]], each table with its own K, element
// size and zero_fix. The host arrays are read here, before the launch.
WF_EXPORT int wf_table_lookup_many(const void* const* tables, void* const* outs,
                                   const int* Ks, const int* elem_bytes,
                                   const int* zero_fix, int count, const int* idx,
                                   long long n, void* stream) {
    if (count < 1 || count > WF_LOOKUP_MAX_TABLES) return (int)cudaErrorInvalidValue;
    WfLookupMany p{};
    p.count = count;
    for (int k = 0; k < count; ++k)
        p.t[k] = {tables[k], outs[k], Ks[k], elem_bytes[k], zero_fix[k] != 0};
    return wf_lookup_launch(p, idx, n, (cudaStream_t)stream);
}
