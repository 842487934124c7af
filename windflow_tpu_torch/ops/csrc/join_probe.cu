// K5 — stream-table join probe: for each probe lane i, hit[i] = (some row j
// has table_keys[j] == probe[i]) and valid[i]; out[i] = table_vals[j] of the
// first such row, or 0 on a miss or an invalid lane. Values are 4-byte words
// (the wrapper widens narrower dtypes first, as jnp.sum does); with zero_fix
// set (float values, K >= 2) a -0.0 value comes back as +0.0, as the JAX
// select-sum gives it. A NaN value stays on its own row.
//
// Replaces windflow_tpu/ops/lookup.py::_join_probe_pallas (and its reference
// _join_probe_xla): a [BLK, K] one-hot compare in VMEM and a select-reduce,
// for K <= 2048. With unique keys (the JoinTable's invariant) the first
// match is the only match, so this equals the select-sum; with repeated keys
// (unused table slots all hold the sentinel) kernel and plain version both
// take the first row. Any K is taken.
//
// Bound on the H100: bytes. The function needs each probe lane read and each
// result written once (4 + 1 bytes in, 4 + 1 out) and the table read once
// (8 bytes a row): q3 at full width, C = 2^20 and K = 2048, is 10.5 MB,
// about 3.1 us at 3.35 TB/s. Its work is O(C) expected lookups, not C * K
// compares.
//
// Design: a hash table of the keys, built once per call, then probed.
//   - Build (wf_probe_build): an open-addressing table of M = next_pow2(2K)
//     slots of (key, row) in scratch device memory that the wrapper
//     allocates. An empty slot has row = -1, so every int32 key can be
//     stored (JOIN_KEY_SENTINEL = INT32_MIN and INT32_MAX too). A slot is
//     claimed with one 64-bit atomicCAS; equal keys share one slot, whose
//     row becomes their minimum by a CAS loop: the first-match rule. The
//     hash is multiplicative (Fibonacci) on the key as uint32, so keys that
//     are multiples of a power of two spread over the table. The load
//     factor is at most 1/2, so every chain ends at an empty slot.
//   - Probe (wf_probe_kernel): a persistent grid of at most two blocks a
//     SM. In its shared-memory form each block copies the table into shared
//     memory once with cp.async (32 KB at K = 2048, 128 KB at K = 5000 or
//     8192), then walks its share of the lanes, four consecutive lanes a
//     thread a step (16-byte probe and 4-byte valid loads): the hash, a
//     linear probe to the key or an empty slot, and the value gathered by
//     row from device memory.
//   - Large tables: where M slots of 8 bytes exceed what a block may hold
//     (M > 2^14, K > 8192), the same kernel, instantiated with SMEM = false,
//     probes the device-memory table through L2. The wrapper picks the form
//     from M; a refused shared-memory size is an error, not a fallback.
// Three launches a call (memset, build, probe); the wrapper counts one.
#include "common.cuh"

constexpr int WF_PROBE_THREADS = 512;
constexpr int WF_PROBE_LANES = 4;            // consecutive lanes a thread takes a step
constexpr int WF_PROBE_BLOCKS_PER_SM = 2;    // each block copies the table once
constexpr unsigned long long WF_PROBE_EMPTY = ~0ULL;   // row = -1 (and key = -1)

// slot = row << 32 | (uint32) key
__device__ __forceinline__ unsigned wf_probe_hash(int key, int log_m) {
    return ((unsigned)key * 2654435769u) >> (32 - log_m);
}

__global__ void wf_probe_build(const int* __restrict__ keys,
                               unsigned long long* __restrict__ table, int K, int log_m) {
    const unsigned mask = (1u << log_m) - 1;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < K;
         j += gridDim.x * blockDim.x) {
        const int key = keys[j];
        const unsigned long long mine =
            ((unsigned long long)(unsigned)j << 32) | (unsigned)key;
        unsigned h = wf_probe_hash(key, log_m);
        while (true) {
            unsigned long long old = atomicCAS(table + h, WF_PROBE_EMPTY, mine);
            if (old == WF_PROBE_EMPTY) break;                     // claimed
            if ((int)(unsigned)old == key) {                      // the key's slot
                while ((int)(old >> 32) > j) {                    // keep the first row
                    const unsigned long long seen = atomicCAS(table + h, old, mine);
                    if (seen == old) break;
                    old = seen;
                }
                break;
            }
            h = (h + 1) & mask;
        }
    }
}

template <bool SMEM>
__device__ __forceinline__ int wf_probe_find(const unsigned long long* slots, int key,
                                             int log_m, unsigned mask) {
    unsigned h = wf_probe_hash(key, log_m);
    while (true) {
        const unsigned long long s = SMEM ? slots[h] : __ldg(slots + h);
        const int row = (int)(s >> 32);
        if (row < 0) return -1;
        if ((int)(unsigned)s == key) return row;
        h = (h + 1) & mask;
    }
}

template <bool SMEM>
__global__ void __launch_bounds__(WF_PROBE_THREADS)
wf_probe_kernel(const unsigned long long* __restrict__ table, int log_m,
                const uint32_t* __restrict__ vals, const int* __restrict__ probe,
                const unsigned char* __restrict__ valid, uint32_t* __restrict__ out,
                unsigned char* __restrict__ hit, long long C, bool zero_fix) {
    extern __shared__ __align__(16) unsigned long long wf_probe_sm[];
    const unsigned mask = (1u << log_m) - 1;
    const unsigned long long* slots = table;
    if (SMEM) {                      // 2^log_m slots, 16 bytes a copy (log_m >= 1)
        const int copies = 1 << (log_m - 1);
        for (int c = threadIdx.x; c < copies; c += blockDim.x) {
            const uint32_t dst = (uint32_t)__cvta_generic_to_shared(wf_probe_sm + 2 * c);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(dst), "l"(table + 2 * c));
        }
        asm volatile("cp.async.commit_group;\n");
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        slots = wf_probe_sm;
    }
    const bool vec = (((uintptr_t)probe | (uintptr_t)out) & 15) == 0 &&
                     (((uintptr_t)valid | (uintptr_t)hit) & 3) == 0;
    const long long groups = (C + WF_PROBE_LANES - 1) / WF_PROBE_LANES;
    for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x; gi < groups;
         gi += (long long)gridDim.x * blockDim.x) {
        const long long i0 = gi * WF_PROBE_LANES;
        const bool full = vec && i0 + WF_PROBE_LANES <= C;
        int p[WF_PROBE_LANES];
        unsigned char v[WF_PROBE_LANES];
        if (full) {
            const int4 q = *reinterpret_cast<const int4*>(probe + i0);
            const uchar4 w = *reinterpret_cast<const uchar4*>(valid + i0);
            p[0] = q.x; p[1] = q.y; p[2] = q.z; p[3] = q.w;
            v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
        } else {
#pragma unroll
            for (int l = 0; l < WF_PROBE_LANES; ++l) {
                p[l] = i0 + l < C ? probe[i0 + l] : 0;
                v[l] = i0 + l < C ? valid[i0 + l] : 0;
            }
        }
        uint32_t o[WF_PROBE_LANES];
        unsigned char h[WF_PROBE_LANES];
#pragma unroll
        for (int l = 0; l < WF_PROBE_LANES; ++l) {
            const int row = v[l] ? wf_probe_find<SMEM>(slots, p[l], log_m, mask) : -1;
            uint32_t val = row >= 0 ? __ldg(vals + row) : 0u;
            if (zero_fix && val == 0x80000000u) val = 0u;
            o[l] = val;
            h[l] = row >= 0;
        }
        if (full) {
            *reinterpret_cast<uint4*>(out + i0) = make_uint4(o[0], o[1], o[2], o[3]);
            *reinterpret_cast<uchar4*>(hit + i0) = make_uchar4(h[0], h[1], h[2], h[3]);
        } else {
#pragma unroll
            for (int l = 0; l < WF_PROBE_LANES; ++l) {
                if (i0 + l < C) { out[i0 + l] = o[l]; hit[i0 + l] = h[l]; }
            }
        }
    }
}

static size_t wf_probe_smem_attr = 0;   // the largest size opted into so far

// keys: int32 [K]; vals: 4-byte words [K]; probe: int32 [C]; valid, hit:
// bool [C]; out: 4-byte words [C]; table: scratch of 2^log_m 8-byte slots,
// 2^log_m >= 2K (log_m in [1, 31]). smem: nonzero for the shared-memory
// form. zero_fix: nonzero for float values of a table of K >= 2 rows. All
// on `stream`.
WF_EXPORT int wf_join_probe(const int* keys, const void* vals, const int* probe,
                            const unsigned char* valid, void* out, unsigned char* hit,
                            void* table, long long C, int K, int log_m, int smem,
                            int zero_fix, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (C < 0 || K < 0 || log_m < 1 || log_m > 31 || (K > 0 && (1LL << log_m) < 2LL * K))
        return (int)cudaErrorInvalidValue;
    if (K == 0) {                 // empty table: every lane misses
        cudaMemsetAsync(out, 0, (size_t)C * 4, st);
        cudaMemsetAsync(hit, 0, (size_t)C, st);
        return (int)cudaGetLastError();
    }
    unsigned long long* slots = static_cast<unsigned long long*>(table);
    cudaError_t e = cudaMemsetAsync(slots, 0xff, (size_t)8 << log_m, st);
    if (e != cudaSuccess) return (int)e;
    wf_probe_build<<<wf_blocks(K, 256, 1, WF_SMS * 8), 256, 0, st>>>(keys, slots, K, log_m);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

    const long long groups = (C + WF_PROBE_LANES - 1) / WF_PROBE_LANES;
    const size_t bytes = smem ? (size_t)8 << log_m : 0;
    void (*kernel)(const unsigned long long*, int, const uint32_t*, const int*,
                   const unsigned char*, uint32_t*, unsigned char*, long long, bool) =
        smem ? &wf_probe_kernel<true> : &wf_probe_kernel<false>;
    if (smem && bytes > wf_probe_smem_attr) {
        e = cudaFuncSetAttribute(wf_probe_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
        wf_probe_smem_attr = bytes;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WF_PROBE_THREADS,
                                                      bytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    if (per_sm > WF_PROBE_BLOCKS_PER_SM) per_sm = WF_PROBE_BLOCKS_PER_SM;
    const int blocks = wf_blocks(groups, WF_PROBE_THREADS, 1, WF_SMS * per_sm);
    kernel<<<blocks, WF_PROBE_THREADS, bytes, st>>>(
        slots, log_m, static_cast<const uint32_t*>(vals), probe, valid,
        static_cast<uint32_t*>(out), hit, C, zero_fix != 0);
    return (int)cudaGetLastError();
}
