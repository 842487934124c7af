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
// take the first row. The TPU kernel stopped at K = 2048; this one tiles the
// table and takes any K.
//
// Bound on the H100: operations. The scan does C * K int32 compares (q3 at
// full width: C = 2^20, K = 2048 is 2^31 compares, about 32 us at 67 T/s),
// against about 13 B of memory traffic per lane (C = 2^20: 13.6 MB, about
// 4 us). A hashed or sorted probe would cut the compares to O(C log K) or
// O(C); that is a redesign left for later.
//
// Design: each block stages a tile of 4096 keys (16 KB) in shared memory;
// every thread holds 8 probe lanes in registers and walks the tile, all
// threads reading the same word at once (a broadcast, no bank conflicts),
// four keys per 16-byte load. Tiles and keys are walked from the last row to
// the first and each match overwrites the found row, so the row left is the
// first match without a test for "found already": one compare and one
// select per key and lane. The value is gathered from device memory once
// per lane at the end.
#include "common.cuh"

constexpr int WF_PROBE_TILE = 4096;   // keys staged per pass (16 KB)
constexpr int WF_PROBE_LANES = 8;     // probe lanes per thread
constexpr int WF_PROBE_THREADS = 256;

__global__ void __launch_bounds__(WF_PROBE_THREADS)
wf_join_probe_kernel(const int* __restrict__ keys, const uint32_t* __restrict__ vals,
                     const int* __restrict__ probe,
                     const unsigned char* __restrict__ valid,
                     uint32_t* __restrict__ out, unsigned char* __restrict__ hit,
                     long long C, int K, bool zero_fix) {
    __shared__ __align__(16) int skey[WF_PROBE_TILE];
    const long long base = (long long)blockIdx.x * blockDim.x * WF_PROBE_LANES
                           + threadIdx.x;
    int p[WF_PROBE_LANES], m[WF_PROBE_LANES];
#pragma unroll
    for (int l = 0; l < WF_PROBE_LANES; ++l) {
        long long i = base + (long long)l * blockDim.x;
        p[l] = i < C ? __ldg(probe + i) : 0;
        m[l] = -1;
    }
    for (int t0 = ((K - 1) / WF_PROBE_TILE) * WF_PROBE_TILE; t0 >= 0;
         t0 -= WF_PROBE_TILE) {
        const int nt = min(WF_PROBE_TILE, K - t0);
        __syncthreads();                       // the previous tile is done
        for (int j = threadIdx.x; j < nt; j += blockDim.x) skey[j] = __ldg(keys + t0 + j);
        __syncthreads();
        for (int j = nt - 1; j >= (nt & ~3); --j) {      // the ragged tail
            const int k = skey[j];
#pragma unroll
            for (int l = 0; l < WF_PROBE_LANES; ++l) m[l] = p[l] == k ? t0 + j : m[l];
        }
        const int4* k4 = reinterpret_cast<const int4*>(skey);
        for (int q = (nt >> 2) - 1; q >= 0; --q) {
            const int4 k = k4[q];
            const int jb = t0 + 4 * q;
#pragma unroll
            for (int l = 0; l < WF_PROBE_LANES; ++l) {
                int r = m[l];
                r = p[l] == k.w ? jb + 3 : r;
                r = p[l] == k.z ? jb + 2 : r;
                r = p[l] == k.y ? jb + 1 : r;
                r = p[l] == k.x ? jb : r;
                m[l] = r;
            }
        }
    }
#pragma unroll
    for (int l = 0; l < WF_PROBE_LANES; ++l) {
        long long i = base + (long long)l * blockDim.x;
        if (i >= C) continue;
        bool h = valid[i] && m[l] >= 0;
        uint32_t v = h ? __ldg(vals + m[l]) : 0u;
        if (zero_fix && v == 0x80000000u) v = 0u;
        out[i] = v;
        hit[i] = h;
    }
}

// keys: int32 [K]; vals: 4-byte words [K]; probe: int32 [C]; valid, hit:
// bool [C]; out: 4-byte words [C]. zero_fix: nonzero for float values of a
// table of K >= 2 rows. All on `stream`.
WF_EXPORT int wf_join_probe(const int* keys, const void* vals, const int* probe,
                            const unsigned char* valid, void* out, unsigned char* hit,
                            long long C, int K, int zero_fix, void* stream) {
    const long long per_block = (long long)WF_PROBE_THREADS * WF_PROBE_LANES;
    long long blocks = (C + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (K <= 0) {                 // empty table: every lane misses
        cudaMemsetAsync(out, 0, (size_t)C * 4, (cudaStream_t)stream);
        cudaMemsetAsync(hit, 0, (size_t)C, (cudaStream_t)stream);
        return (int)cudaGetLastError();
    }
    wf_join_probe_kernel<<<(int)blocks, WF_PROBE_THREADS, 0, (cudaStream_t)stream>>>(
        keys, static_cast<const uint32_t*>(vals), probe, valid,
        static_cast<uint32_t*>(out), hit, C, K, zero_fix != 0);
    return (int)cudaGetLastError();
}
