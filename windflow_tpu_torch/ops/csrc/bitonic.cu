// K4 — bitonic sort and merge networks over four int32 lanes
// (prim, sec, chan, idx) with a lexicographic compare-exchange, on R
// independent rows of n = 2^m lanes each (row-major [R, n]).
//
// Replaces windflow_tpu/ops/bitonic.py::_pallas_network (one Pallas kernel
// running _sort_stages or _merge_stages with the four arrays in VMEM, for
// n <= 2^15). The stage order, the pairing and the direction rule are
// _sort_stages' exactly: stage k = 2, 4, .., n; substage d = k/2, .., 1; the
// pair (i, i + d) with bit d of i clear sorts ascending iff (i & k) == 0,
// where i is the lane within its row; a pair whose lower lane is not
// lexicographically smaller swaps (descending: keeps) exactly as the JAX
// butterfly's selects do, ties included. The merge network is the last
// stage alone (k = n: every pair ascending). Because idx is unique in every
// caller, the output equals a stable lexsort. This kernel takes any power of
// two n >= 2 (the XLA network above 2^15 is the same function).
//
// Bound on the H100: bytes. Each lane's 16 bytes are read once and written
// once (TopN at bench geometry, [16, 2^15]: 16.8 MB, about 5 us at
// 3.35 TB/s); the compare-exchanges (R * n/2 per substage, 120 substages
// for n = 2^15) come to about 4 us at 67 T/s if counted as 8 int32
// operations each.
//
// The trap, and the design: a row of 2^15 lanes is 512 KB, more than one
// SM's 227 KB of shared memory, so a row cannot live in one block the way it
// lived in VMEM. Substages whose stride d reaches across a 4096-lane tile
// (64 KB of shared memory) run as global-memory passes, one launch each,
// one thread per pair; all the smaller strides of a stage run in one
// shared-memory launch per tile. The first launch sorts every tile fully
// (stages 2 .. 4096). So a sort of n = 2^15 is 10 launches and a merge 4;
// the global passes run out of L2 (the TopN keys are 8 MB). The first launch
// reads the inputs and writes the outputs; every later one works in place on
// the outputs. The host side below issues all launches of one network, so
// the Python wrapper counts one launch per call.
#include "common.cuh"

constexpr int WF_BITONIC_TILE = 4096;         // lanes of one shared-memory tile
constexpr int WF_BITONIC_THREADS = 1024;      // threads of a shared-memory block

struct WfLanes {
    const int* in[4];
    int* out[4];
};

// strict lexicographic (a0, a1, a2, a3) < (b0, b1, b2, b3)
__device__ __forceinline__ bool wf_lex_lt(const int a[4], const int b[4]) {
    if (a[0] != b[0]) return a[0] < b[0];
    if (a[1] != b[1]) return a[1] < b[1];
    if (a[2] != b[2]) return a[2] < b[2];
    return a[3] < b[3];
}

// One stride-d substage of stage k over [R, n], one thread per pair.
__global__ void wf_bitonic_global(WfLanes L, long long pairs, int log_n, int k, int d,
                                  int log_d) {
    const long long half_mask = (1LL << (log_n - 1)) - 1;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < pairs;
         p += stride) {
        long long row = p >> (log_n - 1);
        int q = (int)(p & half_mask);
        int i = ((q >> log_d) << (log_d + 1)) | (q & (d - 1));
        long long ai = (row << log_n) + i, aj = ai + d;
        int a[4], b[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) { a[c] = L.in[c][ai]; b[c] = L.in[c][aj]; }
        bool lt = wf_lex_lt(a, b);
        bool take0 = ((i & k) == 0) ? lt : !lt;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            L.out[c][ai] = take0 ? a[c] : b[c];
            L.out[c][aj] = take0 ? b[c] : a[c];
        }
    }
}

// Stages k_first .. k_last (doubling) of one tile of T lanes, each stage's
// substages from min(k/2, d_first) down to 1, in shared memory. One block
// per (row, tile); T is a power of two, at most WF_BITONIC_TILE.
__global__ void __launch_bounds__(WF_BITONIC_THREADS)
wf_bitonic_smem(WfLanes L, int n, int T, int k_first, int k_last, int d_first) {
    extern __shared__ int wf_bitonic_sm[];
    int* s[4] = {wf_bitonic_sm, wf_bitonic_sm + T, wf_bitonic_sm + 2 * T,
                 wf_bitonic_sm + 3 * T};
    const int tiles = n / T;
    const long long row = blockIdx.x / tiles;
    const int lane0 = (blockIdx.x % tiles) * T;
    const long long base = row * n + lane0;
    for (int j = threadIdx.x; j < T; j += blockDim.x) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c][j] = L.in[c][base + j];
    }
    __syncthreads();
    for (int k = k_first; k <= k_last; k <<= 1) {
        for (int d = min(k >> 1, d_first); d >= 1; d >>= 1) {
            for (int q = threadIdx.x; q < (T >> 1); q += blockDim.x) {
                int i = (q / d) * 2 * d + (q & (d - 1));
                int a[4], b[4];
#pragma unroll
                for (int c = 0; c < 4; ++c) { a[c] = s[c][i]; b[c] = s[c][i + d]; }
                bool lt = wf_lex_lt(a, b);
                bool take0 = (((lane0 + i) & k) == 0) ? lt : !lt;
                if (!take0) {
#pragma unroll
                    for (int c = 0; c < 4; ++c) { s[c][i] = b[c]; s[c][i + d] = a[c]; }
                }
            }
            __syncthreads();
        }
    }
    for (int j = threadIdx.x; j < T; j += blockDim.x) {
#pragma unroll
        for (int c = 0; c < 4; ++c) L.out[c][base + j] = s[c][j];
    }
}

static int wf_log2(long long v) {
    int r = 0;
    while ((1LL << r) < v) ++r;
    return r;
}

// in[c], out[c]: int32 [R, n] for c = prim, sec, chan, idx; n = 2^m >= 2.
// sort != 0: the full sort network; 0: the merge network (bitonic input).
// Returns cudaErrorInvalidValue for a bad geometry.
WF_EXPORT int wf_bitonic_network(const int* in0, const int* in1, const int* in2,
                                 const int* in3, int* out0, int* out1, int* out2,
                                 int* out3, long long R, long long n, int sort,
                                 void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (n < 2 || (n & (n - 1)) || n > (1LL << 30) || R < 1 ||
        R * (n / WF_BITONIC_TILE > 0 ? n / WF_BITONIC_TILE : 1) > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int log_n = wf_log2(n);
    const int T = (int)(n < WF_BITONIC_TILE ? n : WF_BITONIC_TILE);
    const int threads = T / 2 < WF_BITONIC_THREADS ? T / 2 : WF_BITONIC_THREADS;
    const size_t smem = (size_t)4 * T * sizeof(int);
    static bool smem_attr = false;
    if (!smem_attr) {
        cudaError_t e = cudaFuncSetAttribute(
            wf_bitonic_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
            4 * WF_BITONIC_TILE * (int)sizeof(int));
        if (e != cudaSuccess) return (int)e;
        smem_attr = true;
    }
    const int smem_blocks = (int)(R * (n / T));
    const long long pairs = R * (n / 2);
    const int gblocks = wf_blocks(pairs, 256, 2, WF_SMS * 32);
    WfLanes first = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
    WfLanes inplace = {{out0, out1, out2, out3}, {out0, out1, out2, out3}};
    bool started = false;
    auto lanes = [&]() { WfLanes l = started ? inplace : first; started = true; return l; };

    long long k0;
    if (sort) {                   // stages 2 .. T inside each tile
        wf_bitonic_smem<<<smem_blocks, threads, smem, st>>>(lanes(), (int)n, T, 2, T,
                                                            T / 2);
        k0 = 2LL * T;
    } else {
        k0 = n;                   // the merge network is the last stage alone
    }
    for (long long k = k0; k <= n; k <<= 1) {
        for (long long d = k / 2; d >= T; d >>= 1)
            wf_bitonic_global<<<gblocks, 256, 0, st>>>(lanes(), pairs, log_n, (int)k,
                                                       (int)d, wf_log2(d));
        wf_bitonic_smem<<<smem_blocks, threads, smem, st>>>(lanes(), (int)n, T, (int)k,
                                                            (int)k, T / 2);
    }
    return (int)cudaGetLastError();
}
