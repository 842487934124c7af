// Block-private partial sums in shared memory, shared by K1 (histogram.cu)
// and K3 (segment.cu).
//
// Both kernels add a small integer per lane into an int32 output cell chosen
// by the lane, and drop lanes that name no cell. Both run the same shape:
//
// - a persistent grid (every CTA resident at once), each CTA taking whole
//   tiles of 4 * THREADS contiguous lanes (tile t covers lanes
//   [t * TILE, (t + 1) * TILE)), so a CTA sees a contiguous stretch of a
//   time-ordered stream and the few cells it hits;
// - each thread loads four neighbouring lanes of a tile, one vector load per
//   array (16 bytes of int32, 4 bytes of bool), neighbouring threads on
//   neighbouring lanes; the ragged tail and unaligned arrays take scalar
//   loads;
// - the lane's add goes to a partial in shared memory (a direct array or a
//   window), and the partials are flushed to the output once; a tile whose
//   cells do not fit the partials goes global: each lane adds with one
//   atomic straight to the output.
//
// Every add is a wrapping int32 add, which is associative and commutative, so
// the output's bits do not depend on the order in which partials land.
#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

// Counters a launch may report (stats != nullptr): tiles that took the
// direct partials (K3) or the window (K1), tiles that went global (one
// atomic a lane straight to the output), tiles with no counted lane (K1).
enum { WF_ST_DIRECT = 0, WF_ST_GLOBAL = 1, WF_ST_EMPTY = 2, WF_ST_COUNT = 3 };

// A tile of THREADS threads, four lanes each.
template <int THREADS> struct WfTile {
    static constexpr int threads = THREADS;
    static constexpr int warps = THREADS / 32;
    static constexpr int lanes = 4 * THREADS;
};

template <typename T> struct alignas(4 * sizeof(T)) WfQuad { T v[4]; };

// This thread's four lanes of the tile starting at base, as int, 0 past n.
// vec: p is aligned for one 4-lane vector load.
template <typename T>
__device__ __forceinline__ void wf_load4(const T* __restrict__ p, long long base, long long n,
                                         bool vec, int out[4]) {
    const long long i = base + 4LL * threadIdx.x;
    if (vec && i + 3 < n) {
        WfQuad<T> q = *reinterpret_cast<const WfQuad<T>*>(p + i);
#pragma unroll
        for (int l = 0; l < 4; ++l) out[l] = (int)q.v[l];
    } else {
#pragma unroll
        for (int l = 0; l < 4; ++l) out[l] = i + l < n ? (int)p[i + l] : 0;
    }
}

// Block-wide min and max of this thread's (lo, hi); every thread gets both.
// red: 2 * warps ints of shared memory. Ends with a barrier.
template <typename Tile>
__device__ __forceinline__ void wf_block_minmax(int& lo, int& hi, int* red) {
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) { red[w] = lo; red[Tile::warps + w] = hi; }
    __syncthreads();
    lo = red[0];
    hi = red[Tile::warps];
#pragma unroll
    for (int i = 1; i < Tile::warps; ++i) {
        lo = min(lo, red[i]);
        hi = max(hi, red[Tile::warps + i]);
    }
    __syncthreads();
}

// CTAs of a persistent grid over `tiles` tiles for `kernel` with `threads`
// threads and `smem` bytes of dynamic shared memory on the current device:
// at most `per_sm_max` a SM, all resident at once (a cooperative launch needs
// that). Per device, the kernel's opt-in shared memory only grows (a smaller
// size set later would refuse the launches of a larger one) and the
// occupancy of each (kernel, smem) pair is asked once.
static int wf_pt_grid(const void* kernel, int threads, size_t smem, int per_sm_max,
                      long long tiles, int* grid) {
    struct Entry { const void* k; int dev; size_t smem; int ctas; };
    struct Optin { const void* k; int dev; size_t smem; };
    static Entry cache[64];
    static Optin optin[32];
    static int used = 0, opted = 0;
    static std::mutex lock;
    std::lock_guard<std::mutex> hold(lock);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    int ctas = 0;
    for (int i = 0; i < used; ++i)
        if (cache[i].k == kernel && cache[i].dev == dev && cache[i].smem == smem)
            ctas = cache[i].ctas;
    if (!ctas) {
        int o = 0;
        while (o < opted && (optin[o].k != kernel || optin[o].dev != dev)) ++o;
        if (o == opted) {
            if (opted == 32) return (int)cudaErrorInvalidConfiguration;
            optin[opted++] = {kernel, dev, 0};
        }
        if (smem > optin[o].smem) {
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
            if (e != cudaSuccess) return (int)e;
            optin[o].smem = smem;
        }
        int per_sm = 0, sms = 0;
        if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                               smem)) != cudaSuccess)
            return (int)e;
        if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
            return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        ctas = (per_sm < per_sm_max ? per_sm : per_sm_max) * sms;
        if (used < 64) cache[used++] = {kernel, dev, smem, ctas};
    }
    *grid = (int)(tiles < ctas ? (tiles < 1 ? 1 : tiles) : ctas);
    return (int)cudaSuccess;
}
