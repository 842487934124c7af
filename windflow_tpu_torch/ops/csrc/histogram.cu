// K1 — keyed pane histogram: out[k, floor_mod(pane, P)] += 1 for every valid
// lane whose key k lies in [0, K).
//
// Replaces windflow_tpu/ops/histogram.py::_pallas_fast (the Pallas kernel
// behind keyed_pane_histogram_pallas), and with it the XLA einsum fast path,
// its lax.cond locality check and the _scatter_hist fallback: all of them
// compute this same count, which this kernel gives for any input.
//
// Bound on the H100: bytes. Each lane reads 9 B (key, pane, valid) and the
// [K, P] i32 output is written once (YSB: C = 2^20, K = 100, P = 4096 —
// 9.4 MB in, 1.6 MB out, about 3.3 us at 3.35 TB/s).
//
// Design (partials.cuh has the common shape): a persistent grid of tiles of
// 1024 contiguous lanes, eight CTAs of 256 threads a SM. A tile of a
// time-ordered stream spans few panes (YSB: about 2 of 1000 lanes each), so
// each tile counts into a [K, Lw] window of int32 in shared memory anchored
// at its lowest counted pane pmin (a block min over valid lanes with a key
// in range), Lw = pmax - pmin + 1, and flushes each nonzero cell with one
// global atomic to out[k, floor_mod(pmin + j, P)]. Pane offsets and pmin + j
// are computed in 64 bits: panes may span the whole int32 range. When
// Lw > P two window columns land on one ring column, which the atomic flush
// sums exactly.
//
// A tile whose panes span more than the window holds (Lw_max = 4096 / K
// columns, 16 KB) goes global: each counted lane adds one to
// out[k, floor_mod(pane, P)] with a global atomic. So does every tile when
// K > 512 (a window of fewer than 8 columns). A hashed table of cells for
// such tiles was measured no faster than the global atomics (PERF.md §6).
//
// The output is zeroed by a memset before the launch: zeroing it inside the
// kernel needs a grid barrier (a cooperative launch) before the first
// flush, and measured no faster than the memset (PERF.md §6). Warp
// aggregation of lanes on one cell was measured too: its ballots and
// shuffles cost more on YSB's tiles than shared atomics on one address
// cost when every lane names one cell, so there is none.
#include "partials.cuh"

using WfHistTile = WfTile<256>;
constexpr int WF_HIST_PER_SM = 8;
constexpr int WF_HIST_SMEM = 16384;                      // the window's bytes
constexpr int WF_HIST_MIN_LW = 8;

// Columns of the window for K keys (0: every tile goes global).
static int wf_hist_lw_max(int K) {
    int lw = WF_HIST_SMEM / 4 / (K > 0 ? K : 1);
    return lw < WF_HIST_MIN_LW ? 0 : lw;
}

__global__ void __launch_bounds__(WfHistTile::threads, WF_HIST_PER_SM)
wf_hist_tiles(const int* __restrict__ key, const int* __restrict__ pane,
              const unsigned char* __restrict__ valid, int* __restrict__ out,
              int* __restrict__ stats, long long n, int K, int P, int lw_max, bool vec) {
    using Tile = WfHistTile;
    extern __shared__ int wf_hist_sm[];
    __shared__ int red[2 * Tile::warps];
    const long long tiles = (n + Tile::lanes - 1) / Tile::lanes;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long base = t * Tile::lanes;
        int k[4], p[4], v[4];
        wf_load4(key, base, n, vec, k);
        wf_load4(pane, base, n, vec, p);
        wf_load4(valid, base, n, vec, v);
        int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
            v[l] = v[l] && k[l] >= 0 && k[l] < K;          // counted
            if (v[l]) { lo = min(lo, p[l]); hi = max(hi, p[l]); }
        }
        wf_block_minmax<Tile>(lo, hi, red);
        if (lo > hi) {                                    // no counted lane
            if (stats && threadIdx.x == 0) atomicAdd(stats + WF_ST_EMPTY, 1);
            continue;
        }
        const long long span = (long long)hi - lo + 1;
        if (span > lw_max) {                              // global: one atomic a lane
#pragma unroll
            for (int l = 0; l < 4; ++l)
                if (v[l]) atomicAdd(out + (long long)k[l] * P + wf_floor_mod(p[l], P), 1);
            if (stats && threadIdx.x == 0) atomicAdd(stats + WF_ST_GLOBAL, 1);
            continue;
        }
        const int lw = (int)span, cells = K * lw;         // the window at pmin = lo
        for (int j = threadIdx.x; j < cells; j += Tile::threads) wf_hist_sm[j] = 0;
        __syncthreads();
#pragma unroll
        for (int l = 0; l < 4; ++l)
            if (v[l]) atomicAdd(wf_hist_sm + k[l] * lw + (int)((long long)p[l] - lo), 1);
        __syncthreads();
        const long long lo_mod = ((long long)lo % P + P) % P;
        for (int j = threadIdx.x; j < cells; j += Tile::threads) {
            const int c = wf_hist_sm[j];
            if (c) {
                const int kk = j / lw, col = j - kk * lw;
                atomicAdd(out + (long long)kk * P + (lo_mod + col) % P, c);
            }
        }
        if (stats && threadIdx.x == 0) atomicAdd(stats + WF_ST_DIRECT, 1);
        __syncthreads();                                  // before the next tile's window
    }
}

static bool wf_hist_bad(long long n, int K, int P) {
    return n < 0 || K < 0 || P <= 0 || (long long)K * P >= (1LL << 31);
}

static int wf_hist_grid(long long n, int* grid) {
    return wf_pt_grid((const void*)wf_hist_tiles, WfHistTile::threads, WF_HIST_SMEM,
                      WF_HIST_PER_SM, (n + WfHistTile::lanes - 1) / WfHistTile::lanes, grid);
}

// The launch K1 makes for n lanes, K keys and a ring of P panes: CTAs of the
// grid, dynamic shared memory a CTA, the window's most columns (0: every
// tile goes global) and lanes a tile.
WF_EXPORT int wf_histogram_plan(long long n, int K, int P, int* grid, int* smem,
                                int* lw_max, int* tile) {
    if (wf_hist_bad(n, K, P)) return (int)cudaErrorInvalidValue;
    *smem = WF_HIST_SMEM;
    *lw_max = wf_hist_lw_max(K);
    *tile = WfHistTile::lanes;
    return wf_hist_grid(n, grid);
}

// out: int32 [K, P] (any contents on entry: a memset zeroes it first), on
// `stream`. stats: nullptr, or int32 [WF_ST_COUNT] (3) to which the launch
// adds its WF_ST_* counts.
WF_EXPORT int wf_keyed_pane_histogram(const int* key, const int* pane,
                                      const unsigned char* valid, int* out, int* stats,
                                      long long n, int K, int P, void* stream) {
    if (wf_hist_bad(n, K, P)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    cudaGetLastError();   // an earlier runtime call's error is not this launch's
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)K * P * 4, st);
    if (e != cudaSuccess || n == 0 || K == 0) return (int)e;
    int grid = 0;
    int r = wf_hist_grid(n, &grid);
    if (r) return r;
    const int lw_max = wf_hist_lw_max(K);
    const bool vec = ((uintptr_t)key % 16 == 0) && ((uintptr_t)pane % 16 == 0) &&
                     ((uintptr_t)valid % 4 == 0);
    wf_hist_tiles<<<grid, WfHistTile::threads, WF_HIST_SMEM, st>>>(
        key, pane, valid, out, stats, n, K, P, lw_max, vec);
    return (int)cudaGetLastError();
}
