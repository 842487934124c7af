// K3 — masked integer segment sum: out[s] = sum of values[i] over valid lanes
// with seg[i] == s, in wrapping int32 arithmetic; segment ids outside
// [0, S) are dropped.
//
// Replaces windflow_tpu/ops/segment.py::_pallas_segment_fold (the fold behind
// Win_SeqFFAT's additive non-count lifts, win_seqffat.py:221 via
// segment_reduce). The TPU kernel split each value into 11-bit limbs so that
// f32 one-hot matmuls stayed exact, then recombined with wrapping adds.
// Here int32 adds wrap in two's complement, and mod-2^32 addition is
// associative and commutative, so the result equals XLA's integer
// segment_sum bit for bit, overflow included, whatever order the adds land
// in. Narrower inputs (int8, int16, uint8) widen to int32 here and the
// wrapper casts the int32 sum back, as segment.py:147 does.
//
// Bound on the H100: bytes. Each lane reads its value, a 4 B segment id and
// a 1 B flag; the [S] i32 output is written once (C = 2^20 int32 values:
// 9.4 MB in). The JAX kernel stopped at S = 4096 (FOLD_MAX_SEGMENTS); this
// one serves any S, because Win_SeqFFAT folds into S = K * P = 409,600.
//
// Design (partials.cuh has the common shape): a persistent grid and one of
// two paths a launch (wf_segment_fold_plan reports which):
//
// - direct, when S <= 16384 (64 KB) and the grid's partials are no more
//   than the lanes (G * S <= max(C, 2^16)): one CTA of 1024 threads a SM,
//   tiles of 4096 lanes, each CTA summing all its tiles into a private [S]
//   array in shared memory. Then the flush:
//   - S <= 512 (paths A and B: 512 and 100): the workspace reduce. Each CTA
//     writes its partials to a workspace column ws[s * G + cta]; after one
//     grid barrier (a cooperative launch) a warp sums each row of ws and
//     writes out[s] once. No atomic touches the output and no memset runs,
//     and no address takes G atomics in a row.
//   - larger S: each nonzero partial's global atomic into an output zeroed
//     by a memset (at S = 4096 the workspace's 540K scattered stores and
//     reads cost more than 540K atomics spread over 4096 addresses).
// - global, otherwise (YSB-sum's S = 409,600): eight CTAs of 256 threads a
//   SM, tiles of 1024 lanes, each lane adding with one global atomic into
//   an output zeroed by a memset.
//
// The choices (tile sizes, the reduce's S limit, the memset against a zero
// fill behind a grid barrier, global atomics against a hashed table of
// segment ids in shared memory, which measured no faster at YSB-sum) were
// made by measurement on the H100; the times are in PERF.md §6.
#include "partials.cuh"

enum { WF_FOLD_DIRECT = 0, WF_FOLD_GLOBAL = 1 };
enum { WF_FLUSH_REDUCE = 0, WF_FLUSH_ATOMIC = 1 };
constexpr int WF_FOLD_DIRECT_MAX = 16384;     // direct partials: at most 64 KB
constexpr int WF_FOLD_REDUCE_MAX = 512;       // the workspace flush up to this S

// Each path's tile: the direct path in one CTA of 1024 threads a SM, the
// global path in eight CTAs of 256 a SM (tiles of 1024 lanes).
template <int PATH> struct WfFoldCfg {
    using Tile = WfTile<PATH == WF_FOLD_DIRECT ? 1024 : 256>;
    static constexpr int per_sm = PATH == WF_FOLD_DIRECT ? 1 : 8;
};

// PATH: WF_FOLD_DIRECT or WF_FOLD_GLOBAL. REDUCE (direct only): the
// workspace flush behind a grid barrier (a cooperative launch), else each
// nonzero partial's global atomic into an output zeroed by a memset.
template <typename T, int PATH, bool REDUCE>
__global__ void __launch_bounds__(WfFoldCfg<PATH>::Tile::threads, WfFoldCfg<PATH>::per_sm)
wf_fold_tiles(const T* __restrict__ values, const int* __restrict__ seg,
              const unsigned char* __restrict__ valid, int* __restrict__ out,
              int* __restrict__ ws, int* __restrict__ stats, long long n, int S, bool vec) {
    using Tile = typename WfFoldCfg<PATH>::Tile;
    extern __shared__ int wf_fold_sm[];
    const long long tiles = (n + Tile::lanes - 1) / Tile::lanes;
    if (PATH == WF_FOLD_DIRECT) {
        for (int j = threadIdx.x; j < S; j += Tile::threads) wf_fold_sm[j] = 0;
        __syncthreads();
    }
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long base = t * Tile::lanes;
        int x[4], s[4], v[4];
        wf_load4(values, base, n, vec, x);
        wf_load4(seg, base, n, vec, s);
        wf_load4(valid, base, n, vec, v);
        int* const to = PATH == WF_FOLD_DIRECT ? wf_fold_sm : out;
#pragma unroll
        for (int l = 0; l < 4; ++l)
            if (v[l] && s[l] >= 0 && s[l] < S) atomicAdd(to + s[l], x[l]);
        if (stats && threadIdx.x == 0)
            atomicAdd(stats + (PATH == WF_FOLD_DIRECT ? WF_ST_DIRECT : WF_ST_GLOBAL), 1);
    }
    if (PATH != WF_FOLD_DIRECT) return;
    __syncthreads();
    if (!REDUCE) {
        for (int j = threadIdx.x; j < S; j += Tile::threads) {
            const int c = wf_fold_sm[j];
            if (c) atomicAdd(out + j, c);
        }
        return;
    }
    // the workspace flush: this CTA's column of ws, one grid barrier, then
    // each warp sums whole rows and writes their segments once
    const int G = gridDim.x;
    for (int j = threadIdx.x; j < S; j += Tile::threads)
        ws[(long long)j * G + blockIdx.x] = wf_fold_sm[j];
    cg::this_grid().sync();
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)G * Tile::warps;
    for (long long j = (long long)blockIdx.x * Tile::warps + (threadIdx.x >> 5); j < S;
         j += warps) {
        const int* row = ws + j * G;
        int acc = 0;
#pragma unroll 4
        for (int r = lane; r < G; r += 32) acc += row[r];
        acc = __reduce_add_sync(0xffffffffu, acc);
        if (lane == 0) out[j] = acc;
    }
}

static size_t wf_fold_smem(int path, int S) {
    return path == WF_FOLD_DIRECT ? (size_t)(S > 0 ? S : 1) * 4 : 0;
}

// The kernel of a (dtype, path, flush) triple; nullptr for a bad dtype.
static const void* wf_fold_pick(int dtype_code, int path, int flush) {
#define WF_FOLD_PICK(T)                                                                  \
    return path == WF_FOLD_GLOBAL      ? (const void*)wf_fold_tiles<T, WF_FOLD_GLOBAL, false> \
           : flush == WF_FLUSH_REDUCE ? (const void*)wf_fold_tiles<T, WF_FOLD_DIRECT, true>  \
                                      : (const void*)wf_fold_tiles<T, WF_FOLD_DIRECT, false>;
    switch (dtype_code) {
        case 0: WF_FOLD_PICK(int32_t)
        case 1: WF_FOLD_PICK(int16_t)
        case 2: WF_FOLD_PICK(int8_t)
        case 3: WF_FOLD_PICK(uint8_t)
        default: return nullptr;
    }
#undef WF_FOLD_PICK
}

static int wf_fold_grid(int dtype_code, int path, int flush, long long n, int S, int* grid) {
    const bool direct = path == WF_FOLD_DIRECT;
    const int lanes = direct ? WfFoldCfg<WF_FOLD_DIRECT>::Tile::lanes
                             : WfFoldCfg<WF_FOLD_GLOBAL>::Tile::lanes;
    return wf_pt_grid(wf_fold_pick(dtype_code, path, flush),
                      direct ? WfFoldCfg<WF_FOLD_DIRECT>::Tile::threads
                             : WfFoldCfg<WF_FOLD_GLOBAL>::Tile::threads,
                      wf_fold_smem(path, S),
                      direct ? WfFoldCfg<WF_FOLD_DIRECT>::per_sm
                             : WfFoldCfg<WF_FOLD_GLOBAL>::per_sm,
                      (n + lanes - 1) / lanes, grid);
}

// The path and flush of a launch, chosen from (n, S), and its grid. Direct
// when S fits and the grid's partials are no more than the lanes; the
// workspace reduce for a direct S of at most 512.
static int wf_fold_geometry(long long n, int S, int dtype_code, int* path, int* flush,
                            int* grid) {
    if (n < 0 || S < 0 || dtype_code < 0 || dtype_code > 3) return (int)cudaErrorInvalidValue;
    *path = WF_FOLD_GLOBAL;
    if (S <= WF_FOLD_DIRECT_MAX) {
        int g = 0;
        int e = wf_fold_grid(dtype_code, WF_FOLD_DIRECT, WF_FLUSH_ATOMIC, n, S, &g);
        if (e) return e;
        const long long room = n > (1LL << 16) ? n : (1LL << 16);
        if ((long long)g * S <= room) *path = WF_FOLD_DIRECT;
    }
    *flush = *path == WF_FOLD_DIRECT && S <= WF_FOLD_REDUCE_MAX ? WF_FLUSH_REDUCE
                                                                : WF_FLUSH_ATOMIC;
    return wf_fold_grid(dtype_code, *path, *flush, n, S, grid);
}

// The launch K3 makes: CTAs of the grid, dynamic shared memory a CTA, the
// path (0 direct, 1 global), the flush (0 the workspace reduce, 1 atomics
// into a zeroed output), lanes a tile and the int32 workspace it needs (the
// workspace reduce's [S, grid] partials, else 0).
WF_EXPORT int wf_segment_fold_plan(long long n, int S, int dtype_code, int* grid, int* smem,
                                   int* path, int* flush, int* tile, long long* ws_ints) {
    int e = wf_fold_geometry(n, S, dtype_code, path, flush, grid);
    if (e) return e;
    *smem = (int)wf_fold_smem(*path, S);
    *tile = *path == WF_FOLD_DIRECT ? WfFoldCfg<WF_FOLD_DIRECT>::Tile::lanes
                                    : WfFoldCfg<WF_FOLD_GLOBAL>::Tile::lanes;
    *ws_ints = *flush == WF_FLUSH_REDUCE ? (long long)*grid * S : 0;
    return (int)cudaSuccess;
}

// dtype_code: 0 int32, 1 int16, 2 int8, 3 uint8. out: int32 [S], any
// contents on entry. ws: int32 workspace of the plan's ws_ints (same n, S and
// dtype). stats: nullptr, or int32 [WF_ST_COUNT] (3) to which the launch
// adds its WF_ST_* counts.
WF_EXPORT int wf_segment_fold(const void* values, int dtype_code, const int* seg,
                              const unsigned char* valid, int* out, int* ws, int* stats,
                              long long n, int S, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaGetLastError();   // an earlier runtime call's error is not this launch's
    int grid = 0, path = 0, flush = 0;
    int e = wf_fold_geometry(n, S, dtype_code, &path, &flush, &grid);
    if (e) return e;
    cudaError_t r = cudaSuccess;
    if (flush == WF_FLUSH_ATOMIC || n == 0 || S == 0)
        r = cudaMemsetAsync(out, 0, (size_t)S * 4, st);
    if (r != cudaSuccess || n == 0 || S == 0) return (int)r;
    const size_t elem = dtype_code == 0 ? 4 : dtype_code == 1 ? 2 : 1;
    bool vec = ((uintptr_t)values % (4 * elem) == 0) && ((uintptr_t)seg % 16 == 0) &&
               ((uintptr_t)valid % 4 == 0);
    const void* kernel = wf_fold_pick(dtype_code, path, flush);
    const int threads = path == WF_FOLD_DIRECT ? WfFoldCfg<WF_FOLD_DIRECT>::Tile::threads
                                               : WfFoldCfg<WF_FOLD_GLOBAL>::Tile::threads;
    void* args[] = {(void*)&values, (void*)&seg, (void*)&valid, (void*)&out, (void*)&ws,
                    (void*)&stats, (void*)&n, (void*)&S, (void*)&vec};
    const size_t smem = wf_fold_smem(path, S);
    r = flush == WF_FLUSH_REDUCE
            ? cudaLaunchCooperativeKernel(kernel, grid, threads, args, smem, st)
            : cudaLaunchKernel(kernel, grid, threads, args, smem, st);
    return (int)(r != cudaSuccess ? r : cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Float segment sums in a fixed order (not a TPU kernel; registry name
// "segment_fold_float"). The JAX package sums floats with XLA's segment_sum,
// and on the CPU the port's index_add_ gives the same bits: each (segment,
// column) cell is summed from +0.0 in stream order, rounded to the value
// dtype after every add (float16 and bfloat16 add through float and round
// back, as the CPU's c10::Half and c10::BFloat16 do). On the card index_add_
// uses float atomics, which land in no fixed order. Here the wrapper sorts the
// lanes by segment (a stable sort, so each segment's lanes stay in stream
// order; dropped lanes take the key S and sort last) and gathers their rows,
// and wf_segment_fold_ordered sums each run of equal keys in order. The bits
// equal the CPU's on every run, NaN payloads aside (the card's adds give the
// canonical NaN; the CPU's payload depends on its own code path).
//
// Bound: bytes (each value read once, [S, D] written once), and a floor the
// bit contract sets: a run of n lanes is n dependent adds, so one hot segment
// takes at least n times the add's latency (about 4 cycles in float32: 2^20
// lanes about 2.1-2.4 ms at 1.755-1.98 GHz, where index_add_'s atomics take
// 1.85 ms in no fixed order). A fixed-order tree would be faster and give
// other bits.
//
// Design (a thread walking a run straight from device memory waits on its
// loads, about 28 cycles a lane, and a hot run leaves one thread working).
// Every run is found one of two ways, picked by the wrapper from S, C and D:
// - segments (S <= C, or D > 1): the wrapper searches each segment's start
//   (S + 1 queries, cheaper than a scan of C lanes when S <= C), and
//   wf_fold_segments gives a (segment, column) a thread, which walks its
//   run plainly, one add a lane (the first design). At D = 1 a run of
//   WF_RUN_LONG lanes or more is put on a work list in device memory
//   (start, end, segment) instead, for wf_fold_stream. Rows of several
//   columns are never streamed: no path folds them yet, so a hot run of
//   them still costs one thread a column its loads' latency a lane;
// - runs (S > C at D = 1: Key_FFAT's pane sums, most segments empty): the
//   output is zeroed (empty segments give +0.0), then wf_fold_runs, a
//   persistent grid over contiguous spans of the sorted lanes, gives a run
//   to the thread at its first lane. The threads of a warp take their runs
//   together, one each a round (a thread that walked a run as soon as it
//   met one would hold back every other owner in its warp). A run shorter
//   than WF_RUN_LONG lanes is walked by that thread, its keys and values
//   read eight lanes, then 32 lanes at a time, so its loads are in flight
//   together; a longer run (its lane WF_RUN_LONG - 1 still has the key) is
//   listed, its end found by binary search;
// - wf_fold_stream gives a listed run a block: four producer warps copy its
//   lanes (whole 16-byte-aligned spans) with cp.async through a ring of
//   WF_STREAM_STAGES stages in shared memory, issued three stages ahead, and
//   one consumer thread adds each stage in order from shared memory, its
//   loads taken a group of 16 lanes ahead of the adds, so the chain runs at
//   the add's latency. The grid reads the list's length on the card:
//   nothing goes back to the host, so the call captures in a graph.
// A padding add of +0.0 (a run's tail group) leaves the sum's bits as they
// are: a sum started from +0.0 is never -0.0 under round to nearest.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <atomic>

// One add of the fold, rounded to T. float16 and bfloat16 use the card's
// own half add: the CPU adds them through float and rounds back, and since
// float carries more than twice their precision plus two bits (24 >= 2 * 11
// + 2, 24 >= 2 * 8 + 2) that double rounding gives the correctly rounded
// sum, which is what the half add gives (Figueroa, "When is double rounding
// innocuous?", 1995). One dependent instruction a lane instead of three.
template <typename T> struct WfAcc {
    static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};
template <> struct WfAcc<__half> {
    static __device__ __forceinline__ __half add(__half a, __half b) { return __hadd(a, b); }
};
template <> struct WfAcc<__nv_bfloat16> {
    static __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
        return __hadd(a, b);
    }
};

constexpr int WF_RUN_LONG = 256;         // lanes from which a D = 1 run is streamed by a block
constexpr int WF_RUN_THREADS = 256;
constexpr int WF_STREAM_STAGE = 12288;   // bytes a ring stage
constexpr int WF_STREAM_STAGES = 4;      // 48 KB of shared memory, no opt-in needed
constexpr int WF_STREAM_PRODUCERS = 4;   // producer warps (warp 0 holds the consumer)
constexpr int WF_STREAM_THREADS = 32 * (1 + WF_STREAM_PRODUCERS);


// An entry of the work list for wf_fold_stream: lanes start .. end - 1 of
// segment s.
__device__ __forceinline__ void wf_list_run(unsigned long long* __restrict__ work,
                                            long long start, long long end, int s) {
    const unsigned long long k = atomicAdd(work, 1ull);
    work[1 + 3 * k] = (unsigned long long)start;
    work[2 + 3 * k] = (unsigned long long)end;
    work[3 + 3 * k] = (unsigned long long)s;
}

// The segments: a thread a (segment, column) cell, its run from starts;
// at D = 1 a run of WF_RUN_LONG lanes or more is listed for wf_fold_stream.
template <typename T>
__global__ void __launch_bounds__(WF_RUN_THREADS)
wf_fold_segments(const T* __restrict__ rows, const long long* __restrict__ starts,
                 T* __restrict__ out, unsigned long long* __restrict__ work, int S, int D) {
    const long long t = (long long)blockIdx.x * WF_RUN_THREADS + threadIdx.x;
    if (t >= (long long)S * D) return;
    const int s = (int)(t / D), col = (int)(t % D);
    const long long a = starts[s], b = starts[s + 1];
    if (D == 1 && b - a >= WF_RUN_LONG) {
        wf_list_run(work, a, b, s);
        return;
    }
    T acc = T(0.0f);
    for (long long r = a; r < b; ++r) acc = WfAcc<T>::add(acc, rows[r * D + col]);
    out[t] = acc;
}

// One step of a D = 1 walk: the keys and values of lanes r .. r + W - 1
// loaded together, the leading ones with key s added in order (the rest add
// +0.0). Returns how many led.
template <typename T, int W>
__device__ __forceinline__ int wf_walk_step(const T* __restrict__ rows,
                                            const int* __restrict__ sseg, long long r,
                                            long long C, int S, int s, T& acc) {
    int key[W];
    T v[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
        key[k] = r + k < C ? sseg[r + k] : S;
        v[k] = r + k < C ? rows[r + k] : T(0.0f);
    }
    int n = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) n += (n == k && key[k] == s);
#pragma unroll
    for (int k = 0; k < W; ++k) acc = WfAcc<T>::add(acc, k < n ? v[k] : T(0.0f));
    return n;
}

// The walkers (D = 1): a persistent grid, each thread a contiguous span of
// sorted lanes (a stride would hand one thread every run of a regular
// spacing that divides it); the thread at a live run's first lane owns the
// run, and a warp's owners take their runs in rounds, together: a short run
// walked eight lanes, then 32 at a time (wf_walk_step), a long one listed
// with its end found by binary search.
template <typename T>
__global__ void __launch_bounds__(WF_RUN_THREADS)
wf_fold_runs(const T* __restrict__ rows, const int* __restrict__ sseg, T* __restrict__ out,
             unsigned long long* __restrict__ work, long long C, int S) {
    const long long threads = (long long)gridDim.x * WF_RUN_THREADS;
    const long long span = (C + threads - 1) / threads;
    const long long t = (long long)blockIdx.x * WF_RUN_THREADS + threadIdx.x;
    const long long last = (t + 1) * span < C ? (t + 1) * span : C;
    long long i = t * span;
    for (;;) {
        while (i < last && (sseg[i] >= S || (i > 0 && sseg[i - 1] == sseg[i]))) ++i;
        if (__all_sync(0xffffffffu, i >= last)) break;       // no run left in the warp
        if (i >= last) continue;
        const int s = sseg[i];
        long long lo = i + WF_RUN_LONG - 1;
        if (lo < C && sseg[lo] == s) {                       // a block streams it
            long long hi = C;                                // the run ends at the
            while (hi - lo > 1) {                            // first other key
                const long long mid = lo + (hi - lo) / 2;
                if (sseg[mid] == s) lo = mid; else hi = mid;
            }
            wf_list_run(work, i, hi, s);
        } else {
            T acc = T(0.0f);
            int n = wf_walk_step<T, 8>(rows, sseg, i, C, S, s, acc);
            long long r = i + n;
            if (n == 8) {
                do {
                    n = wf_walk_step<T, 32>(rows, sseg, r, C, S, s, acc);
                    r += n;
                } while (n == 32);
            }
            out[s] = acc;
        }
        ++i;
    }
}

__device__ __forceinline__ void wf_cp_async16(void* dst, const void* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}

// The consumer's adds of one stage: lanes p[0] .. p[nr - 1] in groups of
// 16, two groups in registers, each group loaded while the one before is
// added, with no per-lane bound check but in the tail, so the chain is the
// adds alone.
template <typename T>
__device__ __forceinline__ T wf_stream_add(T acc, const T* p, int nr) {
    constexpr int G = 16;
    int r = 0;
    if (nr >= 2 * G) {
        T a[G], b[G];
#pragma unroll
        for (int k = 0; k < G; ++k) a[k] = p[k];
        for (; r + 3 * G <= nr; r += 2 * G) {
#pragma unroll
            for (int k = 0; k < G; ++k) b[k] = p[r + G + k];
#pragma unroll
            for (int k = 0; k < G; ++k) acc = WfAcc<T>::add(acc, a[k]);
#pragma unroll
            for (int k = 0; k < G; ++k) a[k] = p[r + 2 * G + k];
#pragma unroll
            for (int k = 0; k < G; ++k) acc = WfAcc<T>::add(acc, b[k]);
        }
#pragma unroll
        for (int k = 0; k < G; ++k) acc = WfAcc<T>::add(acc, a[k]);   // a holds p[r .. r + G)
        r += G;
    }
    for (; r < nr; ++r) acc = WfAcc<T>::add(acc, p[r]);
    return acc;
}

// One block a long D = 1 run (work[0] runs listed by wf_fold_runs); thread
// 0 adds, warps 1 .. WF_STREAM_PRODUCERS copy. rows must be readable 16
// bytes past its end (the wrapper pads it).
template <typename T>
__global__ void __launch_bounds__(WF_STREAM_THREADS)
wf_fold_stream(const T* __restrict__ rows, T* __restrict__ out,
               const unsigned long long* __restrict__ work) {
    extern __shared__ __align__(16) unsigned char wf_ring[];
    constexpr long long rowb = sizeof(T);
    constexpr int tile_rows = (int)((WF_STREAM_STAGE - 32) / rowb);
    const long long n = (long long)work[0];
    const bool producer = threadIdx.x >= 32;
    const int ptid = threadIdx.x - 32;
    const unsigned char* src = (const unsigned char*)rows;
    for (long long w = blockIdx.x; w < n; w += gridDim.x) {
        const long long start = (long long)work[1 + 3 * w], end = (long long)work[2 + 3 * w];
        const long long seg = (long long)work[3 + 3 * w];
        const long long tiles = (end - start + tile_rows - 1) / tile_rows;
        // tile t: lanes start + t * tile_rows .., as the 16-byte-aligned span
        // of their bytes, into stage t % WF_STREAM_STAGES; every thread commits
        // a group (empty past the last tile), so the waits count alike
        auto issue = [&](long long t) {
            if (producer && t < tiles) {
                const long long r0 = start + t * tile_rows;
                const long long r1 = r0 + tile_rows < end ? r0 + tile_rows : end;
                const long long lo = (r0 * rowb) & ~15LL, hi = (r1 * rowb + 15) & ~15LL;
                unsigned char* dst = wf_ring + (t % WF_STREAM_STAGES) * WF_STREAM_STAGE;
                for (long long b = lo + 16LL * ptid; b < hi; b += 16LL * 32 * WF_STREAM_PRODUCERS)
                    wf_cp_async16(dst + (b - lo), src + b);
            }
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        };
        for (int t = 0; t < WF_STREAM_STAGES - 1; ++t) issue(t);
        asm volatile("cp.async.wait_group %0;\n" :: "n"(WF_STREAM_STAGES - 2) : "memory");
        __syncthreads();
        T acc = T(0.0f);
        for (long long t = 0; t < tiles; ++t) {
            issue(t + WF_STREAM_STAGES - 1);
            if (threadIdx.x == 0) {
                const long long r0 = start + t * tile_rows;
                const int nr = (int)((r0 + tile_rows < end ? r0 + tile_rows : end) - r0);
                const unsigned char* st = wf_ring + (t % WF_STREAM_STAGES) * WF_STREAM_STAGE +
                                          (r0 * rowb - ((r0 * rowb) & ~15LL));
                acc = wf_stream_add(acc, (const T*)st, nr);
            }
            asm volatile("cp.async.wait_group %0;\n" :: "n"(WF_STREAM_STAGES - 2) : "memory");
            __syncthreads();
        }
        if (threadIdx.x == 0) out[seg] = acc;
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();                                     // the ring is free for the next run
    }
}

template <typename T>
static cudaError_t wf_fold_ordered_launch(const void* rows, const int* sseg,
                                          const long long* starts, void* out,
                                          unsigned long long* work, long long C, int S, int D,
                                          cudaStream_t st) {
    if (starts) {
        const long long cells = (long long)S * D;
        wf_fold_segments<T><<<(unsigned)((cells + WF_RUN_THREADS - 1) / WF_RUN_THREADS),
                              WF_RUN_THREADS, 0, st>>>((const T*)rows, starts, (T*)out, work,
                                                       S, D);
    } else {
        // the walkers' grid: as many blocks as stay resident at once (the
        // occupancy query runs once a dtype), at most one a lane's worth
        static std::atomic<int> resident;
        int per_sm = resident.load();
        if (!per_sm) {
            cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, (const void*)wf_fold_runs<T>, WF_RUN_THREADS, 0);
            if (q != cudaSuccess) return q;
            per_sm = per_sm < 1 ? 1 : per_sm;
            resident.store(per_sm);
        }
        const long long lanes = (C + WF_RUN_THREADS - 1) / WF_RUN_THREADS;
        const long long cap = (long long)WF_SMS * per_sm;
        wf_fold_runs<T><<<(unsigned)(lanes < cap ? lanes : cap), WF_RUN_THREADS, 0, st>>>(
            (const T*)rows, sseg, (T*)out, work, C, S);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || D != 1 || C < WF_RUN_LONG) return e;
    const long long most = C / WF_RUN_LONG;                  // long runs at most
    const unsigned grid = (unsigned)(most < 4 * WF_SMS ? most : 4 * WF_SMS);
    wf_fold_stream<T><<<grid, WF_STREAM_THREADS, WF_STREAM_STAGES * WF_STREAM_STAGE, st>>>(
        (const T*)rows, (T*)out, work);
    return cudaGetLastError();
}

// The fold of C sorted lanes into [S, D]. rows: [C, D] values ordered by
// segment (stable), readable 16 bytes past the end; sorted_seg: int32 [C]
// keys, S for a dropped lane; starts: int64 [S + 1], segment s owning lanes
// starts[s] .. starts[s + 1] - 1 (the segments regime), or null (the runs
// regime, D = 1 only); out: [S, D]; work: uint64 [1 + 3 * (C / WF_RUN_LONG
// + 1)] scratch (the long-run list, D = 1 only). dtype_code: 0 float32, 1
// float64, 2 float16, 3 bfloat16. At D = 1 a memset of the list's length
// (and of out, in the runs regime) and two kernels, at D > 1 one kernel;
// all on the stream, nothing read back.
WF_EXPORT int wf_segment_fold_ordered(const void* rows, const int* sorted_seg,
                                      const long long* starts, void* out,
                                      unsigned long long* work, long long C, int S, int D,
                                      int dtype_code, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaGetLastError();   // an earlier runtime call's error is not this launch's
    if (C < 0 || S < 0 || D < 0 || dtype_code < 0 || dtype_code > 3 || (!starts && D != 1))
        return (int)cudaErrorInvalidValue;
    const size_t elem = dtype_code == 0 ? 4 : dtype_code == 1 ? 8 : 2;
    cudaError_t e = D == 1 ? cudaMemsetAsync(work, 0, sizeof(unsigned long long), st)
                           : cudaSuccess;
    if (e == cudaSuccess && (!starts || C == 0))
        e = cudaMemsetAsync(out, 0, (size_t)S * D * elem, st);
    if (e != cudaSuccess || C == 0 || S == 0 || D == 0) return (int)e;
    const void* r = rows;
    switch (dtype_code) {
        case 0: e = wf_fold_ordered_launch<float>(r, sorted_seg, starts, out, work, C, S, D, st);
                break;
        case 1: e = wf_fold_ordered_launch<double>(r, sorted_seg, starts, out, work, C, S, D, st);
                break;
        case 2: e = wf_fold_ordered_launch<__half>(r, sorted_seg, starts, out, work, C, S, D, st);
                break;
        default:
            e = wf_fold_ordered_launch<__nv_bfloat16>(r, sorted_seg, starts, out, work, C, S, D,
                                                      st);
    }
    return (int)e;
}
