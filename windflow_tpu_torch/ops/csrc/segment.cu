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
