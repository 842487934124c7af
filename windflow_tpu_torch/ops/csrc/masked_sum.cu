// K6 — per-row masked sum: out[w] = sum over l of (mask[w, l] ? vals[w, l] : 0)
// for vals [W, L] (row-major) and a bool mask [W, L], in jnp.sum's dtype.
//
// Replaces windflow_tpu/ops/pallas_kernels.py::_pallas_masked_sum, the
// aggregation of Win_Seq's non-incremental sum windows (Iterable.sum under the
// window vmap: one row per fired window). The TPU kernel tiled 256 rows per
// grid step and wrote its [W] result through an [8, W] buffer to satisfy
// Mosaic's layouts; it took W % 256 == 0 and L % 128 == 0 only. None of that
// carries over: here any W >= 1 and L >= 1 is served, and the output is [W].
//
// Dtypes (input -> accumulator -> output), jnp.sum's with 32-bit defaults:
// float32 -> float -> float32; bool, int8, int16 and int32 -> uint32 -> int32
// (the narrow integers read as stored and widened in registers); uint8, uint16
// and uint32 -> uint32 -> uint32; float16 and bfloat16 -> float -> their own
// dtype (one rounding at the end); float64 -> double -> float64.
//
// Bound on the H100: bytes. Each element is read once (its value and its
// 1-byte flag) and each row's result written once, over 3.35 TB/s; the adds
// are W * L operations, far below the memory time. Where the whole call
// moves a few hundred kilobytes (YSB-WMR's [10700, 4] rows, the chaos sweep's
// CB 12 windows), the launch floor (about 1 us) and one memory round trip
// bound it instead, and the design keeps the call to that one launch: the
// wrapper allocates the output with torch.empty (no fill), every row is
// written here (0 for a row with no live flag), and bool, int8 and int16 are
// read as stored (no cast).
//
// Design: every load of values or flags is a 16-byte load of an aligned line
// (4 float32 or int32 values, 8 of a 2-byte dtype, 16 bytes of a 1-byte dtype
// or of flags, 2 float64), and the values' and the flags' alignments never
// meet in one load. The planner (ops/window_reduce.py::reduce_plan) picks one
// of three regimes, each one body here, and its geometry (threads, C,
// blocks):
// - narrow (L <= 64 and L * size <= 256 bytes; path B's [10700, 4], the
//   chaos sweep's CB 12): a block of 128 threads stages its 128 rows, one
//   contiguous span of each array, in shared memory: whole lines with
//   16-byte loads, WF_K6_UNROLL in flight a thread, the span's partial end
//   lines a byte at a time; one pad word after every 32 keeps the
//   row-strided reads free of bank conflicts. Each thread then sums its row
//   left to right and the [W] result is written coalesced. Bound: the
//   launch floor and one round trip.
// - warp (long rows, enough to fill the card; path A): a warp a row, blocks
//   of 4 warps. The row [s, t) of the flat arrays is cut into chunks of 512
//   elements from the multiple of 16 at or below s; in a chunk, lane j holds
//   16 consecutive values (sizeof(T) lines) and their 16 flags (one line) in
//   registers, sums them in order (masking the elements outside the row at
//   its two ends), then a shuffle tree with fixed partners (16, 8, 4, 2, 1)
//   gives the chunk's sum, which is added, in chunk order, to stream k % 32
//   (lane k % 32); the 32 streams meet in the same tree (a row of one chunk
//   is that chunk's sum). Bound: bytes; many rows in flight a SM hide each
//   warp's one round trip a chunk.
// - split (few long rows, two chunks or more: [1024, 1024], [64, 2^16]): C
//   warps of one block share a row (C = 2, 4, 8 or 16, at least 8 warps a
//   block); warp q takes chunks q, q + C, ..., so it holds the streams s
//   with s % C == q, and the streams meet in shared memory in the same
//   tree. No atomics. Bound: bytes, with W * C warps to spread them.
// The order of every add depends on L, the dtype and the row's offset to the
// multiples of 16 alone, never on W, C or the blocks, so a row gives the same
// bits in every call (rows 0-6 alone as in the whole call) and on every
// launch. Both bases are 16-byte aligned (the wrapper clones a view that is
// not), so every line of the long rows is a whole aligned line and the
// narrow spans peel only at their ends. Integer sums wrap modulo 2^32 (done
// in uint32, where overflow is defined), as XLA's integer sum does. Float sums round
// after every add, in the order above; it differs from XLA's and torch's, so
// float results agree with them within rounding, and exactly where every
// partial sum is exact.
//
// The geometry and the thresholds come from chip_smoke.py's k6_split (the
// probe wf_k6_geom in benchmarks/csrc/split_probes.cu: every regime at 64 to
// 512 threads, the long rows' lane-contiguous and coalesced layouts with 1 to
// 8 chunks in flight, C = 2 to 16). The planner mirrors the constants below.
#include "common.cuh"
#include <cuda_bf16.h>
#include <cuda_fp16.h>

constexpr int WF_K6_NARROW_LEN = 64;      // a thread sums a row of up to 64 values
constexpr int WF_K6_NARROW_BYTES = 256;   // and 256 value bytes alone
constexpr int WF_K6_UNROLL = 8;           // 16-byte loads in flight a thread (narrow)
constexpr int WF_K6_SMEM_MAX = 48 * 1024; // no opt-in: the default a block may take

// WfSum<T>: the accumulator of input dtype T, how a value enters it (lift),
// and the output dtype it leaves as (out)
template <typename T, typename A, typename O> struct WfSumBase {
    typedef A acc_t;
    typedef O out_t;
    static __device__ __forceinline__ A add(A a, A b) { return a + b; }
};
template <typename T> struct WfSum;
template <> struct WfSum<float> : WfSumBase<float, float, float> {
    static __device__ __forceinline__ float lift(float v) { return v; }
    static __device__ __forceinline__ float out(float a) { return a; }
};
template <> struct WfSum<int> : WfSumBase<int, unsigned int, int> {
    static __device__ __forceinline__ unsigned int lift(int v) { return (unsigned int)v; }
    static __device__ __forceinline__ int out(unsigned int a) { return (int)a; }
};
template <> struct WfSum<bool> : WfSumBase<bool, unsigned int, int> {
    static __device__ __forceinline__ unsigned int lift(bool v) { return v ? 1u : 0u; }
    static __device__ __forceinline__ int out(unsigned int a) { return (int)a; }
};
template <> struct WfSum<signed char> : WfSumBase<signed char, unsigned int, int> {
    static __device__ __forceinline__ unsigned int lift(signed char v) {
        return (unsigned int)(int)v;
    }
    static __device__ __forceinline__ int out(unsigned int a) { return (int)a; }
};
template <> struct WfSum<short> : WfSumBase<short, unsigned int, int> {
    static __device__ __forceinline__ unsigned int lift(short v) { return (unsigned int)(int)v; }
    static __device__ __forceinline__ int out(unsigned int a) { return (int)a; }
};
template <> struct WfSum<unsigned char> : WfSumBase<unsigned char, unsigned int, unsigned int> {
    static __device__ __forceinline__ unsigned int lift(unsigned char v) { return v; }
    static __device__ __forceinline__ unsigned int out(unsigned int a) { return a; }
};
template <> struct WfSum<unsigned short> : WfSumBase<unsigned short, unsigned int, unsigned int> {
    static __device__ __forceinline__ unsigned int lift(unsigned short v) { return v; }
    static __device__ __forceinline__ unsigned int out(unsigned int a) { return a; }
};
template <> struct WfSum<unsigned int> : WfSumBase<unsigned int, unsigned int, unsigned int> {
    static __device__ __forceinline__ unsigned int lift(unsigned int v) { return v; }
    static __device__ __forceinline__ unsigned int out(unsigned int a) { return a; }
};
template <> struct WfSum<__half> : WfSumBase<__half, float, __half> {
    static __device__ __forceinline__ float lift(__half v) { return __half2float(v); }
    static __device__ __forceinline__ __half out(float a) { return __float2half_rn(a); }
};
template <> struct WfSum<__nv_bfloat16> : WfSumBase<__nv_bfloat16, float, __nv_bfloat16> {
    static __device__ __forceinline__ float lift(__nv_bfloat16 v) { return __bfloat162float(v); }
    static __device__ __forceinline__ __nv_bfloat16 out(float a) { return __float2bfloat16_rn(a); }
};
template <> struct WfSum<double> : WfSumBase<double, double, double> {
    static __device__ __forceinline__ double lift(double v) { return v; }
    static __device__ __forceinline__ double out(double a) { return a; }
};

// Staged images: image byte i (i = address - the span's first 16-byte line)
// lives at shared byte wf_pad(i), one pad word after every 32 words.
__host__ __device__ __forceinline__ unsigned wf_pad(unsigned i) { return i + ((i >> 7) << 2); }

// shared bytes of an image of a span of n bytes (16-byte multiple)
static inline unsigned wf_image_bytes(long long n) {
    const long long m = n + 16;                  // the head line's offset
    return (unsigned)((m + 4 * ((m + 127) / 128) + 15) & ~15ll);
}

// Stage the spans [vs, vs + vn) and [ms, ms + mn) into the images vimg and
// mimg, thread tid of nth: their whole 16-byte lines with 16-byte loads, U a
// thread in flight at a time over both spans; the partial lines at their ends
// a byte a thread.
template <int U>
__device__ __forceinline__ void wf_stage(unsigned char* vimg, const unsigned char* vs, long long vn,
                                         unsigned char* mimg, const unsigned char* ms, long long mn,
                                         int tid, int nth) {
    const uintptr_t va = (uintptr_t)vs, ma = (uintptr_t)ms;
    uintptr_t vb0 = (va + 15) & ~(uintptr_t)15, vb1 = (va + vn) & ~(uintptr_t)15;
    uintptr_t mb0 = (ma + 15) & ~(uintptr_t)15, mb1 = (ma + mn) & ~(uintptr_t)15;
    if (vb0 > vb1) vb0 = vb1 = va + vn;         // no whole line: all head
    if (mb0 > mb1) mb0 = mb1 = ma + mn;
    const int vh = (int)(vb0 - va), vt = (int)(va + vn - vb1);
    const int mh = (int)(mb0 - ma), mt = (int)(ma + mn - mb1);
    const unsigned vo = (unsigned)(va & 15), mo = (unsigned)(ma & 15);
    for (int i = tid; i < vh + vt + mh + mt; i += nth) {
        const unsigned char* vtail = (const unsigned char*)vb1;
        const unsigned char* mtail = (const unsigned char*)mb1;
        if (i < vh) {
            vimg[wf_pad(vo + i)] = vs[i];
        } else if (i < vh + vt) {
            const int k = i - vh;
            vimg[wf_pad((unsigned)(vb1 - va) + vo + k)] = vtail[k];
        } else if (i < vh + vt + mh) {
            const int k = i - vh - vt;
            mimg[wf_pad(mo + k)] = ms[k];
        } else {
            const int k = i - vh - vt - mh;
            mimg[wf_pad((unsigned)(mb1 - ma) + mo + k)] = mtail[k];
        }
    }
    const uint4* vl = (const uint4*)vb0;
    const uint4* ml = (const uint4*)mb0;
    const int nv = (int)((vb1 - vb0) >> 4), nl = nv + (int)((mb1 - mb0) >> 4);
    const unsigned vbo = (unsigned)(vb0 - va) + vo, mbo = (unsigned)(mb0 - ma) + mo;
    for (int c = tid; c < nl; c += nth * U) {
        uint4 x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int cc = c + u * nth;
            if (cc < nl) x[u] = cc < nv ? __ldg(vl + cc) : __ldg(ml + (cc - nv));
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int cc = c + u * nth;
            if (cc < nl) {
                unsigned* w = cc < nv ? (unsigned*)(vimg + wf_pad(vbo + 16u * cc))
                                      : (unsigned*)(mimg + wf_pad(mbo + 16u * (cc - nv)));
                w[0] = x[u].x; w[1] = x[u].y; w[2] = x[u].z; w[3] = x[u].w;
            }
        }
    }
}

// element of T at image byte i (a multiple of sizeof(T)); an 8-byte element
// may straddle no pad word but may sit off 8-byte alignment, so it is read
// as two words
template <typename T>
__device__ __forceinline__ T wf_lds(const unsigned char* img, unsigned i) {
    if constexpr (sizeof(T) == 8) {
        const unsigned* w = (const unsigned*)(img + wf_pad(i));
        return __hiloint2double((int)w[1], (int)w[0]);
    } else {
        return *(const T*)(img + wf_pad(i));
    }
}

template <typename A>
__device__ __forceinline__ A wf_tree(A a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a = a + __shfl_xor_sync(0xffffffffu, a, off);
    return a;
}

// narrow rows: blockDim.x rows a block, one a thread, left to right
template <typename T>
__global__ void __launch_bounds__(512)
wf_k6_narrow(const T* __restrict__ vals, const unsigned char* __restrict__ mask,
             typename WfSum<T>::out_t* __restrict__ out, long long W, int L, unsigned vbytes) {
    typedef WfSum<T> S;
    typedef typename S::acc_t acc_t;
    extern __shared__ __align__(16) unsigned char wf_k6_smem[];
    unsigned char* vimg = wf_k6_smem;
    unsigned char* mimg = wf_k6_smem + vbytes;
    const long long r0 = (long long)blockIdx.x * blockDim.x;
    const long long rem = W - r0;
    const int nr = rem < (long long)blockDim.x ? (int)rem : (int)blockDim.x;
    const unsigned char* vs = (const unsigned char*)(vals + r0 * L);
    const unsigned char* ms = mask + r0 * L;
    wf_stage<WF_K6_UNROLL>(vimg, vs, (long long)nr * L * sizeof(T), mimg, ms, (long long)nr * L,
                           threadIdx.x, blockDim.x);
    __syncthreads();
    const int t = threadIdx.x;
    if (t >= nr) return;
    const unsigned vo = (unsigned)((uintptr_t)vs & 15) + (unsigned)t * L * sizeof(T);
    const unsigned mo = (unsigned)((uintptr_t)ms & 15) + (unsigned)t * L;
    acc_t acc = acc_t(0);
    for (int l = 0; l < L; ++l)
        acc = S::add(acc, mimg[wf_pad(mo + l)] ? S::lift(wf_lds<T>(vimg, vo + l * sizeof(T)))
                                               : acc_t(0));
    out[r0 + t] = S::out(acc);
}

// Long rows. A row [s, t) of the flat arrays (s = w L, t = s + L) is cut into
// chunks of 512 elements from c0, the multiple of 16 at or below s: chunk k
// is the part of [c0 + 512 k, c0 + 512 (k + 1)) inside [s, t). In a chunk,
// lane j takes its 16 values from c0 + 512 k + 16 j on (sizeof(T) 16-byte
// lines) and their 16 flags (one 16-byte line).
struct WfRow {
    long long s, t, c0;
    int chunks;
};

__device__ __forceinline__ WfRow wf_row(long long w, int L) {
    WfRow r;
    r.s = w * L;
    r.t = r.s + L;
    r.c0 = r.s & ~15ll;
    r.chunks = (int)((r.t - r.c0 + 511) >> 9);
    return r;
}

// lane's part of the chunk at c, its elements in order (those outside the
// row count 0): its lines read whole (both bases are 16-byte aligned; lines
// holding no element of the row are not read).
template <typename T>
__device__ __forceinline__ typename WfSum<T>::acc_t
wf_k6_lane(const T* vals, const unsigned char* mask, const WfRow& r, long long c, int lane) {
    typedef WfSum<T> S;
    typedef typename S::acc_t acc_t;
    constexpr int V = (int)sizeof(T), E = 16 / V;
    const long long e0 = c + 16 * lane;
    acc_t p = acc_t(0);
    if (e0 + 16 <= r.s || e0 >= r.t) return p;
    uint4 v[V];
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(mask + e0));
    const uint4* vl = reinterpret_cast<const uint4*>(vals + e0);
#pragma unroll
    for (int m = 0; m < V; ++m)
        if (e0 + (m + 1) * E > r.s && e0 + m * E < r.t) v[m] = __ldg(vl + m);
    const T* x = reinterpret_cast<const T*>(v);
    const unsigned char* g = reinterpret_cast<const unsigned char*>(&f);
    if (e0 >= r.s && e0 + 16 <= r.t) {
#pragma unroll
        for (int i = 0; i < 16; ++i) p = S::add(p, g[i] ? S::lift(x[i]) : acc_t(0));
    } else {
        const int lo = r.s > e0 ? (int)(r.s - e0) : 0;
        const int hi = r.t < e0 + 16 ? (int)(r.t - e0) : 16;
#pragma unroll
        for (int i = 0; i < 16; ++i)
            p = S::add(p, (i >= lo && i < hi && g[i]) ? S::lift(x[i]) : acc_t(0));
    }
    return p;
}

// chunks q, q + C, q + 2C, ... of row r, each chunk's sum (the fixed tree
// over its lanes) added to its stream: chunk k to stream k % 32, held by
// lane k % 32
template <typename T>
__device__ __forceinline__ typename WfSum<T>::acc_t
wf_k6_streams(const T* vals, const unsigned char* mask, const WfRow& r, int q, int C, int lane) {
    typedef WfSum<T> S;
    typename S::acc_t stream = typename S::acc_t(0);
    for (int k = q; k < r.chunks; k += C) {
        const typename S::acc_t p = wf_tree(wf_k6_lane<T>(vals, mask, r, r.c0 + 512ll * k, lane));
        if (lane == (k & 31)) stream = S::add(stream, p);
    }
    return stream;
}

// long rows, a warp a row (blockDim.x / 32 rows a block); a row of one chunk
// is that chunk's sum
template <typename T>
__global__ void __launch_bounds__(512)
wf_k6_warp(const T* __restrict__ vals, const unsigned char* __restrict__ mask,
           typename WfSum<T>::out_t* __restrict__ out, long long W, int L) {
    typedef WfSum<T> S;
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= W) return;               // whole warps; no block barrier here
    const WfRow r = wf_row(row, L);
    const typename S::acc_t s = r.chunks == 1
        ? wf_tree(wf_k6_lane<T>(vals, mask, r, r.c0, lane))
        : wf_tree(wf_k6_streams<T>(vals, mask, r, 0, 1, lane));
    if (lane == 0) out[row] = S::out(s);
}

// few long rows (two chunks or more each): C warps a row, (blockDim.x / 32) /
// C rows a block; the streams meet in shared memory
template <typename T>
__global__ void __launch_bounds__(512)
wf_k6_split(const T* __restrict__ vals, const unsigned char* __restrict__ mask,
            typename WfSum<T>::out_t* __restrict__ out, long long W, int L, int C) {
    typedef WfSum<T> S;
    typedef typename S::acc_t acc_t;
    __shared__ acc_t streams[16][32];   // at most 16 rows a block
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const int rl = warp / C, q = warp - rl * C;
    const long long row = (long long)blockIdx.x * (warps / C) + rl;
    if (row < W) {
        const acc_t s = wf_k6_streams<T>(vals, mask, wf_row(row, L), q, C, lane);
        if (lane % C == q) streams[rl][lane] = s;
    }
    __syncthreads();
    if (row < W && q == 0) {
        const acc_t s = wf_tree(streams[rl][lane]);
        if (lane == 0) out[row] = S::out(s);
    }
}

template <typename T>
static int wf_k6_launch(const void* vals_, const unsigned char* mask, void* out_, long long W,
                        int L, int regime, int threads, int C, long long blocks, cudaStream_t s) {
    typedef typename WfSum<T>::out_t O;
    const T* vals = static_cast<const T*>(vals_);
    O* out = static_cast<O*>(out_);
    const int warps = threads / 32;
    if ((uintptr_t)vals % 16 || (uintptr_t)mask % 16 || threads < 32 || threads > 512 ||
        threads % 32 || blocks < 1 || blocks > 0x7fffffffll)
        return (int)cudaErrorInvalidValue;
    if (regime == 0) {
        const unsigned vbytes = wf_image_bytes((long long)threads * L * sizeof(T));
        const size_t smem = vbytes + wf_image_bytes((long long)threads * L);
        if (L > WF_K6_NARROW_LEN || (long long)L * sizeof(T) > WF_K6_NARROW_BYTES ||
            blocks * threads < W ||
            smem > WF_K6_SMEM_MAX)
            return (int)cudaErrorInvalidValue;
        wf_k6_narrow<T><<<(unsigned)blocks, threads, smem, s>>>(vals, mask, out, W, L, vbytes);
    } else if (regime == 1) {
        if (blocks * warps < W) return (int)cudaErrorInvalidValue;
        wf_k6_warp<T><<<(unsigned)blocks, threads, 0, s>>>(vals, mask, out, W, L);
    } else if (regime == 2) {
        if (C < 2 || C > 16 || 16 % C || warps % C || warps / C > 16 || blocks * (warps / C) < W ||
            (long long)L <= 512)
            return (int)cudaErrorInvalidValue;
        wf_k6_split<T><<<(unsigned)blocks, threads, 0, s>>>(vals, mask, out, W, L, C);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// vals: contiguous [W, L]; mask: contiguous bool [W, L], both bases 16-byte
// aligned; out: [W] of the
// output dtype above. dtype_code: 0 float32, 1 int32, 2 uint8, 3 uint16,
// 4 float16, 5 bfloat16, 6 float64, 7 uint32, 8 bool, 9 int8, 10 int16.
// regime 0 narrow, 1 warp, 2 split; threads a block; C warps a row (split);
// blocks: reduce_plan's. W >= 1, L >= 1.
WF_EXPORT int wf_masked_window_reduce(const void* vals, int dtype_code, const unsigned char* mask,
                                      void* out, long long W, int L, int regime, int threads,
                                      int C, long long blocks, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
#define WF_K6(T) wf_k6_launch<T>(vals, mask, out, W, L, regime, threads, C, blocks, s)
    switch (dtype_code) {
        case 0: return WF_K6(float);
        case 1: return WF_K6(int);
        case 2: return WF_K6(unsigned char);
        case 3: return WF_K6(unsigned short);
        case 4: return WF_K6(__half);
        case 5: return WF_K6(__nv_bfloat16);
        case 6: return WF_K6(double);
        case 7: return WF_K6(unsigned int);
        case 8: return WF_K6(bool);
        case 9: return WF_K6(signed char);
        case 10: return WF_K6(short);
        default: return (int)cudaErrorInvalidValue;
    }
#undef WF_K6
}
