// Measurement probes for chip_smoke.py's split of K1's, K2's and K3's time,
// for the launch floor (an empty kernel), for the host link's read rate,
// the bound of the cold-tier reads (ops/csrc/cold_probe.cu), for
// cold_scatter's geometries, and for K6's (wf_k6_geom). No TPU kernel,
// and no path of the port launches them: chip_smoke.py builds this file on
// its own and loads it with ctypes.
// It includes nothing of ops/csrc, so the same file also splits an older
// tree's kernels.
//
// Both probes map lanes to threads as K1 and K3 do: a persistent grid of
// CTAs of 256 threads, eight a SM, each CTA taking whole tiles of 1024
// contiguous lanes, each thread four neighbouring lanes with one 16-byte
// load per int32 array and one 4-byte load of the flags.
#include <cuda_runtime.h>
#include <mutex>
#include <stdint.h>

#define WF_EXPORT extern "C" __attribute__((visibility("default")))

constexpr int WF_SPLIT_THREADS = 256;
constexpr int WF_SPLIT_PER_SM = 8;

static int wf_split_grid(long long quads, int* grid) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long tiles = (quads + WF_SPLIT_THREADS - 1) / WF_SPLIT_THREADS;
    long long cap = (long long)sms * WF_SPLIT_PER_SM;
    *grid = (int)(tiles < 1 ? 1 : tiles < cap ? tiles : cap);
    return (int)e;
}

// Read floor: reads two int32 arrays and one byte array, writes nothing
// unless the xor of every word is a value no input gives in practice. Its
// time is the least a kernel reading the same 9 bytes a lane can take.
__global__ void __launch_bounds__(WF_SPLIT_THREADS, WF_SPLIT_PER_SM)
wf_read_floor_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                     const unsigned* __restrict__ c, int* __restrict__ sink,
                     long long quads) {
    unsigned acc = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < quads;
         i += stride) {
        const int4 x = __ldg(a + i), y = __ldg(b + i);
        acc ^= (unsigned)(x.x ^ x.y ^ x.z ^ x.w ^ y.x ^ y.y ^ y.z ^ y.w) ^ __ldg(c + i);
    }
    if (acc == 0x9e3779b9u) sink[0] = (int)acc;
}

// One global atomic a counted lane: out[seg[i]] += values[i] (1 when values
// is null) for every valid lane with seg[i] in [0, S). What K1 and K3 do on
// a tile that goes global, on every tile.
__global__ void __launch_bounds__(WF_SPLIT_THREADS, WF_SPLIT_PER_SM)
wf_global_fold_kernel(const int4* __restrict__ values, const int4* __restrict__ seg,
                      const uchar4* __restrict__ valid, int* __restrict__ out,
                      long long quads, int S) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < quads;
         i += stride) {
        const int4 s = __ldg(seg + i);
        const uchar4 v = valid[i];
        const int4 x = values ? __ldg(values + i) : make_int4(1, 1, 1, 1);
        if (v.x && s.x >= 0 && s.x < S) atomicAdd(out + s.x, x.x);
        if (v.y && s.y >= 0 && s.y < S) atomicAdd(out + s.y, x.y);
        if (v.z && s.z >= 0 && s.z < S) atomicAdd(out + s.z, x.z);
        if (v.w && s.w >= 0 && s.w < S) atomicAdd(out + s.w, x.w);
    }
}

// a, b: int32 [n]; c: bytes [n]; n a multiple of 4, pointers 16-byte aligned.
WF_EXPORT int wf_read_floor(const int* a, const int* b, const unsigned char* c,
                            int* sink, long long n, void* stream) {
    if (n % 4) return (int)cudaErrorInvalidValue;
    int grid = 0;
    int e = wf_split_grid(n / 4, &grid);
    if (e) return e;
    wf_read_floor_kernel<<<grid, WF_SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)a, (const int4*)b, (const unsigned*)c, sink, n / 4);
    return (int)cudaGetLastError();
}

// values: int32 [n] or null; seg: int32 [n]; valid: bytes [n]; out: int32
// [S], zeroed here by a memset first. n a multiple of 4, pointers 16-byte
// aligned.
WF_EXPORT int wf_global_fold(const int* values, const int* seg, const unsigned char* valid,
                             int* out, long long n, int S, void* stream) {
    if (n % 4 || S < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t r = cudaMemsetAsync(out, 0, (size_t)S * 4, st);
    if (r != cudaSuccess) return (int)r;
    int grid = 0;
    int e = wf_split_grid(n / 4, &grid);
    if (e) return e;
    wf_global_fold_kernel<<<grid, WF_SPLIT_THREADS, 0, st>>>(
        (const int4*)values, (const int4*)seg, (const uchar4*)valid, out, n / 4, S);
    return (int)cudaGetLastError();
}

// The host link's rate of small reads: n reads of 16 bytes at system scope
// (ld.relaxed.sys, as the cold-tier kernels read mapped records), `per`
// reads in flight a thread (1 to 4), a grid of 256-thread blocks covering
// n / per threads, from `lines` lines of 128 bytes of a mapped host buffer.
// seq 0: each read from a line drawn by a hash of the read's number (the
// cold reads' pattern); seq 1: read r at byte 16 r (mod the buffer), a
// block's u-th reads the next 256 after its (u - 1)-th, so each warp load
// reads four whole consecutive lines (cold_scatter's pattern). Writes
// nothing unless the xor of every word is a value no input gives in practice.
__global__ void __launch_bounds__(WF_SPLIT_THREADS)
wf_link_reads_kernel(const unsigned char* buf, long long lines, long long n, int per, int seq,
                     int* __restrict__ sink) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long i0 = t * per;
    const long long b0 = (long long)blockIdx.x * blockDim.x * per + threadIdx.x;
    unsigned acc = 0;
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        if (u >= per) continue;
        const long long r = seq ? b0 + (long long)u * blockDim.x : i0 + u;
        if (r >= n) continue;
        const unsigned long long h = (unsigned long long)(r + 1) * 0x9E3779B97F4A7C15ull;
        const unsigned char* p =
            seq ? buf + (r % (lines * 8)) * 16
                : buf + (long long)((h >> 24) % (unsigned long long)lines) * 128
                      + ((h >> 8) & 7) * 16;
        asm volatile("ld.relaxed.sys.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(v[u].x), "=r"(v[u].y), "=r"(v[u].z), "=r"(v[u].w) : "l"(p));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const long long r = seq ? b0 + (long long)u * blockDim.x : i0 + u;
        if (u < per && r < n) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
    }
    if (acc == 0x9e3779b9u) sink[0] = (int)acc;
}

// buf: device address of a mapped buffer of lines * 128 bytes.
WF_EXPORT int wf_link_reads(const void* buf, long long lines, long long n, int per, int seq,
                            int* sink, void* stream) {
    if (lines < 1 || n < 1 || per < 1 || per > 4 || (seq != 0 && seq != 1))
        return (int)cudaErrorInvalidValue;
    const long long threads = (n + per - 1) / per;
    const long long blocks = (threads + WF_SPLIT_THREADS - 1) / WF_SPLIT_THREADS;
    wf_link_reads_kernel<<<(unsigned)blocks, WF_SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)buf, lines, n, per, seq, sink);
    return (int)cudaGetLastError();
}

// cold_scatter's geometries (ops/csrc/cold_probe.cu, wf_cold_scatter, which
// runs e = 2, 256 threads, 2 blocks an SM): the same staging (n 16-byte
// pairs {key, head row}, then from the next 128-byte line n int32 slot
// numbers) written into slots[slot] = {key, head row} with e entries a
// thread (1, 2 or 4), `threads` a block (a multiple of 32, at most 256) and
// at most per_sm blocks an SM. A warp takes 32e consecutive entries: load j
// reads the pairs of entries 32j + lane; where e = 4 the slot numbers come
// in as one 16-byte load of four a thread, handed to the pairs' threads by
// shuffles, else a 4-byte load a pair; a ragged last chunk reads scalar.
__device__ __forceinline__ uint4 wf_split_ld16_sys(const void* p) {
    uint4 v;
    asm volatile("ld.relaxed.sys.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

__device__ __forceinline__ int wf_split_ld4_sys(const int* p) {
    int v;
    asm volatile("ld.relaxed.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ longlong2 wf_split_pair(uint4 v) {
    return make_longlong2((long long)(((unsigned long long)v.y << 32) | v.x),
                          (long long)(((unsigned long long)v.w << 32) | v.z));
}

template <int E>
__global__ void __launch_bounds__(WF_SPLIT_THREADS)
wf_scatter_geom_kernel(const unsigned char* staging, long long n, longlong2* __restrict__ slots) {
    const uint4* pairs = (const uint4*)staging;
    const int* at = (const int*)(staging + ((16 * n + 127) & ~127ll));
    const int lane = threadIdx.x & 31;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    const long long chunks = (n + 32 * E - 1) / (32 * E);
    for (long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < chunks;
         c += warps) {
        const long long base = c * 32 * E;
        uint4 v[E];
        int s[E];
        if (base + 32 * E <= n) {
#pragma unroll
            for (int j = 0; j < E; ++j) v[j] = wf_split_ld16_sys(pairs + base + 32 * j + lane);
            if (E == 4) {
                // entry base + 32 j + lane's number is word lane % 4 of lane 8 j + lane / 4
                const uint4 q = wf_split_ld16_sys(at + base + 4 * lane);
#pragma unroll
                for (int j = 0; j < E; ++j) {
                    const int src = 8 * j + (lane >> 2);
                    const unsigned x = __shfl_sync(0xffffffffu, q.x, src);
                    const unsigned y = __shfl_sync(0xffffffffu, q.y, src);
                    const unsigned z = __shfl_sync(0xffffffffu, q.z, src);
                    const unsigned w = __shfl_sync(0xffffffffu, q.w, src);
                    const int k = lane & 3;
                    s[j] = (int)(k == 0 ? x : k == 1 ? y : k == 2 ? z : w);
                }
            } else {
#pragma unroll
                for (int j = 0; j < E; ++j) s[j] = wf_split_ld4_sys(at + base + 32 * j + lane);
            }
#pragma unroll
            for (int j = 0; j < E; ++j) slots[s[j]] = wf_split_pair(v[j]);
        } else {
#pragma unroll
            for (int j = 0; j < E; ++j) {
                const long long i = base + 32 * j + lane;
                if (i < n) {
                    v[j] = wf_split_ld16_sys(pairs + i);
                    s[j] = wf_split_ld4_sys(at + i);
                }
            }
#pragma unroll
            for (int j = 0; j < E; ++j)
                if (base + 32 * j + lane < n) slots[s[j]] = wf_split_pair(v[j]);
        }
    }
}

// staging: device address of the mapped staging, 16-byte aligned.
WF_EXPORT int wf_scatter_geom(const void* staging, long long n, void* slots, int e,
                              int threads, int per_sm, void* stream) {
    if (n < 0 || ((uintptr_t)staging & 15) || (e != 1 && e != 2 && e != 4) || threads < 32 ||
        threads > WF_SPLIT_THREADS || threads % 32 || per_sm < 1)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    int dev = 0, sms = 0;
    cudaError_t r = cudaGetDevice(&dev);
    if (r == cudaSuccess) r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (r != cudaSuccess) return (int)r;
    const long long warps = (n + 32 * e - 1) / (32 * e);
    long long blocks = (warps * 32 + threads - 1) / threads;
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
    const unsigned char* st = (const unsigned char*)staging;
    cudaStream_t cs = (cudaStream_t)stream;
    longlong2* out = (longlong2*)slots;
    if (e == 4) wf_scatter_geom_kernel<4><<<(unsigned)blocks, threads, 0, cs>>>(st, n, out);
    else if (e == 2) wf_scatter_geom_kernel<2><<<(unsigned)blocks, threads, 0, cs>>>(st, n, out);
    else wf_scatter_geom_kernel<1><<<(unsigned)blocks, threads, 0, cs>>>(st, n, out);
    return (int)cudaGetLastError();
}

// Pinned host memory mapped into the card's address space for the link
// probe (*dev for the kernel), and its release.
WF_EXPORT int wf_probe_host_alloc(long long bytes, void** host, void** dev) {
    cudaError_t e = cudaHostAlloc(host, (size_t)bytes, cudaHostAllocMapped);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

WF_EXPORT int wf_probe_host_free(void* host) {
    return (int)cudaFreeHost(host);
}

// The launch floor: a kernel of one thread that does nothing.
__global__ void wf_empty_kernel() {}

WF_EXPORT int wf_launch_floor(void* stream) {
    wf_empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// K2's parts, on an int32 table of K rows and n lanes (out[i] = table[idx[i]],
// 0 outside [0, K)), in `blocks` blocks of 256 threads:
//   STAGE: each block copies the table into shared memory, then waits on a
//          barrier; without it, lanes read the table through L2 (__ldg);
//   LANES: 0 no lane (the staging alone), 1 a scalar 4-byte index load and
//          store a lane (K2's parent design), 2 16-byte vectors of four lanes,
//          two in flight a thread (its redesign; n a multiple of 4, pointers
//          16-byte aligned).
template <bool STAGE, int LANES>
__global__ void __launch_bounds__(WF_SPLIT_THREADS)
wf_k2_part_kernel(const int* __restrict__ table, int K, const int* __restrict__ idx,
                  int* __restrict__ out, long long n) {
    extern __shared__ __align__(16) int wf_k2_staged[];
    if constexpr (STAGE) {
        for (int j = threadIdx.x; j < K; j += blockDim.x) wf_k2_staged[j] = __ldg(table + j);
        __syncthreads();
    }
    auto get = [&](int j) -> int {
        if ((unsigned)j >= (unsigned)K) return 0;
        if constexpr (STAGE) return wf_k2_staged[j];
        else return __ldg(table + j);
    };
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if constexpr (LANES == 0) {
        if (get(threadIdx.x % K) == (int)0x9e3779b9) out[blockIdx.x] = 1;
    } else if constexpr (LANES == 1) {
        for (long long i = tid; i < n; i += stride) out[i] = get(__ldg(idx + i));
    } else {
        const long long nv = n / 4;
        const int4* idx4 = reinterpret_cast<const int4*>(idx);
        int4* out4 = reinterpret_cast<int4*>(out);
        for (long long v = tid; v < nv; v += 2 * stride) {
            const int4 a = __ldg(idx4 + v);
            const bool more = v + stride < nv;
            const int4 b = more ? __ldg(idx4 + v + stride) : a;
            out4[v] = make_int4(get(a.x), get(a.y), get(a.z), get(a.w));
            if (more) out4[v + stride] = make_int4(get(b.x), get(b.y), get(b.z), get(b.w));
        }
    }
}

WF_EXPORT int wf_k2_part(const int* table, int K, const int* idx, int* out, long long n,
                         int stage, int lanes, int blocks, void* stream) {
    if (K < 1 || K * 4 > 48 * 1024 || blocks < 1 || lanes < 0 || lanes > 2 ||
        (lanes == 2 && (n % 4 || (uintptr_t)idx % 16 || (uintptr_t)out % 16)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t smem = stage ? (size_t)K * 4 : 0;
#define WF_K2_PART(S, L) \
    wf_k2_part_kernel<S, L><<<blocks, WF_SPLIT_THREADS, smem, st>>>(table, K, idx, out, n)
    if (stage) {
        if (lanes == 0) WF_K2_PART(true, 0);
        else if (lanes == 1) WF_K2_PART(true, 1);
        else WF_K2_PART(true, 2);
    } else {
        if (lanes == 0) WF_K2_PART(false, 0);
        else if (lanes == 1) WF_K2_PART(false, 1);
        else WF_K2_PART(false, 2);
    }
#undef WF_K2_PART
    return (int)cudaGetLastError();
}

// K6's geometries (ops/csrc/masked_sum.cu's three regimes, copied with what
// the shipped kernel fixes as template parameters: U, the narrow regime's
// lines and the long rows' chunks in flight a thread, and LAYOUT, the long
// rows' lane-contiguous values (0, shipped at U = 1) or coalesced lines with
// the flags staged in shared memory (1)); the runtime geometry (regime,
// threads, C warps a row, blocks) as the C entry takes it. Integer values
// only (int32 and uint8 into uint32), whose wrapping sums are exact in any
// order, so every geometry is held bit for bit against the plain version.
__host__ __device__ __forceinline__ unsigned wf_k6p_pad(unsigned i) { return i + ((i >> 7) << 2); }

static inline unsigned wf_k6p_image_bytes(long long n) {
    const long long m = n + 16;
    return (unsigned)((m + 4 * ((m + 127) / 128) + 15) & ~15ll);
}

template <int U>
__device__ __forceinline__ void wf_k6p_stage(unsigned char* vimg, const unsigned char* vs,
                                             long long vn, unsigned char* mimg,
                                             const unsigned char* ms, long long mn, int tid,
                                             int nth) {
    const uintptr_t va = (uintptr_t)vs, ma = (uintptr_t)ms;
    uintptr_t vb0 = (va + 15) & ~(uintptr_t)15, vb1 = (va + vn) & ~(uintptr_t)15;
    uintptr_t mb0 = (ma + 15) & ~(uintptr_t)15, mb1 = (ma + mn) & ~(uintptr_t)15;
    if (vb0 > vb1) vb0 = vb1 = va + vn;
    if (mb0 > mb1) mb0 = mb1 = ma + mn;
    const int vh = (int)(vb0 - va), vt = (int)(va + vn - vb1);
    const int mh = (int)(mb0 - ma), mt = (int)(ma + mn - mb1);
    const unsigned vo = (unsigned)(va & 15), mo = (unsigned)(ma & 15);
    for (int i = tid; i < vh + vt + mh + mt; i += nth) {
        if (i < vh) vimg[wf_k6p_pad(vo + i)] = vs[i];
        else if (i < vh + vt) { const int k = i - vh; vimg[wf_k6p_pad((unsigned)(vb1 - va) + vo + k)] = ((const unsigned char*)vb1)[k]; }
        else if (i < vh + vt + mh) { const int k = i - vh - vt; mimg[wf_k6p_pad(mo + k)] = ms[k]; }
        else { const int k = i - vh - vt - mh; mimg[wf_k6p_pad((unsigned)(mb1 - ma) + mo + k)] = ((const unsigned char*)mb1)[k]; }
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
                unsigned* w = cc < nv ? (unsigned*)(vimg + wf_k6p_pad(vbo + 16u * cc))
                                      : (unsigned*)(mimg + wf_k6p_pad(mbo + 16u * (cc - nv)));
                w[0] = x[u].x; w[1] = x[u].y; w[2] = x[u].z; w[3] = x[u].w;
            }
        }
    }
}

__device__ __forceinline__ unsigned wf_k6p_tree(unsigned a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    return a;
}

template <typename T, int U>
__global__ void __launch_bounds__(512)
wf_k6p_narrow(const T* __restrict__ vals, const unsigned char* __restrict__ mask,
              unsigned* __restrict__ out, long long W, int L, unsigned vbytes) {
    extern __shared__ __align__(16) unsigned char wf_k6p_smem[];
    unsigned char* vimg = wf_k6p_smem;
    unsigned char* mimg = wf_k6p_smem + vbytes;
    const long long r0 = (long long)blockIdx.x * blockDim.x;
    const long long rem = W - r0;
    const int nr = rem < (long long)blockDim.x ? (int)rem : (int)blockDim.x;
    const unsigned char* vs = (const unsigned char*)(vals + r0 * L);
    const unsigned char* ms = mask + r0 * L;
    wf_k6p_stage<U>(vimg, vs, (long long)nr * L * sizeof(T), mimg, ms, (long long)nr * L,
                    threadIdx.x, blockDim.x);
    __syncthreads();
    const int t = threadIdx.x;
    if (t >= nr) return;
    const unsigned vo = (unsigned)((uintptr_t)vs & 15) + (unsigned)t * L * sizeof(T);
    const unsigned mo = (unsigned)((uintptr_t)ms & 15) + (unsigned)t * L;
    unsigned acc = 0;
    for (int l = 0; l < L; ++l)
        acc += mimg[wf_k6p_pad(mo + l)]
                   ? (unsigned)*(const T*)(vimg + wf_k6p_pad(vo + l * sizeof(T))) : 0u;
    out[r0 + t] = acc;
}

struct WfK6pRow {
    long long s, t, c0;
    int chunks;
};

__device__ __forceinline__ WfK6pRow wf_k6p_row(long long w, int L) {
    WfK6pRow r;
    r.s = w * L;
    r.t = r.s + L;
    r.c0 = r.s & ~15ll;
    r.chunks = (int)((r.t - r.c0 + 511) >> 9);
    return r;
}

// LAYOUT 1 (coalesced): lane j holds value lines j, 32 + j, ... of a chunk and
// reads their flags from the chunk's flag lines staged in shared memory;
// LAYOUT 0 (contiguous): lane j holds the chunk's values 16 j to 16 j + 15
// (sizeof(T) consecutive lines) and its own flag line
template <typename T, int U, int LAYOUT>
__device__ __forceinline__ unsigned wf_k6p_streams(const T* vals, const unsigned char* mask,
                                                   const WfK6pRow& r, int q, int C, int lane,
                                                   unsigned char* fl) {
    constexpr int V = (int)sizeof(T), E = 16 / V;
    unsigned stream = 0;
    for (int k0 = q; k0 < r.chunks; k0 += U * C) {
        uint4 v[U][V], f[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long c = r.c0 + 512ll * (k0 + u * C);
            if (k0 + u * C >= r.chunks) break;
            const long long fe = c + 16 * lane;
            if (fe + 16 > r.s && fe < r.t) f[u] = __ldg(reinterpret_cast<const uint4*>(mask + fe));
#pragma unroll
            for (int m = 0; m < V; ++m) {
                const long long e = LAYOUT ? c + E * (32 * m + lane) : fe + E * m;
                if (e + E > r.s && e < r.t) v[u][m] = __ldg(reinterpret_cast<const uint4*>(vals + e));
            }
        }
        if constexpr (LAYOUT == 1 && E < 16) {
            __syncwarp();
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (k0 + u * C < r.chunks) *reinterpret_cast<uint4*>(fl + 512 * u + 16 * lane) = f[u];
            __syncwarp();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int k = k0 + u * C;
            if (k >= r.chunks) break;
            const long long c = r.c0 + 512ll * k;
            const long long lane0 = c + 16 * lane;   // LAYOUT 0: this lane's values
            const bool inner = LAYOUT ? c >= r.s && c + 512 <= r.t
                                      : lane0 >= r.s && lane0 + 16 <= r.t;
            unsigned p = 0;
#pragma unroll
            for (int m = 0; m < V; ++m) {
                const int l = LAYOUT ? 32 * m + lane : V * lane + m;
                const long long e = c + E * l;
                const T* x = reinterpret_cast<const T*>(&v[u][m]);
                unsigned g = 0;
                if constexpr (E == 4) {
                    g = LAYOUT ? *reinterpret_cast<const unsigned*>(fl + 512 * u + 4 * l)
                               : (m == 0 ? f[u].x : m == 1 ? f[u].y : m == 2 ? f[u].z : f[u].w);
                }
                const unsigned char* g16 = reinterpret_cast<const unsigned char*>(&f[u]);
                if (inner) {
#pragma unroll
                    for (int i = 0; i < E; ++i) {
                        const bool on = E == 16 ? g16[i] != 0 : ((g >> (8 * i)) & 0xff) != 0;
                        p += on ? (unsigned)x[i] : 0u;
                    }
                } else {
                    const int lo = r.s > e ? (int)(r.s - e < E ? r.s - e : E) : 0;
                    const int hi = r.t < e + E ? (int)(r.t > e ? r.t - e : 0) : E;
#pragma unroll
                    for (int i = 0; i < E; ++i) {
                        const bool on = E == 16 ? g16[i] != 0 : ((g >> (8 * i)) & 0xff) != 0;
                        p += (i >= lo && i < hi && on) ? (unsigned)x[i] : 0u;
                    }
                }
            }
            p = wf_k6p_tree(p);
            if (lane == (k & 31)) stream += p;
        }
    }
    return stream;
}

template <typename T, int U, int LAYOUT>
__global__ void __launch_bounds__(512)
wf_k6p_warp(const T* __restrict__ vals, const unsigned char* __restrict__ mask,
            unsigned* __restrict__ out, long long W, int L) {
    extern __shared__ __align__(16) unsigned char wf_k6p_smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (row >= W) return;
    const WfK6pRow r = wf_k6p_row(row, L);
    const unsigned st = wf_k6p_streams<T, U, LAYOUT>(vals, mask, r, 0, 1, lane,
                                                     wf_k6p_smem + warp * 512 * U);
    const unsigned s = r.chunks == 1 ? st : wf_k6p_tree(st);   // one chunk: lane 0 holds it
    if (lane == 0) out[row] = s;
}

template <typename T, int U, int LAYOUT>
__global__ void __launch_bounds__(512)
wf_k6p_split(const T* __restrict__ vals, const unsigned char* __restrict__ mask,
             unsigned* __restrict__ out, long long W, int L, int C) {
    __shared__ unsigned streams[16][32];
    extern __shared__ __align__(16) unsigned char wf_k6p_smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const int rl = warp / C, q = warp - rl * C;
    const long long row = (long long)blockIdx.x * (warps / C) + rl;
    if (row < W) {
        const unsigned s = wf_k6p_streams<T, U, LAYOUT>(vals, mask, wf_k6p_row(row, L), q, C, lane,
                                                wf_k6p_smem + warp * 512 * U);
        if (lane % C == q) streams[rl][lane] = s;
    }
    __syncthreads();
    if (row < W && q == 0) {
        const unsigned s = wf_k6p_tree(streams[rl][lane]);
        if (lane == 0) out[row] = s;
    }
}

constexpr int WF_K6P_SMEM_MAX = 200 * 1024;

template <typename T, int U, int LAYOUT>
static int wf_k6p_launch(const T* vals, const unsigned char* mask, unsigned* out, long long W,
                         int L, int regime, int threads, int C, long long blocks,
                         cudaStream_t s) {
    static std::once_flag opt_in;
    std::call_once(opt_in, [] {
        cudaFuncSetAttribute(wf_k6p_narrow<T, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WF_K6P_SMEM_MAX);
        cudaFuncSetAttribute(wf_k6p_warp<T, U, LAYOUT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, WF_K6P_SMEM_MAX);
        cudaFuncSetAttribute(wf_k6p_split<T, U, LAYOUT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, WF_K6P_SMEM_MAX);
    });
    const int warps = threads / 32;
    if (threads < 32 || threads > 512 || threads % 32 || blocks < 1 || blocks > 0x7fffffffll ||
        (uintptr_t)vals % 16 || (uintptr_t)mask % 16)
        return (int)cudaErrorInvalidValue;
    if (regime == 0) {
        const unsigned vbytes = wf_k6p_image_bytes((long long)threads * L * sizeof(T));
        const size_t smem = vbytes + wf_k6p_image_bytes((long long)threads * L);
        if (blocks * threads < W || smem > WF_K6P_SMEM_MAX) return (int)cudaErrorInvalidValue;
        wf_k6p_narrow<T, U><<<(unsigned)blocks, threads, smem, s>>>(vals, mask, out, W, L, vbytes);
    } else if (regime == 1) {
        if (blocks * warps < W) return (int)cudaErrorInvalidValue;
        wf_k6p_warp<T, U, LAYOUT><<<(unsigned)blocks, threads, (size_t)warps * 512 * U, s>>>(
            vals, mask, out, W, L);
    } else {
        if (C < 2 || C > 16 || 16 % C || warps % C || blocks * (warps / C) < W)
            return (int)cudaErrorInvalidValue;
        wf_k6p_split<T, U, LAYOUT><<<(unsigned)blocks, threads, (size_t)warps * 512 * U, s>>>(
            vals, mask, out, W, L, C);
    }
    return (int)cudaGetLastError();
}

template <typename T>
static int wf_k6p_unroll(const T* vals, const unsigned char* mask, unsigned* out, long long W,
                         int L, int unroll, int regime, int threads, int C, long long blocks,
                         cudaStream_t s) {
    // unroll: the slots in flight (1, 2, 4, 8), plus 16 for the contiguous layout
#define WF_K6P(U, LAY) return wf_k6p_launch<T, U, LAY>(vals, mask, out, W, L, regime, threads, C, blocks, s)
    switch (unroll) {
        case 1: WF_K6P(1, 1);
        case 2: WF_K6P(2, 1);
        case 4: WF_K6P(4, 1);
        case 8: WF_K6P(8, 1);
        case 17: WF_K6P(1, 0);
        case 18: WF_K6P(2, 0);
        case 20: WF_K6P(4, 0);
        case 24: WF_K6P(8, 0);
        default: return (int)cudaErrorInvalidValue;
    }
#undef WF_K6P
}

// vals: contiguous int32 (itemsize 4) or uint8 (itemsize 1) [W, L], 16-byte
// aligned; mask bool [W, L], 16-byte aligned; out uint32 [W] (an int32 sum's
// bits). unroll: 1, 2, 4 or 8 (the narrow regime's lines, the long regimes'
// chunks in flight a thread), plus 16 for the long regimes' contiguous layout;
// regime 0 narrow, 1 warp, 2 split.
WF_EXPORT int wf_k6_geom(const void* vals, int itemsize, const unsigned char* mask, void* out,
                         long long W, int L, int unroll, int regime, int threads, int C,
                         long long blocks, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned* o = (unsigned*)out;
    if (W < 1 || L < 1) return (int)cudaErrorInvalidValue;
    if (itemsize == 4)
        return wf_k6p_unroll<int>((const int*)vals, mask, o, W, L, unroll, regime, threads, C,
                                  blocks, s);
    if (itemsize == 1)
        return wf_k6p_unroll<unsigned char>((const unsigned char*)vals, mask, o, W, L, unroll,
                                            regime, threads, C, blocks, s);
    return (int)cudaErrorInvalidValue;
}
