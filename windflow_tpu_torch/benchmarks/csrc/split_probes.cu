// Measurement probes for chip_smoke.py's split of K1's, K2's and K3's time,
// for the launch floor (an empty kernel), and for the host link's read rate,
// the bound of the cold-tier reads (ops/csrc/cold_probe.cu). No TPU kernel,
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
// (ld.relaxed.sys, as the cold-tier kernels read mapped records), each from
// a line of 128 bytes drawn by a hash of the read's number from `lines`
// lines of a mapped host buffer, `per` reads in flight a thread (1 to 4),
// a grid of 256-thread blocks covering n / per threads. Writes nothing
// unless the xor of every word is a value no input gives in practice.
__global__ void __launch_bounds__(WF_SPLIT_THREADS)
wf_link_reads_kernel(const unsigned char* buf, long long lines, long long n, int per,
                     int* __restrict__ sink) {
    const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * per;
    unsigned acc = 0;
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        if (u >= per || i0 + u >= n) continue;
        const unsigned long long h = (unsigned long long)(i0 + u + 1) * 0x9E3779B97F4A7C15ull;
        const unsigned char* p = buf + (long long)((h >> 24) % (unsigned long long)lines) * 128
                                 + ((h >> 8) & 7) * 16;
        asm volatile("ld.relaxed.sys.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(v[u].x), "=r"(v[u].y), "=r"(v[u].z), "=r"(v[u].w) : "l"(p));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
        if (u < per && i0 + u < n) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
    if (acc == 0x9e3779b9u) sink[0] = (int)acc;
}

// buf: device address of a mapped buffer of lines * 128 bytes.
WF_EXPORT int wf_link_reads(const void* buf, long long lines, long long n, int per, int* sink,
                            void* stream) {
    if (lines < 1 || n < 1 || per < 1 || per > 4) return (int)cudaErrorInvalidValue;
    const long long threads = (n + per - 1) / per;
    const long long blocks = (threads + WF_SPLIT_THREADS - 1) / WF_SPLIT_THREADS;
    wf_link_reads_kernel<<<(unsigned)blocks, WF_SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)buf, lines, n, per, sink);
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
