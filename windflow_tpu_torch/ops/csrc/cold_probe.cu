// cold_probe — the tiered state's cold-tier read on the card: for each wanted
// lane, the row of its key in the HostStore (windflow_tpu_torch/state/
// host_store.py), read from pinned, mapped host memory.
//
// A helper kernel: it replaces no TPU kernel. The JAX package reads the cold
// tier with an ordered io_callback inside the compiled step
// (windflow_tpu/ops/lookup.py::join_table_tier_resolve and windflow_tpu/
// state/tiered.py::slot_directory_resolve call JoinTableTier.lookup_cb /
// SlotTableTier.lookup_cb). The port replays a whole step as a CUDA graph,
// which cannot call Python, and a host node that takes the interpreter lock
// can deadlock against a driver thread waiting on the card. So the step
// reads the store itself: the store keeps its key index, its meta and its
// value columns in memory allocated with cudaHostAlloc(cudaHostAllocMapped)
// (wf_host_alloc below), and this kernel probes them over the host link.
//
// What a lane computes is what HostStore.lookup gives for it: (found, the
// low 32 bits of meta m0, m1, m2, one row of each value column), zeros where
// the lane is not wanted or its key is absent. The index is open addressing
// over int64 keys, home slot (uint64)key * 0x9E3779B97F4A7C15 >> (64 - lg),
// linear probing, head row -1 for an empty slot — the hash and order of
// windflow_tpu_torch/native/csrc/host_store.cpp, which writes it; the two
// must stay equal.
//
// A fixed descriptor, itself in mapped memory, holds the arrays' device
// pointers, the index size and each column's row bytes. The kernel reads
// only the descriptor's address from its arguments, so a graph captured
// before the store grew (new arrays, a new descriptor content) still reads
// the current store. The host writes the store only between steps, after
// waiting on the chain's stream; the kernel loads it through volatile
// pointers so no cache holds a value across launches.
//
// The found lanes are added to a counter in device memory (the host link
// offers no system-scope atomics): one __syncthreads_count and one atomicAdd
// a block. The store folds it into its readmission count.
//
// Bound on the H100: the bytes read over the host link (PCIe Gen5 x16, 64
// GB/s a direction by the data sheet): one 16-byte index slot for each
// wanted lane, the meta (24 B) and the value row of each found lane. The
// reads are small and dependent (slot, then row), so the kernel is latency
// bound; one thread a lane keeps up to R probes in flight at once.
//
// cold_fetch, the second entry point, is the multimap read of the interval
// join's archive tier (also a helper kernel that replaces no TPU kernel; the
// JAX package calls ArchiveTier.fetch_cb, windflow_tpu/state/tiered.py, from
// an ordered io_callback). For each wanted lane it finds the key's head row
// as the probe does and walks the next-row links up to M rows, oldest first
// (windflow_tpu_torch/native/csrc/host_store.cpp::wf_hs_fetch, HostStore.
// fetch_multi): mask [R, M] and each column's [R, M] rows, zeros past the
// chain's end. It is read-only and counts nothing. Its bound is the same
// host link: a 16-byte slot a wanted lane, then for each row fetched its
// 8-byte link and its value row; each hop depends on the one before, so it
// is latency bound too, one thread a lane.
#include "common.cuh"

// The descriptor's layout, for both kernels (and ops/cold_probe.py's
// DESC_WORDS and HostStore._alloc, which write it): words 0 index keys, 1
// index head rows, 2 lg (the index has 2^lg slots), 3 meta [rows, 3] int64, 4
// column count, 5 next-row links [rows] int64, then for column c:
// WF_COLD_COL0 + 2c its base, WF_COLD_COL0 + 2c + 1 its bytes a row
constexpr int WF_COLD_MAXC = 16;                              // value columns at most
constexpr int WF_COLD_NXT = 5;                                // next-row links
constexpr int WF_COLD_COL0 = 6;                               // first column's base
constexpr int WF_COLD_DESC = WF_COLD_COL0 + 2 * WF_COLD_MAXC; // descriptor words
struct WfColdOuts {
    unsigned char* col[WF_COLD_MAXC];
};

__device__ __forceinline__ unsigned long long wf_cold_home(long long key, int lg) {
    return ((unsigned long long)key * 0x9E3779B97F4A7C15ull) >> (64 - lg);
}

// head row of key in the store's index, -1 when absent (d: the descriptor)
__device__ __forceinline__ long long wf_cold_head(const long long* d, long long key) {
    const volatile long long* ikey = (const volatile long long*)d[0];
    const volatile long long* irow = (const volatile long long*)d[1];
    const int lg = (int)d[2];
    const unsigned long long mask = (1ull << lg) - 1;
    for (unsigned long long s = wf_cold_home(key, lg);; s = (s + 1) & mask) {
        const long long r = irow[s];
        if (r < 0) return -1;
        if (ikey[s] == key) return r;
    }
}

// one row (rb bytes) of a column, or zeros when row < 0
__device__ __forceinline__ void wf_cold_copy_row(unsigned char* dst,
                                                 const volatile unsigned char* base,
                                                 long long row, long long rb) {
    const bool hit = row >= 0;
    const volatile unsigned char* src = base + (hit ? row : 0) * rb;
    if (rb % 4 == 0) {
        const volatile unsigned int* s4 = (const volatile unsigned int*)src;
        unsigned int* d4 = (unsigned int*)dst;
        for (long long w = 0; w < rb / 4; ++w) d4[w] = hit ? s4[w] : 0u;
    } else {
        for (long long b = 0; b < rb; ++b) dst[b] = hit ? src[b] : (unsigned char)0;
    }
}

__global__ void wf_cold_probe_kernel(const volatile long long* desc,
                                     const int* __restrict__ keys,
                                     const bool* __restrict__ want, long long R,
                                     bool* __restrict__ found, int* __restrict__ m0,
                                     int* __restrict__ m1, int* __restrict__ m2,
                                     WfColdOuts outs,
                                     unsigned long long* __restrict__ readmits) {
    __shared__ long long d[WF_COLD_DESC];
    if (threadIdx.x < WF_COLD_DESC) d[threadIdx.x] = desc[threadIdx.x];
    __syncthreads();
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long row = -1;
    if (i < R) {
        if (want[i]) row = wf_cold_head(d, keys[i]);
        const bool hit = row >= 0;
        const volatile long long* meta = (const volatile long long*)d[3];
        found[i] = hit;
        m0[i] = hit ? (int)meta[3 * row] : 0;
        m1[i] = hit ? (int)meta[3 * row + 1] : 0;
        m2[i] = hit ? (int)meta[3 * row + 2] : 0;
        const int ncols = (int)d[4];
        for (int c = 0; c < ncols; ++c) {
            const long long rb = d[WF_COLD_COL0 + 2 * c + 1];
            wf_cold_copy_row(outs.col[c] + i * rb,
                             (const volatile unsigned char*)d[WF_COLD_COL0 + 2 * c], row, rb);
        }
    }
    const int n = __syncthreads_count(row >= 0);
    if (threadIdx.x == 0 && n) atomicAdd(readmits, (unsigned long long)n);
}

// Probe R lanes. desc: the store's descriptor (device address of mapped
// memory); outs: ncols output bases, column c of R rows of the descriptor's
// row bytes; readmits: a device uint64 the found lanes are added to.
WF_EXPORT int wf_cold_probe(const void* desc, const int* keys, const bool* want,
                            long long R, bool* found, int* m0, int* m1, int* m2,
                            void* const* outs, int ncols, unsigned long long* readmits,
                            void* stream) {
    if (ncols < 0 || ncols > WF_COLD_MAXC) return (int)cudaErrorInvalidValue;
    WfColdOuts o = {};
    for (int c = 0; c < ncols; ++c) o.col[c] = (unsigned char*)outs[c];
    if (R <= 0) return 0;
    const int threads = 256;
    const long long blocks = (R + threads - 1) / threads;
    wf_cold_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const volatile long long*)desc, keys, want, R, found, m0, m1, m2, o, readmits);
    return (int)cudaGetLastError();
}

__global__ void wf_cold_fetch_kernel(const volatile long long* desc,
                                     const int* __restrict__ keys,
                                     const bool* __restrict__ want, long long R, int M,
                                     bool* __restrict__ mask, WfColdOuts outs) {
    __shared__ long long d[WF_COLD_DESC];
    if (threadIdx.x < WF_COLD_DESC) d[threadIdx.x] = desc[threadIdx.x];
    __syncthreads();
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R) return;
    long long row = want[i] ? wf_cold_head(d, keys[i]) : -1;
    const volatile long long* nxt = (const volatile long long*)d[WF_COLD_NXT];
    const int ncols = (int)d[4];
    for (int t = 0; t < M; ++t) {
        const long long o = i * M + t;
        mask[o] = row >= 0;
        for (int c = 0; c < ncols; ++c) {
            const long long rb = d[WF_COLD_COL0 + 2 * c + 1];
            wf_cold_copy_row(outs.col[c] + o * rb,
                             (const volatile unsigned char*)d[WF_COLD_COL0 + 2 * c], row, rb);
        }
        if (row >= 0) row = nxt[row];
    }
}

// Fetch up to M rows for each of R lanes. desc: the store's descriptor;
// mask: [R, M]; outs: ncols output bases, column c of R * M rows of the
// descriptor's row bytes.
WF_EXPORT int wf_cold_fetch(const void* desc, const int* keys, const bool* want,
                            long long R, int M, bool* mask, void* const* outs, int ncols,
                            void* stream) {
    if (ncols < 0 || ncols > WF_COLD_MAXC || M < 1) return (int)cudaErrorInvalidValue;
    WfColdOuts o = {};
    for (int c = 0; c < ncols; ++c) o.col[c] = (unsigned char*)outs[c];
    if (R <= 0) return 0;
    const int threads = 256;
    const long long blocks = (R + threads - 1) / threads;
    wf_cold_fetch_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const volatile long long*)desc, keys, want, R, M, mask, o);
    return (int)cudaGetLastError();
}

// Pinned host memory mapped into the card's address space: *host for the
// host, *dev for kernels (on a system with unified addressing the two are
// equal).
WF_EXPORT int wf_host_alloc(long long bytes, void** host, void** dev) {
    cudaError_t e = cudaHostAlloc(host, (size_t)(bytes > 0 ? bytes : 1), cudaHostAllocMapped);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

WF_EXPORT int wf_host_free(void* host) {
    return (int)cudaFreeHost(host);
}
