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
// pointers, the index size and each column's place in a row's record. The
// kernels read only the descriptor's address from their arguments, so a
// graph captured before the store grew (new arrays, a new descriptor
// content) still reads the current store. The host writes the store only
// between steps, after waiting on the chain's stream. The kernels load the
// index and the meta through volatile pointers and the records with
// ld.relaxed.sys (below), so no cache holds a value across launches.
//
// The found lanes are added to a counter in device memory (the host link
// offers no system-scope atomics): one __syncthreads_count and one atomicAdd
// a block. The store folds it into its readmission count.
//
// Bound on the H100: the bytes read over the host link (PCIe Gen5 x16, 64
// GB/s a direction by the data sheet): one 16-byte index slot for each
// wanted lane, the meta (24 B) and the value row of each found lane. The
// reads are small and dependent (slot, then row), so the kernel is latency
// bound; one thread a lane keeps up to R probes in flight at once, and reads
// a found row's record (below) a 16-byte chunk at a time, as the fetch does.
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
// 8-byte link and its value row. What limits it is the number of reads over
// PCIe, not their bytes: on the H100 the link serves about 240 M reads a
// second of one line each, whatever their width up to 16 bytes, and a
// system-scope read of a second word of the same line is a read of its own
// (PERF.md). With a column an array, a hop of q4's five columns would be six
// reads; the store keeps a row's link and columns in one record
// (state/host_store.py::record_layout, a multiple of 16 bytes), and a group
// of g threads (a power of two, all in one warp) serves a lane: its leader
// reads the head slot; at every hop thread j reads the record's 16-byte
// chunks j, j + g, ... into shared memory with ld.relaxed.sys.v4 (a
// system-scope load observes the host's writes made before the launch,
// where a weak load may hit a line an earlier launch left in the card's
// caches; "relaxed" orders nothing, so the chunks of one hop stay in flight
// together), every thread of the group takes the next link from there, and
// thread c copies column c out. A hop of q4's 32-byte record is two chunks
// of one line; a record wider than WF_FETCH_STAGE bytes is read a window of
// that many bytes at a time.
#include "common.cuh"

// The descriptor's layout, for both kernels (and ops/cold_probe.py's
// DESC_WORDS and HostStore._alloc, which write it): words 0 index keys, 1
// index head rows, 2 lg (the index has 2^lg slots), 3 meta [rows, 3] int64, 4
// column count, 5 the records (a row's next-row link at byte 0, then its
// value columns), 6 a record's bytes (a multiple of 16), then for column c:
// WF_COLD_COL0 + 2c its offset in a record, WF_COLD_COL0 + 2c + 1 its bytes
// a row
constexpr int WF_COLD_MAXC = 16;                              // value columns at most
constexpr int WF_COLD_REC = 5;                                // the records
constexpr int WF_COLD_REC_BYTES = 6;                          // bytes a record
constexpr int WF_COLD_COL0 = 7;                               // first column's offset
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

// 16 bytes over the host link (see cold_fetch above: relaxed, system scope)
__device__ __forceinline__ uint4 wf_ld16_sys(const unsigned char* p) {
    uint4 v;
    asm volatile("ld.relaxed.sys.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

// rb bytes from shared memory (hit) or zeros to dst, W bytes a store
template <typename T>
__device__ __forceinline__ void wf_stage_copy(unsigned char* dst, const unsigned char* src,
                                              bool hit, long long rb) {
    for (long long o = 0; o < rb; o += sizeof(T)) *(T*)(dst + o) = hit ? *(const T*)(src + o) : T();
}

// the widest store (up to 16 bytes) that the width and both addresses allow
__device__ __forceinline__ void wf_stage_copy_row(unsigned char* dst, const unsigned char* src,
                                                  bool hit, long long rb) {
    const unsigned x = (unsigned)(((uintptr_t)src | (uintptr_t)dst | (unsigned long long)rb) & 15);
    switch (x == 0 ? 16 : x & (0u - x)) {
        case 16: wf_stage_copy<uint4>(dst, src, hit, rb); break;
        case 8: wf_stage_copy<uint2>(dst, src, hit, rb); break;
        case 4: wf_stage_copy<unsigned int>(dst, src, hit, rb); break;
        case 2: wf_stage_copy<unsigned short>(dst, src, hit, rb); break;
        default: wf_stage_copy<unsigned char>(dst, src, hit, rb);
    }
}

// Row `row`'s record (zeros when row < 0) copied out as row o of every
// column, read a window of `staged` bytes at a time into the group's stage
// st: of the group's g threads, thread j reads the window's 16-byte chunks
// j, j + g, ... and thread c copies the part of columns c, c + g, ... that
// lies in it (no copy where !live). Returns the record's next-row link (-1
// when row < 0). A group of g > 1 lies in one warp, whose threads all run
// it together (the warp syncs see the whole warp).
__device__ __forceinline__ long long wf_copy_record(unsigned char* st, int staged, int g, int c,
                                                    const long long* d, long long row,
                                                    long long o, bool live,
                                                    const WfColdOuts& outs) {
    const long long rec_bytes = d[WF_COLD_REC_BYTES];
    const unsigned char* rec = (const unsigned char*)d[WF_COLD_REC] +
                               (row >= 0 ? row : 0) * rec_bytes;
    const int ncols = (int)d[4];
    long long next = -1;
    for (long long w0 = 0; w0 < rec_bytes; w0 += staged) {
        const long long nb = rec_bytes - w0 < staged ? rec_bytes - w0 : staged;
        if (row >= 0)
            for (int j = c; j < nb / 16; j += g)
                *(uint4*)(st + 16 * j) = wf_ld16_sys(rec + w0 + 16 * j);
        if (g > 1) __syncwarp();
        if (w0 == 0 && row >= 0) next = *(const long long*)st;
        for (int k = c; live && k < ncols; k += g) {
            const long long off = d[WF_COLD_COL0 + 2 * k], rb = d[WF_COLD_COL0 + 2 * k + 1];
            const long long lo = off > w0 ? off : w0;
            const long long hi = off + rb < w0 + nb ? off + rb : w0 + nb;
            if (lo < hi)
                wf_stage_copy_row(outs.col[k] + o * rb + (lo - off), st + (lo - w0), row >= 0,
                                  hi - lo);
        }
        if (g > 1) __syncwarp();
    }
    return next;
}

constexpr int WF_PROBE_THREADS = 256;
constexpr int WF_PROBE_STAGE = 64;       // bytes of a record a probing thread stages at once

__global__ void __launch_bounds__(WF_PROBE_THREADS)
wf_cold_probe_kernel(const volatile long long* desc, const int* __restrict__ keys,
                     const bool* __restrict__ want, long long R, bool* __restrict__ found,
                     int* __restrict__ m0, int* __restrict__ m1, int* __restrict__ m2,
                     WfColdOuts outs, unsigned long long* __restrict__ readmits) {
    __shared__ __align__(16) unsigned char stage[WF_PROBE_THREADS * WF_PROBE_STAGE];
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
        const int staged = (int)(d[WF_COLD_REC_BYTES] < WF_PROBE_STAGE ? d[WF_COLD_REC_BYTES]
                                                                       : WF_PROBE_STAGE);
        wf_copy_record(stage + threadIdx.x * WF_PROBE_STAGE, staged, 1, 0, d, row, i, true,
                       outs);
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
    const long long blocks = (R + WF_PROBE_THREADS - 1) / WF_PROBE_THREADS;
    wf_cold_probe_kernel<<<(unsigned)blocks, WF_PROBE_THREADS, 0, (cudaStream_t)stream>>>(
        (const volatile long long*)desc, keys, want, R, found, m0, m1, m2, o, readmits);
    return (int)cudaGetLastError();
}

constexpr int WF_FETCH_THREADS = 256;
constexpr int WF_FETCH_STAGE = 1024;     // bytes of a record a lane's group stages at once

// g threads a lane (a power of two, at most 32, so a lane's group lies in one
// warp), each group `staged` bytes of shared memory: every hop copies its
// record out (wf_copy_record) and takes the next link from it; thread 0 (the
// leader) reads the head slot and writes the mask. Every thread of a warp
// runs the same hops.
__global__ void __launch_bounds__(WF_FETCH_THREADS)
wf_cold_fetch_kernel(const volatile long long* desc, const int* __restrict__ keys,
                     const bool* __restrict__ want, long long R, int M, int g, int staged,
                     bool* __restrict__ mask, WfColdOuts outs) {
    extern __shared__ __align__(16) unsigned char wf_fetch_stage[];
    __shared__ long long d[WF_COLD_DESC];
    if (threadIdx.x < WF_COLD_DESC) d[threadIdx.x] = desc[threadIdx.x];
    __syncthreads();
    const long long i = ((long long)blockIdx.x * WF_FETCH_THREADS + threadIdx.x) / g;
    const int c = threadIdx.x & (g - 1);
    const int leader = (threadIdx.x & 31) & ~(g - 1);
    const bool live = i < R;
    unsigned char* st = wf_fetch_stage + (threadIdx.x / g) * staged;
    long long row = -1;
    if (live && c == 0 && want[i]) row = wf_cold_head(d, keys[i]);
    row = __shfl_sync(0xffffffffu, row, leader);
    for (int t = 0; t < M; ++t) {
        const long long o = i * M + t;
        const long long next = wf_copy_record(st, staged, g, c, d, row, o, live, outs);
        if (live && c == 0) mask[o] = row >= 0;
        row = next;
    }
}

// Fetch up to M rows for each of R lanes. desc: the store's descriptor;
// rec_bytes: its records' bytes (a multiple of 16); mask: [R, M]; outs:
// ncols output bases, column c of R * M rows of the descriptor's row bytes.
WF_EXPORT int wf_cold_fetch(const void* desc, const int* keys, const bool* want,
                            long long R, int M, long long rec_bytes, bool* mask,
                            void* const* outs, int ncols, void* stream) {
    if (ncols < 0 || ncols > WF_COLD_MAXC || M < 1 || rec_bytes < 16 || rec_bytes % 16)
        return (int)cudaErrorInvalidValue;
    WfColdOuts o = {};
    for (int c = 0; c < ncols; ++c) o.col[c] = (unsigned char*)outs[c];
    if (R <= 0) return 0;
    const int staged = (int)(rec_bytes < WF_FETCH_STAGE ? rec_bytes : WF_FETCH_STAGE);
    int g = 1;
    while (g < 32 && (g < ncols || g < staged / 16)) g *= 2;
    const long long blocks = (R * g + WF_FETCH_THREADS - 1) / WF_FETCH_THREADS;
    const size_t smem = (size_t)(WF_FETCH_THREADS / g) * staged;
    wf_cold_fetch_kernel<<<(unsigned)blocks, WF_FETCH_THREADS, smem, (cudaStream_t)stream>>>(
        (const volatile long long*)desc, keys, want, R, M, g, staged, mask, o);
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
