// cold_probe — the tiered state's cold-tier read on the card: for each wanted
// lane, the row of its key in the HostStore (windflow_tpu_torch/state/
// host_store.py): the key's slot found in the store's index, mirrored in the
// card's memory, and the row's record read from pinned, mapped host memory.
//
// A helper kernel: it replaces no TPU kernel. The JAX package reads the cold
// tier with an ordered io_callback inside the compiled step
// (windflow_tpu/ops/lookup.py::join_table_tier_resolve and windflow_tpu/
// state/tiered.py::slot_directory_resolve call JoinTableTier.lookup_cb /
// SlotTableTier.lookup_cb). The port replays a whole step as a CUDA graph,
// which cannot call Python, and a host node that takes the interpreter lock
// can deadlock against a driver thread waiting on the card. So the step
// reads the store itself: the store keeps its records in memory allocated
// with cudaHostAlloc(cudaHostAllocMapped) (wf_host_alloc below) and a copy
// of its key index in device memory, and this kernel probes them.
//
// What a lane computes is what HostStore.lookup gives for it: (found, the
// low 32 bits of meta m0, m1, m2, one row of each value column), zeros where
// the lane is not wanted or its key is absent. The index is open addressing
// over int64 keys, 16-byte slots {key, head row}, home slot (uint64)key *
// 0x9E3779B97F4A7C15 >> (64 - lg), linear probing, head row -1 for an empty
// slot — the hash and order of windflow_tpu_torch/native/csrc/
// host_store.cpp, which writes the host's index; the two must stay equal.
// The host copies the slots each write changed into the device copy with
// wf_cold_scatter (below) on the stream the reads run on, so a read sees
// the index of the last write before it.
//
// Where the time goes: on this card the host link serves about 240 M
// requests a second for reads of random lines (chip_smoke.py's link_reads
// phase measures it with a probe of windflow_tpu_torch/benchmarks/csrc/
// split_probes.cu), each a round trip of a microsecond or more, where a
// device-memory read takes a few hundred nanoseconds; the 16-byte loads of
// one warp instruction that fall in one 128-byte line are one request, a
// second instruction's load of the same line is a request of its own. So
// the walk, of dependent reads one slot at a time, stays in device memory:
// one 16-byte load a step, neighbouring slots in one sector. Only a hit
// crosses the link, once: its record (a unique store's meta low words,
// then its value columns; state/host_store.py::record_layout; q3's is one
// 16-byte chunk), read by a group of threads a lane (wf_cold_group) that
// loads a window's chunks with one instruction. A miss and a lane not
// wanted read nothing over the link.
//
// A fixed descriptor in device memory holds the index copy's and the
// records' addresses, the index size and each column's place in a record.
// The kernels read only the descriptor's address from their arguments, so a
// graph captured before the store grew (new arrays, a new descriptor
// content, written by an async copy on the stream) still reads the current
// store. The host writes the records only between steps, after waiting on
// the chain's stream; the kernels read them with ld.relaxed.sys (below), so
// no cache holds a value across launches.
//
// The found lanes are added to a counter in device memory (the host link
// offers no system-scope atomics): one __syncthreads_count and one atomicAdd
// a block. The store folds it into its readmission count.
//
// cold_fetch, the second entry point, is the multimap read of the interval
// join's archive tier (also a helper kernel that replaces no TPU kernel; the
// JAX package calls ArchiveTier.fetch_cb, windflow_tpu/state/tiered.py, from
// an ordered io_callback). For each wanted lane it finds the key's head row
// as the probe does and walks the next-row links up to M rows, oldest first
// (windflow_tpu_torch/native/csrc/host_store.cpp::wf_hs_fetch, HostStore.
// fetch_multi): mask [R, M] and each column's [R, M] rows, zeros past the
// chain's end. It is read-only and counts nothing. A multimap record holds a
// row's next-row link and its value columns (a multiple of 16 bytes), and a
// group of g threads (a power of two, all in one warp) serves a lane: its
// leader finds the head slot; at every hop thread j reads the record's
// 16-byte chunks j, j + g, ... into shared memory with ld.relaxed.sys.v4 (a
// system-scope load observes the host's writes made before the launch,
// where a weak load may hit a line an earlier launch left in the card's
// caches; "relaxed" orders nothing, so the chunks of one hop stay in flight
// together), every thread of the group takes the next link from there, and
// thread c copies column c out. A hop of q4's 32-byte record is two chunks
// of one line, one request; a record wider than WF_COLD_STAGE bytes is read
// a window of that many bytes at a time.
//
// cold_scatter, the third, writes a host store's changed slots into its
// index copy: entries of 32 bytes (key, head row, slot, 0) staged in mapped
// memory, two threads an entry, a 16-byte load each and one 16-byte store.
#include "common.cuh"

// The descriptor's layout, for every kernel here (and ops/cold_probe.py's
// DESC_* and HostStore._alloc, which write it): words 0 the index copy
// ([2^lg] 16-byte slots in device memory), 1 lg, 2 column count, 3 the
// records (a multimap row's next-row link or a unique row's three meta low
// words first, then its value columns), 4 a record's bytes (a multiple of
// 16), then for column c: WF_COLD_COL0 + 2c its offset in a record,
// WF_COLD_COL0 + 2c + 1 its bytes a row
constexpr int WF_COLD_MAXC = 16;                              // value columns at most
constexpr int WF_COLD_SLOTS = 0;                              // the index copy
constexpr int WF_COLD_LG = 1;                                 // 2^lg slots
constexpr int WF_COLD_NCOLS = 2;                              // value columns
constexpr int WF_COLD_REC = 3;                                // the records
constexpr int WF_COLD_REC_BYTES = 4;                          // bytes a record
constexpr int WF_COLD_COL0 = 5;                               // first column's offset
constexpr int WF_COLD_DESC = WF_COLD_COL0 + 2 * WF_COLD_MAXC; // descriptor words
struct WfColdOuts {
    unsigned char* col[WF_COLD_MAXC];
};

__device__ __forceinline__ unsigned long long wf_cold_home(long long key, int lg) {
    return ((unsigned long long)key * 0x9E3779B97F4A7C15ull) >> (64 - lg);
}

// head row of key in the store's index copy, -1 when absent (d: the
// descriptor): one 16-byte load of device memory a slot
__device__ __forceinline__ long long wf_cold_head(const long long* d, long long key) {
    const longlong2* slots = (const longlong2*)d[WF_COLD_SLOTS];
    const int lg = (int)d[WF_COLD_LG];
    const unsigned long long mask = (1ull << lg) - 1;
    for (unsigned long long s = wf_cold_home(key, lg);; s = (s + 1) & mask) {
        const longlong2 e = __ldg(slots + s);
        if (e.y < 0) return -1;
        if (e.x == key) return e.y;
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
// j, j + g, ... (four loads in flight before their stores) and thread c
// copies the part of columns c, c + g, ... that lies in it (no copy where
// !live). Returns the record's first 8 bytes (a multimap row's next-row
// link; -1 when row < 0); with meta3, the first window's three int32 (a
// unique row's meta low words) go there. A group of g > 1 lies in
// one warp, whose threads all run it together (the warp syncs see the whole
// warp).
__device__ __forceinline__ long long wf_copy_record(unsigned char* st, int staged, int g, int c,
                                                    const long long* d, long long row,
                                                    long long o, bool live,
                                                    const WfColdOuts& outs,
                                                    int* meta3 = nullptr) {
    const long long rec_bytes = d[WF_COLD_REC_BYTES];
    const unsigned char* rec = (const unsigned char*)d[WF_COLD_REC] +
                               (row >= 0 ? row : 0) * rec_bytes;
    const int ncols = (int)d[WF_COLD_NCOLS];
    long long next = -1;
    for (long long w0 = 0; w0 < rec_bytes; w0 += staged) {
        const long long nb = rec_bytes - w0 < staged ? rec_bytes - w0 : staged;
        const int chunks = (int)(nb / 16);
        if (row >= 0)
            for (int j = c; j < chunks; j += 4 * g) {
                uint4 v[4];
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (j + u * g < chunks) v[u] = wf_ld16_sys(rec + w0 + 16 * (j + u * g));
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (j + u * g < chunks) *(uint4*)(st + 16 * (j + u * g)) = v[u];
            }
        if (g > 1) __syncwarp();
        if (w0 == 0 && row >= 0) {
            next = *(const long long*)st;
            if (meta3) {
                meta3[0] = ((const int*)st)[0];
                meta3[1] = ((const int*)st)[1];
                meta3[2] = ((const int*)st)[2];
            }
        }
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

constexpr int WF_COLD_THREADS = 256;
constexpr int WF_COLD_STAGE = 1024;      // bytes of a record a lane's group stages at once

// A lane's group for records of rec_bytes (a multiple of 16) and ncols
// columns: g threads (a power of two, at most 32, so a group lies in one
// warp), enough to read a window's chunks with one load each where they fit
// (the chunks of a line that one load instruction of a warp reads are one
// request over the link; a second load of the same line is a request of its
// own) and to copy each column; `staged` bytes of shared memory a group.
static void wf_cold_group(long long rec_bytes, int ncols, int* g, int* staged) {
    *staged = (int)(rec_bytes < WF_COLD_STAGE ? rec_bytes : WF_COLD_STAGE);
    *g = 1;
    while (*g < 32 && (*g < ncols || *g < *staged / 16)) *g *= 2;
}

// g threads a lane (wf_cold_group): the leader (thread 0) walks the index
// copy; the group reads a hit's record (wf_copy_record) and copies its
// columns; the leader writes found and the meta low words. Every thread of
// a warp runs it together.
__global__ void __launch_bounds__(WF_COLD_THREADS)
wf_cold_probe_kernel(const long long* __restrict__ desc, const int* __restrict__ keys,
                     const bool* __restrict__ want, long long R, int g, int staged,
                     bool* __restrict__ found, int* __restrict__ m0, int* __restrict__ m1,
                     int* __restrict__ m2, WfColdOuts outs,
                     unsigned long long* __restrict__ readmits) {
    extern __shared__ __align__(16) unsigned char wf_probe_stage[];
    __shared__ long long d[WF_COLD_DESC];
    if (threadIdx.x < WF_COLD_DESC) d[threadIdx.x] = desc[threadIdx.x];
    __syncthreads();
    const long long i = ((long long)blockIdx.x * WF_COLD_THREADS + threadIdx.x) / g;
    const int c = threadIdx.x & (g - 1);
    const int leader = (threadIdx.x & 31) & ~(g - 1);
    const bool live = i < R;
    long long row = -1;
    if (live && c == 0 && want[i]) row = wf_cold_head(d, keys[i]);
    row = __shfl_sync(0xffffffffu, row, leader);
    int meta[3] = {0, 0, 0};
    wf_copy_record(wf_probe_stage + (threadIdx.x / g) * staged, staged, g, c, d, row, i, live,
                   outs, meta);
    if (live && c == 0) {
        found[i] = row >= 0;
        m0[i] = meta[0];
        m1[i] = meta[1];
        m2[i] = meta[2];
    }
    const int n = __syncthreads_count(live && c == 0 && row >= 0);
    if (threadIdx.x == 0 && n) atomicAdd(readmits, (unsigned long long)n);
}

// Probe R lanes of a unique store. desc: the store's descriptor (device
// memory); rec_bytes: its records' bytes (a multiple of 16); outs: ncols
// output bases, column c of R rows of the descriptor's row bytes; readmits:
// a device uint64 the found lanes are added to.
WF_EXPORT int wf_cold_probe(const void* desc, const int* keys, const bool* want,
                            long long R, long long rec_bytes, bool* found, int* m0, int* m1,
                            int* m2, void* const* outs, int ncols,
                            unsigned long long* readmits, void* stream) {
    if (ncols < 0 || ncols > WF_COLD_MAXC || rec_bytes < 16 || rec_bytes % 16)
        return (int)cudaErrorInvalidValue;
    WfColdOuts o = {};
    for (int c = 0; c < ncols; ++c) o.col[c] = (unsigned char*)outs[c];
    if (R <= 0) return 0;
    int g = 1, staged = 16;
    wf_cold_group(rec_bytes, ncols, &g, &staged);
    const long long blocks = (R * g + WF_COLD_THREADS - 1) / WF_COLD_THREADS;
    const size_t smem = (size_t)(WF_COLD_THREADS / g) * staged;
    wf_cold_probe_kernel<<<(unsigned)blocks, WF_COLD_THREADS, smem, (cudaStream_t)stream>>>(
        (const long long*)desc, keys, want, R, g, staged, found, m0, m1, m2, o, readmits);
    return (int)cudaGetLastError();
}

// The fetch's lane groups are the probe's (wf_cold_group): every hop copies
// its record out (wf_copy_record) and takes the next link from it; the
// leader reads the head slot and writes the mask. Every thread of a warp
// runs the same hops.
__global__ void __launch_bounds__(WF_COLD_THREADS)
wf_cold_fetch_kernel(const long long* __restrict__ desc, const int* __restrict__ keys,
                     const bool* __restrict__ want, long long R, int M, int g, int staged,
                     bool* __restrict__ mask, WfColdOuts outs) {
    extern __shared__ __align__(16) unsigned char wf_fetch_stage[];
    __shared__ long long d[WF_COLD_DESC];
    if (threadIdx.x < WF_COLD_DESC) d[threadIdx.x] = desc[threadIdx.x];
    __syncthreads();
    const long long i = ((long long)blockIdx.x * WF_COLD_THREADS + threadIdx.x) / g;
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
    int g = 1, staged = 16;
    wf_cold_group(rec_bytes, ncols, &g, &staged);
    const long long blocks = (R * g + WF_COLD_THREADS - 1) / WF_COLD_THREADS;
    const size_t smem = (size_t)(WF_COLD_THREADS / g) * staged;
    wf_cold_fetch_kernel<<<(unsigned)blocks, WF_COLD_THREADS, smem, (cudaStream_t)stream>>>(
        (const long long*)desc, keys, want, R, M, g, staged, mask, o);
    return (int)cudaGetLastError();
}

constexpr int WF_SCATTER_THREADS = 256;

// Two threads an entry, each one 16-byte load, so a warp's loads read 512
// contiguous bytes (four lines, four requests over the link): the even
// thread holds {key, head row} and takes the slot from its odd neighbour.
__global__ void __launch_bounds__(WF_SCATTER_THREADS)
wf_cold_scatter_kernel(const unsigned char* entries, long long n, longlong2* __restrict__ slots) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < 2 * n) v = wf_ld16_sys(entries + 16 * t);
    const unsigned lo = __shfl_xor_sync(0xffffffffu, v.x, 1);
    const unsigned hi = __shfl_xor_sync(0xffffffffu, v.y, 1);
    if (t < 2 * n && !(t & 1)) {
        longlong2 e;
        e.x = (long long)(((unsigned long long)v.y << 32) | v.x);
        e.y = (long long)(((unsigned long long)v.w << 32) | v.z);
        slots[(long long)(((unsigned long long)hi << 32) | lo)] = e;
    }
}

// Write n staged entries (mapped memory, 32 bytes each: key, head row, slot,
// unused; int64) into the index copy: slots[slot] = {key, head row}. Entries
// naming one slot twice carry the same value.
WF_EXPORT int wf_cold_scatter(const void* entries, long long n, void* slots, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const long long blocks = (2 * n + WF_SCATTER_THREADS - 1) / WF_SCATTER_THREADS;
    wf_cold_scatter_kernel<<<(unsigned)blocks, WF_SCATTER_THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)entries, n, (longlong2*)slots);
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
