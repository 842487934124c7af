// K4 — bitonic sort and merge networks over four int32 lanes
// (prim, sec, chan, idx) with a lexicographic compare-exchange, on R
// independent rows of n = 2^m lanes each (row-major [R, n]).
//
// Replaces windflow_tpu/ops/bitonic.py::_pallas_network (one Pallas kernel
// running _sort_stages or _merge_stages with the four arrays in VMEM, for
// n <= 2^15). The function is an exact lexicographic sort of the 4-tuples
// (the merge network: of a bitonic row), so any exact total-order network
// gives the same bits, ties and repeated tuples included; this one keeps
// _sort_stages' stages and direction rule: stage k = 2, 4, .., n; substage
// d = k/2, .., 1; the pair (i, i + d) with bit d of i clear sorts ascending
// iff (i & k) == 0, i being the lane within its row. The merge network is
// the last stage alone (k = n). Any power of two n >= 2 is taken.
//
// Bound on the H100: bytes. Each lane's 16 bytes are read once and written
// once (TopN at bench geometry, [16, 2^15]: 16.8 MB, about 5 us at
// 3.35 TB/s); the compare-exchanges come to about 4 us at 67 T/s if each is
// counted as 8 int32 operations.
//
// Design. A lane is packed on load into one 128-bit unsigned key, four
// 32-bit words with the sign bits flipped, prim most significant, so a
// compare is the borrow of one 128-bit subtraction (five instructions) and
// an element one 16-byte register quad; it is unpacked on the final write.
// A CTA of 512 threads holds a share of 4096 lanes, 8 a thread in
// registers, and 64 KB of dynamic shared memory; two CTAs fit on an SM.
// Every substage runs in registers: four compare-exchanges a thread, one
// compare each, no synchronisation. What moves is the assignment of lane
// bits to registers (the layout, see wf_lane): a substage of stride 2^b
// needs bit b among the thread's three register bits. The four local
// layouts G0..G3 hold bits 0-2, 3-5, 6-8 and 9-11 of the CTA's lanes in
// registers; the cross layout X holds a cluster span's top three bits. The
// layout changes (through shared memory, XOR-swizzled against bank
// conflicts) only when the stride leaves the current three bits: at most
// four times a stage within a CTA, and twice a stage across a cluster.
// Direction bits come from masks of the lane's index in its row, and every
// layout's lane formula is shifts and masks.
//
// Regimes:
//   - n <= 4096: one CTA per 4096 lanes, that is 4096 / n whole rows a CTA
//     (a partial last CTA leaves its missing rows unwritten);
//   - 4096 < n <= 4096 * cluster: a row lives in one thread block cluster of
//     n / 4096 CTAs (up to 8, the largest size that
//     cudaOccupancyMaxActiveClusters says the card schedules). The
//     substages whose strides cross CTAs (the span's top bits) run in layout
//     X: each CTA writes its registers to its own shared memory, and after
//     a cluster.sync() every thread reads its eight new registers from the
//     CTAs that hold them (distributed shared memory, ld.shared::cluster),
//     so no CTA writes another's memory and each exchange spreads over all
//     the cluster's CTAs. The whole network is one launch: TopN's
//     [16, 2^15] is 16 clusters of 8 CTAs, 128 CTAs, one wave; more rows
//     run in further waves;
//   - n above one cluster's span: strides of a span or more run as
//     global-memory passes (one launch each, one thread a pair), and every
//     stage's smaller strides in one cluster launch, which loads straight
//     into layout X.
// wf_bitonic_plan reports the cluster size, the clusters the card holds at
// once and the number of launches of a call; the Python wrapper counts one
// launch per call.
#include <cooperative_groups.h>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int WF_BT_LOG_SHARE = 12;
constexpr int WF_BT_SHARE = 1 << WF_BT_LOG_SHARE;      // lanes of a CTA
constexpr int WF_BT_RB = 3;                            // register bits of a lane
constexpr int WF_BT_E = 1 << WF_BT_RB;                 // lanes a thread holds
constexpr int WF_BT_TB = WF_BT_LOG_SHARE - WF_BT_RB;   // thread-index bits
constexpr int WF_BT_THREADS = 1 << WF_BT_TB;           // threads of a CTA
constexpr int WF_BT_SMEM = WF_BT_SHARE * 16;           // 64 KB
constexpr int WF_BT_MAX_CLUSTER = 8;                   // the portable maximum

// A lane as one 128-bit unsigned key, most significant word last:
// w = prim, z = sec, y = chan, x = idx, each with its sign bit flipped.
typedef uint4 WfKey;

struct WfLanes {
    const int* in[4];
    int* out[4];
};

__device__ __forceinline__ WfKey wf_pack(int p, int s, int c, int i) {
    return make_uint4((unsigned)i ^ 0x80000000u, (unsigned)c ^ 0x80000000u,
                      (unsigned)s ^ 0x80000000u, (unsigned)p ^ 0x80000000u);
}

__device__ __forceinline__ void wf_unpack(const WfKey& k, int& p, int& s, int& c, int& i) {
    p = (int)(k.w ^ 0x80000000u);
    s = (int)(k.z ^ 0x80000000u);
    c = (int)(k.y ^ 0x80000000u);
    i = (int)(k.x ^ 0x80000000u);
}

// strict lexicographic (prim, sec, chan, idx) order: the borrow out of the
// 128-bit subtraction a - b
__device__ __forceinline__ bool wf_key_lt(const WfKey& a, const WfKey& b) {
    unsigned borrow;
    asm("{\n\t.reg .u32 t;\n\t"
        "sub.cc.u32 t, %1, %5;\n\t"
        "subc.cc.u32 t, %2, %6;\n\t"
        "subc.cc.u32 t, %3, %7;\n\t"
        "subc.cc.u32 t, %4, %8;\n\t"
        "subc.u32 %0, 0, 0;\n\t}"
        : "=r"(borrow)
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y), "r"(b.z), "r"(b.w));
    return borrow != 0;
}

__device__ __forceinline__ WfKey wf_sel(bool take_y, const WfKey& x, const WfKey& y) {
    return make_uint4(take_y ? y.x : x.x, take_y ? y.y : x.y, take_y ? y.z : x.z,
                      take_y ? y.w : x.w);
}

// Layouts. A cluster of C CTAs (C = 1, 2, 4, 8) holds a span of 4096 C
// lanes: bits 0..11 of a lane within its span are the lane within the CTA
// that loads it, the bits above the CTA's rank. In the local layout Gj
// (j = 0..3), register e of thread t of the CTA of rank r holds span lane
//   r << 12 | (t & (2^s - 1)) | e << s | (t >> s) << (s + 3),   s = 3j:
// bits 3j..3j+2 are the register index and the thread's nine bits fill the
// rest of the CTA's twelve. In the cross layout X (C > 1), the register
// index is the span's top three bits p..p+2 (p = log2(4096 C) - 3), and the
// thread and rank fill the rest: t | r << 9 | e << p. A lane's span bits
// decide its layout: bits at or above p are register bits of X, the others
// register bits of G(b / 3).
constexpr int WF_BT_X = 4;                   // the layout id of X

// span lane of register e of thread t in the CTA of rank r, layout lay
__device__ __forceinline__ unsigned wf_lane(int lay, int e, unsigned t, unsigned r, int p) {
    if (lay == WF_BT_X) return t | (r << WF_BT_TB) | ((unsigned)e << p);
    const int s = WF_BT_RB * lay;
    return (r << WF_BT_LOG_SHARE) | (t & ((1u << s) - 1)) |
           ((t >> s) << (s + WF_BT_RB)) | ((unsigned)e << s);
}

// Where a layout's registers wait in shared memory during a change of
// layout: the CTA that wrote them and the lane index there. A local layout
// writes each lane at its index within its CTA; X writes register e of
// thread t at t | e << 9.
__device__ __forceinline__ void wf_home(int lay, unsigned lane, int p, unsigned cmask,
                                        unsigned& owner, unsigned& idx) {
    if (lay == WF_BT_X) {
        owner = (lane >> WF_BT_TB) & cmask;
        idx = (lane & (WF_BT_THREADS - 1)) | ((lane >> p) << WF_BT_TB);
    } else {
        owner = lane >> WF_BT_LOG_SHARE;
        idx = lane & (WF_BT_SHARE - 1);
    }
}

// shared-memory slot of a lane index: 16-byte slots XOR-swizzled so that
// the eight threads of a quarter warp hit eight different bank groups in
// every layout
__device__ __forceinline__ unsigned wf_slot(unsigned l) {
    return l ^ ((l >> WF_BT_RB) & 7);
}

// The shared::cluster address of this CTA's shared memory `sm` in the CTA
// of the cluster with rank `rank`.
__device__ __forceinline__ unsigned wf_peer_smem(const void* sm, unsigned rank) {
    unsigned a;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(a) : "r"((unsigned)__cvta_generic_to_shared(sm)), "r"(rank));
    return a;
}

// One 16-byte load from a CTA's shared memory (distributed shared memory).
__device__ __forceinline__ WfKey wf_ld_cluster(unsigned addr) {
    WfKey v;
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
    return v;
}

__device__ __forceinline__ bool wf_aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

// The registers of layout lay from the lanes g0 + (span lane); lanes past
// `total` read as zero keys. G0's eight lanes are consecutive and load as
// 16-byte vectors.
__device__ __forceinline__ void wf_bt_load(const WfLanes& L, long long g0, long long total,
                                           int lay, unsigned t, unsigned r, int p,
                                           WfKey x[WF_BT_E]) {
    const long long v0 = g0 + wf_lane(lay, 0, t, r, p);
    bool vec = lay == 0 && v0 + WF_BT_E <= total;
#pragma unroll
    for (int c = 0; c < 4; ++c) vec = vec && wf_aligned16(L.in[c] + v0);
    int v[4][WF_BT_E];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        if (vec) {
#pragma unroll
            for (int q = 0; q < WF_BT_E; q += 4) {
                const int4 a = *reinterpret_cast<const int4*>(L.in[c] + v0 + q);
                v[c][q] = a.x; v[c][q + 1] = a.y; v[c][q + 2] = a.z; v[c][q + 3] = a.w;
            }
        } else {
#pragma unroll
            for (int e = 0; e < WF_BT_E; ++e) {
                const long long g = g0 + wf_lane(lay, e, t, r, p);
                v[c][e] = g < total ? L.in[c][g] : 0;
            }
        }
    }
#pragma unroll
    for (int e = 0; e < WF_BT_E; ++e) x[e] = wf_pack(v[0][e], v[1][e], v[2][e], v[3][e]);
}

// The registers of layout G0 to the lanes g0 + (span lane) below `total`.
__device__ __forceinline__ void wf_bt_store(const WfLanes& L, long long g0, long long total,
                                            unsigned t, unsigned r,
                                            const WfKey x[WF_BT_E]) {
    const long long v0 = g0 + wf_lane(0, 0, t, r, 0);
    int v[4][WF_BT_E];
#pragma unroll
    for (int e = 0; e < WF_BT_E; ++e) wf_unpack(x[e], v[0][e], v[1][e], v[2][e], v[3][e]);
    bool vec = v0 + WF_BT_E <= total;
#pragma unroll
    for (int c = 0; c < 4; ++c) vec = vec && wf_aligned16(L.out[c] + v0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        if (vec) {
#pragma unroll
            for (int q = 0; q < WF_BT_E; q += 4)
                *reinterpret_cast<int4*>(L.out[c] + v0 + q) =
                    make_int4(v[c][q], v[c][q + 1], v[c][q + 2], v[c][q + 3]);
        } else {
#pragma unroll
            for (int e = 0; e < WF_BT_E; ++e)
                if (v0 + e < total) L.out[c][v0 + e] = v[c][e];
        }
    }
}

// One substage in registers: register bit R of layout lay (R = 0, 1, 2),
// four compare-exchanges a thread, no synchronisation. i0 = span0 | lane
// of register 0 and rk = (n - 1) & k give the direction bit (ascending iff
// bit k of the lane's index in its row is clear); s is the register bits'
// first lane bit.
template <int R>
__device__ __forceinline__ void wf_bt_sub(WfKey x[WF_BT_E], unsigned i0, int s,
                                          unsigned rk) {
    constexpr int M = 1 << R;
    const unsigned lr = i0 & rk;
#pragma unroll
    for (int e = 0; e < WF_BT_E; ++e) {
        if (e & M) continue;
        const bool up = (lr | (((unsigned)e << s) & rk)) == 0;
        const WfKey a = x[e], b = x[e | M];
        // equal keys are equal bits, so swapping them changes nothing
        const bool swap = wf_key_lt(b, a) == up;
        x[e] = wf_sel(swap, a, b);
        x[e | M] = wf_sel(swap, b, a);
    }
}

// Stages k_first .. k_last (doubling) of the lanes of one cluster, each
// stage's substages from min(k/2, d_first) down to 1. CTA b holds the lanes
// [4096 b, 4096 b + 4096) of the flat [R * n] array in G layouts; a
// cluster's CTAs hold one aligned span of a row (or, for n <= 4096, one CTA
// holds 4096 / n rows). Every substage runs in registers. Between substages
// of different layouts the registers change layout through shared memory:
// between local layouts within the CTA (__syncthreads), to or from X across
// the cluster, each CTA writing its own shared memory and reading its new
// registers from the CTAs that hold them (distributed shared memory, after
// a cluster.sync). Two CTAs fit on an SM (64 registers a thread, 2 x 64 KB
// of shared memory).
__global__ void __launch_bounds__(WF_BT_THREADS, 2)
wf_bitonic_cluster(WfLanes L, long long total, unsigned n, unsigned k_first,
                   unsigned k_last, unsigned d_first) {
    extern __shared__ __align__(16) unsigned char wf_bt_raw[];
    WfKey* sm = reinterpret_cast<WfKey*>(wf_bt_raw);
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned C = cluster.num_blocks(), r = cluster.block_rank(), t = threadIdx.x;
    const int p = WF_BT_LOG_SHARE + (31 - __clz((int)C)) - WF_BT_RB;   // X's first bit
    const long long g0 = ((long long)blockIdx.x - r) * WF_BT_SHARE;   // the span's lane 0
    const unsigned rm = n - 1;
    const unsigned span0 = (unsigned)g0 & rm;    // the span's first lane in its row
    const unsigned first = (k_first >> 1) < d_first ? (k_first >> 1) : d_first;
    const int b0 = 31 - __clz((int)first);
    int lay = C > 1 && b0 >= p ? WF_BT_X : b0 / WF_BT_RB;
    WfKey x[WF_BT_E];
    wf_bt_load(L, g0, total, lay, t, r, p, x);
    bool remote = false;        // other CTAs may still read this CTA's shared memory

    for (unsigned k = k_first; k <= k_last; k <<= 1) {
        const unsigned rk = rm & k;
        for (unsigned d = (k >> 1) < d_first ? (k >> 1) : d_first; d >= 1; d >>= 1) {
            const int b = 31 - __clz((int)d);           // the stride's span-lane bit
            const int to = C > 1 && b >= p ? WF_BT_X : b / WF_BT_RB;
            if (to != lay) {                            // change layout
                if (remote) cluster.sync(); else __syncthreads();
#pragma unroll
                for (int e = 0; e < WF_BT_E; ++e) {
                    unsigned owner, idx;
                    wf_home(lay, wf_lane(lay, e, t, r, p), p, C - 1, owner, idx);
                    sm[wf_slot(idx)] = x[e];
                }
                if (lay == WF_BT_X || to == WF_BT_X) {  // across the cluster
                    cluster.sync();
#pragma unroll
                    for (int e = 0; e < WF_BT_E; ++e) {
                        unsigned owner, idx;
                        wf_home(lay, wf_lane(to, e, t, r, p), p, C - 1, owner, idx);
                        x[e] = wf_ld_cluster(wf_peer_smem(sm, owner) + 16 * wf_slot(idx));
                    }
                    remote = true;
                } else {
                    __syncthreads();
#pragma unroll
                    for (int e = 0; e < WF_BT_E; ++e)
                        x[e] = sm[wf_slot(wf_lane(to, e, t, r, p) & (WF_BT_SHARE - 1))];
                    remote = false;
                }
                lay = to;
            }
            const int s = lay == WF_BT_X ? p : WF_BT_RB * lay;
            const unsigned i0 = span0 | wf_lane(lay, 0, t, r, p);
            switch (b - s) {
                case 0: wf_bt_sub<0>(x, i0, s, rk); break;
                case 1: wf_bt_sub<1>(x, i0, s, rk); break;
                default: wf_bt_sub<2>(x, i0, s, rk); break;
            }
        }
    }
    if (remote) cluster.sync();        // other CTAs finish reading before this one exits
    wf_bt_store(L, g0, total, t, r, x);    // every launch ends with d = 1, in G0
}

// One stride-d substage of stage k over [R, n], one thread per pair, for
// strides of a cluster's span or more.
__global__ void wf_bitonic_global(WfLanes L, long long pairs, int log_n, long long k,
                                  long long d, int log_d) {
    const long long half_mask = (1LL << (log_n - 1)) - 1;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < pairs;
         p += stride) {
        const long long row = p >> (log_n - 1);
        const long long q = p & half_mask;
        const long long i = ((q >> log_d) << (log_d + 1)) | (q & (d - 1));
        const long long ai = (row << log_n) + i, aj = ai + d;
        const WfKey a = wf_pack(L.in[0][ai], L.in[1][ai], L.in[2][ai], L.in[3][ai]);
        const WfKey b = wf_pack(L.in[0][aj], L.in[1][aj], L.in[2][aj], L.in[3][aj]);
        const bool swap = ((i & k) == 0) ? wf_key_lt(b, a) : wf_key_lt(a, b);
        int lo[4], hi[4];
        wf_unpack(wf_sel(swap, a, b), lo[0], lo[1], lo[2], lo[3]);
        wf_unpack(wf_sel(swap, b, a), hi[0], hi[1], hi[2], hi[3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) { L.out[c][ai] = lo[c]; L.out[c][aj] = hi[c]; }
    }
}

static int wf_log2(long long v) {
    int r = 0;
    while ((1LL << r) < v) ++r;
    return r;
}

static int wf_bt_cluster_max = 0;        // 0: not yet asked
static int wf_bt_active[WF_BT_MAX_CLUSTER + 1];   // clusters of each size at once

static cudaLaunchConfig_t wf_bt_config(unsigned blocks, int cluster, cudaStream_t st,
                                       cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(WF_BT_THREADS);
    cfg.dynamicSmemBytes = WF_BT_SMEM;
    cfg.stream = st;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Opt the kernel into 64 KB of shared memory and find the largest cluster
// (8, 4, 2 or 1 CTAs) that the card schedules; an error if none. Once a
// process (std::call_once: stage threads may make their first call at once);
// every later call returns the first one's result.
static int wf_bt_setup_once() {
    cudaError_t e = cudaFuncSetAttribute(
        wf_bitonic_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, WF_BT_SMEM);
    if (e != cudaSuccess) return (int)e;
    for (int c = WF_BT_MAX_CLUSTER; c >= 1; c >>= 1) {
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg = wf_bt_config((unsigned)c, c, 0, &attr);
        int active = 0;
        e = cudaOccupancyMaxActiveClusters(&active, (void*)wf_bitonic_cluster, &cfg);
        if (e != cudaSuccess) cudaGetLastError();   // a refused size: try smaller ones
        wf_bt_active[c] = e == cudaSuccess ? active : 0;
        if (wf_bt_active[c] > 0 && !wf_bt_cluster_max) wf_bt_cluster_max = c;
    }
    if (wf_bt_cluster_max) return (int)cudaSuccess;
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
}

static int wf_bt_setup() {
    static std::once_flag once;
    static int rc = 0;
    std::call_once(once, [] { rc = wf_bt_setup_once(); });
    return rc;
}

// CTAs of one cluster and lanes of one cluster's span, for rows of n lanes
static void wf_bt_geometry(long long n, int& cluster, long long& span) {
    const long long cap = (long long)wf_bt_cluster_max * WF_BT_SHARE;
    span = n < cap ? n : cap;
    cluster = n <= WF_BT_SHARE ? 1 : (int)(span / WF_BT_SHARE);
}

static bool wf_bt_bad(long long R, long long n) {
    return n < 2 || (n & (n - 1)) || n > (1LL << 30) || R < 1 ||
           (R * n + WF_BT_SHARE - 1) / WF_BT_SHARE > 0x7fffffffLL;
}

// The cluster size, the clusters of that size the card holds at once, and
// the number of CUDA launches of one network call on rows of n lanes
// (sort != 0: the sort, 0: the merge).
WF_EXPORT int wf_bitonic_plan(long long n, int sort, int* cluster, int* active,
                              int* launches) {
    if (wf_bt_bad(1, n)) return (int)cudaErrorInvalidValue;
    const int e = wf_bt_setup();
    if (e) return e;
    long long span;
    wf_bt_geometry(n, *cluster, span);
    *active = wf_bt_active[*cluster];
    int count = sort ? 1 : 0;
    for (long long k = sort ? 2 * span : n; k <= n; k <<= 1)
        count += 1 + wf_log2(k / span);   // the global passes, then a cluster launch
    *launches = count;
    return (int)cudaSuccess;
}

// in[c], out[c]: int32 [R, n] for c = prim, sec, chan, idx; n = 2^m >= 2.
// sort != 0: the full sort network; 0: the merge network (bitonic input).
// Returns cudaErrorInvalidValue for a bad geometry, else the first CUDA
// error of the setup or the launches.
WF_EXPORT int wf_bitonic_network(const int* in0, const int* in1, const int* in2,
                                 const int* in3, int* out0, int* out1, int* out2,
                                 int* out3, long long R, long long n, int sort,
                                 void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (wf_bt_bad(R, n)) return (int)cudaErrorInvalidValue;
    int e = wf_bt_setup();
    if (e) return e;
    int cluster;
    long long span;
    wf_bt_geometry(n, cluster, span);
    const long long total = R * n;
    const unsigned blocks = (unsigned)((total + WF_BT_SHARE - 1) / WF_BT_SHARE);
    const long long pairs = total / 2;
    const int log_n = wf_log2(n);
    const int gblocks = wf_blocks(pairs, 256, 2, WF_SMS * 32);
    WfLanes first = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
    WfLanes inplace = {{out0, out1, out2, out3}, {out0, out1, out2, out3}};
    bool started = false;
    auto lanes = [&]() { WfLanes l = started ? inplace : first; started = true; return l; };
    auto cluster_launch = [&](long long k_first, long long k_last) -> int {
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg = wf_bt_config(blocks, cluster, st, &attr);
        cudaError_t r = cudaLaunchKernelEx(&cfg, wf_bitonic_cluster, lanes(), total,
                                           (unsigned)n, (unsigned)k_first,
                                           (unsigned)k_last, (unsigned)(span / 2));
        return (int)(r != cudaSuccess ? r : cudaGetLastError());
    };

    long long k0 = n;                      // the merge network is the last stage alone
    if (sort) {                            // stages 2 .. span inside each cluster
        if ((e = cluster_launch(2, span))) return e;
        k0 = 2 * span;
    }
    for (long long k = k0; k <= n; k <<= 1) {
        for (long long d = k / 2; d >= span; d >>= 1) {
            wf_bitonic_global<<<gblocks, 256, 0, st>>>(lanes(), pairs, log_n, k, d,
                                                       wf_log2(d));
            if ((e = (int)cudaGetLastError())) return e;
        }
        if ((e = cluster_launch(k, k))) return e;
    }
    return (int)cudaGetLastError();
}
