// Measurement probes for chip_smoke.py's split of K1's and K3's time. No TPU
// kernel, and no path of the port launches them: chip_smoke.py builds this
// file on its own and loads it with ctypes. It includes nothing of
// ops/csrc, so the same file also splits an older tree's kernels.
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
