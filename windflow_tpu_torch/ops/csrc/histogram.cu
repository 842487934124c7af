// K1 — keyed pane histogram: out[k, floor_mod(pane, P)] += 1 for every valid
// lane whose key k lies in [0, K).
//
// Replaces windflow_tpu/ops/histogram.py::_pallas_fast (the Pallas kernel
// behind keyed_pane_histogram_pallas), and with it the XLA einsum fast path,
// its lax.cond locality check and the _scatter_hist fallback: all of them
// compute this same count, which this kernel gives for any input.
//
// Bound on the H100: bytes. Each lane reads 9 B (key, pane, valid) and the
// [K, P] i32 output is written once (YSB: C = 2^20, K = 100, P = 4096 —
// 9.4 MB in, 1.6 MB out, about 3.3 us at 3.35 TB/s). There is no arithmetic
// to speak of; the risk is contention, because a run of consecutive lanes of
// a time-ordered stream hits only a couple of panes and at most K keys.
//
// Design: one global int32 atomicAdd per counted lane, grid-stride over C.
// The TPU kernel needed a chunk-locality precondition so that one-hot matmuls
// could place a [K, L] partial into the ring; atomics need none, and the
// result is exact whatever order they land in. The [K, P] ring (1.6 MB at
// YSB shapes) is 7x what one block's shared memory holds, so there is no
// block-private copy of the whole output; a shared-memory window at a
// block's minimum pane is a later optimisation.
#include "common.cuh"

__global__ void wf_hist_kernel(const int* __restrict__ key,
                               const int* __restrict__ pane,
                               const unsigned char* __restrict__ valid,
                               int* __restrict__ out, long long n, int K, int P) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        if (!valid[i]) continue;
        int k = key[i];
        if (k < 0 || k >= K) continue;
        atomicAdd(out + (long long)k * P + wf_floor_mod(pane[i], P), 1);
    }
}

// out: zeroed int32 [K, P], written on `stream`.
WF_EXPORT int wf_keyed_pane_histogram(const int* key, const int* pane,
                                      const unsigned char* valid, int* out,
                                      long long n, int K, int P, void* stream) {
    const int threads = 256;
    int blocks = wf_blocks(n, threads, 4, WF_SMS * 16);
    wf_hist_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        key, pane, valid, out, n, K, P);
    return (int)cudaGetLastError();
}
