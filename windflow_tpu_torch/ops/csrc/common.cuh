// Shared helpers of the port's hand-written kernels (plain C interfaces,
// built with nvcc for sm_90a and bound with ctypes; see ../cuda.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WF_EXPORT extern "C" __attribute__((visibility("default")))

// H100 SXM: 132 streaming multiprocessors.
constexpr int WF_SMS = 132;

// Blocks for a grid-stride loop over n elements with `threads` threads a
// block, each thread taking about `per_thread` elements, capped at `cap`.
static inline int wf_blocks(long long n, int threads, int per_thread, int cap) {
    long long b = (n + (long long)threads * per_thread - 1) /
                  ((long long)threads * per_thread);
    if (b < 1) b = 1;
    if (b > cap) b = cap;
    return (int)b;
}

// a mod n with the sign of n (n > 0). C's % truncates toward zero
// (-7 % 4 == -3); jnp and torch floor (-7 mod 4 == 1), and the JAX package
// places negative panes by the floored result.
__device__ __forceinline__ int wf_floor_mod(int a, int n) {
    int r = a % n;
    return r < 0 ? r + n : r;
}
