// Native host runtime substrate: lock-free SPSC ring queues + thread pinning.
//
// The port's own copy of windflow_tpu/native/spsc_queue.cpp. This is the
// FastFlow role in the reference (L0: ff_node threads connected by lock-free
// SPSC queues, SURVEY §1; wf/windflow.hpp includes <ff/ff.hpp>): the stage
// threads of the threaded drivers exchange *micro-batch handles* (opaque 64-bit
// tokens naming batches on the card) through bounded SPSC rings, with the
// backpressure semantics of the reference's FF_BOUNDED_BUFFER queues. The card's
// work is launched by the stage that owns the batch, on that stage's CUDA stream;
// the queue only moves handles, so the native layer is allocation-free and
// wait-free on the fast path.
//
// Plain C ABI, bound with ctypes (windflow_tpu_torch/native/__init__.py).
//
// Design notes (mirroring FastFlow's buffer):
//  - capacity rounded to a power of two; index wrap via mask
//  - head/tail on separate cache lines to avoid false sharing
//  - push/pop are wait-free; *_spin variants bound the spin then yield
//    (BLOCKING_MODE-equivalent behavior), and past kYieldRounds rounds they
//    sleep kNapMicros between tries: a stage blocked for longer than about
//    a tenth of a millisecond stops taking a core from the stage threads
//    that work (whose every CUDA call slows several-fold beside spinners)

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <ctime>
#include <thread>

#if defined(__linux__)
#include <pthread.h>
#include <sched.h>
#endif

namespace {

constexpr size_t kCacheLine = 64;

struct alignas(kCacheLine) SpscQueue {
    uint64_t* buf;
    uint64_t mask;
    alignas(kCacheLine) std::atomic<uint64_t> head;  // consumer position
    alignas(kCacheLine) std::atomic<uint64_t> tail;  // producer position

    explicit SpscQueue(uint64_t capacity_pow2)
        : buf(static_cast<uint64_t*>(std::calloc(capacity_pow2, sizeof(uint64_t)))),
          mask(capacity_pow2 - 1), head(0), tail(0) {}
    ~SpscQueue() { std::free(buf); }
};

// rounds of `spin` tries that yield between them before a blocked end naps
constexpr uint64_t kYieldRounds = 64;
// a nap between later rounds, and what one counts for against max_yields
// (about the yields that fit in it), so a pop's bound stays a few ms
constexpr int64_t kNapMicros = 50;
constexpr uint64_t kNapRounds = 16;

// Wait between two rounds of tries; returns the rounds the wait counts for.
uint64_t wait_round(uint64_t round) {
    if (round < kYieldRounds) {
        std::this_thread::yield();
        return 1;
    }
    std::this_thread::sleep_for(std::chrono::microseconds(kNapMicros));
    return kNapRounds;
}

uint64_t next_pow2(uint64_t n) {
    uint64_t p = 1;
    while (p < n) p <<= 1;
    return p;
}

}  // namespace

extern "C" {

void* wf_queue_create(uint64_t capacity) {
    return new SpscQueue(next_pow2(capacity < 2 ? 2 : capacity));
}

void wf_queue_destroy(void* q) { delete static_cast<SpscQueue*>(q); }

// Wait-free push; returns 0 when the ring is full (bounded backpressure,
// FF_BOUNDED_BUFFER semantics).
int wf_queue_push(void* qp, uint64_t item) {
    auto* q = static_cast<SpscQueue*>(qp);
    const uint64_t t = q->tail.load(std::memory_order_relaxed);
    if (t - q->head.load(std::memory_order_acquire) > q->mask) return 0;
    q->buf[t & q->mask] = item;
    q->tail.store(t + 1, std::memory_order_release);
    return 1;
}

// Wait-free pop; returns 0 when empty (item untouched).
int wf_queue_pop(void* qp, uint64_t* item) {
    auto* q = static_cast<SpscQueue*>(qp);
    const uint64_t h = q->head.load(std::memory_order_relaxed);
    if (h == q->tail.load(std::memory_order_acquire)) return 0;
    *item = q->buf[h & q->mask];
    q->head.store(h + 1, std::memory_order_release);
    return 1;
}

// Spinning variants: spin `spin` times, then wait (wait_round: yield, later
// nap) between retries until success (push) or until `max_yields` yields' worth
// of waiting has elapsed (pop; returns 0 on timeout so callers can check
// shutdown flags). GIL is released by ctypes for the duration.
int wf_queue_push_spin(void* qp, uint64_t item, uint64_t spin) {
    for (uint64_t round = 0;; ++round) {
        for (uint64_t i = 0; i < spin; ++i)
            if (wf_queue_push(qp, item)) return 1;
        wait_round(round);
    }
}

int wf_queue_pop_spin(void* qp, uint64_t* item, uint64_t spin, uint64_t max_yields) {
    for (uint64_t round = 0, y = 0; y <= max_yields; ++round) {
        for (uint64_t i = 0; i < spin; ++i)
            if (wf_queue_pop(qp, item)) return 1;
        y += wait_round(round);
    }
    return 0;
}

uint64_t wf_queue_size(void* qp) {
    auto* q = static_cast<SpscQueue*>(qp);
    return q->tail.load(std::memory_order_acquire) -
           q->head.load(std::memory_order_acquire);
}

// Pin the calling thread to a core (the reference pins one thread per ff_node
// unless NO_DEFAULT_MAPPING). Returns 0 on success.
int wf_pin_thread(int core) {
#if defined(__linux__)
    cpu_set_t set;
    CPU_ZERO(&set);
    CPU_SET(core, &set);
    return pthread_setaffinity_np(pthread_self(), sizeof(set), &set);
#else
    (void)core;
    return -1;
#endif
}

int wf_hardware_concurrency() {
    return static_cast<int>(std::thread::hardware_concurrency());
}

// Self-benchmark of the raw ring (no Python in the loop): a producer and a
// consumer thread move n tokens; returns tokens/second. This is the number
// FastFlow's lock-free queues compete on (reference L0).
//
// The threads are not pinned: fixed cores would ignore the process's allowed
// CPUs and put every concurrent caller's pair on the same two cores. The
// consumer times n/16 tokens at a time and the fastest slice gives the rate.
// A slice's time is the CPU time both threads spent on it (each reads its
// own thread clock; the producer publishes its reading every 256 tokens), so
// time the scheduler gave to other processes' threads is not counted: a
// loaded host does not read as a slow ring. Two threads that run at once on
// two cores both count, so the rate is at most the wall-clock rate of an
// unloaded run. Where the thread clocks fail or did not advance over a slice
// (a clock coarser than the slice), the slice's wall-clock time counts.
static bool thread_seconds(double* s) {
    timespec ts;
    if (clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts) != 0) return false;
    *s = ts.tv_sec + ts.tv_nsec * 1e-9;
    return true;
}

double wf_queue_selfbench(uint64_t n, uint64_t capacity) {
    void* q = wf_queue_create(capacity);
    // short spins: on a single-core host long spin loops burn whole scheduler
    // quanta against the peer thread; on multi-core the difference is noise
    bool multi = std::thread::hardware_concurrency() >= 2;
    uint64_t spin = multi ? (1 << 12) : 64;
    const uint64_t per = n >= 16 ? n / 16 : 1;
    std::atomic<double> prod_cpu{-1.0};     // the producer's clock, -1: failed
    std::thread prod([&] {
        double s = 0.0;
        for (uint64_t i = 1; i <= n; ++i) {
            if ((i & 255) == 1)
                prod_cpu.store(thread_seconds(&s) ? s : -1.0, std::memory_order_relaxed);
            wf_queue_push_spin(q, i, spin);
        }
    });
    uint64_t sum = 0;
    double best = 0.0;
    std::thread cons([&] {
        uint64_t got = 0, v = 0;
        double c0 = 0.0, c1 = 0.0;
        bool ok0 = thread_seconds(&c0);
        double p0 = prod_cpu.load(std::memory_order_relaxed);
        auto w0 = std::chrono::steady_clock::now();
        while (got < n) {
            if (!wf_queue_pop_spin(q, &v, spin, 1)) continue;
            sum += v;
            if (++got % per != 0) continue;
            auto w1 = std::chrono::steady_clock::now();
            bool ok1 = thread_seconds(&c1);
            double p1 = prod_cpu.load(std::memory_order_relaxed);
            double dt = (c1 - c0) + (p1 - p0);
            if (!(ok0 && ok1 && p0 >= 0.0 && p1 >= 0.0) || !(dt > 0.0))
                dt = std::chrono::duration<double>(w1 - w0).count();
            if (dt > 0.0 && per / dt > best) best = per / dt;
            c0 = c1, p0 = p1, ok0 = ok1, w0 = w1;
        }
    });
    prod.join();
    cons.join();
    wf_queue_destroy(q);
    // defeat dead-code elimination of the consumer sum
    if (sum == 0 && n > 0) return -1.0;
    return best;
}

}  // extern "C"
