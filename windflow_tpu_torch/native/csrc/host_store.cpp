// The cold tier's key index: open addressing over int64 keys, for the port's
// HostStore (windflow_tpu_torch/state/host_store.py).
//
// The store keeps its rows in columns (key, live, the (m0, m1, m2) meta
// triplet) and in records, one every `ns` int64 words: a multimap record
// holds the row's next-row link (nxt[row * ns]) and then its value columns;
// a unique record holds the meta's low 32 bits (rmeta[row * 2 * ns + 0..2])
// and then its value columns (a unique key has one row, so it needs no
// link). This file keeps the index from key to row and does the per-row work
// of the store's writes and probes in one C pass each. The index is a table
// of 2^lg 16-byte slots {key, head row} (idx[2 * s], idx[2 * s + 1]) beside a
// tail row a slot (itail[s], which only the host reads), linear probing from
// the slot `(uint64)key * 0x9E3779B97F4A7C15 >> (64 - lg)` (unsigned, so a
// negative key hashes like any other); a slot whose head row is -1 is empty.
// A multimap store chains a key's rows through the next-row links in append
// order (head to tail). The store keeps the table at most half full.
// Deletion shifts the following run back, so no slot is ever a tombstone.
//
// On the card the store keeps a copy of the slots in device memory, which
// the kernels of windflow_tpu_torch/ops/csrc/cold_probe.cu walk with the
// same hash and probe order (the two must stay equal). Every pass that
// writes slots appends each slot it writes to the caller's touched list
// (touched[*nt], at most cap entries; *nt = -1 once it would overflow), so
// the caller copies just those slots across; a rebuild writes them all.
// An append to an existing chain writes only the tail, which the card never
// reads.
//
// Plain C ABI, bound with ctypes. All pointers are caller-owned; the caller
// makes room for every row a call may append before the call. nxt is null
// for a unique store, rmeta for a multimap store, touched when the caller
// keeps no copy of the slots.

#include <cstdint>

namespace {

inline uint64_t home(int64_t key, int lg) {
    return (static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull) >> (64 - lg);
}

// slot holding key, or -1
inline int64_t find(const int64_t* idx, int lg, int64_t key) {
    const uint64_t mask = (1ull << lg) - 1;
    for (uint64_t s = home(key, lg);; s = (s + 1) & mask) {
        if (idx[2 * s + 1] < 0) return -1;
        if (idx[2 * s] == key) return static_cast<int64_t>(s);
    }
}

// first empty slot on key's probe path (the key is known to be absent)
inline uint64_t free_slot(const int64_t* idx, int lg, int64_t key) {
    const uint64_t mask = (1ull << lg) - 1;
    uint64_t s = home(key, lg);
    while (idx[2 * s + 1] >= 0) s = (s + 1) & mask;
    return s;
}

struct Touched {
    int64_t* list;
    int64_t cap;
    int64_t* nt;
    void add(uint64_t s) const {
        if (!list || *nt < 0) return;
        if (*nt < cap) list[(*nt)++] = static_cast<int64_t>(s);
        else *nt = -1;
    }
};

// link row as the newest row of key: a new slot, or (multimap) the tail of
// its chain; a unique store's index keeps the key's first row
inline void link_row(int64_t* idx, int64_t* itail, int lg, int64_t* nxt, int64_t ns,
                     int64_t key, int64_t row, const Touched& t) {
    if (nxt) nxt[row * ns] = -1;
    int64_t s = find(idx, lg, key);
    if (s < 0) {
        uint64_t f = free_slot(idx, lg, key);
        idx[2 * f] = key;
        idx[2 * f + 1] = row;
        itail[f] = row;
        t.add(f);
    } else if (nxt) {
        nxt[itail[s] * ns] = row;
        itail[s] = row;
    }
}

inline void put_meta(int64_t* meta, int32_t* rmeta, int64_t ns, int64_t row, int64_t a,
                     int64_t b, int64_t c) {
    meta[3 * row] = a;
    meta[3 * row + 1] = b;
    meta[3 * row + 2] = c;
    if (rmeta) {
        int32_t* r = rmeta + row * 2 * ns;
        r[0] = static_cast<int32_t>(a);
        r[1] = static_cast<int32_t>(b);
        r[2] = static_cast<int32_t>(c);
    }
}

inline int64_t append_row(int64_t* skey, uint8_t* live, int64_t* meta, int32_t* rmeta,
                          int64_t ns, int64_t* n, int64_t key, int64_t a, int64_t b,
                          int64_t c) {
    const int64_t row = (*n)++;
    skey[row] = key;
    live[row] = 1;
    put_meta(meta, rmeta, ns, row, a, b, c);
    return row;
}

}  // namespace

extern "C" {

// Unique store write, last writer wins by the (m0, m1, m2) triplet: a new key
// appends a row; an existing row takes the lane when its meta is <= the
// lane's (equal meta applies again). Lanes apply in order. dest[i] is the row
// lane i wrote (its value columns are the caller's to copy), -1 if it did not
// apply. Returns the number of lanes applied.
int64_t wf_hs_upsert(int64_t* idx, int64_t* itail, int lg, int64_t* skey, uint8_t* live,
                     int64_t* meta, int64_t* nxt, int32_t* rmeta, int64_t ns, int64_t* n,
                     const int64_t* keys, const int64_t* m0, const int64_t* m1,
                     const int64_t* m2, const uint8_t* ok, int64_t r, int64_t* dest,
                     int64_t* touched, int64_t cap, int64_t* nt) {
    const Touched t{touched, cap, nt};
    int64_t applied = 0;
    for (int64_t i = 0; i < r; ++i) {
        dest[i] = -1;
        if (!ok[i]) continue;
        const int64_t s = find(idx, lg, keys[i]);
        if (s < 0) {
            const int64_t row = append_row(skey, live, meta, rmeta, ns, n, keys[i], m0[i],
                                           m1[i], m2[i]);
            link_row(idx, itail, lg, nxt, ns, keys[i], row, t);
            dest[i] = row;
            ++applied;
            continue;
        }
        const int64_t j = idx[2 * s + 1];
        const int64_t* mj = meta + 3 * j;
        const bool le = mj[0] != m0[i] ? mj[0] < m0[i]
                        : mj[1] != m1[i] ? mj[1] < m1[i] : mj[2] <= m2[i];
        if (le) {
            put_meta(meta, rmeta, ns, j, m0[i], m1[i], m2[i]);
            dest[i] = j;
            ++applied;
        }
    }
    return applied;
}

// Multimap store write: every ok lane appends a row at the tail of its key's
// chain. dest[i] is the row, -1 for a lane not ok. Returns the rows appended.
int64_t wf_hs_append(int64_t* idx, int64_t* itail, int lg, int64_t* skey, uint8_t* live,
                     int64_t* meta, int64_t* nxt, int32_t* rmeta, int64_t ns, int64_t* n,
                     const int64_t* keys, const int64_t* m0, const int64_t* m1,
                     const int64_t* m2, const uint8_t* ok, int64_t r, int64_t* dest,
                     int64_t* touched, int64_t cap, int64_t* nt) {
    const Touched t{touched, cap, nt};
    int64_t added = 0;
    for (int64_t i = 0; i < r; ++i) {
        dest[i] = -1;
        if (!ok[i]) continue;
        const int64_t row = append_row(skey, live, meta, rmeta, ns, n, keys[i], m0[i], m1[i],
                                       m2[i]);
        link_row(idx, itail, lg, nxt, ns, keys[i], row, t);
        dest[i] = row;
        ++added;
    }
    return added;
}

// Head row of each wanted key (-1: not wanted or absent). Returns the lanes
// found.
int64_t wf_hs_lookup(const int64_t* idx, int lg, const int64_t* keys, const uint8_t* want,
                     int64_t r, int64_t* out_row) {
    int64_t found = 0;
    for (int64_t i = 0; i < r; ++i) {
        out_row[i] = -1;
        if (!want[i]) continue;
        const int64_t s = find(idx, lg, keys[i]);
        if (s >= 0) {
            out_row[i] = idx[2 * s + 1];
            ++found;
        }
    }
    return found;
}

// The first m rows of each wanted key's chain, oldest first: out_rows[i * m
// + t], -1 past the chain's end (a unique store, nxt null: one row a key).
void wf_hs_fetch(const int64_t* idx, int lg, const int64_t* nxt, int64_t ns,
                 const int64_t* keys, const uint8_t* want, int64_t r, int64_t m,
                 int64_t* out_rows) {
    for (int64_t i = 0; i < r; ++i) {
        int64_t row = -1;
        if (want[i]) {
            const int64_t s = find(idx, lg, keys[i]);
            if (s >= 0) row = idx[2 * s + 1];
        }
        for (int64_t t = 0; t < m; ++t) {
            out_rows[i * m + t] = row;
            if (row >= 0) row = nxt ? nxt[row * ns] : -1;
        }
    }
}

// Remove each key from the index (backward-shift deletion); rows[i] is the
// key's head row, -1 if it was absent. The rows themselves stay; the caller
// marks them dead. Every slot emptied or moved into is touched.
void wf_hs_remove(int64_t* idx, int64_t* itail, int lg, const int64_t* keys, int64_t r,
                  int64_t* rows, int64_t* touched, int64_t cap, int64_t* nt) {
    const Touched t{touched, cap, nt};
    const uint64_t mask = (1ull << lg) - 1;
    for (int64_t q = 0; q < r; ++q) {
        const int64_t s0 = find(idx, lg, keys[q]);
        rows[q] = s0 < 0 ? -1 : idx[2 * s0 + 1];
        if (s0 < 0) continue;
        uint64_t i = static_cast<uint64_t>(s0);
        idx[2 * i + 1] = -1;
        t.add(i);
        for (uint64_t j = (i + 1) & mask; idx[2 * j + 1] >= 0; j = (j + 1) & mask) {
            const uint64_t h = home(idx[2 * j], lg);
            // the entry at j may fill the hole at i unless its home lies
            // cyclically in (i, j]
            const bool stays = i <= j ? (h > i && h <= j) : (h > i || h <= j);
            if (stays) continue;
            idx[2 * i] = idx[2 * j];
            idx[2 * i + 1] = idx[2 * j + 1];
            itail[i] = itail[j];
            idx[2 * j + 1] = -1;
            t.add(j);
            i = j;
        }
    }
}

// Rebuild the index from the live rows in ascending row order (a multimap
// key's chain then runs oldest row first). Every slot is written: an empty
// one as {0, -1}.
void wf_hs_reindex(int64_t* idx, int64_t* itail, int lg, const int64_t* skey,
                   const uint8_t* live, int64_t* nxt, int64_t ns, int64_t n) {
    const uint64_t slots = 1ull << lg;
    for (uint64_t s = 0; s < slots; ++s) {
        idx[2 * s] = 0;
        idx[2 * s + 1] = -1;
    }
    const Touched none{nullptr, 0, nullptr};
    for (int64_t i = 0; i < n; ++i)
        if (live[i]) link_row(idx, itail, lg, nxt, ns, skey[i], i, none);
}

}  // extern "C"
