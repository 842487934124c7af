// The cold tier's key index: open addressing over int64 keys, for the port's
// HostStore (windflow_tpu_torch/state/host_store.py).
//
// The store keeps its rows in columns (key, live, the (m0, m1, m2) meta
// triplet, one array per value column, and a next-row link per row); this
// file keeps the index from key to row and does the per-row work of the
// store's writes and probes in one C pass each. The index is a table of
// 2^lg slots, each (key, head row, tail row), linear probing from the slot
// `(uint64)key * 0x9E3779B97F4A7C15 >> (64 - lg)` (unsigned, so a negative
// key hashes like any other); a slot whose head row is -1 is empty. A unique
// store has one row a key; a multimap store chains a key's rows through the
// next-row links in append order (head to tail). The store keeps the table
// at most half full. Deletion shifts the following run back, so no slot is
// ever a tombstone.
//
// On the card the index's key and head arrays, the meta and the value
// columns live in pinned, mapped host memory, and the kernel
// windflow_tpu_torch/ops/csrc/cold_probe.cu reads them with the same hash
// and probe order: the two must stay equal.
//
// Plain C ABI, bound with ctypes. All pointers are caller-owned; the caller
// makes room for every row a call may append before the call.

#include <cstdint>

namespace {

inline uint64_t home(int64_t key, int lg) {
    return (static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull) >> (64 - lg);
}

// slot holding key, or -1
inline int64_t find(const int64_t* ikey, const int64_t* irow, int lg, int64_t key) {
    const uint64_t mask = (1ull << lg) - 1;
    for (uint64_t s = home(key, lg);; s = (s + 1) & mask) {
        if (irow[s] < 0) return -1;
        if (ikey[s] == key) return static_cast<int64_t>(s);
    }
}

// first empty slot on key's probe path (the key is known to be absent)
inline uint64_t free_slot(const int64_t* irow, int lg, int64_t key) {
    const uint64_t mask = (1ull << lg) - 1;
    uint64_t s = home(key, lg);
    while (irow[s] >= 0) s = (s + 1) & mask;
    return s;
}

// link row as the newest row of key (a new slot, or the tail of its chain)
inline void link_row(int64_t* ikey, int64_t* irow, int64_t* itail, int lg,
                     int64_t* nxt, int64_t key, int64_t row) {
    nxt[row] = -1;
    int64_t s = find(ikey, irow, lg, key);
    if (s < 0) {
        uint64_t f = free_slot(irow, lg, key);
        ikey[f] = key;
        irow[f] = row;
        itail[f] = row;
    } else {
        nxt[itail[s]] = row;
        itail[s] = row;
    }
}

inline int64_t append_row(int64_t* skey, uint8_t* live, int64_t* meta, int64_t* n,
                          int64_t key, int64_t a, int64_t b, int64_t c) {
    const int64_t row = (*n)++;
    skey[row] = key;
    live[row] = 1;
    meta[3 * row] = a;
    meta[3 * row + 1] = b;
    meta[3 * row + 2] = c;
    return row;
}

}  // namespace

extern "C" {

// Unique store write, last writer wins by the (m0, m1, m2) triplet: a new key
// appends a row; an existing row takes the lane when its meta is <= the
// lane's (equal meta applies again). Lanes apply in order. dest[i] is the row
// lane i wrote (its value columns are the caller's to copy), -1 if it did not
// apply. Returns the number of lanes applied.
int64_t wf_hs_upsert(int64_t* ikey, int64_t* irow, int64_t* itail, int lg,
                     int64_t* skey, uint8_t* live, int64_t* meta, int64_t* nxt,
                     int64_t* n, const int64_t* keys, const int64_t* m0,
                     const int64_t* m1, const int64_t* m2, const uint8_t* ok,
                     int64_t r, int64_t* dest) {
    int64_t applied = 0;
    for (int64_t i = 0; i < r; ++i) {
        dest[i] = -1;
        if (!ok[i]) continue;
        const int64_t s = find(ikey, irow, lg, keys[i]);
        if (s < 0) {
            const int64_t row = append_row(skey, live, meta, n, keys[i], m0[i], m1[i], m2[i]);
            link_row(ikey, irow, itail, lg, nxt, keys[i], row);
            dest[i] = row;
            ++applied;
            continue;
        }
        const int64_t j = irow[s];
        int64_t* mj = meta + 3 * j;
        const bool le = mj[0] != m0[i] ? mj[0] < m0[i]
                        : mj[1] != m1[i] ? mj[1] < m1[i] : mj[2] <= m2[i];
        if (le) {
            mj[0] = m0[i];
            mj[1] = m1[i];
            mj[2] = m2[i];
            dest[i] = j;
            ++applied;
        }
    }
    return applied;
}

// Multimap store write: every ok lane appends a row at the tail of its key's
// chain. dest[i] is the row, -1 for a lane not ok. Returns the rows appended.
int64_t wf_hs_append(int64_t* ikey, int64_t* irow, int64_t* itail, int lg,
                     int64_t* skey, uint8_t* live, int64_t* meta, int64_t* nxt,
                     int64_t* n, const int64_t* keys, const int64_t* m0,
                     const int64_t* m1, const int64_t* m2, const uint8_t* ok,
                     int64_t r, int64_t* dest) {
    int64_t added = 0;
    for (int64_t i = 0; i < r; ++i) {
        dest[i] = -1;
        if (!ok[i]) continue;
        const int64_t row = append_row(skey, live, meta, n, keys[i], m0[i], m1[i], m2[i]);
        link_row(ikey, irow, itail, lg, nxt, keys[i], row);
        dest[i] = row;
        ++added;
    }
    return added;
}

// Head row of each wanted key (-1: not wanted or absent). Returns the lanes
// found.
int64_t wf_hs_lookup(const int64_t* ikey, const int64_t* irow, int lg,
                     const int64_t* keys, const uint8_t* want, int64_t r,
                     int64_t* out_row) {
    int64_t found = 0;
    for (int64_t i = 0; i < r; ++i) {
        out_row[i] = -1;
        if (!want[i]) continue;
        const int64_t s = find(ikey, irow, lg, keys[i]);
        if (s >= 0) {
            out_row[i] = irow[s];
            ++found;
        }
    }
    return found;
}

// The first m rows of each wanted key's chain, oldest first: out_rows[i * m
// + t], -1 past the chain's end.
void wf_hs_fetch(const int64_t* ikey, const int64_t* irow, int lg, const int64_t* nxt,
                 const int64_t* keys, const uint8_t* want, int64_t r, int64_t m,
                 int64_t* out_rows) {
    for (int64_t i = 0; i < r; ++i) {
        int64_t row = -1;
        if (want[i]) {
            const int64_t s = find(ikey, irow, lg, keys[i]);
            if (s >= 0) row = irow[s];
        }
        for (int64_t t = 0; t < m; ++t) {
            out_rows[i * m + t] = row;
            if (row >= 0) row = nxt[row];
        }
    }
}

// Remove each key from the index (backward-shift deletion); rows[i] is the
// key's head row, -1 if it was absent. The rows themselves stay; the caller
// marks them dead.
void wf_hs_remove(int64_t* ikey, int64_t* irow, int64_t* itail, int lg,
                  const int64_t* keys, int64_t r, int64_t* rows) {
    const uint64_t mask = (1ull << lg) - 1;
    for (int64_t q = 0; q < r; ++q) {
        const int64_t s0 = find(ikey, irow, lg, keys[q]);
        rows[q] = s0 < 0 ? -1 : irow[s0];
        if (s0 < 0) continue;
        uint64_t i = static_cast<uint64_t>(s0);
        irow[i] = -1;
        for (uint64_t j = (i + 1) & mask; irow[j] >= 0; j = (j + 1) & mask) {
            const uint64_t h = home(ikey[j], lg);
            // the entry at j may fill the hole at i unless its home lies
            // cyclically in (i, j]
            const bool stays = i <= j ? (h > i && h <= j) : (h > i || h <= j);
            if (stays) continue;
            ikey[i] = ikey[j];
            irow[i] = irow[j];
            itail[i] = itail[j];
            irow[j] = -1;
            i = j;
        }
    }
}

// Rebuild the index from the live rows in ascending row order (a multimap
// key's chain then runs oldest row first).
void wf_hs_reindex(int64_t* ikey, int64_t* irow, int64_t* itail, int lg,
                   const int64_t* skey, const uint8_t* live, int64_t* nxt, int64_t n) {
    const uint64_t slots = 1ull << lg;
    for (uint64_t s = 0; s < slots; ++s) irow[s] = -1;
    for (int64_t i = 0; i < n; ++i)
        if (live[i]) link_row(ikey, irow, itail, lg, nxt, skey[i], i);
}

}  // extern "C"
