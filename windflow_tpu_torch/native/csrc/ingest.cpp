// Native host ingest/egress: AoS record <-> SoA column packing and key hashing.
//
// Reference lineage: the reference's per-tuple host data path — Source allocating a
// tuple per record (wf/source.hpp:184), Shipper copying per push (wf/shipper.hpp:87),
// Standard_Emitter hashing every key (wf/standard_emitter.hpp:88-99, std::hash) —
// is the cost the micro-batch design removes. This module is that path's native
// counterpart on the host (the port's own copy of windflow_tpu/native/ingest.cpp):
// records arriving AoS (network/disk framing) are transposed to SoA columns in one
// C pass, and string/integer keys are hashed to key slots with the exact
// arithmetic of windflow_tpu_torch.batch.hash_key_to_slot (32-bit FNV-1a for
// strings, Knuth uint64 multiply for ints), so host-ingested and device-generated
// streams agree on key routing bit-for-bit.
//
// Plain C ABI, bound with ctypes. All pointers are caller-owned; no allocation
// happens in this module.

#include <cstdint>
#include <cstring>

extern "C" {

// AoS -> SoA: scatter n_fields interleaved fields of each of n records into
// contiguous per-field columns. src is the record buffer (record i at
// src + i*stride); field f occupies sizes[f] bytes at offsets[f] within a record
// and lands in dst[f] + i*sizes[f]. Fast paths for the power-of-two widths cover
// every numeric dtype; memcpy handles packed structs/strings.
void wf_unpack_records(const char* src, uint64_t n, uint64_t stride,
                       uint32_t n_fields, const uint64_t* offsets,
                       const uint64_t* sizes, char** dst) {
    for (uint32_t f = 0; f < n_fields; ++f) {
        const char* s = src + offsets[f];
        char* d = dst[f];
        const uint64_t w = sizes[f];
        switch (w) {
        case 1:
            for (uint64_t i = 0; i < n; ++i) d[i] = s[i * stride];
            break;
        case 2:
            for (uint64_t i = 0; i < n; ++i)
                std::memcpy(d + i * 2, s + i * stride, 2);
            break;
        case 4:
            for (uint64_t i = 0; i < n; ++i)
                std::memcpy(d + i * 4, s + i * stride, 4);
            break;
        case 8:
            for (uint64_t i = 0; i < n; ++i)
                std::memcpy(d + i * 8, s + i * stride, 8);
            break;
        default:
            for (uint64_t i = 0; i < n; ++i)
                std::memcpy(d + i * w, s + i * stride, w);
        }
    }
}

// SoA -> AoS (egress symmetric of the above: sinks emitting framed records).
void wf_pack_records(char* dst, uint64_t n, uint64_t stride, uint32_t n_fields,
                     const uint64_t* offsets, const uint64_t* sizes,
                     const char* const* src) {
    for (uint32_t f = 0; f < n_fields; ++f) {
        char* d = dst + offsets[f];
        const char* s = src[f];
        const uint64_t w = sizes[f];
        for (uint64_t i = 0; i < n; ++i)
            std::memcpy(d + i * stride, s + i * w, w);
    }
}

// 32-bit FNV-1a over [offsets[i], offsets[i+1]) byte ranges, modulo num_slots —
// bit-identical to windflow_tpu_torch.batch._fnv1a / hash_key_to_slot for str/bytes.
void wf_hash_str_keys(const char* buf, const int64_t* offsets, uint64_t n,
                      uint32_t num_slots, int32_t* out) {
    for (uint64_t i = 0; i < n; ++i) {
        uint32_t h = 2166136261u;
        for (int64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
            h ^= static_cast<unsigned char>(buf[j]);
            h *= 16777619u;
        }
        out[i] = static_cast<int32_t>(h % num_slots);
    }
}

// Fixed-width string keys (numpy 'S<w>' column, NUL-padded): hash each record's
// value with TRAILING NULs stripped but embedded NULs kept — numpy's own
// bytes-item semantics, so binary keys route identically to the Python fallback.
// AoS form: key i at buf + i*stride.
void wf_hash_fixed_str_keys(const char* buf, uint64_t n, uint64_t stride,
                            uint64_t width, uint32_t num_slots, int32_t* out) {
    for (uint64_t i = 0; i < n; ++i) {
        const char* s = buf + i * stride;
        uint64_t len = width;
        while (len > 0 && s[len - 1] == '\0') --len;
        uint32_t h = 2166136261u;
        for (uint64_t j = 0; j < len; ++j) {
            h ^= static_cast<unsigned char>(s[j]);
            h *= 16777619u;
        }
        out[i] = static_cast<int32_t>(h % num_slots);
    }
}

// Knuth multiplicative hash in uint64 wraparound — matches the integer branch of
// hash_key_to_slot ((k * 2654435761) mod 2^64 mod num_slots).
void wf_hash_int_keys(const int64_t* keys, uint64_t n, uint32_t num_slots,
                      int32_t* out) {
    for (uint64_t i = 0; i < n; ++i) {
        uint64_t k = static_cast<uint64_t>(keys[i]) * 2654435761ull;
        out[i] = static_cast<int32_t>(k % num_slots);
    }
}

}  // extern "C"
