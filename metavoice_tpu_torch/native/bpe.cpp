// Native BPE merge engine.
//
// The reference tokenizes through tiktoken's Rust core
// (fam/quantiser/text/tokenise.py:1-11). This is the equivalent native
// component for this framework: the byte-pair merge hot loop in C++ behind a
// plain C ABI, bound from Python via ctypes (metavoice_tpu_torch/tokenizer.py).
// Pre-tokenization (the regex split) stays host-Python; each piece is a
// short word-like byte string, merged here.
//
// Vocab wire format (little-endian):
//   u32 n_entries, then per entry: u32 rank, u32 len, len bytes.
//
// Built on first use by metavoice_tpu_torch/native/__init__.py:
//   g++ -O2 -std=c++17 -shared -fPIC bpe.cpp -o ../_build/libmvbpe-<hash>.so

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Engine {
    std::unordered_map<std::string, uint32_t> ranks;
};

constexpr uint32_t kNoRank = 0xFFFFFFFFu;

uint32_t lookup(const Engine* e, std::string_view piece) {
    auto it = e->ranks.find(std::string(piece));
    return it == e->ranks.end() ? kNoRank : it->second;
}

}  // namespace

extern "C" {

void* mvbpe_create(const uint8_t* blob, uint64_t len) {
    if (len < 4) return nullptr;
    auto* e = new Engine();
    uint64_t off = 0;
    uint32_t n;
    std::memcpy(&n, blob + off, 4);
    off += 4;
    e->ranks.reserve(n * 2);
    for (uint32_t i = 0; i < n; ++i) {
        if (off + 8 > len) { delete e; return nullptr; }
        uint32_t rank, tok_len;
        std::memcpy(&rank, blob + off, 4);
        std::memcpy(&tok_len, blob + off + 4, 4);
        off += 8;
        if (off + tok_len > len) { delete e; return nullptr; }
        e->ranks.emplace(std::string(reinterpret_cast<const char*>(blob + off), tok_len), rank);
        off += tok_len;
    }
    return e;
}

void mvbpe_destroy(void* handle) { delete static_cast<Engine*>(handle); }

// Greedy lowest-rank-first merge of one pre-tokenized piece.
// Returns the number of tokens written to `out` (capacity must be >= len),
// or -1 if an intermediate part has no rank (caller falls back).
int64_t mvbpe_encode_piece(void* handle, const uint8_t* bytes, uint64_t len,
                           uint32_t* out, uint64_t out_cap) {
    auto* e = static_cast<Engine*>(handle);
    if (len == 0) return 0;
    const char* data = reinterpret_cast<const char*>(bytes);

    // whole piece is a single token?
    {
        uint32_t r = lookup(e, std::string_view(data, len));
        if (r != kNoRank) {
            if (out_cap < 1) return -1;
            out[0] = r;
            return 1;
        }
    }

    // boundaries[i] = start offset of part i; parts are contiguous slices
    std::vector<uint32_t> starts(len);
    std::vector<uint32_t> lens(len, 1);
    for (uint64_t i = 0; i < len; ++i) starts[i] = static_cast<uint32_t>(i);
    uint64_t n_parts = len;

    while (n_parts > 1) {
        uint32_t best_rank = kNoRank;
        uint64_t best_i = 0;
        for (uint64_t i = 0; i + 1 < n_parts; ++i) {
            std::string_view merged(data + starts[i], lens[i] + lens[i + 1]);
            uint32_t r = lookup(e, merged);
            if (r < best_rank) {
                best_rank = r;
                best_i = i;
            }
        }
        if (best_rank == kNoRank) break;
        lens[best_i] += lens[best_i + 1];
        for (uint64_t i = best_i + 1; i + 1 < n_parts; ++i) {
            starts[i] = starts[i + 1];
            lens[i] = lens[i + 1];
        }
        --n_parts;
    }

    if (out_cap < n_parts) return -1;
    for (uint64_t i = 0; i < n_parts; ++i) {
        uint32_t r = lookup(e, std::string_view(data + starts[i], lens[i]));
        if (r == kNoRank) return -1;
        out[i] = r;
    }
    return static_cast<int64_t>(n_parts);
}

}  // extern "C"
