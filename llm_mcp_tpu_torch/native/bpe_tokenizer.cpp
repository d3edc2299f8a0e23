// Native BPE tokenizer core of the PyTorch port (a copy of the JAX
// package's native/bpe_tokenizer.cpp, so the port builds it from its own
// tree): the byte-level BPE merge loop and the streaming UTF-8 boundary
// scanner behind llm_mcp_tpu_torch/executor/bpe.py.
//
// Exposed as a plain C ABI for ctypes. Cold-path work (tokenizer.json
// parsing, GPT-2 byte-unicode remapping, regex pretokenization) stays in
// Python; this library owns the per-piece merge loop and byte<->id tables.
//
// Build (llm_mcp_tpu_torch/native/__init__.py does it at first use):
//   g++ -O2 -std=c++17 -shared -fPIC -o libbpe.so bpe_tokenizer.cpp

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct MergeInfo {
    int32_t rank;
    int32_t merged_id;
};

struct Bpe {
    std::unordered_map<std::string, int32_t> token_to_id;
    std::vector<std::string> id_to_token;       // id -> raw bytes
    std::unordered_map<uint64_t, MergeInfo> merges;  // (left<<32|right) -> info
    int32_t byte_ids[256];                      // single-byte token ids (-1 = absent)
    bool finalized = false;

    Bpe() { std::memset(byte_ids, -1, sizeof(byte_ids)); }
};

inline uint64_t pair_key(int32_t a, int32_t b) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
           static_cast<uint32_t>(b);
}

}  // namespace

extern "C" {

void* bpe_new() { return new Bpe(); }

void bpe_free(void* h) { delete static_cast<Bpe*>(h); }

// Register a vocab entry: `bytes` is the token's RAW byte string (the Python
// loader undoes GPT-2 byte-to-unicode remapping before calling).
int bpe_add_token(void* h, const uint8_t* bytes, int len, int32_t id) {
    if (h == nullptr || bytes == nullptr || len < 0 || id < 0) return -1;
    Bpe* b = static_cast<Bpe*>(h);
    std::string tok(reinterpret_cast<const char*>(bytes), static_cast<size_t>(len));
    b->token_to_id.emplace(tok, id);
    if (static_cast<size_t>(id) >= b->id_to_token.size()) {
        b->id_to_token.resize(static_cast<size_t>(id) + 1);
    }
    b->id_to_token[static_cast<size_t>(id)] = std::move(tok);
    if (len == 1) b->byte_ids[bytes[0]] = id;
    return 0;
}

// Register a merge rule: (left, right) token ids merge into `merged_id` with
// priority `rank` (lower rank merges first).
int bpe_add_merge(void* h, int32_t left, int32_t right, int32_t rank, int32_t merged_id) {
    if (h == nullptr || left < 0 || right < 0 || merged_id < 0) return -1;
    Bpe* b = static_cast<Bpe*>(h);
    b->merges[pair_key(left, right)] = MergeInfo{rank, merged_id};
    return 0;
}

int bpe_num_tokens(void* h) {
    return h ? static_cast<int>(static_cast<Bpe*>(h)->token_to_id.size()) : 0;
}

// Encode one pretokenized piece (raw bytes) into token ids.
// Returns the number of ids written, or -1 on bad args / overflow of max_out.
// Bytes with no single-byte token are skipped (mirrors ByteTokenizer's
// out-of-range policy: garbage must not crash the stream).
int bpe_encode(void* h, const uint8_t* text, int len, int32_t* out, int max_out) {
    if (h == nullptr || (text == nullptr && len > 0) || out == nullptr || len < 0) return -1;
    Bpe* b = static_cast<Bpe*>(h);

    // initial symbol sequence: one id per byte
    std::vector<int32_t> sym;
    sym.reserve(static_cast<size_t>(len));
    for (int i = 0; i < len; ++i) {
        int32_t id = b->byte_ids[text[i]];
        if (id >= 0) sym.push_back(id);
    }

    // greedy merge loop: repeatedly apply the lowest-rank adjacent pair.
    // Pieces are pretokenized words (tens of bytes), so the quadratic scan
    // beats heap bookkeeping in practice.
    while (sym.size() >= 2) {
        int best_pos = -1;
        int32_t best_rank = INT32_MAX;
        int32_t best_id = -1;
        for (size_t i = 0; i + 1 < sym.size(); ++i) {
            auto it = b->merges.find(pair_key(sym[i], sym[i + 1]));
            if (it != b->merges.end() && it->second.rank < best_rank) {
                best_rank = it->second.rank;
                best_pos = static_cast<int>(i);
                best_id = it->second.merged_id;
            }
        }
        if (best_pos < 0) break;
        sym[static_cast<size_t>(best_pos)] = best_id;
        sym.erase(sym.begin() + best_pos + 1);
    }

    if (static_cast<int>(sym.size()) > max_out) return -1;
    std::memcpy(out, sym.data(), sym.size() * sizeof(int32_t));
    return static_cast<int>(sym.size());
}

// Encode MANY pretokenized pieces in one call (the per-call ctypes overhead
// otherwise dominates: a document is thousands of pieces). `data` is the
// concatenation of all pieces' bytes; `offsets` has n_pieces+1 entries with
// piece i spanning [offsets[i], offsets[i+1]). Returns total ids written,
// or -1 on bad args / output overflow.
int bpe_encode_batch(void* h, const uint8_t* data, const int32_t* offsets,
                     int n_pieces, int32_t* out, int max_out) {
    if (h == nullptr || offsets == nullptr || out == nullptr || n_pieces < 0) return -1;
    Bpe* b = static_cast<Bpe*>(h);
    std::vector<int32_t> sym;
    int w = 0;
    for (int p = 0; p < n_pieces; ++p) {
        int32_t start = offsets[p], end = offsets[p + 1];
        if (start < 0 || end < start) return -1;

        sym.clear();
        sym.reserve(static_cast<size_t>(end - start));
        for (int32_t i = start; i < end; ++i) {
            int32_t id = b->byte_ids[data[i]];
            if (id >= 0) sym.push_back(id);
        }
        while (sym.size() >= 2) {
            int best_pos = -1;
            int32_t best_rank = INT32_MAX;
            int32_t best_id = -1;
            for (size_t i = 0; i + 1 < sym.size(); ++i) {
                auto it = b->merges.find(pair_key(sym[i], sym[i + 1]));
                if (it != b->merges.end() && it->second.rank < best_rank) {
                    best_rank = it->second.rank;
                    best_pos = static_cast<int>(i);
                    best_id = it->second.merged_id;
                }
            }
            if (best_pos < 0) break;
            sym[static_cast<size_t>(best_pos)] = best_id;
            sym.erase(sym.begin() + best_pos + 1);
        }
        if (w + static_cast<int>(sym.size()) > max_out) return -1;
        std::memcpy(out + w, sym.data(), sym.size() * sizeof(int32_t));
        w += static_cast<int>(sym.size());
    }
    return w;
}

// Decode ids back to raw bytes. Unknown ids are skipped. Returns byte count,
// or -1 when the output buffer is too small (call again with a bigger one).
int bpe_decode(void* h, const int32_t* ids, int n, uint8_t* out, int max_out) {
    if (h == nullptr || (ids == nullptr && n > 0) || out == nullptr || n < 0) return -1;
    Bpe* b = static_cast<Bpe*>(h);
    int w = 0;
    for (int i = 0; i < n; ++i) {
        int32_t id = ids[i];
        if (id < 0 || static_cast<size_t>(id) >= b->id_to_token.size()) continue;
        const std::string& tok = b->id_to_token[static_cast<size_t>(id)];
        if (w + static_cast<int>(tok.size()) > max_out) return -1;
        std::memcpy(out + w, tok.data(), tok.size());
        w += static_cast<int>(tok.size());
    }
    return w;
}

// How many trailing bytes of `data` form an INCOMPLETE UTF-8 sequence and
// must be held back by a streaming decoder (0..3). Mirrors
// ByteTokenizer.decode_stream's boundary logic; shared by the SSE stream.
int utf8_hold(const uint8_t* data, int len) {
    if (data == nullptr || len <= 0) return 0;
    int scan = len < 3 ? len : 3;
    for (int i = 1; i <= scan; ++i) {
        uint8_t c = data[len - i];
        if (c < 0x80) return 0;          // ASCII: complete
        if (c >= 0xC0) {                 // lead byte
            int need = c < 0xE0 ? 2 : (c < 0xF0 ? 3 : 4);
            return i < need ? i : 0;
        }
        // else continuation byte: keep scanning backwards
    }
    return 0;
}

}  // extern "C"
