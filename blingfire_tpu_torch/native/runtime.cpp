// Copy of blingfire_tpu/native/runtime.cpp, built by blingfire_tpu_torch/native/__init__.py
// (the benchmark entry at the end takes its model path as an argument).
// Native host runtime: BlingFire-compatible C ABI over dense model tables.
//
// This is the framework's C++ host engine: it loads `.bin` LDB models ONCE
// into flat, cache-friendly CSR tables (the same densified design the Python
// loader and the TPU runtime use — NOT the reference's in-place byte-offset
// interpretation) and runs the four tokenization algorithm families plus
// hyphenation behind the exact C ABI of the reference product layer
// (blingfiretools/blingfiretokdll/blingfiretokdll.h:25-103), so existing
// BlingFire FFI bindings can link against it unchanged.
//
// Semantics sources (cited for parity, no code copied):
//   container/conf:  blingfireclient.library/src/FALDB.cpp:24-191
//   packed formats:  FADfaPack_triv.h:27-93, FAMultiMap_pack.cpp:22-126,
//                    FAMultiMap_pack_fixed.cpp:25-161, FAArray_pack.cpp:27-99,
//                    FAStringArray_pack.cpp:23-96, FAIwMap_pack.cpp:35-88,
//                    FAChains_pack_triv.h:81-223
//   engines:         FALexTools_t.h:205-458,
//                    FATokenSegmentationTools_1best{,_bpe,_bpe_with_merges}_t.h,
//                    FAHyphInterpreter_core_t.h:136-267
//   product layer:   blingfiretokdll.cpp (functions cited per block below)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace btf {

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

static inline int32_t rd_i32(const uint8_t* p) {
    int32_t v;
    std::memcpy(&v, p, 4);
    return v;
}
static inline uint32_t rd_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}
static inline int64_t rd_be(const uint8_t* p, int nbytes) {
    int64_t v = 0;
    for (int k = 0; k < nbytes; ++k) v = (v << 8) | p[k];
    return v;
}
static inline int64_t rd_le_signed(const uint8_t* p, int nbytes) {
    switch (nbytes) {
        case 1: return (int8_t)p[0];
        case 2: { int16_t v; std::memcpy(&v, p, 2); return v; }
        default: { int32_t v; std::memcpy(&v, p, 4); return v; }
    }
}

static inline bool is_whitespace(int c) {
    return (c <= 0x20 || c == 0xa0 || (c >= 0x2000 && c <= 0x200f) ||
            c == 0x202f || c == 0x205f || c == 0x2060 || c == 0x2420 ||
            c == 0x2424 || c == 0x3000 || c == 0xfeff);
}

static const int SPM = 0x2581;
static const int MAX_WORD_SIZE = 300;
static const double UNK_SCORE = -100000.0;

// special input weights (FAFsmConst.h:68-75)
enum { IW_ANY = 0, IW_L_ANCHOR = 1, IW_R_ANCHOR = 2, IW_EPSILON = 3 };

// LDB sections / params (FAFsmConst.h:152-273; subset used here)
enum {
    FUNC_W2H = 11, FUNC_POS_DICT = 12, FUNC_WBD = 19, FUNC_GLOBAL = 20,
    FUNC_I2W = 35
};
enum {
    P_FSM = 2, P_MAP_MODE = 16, P_MIN_LEN = 17, P_IGNORE_CASE = 22,
    P_ARRAY = 24, P_MULTI_MAP = 25, P_FSM_TYPE = 26, P_LEFT_ANCHOR = 27,
    P_RIGHT_ANCHOR = 28, P_MIN_LEN2 = 32, P_DEPTH = 38, P_WORD = 42,
    P_CHARMAP = 47, P_XWORD = 51, P_SEG = 52, P_IGNORE = 53,
    P_ACT_DATA = 63, P_MAX_LENGTH = 69, P_VERIFY_LDB_BIN = 70,
    P_TOKENIZATION_TYPE = 71, P_ID_OFFSET = 72, P_USE_BYTE_ENCODING = 73,
    P_NO_DUMMY_PREFIX = 74, P_STRING_ARRAY = 75, P_TOKENID_MIN = 76,
    P_TOKENID_MAX = 77
};
// FAFsmConst.h:403-415 (TOKENIZE_*)
enum { ALGO_DEFAULT = 0, ALGO_WORDPIECE = 1, ALGO_UNIGRAM_LM = 2,
       ALGO_BPE = 3, ALGO_BPE_OPT = 4, ALGO_BPE_OPT_WITH_MERGES = 5 };

static const int WBD_WORD_TAG = 1;
static const int WBD_IGNORE_TAG = 4;

// optional full-Unicode casefold table installed by the Python binding
// (tolower; indices up to CASE_MAX); without it only ASCII folds.
static std::vector<int32_t> g_tolower;
static inline int fold_lower(int c) {
    if (!g_tolower.empty())
        return (c >= 0 && c < (int)g_tolower.size()) ? g_tolower[c] : c;
    return (c >= 'A' && c <= 'Z') ? c + 0x20 : c;
}

// ---------------------------------------------------------------------------
// UTF-8 <-> UTF-32 (FAUtf8Utils.cpp semantics: strict, BOM-strip, offsets)
// ---------------------------------------------------------------------------

static bool utf8_decode(const uint8_t* s, int n, std::vector<int>& cps,
                        std::vector<int>& offs) {
    cps.clear();
    offs.clear();
    int i = 0;
    if (n >= 3 && s[0] == 0xEF && s[1] == 0xBB && s[2] == 0xBF) i = 3;
    while (i < n) {
        uint8_t b0 = s[i];
        int cnt, ch;
        if ((b0 & 0x80) == 0) { cnt = 1; ch = b0; }
        else if ((b0 & 0xE0) == 0xC0) { cnt = 2; ch = b0 & 0x1F; }
        else if ((b0 & 0xF0) == 0xE0) { cnt = 3; ch = b0 & 0x0F; }
        else if ((b0 & 0xF8) == 0xF0) { cnt = 4; ch = b0 & 0x07; }
        else return false;
        if (i + cnt > n) return false;
        for (int k = 1; k < cnt; ++k) {
            uint8_t bk = s[i + k];
            if ((bk & 0xC0) != 0x80) return false;
            ch = (ch << 6) | (bk & 0x3F);
        }
        int exp = ch <= 0x7F ? 1 : ch <= 0x7FF ? 2 : ch <= 0xFFFF ? 3
                  : ch <= 0x10FFFF ? 4 : 0;
        if (exp != cnt) return false;
        if ((ch & 0xFFFFF800) == 0xD800) return false;
        cps.push_back(ch);
        offs.push_back(i);
        i += cnt;
    }
    return true;
}

static void utf8_as_bytes(const uint8_t* s, int n, std::vector<int>& cps,
                          std::vector<int>& offs) {
    cps.clear();
    offs.clear();
    int i = (n >= 3 && s[0] == 0xEF && s[1] == 0xBB && s[2] == 0xBF) ? 3 : 0;
    for (; i < n; ++i) {
        cps.push_back(s[i]);
        offs.push_back(i);
    }
}

static inline int utf8_size_at(const uint8_t* s, int n, int off) {
    if (off < 0 || off >= n) return 0;
    uint8_t b0 = s[off];
    if ((b0 & 0x80) == 0) return 1;
    if ((b0 & 0xE0) == 0xC0) return 2;
    if ((b0 & 0xF0) == 0xE0) return 3;
    if ((b0 & 0xF8) == 0xF0) return 4;
    return 0;
}

static void utf8_encode_cp(int c, std::string& out) {
    if (c < 0 || c > 0x10FFFF) c = 0xFFFD;
    if (c <= 0x7F) {
        out.push_back((char)c);
    } else if (c <= 0x7FF) {
        out.push_back((char)(0xC0 | (c >> 6)));
        out.push_back((char)(0x80 | (c & 0x3F)));
    } else if (c <= 0xFFFF) {
        out.push_back((char)(0xE0 | (c >> 12)));
        out.push_back((char)(0x80 | ((c >> 6) & 0x3F)));
        out.push_back((char)(0x80 | (c & 0x3F)));
    } else {
        out.push_back((char)(0xF0 | (c >> 18)));
        out.push_back((char)(0x80 | ((c >> 12) & 0x3F)));
        out.push_back((char)(0x80 | ((c >> 6) & 0x3F)));
        out.push_back((char)(0x80 | (c & 0x3F)));
    }
}

// ---------------------------------------------------------------------------
// packed structure readers (load-time only)
// ---------------------------------------------------------------------------

struct ChainsView {
    const uint8_t* base = nullptr;
    int size_of_value = 4;
    void init(const uint8_t* p) {
        base = p;
        size_of_value = rd_i32(p);
    }
    void unpack(int64_t offset, std::vector<int>& out) const {
        const uint8_t* p = base + offset;
        int64_t count = rd_le_signed(p, size_of_value);
        out.clear();
        for (int64_t k = 0; k < count; ++k)
            out.push_back(
                (int)rd_le_signed(p + size_of_value * (1 + k), size_of_value));
    }
};

struct MultiMapView {
    const uint8_t* img = nullptr;
    int64_t max_key = 0;
    int size_of_offset = 4;
    const uint8_t* off_base = nullptr;
    ChainsView values;
    void init(const uint8_t* p) {
        img = p;
        max_key = rd_u32(p);
        size_of_offset = (int)rd_u32(p + 4);
        off_base = p + 8;
        int64_t voff = 8 + size_of_offset * (max_key + 1);
        if (voff % 4) voff += 4 - voff % 4;
        values.init(p + voff);
    }
    bool get(int64_t key, std::vector<int>& out) const {
        if (key < 0 || key > max_key) return false;
        int64_t off = rd_be(off_base + key * size_of_offset, size_of_offset);
        if (off == 0) return false;
        values.unpack(off - 1, out);
        return true;
    }
};

struct FixedMapDense {
    int min_key = 0, max_key = -1, max_count = 0;
    std::vector<int32_t> counts;  // per key
    std::vector<int32_t> vals;    // per key, max_count slots
    void init(const uint8_t* p) {
        int size_of_value = (int)rd_u32(p);
        max_count = rd_i32(p + 4);
        min_key = rd_i32(p + 8);
        max_key = rd_i32(p + 12);
        const uint8_t* data = p + 16;
        int64_t nkeys = (int64_t)max_key - min_key + 1;
        counts.assign(nkeys, 0);
        vals.assign(nkeys * max_count, 0);
        int64_t slot = (int64_t)(max_count + 1) * size_of_value;
        for (int64_t k = 0; k < nkeys; ++k) {
            const uint8_t* sp = data + k * slot;
            counts[k] = (int32_t)rd_le_signed(sp, size_of_value);
            for (int j = 0; j < max_count; ++j)
                vals[k * max_count + j] = (int32_t)rd_le_signed(
                    sp + (1 + j) * size_of_value, size_of_value);
        }
    }
    // 1->N expansion query; returns count or -1 when no mapping
    int get(int key, const int32_t** out) const {
        if (key < min_key || key > max_key) return -1;
        int64_t k = key - min_key;
        int n = counts[k];
        if (n > max_count) return -1;
        *out = &vals[k * max_count];
        return n;
    }
};

static std::vector<int32_t> array_pack_densify(const uint8_t* p) {
    int m = rd_i32(p), size_of_index = rd_i32(p + 4);
    int size_of_value = rd_i32(p + 8), count = rd_i32(p + 12);
    const uint8_t* d = p + 16;
    std::vector<int32_t> out;
    out.reserve(count);
    if (size_of_index == 0) {
        for (int i = 0; i < count; ++i)
            out.push_back((int32_t)rd_be(d + (int64_t)i * size_of_value,
                                         size_of_value));
        return out;
    }
    int nchunks = (count + m - 1) / m;
    const uint8_t* data = d + (int64_t)nchunks * size_of_index;
    for (int i = 0; i < count; ++i) {
        int chunk = i / m, pos = i % m;
        int64_t cid = rd_be(d + (int64_t)chunk * size_of_index, size_of_index);
        out.push_back((int32_t)rd_be(
            data + (cid * m + pos) * size_of_value, size_of_value));
    }
    return out;
}

struct StringArrayView {
    const uint8_t* base = nullptr;
    uint32_t count = 0;
    const uint8_t* offs = nullptr;
    const uint8_t* data = nullptr;
    void init(const uint8_t* p) {
        base = p;
        count = rd_u32(p);
        offs = p + 4;
        data = p + 4 + 4 * ((int64_t)count + 1);
    }
    int get(int idx, const uint8_t** out) const {
        if (idx < 0 || (uint32_t)idx >= count) return -1;
        uint32_t b = rd_u32(offs + 4 * (int64_t)idx);
        uint32_t e = rd_u32(offs + 4 * ((int64_t)idx + 1));
        *out = data + b;
        return (int)(e - b);
    }
};

// dense old-iw -> internal-iw remap (FAIwMap_pack)
static std::vector<int32_t> iwmap_densify(const uint8_t* p) {
    int interval_count = rd_i32(p + 4);
    const uint8_t* from = p + 8;
    const uint8_t* pairs = from + 4 * (int64_t)interval_count;
    const uint8_t* storage = pairs + 8 * (int64_t)interval_count;
    int size_of_new = rd_i32(p);
    int hi = interval_count
                 ? rd_i32(pairs + 8 * ((int64_t)interval_count - 1))
                 : 0;
    std::vector<int32_t> out((int64_t)hi + 1, -1);
    for (int i = 0; i < interval_count; ++i) {
        int lo = rd_i32(from + 4 * (int64_t)i);
        int to = rd_i32(pairs + 8 * (int64_t)i);
        int off = rd_i32(pairs + 8 * (int64_t)i + 4);
        for (int k = lo; k <= to; ++k) {
            int64_t v = rd_be(storage + off + (int64_t)(k - lo) * size_of_new,
                              size_of_new);
            out[k] = v ? (int32_t)(v - 1) : -1;
        }
    }
    return out;
}

// ---------------------------------------------------------------------------
// packed automaton image -> dense CSR automaton
// ---------------------------------------------------------------------------

static const int DEAD = -2;

struct DenseAut {
    int n_states = 0;
    std::vector<uint8_t> final_;
    std::vector<int32_t> moore_ow;      // -1 where absent
    std::vector<int64_t> row_ptr;       // n_states+1
    std::vector<int32_t> e_iw, e_dst, e_ow;
    std::vector<int32_t> iw2iw;         // empty when image has no remap

    // per-state node records sized for the access pattern of trie walks:
    //   TINY (<=2 edges, the common trie case): edges inline, ONE cache line
    //   DENSE (>=8 edges, compact span): direct-indexed slot slice (the same
    //     trick the packed IWIA representation plays)
    //   SPARSE (3..7 edges or budget overflow): linear/binary scan in CSR
    enum : int32_t { K_TINY = 0, K_DENSE = 1, K_SPARSE = 2 };
    struct Node {  // 32 bytes, cache-line friendly
        int32_t kind;
        int32_t a, b, c, d, e, f;  // tiny: iw0,dst0,ow0,iw1,dst1,ow1
        int32_t g;                 // dense: a=base, b=width, (c,g)=pool offset
    };
    struct Slot { int32_t dst, ow; };
    std::vector<Node> nodes;
    std::vector<Slot> pool;  // dst == NONE marks "no transition"
    static constexpr int32_t NONE = -3;

    static inline int64_t node_off(const Node& n) {
        return (int64_t)(uint32_t)n.c | ((int64_t)n.g << 32);
    }

    void build_rows() {
        nodes.assign(n_states, Node{K_SPARSE, 0, 0, 0, 0, 0, 0, 0});
        pool.clear();
        int64_t budget = 32u << 20;  // at most 32M dense slots (256 MB)
        for (int s = 0; s < n_states; ++s) {
            int64_t lo = row_ptr[s], hi = row_ptr[s + 1];
            int64_t cnt = hi - lo;
            if (cnt <= 2) {
                Node n{K_TINY, -1, -1, 0, -1, -1, 0, 0};
                if (cnt > 0) { n.a = e_iw[lo]; n.b = e_dst[lo]; n.c = e_ow[lo]; }
                if (cnt > 1) { n.d = e_iw[lo+1]; n.e = e_dst[lo+1]; n.f = e_ow[lo+1]; }
                nodes[s] = n;
                continue;
            }
            if (cnt >= 8) {
                // try the full span; if one extreme iw (e.g. the 0x2581 SPM
                // edge in a byte-alphabet row) blows it up, keep that single
                // outlier edge inline and densify the compact remainder
                int64_t from = lo, to = hi;  // dense part [from, to)
                int64_t outlier = -1;
                int64_t width = (int64_t)e_iw[hi - 1] - e_iw[lo] + 1;
                if (width > 4 * cnt + 64) {
                    int64_t w_hi = (int64_t)e_iw[hi - 2] - e_iw[lo] + 1;
                    int64_t w_lo = (int64_t)e_iw[hi - 1] - e_iw[lo + 1] + 1;
                    if (w_hi <= w_lo) { outlier = hi - 1; to = hi - 1; width = w_hi; }
                    else { outlier = lo; from = lo + 1; width = w_lo; }
                }
                if (width <= 65536 && width <= budget) {
                    budget -= width;
                    int32_t base = e_iw[from];
                    Node n{K_DENSE, base, (int32_t)width, 0, -1, -1, 0, 0};
                    if (outlier >= 0) {
                        n.d = e_iw[outlier];
                        n.e = e_dst[outlier];
                        n.f = e_ow[outlier];
                    }
                    int64_t off = (int64_t)pool.size();
                    n.c = (int32_t)(uint32_t)(off & 0xFFFFFFFF);
                    n.g = (int32_t)(off >> 32);
                    nodes[s] = n;
                    pool.resize(pool.size() + width, Slot{NONE, 0});
                    for (int64_t k = from; k < to; ++k)
                        pool[off + e_iw[k] - base] = Slot{e_dst[k], e_ow[k]};
                    continue;
                }
            }
            // K_SPARSE: CSR scan
        }
    }

    // GetDest equivalent over dense tables
    inline int step(int state, int iw, int* ow = nullptr) const {
        if (state < 0) return -1;
        const Node& nd = nodes[state];
        if (nd.kind == K_TINY) {
            if (nd.a == iw) { if (ow) *ow = nd.c; return nd.b; }
            if (nd.d == iw) { if (ow) *ow = nd.f; return nd.e; }
            return -1;
        }
        if (nd.kind == K_DENSE) {
            uint32_t rel = (uint32_t)(iw - nd.a);
            if (rel >= (uint32_t)nd.b) {
                if (nd.d == iw) { if (ow) *ow = nd.f; return nd.e; }
                return -1;
            }
            Slot s = pool[node_off(nd) + rel];
            if (s.dst == NONE) return -1;
            if (ow) *ow = s.ow;
            return s.dst;
        }
        int64_t lo = row_ptr[state], hi = row_ptr[state + 1];
        if (hi - lo > 16) {  // rare: wide row that exceeded the dense budget
            const int32_t* beg = e_iw.data();
            const int32_t* it = std::lower_bound(beg + lo, beg + hi, (int32_t)iw);
            if (it != beg + hi && *it == iw) {
                int64_t idx = it - beg;
                if (ow) *ow = e_ow[idx];
                return e_dst[idx];
            }
            return -1;
        }
        for (int64_t k = lo; k < hi; ++k) {
            if (e_iw[k] == iw) {
                if (ow) *ow = e_ow[k];
                return e_dst[k];
            }
            if (e_iw[k] > iw) break;
        }
        return -1;
    }
    inline int remap(int raw_iw) const {
        if (iw2iw.empty()) return raw_iw;
        if (raw_iw < 0 || raw_iw >= (int)iw2iw.size()) return -1;
        return iw2iw[raw_iw];
    }
    inline int dest(int state, int raw_iw, int* ow = nullptr) const {
        int iw = remap(raw_iw);
        if (iw == -1) return -1;
        return step(state, iw, ow);
    }
};

// decode one packed state (FADfaPack_triv.h:27-93 layout)
struct RawState {
    bool final_ = false;
    std::vector<std::pair<int, int64_t>> edges;  // (iw, dst byte offset)
    bool has_ow = false;
    int32_t ow = 0;
};

static void decode_state(const uint8_t* img, int dst_size, int64_t state,
                         RawState& out) {
    static const int OW_SIZE[4] = {0, 1, 2, 4};
    const uint8_t* p = img + state;
    uint8_t info = *p++;
    out.final_ = (info & 0x80) != 0;
    out.edges.clear();
    out.has_ow = false;
    int iw_size = ((info & 0x18) >> 3) + 1;
    int ow_size = OW_SIZE[(info & 0x60) >> 5];
    int tr = info & 0x07;
    int64_t dead = ((int64_t)1 << (8 * dst_size)) - 1;
    auto dst_at = [&](const uint8_t* q, int i) -> int64_t {
        int64_t v = rd_be(q + (int64_t)i * dst_size, dst_size);
        return v == dead ? DEAD : v;
    };
    switch (tr) {
        case 0x00:  // none
            break;
        case 0x02: {  // implicit
            int64_t v = 0;
            for (int k = iw_size - 1; k >= 0; --k) v = (v << 8) | p[k];  // LE
            out.edges.push_back({(int)v, state + 1 + iw_size + ow_size});
            p += iw_size;
            break;
        }
        case 0x04: {  // parallel arrays
            int64_t count = 0;
            for (int k = iw_size - 1; k >= 0; --k) count = (count << 8) | p[k];
            count += 1;
            p += iw_size;
            const uint8_t* iws = p;
            const uint8_t* dsts = p + count * iw_size;
            for (int64_t i = 0; i < count; ++i) {
                int64_t iw = 0;
                for (int k = iw_size - 1; k >= 0; --k)
                    iw = (iw << 8) | iws[i * iw_size + k];
                out.edges.push_back({(int)iw, dst_at(dsts, (int)i)});
            }
            p = dsts + count * dst_size;
            break;
        }
        case 0x06: {  // iw-index array
            int64_t iw_base = 0, iw_max = 0;
            for (int k = iw_size - 1; k >= 0; --k)
                iw_base = (iw_base << 8) | p[k];
            p += iw_size;
            for (int k = iw_size - 1; k >= 0; --k)
                iw_max = (iw_max << 8) | p[k];
            p += iw_size;
            int64_t count = iw_max - iw_base + 1;
            for (int64_t i = 0; i < count; ++i) {
                int64_t v = rd_be(p + i * dst_size, dst_size);
                if (v == 0) continue;          // no transition
                out.edges.push_back(
                    {(int)(iw_base + i), v == dead ? DEAD : v});
            }
            p += count * dst_size;
            break;
        }
        case 0x01: {  // ranges
            int64_t count = 0;
            for (int k = iw_size - 1; k >= 0; --k) count = (count << 8) | p[k];
            count += 1;
            p += iw_size;
            const uint8_t* froms = p;
            const uint8_t* tos = p + count * iw_size;
            const uint8_t* dsts = tos + count * iw_size;
            for (int64_t i = 0; i < count; ++i) {
                int64_t f = 0, t = 0;
                for (int k = iw_size - 1; k >= 0; --k)
                    f = (f << 8) | froms[i * iw_size + k];
                for (int k = iw_size - 1; k >= 0; --k)
                    t = (t << 8) | tos[i * iw_size + k];
                int64_t d = dst_at(dsts, (int)i);
                for (int64_t iw = f; iw <= t; ++iw)
                    out.edges.push_back({(int)iw, d});
            }
            p = dsts + count * dst_size;
            break;
        }
        default:
            break;
    }
    if (ow_size) {
        out.has_ow = true;
        out.ow = (int32_t)rd_le_signed(p, ow_size);
    }
}

// parse header + BFS-densify (mirrors formats/dfa.py::densify_automaton)
static void densify(const uint8_t* img, DenseAut& A, bool mealy) {
    int dst_size = rd_i32(img);
    if (dst_size < 1 || dst_size > 4) dst_size = 3;
    int32_t ows_offset = rd_i32(img + 4);
    uint32_t raw_count = rd_u32(img + 8);
    bool remap = (raw_count & 0x80000000u) != 0;
    int64_t iw_count = raw_count & 0x7FFFFFFF;
    int64_t p = 12 + 4 * iw_count;
    if (remap) {
        int32_t iw2iw_size = rd_i32(img + p);
        p += 4;
        A.iw2iw = iwmap_densify(img + p);
        p += iw2iw_size;
    } else {
        A.iw2iw.clear();
    }
    int64_t initial = p;
    ChainsView ows;
    if (ows_offset) ows.init(img + ows_offset);

    std::unordered_map<int64_t, int> off2id;
    std::vector<int64_t> order;
    off2id[initial] = 0;
    order.push_back(initial);
    RawState st;
    std::vector<RawState> states;
    for (size_t qi = 0; qi < order.size(); ++qi) {
        decode_state(img, dst_size, order[qi], st);
        for (auto& e : st.edges) {
            if (e.second >= 0 && !off2id.count(e.second)) {
                off2id[e.second] = (int)order.size();
                order.push_back(e.second);
            }
        }
        states.push_back(st);
    }
    int n = (int)states.size();
    A.n_states = n;
    A.final_.assign(n, 0);
    A.moore_ow.assign(n, -1);
    A.row_ptr.assign(n + 1, 0);
    A.e_iw.clear();
    A.e_dst.clear();
    A.e_ow.clear();
    std::vector<int> chain;
    for (int s = 0; s < n; ++s) {
        RawState& rs = states[s];
        A.final_[s] = rs.final_ ? 1 : 0;
        if (!mealy && rs.has_ow) A.moore_ow[s] = rs.ow;
        if (mealy && rs.has_ow) {
            ows.unpack(rs.ow, chain);
        } else {
            chain.clear();
        }
        // pair each transition with its ow (chain entry at the transition's
        // STORAGE index, FAMealyDfa_pack_triv.cpp:220-243) BEFORE sorting
        std::vector<std::pair<int32_t, std::pair<int32_t, int32_t>>> tri;
        tri.reserve(rs.edges.size());
        for (size_t k = 0; k < rs.edges.size(); ++k) {
            auto& e = rs.edges[k];
            int32_t d = e.second == DEAD ? DEAD : off2id[e.second];
            int32_t ow = k < chain.size() ? chain[k] : 0;
            tri.push_back({(int32_t)e.first, {d, ow}});
        }
        std::sort(tri.begin(), tri.end());
        for (auto& t : tri) {
            A.e_iw.push_back(t.first);
            A.e_dst.push_back(t.second.first);
            A.e_ow.push_back(t.second.second);
        }
        A.row_ptr[s + 1] = (int64_t)A.e_iw.size();
    }
    A.build_rows();
}

// ---------------------------------------------------------------------------
// conf decoding (FALDB.cpp:119-191)
// ---------------------------------------------------------------------------

static bool is_flag_param(int func, int param) {
    switch (func) {
        case FUNC_WBD: return param == P_IGNORE_CASE;
        case FUNC_POS_DICT:
            return param == 18 /*NO_TR*/ || param == P_IGNORE_CASE ||
                   param == P_USE_BYTE_ENCODING || param == P_NO_DUMMY_PREFIX;
        case FUNC_W2H:
            return param == P_IGNORE_CASE || param == 35 /*NORMALIZE*/;
        default: return false;
    }
}

static void decode_params(const std::vector<int>& stream, int func,
                          std::unordered_map<int, int>& out) {
    size_t i = 0;
    while (i < stream.size()) {
        int pid = stream[i];
        if (is_flag_param(func, pid)) {
            out[pid] = 1;
            i += 1;
        } else {
            if (i + 1 >= stream.size()) break;
            out[pid] = stream[i + 1];
            i += 2;
        }
    }
}

static int param(const std::unordered_map<int, int>& p, int key, int dflt) {
    auto it = p.find(key);
    return it == p.end() ? dflt : it->second;
}

// ---------------------------------------------------------------------------
// model sections
// ---------------------------------------------------------------------------

struct WbdModel {
    DenseAut aut;
    std::unordered_map<int, std::vector<int>> acts;  // rule Ow -> action
    FixedMapDense charmap;
    bool has_charmap = false;
    int max_depth = 2, max_token_length = 300;
    bool ignore_case = false;
    std::vector<int> fn2ini;  // fn tag -> initial state (index 0 = main)

    inline int dest_any(int state, int raw_iw) const {
        int d = aut.dest(state, raw_iw);
        if (d == -1) d = aut.dest(state, IW_ANY);
        return d;
    }

    // per-function initial states (FAWbdConfKeeper.cpp:246-314)
    void calc_fn_ini() {
        fn2ini.clear();
        int state_r = aut.dest(0, IW_R_ANCHOR);
        if (state_r == -1) return;
        int max_fn = -1;
        for (auto& kv : acts) {
            const std::vector<int>& a = kv.second;
            size_t i = 2;
            while (i < a.size()) {
                if (a[i] == 0 && i + 1 < a.size()) { i += 1; break; }
                i += 1;
            }
            for (; i < a.size(); ++i) max_fn = std::max(max_fn, a[i]);
        }
        if (max_fn == -1) return;
        fn2ini.push_back(0);
        for (int fn = 1; fn <= max_fn; ++fn)
            fn2ini.push_back(aut.dest(state_r, fn));
    }
};

struct SegModel {
    DenseAut aut;
    std::vector<int32_t> ids;      // MPH index -> token id
    std::vector<float> scores;     // MPH index -> score / merge rank
    int min_key = 0;
    FixedMapDense charmap;
    bool has_charmap = false;
    int algo = ALGO_DEFAULT;
    int id_offset = 0;
    bool raw_bytes = false;
    bool no_dummy = false;
};

struct HyphModel {
    DenseAut aut;
    std::unordered_map<int, std::vector<int>> i2info;
    FixedMapDense charmap;
    bool has_charmap = false;
    int left_anchor = 1, right_anchor = 2;
    int min_pat_len = 3, no_hyph_len = 0;
    bool ignore_case = false;
};

struct I2wModel {
    StringArrayView sa;
    int min_token_id = 0, max_token_id = 0x7FFFFFFF;
};

struct ModelData {
    std::vector<uint8_t> image;
    bool has_wbd = false, has_seg = false, has_w2h = false, has_i2w = false;
    WbdModel wbd;
    SegModel seg;
    HyphModel w2h;
    I2wModel i2w;
};

// parse the LDB container and all known sections; returns nullptr on error
static ModelData* load_model_bytes(const uint8_t* bytes, int size) {
    if (!bytes || size < 8) return nullptr;
    ModelData* md = new ModelData();
    md->image.assign(bytes, bytes + size);
    const uint8_t* img = md->image.data();

    int count = rd_i32(img);
    if (count < 1 || count > 256) { delete md; return nullptr; }
    std::vector<int64_t> dumps(count);
    for (int i = 0; i < count; ++i) dumps[i] = rd_i32(img + 4 + 4 * i);

    MultiMapView conf;
    conf.init(img + dumps[0]);
    std::vector<int> stream;

    auto load_charmap = [&](int dump_num, FixedMapDense& cm) {
        cm.init(img + dumps[dump_num]);
    };

    if (conf.get(FUNC_WBD, stream)) {
        std::unordered_map<int, int> p;
        decode_params(stream, FUNC_WBD, p);
        WbdModel& w = md->wbd;
        densify(img + dumps[param(p, P_FSM, 1)], w.aut, false);
        MultiMapView acts;
        acts.init(img + dumps[param(p, P_MULTI_MAP, 2)]);
        std::vector<int> v;
        for (int64_t k = 0; k <= acts.max_key; ++k)
            if (acts.get(k, v)) w.acts[(int)k] = v;
        if (p.count(P_CHARMAP)) {
            load_charmap(p[P_CHARMAP], w.charmap);
            w.has_charmap = true;
        }
        w.max_depth = param(p, P_DEPTH, 2);
        w.max_token_length = param(p, P_MAX_LENGTH, 300);
        w.ignore_case = param(p, P_IGNORE_CASE, 0) != 0;
        w.calc_fn_ini();
        md->has_wbd = true;
    }
    if (conf.get(FUNC_POS_DICT, stream)) {
        std::unordered_map<int, int> p;
        decode_params(stream, FUNC_POS_DICT, p);
        SegModel& s = md->seg;
        densify(img + dumps[param(p, P_FSM, 1)], s.aut, true);
        // I2Info: fixed map (MODE_PACK_FIXED) or packed multimap
        int mode = param(p, P_MAP_MODE, 1);
        int64_t mm = dumps[param(p, P_MULTI_MAP, 3)];
        if (mode == 3) {
            FixedMapDense fm;
            fm.init(img + mm);
            s.min_key = fm.min_key;
            int64_t nk = (int64_t)fm.max_key - fm.min_key + 1;
            s.ids.resize(nk);
            s.scores.assign(nk, 0.0f);
            for (int64_t k = 0; k < nk; ++k) {
                s.ids[k] = fm.max_count > 0 ? fm.vals[k * fm.max_count] : 0;
                if (fm.max_count > 1) {
                    int32_t raw = fm.vals[k * fm.max_count + 1];
                    std::memcpy(&s.scores[k], &raw, 4);
                }
            }
        } else {
            MultiMapView m;
            m.init(img + mm);
            s.min_key = 0;
            s.ids.assign(m.max_key + 1, 0);
            s.scores.assign(m.max_key + 1, 0.0f);
            std::vector<int> v;
            for (int64_t k = 0; k <= m.max_key; ++k) {
                if (!m.get(k, v)) continue;
                if (!v.empty()) s.ids[k] = v[0];
                if (v.size() > 1) {
                    int32_t raw = v[1];
                    std::memcpy(&s.scores[k], &raw, 4);
                }
            }
        }
        if (p.count(P_CHARMAP)) {
            load_charmap(p[P_CHARMAP], s.charmap);
            s.has_charmap = true;
        }
        s.algo = param(p, P_TOKENIZATION_TYPE, ALGO_DEFAULT);
        s.id_offset = param(p, P_ID_OFFSET, 0);
        s.raw_bytes = param(p, P_USE_BYTE_ENCODING, 0) != 0;
        s.no_dummy = param(p, P_NO_DUMMY_PREFIX, 0) != 0;
        md->has_seg = true;
    }
    if (conf.get(FUNC_W2H, stream)) {
        std::unordered_map<int, int> p;
        decode_params(stream, FUNC_W2H, p);
        HyphModel& h = md->w2h;
        densify(img + dumps[param(p, P_FSM, 1)], h.aut, false);
        MultiMapView m;
        m.init(img + dumps[param(p, P_MULTI_MAP, 2)]);
        std::vector<int> v;
        for (int64_t k = 0; k <= m.max_key; ++k)
            if (m.get(k, v)) h.i2info[(int)k] = v;
        if (p.count(P_CHARMAP)) {
            load_charmap(p[P_CHARMAP], h.charmap);
            h.has_charmap = true;
        }
        h.left_anchor = param(p, P_LEFT_ANCHOR, 1);
        h.right_anchor = param(p, P_RIGHT_ANCHOR, 2);
        h.min_pat_len = param(p, P_MIN_LEN, 3);
        h.no_hyph_len = param(p, P_MIN_LEN2, 0);
        h.ignore_case = param(p, P_IGNORE_CASE, 0) != 0;
        md->has_w2h = true;
    }
    if (conf.get(FUNC_I2W, stream)) {
        std::unordered_map<int, int> p;
        decode_params(stream, FUNC_I2W, p);
        md->i2w.sa.init(img + dumps[param(p, P_STRING_ARRAY, 1)]);
        md->i2w.min_token_id = param(p, P_TOKENID_MIN, 0);
        md->i2w.max_token_id = param(p, P_TOKENID_MAX, 0x7FFFFFFF);
        md->has_i2w = true;
    }
    if (!md->has_wbd && !md->has_seg && !md->has_w2h && !md->has_i2w) {
        delete md;
        return nullptr;
    }
    return md;
}

// ---------------------------------------------------------------------------
// pattern lexer engine (FALexTools_t.h:205-458 semantics)
// ---------------------------------------------------------------------------

static void lex_process_int(const WbdModel& w, int initial, int offset,
                            const int* seq, int lo, int hi,
                            std::vector<int>& out, int max_out, int rec_depth,
                            bool once) {
    if (w.max_depth < rec_depth) return;
    int in_size = hi - lo;
    int from_pos = -1;
    while (from_pos < in_size) {
        int state = initial;
        int final_state = -1, final_pos = -1;
        int j = from_pos;
        int length_bound = std::min(from_pos + w.max_token_length, in_size);
        if (j == -1) {
            state = w.aut.dest(initial, IW_L_ANCHOR);
            if (state == -1) {
                state = w.aut.dest(initial, IW_ANY);
                if (state == -1) { from_pos += 1; continue; }
            }
            j += 1;
        }
        while (j < length_bound) {
            int iw = seq[lo + j];
            if (iw < IW_EPSILON) iw = IW_EPSILON;  // FALexTools_t.h:259-261
            if (w.ignore_case) iw = fold_lower(iw);
            int dst = w.dest_any(state, iw);
            if (dst == -1) break;
            if (dst >= 0 && w.aut.final_[dst]) {
                final_state = dst;
                final_pos = j;
            }
            state = dst;
            j += 1;
        }
        if (j == in_size) {
            int dst = w.aut.dest(state, IW_R_ANCHOR);
            if (dst == -1) dst = w.aut.dest(state, IW_ANY);
            if (dst != -1 && dst >= 0 && w.aut.final_[dst]) {
                final_state = dst;
                final_pos = j;
            }
        }
        if (final_pos != -1) {
            int ow = w.aut.moore_ow[final_state];
            auto it = w.acts.find(ow);
            if (it == w.acts.end() || it->second.size() < 3) return;
            const std::vector<int>& act = it->second;
            int left_cx = act[0], right_cx = act[1], tag = act[2];
            int from2 = std::min(std::max(from_pos + left_cx, 0), in_size - 1);
            int to2 = std::min(std::max(final_pos - right_cx, 0), in_size - 1);
            size_t fn_idx = 3;
            if (tag != 0) {
                if ((int)out.size() + 3 <= max_out)
                    { out.push_back(tag); out.push_back(from2 + offset);
                      out.push_back(to2 + offset); }
                else return;
                fn_idx = 4;
            }
            bool fn_once = (act.size() - fn_idx) > 1;
            int fn_from = from2;
            while (fn_idx < act.size()) {
                int fn_id = act[fn_idx];
                int fn_ini = w.fn2ini.empty() ? -1 : w.fn2ini[fn_id];
                size_t n_before = out.size();
                lex_process_int(w, fn_ini, fn_from + offset, seq,
                                lo + fn_from, lo + to2 + 1, out, max_out,
                                rec_depth + 1, fn_id == 0 ? false : fn_once);
                if (out.size() > n_before) {
                    fn_from = out.back() + 1 - offset;
                    if (fn_from > to2) break;
                }
                fn_idx += 1;
            }
            if (once) return;
            if (final_pos - right_cx > from_pos)
                from_pos = final_pos - right_cx;
        }
        from_pos += 1;
    }
}

static void lex_process(const WbdModel& w, const int* seq, int n,
                        std::vector<int>& out, int max_out) {
    out.clear();
    lex_process_int(w, 0, 0, seq, 0, n, out, max_out, 1, false);
}

// ---------------------------------------------------------------------------
// segmenters (unigram LM / BPE / BPE+merges)
// ---------------------------------------------------------------------------

struct Arc { int start, end, id; float rank; };

struct Triple { int id, from, to; };

static void seg_unigram(const SegModel& m, const std::vector<int>& seq,
                        int unk_id, std::vector<Triple>& out) {
    int n = (int)seq.size();
    out.clear();
    if (n <= 0) return;
    std::vector<int> best_begin(n, -1), best_id(n, -1);
    std::vector<double> best_score(n, -1e300);
    for (int start = 0; start < n; ++start) {
        bool unknown = true;
        int state = 0, sum_ow = 0;
        for (int i = start; i < n; ++i) {
            int ow = 0;
            state = m.aut.step(state, seq[i], &ow);
            if (state == -1) break;
            sum_ow += ow;
            if (state >= 0 && m.aut.final_[state]) {
                int k = sum_ow - m.min_key;
                int tid = (k >= 0 && k < (int)m.ids.size()) ? m.ids[k] : 0;
                float sf = (k >= 0 && k < (int)m.scores.size()) ? m.scores[k]
                                                                : 0.0f;
                double prev = start > 0 ? best_score[start - 1] : 0.0;
                double cand = (double)sf + prev;
                if (best_score[i] < cand) {
                    best_begin[i] = start;
                    best_id[i] = tid;
                    best_score[i] = cand;
                }
                unknown = false;
            }
        }
        if (unknown) {
            double prev = start > 0 ? best_score[start - 1] : 0.0;
            double cand = UNK_SCORE + prev;
            if (best_score[start] < cand) {
                best_begin[start] = start;
                best_id[start] = -1;
                best_score[start] = cand;
                if (start > 0 && best_id[start - 1] == -1)
                    best_begin[start] = best_begin[start - 1];
            }
        }
    }
    int end = n - 1;
    while (end >= 0) {
        int start = best_begin[end];
        int tid = best_id[end];
        out.push_back({tid != -1 ? tid : unk_id, start, end});
        end = start - 1;
    }
    std::reverse(out.begin(), out.end());
}

static void seg_bpe(const SegModel& m, const std::vector<int>& seq,
                    int unk_id, bool fast, bool with_merges,
                    std::vector<Triple>& out) {
    int n = (int)seq.size();
    out.clear();
    if (n <= 0) return;
    std::vector<Arc> arcs;
    arcs.reserve(4 * seq.size());
    int start = 0;
    while (start < n) {
        bool unknown = true;
        bool token_start = seq[start] == SPM;
        size_t arcs_at_start = arcs.size();
        int fast_forward = start;
        int state = 0, sum_ow = 0;
        for (int i = start; i < n; ++i) {
            int ow = 0;
            state = m.aut.step(state, seq[i], &ow);
            if (state == -1) break;
            sum_ow += ow;
            if (state >= 0 && m.aut.final_[state]) {
                int k = sum_ow - m.min_key;
                int tid = (k >= 0 && k < (int)m.ids.size()) ? m.ids[k] : 0;
                float rank = (k >= 0 && k < (int)m.scores.size())
                                 ? m.scores[k] : 0.0f;
                bool apply_opt =
                    fast && token_start &&
                    (i < n - 1 ? seq[i + 1] == SPM : true) &&
                    arcs_at_start < arcs.size();
                if (!apply_opt) {
                    arcs.push_back({start, i, tid, rank});
                } else {
                    arcs.resize(arcs_at_start);
                    arcs.push_back({start, i, tid, rank});
                    fast_forward = i;
                }
                unknown = false;
            }
        }
        if (unknown) {
            if (!arcs.empty() && arcs.back().id == unk_id)
                arcs.back().end = start;
            else
                arcs.push_back({start, start, unk_id, 0.0f});
        }
        if (fast) start = fast_forward;
        start += 1;
    }
    // (rank,id,start) / (id,start) are unique per arc — a vocab id at a
    // given start determines the arc — so an unstable sort is equivalent.
    // Sort packed integer keys instead of the 16-byte structs: one-compare
    // uint64/uint64 pairs are several times faster under std::sort.
    std::vector<std::pair<uint64_t, uint64_t>> keys;
    keys.reserve(arcs.size());
    if (with_merges) {
        for (size_t k = 0; k < arcs.size(); ++k) {
            // IEEE float -> order-preserving uint32, inverted for descending
            uint32_t rb;
            std::memcpy(&rb, &arcs[k].rank, 4);
            rb = (rb & 0x80000000u) ? ~rb : (rb | 0x80000000u);
            uint64_t hi = ((uint64_t)(~rb) << 32) | (uint32_t)arcs[k].id;
            keys.push_back({hi, ((uint64_t)(uint32_t)arcs[k].start << 32) | k});
        }
    } else {
        for (size_t k = 0; k < arcs.size(); ++k)
            keys.push_back({((uint64_t)(uint32_t)arcs[k].id << 32) |
                                (uint32_t)arcs[k].start,
                            k});
    }
    std::sort(keys.begin(), keys.end());
    std::vector<int> tos(n, 0), ids(n, unk_id);
    std::vector<uint8_t> inter(n, 0);
    for (auto& kv : keys) {
        const Arc& a = arcs[(uint32_t)kv.second];
        if (inter[a.start] == 0 && (a.end + 1 == n || inter[a.end + 1] == 0)) {
            tos[a.start] = a.end;
            ids[a.start] = a.id;
            for (int j = a.start + 1; j <= a.end; ++j) inter[j] = 1;
        }
    }
    int s = 0;
    while (s < n) {
        out.push_back({ids[s], s, tos[s]});
        s = tos[s] + 1;
    }
}

static void seg_process(const SegModel& m, const std::vector<int>& seq,
                        int unk_id, std::vector<Triple>& out) {
    switch (m.algo) {
        case ALGO_BPE:
            seg_bpe(m, seq, unk_id, false, false, out);
            break;
        case ALGO_BPE_OPT:
            seg_bpe(m, seq, unk_id, true, false, out);
            break;
        case ALGO_BPE_OPT_WITH_MERGES:
            seg_bpe(m, seq, unk_id, true, true, out);
            break;
        default:
            seg_unigram(m, seq, unk_id, out);
    }
}

// ---------------------------------------------------------------------------
// hyphenation engine (FAHyphInterpreter_core_t.h:136-267)
// ---------------------------------------------------------------------------

enum { HYPH_CONFLICT = -2, HYPH_UNKNOWN = -1, HYPH_NO_HYPH = 0,
       HYPH_DONT_CARE = 7 };

static bool hyph_process(const HyphModel& h, const std::vector<int>& word,
                         std::vector<int>& out) {
    int n = (int)word.size();
    if (n > MAX_WORD_SIZE) return false;
    std::vector<int> seq(n + 2);
    seq[0] = h.left_anchor;
    seq[n + 1] = h.right_anchor;
    for (int i = 0; i < n; ++i) {
        int c = word[i];
        if (h.ignore_case) c = fold_lower(c);
        if (h.has_charmap) {
            const int32_t* v;
            int cnt = h.charmap.get(c, &v);
            if (cnt == 1) c = v[0];
        }
        seq[i + 1] = c;
    }
    int n2 = n + 2;
    out.assign(n, HYPH_UNKNOWN);
    int js = 1;
    for (int frm = 0; frm < n2 - (h.min_pat_len - 1); ++frm) {
        int state = 0;
        for (int i = frm; i < n2; ++i) {
            state = h.aut.dest(state, seq[i]);
            if (state == -1) break;
            if (state >= 0 && h.aut.final_[state]) {
                int pat_id = h.aut.moore_ow[state];
                auto it = h.i2info.find(pat_id);
                if (it == h.i2info.end()) return false;
                const std::vector<int>& pat = it->second;
                int je = (int)pat.size();
                int oob = frm + (int)pat.size() - n;
                if (oob > 0) je -= oob;
                for (int j = js; j < je; ++j) {
                    int ow = pat[j];
                    if (ow == HYPH_DONT_CARE) continue;
                    int oi = frm + j - 1;
                    int cur = out[oi];
                    if (cur == HYPH_UNKNOWN) out[oi] = ow;
                    else if (cur != ow) out[oi] = HYPH_CONFLICT;
                }
            }
        }
        js = 0;
    }
    int k = std::min(h.no_hyph_len, n);
    for (int i = 0; i < k; ++i) {
        out[i] = HYPH_NO_HYPH;
        int j = n - i - 2;
        if (j > 0) out[j] = HYPH_NO_HYPH;
    }
    return true;
}

// ---------------------------------------------------------------------------
// product pipeline helpers
// ---------------------------------------------------------------------------

// charmap normalize with offsets (FAUtils_cl.h:312-436: 1->N, cap 10, drop >10)
static void charmap_normalize(const FixedMapDense& cm,
                              const std::vector<int>& in,
                              std::vector<int>& out, std::vector<int>& offs) {
    out.clear();
    offs.clear();
    for (size_t i = 0; i < in.size(); ++i) {
        const int32_t* v;
        int n = cm.get(in[i], &v);
        if (n < 0) {
            out.push_back(in[i]);
            offs.push_back((int)i);
        } else if (n >= 1 && n <= 10) {
            for (int k = 0; k < n; ++k) {
                out.push_back(v[k]);
                offs.push_back((int)i);
            }
        }
        // n == 0 or n > 10: dropped
    }
}

// whitespace runs -> single SPM, trailing trimmed (blingfiretokdll.cpp:1452-1496)
static void squeeze_ws(std::vector<int>& chars, std::vector<int>& offs) {
    size_t j = 0;
    for (size_t i = 0; i < chars.size(); ++i) {
        int c = chars[i];
        if (!is_whitespace(c)) {
            chars[j] = c;
            offs[j] = offs[i];
            ++j;
        } else if (j == 0 || chars[j - 1] != SPM) {
            chars[j] = SPM;
            offs[j] = offs[i];
            ++j;
        }
    }
    if (j > 1 && chars[j - 1] == SPM) --j;
    chars.resize(j);
    offs.resize(j);
}

// copy a built string per the product convention: append '\0', copy only if
// it fits, return full length including the terminator
static int emit_str(const std::string& s, char* out, int max_out) {
    int len = (int)s.size() + 1;
    if (out && len <= max_out) {
        std::memcpy(out, s.data(), s.size());
        out[s.size()] = 0;
    }
    return len;
}

// ---------------------------------------------------------------------------
// C ABI (names and conventions of blingfiretokdll.h:25-103)
// ---------------------------------------------------------------------------

}  // namespace btf

using namespace btf;

extern "C" {

int GetBlingFireTokVersion() { return 1000; }

void* SetModel(const unsigned char* pImgBytes, int ModelByteCount) {
    return load_model_bytes(pImgBytes, ModelByteCount);
}

void* LoadModel(const char* pszLdbFileName) {
    FILE* f = std::fopen(pszLdbFileName, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(sz > 0 ? sz : 0);
    if (sz > 0 && std::fread(buf.data(), 1, sz, f) != (size_t)sz) {
        std::fclose(f);
        return nullptr;
    }
    std::fclose(f);
    return load_model_bytes(buf.data(), (int)sz);
}

int FreeModel(void* ModelPtr) {
    delete (ModelData*)ModelPtr;
    return 1;
}

int SetNoDummyPrefix(void* ModelPtr, bool fNoDummyPrefix) {
    ModelData* md = (ModelData*)ModelPtr;
    if (!md || !md->has_seg) return 0;
    md->seg.no_dummy = fNoDummyPrefix;
    return 1;
}

// install the full-Unicode tolower table (framework extension; the Python
// binding passes runtime/casefold.py's table so ignore-case models match)
void SetCaseFoldTable(const int32_t* table, int count) {
    if (!table || count <= 0) {
        g_tolower.clear();
        return;
    }
    g_tolower.assign(table, table + count);
}

// -- words / sentences (blingfiretokdll.cpp:163-582) ------------------------

static int words_impl(const char* in, int n, char* out, int* starts,
                      int* ends, int max_out, void* h, bool sentences) {
    ModelData* md = (ModelData*)h;
    if (!md || !md->has_wbd) return -1;
    if (n == 0) return 0;
    if (n < 0 || !in) return -1;
    if (starts) std::memset(starts, 0, (size_t)max_out * sizeof(int));
    if (ends) std::memset(ends, 0, (size_t)max_out * sizeof(int));

    std::vector<int> cps, offs;
    if (!utf8_decode((const uint8_t*)in, n, cps, offs)) return -1;
    int m = (int)cps.size();
    if (m <= 0 || m > n) return -1;
    for (int i = 0; i < m; ++i)
        if (cps[i] == 0) cps[i] = 0x20;

    std::vector<int> res;
    lex_process(md->wbd, cps.data(), m, res, m * 3);

    std::string os;
    int count = 0;
    bool added = false;
    auto push_span = [&](int frm, int to) {
        if (starts && count < max_out) starts[count] = offs[frm];
        if (ends && count < max_out) {
            int sz = utf8_size_at((const uint8_t*)in, n, offs[to]);
            ends[count] = offs[to] + (sz > 0 ? sz - 1 : 0);
        }
        ++count;
        if (added) os.push_back(sentences ? '\n' : ' ');
        size_t at = os.size();
        for (int k = frm; k <= to; ++k) utf8_encode_cp(cps[k], os);
        // words: ' '->'_' (it is the delimiter); sentences: '\n'->' '
        for (size_t k = at; k < os.size(); ++k) {
            if (!sentences && os[k] == ' ') os[k] = '_';
            if (sentences && os[k] == '\n') os[k] = ' ';
        }
        added = true;
    };

    if (!sentences) {
        for (size_t i = 0; i < res.size(); i += 3) {
            if (res[i] == WBD_IGNORE_TAG) continue;
            push_span(res[i + 1], res[i + 2]);
        }
    } else {
        // sentence assembly (blingfiretokdll.cpp:250-330): spans between EOS
        // results; leading whitespace skipped; trailing text is a sentence
        int prev_end = -1;
        auto emit = [&](int frm, int to) {
            int delta = 0;
            while (frm + delta <= to && is_whitespace(cps[frm + delta]))
                ++delta;
            if (frm + delta <= to) push_span(frm + delta, to);
        };
        for (size_t i = 0; i < res.size(); i += 3) {
            int frm = prev_end + 1;
            int to = res[i + 2];
            prev_end = to;
            emit(frm, to);
        }
        if (prev_end + 1 < m) emit(prev_end + 1, m - 1);
    }
    return emit_str(os, out, max_out);
}

int TextToWordsWithOffsetsWithModel(const char* in, int n, char* out,
                                    int* starts, int* ends, const int max_out,
                                    void* h) {
    return words_impl(in, n, out, starts, ends, max_out, h, false);
}
int TextToWordsWithModel(const char* in, int n, char* out, const int max_out,
                         void* h) {
    return words_impl(in, n, out, nullptr, nullptr, max_out, h, false);
}
int TextToSentencesWithOffsetsWithModel(const char* in, int n, char* out,
                                        int* starts, int* ends,
                                        const int max_out, void* h) {
    return words_impl(in, n, out, starts, ends, max_out, h, true);
}
int TextToSentencesWithModel(const char* in, int n, char* out,
                             const int max_out, void* h) {
    return words_impl(in, n, out, nullptr, nullptr, max_out, h, true);
}

// Default wbd/sbd models are COMPILED IN as byte arrays (default_models.cxx,
// generated from the framework compiler's own binaries), exactly like the
// reference links BlingFireTokLib{Wbd,Sbd}Data.cxx (blingfiretokdll.cpp:
// 27-31).  Initialization is lazy behind a double-checked mutex (reference
// blingfiretokdll.cpp:42-44,174-190); SetDefaultModels still overrides.
extern const unsigned char g_dumpBlingFireTokLibWbdData[];
extern const unsigned int g_dumpBlingFireTokLibWbdData_size;
extern const unsigned char g_dumpBlingFireTokLibSbdData[];
extern const unsigned int g_dumpBlingFireTokLibSbdData_size;

static ModelData* g_default_wbd = nullptr;
static ModelData* g_default_sbd = nullptr;
static bool g_defaults_init = false;
static std::mutex g_defaults_mutex;
void* SetModel(const unsigned char* pImgBytes, int ModelByteCount);

static void ensure_default_models() {
    if (g_defaults_init) return;
    std::lock_guard<std::mutex> lock(g_defaults_mutex);
    if (g_defaults_init) return;
    if (!g_default_wbd)
        g_default_wbd = (ModelData*)SetModel(
            g_dumpBlingFireTokLibWbdData,
            (int)g_dumpBlingFireTokLibWbdData_size);
    if (!g_default_sbd)
        g_default_sbd = (ModelData*)SetModel(
            g_dumpBlingFireTokLibSbdData,
            (int)g_dumpBlingFireTokLibSbdData_size);
    g_defaults_init = true;
}

int SetDefaultModels(void* wbd, void* sbd) {
    std::lock_guard<std::mutex> lock(g_defaults_mutex);
    g_default_wbd = (ModelData*)wbd;
    g_default_sbd = (ModelData*)sbd;
    g_defaults_init = true;
    return 1;
}
int TextToWords(const char* in, int n, char* out, const int max_out) {
    ensure_default_models();
    return words_impl(in, n, out, nullptr, nullptr, max_out, g_default_wbd,
                      false);
}
int TextToWordsWithOffsets(const char* in, int n, char* out, int* starts,
                           int* ends, const int max_out) {
    ensure_default_models();
    return words_impl(in, n, out, starts, ends, max_out, g_default_wbd, false);
}
int TextToSentences(const char* in, int n, char* out, const int max_out) {
    ensure_default_models();
    return words_impl(in, n, out, nullptr, nullptr, max_out, g_default_sbd,
                      true);
}
int TextToSentencesWithOffsets(const char* in, int n, char* out, int* starts,
                               int* ends, const int max_out) {
    ensure_default_models();
    return words_impl(in, n, out, starts, ends, max_out, g_default_sbd, true);
}

// -- NormalizeSpaces (blingfiretokdll.cpp:629-683) ---------------------------

int NormalizeSpaces(const char* in, int n, char* out, const int max_out,
                    const int uSpace) {
    if (n == 0 || !in) return -1;
    std::vector<int> cps, offs;
    if (!utf8_decode((const uint8_t*)in, n, cps, offs)) return -1;
    int m = (int)cps.size();
    if (m <= 0 || m > n) return -1;
    std::string os;
    int last = -1;
    size_t written = 0;
    for (int i = 0; i < m; ++i) {
        int c = cps[i];
        if (!is_whitespace(c)) {
            utf8_encode_cp(c, os);
            last = c;
            ++written;
        } else if (written > 0 && last != uSpace) {
            utf8_encode_cp(uSpace, os);
            last = uSpace;
            ++written;
        }
    }
    if (written > 1 && last == uSpace) {
        // trim the trailing space (re-encode minus the last cp)
        std::string enc;
        utf8_encode_cp(uSpace, enc);
        os.resize(os.size() - enc.size());
    }
    int len = (int)os.size();
    if (len > max_out) return -1;  // FAArrayToStrUtf8 failure convention
    std::memcpy(out, os.data(), len);
    if (len < max_out) out[len] = 0;
    return len;
}

// -- TextToHashes (blingfiretokdll.cpp:686-815, fastText-compatible) --------

static inline uint32_t fnv_hash(const char* s, size_t len) {
    uint32_t h = 2166136261u;
    for (size_t i = 0; i < len; ++i) {
        h = h ^ (uint32_t)(int32_t)(int8_t)s[i];
        h = h * 16777619u;
    }
    return h;
}

int TextToHashes(const char* in, int n, int32_t* out, const int max_out,
                 int wordNgrams, int bucketSize) {
    if (!in || n < 0 || !out || wordNgrams <= 0 || bucketSize <= 0) return -1;
    static const int32_t EOS_HASH = (int32_t)fnv_hash("</s>", 4);
    // split on single spaces (input is pre-tokenized)
    std::vector<std::pair<int, int>> words;
    int b = 0;
    for (int i = 0; i <= n; ++i) {
        if (i == n || in[i] == ' ') {
            words.push_back({b, i - b});
            b = i + 1;
        }
    }
    int wc = (int)words.size();
    int64_t total = (int64_t)wc * wordNgrams;
    std::vector<int32_t> res(total, 0);
    for (int i = 0; i < wc; ++i)
        res[i] = (int32_t)fnv_hash(in + words[i].first, words[i].second);
    for (int i = 0; i < wc; ++i) {
        uint64_t h = (uint64_t)(int64_t)res[i];
        for (int j = i + 1; j < i + wordNgrams; ++j) {
            uint64_t temp =
                j < wc ? (uint64_t)(int64_t)res[j] : (uint64_t)(int64_t)EOS_HASH;
            h = h * 116049371ull + temp;
            res[(int64_t)(j - i) * wc + i] = (int32_t)(h % (uint64_t)bucketSize);
        }
    }
    int copy = (int)std::min<int64_t>(total, max_out);
    std::memcpy(out, res.data(), (size_t)copy * 4);
    return (int)total;
}

// -- WordHyphenationWithModel (blingfiretokdll.cpp:824-911) ------------------

int WordHyphenationWithModel(const char* in, int n, char* out,
                             const int max_out, void* h, const int uHy) {
    ModelData* md = (ModelData*)h;
    if (!md || !md->has_w2h) return -1;
    if (n == 0) return 0;
    if (n < 0 || !in) return -1;
    std::vector<int> cps, offs;
    if (!utf8_decode((const uint8_t*)in, n, cps, offs)) return -1;
    int m = (int)cps.size();
    if (m <= 0 || m > n) return -1;
    for (int i = 0; i < m; ++i)
        if (cps[i] == 0) cps[i] = 0x20;
    if (m > MAX_WORD_SIZE) cps.resize(m = MAX_WORD_SIZE);
    std::vector<int> ops;
    if (!hyph_process(md->w2h, cps, ops)) return -1;
    std::string os;
    for (int i = 0; i < m; ++i) {
        utf8_encode_cp(cps[i], os);
        if (ops[i] > HYPH_NO_HYPH) utf8_encode_cp(uHy, os);
    }
    int needed = (int)os.size();
    if (out && needed <= max_out) std::memcpy(out, os.data(), needed);
    if (out && needed < max_out) {
        out[needed] = 0;
        return needed + 1;
    }
    return needed;
}

// -- TextToIds family (blingfiretokdll.cpp:1097-1646) ------------------------

static int ids_wp(ModelData* md, const char* in, int n, int32_t* ids,
                  int* starts, int* ends, const int max_ids, const int unk) {
    const WbdModel& w = md->wbd;
    if (n <= 0 || !in) return 0;
    std::vector<int> cps, offs;
    if (!utf8_decode((const uint8_t*)in, n, cps, offs)) return 0;
    if ((int)cps.size() == 0 || (int)cps.size() > n) return 0;
    std::vector<int> norm_offs;
    bool use_norm = false;
    if (w.has_charmap) {
        std::vector<int> norm;
        charmap_normalize(w.charmap, cps, norm, norm_offs);
        if ((int)norm.size() <= 0 || (int)norm.size() > n) return 0;
        cps.swap(norm);
        use_norm = true;
    }
    std::vector<int> res;
    lex_process(w, cps.data(), (int)cps.size(), res, (int)cps.size() * 6);

    // WordPiece stitching (blingfiretokdll.cpp:1210-1311)
    int out_n = 0;
    auto emit = [&](int tid, int f, int t) {
        if (out_n >= max_ids) return;
        ids[out_n] = tid;
        if (starts && ends) {
            int fo = use_norm ? offs[norm_offs[f]] : offs[f];
            int to = use_norm ? offs[norm_offs[t]] : offs[t];
            starts[out_n] = fo;
            int sz = utf8_size_at((const uint8_t*)in, n, to);
            ends[out_n] = to + (sz > 0 ? sz - 1 : 0);
        }
        ++out_n;
    };
    size_t i = 0, nres = res.size();
    while (i + 2 < nres + 1 && i < nres) {
        int tag = res[i], tok_from = res[i + 1], tok_to = res[i + 2];
        if (tag == WBD_IGNORE_TAG) { i += 3; continue; }
        if (tag == WBD_WORD_TAG) {
            size_t j = i + 3;
            int num_sub = 0;
            bool covered = false;
            int expected_from = tok_from;
            while (j < nres && res[j] > WBD_IGNORE_TAG &&
                   expected_from == res[j + 1]) {
                expected_from = res[j + 2] + 1;
                ++num_sub;
                j += 3;
            }
            if (num_sub > 0 && expected_from - 1 == tok_to) {
                for (int k = 0; k < num_sub; ++k) {
                    size_t b = i + (size_t)(k + 1) * 3;
                    emit(res[b], res[b + 1], res[b + 2]);
                }
                covered = true;
            }
            if (!covered) emit(unk, tok_from, tok_to);
            i = j - 3;
        }
        if (out_n >= max_ids) break;
        i += 3;
    }
    return out_n;
}

static int ids_sp(ModelData* md, const char* in, int n, int32_t* ids,
                  int* starts, int* ends, const int max_ids, const int unk) {
    SegModel& m = md->seg;
    if (n <= 0 || !in) return 0;
    std::vector<int> chars, offs;
    if (m.raw_bytes) {
        utf8_as_bytes((const uint8_t*)in, n, chars, offs);
    } else if (!utf8_decode((const uint8_t*)in, n, chars, offs)) {
        return 0;
    }
    if ((int)chars.size() == 0 || (int)chars.size() > n) return 0;
    if (!m.no_dummy) {
        chars.insert(chars.begin(), SPM);
        offs.insert(offs.begin(), -1);
    }
    std::vector<int> char_offs;
    if (m.has_charmap) {
        std::vector<int> norm, no;
        charmap_normalize(m.charmap, chars, norm, no);
        if ((int)norm.size() <= 0 || (int)norm.size() > 2 * (n + 1)) return 0;
        chars.swap(norm);
        char_offs.swap(no);
    } else {
        char_offs.resize(chars.size());
        for (size_t i = 0; i < chars.size(); ++i) char_offs[i] = (int)i;
    }
    squeeze_ws(chars, char_offs);

    std::vector<Triple> triples;
    seg_process(m, chars, unk, triples);
    int out_n = 0;
    for (const Triple& t : triples) {
        if (out_n >= max_ids) break;
        ids[out_n] = t.id + m.id_offset;
        if (starts && ends) {
            int fo = offs[char_offs[t.from]];
            int to = offs[char_offs[t.to]];
            starts[out_n] = fo;
            int sz = utf8_size_at((const uint8_t*)in, n, to);
            ends[out_n] = to + (sz > 0 ? sz - 1 : 0);
        }
        ++out_n;
    }
    return out_n;
}

int TextToIdsWithOffsets_wp(void* h, const char* in, int n, int32_t* ids,
                            int* starts, int* ends, const int max_ids,
                            const int unk) {
    ModelData* md = (ModelData*)h;
    if (!md || !md->has_wbd) return 0;
    return ids_wp(md, in, n, ids, starts, ends, max_ids, unk);
}
int TextToIds_wp(void* h, const char* in, int n, int32_t* ids,
                 const int max_ids, const int unk) {
    ModelData* md = (ModelData*)h;
    if (!md || !md->has_wbd) return 0;
    return ids_wp(md, in, n, ids, nullptr, nullptr, max_ids, unk);
}
int TextToIdsWithOffsets_sp(void* h, const char* in, int n, int32_t* ids,
                            int* starts, int* ends, const int max_ids,
                            const int unk) {
    ModelData* md = (ModelData*)h;
    if (!md || !md->has_seg) return 0;
    return ids_sp(md, in, n, ids, starts, ends, max_ids, unk);
}
int TextToIds_sp(void* h, const char* in, int n, int32_t* ids,
                 const int max_ids, const int unk) {
    ModelData* md = (ModelData*)h;
    if (!md || !md->has_seg) return 0;
    return ids_sp(md, in, n, ids, nullptr, nullptr, max_ids, unk);
}
int TextToIdsWithOffsets(void* h, const char* in, int n, int32_t* ids,
                         int* starts, int* ends, const int max_ids,
                         const int unk) {
    ModelData* md = (ModelData*)h;
    if (!md) return 0;
    return md->has_seg ? ids_sp(md, in, n, ids, starts, ends, max_ids, unk)
                       : ids_wp(md, in, n, ids, starts, ends, max_ids, unk);
}
int TextToIds(void* h, const char* in, int n, int32_t* ids, const int max_ids,
              const int unk) {
    ModelData* md = (ModelData*)h;
    if (!md) return 0;
    return md->has_seg
               ? ids_sp(md, in, n, ids, nullptr, nullptr, max_ids, unk)
               : ids_wp(md, in, n, ids, nullptr, nullptr, max_ids, unk);
}

// -- IdsToText (blingfiretokdll.cpp:1689-1745) -------------------------------

int IdsToText(void* h, const int32_t* ids, const int count, char* out,
              const int max_out, bool skip_special) {
    ModelData* md = (ModelData*)h;
    if (!md || !md->has_i2w || !ids || count == 0) return 0;
    int actual = 0;
    for (int i = 0; i < count; ++i) {
        int id = ids[i];
        if (skip_special &&
            (id < md->i2w.min_token_id || id > md->i2w.max_token_id))
            continue;
        const uint8_t* tok;
        int len = md->i2w.sa.get(id, &tok);
        if (len < 0) return 0;  // unknown id
        if (actual == 0 && len > 0 && tok[0] == 0x20) {
            ++tok;
            --len;
        }
        if (len > 0 && max_out - actual >= len)
            std::memcpy(out + actual, tok, len);
        actual += len;
    }
    if (max_out > actual) out[actual] = 0;
    return actual + 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// WordPiece hybrid batch (TPU production path for bert-class models).
//
// The host runs the LEVEL-0 [wbd] scan only (words/ignores; sub-token
// functions are NOT recursed), interning each function span (typically a
// word — Zipf-repeated) once per batch.  The device then tokenizes the
// UNIQUE spans in dense packed rows, and BtlWpStitch writes flat per-doc
// ids from the device output.  Mirrors the unique-unit pipeline of
// native/prep.cpp for the [pos-dict] family.

// Cross-batch span cache (round 5, mirroring prep.cpp::BtlUnitCache): the
// (fn, folded cps) -> sub-token ids map persists across batches, so only
// never-resolved words are packed for the device.  Resolution codes in
// r_cnt: >= 0 ids in arena; -1 device-fallback; -2 uncovered -> emit unk.
struct WpCache {
    std::vector<int32_t> u_syms;     // concatenated guarded+folded span cps
    std::vector<int32_t> u_soff;     // (U+1)
    std::vector<int32_t> u_fn;       // fn id per unique span
    std::vector<int64_t> tab;
    int64_t mask = 0;
    std::vector<int64_t> r_off;      // -1 = unresolved
    std::vector<int32_t> r_cnt;
    std::vector<uint8_t> pending;
    std::vector<int32_t> r_ids;      // arena
    WpCache() { u_soff.push_back(0); }
    int32_t units() const { return (int32_t)u_soff.size() - 1; }
};

struct WpBatch {
    int n_docs = 0;
    WpCache* cache = nullptr;
    bool owns_cache = false;
    std::vector<int32_t> local_units;   // global ids packed THIS batch
    std::vector<int32_t> inst_unit;  // GLOBAL id; -1 = WORD w/o fn -> unk
    std::vector<int64_t> doc_inst_off;  // (B+1)
    std::vector<uint8_t> status;     // 0 ok / 1 invalid / 2 fallback
    int64_t total_cps = 0;
    ~WpBatch() {
        if (owns_cache) { delete cache; return; }
        for (int32_t u : local_units)
            if (cache->r_off[u] < 0) cache->pending[u] = 0;
    }
};

static uint64_t wp_hash(int fn, const int32_t* s, int len) {
    uint64_t h = ((uint64_t)fn << 32) ^ ((uint64_t)len * 0x9E3779B97F4A7C15ull);
    for (int i = 0; i < len; ++i)
        h = (h ^ (uint64_t)(uint32_t)s[i]) * 0x100000001B3ull;
    return h ^ (h >> 29);
}

static void wp_rehash(WpCache* c, int64_t cap) {
    c->tab.assign(cap, -1);
    c->mask = cap - 1;
    int U = c->units();
    for (int u = 0; u < U; ++u) {
        uint64_t h = wp_hash(c->u_fn[u], c->u_syms.data() + c->u_soff[u],
                             c->u_soff[u + 1] - c->u_soff[u]) & c->mask;
        while (c->tab[h] >= 0) h = (h + 1) & c->mask;
        c->tab[h] = u;
    }
}

// Read-only probe (safe from scan threads: all inserts happen serially).
static int32_t wp_lookup(const WpCache* c, int fn, const int32_t* s,
                         int len) {
    if (c->mask <= 0) return -1;
    uint64_t h = wp_hash(fn, s, len) & c->mask;
    while (true) {
        int64_t u = c->tab[h];
        if (u < 0) return -1;
        int ulen = c->u_soff[u + 1] - c->u_soff[u];
        if (ulen == len && c->u_fn[u] == fn &&
            memcmp(c->u_syms.data() + c->u_soff[u], s, (size_t)len * 4) == 0)
            return (int32_t)u;
        h = (h + 1) & c->mask;
    }
}

static int32_t wp_intern(WpCache* c, int fn, const int32_t* s, int len,
                         bool* fresh) {
    if ((int64_t)c->u_soff.size() * 2 + 2 > c->mask)
        wp_rehash(c, (c->mask + 1) * 2);
    uint64_t h = wp_hash(fn, s, len) & c->mask;
    while (true) {
        int64_t u = c->tab[h];
        if (u < 0) break;
        int ulen = c->u_soff[u + 1] - c->u_soff[u];
        if (ulen == len && c->u_fn[u] == fn &&
            memcmp(c->u_syms.data() + c->u_soff[u], s, (size_t)len * 4) == 0) {
            *fresh = false;
            return (int32_t)u;
        }
        h = (h + 1) & c->mask;
    }
    int32_t u = c->units();
    c->u_syms.insert(c->u_syms.end(), s, s + len);
    c->u_soff.push_back((int32_t)c->u_syms.size());
    c->u_fn.push_back(fn);
    c->r_off.push_back(-1);
    c->r_cnt.push_back(0);
    c->pending.push_back(0);
    c->tab[h] = u;
    *fresh = true;
    return u;
}

// level-0 scan of one document (lex_process_int semantics at rec_depth=1,
// once=false), recording WORD instances instead of recursing into functions.
// Returns false when the document must take the full native path.
// `shared` (nullable): a cross-batch cache probed READ-ONLY by scan
// threads; hits on resolved/in-flight words are recorded as global ids,
// misses intern locally and are encoded as -(lu + 2) (-1 stays "no-fn
// WORD -> unk") for the serial merge to remap.
static bool wp_scan_doc(const WbdModel& w, WpBatch* st,
                        const std::vector<int>& cps, int max_unit,
                        const WpCache* shared = nullptr) {
    int in_size = (int)cps.size();
    const int* seq = cps.data();
    std::vector<int32_t> folded;
    int from_pos = -1;
    while (from_pos < in_size) {
        int state = 0;
        int final_state = -1, final_pos = -1;
        int j = from_pos;
        int length_bound = std::min(from_pos + w.max_token_length, in_size);
        if (j == -1) {
            state = w.aut.dest(0, IW_L_ANCHOR);
            if (state == -1) {
                state = w.aut.dest(0, IW_ANY);
                if (state == -1) { from_pos += 1; continue; }
            }
            j += 1;
        }
        while (j < length_bound) {
            int iw = seq[j];
            if (iw < IW_EPSILON) iw = IW_EPSILON;
            if (w.ignore_case) iw = fold_lower(iw);
            int dst = w.dest_any(state, iw);
            if (dst == -1) break;
            if (dst >= 0 && w.aut.final_[dst]) { final_state = dst; final_pos = j; }
            state = dst;
            j += 1;
        }
        if (j == in_size) {
            int dst = w.aut.dest(state, IW_R_ANCHOR);
            if (dst == -1) dst = w.aut.dest(state, IW_ANY);
            if (dst != -1 && dst >= 0 && w.aut.final_[dst]) {
                final_state = dst;
                final_pos = j;
            }
        }
        if (final_pos != -1) {
            int ow = w.aut.moore_ow[final_state];
            auto it = w.acts.find(ow);
            if (it == w.acts.end() || it->second.size() < 3) return true;
            const std::vector<int>& act = it->second;
            int left_cx = act[0], right_cx = act[1], tag = act[2];
            int from2 = std::min(std::max(from_pos + left_cx, 0), in_size - 1);
            int to2 = std::min(std::max(final_pos - right_cx, 0), in_size - 1);
            size_t fn_idx = tag != 0 ? 4 : 3;
            int n_fns = (int)act.size() - (int)fn_idx;
            if (n_fns > 1) return false;  // multi-fn actions: full native path
            if (tag == WBD_WORD_TAG) {
                int fn = n_fns == 1 ? act[fn_idx] : -1;
                int fini = (fn >= 0 && fn < (int)w.fn2ini.size())
                               ? w.fn2ini[fn] : -1;
                if (fn >= 0 && fini >= 0 && w.max_depth >= 2) {
                    int len = to2 - from2 + 1;
                    if (len > max_unit) return false;  // oversize word
                    folded.resize(len);
                    for (int q = 0; q < len; ++q) {
                        int iw = seq[from2 + q];
                        if (iw < IW_EPSILON) iw = IW_EPSILON;
                        if (w.ignore_case) iw = fold_lower(iw);
                        folded[q] = iw;
                    }
                    if (shared) {
                        int32_t g = wp_lookup(shared, fn, folded.data(), len);
                        if (g >= 0 && (shared->r_off[g] >= 0 ||
                                       shared->pending[g])) {
                            st->inst_unit.push_back(g);
                        } else {
                            bool fresh = false;
                            int32_t lu = wp_intern(st->cache, fn,
                                                   folded.data(), len,
                                                   &fresh);
                            st->inst_unit.push_back(-(lu + 2));
                        }
                    } else {
                        WpCache* c = st->cache;
                        bool fresh = false;
                        int32_t u = wp_intern(c, fn, folded.data(), len,
                                              &fresh);
                        if (fresh || (c->r_off[u] < 0 && !c->pending[u])) {
                            st->local_units.push_back(u);
                            c->pending[u] = 1;
                        }
                        st->inst_unit.push_back(u);
                    }
                    st->total_cps += len;
                } else {
                    st->inst_unit.push_back(-1);  // WORD with no fn -> unk
                }
            }
            // non-WORD tags (XWORD/SEG/IGNORE/pure-fn) contribute no ids
            // (blingfiretokdll.cpp:1210-1311 skips them at the top level)
            if (final_pos - right_cx > from_pos)
                from_pos = final_pos - right_cx;
        }
        from_pos += 1;
    }
    return true;
}

extern "C" {

// out_counts: [0]=U unique spans, [1]=len(u_syms), [2]=I instances,
//             [3]=output-id capacity bound
void* BtlWpCacheNew() {
    WpCache* c = new WpCache();
    wp_rehash(c, 1 << 14);
    return c;
}
void BtlWpCacheFree(void* h) { delete (WpCache*)h; }
void BtlWpCacheStats(void* h, int64_t* out) {
    WpCache* c = (WpCache*)h;
    int U = c->units();
    int64_t resolved = 0;
    for (int u = 0; u < U; ++u) resolved += c->r_off[u] >= 0;
    out[0] = U;
    out[1] = resolved;
    out[2] = (int64_t)c->r_ids.size();
    out[3] = (int64_t)(c->u_syms.size() + c->r_ids.size()) * 4 +
             (int64_t)(c->tab.size() + c->r_off.size()) * 8;
}

// Scan a contiguous doc range into `st` (st->cache must be private to the
// calling thread; doc/instance offsets are st-relative starting at d0).
static void wp_scan_range(const WbdModel& w, WpBatch* st, const char* docs,
                          const int64_t* doc_off, int d0, int d1,
                          int max_unit, const WpCache* shared = nullptr) {
    std::vector<int> cps, offs;
    for (int d = d0; d < d1; ++d) {
        st->doc_inst_off[d - d0] = (int64_t)st->inst_unit.size();
        const uint8_t* p = (const uint8_t*)docs + doc_off[d];
        int n = (int)(doc_off[d + 1] - doc_off[d]);
        if (n <= 0) { st->status[d - d0] = 1; continue; }
        cps.clear(); offs.clear();
        if (!utf8_decode(p, n, cps, offs) || (int)cps.size() == 0 ||
            (int)cps.size() > n) {
            st->status[d - d0] = 1;
            continue;
        }
        if (w.has_charmap) {
            std::vector<int> norm, no;
            charmap_normalize(w.charmap, cps, norm, no);
            if ((int)norm.size() <= 0 || (int)norm.size() > n) {
                st->status[d - d0] = 1;
                continue;
            }
            cps.swap(norm);
        }
        size_t mark = st->inst_unit.size();
        if (!wp_scan_doc(w, st, cps, max_unit, shared)) {
            st->inst_unit.resize(mark);  // discard partial instances
            st->status[d - d0] = 2;
        }
    }
    st->doc_inst_off[d1 - d0] = (int64_t)st->inst_unit.size();
}

void* BtlWpAnalyzeC(void* cache_h, void* model, const char* docs,
                    const int64_t* doc_off,
                    int n_docs, int max_unit, int64_t* out_counts) {
    ModelData* md = (ModelData*)model;
    if (!md || !md->has_wbd) return nullptr;
    const WbdModel& w = md->wbd;
    WpBatch* st = new WpBatch();
    st->n_docs = n_docs;
    st->status.assign(n_docs, 0);
    st->doc_inst_off.assign(n_docs + 1, 0);
    if (cache_h) {
        st->cache = (WpCache*)cache_h;
        st->owns_cache = false;
    } else {
        st->cache = new WpCache();
        st->owns_cache = true;
        wp_rehash(st->cache, 1 << 14);
    }

    // The level-0 scan is the CPU-heavy stage and is per-doc independent:
    // shard docs across threads, each scanning into a PRIVATE intern, then
    // merge the shards into the shared cache serially (cheap: unique units
    // only).  n_threads caps at the core count (2 on this box).
    int n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads > 4) n_threads = 4;
    if (n_threads < 1) n_threads = 1;
    int64_t total_bytes = doc_off[n_docs] - doc_off[0];
    if (n_threads > 1 && n_docs >= 64 && total_bytes >= (64 << 10)) {
        std::vector<WpBatch*> shards(n_threads);
        std::vector<std::thread> threads;
        std::vector<int> bounds(n_threads + 1);
        for (int t = 0; t <= n_threads; ++t)
            bounds[t] = (int)((int64_t)n_docs * t / n_threads);
        for (int t = 0; t < n_threads; ++t) {
            WpBatch* sh = new WpBatch();
            int nd = bounds[t + 1] - bounds[t];
            sh->n_docs = nd;
            sh->status.assign(nd, 0);
            sh->doc_inst_off.assign(nd + 1, 0);
            sh->cache = new WpCache();
            sh->owns_cache = true;
            wp_rehash(sh->cache, 1 << 14);
            shards[t] = sh;
            const WpCache* shc = st->cache;
            threads.emplace_back([&w, sh, docs, doc_off, t, &bounds,
                                  max_unit, shc]() {
                wp_scan_range(w, sh, docs, doc_off, bounds[t], bounds[t + 1],
                              max_unit, shc);
            });
        }
        for (auto& th : threads) th.join();
        // serial merge into the shared cache
        WpCache* c = st->cache;
        std::vector<int32_t> remap;
        for (int t = 0; t < n_threads; ++t) {
            WpBatch* sh = shards[t];
            WpCache* lc = sh->cache;
            int LU = lc->units();
            remap.assign(LU, -1);
            for (int lu = 0; lu < LU; ++lu) {
                bool fresh = false;
                int32_t g = wp_intern(
                    c, lc->u_fn[lu], lc->u_syms.data() + lc->u_soff[lu],
                    lc->u_soff[lu + 1] - lc->u_soff[lu], &fresh);
                if (fresh || (c->r_off[g] < 0 && !c->pending[g])) {
                    st->local_units.push_back(g);
                    c->pending[g] = 1;
                }
                remap[lu] = g;
            }
            int d0 = bounds[t];
            for (int d = 0; d < sh->n_docs; ++d) {
                st->doc_inst_off[d0 + d] =
                    (int64_t)st->inst_unit.size();
                st->status[d0 + d] = sh->status[d];
                for (int64_t i = sh->doc_inst_off[d];
                     i < sh->doc_inst_off[d + 1]; ++i) {
                    int32_t v = sh->inst_unit[i];
                    st->inst_unit.push_back(
                        v >= 0 ? v : (v == -1 ? -1 : remap[-(v + 2)]));
                }
            }
            st->total_cps += sh->total_cps;
            delete sh;
        }
    } else {
        wp_scan_range(w, st, docs, doc_off, 0, n_docs, max_unit);
    }
    st->doc_inst_off[n_docs] = (int64_t)st->inst_unit.size();
    // counts describe the LOCAL (to-pack) units; [4] = global intern size
    WpCache* c = st->cache;
    int64_t s_local = 0;
    for (int32_t u : st->local_units)
        s_local += c->u_soff[u + 1] - c->u_soff[u];
    out_counts[0] = (int64_t)st->local_units.size();
    out_counts[1] = s_local;
    out_counts[2] = (int64_t)st->inst_unit.size();
    out_counts[3] = st->total_cps + (int64_t)st->inst_unit.size() + 16;
    out_counts[4] = c->units();
    return st;
}

void* BtlWpAnalyze(void* model, const char* docs, const int64_t* doc_off,
                   int n_docs, int max_unit, int64_t* out_counts) {
    int64_t c5[5];
    void* st = BtlWpAnalyzeC(nullptr, model, docs, doc_off, n_docs, max_unit,
                             c5);
    for (int i = 0; i < 4; ++i) out_counts[i] = c5[i];
    return st;
}

// Emit the LOCAL units (this batch's cache misses) for device packing.
void BtlWpUnits(void* h, int32_t* u_syms, int32_t* u_soff, int32_t* u_fn) {
    WpBatch* st = (WpBatch*)h;
    WpCache* c = st->cache;
    int64_t s = 0;
    u_soff[0] = 0;
    for (size_t li = 0; li < st->local_units.size(); ++li) {
        int32_t u = st->local_units[li];
        int len = c->u_soff[u + 1] - c->u_soff[u];
        memcpy(u_syms + s, c->u_syms.data() + c->u_soff[u], (size_t)len * 4);
        s += len;
        u_soff[li + 1] = (int32_t)s;
        u_fn[li] = c->u_fn[u];
    }
}

// rows: (rows_n, stride) int32 device output; lane j < count holds
// (tag+1) | from<<20 | to<<25 | nested<<30 in ROW coordinates; col
// stride-2 = count, col stride-1 = reserved.  u_row/u_off give each unique
// span's packed position.  Returns total ids written, -1 on cap overflow.
int64_t BtlWpStitch(void* h, const int32_t* rows, int64_t rows_n, int stride,
                    const int32_t* u_row, const int32_t* u_off, int unk_id,
                    int32_t* out_ids, int64_t cap, int64_t* out_bounds,
                    uint8_t* need_fb) {
    WpBatch* st = (WpBatch*)h;
    WpCache* c = st->cache;
    int NL = (int)st->local_units.size();
    // resolve this batch's LOCAL units from the device rows into the cache
    // (u_row/u_off index the local list); recurring units across batches
    // read straight from the cache arena (cross-batch dedup).
    // Local units sorted by (row, off) so each row is walked once.
    std::vector<int32_t> order(NL);
    for (int li = 0; li < NL; ++li) order[li] = li;
    std::sort(order.begin(), order.end(), [&](int a, int b) {
        if (u_row[a] != u_row[b]) return u_row[a] < u_row[b];
        return u_off[a] < u_off[b];
    });
    std::vector<int32_t> tmp;
    for (int oi = 0; oi < NL; ++oi) {
        int li = order[oi];
        int32_t u = st->local_units[li];
        int r = u_row[li];
        int off = u_off[li];
        int ulen = c->u_soff[u + 1] - c->u_soff[u];
        c->pending[u] = 0;
        if (r >= rows_n) {
            if (c->r_off[u] < 0) { c->r_off[u] = 0; c->r_cnt[u] = -1; }
            continue;
        }
        const int32_t* row = rows + (int64_t)r * stride;
        int cnt = row[stride - 2];
        // lane format (ops/lexer.py::pack_lex_rows): (tag+1) in bits 0..16,
        // row-local from in 17..23, to in 24..30, nested-fn flag in bit 31.
        // Matches are start-ascending within the row; reproduce the
        // reference tiling check (blingfiretokdll.cpp:1226-1279) in
        // unit-relative coordinates.
        tmp.clear();
        bool nested = false;
        int expected = 0;
        bool broken = false;
        for (int j = 0; j < cnt && j < stride - 2; ++j) {
            int32_t v = row[j];
            int f = (v >> 17) & 0x7F;
            if (f < off || f >= off + ulen) continue;  // other unit's match
            if (v < 0) nested = true;  // bit 31 = nested-fn flag
            int tag = (v & 0x1FFFF) - 1;
            int rt = ((v >> 24) & 0x7F) - off;
            if (!broken && tag > WBD_IGNORE_TAG && f - off == expected) {
                expected = rt + 1;
                tmp.push_back(tag);
            } else {
                broken = true;
            }
        }
        int sub_n = (int)tmp.size();
        bool covered = (sub_n > 0) && (expected == ulen) && !broken;
        if (nested) {
            c->r_off[u] = 0;
            c->r_cnt[u] = -1;  // device-fallback
        } else if (covered) {
            c->r_off[u] = (int64_t)c->r_ids.size();
            c->r_cnt[u] = sub_n;
            c->r_ids.insert(c->r_ids.end(), tmp.begin(), tmp.end());
        } else {
            c->r_off[u] = 0;
            c->r_cnt[u] = -2;  // uncovered word -> emit caller's unk id
        }
    }
    int64_t t = 0;
    out_bounds[0] = 0;
    for (int d = 0; d < st->n_docs; ++d) {
        int64_t i0 = st->doc_inst_off[d], i1 = st->doc_inst_off[d + 1];
        bool fb = st->status[d] == 2;
        for (int64_t i = i0; !fb && i < i1; ++i) {
            int32_t u = st->inst_unit[i];
            if (u >= 0 && (c->r_off[u] < 0 || c->r_cnt[u] == -1)) fb = true;
        }
        need_fb[d] = fb ? 1 : 0;
        if (!fb && st->status[d] == 0) {
            for (int64_t i = i0; i < i1; ++i) {
                int32_t u = st->inst_unit[i];
                if (u < 0 || c->r_cnt[u] == -2) {
                    if (t + 1 > cap) return -1;
                    out_ids[t++] = unk_id;
                } else {
                    int cc = c->r_cnt[u];
                    if (t + cc > cap) return -1;
                    memcpy(out_ids + t, c->r_ids.data() + c->r_off[u],
                           (size_t)cc * 4);
                    t += cc;
                }
            }
        }
        out_bounds[d + 1] = t;
    }
    return t;
}

void BtlWpFree(void* h) { delete (WpBatch*)h; }

}  // extern "C"

// optional micro-benchmark entry (build with -DBTF_BENCH_MAIN)
#ifdef BTF_BENCH_MAIN
int main(int argc, char** argv) {
    if (argc < 2) return 2;  // usage: <binary> model.bin
    void* h = LoadModel(argv[1]);
    if (!h) return 1;
    const char* line =
        "The quick brown fox jumps over the lazy dog while the committee "
        "discussed infrastructure development of rural areas in 2023.";
    int n = (int)std::strlen(line);
    int32_t ids[512];
    long total = 0;
    for (int i = 0; i < 200000; ++i) total += TextToIds(h, line, n, ids, 512, 0);
    std::printf("total ids: %ld\n", total);
    return 0;
}
#endif
