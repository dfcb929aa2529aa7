// Copy of blingfire_tpu/native/prep.cpp, built by blingfire_tpu_torch/native/__init__.py.
// Native host-side batch preparation for the TPU tokenizer runtime.
//
// Performs the byte-level prelude of the sentence-piece pipeline
// (semantics: blingfiretokdll.cpp:1349-1496 in the reference):
//   UTF-8 validation/decoding (or raw-byte mode), BOM strip, dummy-prefix
//   insertion, charmap normalization (1->N), whitespace-run squeeze to
//   U+2581, dense-alphabet remap, and fixed-shape batch packing.
//
// Exposed as a C ABI consumed via ctypes; one call prepares a whole batch.
// This is the production data-loader path; the NumPy implementation in
// runtime/host.py remains as the reference/fallback.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// whitespace class, blingfiretokdll.h:16-21
static inline bool is_ws(int32_t c) {
    return (c <= 0x20 || c == 0xa0 || (c >= 0x2000 && c <= 0x200f) ||
            c == 0x202f || c == 0x205f || c == 0x2060 || c == 0x2420 ||
            c == 0x2424 || c == 0x3000 || c == 0xfeff);
}

static const int32_t SPM = 0x2581;

// strict UTF-8 decode (FAUtf8Utils.cpp:58-118): returns count or -1
static int decode_utf8(const uint8_t* s, int n, int32_t* out, int32_t* offs,
                       int max_out) {
    int i = 0;
    if (n >= 3 && s[0] == 0xEF && s[1] == 0xBB && s[2] == 0xBF) i = 3;
    int k = 0;
    while (i < n && k < max_out) {
        uint8_t b0 = s[i];
        int cnt, ch;
        if ((b0 & 0x80) == 0) { cnt = 1; ch = b0; }
        else if ((b0 & 0xE0) == 0xC0) { cnt = 2; ch = b0 & 0x1F; }
        else if ((b0 & 0xF0) == 0xE0) { cnt = 3; ch = b0 & 0x0F; }
        else if ((b0 & 0xF8) == 0xF0) { cnt = 4; ch = b0 & 0x07; }
        else return -1;
        if (i + cnt > n) return -1;
        for (int j = 1; j < cnt; ++j) {
            uint8_t bj = s[i + j];
            if ((bj & 0xC0) != 0x80) return -1;
            ch = (ch << 6) | (bj & 0x3F);
        }
        int exp = ch <= 0x7F ? 1 : ch <= 0x7FF ? 2 : ch <= 0xFFFF ? 3
                 : ch <= 0x10FFFF ? 4 : 0;
        if (exp != cnt) return -1;
        if ((ch & 0xFFFFF800) == 0xD800) return -1;
        out[k] = ch;
        if (offs) offs[k] = i;
        ++k;
        i += cnt;
    }
    return k;
}

// Prepare one batch of documents for the [pos-dict] device kernels.
//
//  docs        concatenated document bytes
//  doc_off     int64[n_docs+1] offsets into docs
//  use_raw_bytes / no_dummy_prefix  model flags
//  cm_*        charmap tables (NULL cm_counts disables): dense over
//              [cm_min, cm_max], counts<0 = identity, 0 or >10 = drop
//  sym2iw      dense raw-symbol -> input-weight map, length sym2iw_len
//              (missing symbols map to -1 = walk dies)
//  n_sym       row width of the output batch
//  x_iw        int32[n_docs * n_sym]  (pre-filled by caller or not; we fill)
//  is_spm      uint8[n_docs * n_sym]
//  lengths     int32[n_docs]
//  sym_off     int32[n_docs * n_sym] byte offset per kept symbol (or NULL)
//  status      uint8[n_docs]: 0 ok, 1 invalid-input, 2 overflow(fallback)
//
// scratch workspace is allocated internally per call (thread-local reuse).
// Shared per-doc prelude: decode -> dummy prefix -> charmap -> ws squeeze.
// Writes raw (pre-remap) symbols into *pcur / offsets into *pcuro (pointers
// into the caller's buf/nbuf scratch, capacity >= 10*n+16 each).  Returns the
// symbol count k, or -1 for invalid input (status 1).
static int prep_doc_syms(const uint8_t* p, int n, int use_raw_bytes,
                         int no_dummy_prefix, const int32_t* cm_counts,
                         const int32_t* cm_values, int cm_width, int cm_min,
                         int cm_max, int32_t* buf, int32_t* offs,
                         int32_t* nbuf, int32_t* noffs, int32_t** pcur,
                         int32_t** pcuro) {
    if (n == 0) return -1;
    int base = 0;
    if (!no_dummy_prefix) { buf[0] = SPM; if (offs) offs[0] = -1; base = 1; }
    int got;
    if (use_raw_bytes) {
        int i = 0;
        if (n >= 3 && p[0] == 0xEF && p[1] == 0xBB && p[2] == 0xBF) i = 3;
        got = 0;
        for (; i < n; ++i) {
            buf[base + got] = p[i];
            if (offs) offs[base + got] = i;
            ++got;
        }
    } else {
        got = decode_utf8(p, n, buf + base, offs ? offs + base : nullptr, n);
    }
    if (got <= 0 || got > n) return -1;
    int k = base + got;

    // charmap normalization (FAUtils_cl.h:312-436)
    int32_t* cur = buf;
    int32_t* curo = offs;
    if (cm_counts) {
        int m = 0;
        for (int i = 0; i < k; ++i) {
            int32_t c = cur[i];
            int cnt = -1;
            if (c >= cm_min && c <= cm_max) cnt = cm_counts[c - cm_min];
            if (cnt > cm_width) cnt = -1;
            if (cnt < 0) {
                nbuf[m] = c;
                if (noffs) noffs[m] = curo[i];
                ++m;
            } else if (cnt >= 1 && cnt <= 10) {
                const int32_t* v = cm_values + (int64_t)(c - cm_min) * cm_width;
                for (int j = 0; j < cnt; ++j) {
                    nbuf[m] = v[j];
                    if (noffs) noffs[m] = curo[i];
                    ++m;
                }
            } // cnt == 0 or > 10: dropped
        }
        // reference bails out when normalization overflows its
        // 2*(bytes+1) buffer (blingfiretokdll.cpp:1438-1445)
        if (m <= 0 || m > 2 * (n + 1)) return -1;
        cur = nbuf;
        curo = noffs;
        k = m;
    }

    // whitespace squeeze (blingfiretokdll.cpp:1462-1496)
    int w = 0;
    for (int i = 0; i < k; ++i) {
        int32_t c = cur[i];
        if (!is_ws(c)) {
            cur[w] = c;
            if (curo) curo[w] = curo[i];
            ++w;
        } else if (w == 0 || cur[w - 1] != SPM) {
            cur[w] = SPM;
            if (curo) curo[w] = curo[i];
            ++w;
        }
    }
    if (w > 1 && cur[w - 1] == SPM) --w;
    *pcur = cur;
    *pcuro = curo;
    return w;
}

int btl_prep_sp_batch(const uint8_t* docs, const int64_t* doc_off, int n_docs,
                      int use_raw_bytes, int no_dummy_prefix,
                      const int32_t* cm_counts, const int32_t* cm_values,
                      int cm_width, int cm_min, int cm_max,
                      const int32_t* sym2iw, int64_t sym2iw_len,
                      int n_sym, int32_t* x_iw, uint8_t* is_spm,
                      int32_t* lengths, int32_t* sym_off, uint8_t* status) {
    // worst case symbols per doc: 2 * bytes + 1 (charmap can double)
    int64_t max_doc = 0;
    for (int d = 0; d < n_docs; ++d) {
        int64_t len = doc_off[d + 1] - doc_off[d];
        if (len > max_doc) max_doc = len;
    }
    int64_t cap = 10 * max_doc + 16;  // charmap may expand 1 -> up to 10
    int32_t* buf = new int32_t[cap];
    int32_t* offs = sym_off ? new int32_t[cap] : nullptr;
    int32_t* nbuf = new int32_t[cap];
    int32_t* noffs = sym_off ? new int32_t[cap] : nullptr;

    for (int d = 0; d < n_docs; ++d) {
        const uint8_t* p = docs + doc_off[d];
        int n = (int)(doc_off[d + 1] - doc_off[d]);
        int32_t* xrow = x_iw + (int64_t)d * n_sym;
        uint8_t* srow = is_spm + (int64_t)d * n_sym;
        int32_t* orow = sym_off ? sym_off + (int64_t)d * n_sym : nullptr;
        for (int j = 0; j < n_sym; ++j) { xrow[j] = -1; srow[j] = 0; }
        lengths[d] = 0;
        status[d] = 0;

        int32_t *cur, *curo;
        int k = prep_doc_syms(p, n, use_raw_bytes, no_dummy_prefix, cm_counts,
                              cm_values, cm_width, cm_min, cm_max, buf, offs,
                              nbuf, noffs, &cur, &curo);
        if (k < 0) { status[d] = 1; continue; }
        if (k > n_sym) { status[d] = 2; continue; }

        // dense remap + pack
        for (int i = 0; i < k; ++i) {
            int32_t c = cur[i];
            xrow[i] = (c >= 0 && c < sym2iw_len) ? sym2iw[c] : -1;
            srow[i] = (c == SPM) ? 1 : 0;
            if (orow) orow[i] = curo[i];
        }
        lengths[d] = k;
    }

    delete[] buf;
    delete[] nbuf;
    if (offs) delete[] offs;
    if (noffs) delete[] noffs;
    return 0;
}

// ---------------------------------------------------------------------------
// Unique-word-unit batch pipeline (native twin of runtime/dedup.py).
//
// One pass over the documents produces everything the device path needs:
//   * unique units (deduped on their dense-iw symbol sequence),
//   * a greedy dense packing of the unique units into n_sym-wide rows
//     (non-SPM-initial units each open a row; SPM-initial units fill on —
//     identical layout rules to dedup.pack_units),
//   * the doc-major instance list used to stitch per-document ids back
//     together after the device pass.
//
// Protocol: analyze() builds the state and reports sizes; emit() fills the
// caller-allocated device input arrays; stitch() consumes the device OUTPUT
// (compact (id+1)|start<<shift lanes) and writes flat ids + per-doc bounds
// in one pass; free() releases the state (stitch frees implicitly).

// SPM-initial units are packed into length-class row regions walked with
// short unrolled kernels.  Must match dedup.LW_CLASSES on the Python side.
static const int BTL_LW1 = 8;   // region A1: units <= 8 symbols
static const int BTL_LW2 = 16;  // region A2: units 9..16 symbols

// Cross-batch unit cache (VERDICT r4 #1b): interned units + their resolved
// token ids persist across batches, so dedup is CUMULATIVE over a corpus —
// a batch only dispatches units never resolved before.  Resolution is
// context-free under the chunk-safe vocabulary property (the same property
// that licenses per-batch dedup), so a cached (unit -> ids) entry is exact
// wherever the unit recurs.
struct BtlUnitCache {
    std::vector<int32_t> u_syms;       // concatenated unique-unit iw symbols
    std::vector<int32_t> u_soff;       // (U+1) offsets into u_syms
    std::vector<int64_t> hash_tab;     // open addressing: -1 empty, else unit id
    int64_t hash_mask = 0;
    // resolution state per unit:
    //   r_off < 0                unresolved
    //   r_off >= 0, r_cnt >= 0   ids = r_ids[r_off .. r_off + r_cnt)
    //   r_off >= 0, r_cnt < 0    resolved-fallback (the device flagged
    //                            the unit: a marked lane of it, or its row)
    std::vector<int64_t> r_off;
    std::vector<int32_t> r_cnt;
    std::vector<uint8_t> pending;      // packed by an in-flight batch
    std::vector<int32_t> r_ids;        // arena of resolved token ids
    BtlUnitCache() { u_soff.push_back(0); }
    int32_t units() const { return (int32_t)u_soff.size() - 1; }
};

struct BtlUnitsState {
    int n_docs = 0, n_sym = 0;
    int split_rows1 = 0;  // end of region A1
    int split_rows = 0;   // end of region A2 (== A1 end when empty)
    BtlUnitCache* cache = nullptr;     // shared intern/result store
    bool owns_cache = false;           // private cache (classic single-batch)
    std::vector<int32_t> local_units;  // units packed into THIS batch's rows
    std::vector<int32_t> u_row, u_off; // packing position per local unit idx
    std::vector<int32_t> inst_unit;    // (I) GLOBAL unit id per instance
    std::vector<int64_t> doc_inst_off; // (B+1)
    std::vector<uint8_t> status;       // (B) 0 ok / 1 invalid / 2 overflow
    std::vector<int32_t> row_unit_off; // (R+1) units per row, offset-ordered
    std::vector<int32_t> row_units;    // LOCAL unit idx sorted by (row, off)
    int64_t total_syms = 0;            // sum of kept per-doc symbol counts
    int R = 0;
    ~BtlUnitsState() {
        if (owns_cache) { delete cache; return; }
        // freed without stitch (error path): release in-flight claims so a
        // later batch can pack these units again
        for (int32_t u : local_units)
            if (cache->r_off[u] < 0) cache->pending[u] = 0;
    }
};

static uint64_t hash_syms(const int32_t* s, int len) {
    uint64_t h = (uint64_t)len * 0x9E3779B97F4A7C15ull;
    for (int i = 0; i < len; ++i)
        h = (h ^ (uint64_t)(uint32_t)s[i]) * 0x100000001B3ull;
    return h ^ (h >> 29);
}

static void units_rehash(BtlUnitCache* c, int64_t cap) {
    c->hash_tab.assign(cap, -1);
    c->hash_mask = cap - 1;
    int U = c->units();
    for (int u = 0; u < U; ++u) {
        const int32_t* s = c->u_syms.data() + c->u_soff[u];
        int len = c->u_soff[u + 1] - c->u_soff[u];
        uint64_t h = hash_syms(s, len) & c->hash_mask;
        while (c->hash_tab[h] >= 0) h = (h + 1) & c->hash_mask;
        c->hash_tab[h] = u;
    }
}

// Read-only probe: id of syms[0..len) in `c`, or -1.  Safe from scan
// threads while no writer mutates `c` (analyze threads only read the
// shared cache; all inserts happen in the serial merge).
static int32_t unit_lookup(const BtlUnitCache* c, const int32_t* s, int len) {
    if (c->hash_mask <= 0) return -1;
    uint64_t h = hash_syms(s, len) & c->hash_mask;
    while (true) {
        int64_t u = c->hash_tab[h];
        if (u < 0) return -1;
        int ulen = c->u_soff[u + 1] - c->u_soff[u];
        if (ulen == len &&
            memcmp(c->u_syms.data() + c->u_soff[u], s,
                   (size_t)len * 4) == 0)
            return (int32_t)u;
        h = (h + 1) & c->hash_mask;
    }
}

// Returns the unique-unit id for syms[0..len), inserting if unseen
// (*fresh = true for a newly interned unit).
static int32_t unit_intern(BtlUnitCache* c, const int32_t* s, int len,
                           bool* fresh) {
    if ((int64_t)(c->u_soff.size()) * 2 + 2 > c->hash_mask)
        units_rehash(c, (c->hash_mask + 1) * 2);
    uint64_t h = hash_syms(s, len) & c->hash_mask;
    while (true) {
        int64_t u = c->hash_tab[h];
        if (u < 0) break;
        int ulen = c->u_soff[u + 1] - c->u_soff[u];
        if (ulen == len &&
            memcmp(c->u_syms.data() + c->u_soff[u], s,
                   (size_t)len * 4) == 0) {
            *fresh = false;
            return (int32_t)u;
        }
        h = (h + 1) & c->hash_mask;
    }
    int32_t u = c->units();
    c->u_syms.insert(c->u_syms.end(), s, s + len);
    c->u_soff.push_back((int32_t)c->u_syms.size());
    c->r_off.push_back(-1);
    c->r_cnt.push_back(0);
    c->pending.push_back(0);
    c->hash_tab[h] = u;
    *fresh = true;
    return u;
}

// Persistent cross-batch unit cache handles.
void* btl_ucache_new() {
    BtlUnitCache* c = new BtlUnitCache();
    units_rehash(c, 1 << 14);
    return c;
}

void btl_ucache_free(void* h) { delete (BtlUnitCache*)h; }

// out_stats: [0]=interned units, [1]=resolved units, [2]=arena ids,
//            [3]=approx bytes held
void btl_ucache_stats(void* h, int64_t* out_stats) {
    BtlUnitCache* c = (BtlUnitCache*)h;
    int U = c->units();
    int64_t resolved = 0;
    for (int u = 0; u < U; ++u) resolved += c->r_off[u] >= 0;
    out_stats[0] = U;
    out_stats[1] = resolved;
    out_stats[2] = (int64_t)c->r_ids.size();
    out_stats[3] = (int64_t)(c->u_syms.size() + c->r_ids.size()) * 4 +
                   (int64_t)(c->hash_tab.size() + c->r_off.size()) * 8;
}

// out_counts: [0]=U units referenced, [1]=I instances, [2]=R packed rows,
//             [3]=total kept symbols (an upper bound on emitted tokens),
//             [4]=end row of length-class region A2, [5]=end of region A1,
//             [6]=units newly packed this batch (cache misses)
//
// `cache` may be NULL (a private single-batch cache is used — the classic
// behavior).  With a shared cache, only units with no resolution and no
// in-flight packing are packed into this batch's rows; everything else is
// stitched from the cache (batches must be stitched in dispatch order).
void* btl_units_analyze_c(void* cache_h, const uint8_t* docs,
                          const int64_t* doc_off,
                          int n_docs, int use_raw_bytes, int no_dummy_prefix,
                          const int32_t* cm_counts, const int32_t* cm_values,
                          int cm_width, int cm_min, int cm_max,
                          const int32_t* sym2iw, int64_t sym2iw_len,
                          int spm_iw, int n_sym, int64_t* out_counts) {
    BtlUnitsState* st = new BtlUnitsState();
    st->n_docs = n_docs;
    st->n_sym = n_sym;
    st->status.assign(n_docs, 0);
    st->doc_inst_off.assign(n_docs + 1, 0);
    if (cache_h) {
        st->cache = (BtlUnitCache*)cache_h;
        st->owns_cache = false;
    } else {
        st->cache = new BtlUnitCache();
        st->owns_cache = true;
        units_rehash(st->cache, 1 << 14);
    }
    BtlUnitCache* c = st->cache;

    // The per-doc prep+intern scan is CPU-bound and per-doc independent:
    // shard docs across threads with PRIVATE interns, merge serially into
    // the shared cache (unique units only — cheap).  Mirrors the WpAnalyze
    // threading in runtime.cpp.
    auto scan_range = [&](BtlUnitsState* sh, BtlUnitCache* lc, int d0,
                          int d1) {
        int64_t max_doc = 0;
        for (int d = d0; d < d1; ++d) {
            int64_t len = doc_off[d + 1] - doc_off[d];
            if (len > max_doc) max_doc = len;
        }
        int64_t cap = 10 * max_doc + 16;
        std::vector<int32_t> buf(cap), nbuf(cap), iw(cap);
        std::vector<uint8_t> spmf(cap);
        for (int d = d0; d < d1; ++d) {
            sh->doc_inst_off[d - d0] = (int64_t)sh->inst_unit.size();
            const uint8_t* p = docs + doc_off[d];
            int n = (int)(doc_off[d + 1] - doc_off[d]);
            int32_t *cur, *curo;
            int k = prep_doc_syms(p, n, use_raw_bytes, no_dummy_prefix,
                                  cm_counts, cm_values, cm_width, cm_min,
                                  cm_max, buf.data(), nullptr, nbuf.data(),
                                  nullptr, &cur, &curo);
            if (k < 0) { sh->status[d - d0] = 1; continue; }
            // dense remap + SPM flags (unit boundaries use RAW symbols;
            // dedup keys use iw sequences — dedup.split_units semantics)
            for (int i = 0; i < k; ++i) {
                int32_t cch = cur[i];
                iw[i] = (cch >= 0 && cch < sym2iw_len) ? sym2iw[cch] : -1;
                spmf[i] = (cch == SPM) ? 1 : 0;
            }
            // Document LENGTH is no limit here — per-unit resolution never
            // materializes the doc as a row (chunk-safe factorization); only
            // a single UNIT wider than a device row falls back (status 2).
            int start = 0;
            bool giant = false;
            for (int i = 1; i <= k; ++i) {
                if (i == k || (spmf[i] && !spmf[i - 1])) {
                    if (i - start > n_sym) { giant = true; break; }
                    start = i;
                }
            }
            if (giant) { sh->status[d - d0] = 2; continue; }
            sh->total_syms += k;
            // units: maximal [SPM-run +] non-SPM-run blocks.  Probe the
            // SHARED cache read-only first (no writers run concurrently):
            // local interning holds only shared-cache MISSES, so the serial
            // merge touches new units only.  Instance encoding: shared id g
            // stored as g, local id lu stored as -(lu + 1).
            start = 0;
            for (int i = 1; i <= k; ++i) {
                if (i == k || (spmf[i] && !spmf[i - 1])) {
                    int32_t g = unit_lookup(c, iw.data() + start, i - start);
                    // a shared unit that is neither resolved nor in flight
                    // must be re-packed: route it through the local path
                    if (g >= 0 && (c->r_off[g] >= 0 || c->pending[g])) {
                        sh->inst_unit.push_back(g);
                    } else {
                        bool fresh = false;
                        int32_t lu = unit_intern(lc, iw.data() + start,
                                                 i - start, &fresh);
                        sh->inst_unit.push_back(-(lu + 1));
                    }
                    start = i;
                }
            }
        }
        sh->doc_inst_off[d1 - d0] = (int64_t)sh->inst_unit.size();
    };

    int n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads > 4) n_threads = 4;
    if (n_threads < 1) n_threads = 1;
    int64_t total_bytes = doc_off[n_docs] - doc_off[0];
    if (n_threads > 1 && n_docs >= 64 && total_bytes >= (64 << 10)) {
        std::vector<BtlUnitsState*> shards(n_threads);
        std::vector<BtlUnitCache*> lcs(n_threads);
        std::vector<std::thread> threads;
        std::vector<int> bounds(n_threads + 1);
        for (int t = 0; t <= n_threads; ++t)
            bounds[t] = (int)((int64_t)n_docs * t / n_threads);
        for (int t = 0; t < n_threads; ++t) {
            BtlUnitsState* sh = new BtlUnitsState();
            int nd = bounds[t + 1] - bounds[t];
            sh->n_docs = nd;
            sh->n_sym = n_sym;
            sh->status.assign(nd, 0);
            sh->doc_inst_off.assign(nd + 1, 0);
            BtlUnitCache* lc = new BtlUnitCache();
            units_rehash(lc, 1 << 14);
            sh->cache = lc;
            sh->owns_cache = true;
            shards[t] = sh;
            lcs[t] = lc;
            threads.emplace_back([&scan_range, sh, lc, t, &bounds]() {
                scan_range(sh, lc, bounds[t], bounds[t + 1]);
            });
        }
        for (auto& th : threads) th.join();
        std::vector<int32_t> remap;
        for (int t = 0; t < n_threads; ++t) {
            BtlUnitsState* sh = shards[t];
            BtlUnitCache* lc = lcs[t];
            int LU = lc->units();
            remap.assign(LU, -1);
            for (int lu = 0; lu < LU; ++lu) {
                bool fresh = false;
                int32_t g = unit_intern(
                    c, lc->u_syms.data() + lc->u_soff[lu],
                    lc->u_soff[lu + 1] - lc->u_soff[lu], &fresh);
                if (fresh || (c->r_off[g] < 0 && !c->pending[g])) {
                    st->local_units.push_back(g);
                    c->pending[g] = 1;
                }
                remap[lu] = g;
            }
            int d0 = bounds[t];
            for (int d = 0; d < sh->n_docs; ++d) {
                st->doc_inst_off[d0 + d] = (int64_t)st->inst_unit.size();
                st->status[d0 + d] = sh->status[d];
                for (int64_t i = sh->doc_inst_off[d];
                     i < sh->doc_inst_off[d + 1]; ++i) {
                    int32_t v = sh->inst_unit[i];
                    // v >= 0: already a shared-cache id; v < 0: local miss
                    st->inst_unit.push_back(v >= 0 ? v : remap[-(v + 1)]);
                }
            }
            st->total_syms += sh->total_syms;
            delete sh;
        }
    } else {
        // single-thread path: scan straight into st with the shared cache
        auto single = [&](int d0, int d1) {
            // identical to scan_range but interning into the SHARED cache
            // with local_units/pending bookkeeping
            int64_t max_doc = 0;
            for (int d = d0; d < d1; ++d) {
                int64_t len = doc_off[d + 1] - doc_off[d];
                if (len > max_doc) max_doc = len;
            }
            int64_t cap = 10 * max_doc + 16;
            std::vector<int32_t> buf(cap), nbuf(cap), iw(cap);
            std::vector<uint8_t> spmf(cap);
            for (int d = d0; d < d1; ++d) {
                st->doc_inst_off[d] = (int64_t)st->inst_unit.size();
                const uint8_t* p = docs + doc_off[d];
                int n = (int)(doc_off[d + 1] - doc_off[d]);
                int32_t *cur, *curo;
                int k = prep_doc_syms(p, n, use_raw_bytes, no_dummy_prefix,
                                      cm_counts, cm_values, cm_width, cm_min,
                                      cm_max, buf.data(), nullptr, nbuf.data(),
                                      nullptr, &cur, &curo);
                if (k < 0) { st->status[d] = 1; continue; }
                for (int i = 0; i < k; ++i) {
                    int32_t cch = cur[i];
                    iw[i] = (cch >= 0 && cch < sym2iw_len) ? sym2iw[cch] : -1;
                    spmf[i] = (cch == SPM) ? 1 : 0;
                }
                int start = 0;
                bool giant = false;
                for (int i = 1; i <= k; ++i) {
                    if (i == k || (spmf[i] && !spmf[i - 1])) {
                        if (i - start > n_sym) { giant = true; break; }
                        start = i;
                    }
                }
                if (giant) { st->status[d] = 2; continue; }
                st->total_syms += k;
                start = 0;
                for (int i = 1; i <= k; ++i) {
                    if (i == k || (spmf[i] && !spmf[i - 1])) {
                        bool fresh = false;
                        int32_t u = unit_intern(c, iw.data() + start,
                                                i - start, &fresh);
                        if (fresh || (c->r_off[u] < 0 && !c->pending[u])) {
                            st->local_units.push_back(u);
                            c->pending[u] = 1;
                        }
                        st->inst_unit.push_back(u);
                        start = i;
                    }
                }
            }
        };
        single(0, n_docs);
    }
    st->doc_inst_off[n_docs] = (int64_t)st->inst_unit.size();

    // Greedy dense packing of the LOCAL (unresolved) units into two row
    // regions (layout rules as before: non-SPM-initial units may only sit at
    // row offset 0; SPM-initial units fill left to right).  Region A =
    // SPM-initial units of length <= the class depth, packed into rows
    // [0, split_rows): the device walks those rows with the short unrolled
    // kernel (a match can never out-run its unit under chunk-safe
    // vocabularies).  Region B = everything else.
    int NL = (int)st->local_units.size();
    st->u_row.assign(NL, 0);
    st->u_off.assign(NL, 0);
    st->row_units.reserve(NL);
    std::vector<int32_t> row_count;
    int row = -1, curp = n_sym + 1;
    auto place = [&](int32_t li, int len, bool open_row) {
        if (open_row || curp + len > n_sym) {
            ++row;
            curp = 0;
            row_count.push_back(0);
        }
        st->u_row[li] = row;
        st->u_off[li] = curp;
        curp += len;
        st->row_units.push_back(li);
        ++row_count.back();
    };
    auto len_of = [&](int li) {
        int32_t u = st->local_units[li];
        return c->u_soff[u + 1] - c->u_soff[u];
    };
    auto spm0_of = [&](int li) {
        int32_t u = st->local_units[li];
        return c->u_soff[u + 1] > c->u_soff[u] &&
               c->u_syms[c->u_soff[u]] == (int32_t)spm_iw;
    };
    // region A1: SPM-initial units <= BTL_LW1
    for (int li = 0; li < NL; ++li)
        if (spm0_of(li) && len_of(li) <= BTL_LW1) place(li, len_of(li), false);
    st->split_rows1 = row + 1;
    curp = n_sym + 1;  // force a fresh row at each region boundary
    // region A2: SPM-initial units in (BTL_LW1, BTL_LW2]
    for (int li = 0; li < NL; ++li) {
        int len = len_of(li);
        if (spm0_of(li) && len > BTL_LW1 && len <= BTL_LW2)
            place(li, len, false);
    }
    st->split_rows = row + 1;
    curp = n_sym + 1;
    // region B: non-SPM-initial first (each opens a row), long SPM units fill
    for (int li = 0; li < NL; ++li)
        if (!spm0_of(li)) place(li, len_of(li), true);
    for (int li = 0; li < NL; ++li)
        if (spm0_of(li) && len_of(li) > BTL_LW2) place(li, len_of(li), false);
    st->R = row + 1;
    st->row_unit_off.assign(st->R + 1, 0);
    for (int r = 0; r < st->R; ++r)
        st->row_unit_off[r + 1] = st->row_unit_off[r] + row_count[r];
    // row_units was appended in assignment order == (row, offset) order

    out_counts[0] = c->units();
    out_counts[1] = (int64_t)st->inst_unit.size();
    out_counts[2] = st->R;
    out_counts[3] = st->total_syms;
    out_counts[4] = st->split_rows;
    out_counts[5] = st->split_rows1;
    out_counts[6] = NL;
    return st;
}

void* btl_units_analyze(const uint8_t* docs, const int64_t* doc_off,
                        int n_docs, int use_raw_bytes, int no_dummy_prefix,
                        const int32_t* cm_counts, const int32_t* cm_values,
                        int cm_width, int cm_min, int cm_max,
                        const int32_t* sym2iw, int64_t sym2iw_len,
                        int spm_iw, int n_sym, int64_t* out_counts) {
    int64_t counts7[7];
    void* st = btl_units_analyze_c(
        nullptr, docs, doc_off, n_docs, use_raw_bytes, no_dummy_prefix,
        cm_counts, cm_values, cm_width, cm_min, cm_max, sym2iw, sym2iw_len,
        spm_iw, n_sym, counts7);
    for (int i = 0; i < 6; ++i) out_counts[i] = counts7[i];
    return st;
}

// Fill device inputs: px (R, n_sym) int32 iw rows (-1 pad), plen (R,),
// status (n_docs,).
void btl_units_emit(void* handle, int32_t* px, int32_t* plen,
                    uint8_t* status) {
    BtlUnitsState* st = (BtlUnitsState*)handle;
    BtlUnitCache* c = st->cache;
    int N = st->n_sym;
    memset(plen, 0, sizeof(int32_t) * st->R);
    for (int64_t i = 0; i < (int64_t)st->R * N; ++i) px[i] = -1;
    int NL = (int)st->local_units.size();
    for (int li = 0; li < NL; ++li) {
        int32_t u = st->local_units[li];
        int len = c->u_soff[u + 1] - c->u_soff[u];
        int32_t r = st->u_row[li], o = st->u_off[li];
        memcpy(px + (int64_t)r * N + o, c->u_syms.data() + c->u_soff[u],
               (size_t)len * 4);
        if (o + len > plen[r]) plen[r] = o + len;
    }
    memcpy(status, st->status.data(), st->n_docs);
}

// Consume the device output and write flat per-doc ids.
//
//  rows       (rows_n, n_sym + 2) int32: lane j<count =
//             (id+1) | (start<<shift) | (mark<<31), start below
//             2^(31-shift); col n_sym = token count; col n_sym+1 = the
//             row's device-fallback flag
//  out_ids    capacity cap int32
//  out_bounds (n_docs+1) int64 token offsets per doc (fallback docs span 0)
//  need_fb    (n_docs) 1 = doc must take the host-oracle path
//  out_stats  NULL, or [0] rows flagged (the flag set or a marked lane),
//             [1] units this stitch made resolved-fallback
// Returns total tokens written, or -1 if cap was exceeded.
//
// The device flags the unit, not the row: a unit with a marked lane (K2's
// mark of a token over a walk cut at its depth cap), or every unit of a row
// whose flag is set, is resolved-fallback; every other unit of the row is
// stored as resolved.  With a shared cache, this batch's freshly resolved
// units are stored into the cache (one compact arena append per unique
// unit), and instances of units resolved by EARLIER stitches read straight
// from the arena — the cross-batch dedup payoff.  Unresolved non-local
// units (an earlier batch was dispatched but never stitched) conservatively
// flag the doc.
int64_t btl_units_stitch_m(void* handle, const int32_t* rows, int64_t rows_n,
                           const int32_t* row_map, int shift,
                           int32_t* out_ids, int64_t cap,
                           int64_t* out_bounds, uint8_t* need_fb,
                           int64_t* out_stats) {
    BtlUnitsState* st = (BtlUnitsState*)handle;
    BtlUnitCache* c = st->cache;
    int N = st->n_sym;
    int64_t stride = N + 2;
    int NL = (int)st->local_units.size();
    const uint32_t start_mask = (1u << (31 - shift)) - 1;
    const int32_t id_mask = (1 << shift) - 1;
    auto start_of = [&](int32_t lane) {
        return (int32_t)(((uint32_t)lane >> shift) & start_mask);
    };
    int64_t flagged_rows = 0, fallback_units = 0;
    auto set_fallback = [&](int32_t u) {
        c->r_off[u] = (int64_t)c->r_ids.size();
        c->r_cnt[u] = -1;  // resolved-fallback
        c->pending[u] = 0;
        ++fallback_units;
    };

    // resolve local units: token spans within the packed rows -> cache arena
    // (row_map: packed row r lives at device row row_map[r]; NULL = identity
    // — lets the dispatcher batch fixed-shape chunk groups with padding)
    for (int r = 0; r < st->R; ++r) {
        int64_t dr = row_map ? row_map[r] : r;
        if (dr < 0 || dr >= rows_n) continue;
        const int32_t* row = rows + dr * stride;
        int cnt = row[N];
        int ub = st->row_unit_off[r], ue = st->row_unit_off[r + 1];
        if (row[N + 1] != 0) {
            ++flagged_rows;
            for (int q = ub; q < ue; ++q)
                set_fallback(st->local_units[st->row_units[q]]);
            continue;
        }
        bool marked_row = false;
        int j = 0;
        for (int q = ub; q < ue; ++q) {
            int32_t li = st->row_units[q];
            int32_t u = st->local_units[li];
            int32_t uo = st->u_off[li];
            int32_t uend = uo + (c->u_soff[u + 1] - c->u_soff[u]);
            // tokens are start-ascending within the row
            while (j < cnt && start_of(row[j]) < uo) ++j;
            int j0 = j;
            bool marked = false;
            while (j < cnt && start_of(row[j]) < uend) marked |= row[j++] < 0;
            if (marked) {
                marked_row = true;
                set_fallback(u);
                continue;
            }
            c->r_off[u] = (int64_t)c->r_ids.size();
            c->r_cnt[u] = j - j0;
            for (int q2 = j0; q2 < j; ++q2)
                c->r_ids.push_back((row[q2] & id_mask) - 1);
            c->pending[u] = 0;
        }
        flagged_rows += marked_row;
    }
    // rows not covered by the transfer (bug guard): resolved-fallback
    for (int li = 0; li < NL; ++li) {
        int32_t r = st->u_row[li];
        int64_t dr = row_map ? row_map[r] : r;
        if (dr < 0 || dr >= rows_n) {
            int32_t u = st->local_units[li];
            if (c->r_off[u] < 0) set_fallback(u);
        }
    }
    if (out_stats) {
        out_stats[0] = flagged_rows;
        out_stats[1] = fallback_units;
    }

    int64_t t = 0;
    out_bounds[0] = 0;
    for (int d = 0; d < st->n_docs; ++d) {
        int64_t i0 = st->doc_inst_off[d], i1 = st->doc_inst_off[d + 1];
        bool fb = st->status[d] != 0;
        for (int64_t i = i0; !fb && i < i1; ++i) {
            int32_t u = st->inst_unit[i];
            fb = c->r_off[u] < 0 || c->r_cnt[u] < 0;
        }
        need_fb[d] = fb ? 1 : 0;
        if (!fb) {
            for (int64_t i = i0; i < i1; ++i) {
                int32_t u = st->inst_unit[i];
                int32_t cnt = c->r_cnt[u];
                if (t + cnt > cap) return -1;
                memcpy(out_ids + t, c->r_ids.data() + c->r_off[u],
                       (size_t)cnt * 4);
                t += cnt;
            }
        }
        out_bounds[d + 1] = t;
    }
    return t;
}

int64_t btl_units_stitch(void* handle, const int32_t* rows, int64_t rows_n,
                         int shift, int32_t* out_ids, int64_t cap,
                         int64_t* out_bounds, uint8_t* need_fb) {
    return btl_units_stitch_m(handle, rows, rows_n, nullptr, shift, out_ids,
                              cap, out_bounds, need_fb, nullptr);
}

void btl_units_free(void* handle) { delete (BtlUnitsState*)handle; }

int btl_version() { return 1000; }

}  // extern "C"
