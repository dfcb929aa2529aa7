// K10 hyph_segment: W2H hyphenation of a batch of anchored words, rows
// [L_ANCHOR c1 .. cn R_ANCHOR -1 ...] of dense input weights, into (B, M-2)
// int32 per-position ops.  Replaces blingfire_tpu/ops/hyph.py::hyph_segment
// (hyph.py:67-143) with its _scatter_min/_scatter_max (:146-161).
//
// Row tiles.  A block of 256 threads takes a tile of T = max(1, 256 / M)
// consecutive rows of one segment (rows of one width M): 14 rows at M = 18,
// 7 at 34, 3 at 66, one at 130 or 302.  The tile's rows come in as one
// contiguous T*M span and its ops go out as one contiguous T*W span (W =
// M - 2), so loads and stores are coalesced across rows.  Thread i takes
// the (row, start) pair (i / M, i % M) of the tile, and i + 256, ... when a
// row is wider than the block.  Each row has its own two W-long grids in
// shared memory, the least and the greatest op applied to each position,
// set to BIG and -BIG before any thread writes.
//
// Segments.  One launch can take rows of several widths (every bucket of a
// HyphTpu.process_batch call): a table of 8-int records {first tile, rows,
// M, T, x offset, word-length offset, out offset, 0} at the start of one
// int32 buffer, the rows and word lengths after it, ops into one output.
// A block finds its segment by a binary search over the first tiles; a
// tile never spans two segments.  bf_hyph_segment is the one-segment case,
// its record passed by value.
//
// The walk.  A start From < n + 2 - (min_pat_len - 1)
// walks the comb table from state 0 until its state dies or the row ends;
// the JAX while loop runs on until every lane of the batch is dead, and a
// dead lane stays dead, so the grids are the same.  At each final the
// pattern's ops j in [js, je) go to position From + j - 1 by shared
// atomicMin/atomicMax: js = 1 only at From 0 (the L anchor's op), je = plen
// - max(0, From + plen - n), DONT_CARE skipped, positions outside the row's
// own [0, W) dropped.  Min and max are order-free, so the result is
// deterministic (the reference's first-wins/CONFLICT rule is CONFLICT iff
// two distinct ops cover a position).  After a barrier each position
// resolves to UNKNOWN, the op or CONFLICT, and the edge suppression of
// no_hyph_len applies (FAHyphInterpreter_core_t.h:252-263), with n the
// row's word length even where it disagrees with the row.
//
// A comb lookup takes no transition when base[s] + c falls outside
// [0, n_slots).  JAX clamps that slot (hyph.py:96) and so, from the state
// that owns slot 0, takes slot 0's transition for a symbol below its
// lowest one (ROADMAP.md section C).  The unmapped-symbol sentinel n_iws
// stays in range (ops/tables.py guarantees base + n_iws < n_slots) and
// misses.  XLA's other clamps are explicit here: the pattern id into
// [0, n_pats) (hyph.py:101, :109) and the state into [0, n_states)
// (hyph.py:99-100).  Op values such as (sym << 4) | code stay int32.
// A step reads two packed records (ops/hyph.py's state_rec and slot_rec,
// ops/lexer.py's layout): the slot's {owner, nxt} and then the next
// state's {base, final, Moore Ow}, which the next step reuses for its base;
// separate base, owner, nxt and final arrays cost four scattered sectors.
//
// Bound: bytes.  The rows in (4 B a lane, 4 B a row), the ops out (4 B a
// position), and each table entry the walks read once; a syllab-sized
// table (about 100k states, 150k slots, 9k op rows) sits in the 50 MB L2.
// Walks are short (a start walks about 1.6 live steps on corpus words);
// with a one-warp block a row, the launch floor (63,379 blocks on the
// corpus's 16-symbol bucket) was half the time.  A tile shares the loads,
// grids and stores over up to 14 rows, and one launch serves every bucket.
// What is left is the walks' scattered table gathers (PERF.md section 6).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRow = 302;             // MAX_HYPH_ROW: 300 symbols, 2 anchors
constexpr int kTileInts = 3 * kMaxRow - 4;  // rows and grids of the widest tile
constexpr int kSegInts = 8;
constexpr int kBig = 1 << 30;
constexpr int kUnknown = -1;
constexpr int kConflict = -2;
constexpr int kNoHyph = 0;
constexpr int kDontCare = 7;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

struct Tables {
    const int4* state_rec;  // (n_states,): base, final, Moore Ow, 0
    const int2* slot_rec;   // (n_slots,): owner, nxt
    int n_states;
    int n_slots;
    const int32_t* pat_vals;  // (n_pats, max_pat)
    const int32_t* pat_len;   // (n_pats,)
    int n_pats;
    int max_pat;
    int min_pat_len;
    int no_hyph_len;
};

// One segment: rows of width M, T to a tile; offsets in int32 elements
struct Seg {
    int first_tile, rows, M, T;
    int64_t x_off, wl_off, out_off;
};

// eight blocks an SM (32 registers, a few bytes spilled): the walks' table
// gathers, not a tile's longest walk, bound a launch, so more of them in
// flight pays (tiles of 2x and 4x the rows measured no faster)
__global__ void __launch_bounds__(kThreads, 8)
hyph_segment_kernel(Tables t, const int32_t* __restrict__ segs, int n_segs,
                    Seg one, const int32_t* __restrict__ xb,
                    const int32_t* __restrict__ wlb,
                    int32_t* __restrict__ outb) {
    __shared__ int32_t smem[kTileInts];
    __shared__ int32_t wls[kThreads / 2];
    const int b = blockIdx.x;
    Seg s = one;
    if (segs != nullptr) {  // the last record whose first tile is <= b
        int lo = 0, hi = n_segs - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (__ldg(segs + mid * kSegInts) <= b) lo = mid; else hi = mid - 1;
        }
        const int32_t* r = segs + lo * kSegInts;
        s = Seg{__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3),
                __ldg(r + 4), __ldg(r + 5), __ldg(r + 6)};
    }
    const int M = s.M, W = M - 2;
    const int row0 = (b - s.first_tile) * s.T;
    const int nr = min(s.T, s.rows - row0);
    const int span = nr * M, wspan = nr * W;
    int32_t* xs = smem;           // nr * M: the tile's rows
    int32_t* vmin = xs + span;    // nr * W
    int32_t* vmax = vmin + wspan; // nr * W
    const int tid = threadIdx.x;

    // ---- LOAD
    const int32_t* xt = xb + s.x_off + (int64_t)row0 * M;
    for (int i = tid; i < span; i += kThreads) xs[i] = __ldg(xt + i);
    for (int i = tid; i < wspan; i += kThreads) {
        vmin[i] = kBig;
        vmax[i] = -kBig;
    }
    if (tid < nr) wls[tid] = __ldg(wlb + s.wl_off + row0 + tid);
    __syncthreads();

    // ---- WALK
    const int4 root = __ldg(t.state_rec);
    for (int i = tid; i < span; i += kThreads) {
        const int r = i / M, p = i - r * M;
        const int32_t n = wls[r];
        if ((int64_t)p >= (int64_t)n + 2 - (t.min_pat_len - 1)) continue;
        const int32_t* xr = xs + r * M;
        int32_t* rmin = vmin + r * W;
        int32_t* rmax = vmax + r * W;
        int32_t state = 0;
        int4 srec = root;  // the record of the clamped state
        for (int q = p; q < M; ++q) {
            const int32_t c = xr[q];
            if (c < 0) break;
            const int64_t raw = (int64_t)srec.x + c;
            if (raw < 0 || raw >= t.n_slots) break;
            const int2 slot = __ldg(t.slot_rec + raw);
            if (slot.x != state) break;
            state = slot.y;
            if (state < 0) break;
            srec = __ldg(t.state_rec + clamp64(state, 0, t.n_states - 1));
            if (!srec.y || t.n_pats <= 0) continue;
            const int64_t pid = clamp64(srec.z, 0, t.n_pats - 1);
            const int plen = __ldg(t.pat_len + pid);
            const int64_t oob = (int64_t)p + plen - n;
            const int64_t je = plen - (oob > 0 ? oob : 0);
            const int32_t* vals = t.pat_vals + pid * t.max_pat;
            for (int j = p == 0 ? 1 : 0; j < je && j < t.max_pat; ++j) {
                const int32_t ow = __ldg(vals + j);
                const int oi = p + j - 1;
                if (ow == kDontCare || oi < 0 || oi >= W) continue;
                atomicMin(rmin + oi, ow);
                atomicMax(rmax + oi, ow);
            }
        }
    }
    __syncthreads();

    // ---- WRITE
    int32_t* ot = outb + s.out_off + (int64_t)row0 * W;
    for (int i = tid; i < wspan; i += kThreads) {
        const int r = i / W, pos = i - r * W;
        const int64_t n = wls[r];
        const int64_t k = n < t.no_hyph_len ? n : t.no_hyph_len;
        const int32_t lo = vmin[i], hi = vmax[i];
        const int32_t v = lo == kBig ? kUnknown : (lo == hi ? lo : kConflict);
        const bool lead = pos < k;
        const bool tail = pos >= n - 1 - k && pos < n - 1 && pos > 0;
        ot[i] = lead || tail ? kNoHyph : v;
    }
}

int launch(const Tables& t, const int32_t* segs, int n_segs, const Seg& one,
           int n_tiles, const int32_t* xb, const int32_t* wlb, int32_t* outb,
           void* stream) {
    if (n_tiles <= 0) return 0;
    if (t.n_states <= 0 || t.max_pat <= 0) return (int)cudaErrorInvalidValue;
    hyph_segment_kernel<<<(unsigned)n_tiles, kThreads, 0,
                          (cudaStream_t)stream>>>(t, segs, n_segs, one, xb,
                                                  wlb, outb);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bf_hyph_segment(
    const int32_t* state_rec, const int32_t* slot_rec, int n_states,
    int n_slots, const int32_t* pat_vals, const int32_t* pat_len, int n_pats, int max_pat,
    int min_pat_len, int no_hyph_len, const int32_t* x,
    const int32_t* word_len, int B, int M, int32_t* out, void* stream) {
    if (B <= 0) return 0;
    if (M < 2 || M > kMaxRow) return (int)cudaErrorInvalidValue;
    const Tables t{(const int4*)state_rec, (const int2*)slot_rec, n_states,
                   n_slots, pat_vals, pat_len, n_pats, max_pat, min_pat_len,
                   no_hyph_len};
    const int T = kThreads / M > 1 ? kThreads / M : 1;
    const Seg one{0, B, M, T, 0, 0, 0};
    return launch(t, nullptr, 1, one, (B + T - 1) / T, x, word_len, out,
                  stream);
}

// Every segment of buf in one launch: buf starts with n_segs records of
// kSegInts ints (ops/hyph.py::pack_rows writes them; every M in [2, 302]),
// offsets count int32 elements from buf (rows, word lengths) and from out.
extern "C" int bf_hyph_segment_packed(
    const int32_t* state_rec, const int32_t* slot_rec, int n_states,
    int n_slots, const int32_t* pat_vals, const int32_t* pat_len, int n_pats, int max_pat,
    int min_pat_len, int no_hyph_len, const int32_t* buf, int n_segs,
    int n_tiles, int32_t* out, void* stream) {
    if (n_segs <= 0) return (int)cudaErrorInvalidValue;
    const Tables t{(const int4*)state_rec, (const int2*)slot_rec, n_states,
                   n_slots, pat_vals, pat_len, n_pats, max_pat, min_pat_len,
                   no_hyph_len};
    return launch(t, buf, n_segs, Seg{}, n_tiles, buf, buf, out, stream);
}
