// K2 bpe_resolve: FILTER, SORT, CLAIM and EMIT of byte- and char-BPE, one
// block a row.
//
// Replaces blingfire_tpu/ops/bpe.py::_resolve_impl (bpe.py:340, jit at :794)
// with _bitonic_sort (bpe.py:195) and, in rank mode, _float_desc_key
// (bpe.py:181) inside it, and follows its scatter (CPU) branch bit for bit:
// the same arc slab order (slot-major d*N+p, then the unknown runs), the same
// compaction to a_max arcs, the same ((rank desc,) id asc, start asc) order
// with ties kept in slab order, the same lanes (unemitted lanes hold 0 +
// id_offset with start and end 0) and the same fallback flags (slot_overflow
// | arc_overflow | anomaly), unless the caller asks for marks (below).  The
// rank key is the reference's order, not JAX's: -0.0 ties +0.0, and an
// unknown run's +0.0 sorts before every negative rank (ROADMAP.md section C
// item 5; ops/bpe.py::float_desc_key).
//
// One block of ceil(N/32) warps handles one packed row, one thread a start:
//   FILTER  each thread reads its LR match slots (coalesced along p), finds
//           the whole-token fast-forward, and the block scans give the
//           visited starts (exclusive cummax) and the anomaly flag; unknown
//           runs come from neighbours in shared memory.
//   SORT    surviving arcs are compacted into shared memory in slab order
//           (one block prefix sum per depth), the first a_max kept, as keys
//           (segment, [rank,] id, start, end); a block max-scan of each
//           start's furthest kept end gives the cuts, the positions q that
//           no kept arc crosses (st < q <= en), and a second scan each
//           position's segment (its first position); an in-block bitonic
//           network over the next power of two of the kept arcs sorts them
//           segment-major.
//   CLAIM   one thread a segment walks that segment's arcs in sort order
//           with the unchanged rule (claimed if st and en+1 are not
//           interior to an earlier claim; a claim marks st+1..en interior),
//           on a byte a position.  A claim reads only st and en+1 of its own
//           segment, or the cut that ends it, which no claim marks, and
//           writes only inside it: the greedy run in the row's sort order
//           equals the same run per segment (ops/bpe.py::claim_segments
//           computes the segments on the host).  A row that is one segment
//           claims serially, as a single thread did.
//   EMIT    last claim wins at each start (a start's arcs share its
//           segment); starts inside a claimed arc are dropped; a block
//           prefix sum compacts the tokens left.
//
// Marks (mark != 0; every launch whose rows go to the native stitch; only
// region B's unbounded walk can stop at its cap).  A walk still live at
// its depth cap (slot_overflow) flags the token that covers its start and
// not the row: a block prefix count of the row's overflowed positions, one
// difference a token, sets bit 10 (MARK_BIT) of the token's out_starts
// (N <= 1,024 leaves it free), and the row's flag keeps arc_overflow |
// anomaly, and an overflowed position no token covers.  Under a chunk-safe
// vocabulary a match stays inside its unit, so the marked tokens name the
// units whose ids the cap may have changed; the other units of the row are
// exact.  A row with no overflowed position costs nothing more.
//
// Keys.  Plain and priority modes: one 64-bit word, segment (10 bits) at
// 42, id + 2^20 (21) at 21, start (10) at 11, end (11) at 0.  Rank mode:
// a 64-bit word, segment at 53, the 32-bit rank key at 21, id + 2^20 at 0,
// then a 32-bit word, start at 11 and end at 0.  Among arcs of one (id,
// start), end order is slab order (same start, depth-major; unknown runs
// never share a start with a match), so the order is the reference's
// ((rank desc,) id asc, start asc, slab asc) inside each segment, and the
// claim decodes start and end with shifts.
//
// Bound: operations and latency, not bytes.  The row's inputs (LR*N + N
// int32) are read once, coalesced; everything after FILTER stays in shared
// memory.  The claim's serial depth is the row's longest segment (a unit
// row: a unit of at most 64 symbols; a classic row: a word, or two joined
// by a pair piece), not the row's arc count; the sort's 78 barrier stages
// at 4,096 arcs then lead.  Shared memory a block: P_max*8 (rank mode 12)
// + N*12 + N*3 + 1 + 128 bytes: at a_max = 4,096 and N = 1,024, 48,257 B,
// and in rank mode 64,641 B, past the 48 KB default, so the launch opts in
// to more (Hopper allows 227 KB a block).  Shared memory then admits four
// (rank mode three) blocks an SM, and its 2,048 threads two blocks of
// 1,024, as registers allow (nvcc -Xptxas -v in chip_smoke's build log).

#include "common.cuh"

// ascending order == descending rank in the reference's order: -0.0 becomes
// +0.0, the sign-magnitude bits become an ordered int32, NOT reverses it,
// and the sign flip makes unsigned order equal signed order
__device__ __forceinline__ uint32_t rank_key(float r) {
    int32_t bits = __float_as_int(r);
    if (bits == INT32_MIN) bits = 0;
    const int32_t asc = bits >= 0 ? bits : (bits ^ 0x7FFFFFFF);
    return (uint32_t)(~asc) ^ 0x80000000u;
}

constexpr int ID_BIAS = 1 << 20;  // ids lie in [-2^20, 2^20): 21 bits
constexpr int MARK_BIT = 1 << 10;  // a marked token's bit in out_starts
constexpr int SEG_SHIFT = 42, RANK_SEG_SHIFT = 53, RANK_SHIFT = 21;

// start and end of an arc: bits 11..20 and 0..10 of the key's last word
__device__ __forceinline__ uint32_t span_bits(int st, int en) {
    return ((uint32_t)st << 11) | (uint32_t)en;
}

template <bool RANK>
__global__ void bpe_resolve_kernel(
    const int32_t* __restrict__ m_pack, const float* __restrict__ m_rank,
    const uint8_t* __restrict__ slot_overflow,
    const int32_t* __restrict__ x, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ prio2id, int B, int N, int LR, int a_max,
    int P_max, int spm_iw, int unk_id, int id_offset, int fast, int trie_v,
    int mark, int32_t* __restrict__ out_ids, int32_t* __restrict__ out_starts,
    int32_t* __restrict__ out_ends, int32_t* __restrict__ counts,
    uint8_t* __restrict__ fallback) {
    extern __shared__ unsigned char smem[];
    // keys[i]: (segment, id, start, end), or in rank mode (segment, rank,
    // id) then span[i] = (start, end)
    uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // P_max
    uint32_t* span = reinterpret_cast<uint32_t*>(keys + P_max);  // P_max, RANK
    int32_t* win_id = reinterpret_cast<int32_t*>(span + (RANK ? P_max : 0));  // N
    int32_t* win_end = win_id + N;  // N
    // run_end until the keys are built, then each position's segment, then
    // each segment's first sorted arc, then (marks) the inclusive count of
    // overflowed positions
    int32_t* pos_a = win_end + N;  // N
    int* buf = reinterpret_cast<int*>(pos_a + N);  // 32
    uint8_t* unk = reinterpret_cast<uint8_t*>(buf + 32);  // N
    uint8_t* has_win = unk + N;  // N
    uint8_t* occ = has_win + N;  // N + 1: position inside a claimed arc
    __shared__ int n_cov;  // marks: overflowed positions inside marked tokens

    const int b = blockIdx.x, p = threadIdx.x;
    const int T = blockDim.x;
    const bool in = p < N;
    const int len = lengths[b];
    const bool valid = in && p < len;
    const int64_t row = (int64_t)b * N;
    const bool spm = in && x[row + p] == spm_iw;
    const int seg_shift = RANK ? RANK_SEG_SHIFT : SEG_SHIFT;

    // ---------------------------------------------------------------- FILTER
    int dlast = -1, n_valid = 0;
    if (in) {
        for (int d = 0; d < LR; ++d) {
            const int v = m_pack[((int64_t)d * B + b) * N + p];
            if (v < 0) continue;
            // whole-token optimisation: a ▁ start, the match ends before
            // ▁/end, and a shorter match exists (bpe.py:381-387)
            if (fast && ((v >> 27) & 1) && spm && n_valid > 0) dlast = d;
            ++n_valid;
        }
    }
    const bool has = n_valid > 0;
    const int ffe = dlast > 0 ? p + dlast : -1;  // ff_eff
    const int cover_before = block_scan(ffe, buf, OpMax(), -1, nullptr, nullptr);
    const bool visited = valid && cover_before < p;
    const bool anom = ffe >= 0 && cover_before >= p && ffe > cover_before;
    const bool u = visited && !has;
    if (in) {
        unk[p] = u;
        has_win[p] = 0;
        occ[p] = 0;
    }
    if (p == 0) occ[N] = 0;
    __syncthreads();
    const bool run_start = u && !(p > 0 && unk[p - 1]);
    if (run_start) {
        int q = p;
        while (q + 1 < N && unk[q + 1]) ++q;
        pos_a[p] = q;  // run_end, <= N-1
    }
    const bool any_anom = __syncthreads_or(anom) != 0;
    const bool any_ovf = __syncthreads_or(valid && slot_overflow[row + p]) != 0;

    // ------------------------------------------------------------------ SORT
    int base = 0, kend = -1;  // kend: the furthest end of this start's kept arcs
    for (int d = 0; d < LR; ++d) {
        int v = -1;
        const int64_t o = ((int64_t)d * B + b) * N + p;
        if (visited && d >= dlast) v = m_pack[o];
        const bool f = v >= 0;
        int tot;
        const int ex = block_scan(f ? 1 : 0, buf, OpSum(), 0, nullptr, &tot);
        if (f && base + ex < a_max) {
            const uint64_t idb = (uint64_t)((v & 0xFFFFF) + ID_BIAS);
            if (RANK) {
                keys[base + ex] =
                    ((uint64_t)rank_key(m_rank[o]) << RANK_SHIFT) | idb;
                span[base + ex] = span_bits(p, p + d);
            } else {
                keys[base + ex] = (idb << 21) | span_bits(p, p + d);
            }
            kend = p + d;
        }
        base += tot;
    }
    {
        int tot;
        const int ex = block_scan(run_start ? 1 : 0, buf, OpSum(), 0, nullptr, &tot);
        if (run_start && base + ex < a_max) {
            const int en = pos_a[p];
            const uint64_t idb = (uint64_t)((prio2id ? 0 : unk_id) + ID_BIAS);
            if (RANK) {  // an unknown run's rank is +0.0
                keys[base + ex] = ((uint64_t)rank_key(0.0f) << RANK_SHIFT) | idb;
                span[base + ex] = span_bits(p, en);
            } else {
                keys[base + ex] = (idb << 21) | span_bits(p, en);
            }
            kend = en;
        }
        base += tot;
    }
    const int n_arcs = base;
    const int n_keep = n_arcs < a_max ? n_arcs : a_max;
    // cuts: q is one when no kept arc starting before q ends at or past it
    const int cover = block_scan(in ? kend : -1, buf, OpMax(), -1, nullptr, nullptr);
    const bool cut = in && (p == 0 || cover < p);
    int seg;
    block_scan(cut ? p : 0, buf, OpMax(), 0, &seg, nullptr);
    if (in) pos_a[p] = seg;  // this thread alone read its run_end
    __syncthreads();
    for (int i = p; i < n_keep; i += T) {
        const int st = (int)(((RANK ? span[i] : (uint32_t)keys[i]) >> 11) & 0x3FF);
        keys[i] |= (uint64_t)pos_a[st] << seg_shift;
    }
    int P = 1;
    while (P < n_keep) P <<= 1;
    for (int i = n_keep + p; i < P; i += T) {
        keys[i] = ~0ull;
        if (RANK) span[i] = ~0u;
    }
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = p; i < P; i += T) {
                const int l = i ^ j;
                if (l > i) {
                    const uint64_t a = keys[i], c = keys[l];
                    bool gt = a > c;
                    if (RANK) {
                        const uint32_t sa = span[i], sc = span[l];
                        gt = gt || (a == c && sa > sc);
                        if (gt == ((i & k) == 0)) {
                            span[i] = sc;
                            span[l] = sa;
                        }
                    }
                    if (gt == ((i & k) == 0)) {
                        keys[i] = c;
                        keys[l] = a;
                    }
                }
            }
            __syncthreads();
        }
    }

    // ----------------------------------------------------------------- CLAIM
    if (in) pos_a[p] = -1;
    __syncthreads();
    for (int i = p; i < n_keep; i += T) {
        const int s = (int)(keys[i] >> seg_shift);
        if (i == 0 || (int)(keys[i - 1] >> seg_shift) != s) pos_a[s] = i;
    }
    __syncthreads();
    if (in && pos_a[p] >= 0) {
        for (int a = pos_a[p]; a < n_keep; ++a) {
            const uint64_t key = keys[a];
            if ((int)(key >> seg_shift) != p) break;
            const uint32_t sp = RANK ? span[a] : (uint32_t)key;
            const int st = (int)((sp >> 11) & 0x3FF), en = (int)(sp & 0x7FF);
            const int id = (int)((RANK ? key : key >> 21) & 0x1FFFFF) - ID_BIAS;
            const int q2 = en + 1 < N ? en + 1 : N;
            if (!occ[st] && (en + 1 >= len || !occ[q2])) {
                const int hi = en < N ? en : N;
                for (int q = st + 1; q <= hi; ++q) occ[q] = 1;
                win_id[st] = id;  // a later claim at the same start wins
                win_end[st] = en;
                has_win[st] = 1;
            }
        }
    }
    __syncthreads();
    const bool mark_row = mark && any_ovf;  // uniform across the block
    if (mark_row) {
        int incl;
        block_scan(valid && slot_overflow[row + p] ? 1 : 0, buf, OpSum(), 0,
                   &incl, nullptr);
        if (in) pos_a[p] = incl;
        if (p == 0) n_cov = 0;
        __syncthreads();
    }

    // ------------------------------------------------------------------ EMIT
    const bool tok = valid && has_win[p] && !occ[p];
    int count;
    const int slot = block_scan(tok ? 1 : 0, buf, OpSum(), 0, nullptr, &count);
    if (tok) {
        int raw = win_id[p];
        if (prio2id) {
            const int c = raw < 0 ? 0 : (raw > trie_v - 1 ? trie_v - 1 : raw);
            raw = raw == 0 ? unk_id : prio2id[c];
        }
        const int en = win_end[p];
        int st = p;
        if (mark_row) {
            const int n_ov = pos_a[en < N ? en : N - 1] - (p > 0 ? pos_a[p - 1] : 0);
            if (n_ov > 0) {
                st |= MARK_BIT;
                atomicAdd(&n_cov, n_ov);
            }
        }
        out_ids[row + slot] = raw + id_offset;
        out_starts[row + slot] = st;
        out_ends[row + slot] = en;
    }
    if (in && p >= count) {
        out_ids[row + p] = id_offset;
        out_starts[row + p] = 0;
        out_ends[row + p] = 0;
    }
    if (mark_row) __syncthreads();
    if (p == 0) {
        counts[b] = count;
        const bool whole = mark ? mark_row && n_cov < pos_a[N - 1] : any_ovf;
        fallback[b] = (whole || n_arcs > a_max || any_anom) ? 1 : 0;
    }
}

template <bool RANK>
static int launch(const int32_t* m_pack, const float* m_rank,
                  const uint8_t* slot_overflow, const int32_t* x,
                  const int32_t* lengths, const int32_t* prio2id, int B, int N,
                  int LR, int a_max, int spm_iw, int unk_id, int id_offset,
                  int fast, int trie_v, int mark, int32_t* out_ids,
                  int32_t* out_starts, int32_t* out_ends, int32_t* counts,
                  uint8_t* fallback, cudaStream_t stream) {
    const int T = ((N + 31) / 32) * 32;
    int P_max = 1;
    while (P_max < a_max) P_max <<= 1;
    const size_t smem = (size_t)P_max * (RANK ? 12 : 8) + (size_t)N * 12 +
                        32 * 4 + (size_t)N * 3 + 1;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            bpe_resolve_kernel<RANK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    bpe_resolve_kernel<RANK><<<B, T, smem, stream>>>(
        m_pack, m_rank, slot_overflow, x, lengths, prio2id, B, N, LR, a_max,
        P_max, spm_iw, unk_id, id_offset, fast, trie_v, mark, out_ids,
        out_starts, out_ends, counts, fallback);
    return (int)cudaGetLastError();
}

// m_rank == NULL: no rank key (plain and merge-priority modes); mark != 0:
// overflow marks the token, not the row (N <= 1,024)
extern "C" int bf_bpe_resolve(const int32_t* m_pack, const float* m_rank,
                              const uint8_t* slot_overflow, const int32_t* x,
                              const int32_t* lengths, const int32_t* prio2id,
                              int B, int N, int LR, int a_max, int spm_iw,
                              int unk_id, int id_offset, int fast, int trie_v,
                              int mark, int32_t* out_ids, int32_t* out_starts,
                              int32_t* out_ends, int32_t* counts,
                              uint8_t* fallback, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (m_rank)
        return launch<true>(m_pack, m_rank, slot_overflow, x, lengths, prio2id,
                            B, N, LR, a_max, spm_iw, unk_id, id_offset, fast,
                            trie_v, mark, out_ids, out_starts, out_ends,
                            counts, fallback, s);
    return launch<false>(m_pack, m_rank, slot_overflow, x, lengths, prio2id, B,
                         N, LR, a_max, spm_iw, unk_id, id_offset, fast, trie_v,
                         mark, out_ids, out_starts, out_ends, counts, fallback,
                         s);
}
