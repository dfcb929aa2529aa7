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
// | arc_overflow | anomaly).  The rank key is the reference's order, not
// JAX's: -0.0 ties +0.0, and an unknown run's +0.0 sorts before every
// negative rank (ROADMAP.md section C item 5; ops/bpe.py::float_desc_key).
//
// One block of ceil(N/32) warps handles one packed row, one thread a start:
//   FILTER  each thread reads its LR match slots (coalesced along p), finds
//           the whole-token fast-forward, and the block scans give the
//           visited starts (exclusive cummax) and the anomaly flag; unknown
//           runs come from neighbours in shared memory.
//   SORT    surviving arcs are compacted into shared memory in slab order
//           (one block prefix sum per depth), as 64-bit keys
//           (id, start, slab index) with, in rank mode, a 32-bit rank key
//           ahead of them (a second word: the 64 bits are full), and sorted
//           by an in-block bitonic network over the next power of two of
//           the row's arc count.
//   CLAIM   one thread walks the sorted arcs with the row's bitmask of
//           claimed interiors (W = ceil((N+1)/32) words): claim order is
//           inherently sequential, and a row has a few hundred arcs at most.
//   EMIT    last claim wins at each start; starts inside a claimed arc are
//           dropped; a block prefix sum compacts the tokens left.
//
// Bound: operations and latency, not bytes.  The row's inputs (LR*N + N
// int32) are read once, coalesced; everything after FILTER stays in shared
// memory.  The serial claim costs a few cycles per arc on one thread, so
// enough rows must be in flight to hide it: blocks are small (N threads).
// The sort keys take 8 (rank mode 12) bytes an arc of shared memory: at
// a_max = 4096 a block needs up to 63 KB, past the 48 KB default, so the
// launch opts in to more (Hopper allows 227 KB a block).

#include "common.cuh"

__device__ __forceinline__ bool bit_at(const uint32_t* mask, int q) {
    return (mask[q >> 5] >> (q & 31)) & 1u;
}

// set bits lo..hi (inclusive) of the row mask
__device__ __forceinline__ void set_range(uint32_t* mask, int lo, int hi) {
    for (int w = lo >> 5; w <= (hi >> 5); ++w) {
        const int a = lo - 32 * w > 0 ? lo - 32 * w : 0;
        const int z = hi - 32 * w < 31 ? hi - 32 * w : 31;
        const uint32_t upto = z >= 31 ? 0xffffffffu : ((1u << (z + 1)) - 1u);
        mask[w] |= upto & ~((1u << a) - 1u);
    }
}

// ascending order == (id asc as signed int32, start asc, slab asc)
__device__ __forceinline__ uint64_t make_key(int id, int start, int slab) {
    return ((uint64_t)((uint32_t)id ^ 0x80000000u) << 32) |
           ((uint64_t)(uint32_t)start << 16) | (uint64_t)(uint32_t)slab;
}

// ascending order == descending rank in the reference's order: -0.0 becomes
// +0.0, the sign-magnitude bits become an ordered int32, NOT reverses it,
// and the sign flip makes unsigned order equal signed order
__device__ __forceinline__ uint32_t rank_key(float r) {
    int32_t bits = __float_as_int(r);
    if (bits == INT32_MIN) bits = 0;
    const int32_t asc = bits >= 0 ? bits : (bits ^ 0x7FFFFFFF);
    return (uint32_t)(~asc) ^ 0x80000000u;
}

template <bool RANK>
__global__ void bpe_resolve_kernel(
    const int32_t* __restrict__ m_pack, const float* __restrict__ m_rank,
    const uint8_t* __restrict__ slot_overflow,
    const int32_t* __restrict__ x, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ prio2id, int B, int N, int LR, int a_max,
    int P_max, int spm_iw, int unk_id, int id_offset, int fast, int trie_v,
    int32_t* __restrict__ out_ids, int32_t* __restrict__ out_starts,
    int32_t* __restrict__ out_ends, int32_t* __restrict__ counts,
    uint8_t* __restrict__ fallback) {
    extern __shared__ unsigned char smem[];
    const int W = (N + 32) / 32;
    uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // P_max
    uint32_t* rkeys = reinterpret_cast<uint32_t*>(keys + P_max);  // P_max, RANK
    int32_t* win_id = reinterpret_cast<int32_t*>(rkeys + (RANK ? P_max : 0));  // N
    int32_t* win_end = win_id + N;  // N
    int32_t* run_end = win_end + N;  // N
    uint32_t* mask = reinterpret_cast<uint32_t*>(run_end + N);  // W
    int* buf = reinterpret_cast<int*>(mask + W);  // 32
    uint8_t* unk = reinterpret_cast<uint8_t*>(buf + 32);  // N
    uint8_t* has_win = unk + N;  // N

    const int b = blockIdx.x, p = threadIdx.x;
    const int T = blockDim.x;
    const bool in = p < N;
    const int len = lengths[b];
    const bool valid = in && p < len;
    const int64_t row = (int64_t)b * N;
    const bool spm = in && x[row + p] == spm_iw;

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
    }
    for (int w = p; w < W; w += T) mask[w] = 0;
    __syncthreads();
    const bool run_start = u && !(p > 0 && unk[p - 1]);
    if (run_start) {
        int q = p;
        while (q + 1 < N && unk[q + 1]) ++q;
        run_end[p] = q;  // <= N-1
    }
    const bool any_anom = __syncthreads_or(anom) != 0;
    const bool any_ovf = __syncthreads_or(valid && slot_overflow[row + p]) != 0;

    // ------------------------------------------------------------------ SORT
    int base = 0;
    for (int d = 0; d < LR; ++d) {
        int v = -1;
        const int64_t o = ((int64_t)d * B + b) * N + p;
        if (visited && d >= dlast) v = m_pack[o];
        const bool f = v >= 0;
        int tot;
        const int ex = block_scan(f ? 1 : 0, buf, OpSum(), 0, nullptr, &tot);
        if (f && base + ex < a_max) {
            keys[base + ex] = make_key(v & 0xFFFFF, p, d * N + p);
            if (RANK) rkeys[base + ex] = rank_key(m_rank[o]);
        }
        base += tot;
    }
    {
        int tot;
        const int ex = block_scan(run_start ? 1 : 0, buf, OpSum(), 0, nullptr, &tot);
        if (run_start && base + ex < a_max) {
            keys[base + ex] = make_key(prio2id ? 0 : unk_id, p, LR * N + p);
            if (RANK) rkeys[base + ex] = rank_key(0.0f);  // an unknown run's rank
        }
        base += tot;
    }
    const int n_arcs = base;
    const int n_keep = n_arcs < a_max ? n_arcs : a_max;
    int P = 1;
    while (P < n_keep) P <<= 1;
    for (int i = n_keep + p; i < P; i += T) {
        keys[i] = ~0ull;
        if (RANK) rkeys[i] = ~0u;
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
                        const uint32_t ra = rkeys[i], rc = rkeys[l];
                        gt = ra > rc || (ra == rc && gt);
                        if (gt == ((i & k) == 0)) {
                            rkeys[i] = rc;
                            rkeys[l] = ra;
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
    if (p == 0) {
        for (int a = 0; a < n_keep; ++a) {
            const uint64_t key = keys[a];
            const int slab = (int)(key & 0xFFFFu);
            const int id = (int)((uint32_t)(key >> 32) ^ 0x80000000u);
            int st, en;
            if (slab < LR * N) {
                st = slab % N;
                en = st + slab / N;
            } else {
                st = slab - LR * N;
                en = run_end[st];
            }
            const int q1 = st < N ? st : N;
            const int q2 = en + 1 < N ? en + 1 : N;
            const bool free1 = !bit_at(mask, q1);
            const bool free2 = (en + 1 >= len) || !bit_at(mask, q2);
            if (free1 && free2) {
                if (en >= st + 1) set_range(mask, st + 1, en);
                win_id[st] = id;  // a later claim at the same start wins
                win_end[st] = en;
                has_win[st] = 1;
            }
        }
    }
    __syncthreads();

    // ------------------------------------------------------------------ EMIT
    const bool tok = valid && has_win[p] && !bit_at(mask, p);
    int count;
    const int slot = block_scan(tok ? 1 : 0, buf, OpSum(), 0, nullptr, &count);
    if (tok) {
        int raw = win_id[p];
        if (prio2id) {
            const int c = raw < 0 ? 0 : (raw > trie_v - 1 ? trie_v - 1 : raw);
            raw = raw == 0 ? unk_id : prio2id[c];
        }
        out_ids[row + slot] = raw + id_offset;
        out_starts[row + slot] = p;
        out_ends[row + slot] = win_end[p];
    }
    if (in && p >= count) {
        out_ids[row + p] = id_offset;
        out_starts[row + p] = 0;
        out_ends[row + p] = 0;
    }
    if (p == 0) {
        counts[b] = count;
        fallback[b] = (any_ovf || n_arcs > a_max || any_anom) ? 1 : 0;
    }
}

template <bool RANK>
static int launch(const int32_t* m_pack, const float* m_rank,
                  const uint8_t* slot_overflow, const int32_t* x,
                  const int32_t* lengths, const int32_t* prio2id, int B, int N,
                  int LR, int a_max, int spm_iw, int unk_id, int id_offset,
                  int fast, int trie_v, int32_t* out_ids, int32_t* out_starts,
                  int32_t* out_ends, int32_t* counts, uint8_t* fallback,
                  cudaStream_t stream) {
    const int T = ((N + 31) / 32) * 32;
    int P_max = 1;
    while (P_max < a_max) P_max <<= 1;
    const int W = (N + 32) / 32;
    const size_t smem = (size_t)P_max * (RANK ? 12 : 8) + (size_t)N * 12 +
                        (size_t)W * 4 + 32 * 4 + (size_t)N * 2;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            bpe_resolve_kernel<RANK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    bpe_resolve_kernel<RANK><<<B, T, smem, stream>>>(
        m_pack, m_rank, slot_overflow, x, lengths, prio2id, B, N, LR, a_max,
        P_max, spm_iw, unk_id, id_offset, fast, trie_v, out_ids, out_starts,
        out_ends, counts, fallback);
    return (int)cudaGetLastError();
}

// m_rank == NULL: no rank key (plain and merge-priority modes)
extern "C" int bf_bpe_resolve(const int32_t* m_pack, const float* m_rank,
                              const uint8_t* slot_overflow, const int32_t* x,
                              const int32_t* lengths, const int32_t* prio2id,
                              int B, int N, int LR, int a_max, int spm_iw,
                              int unk_id, int id_offset, int fast, int trie_v,
                              int32_t* out_ids, int32_t* out_starts,
                              int32_t* out_ends, int32_t* counts,
                              uint8_t* fallback, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (m_rank)
        return launch<true>(m_pack, m_rank, slot_overflow, x, lengths, prio2id,
                            B, N, LR, a_max, spm_iw, unk_id, id_offset, fast,
                            trie_v, out_ids, out_starts, out_ends, counts,
                            fallback, s);
    return launch<false>(m_pack, m_rank, slot_overflow, x, lengths, prio2id, B,
                         N, LR, a_max, spm_iw, unk_id, id_offset, fast, trie_v,
                         out_ids, out_starts, out_ends, counts, fallback, s);
}
