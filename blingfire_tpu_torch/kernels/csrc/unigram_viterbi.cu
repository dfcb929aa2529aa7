// K6 unigram_viterbi: the unigram LM's best segmentation from the walk's arcs.
//
// Replaces everything after the walk in blingfire_tpu/ops/unigram.py::
// unigram_segment (unigram.py:214-351): the re-index of arcs by end
// (roll_d), the DP scan in df64 pairs (dfloat.cuh), the backtrace, the
// deferred id gather and the left compaction with id_offset.
//
// Bound.  The bytes are the B*N*L*8 of the arcs (m_key, m_score), read
// once, and the outputs; the DP itself is a serial chain of one step per
// position of a row, and each step's winner feeds the next step's
// candidates, so a row takes N times the chain's step latency whatever the
// card's bandwidth.  The design shortens that step; rows run side by side.
// The df64 sums are never reassociated: the argmax at a position depends on
// the rounding of the running sum, so no split of the chain is exact.  The
// winner at an end is the first maximum of (hi, lo) in the order depth
// L-1 .. 0, then the unknown arc: beats() on (hi, lo, candidate index) is
// a total order, so any order of comparisons finds it.
//
// Lane groups (L <= 32).  A row is a group of G lanes, G the smallest power
// of two >= L (raised only when a warp's rows would not fit in shared
// memory), so a warp runs 32 / G rows.  Every lane runs every step up to the
// longest row of its warp (full-mask shuffles and ballots).
//
// A register ring of running bests.  Lane k < L holds the running best
// (hi, lo, candidate index, key) of the one position among the next L whose
// index is k mod L.  At end e, lane x = e mod L has seen every arc of e; it
// adds the unknown arc (best[e-1] - 100000 where no arc starts at e), and
// its winner best[e] reaches every lane of the group in one shuffle of hi
// and lo.  Each lane then relaxes its position with the arc that starts at
// e + 1 and ends there, and lane x, its position done, starts e + L.  The
// chain of a step is one compare, one shuffle, one df64 add and one beats().
// (A first version kept candidate j on lane j and found the winner with a
// log2(G)-round butterfly over a ring of bests shifted by a shuffle: every
// round sat on the chain.  PERF.md has both measured on the H100.)
// Arcs that would start before the row are no arcs, (-FLT_MAX, 0), and
// best[-1] is (0, 0), as the plain version's masks have them.
//
// Staged arcs.  No global load is on the chain: the row's m_key/m_score are
// copied with cp.async (16-byte vectors when the rows are 16-byte aligned,
// else 4 bytes) in tiles of 16 positions into a ring of 4 tiles in
// shared memory, two tiles ahead of the chain, and each step's operands are
// read from the ring a step ahead.  The L lanes of a step read the L arcs
// that start at one position, L consecutive words (no bank conflict), and a
// ballot of their keys is that position's no-match flag.
//
// Shared memory a row: the tile ring (512 L bytes) and 5 bytes a position
// for the backtrace, where the earlier kernel kept 17: a word, the winning
// arc's key (or, where the unknown arc won, the run's begin), and a flags
// byte: bit 1 the unknown arc won, bit 2 a segment ends here, bits 3-7 the
// winning arc's depth.
//
// L > 32 (no main-path shape): one row a warp, the candidates strided over
// the lanes, the bests in a shared ring of a power of two > L positions, the
// arcs read from global memory, begins in the words; flags bit 0 marks a
// position where no match starts.
//
// Backtrace and emit: one lane of each group walks the begins from the last
// position and marks the segment ends; the group's lanes then gather the
// ids (clamped as XLA clamps), compact the marked ends left with a ballot
// and pad with id_offset, 0, 0.

#include <cfloat>
#include <climits>
#include <cmath>

#include "common.cuh"
#include "dfloat.cuh"

namespace {

constexpr float kNegInf = -FLT_MAX;
constexpr float kUnkScore = -100000.0f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may ask for
constexpr int kFlagNoMatch = 1, kFlagUnk = 2, kFlagEmit = 4;
constexpr int kTile = 16;  // positions an arc tile of the lane-group kernel

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// (h, l, j) beats (bh, bl, bj): a strictly greater df64 pair, or an equal
// pair at a lower candidate index
__device__ __forceinline__ bool beats(float h, float l, int j, float bh,
                                      float bl, int bj) {
    return df_lt(bh, bl, h, l) | (!df_lt(h, l, bh, bl) & (j < bj));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A group's bits of a warp-wide ballot, lane j of the group at bit j
template <int G>
__device__ __forceinline__ unsigned group_bits(unsigned bal, int g) {
    return G == 32 ? bal : (bal >> (g * G)) & ((1u << (G & 31)) - 1u);
}

// Backtrace from the row's last position (lane 0 of the group marks the
// segment ends), then the group's G lanes compact the marked ends left,
// gather the ids and pad.  Every lane of the warp calls it; e_end is the
// warp's largest n_act.  kKeyed (the lane-group kernel): a position's word
// holds the winning arc's key, and its flags byte the arc's depth above
// bit 3, or, when the unknown arc won, the word holds the run's begin;
// otherwise (the strided kernel) the word holds the begin and the key is
// read from m_key as the plain version gathers it.
template <int G, bool kKeyed>
__device__ __forceinline__ void backtrace_emit(
    int j, int g, bool live, int64_t b, int len, int n_act, int e_end,
    int* word, uint8_t* flg, const int32_t* kr,
    const int32_t* __restrict__ ids_tab, int nkeys, int N, int L, int unk_id,
    int id_offset, int32_t* __restrict__ out_ids,
    int32_t* __restrict__ out_starts, int32_t* __restrict__ out_ends,
    int32_t* __restrict__ counts) {
    auto begin_of = [&](int p, int f) {
        return !kKeyed || (f & kFlagUnk) ? word[p] : p - (f >> 3);
    };
    // begins never exceed their end: the walk ends
    if (j == 0) {
        for (int cur = len - 1; cur >= 0 && cur < n_act;) {
            const int f = flg[cur];
            flg[cur] = f | kFlagEmit;
            cur = begin_of(cur, f) - 1;
        }
    }
    __syncwarp();
    if (kKeyed) {  // each segment's id in place of its key, loads in flight
#pragma unroll 8
        for (int p = j; p < n_act; p += G) {
            const int f = flg[p];
            if ((f & kFlagEmit) && !(f & kFlagUnk))
                word[p] = __ldg(ids_tab + clampi(word[p], 0, nkeys - 1));
        }
        __syncwarp();
    }
    const int64_t ro = b * N;
    int n = 0;
    for (int p0 = 0; p0 < e_end; p0 += G) {
        const int p = p0 + j;
        const int f = p < n_act ? flg[p] : 0;
        const bool mark = f & kFlagEmit;
        const unsigned gb = group_bits<G>(__ballot_sync(kFull, mark), g);
        if (mark) {
            const int k = n + __popc(gb & ((1u << j) - 1u));
            const int st = begin_of(p, f);
            int id;
            if (f & kFlagUnk) {
                id = unk_id;
            } else if (kKeyed) {
                id = word[p];
            } else {
                const int wd = clampi(p - st, 0, L - 1);
                const int key = kr[(int64_t)clampi(st, 0, N - 1) * L + wd];
                id = __ldg(ids_tab + clampi(key, 0, nkeys - 1));
            }
            out_ids[ro + k] = id + id_offset;
            out_starts[ro + k] = st;
            out_ends[ro + k] = p;
        }
        n += __popc(gb);
    }
    if (!live) return;
    for (int k = n + j; k < N; k += G) {
        out_ids[ro + k] = id_offset;
        out_starts[ro + k] = 0;
        out_ends[ro + k] = 0;
    }
    if (j == 0) counts[b] = n;
}

// L <= G <= 32: 32 / G rows a warp, one warp a block.  stride: the shared
// bytes of one row (tile ring, words, flags).
template <int G>
__global__ void __launch_bounds__(32) unigram_viterbi_kernel(
    const int32_t* __restrict__ m_key, const float* __restrict__ m_score,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ ids_tab,
    int nkeys, int B, int N, int L, int vec16, int stride, int unk_id,
    int id_offset, int32_t* __restrict__ out_ids,
    int32_t* __restrict__ out_starts, int32_t* __restrict__ out_ends,
    int32_t* __restrict__ counts) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int RW = 32 / G;
    const int lane = threadIdx.x & 31;
    const int g = lane / G, j = lane % G;
    const int64_t b = (int64_t)blockIdx.x * RW + g;
    const bool live = b < B;
    const int len = live ? lengths[b] : 0;
    const int n_act = clampi(len, 0, N);  // positions scanned
    const int e_end = __reduce_max_sync(kFull, n_act);

    constexpr int S = 4 * kTile;  // ring positions: tiles c, c+1, c+2, a spare
    unsigned char* base = smem + (size_t)g * stride;
    int32_t* sk = reinterpret_cast<int32_t*>(base);
    float* ss = reinterpret_cast<float*>(base + (size_t)S * L * 4);
    int* word = reinterpret_cast<int*>(base + (size_t)S * L * 8);
    uint8_t* flg = reinterpret_cast<uint8_t*>(word + N);
    const int32_t* kr = live ? m_key + b * N * L : m_key;
    const float* sr = live ? m_score + b * N * L : m_score;

    // tile c of the row into ring slot c mod 4: one commit group a tile
    auto stage = [&](int c) {
        const int p0 = c * kTile, p1 = min(p0 + kTile, n_act);
        if (p1 > p0) {
            int32_t* dk = sk + (size_t)(c & 3) * kTile * L;
            float* ds = ss + (size_t)(c & 3) * kTile * L;
            const int64_t o = (int64_t)p0 * L;
            const int cnt = (p1 - p0) * L;
            if (vec16) {  // rows and tiles 16-byte aligned, N*L % 4 == 0
                for (int v = 4 * j; v < cnt; v += 4 * G) {
                    cp_async16(dk + v, kr + o + v);
                    cp_async16(ds + v, sr + o + v);
                }
            } else {
                for (int v = j; v < cnt; v += G) {
                    cp_async4(dk + v, kr + o + v);
                    cp_async4(ds + v, sr + o + v);
                }
            }
        }
        cp_async_commit();
    };
    // the register ring of running bests (see the note at the top): lane k
    // < L holds the position of the next L that is k mod L
    const bool act = j < L;
    // the depth lane k pushes after end e, whose finalizing lane is x
    auto depth = [&](int x) {
        const int d = j - x - 1;
        return act ? (d < 0 ? d + L : d) : 0;
    };
    // the next step's operands, read from shared memory a step ahead: the
    // arc starting at e + 2 of this lane's depth then.  The L lanes read
    // the L arcs that start there, so a ballot of their keys is the no-match
    // flag of that start (the unknown arc's condition).
    int n_key = 0;
    float n_sc = 0.0f;
    auto fetch = [&](int e, int x) {  // for the push after end e + 1
        const int at = ((e + 2) & (S - 1)) * L + depth(x);
        n_key = sk[at];
        n_sc = ss[at];
    };
    auto no_match = [&](int key) {
        return group_bits<G>(__ballot_sync(kFull, act && key >= 0), g) == 0;
    };

    stage(0);
    stage(1);
    cp_async_wait1();
    __syncwarp();

    // positions 0 .. L-1 on lanes 0 .. L-1.  An arc that would start before
    // the row is no arc, (-FLT_MAX, 0), the first of them, index 0, wins
    // their ties; its key is the plain version's clamped gather (0, L-1).
    float rh = -INFINITY, rl = -INFINITY;
    int ri = INT_MAX, rk = 0;
    if (act && j < L - 1) {
        rh = kNegInf;
        rl = 0.0f;
        ri = 0;
        rk = sk[L - 1];
    }
    // best[-1] = (0, 0) relaxes position k with the arc (0, k)
    auto relax = [&](float bh, float bl, int key, float sc, int d) {
        float ch, cl;
        df_add(bh, bl, sc, ch, cl);
        const bool arc = key >= 0;
        ch = arc ? ch : kNegInf;
        cl = arc ? cl : 0.0f;
        const int ci = L - 1 - d;
        const bool take = act && beats(ch, cl, ci, rh, rl, ri);
        rh = take ? ch : rh;
        rl = take ? cl : rl;
        ri = take ? ci : ri;
        rk = take ? key : rk;
    };
    bool nm;  // no match starts at the next end
    {
        const int d = act ? j : 0;
        relax(0.0f, 0.0f, sk[d], ss[d], d);
        nm = no_match(sk[d]);
    }
    float uh, ul;  // the unknown arc of the next end: best[e-1] - 100000
    df_add(0.0f, 0.0f, kUnkScore, uh, ul);
    fetch(-1, 0);

    bool prev_unk = false;
    int prev_begin = 0;
    int x = 0;  // e mod L: the lane that holds end e
    for (int c = 0; c * kTile < e_end; ++c) {
        __syncwarp();  // tile c-2's slot is read no more
        stage(c + 2);
        cp_async_wait1();  // tile c+1 has landed
        __syncwarp();
        const int e1 = min(c * kTile + kTile, e_end);
        for (int e = c * kTile; e < e1; ++e) {
            const int key = n_key;
            const float sc = n_sc;
            const bool nm_next = no_match(key);
            const int xn = x + 1 == L ? 0 : x + 1;
            fetch(e, xn);
            // end e on lane x: the unknown arc wins only when strictly
            // greater (its index, L, is the last)
            const bool take_u = nm && df_lt(rh, rl, uh, ul);
            const float fh = take_u ? uh : rh, fl = take_u ? ul : rl;
            const int fi = take_u ? L : ri;
            const int fk = rk;
            const float bh = __shfl_sync(kFull, fh, x, G);
            const float bl = __shfl_sync(kFull, fl, x, G);
            const int wi = __shfl_sync(kFull, fi, x, G);
            const int wk = __shfl_sync(kFull, fk, x, G);
            // lane x starts position e + L with its first candidate
            if (j == x) {
                rh = -INFINITY;
                rl = -INFINITY;
                ri = INT_MAX;
            }
            relax(bh, bl, key, sc, depth(x));
            df_add(bh, bl, kUnkScore, uh, ul);
            // bookkeeping off the chain: begin, the run merge, the stores
            // (every lane of the group stores the same values: no branch;
            // a finished row's positions are read by no later phase)
            const bool w_unk = wi == L;
            const int dw = L - 1 - wi;
            const int begin = w_unk ? (prev_unk ? prev_begin : e) : e - dw;
            word[e] = w_unk ? begin : wk;
            flg[e] = w_unk ? kFlagUnk : dw << 3;
            prev_unk = w_unk;
            prev_begin = begin;
            nm = nm_next;
            x = xn;
        }
    }
    cp_async_wait_all();  // no copy is left in flight (the last are empty)
    __syncwarp();
    backtrace_emit<G, true>(j, g, live, b, len, n_act, e_end, word, flg, kr,
                            ids_tab, nkeys, N, L, unk_id, id_offset, out_ids,
                            out_starts, out_ends, counts);
}

// L > 32: one row a warp; bests in a shared ring of R (a power of two > L)
// positions, arcs from global memory.
__global__ void __launch_bounds__(32) unigram_viterbi_wide_kernel(
    const int32_t* __restrict__ m_key, const float* __restrict__ m_score,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ ids_tab,
    int nkeys, int B, int N, int L, int R, int unk_id, int id_offset,
    int32_t* __restrict__ out_ids, int32_t* __restrict__ out_starts,
    int32_t* __restrict__ out_ends, int32_t* __restrict__ counts) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int64_t b = blockIdx.x;  // B blocks: every row is live
    float* rh = reinterpret_cast<float*>(smem);
    float* rl = rh + R;
    int* beg = reinterpret_cast<int*>(rl + R);
    uint8_t* flg = reinterpret_cast<uint8_t*>(beg + N);
    const int len = lengths[b];
    const int n_act = clampi(len, 0, N);
    const int32_t* kr = m_key + b * N * L;
    const float* sr = m_score + b * N * L;

    for (int p = lane; p < n_act; p += 32) {
        bool has = false;
        for (int d = 0; d < L && !has; ++d) has = kr[(int64_t)p * L + d] >= 0;
        flg[p] = has ? 0 : kFlagNoMatch;
    }
    __syncwarp();

    bool prev_unk = false;
    int prev_begin = 0;
    for (int e = 0; e < n_act; ++e) {
        float bh = -INFINITY, bl = -INFINITY;
        int bj = INT_MAX;
        for (int j = lane; j <= L; j += 32) {
            float ch = kNegInf, cl = 0.0f;
            if (j < L) {
                const int d = L - 1 - j;
                const int st = e - d;
                if (st >= 0 && kr[(int64_t)st * L + d] >= 0) {
                    const float esc = sr[(int64_t)st * L + d];
                    const bool before = st - 1 >= 0;
                    const int q = (st - 1) & (R - 1);
                    df_add(before ? rh[q] : 0.0f, before ? rl[q] : 0.0f, esc,
                           ch, cl);
                }
            } else if (flg[e] & kFlagNoMatch) {
                const int q = (e - 1) & (R - 1);
                df_add(e >= 1 ? rh[q] : 0.0f, e >= 1 ? rl[q] : 0.0f,
                       kUnkScore, ch, cl);
            }
            if (beats(ch, cl, j, bh, bl, bj)) {
                bh = ch;
                bl = cl;
                bj = j;
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float oh = __shfl_xor_sync(kFull, bh, o);
            const float ol = __shfl_xor_sync(kFull, bl, o);
            const int oj = __shfl_xor_sync(kFull, bj, o);
            if (beats(oh, ol, oj, bh, bl, bj)) {
                bh = oh;
                bl = ol;
                bj = oj;
            }
        }
        const bool w_unk = bj == L;
        int begin = e - (w_unk ? 0 : L - 1 - bj);
        if (w_unk && prev_unk) begin = prev_begin;
        __syncwarp();  // every lane has read the ring slot written next
        if (lane == 0) {
            rh[e & (R - 1)] = bh;
            rl[e & (R - 1)] = bl;
            beg[e] = begin;
            if (w_unk) flg[e] |= kFlagUnk;
        }
        prev_unk = w_unk;
        prev_begin = begin;
        __syncwarp();
    }
    backtrace_emit<32, false>(lane, 0, true, b, len, n_act, n_act, beg, flg,
                              kr, ids_tab, nkeys, N, L, unk_id, id_offset,
                              out_ids, out_starts, out_ends, counts);
}

size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class K>
int set_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int G>
int launch_group(const int32_t* m_key, const float* m_score,
                 const int32_t* lengths, const int32_t* ids_tab, int nkeys,
                 int B, int N, int L, int vec16, size_t stride,
                 int unk_id, int id_offset, int32_t* out_ids,
                 int32_t* out_starts, int32_t* out_ends, int32_t* counts,
                 cudaStream_t s) {
    constexpr int RW = 32 / G;
    const size_t smem = RW * stride;
    const int e = set_smem(unigram_viterbi_kernel<G>, smem);
    if (e != 0) return e;
    const unsigned blocks = (unsigned)((B + RW - 1) / RW);
    unigram_viterbi_kernel<G><<<blocks, 32, smem, s>>>(
        m_key, m_score, lengths, ids_tab, nkeys, B, N, L, vec16,
        (int)stride, unk_id, id_offset, out_ids, out_starts, out_ends,
        counts);
    return (int)cudaGetLastError();
}

}  // namespace

// m_key, m_score (B, N, L); lengths (B,); outputs (B, N) and counts (B,).
// One warp a block, so that a launch of a few hundred rows still spreads
// over every SM.  Returns cudaErrorInvalidValue for a shape whose shared
// memory does not fit (ops/unigram.py checks the same limits first).
extern "C" int bf_unigram_viterbi(const int32_t* m_key, const float* m_score,
                                  const int32_t* lengths,
                                  const int32_t* ids_tab, int nkeys, int B,
                                  int N, int L, int unk_id, int id_offset,
                                  int32_t* out_ids, int32_t* out_starts,
                                  int32_t* out_ends, int32_t* counts,
                                  void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (L > 32) {
        int R = 1;
        while (R <= L) R <<= 1;
        const size_t smem = align16((size_t)8 * R + (size_t)5 * N);
        if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
        const int e = set_smem(unigram_viterbi_wide_kernel, smem);
        if (e != 0) return e;
        unigram_viterbi_wide_kernel<<<(unsigned)B, 32, smem, s>>>(
            m_key, m_score, lengths, ids_tab, nkeys, B, N, L, R, unk_id,
            id_offset, out_ids, out_starts, out_ends, counts);
        return (int)cudaGetLastError();
    }
    int G = 1;
    while (G < L) G <<= 1;
    const size_t stride = align16((size_t)32 * kTile * L + (size_t)5 * N);
    while (G < 32 && (size_t)(32 / G) * stride > (size_t)kMaxSmem) G <<= 1;
    if ((size_t)(32 / G) * stride > (size_t)kMaxSmem)
        return (int)cudaErrorInvalidValue;
    const int vec16 = aligned16(m_key) && aligned16(m_score) &&
                      ((int64_t)N * L) % 4 == 0;
#define BF_VITERBI_CASE(g)                                                    \
    case g:                                                                   \
        return launch_group<g>(m_key, m_score, lengths, ids_tab, nkeys, B, N, \
                               L, vec16, stride, unk_id, id_offset,           \
                               out_ids, out_starts, out_ends, counts, s);
    switch (G) {
        BF_VITERBI_CASE(1)
        BF_VITERBI_CASE(2)
        BF_VITERBI_CASE(4)
        BF_VITERBI_CASE(8)
        BF_VITERBI_CASE(16)
        BF_VITERBI_CASE(32)
    }
#undef BF_VITERBI_CASE
    return (int)cudaErrorInvalidValue;
}
