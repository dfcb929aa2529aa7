// K10 hyph_segment: W2H hyphenation of a batch of anchored words, rows
// [L_ANCHOR c1 .. cn R_ANCHOR -1 ...] of dense input weights, into (B, M-2)
// int32 per-position ops.  Replaces blingfire_tpu/ops/hyph.py::hyph_segment
// (hyph.py:67-143) with its _scatter_min/_scatter_max (:146-161).
//
// One block a row, one thread a start position (a thread takes p,
// p + blockDim.x, ... when M exceeds the block).  The row and two W-long
// grids, the least and the greatest op applied to each position, sit in
// shared memory; the grids start at BIG and -BIG before any thread writes.
// A start From < n + 2 - (min_pat_len - 1) walks the comb table from state
// 0 until its state dies or the row ends; the JAX while loop runs on until
// every lane of the batch is dead, and a dead lane stays dead, so the grids
// are the same.  At each final the pattern's ops j in [js, je) go to
// position From + j - 1 by shared atomicMin/atomicMax: js = 1 only at From
// 0 (the L anchor's op), je = plen - max(0, From + plen - n), DONT_CARE
// skipped.  Min and max are order-free, so the result is deterministic
// (the reference's first-wins/CONFLICT rule is CONFLICT iff two distinct
// ops cover a position).  After a barrier each position resolves to
// UNKNOWN, the op or CONFLICT, and the edge suppression of no_hyph_len
// applies (FAHyphInterpreter_core_t.h:252-263).
//
// A comb lookup takes no transition when base[s] + c falls outside
// [0, n_slots).  JAX clamps that slot (hyph.py:96) and so, from the state
// that owns slot 0, takes slot 0's transition for a symbol below its
// lowest one (ROADMAP.md section C).  The unmapped-symbol sentinel n_iws
// stays in range (ops/tables.py guarantees base + n_iws < n_slots) and
// misses.  XLA's other clamps are explicit here: the pattern id into
// [0, n_pats) (hyph.py:101, :109) and the state into [0, n_states)
// (hyph.py:99-100).  Op values such as (sym << 4) | code stay int32.
//
// Bound: bytes.  The rows in (4 B a lane, 4 B a row), the ops out (4 B a
// position), and each table entry the walks read once; a syllab-sized
// table (about 100k states, 150k slots, 9k op rows) sits in the 50 MB L2.
// Walks are short (a pattern has at most max_pat symbols), so most of a
// block's time is the row load, the grid set-up and the write-back.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 320;
constexpr int kBig = 1 << 30;
constexpr int kUnknown = -1;
constexpr int kConflict = -2;
constexpr int kNoHyph = 0;
constexpr int kDontCare = 7;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

struct Tables {
    const int32_t* base;
    const int32_t* owner;
    const int32_t* nxt;
    const uint8_t* final_;
    const int32_t* moore_ow;
    int n_states;
    int n_slots;
    const int32_t* pat_vals;  // (n_pats, max_pat)
    const int32_t* pat_len;   // (n_pats,)
    int n_pats;
    int max_pat;
    int min_pat_len;
    int no_hyph_len;
};

__global__ void hyph_segment_kernel(Tables t, const int32_t* __restrict__ x,
                                    const int32_t* __restrict__ word_len,
                                    int M, int32_t* __restrict__ out) {
    extern __shared__ int32_t smem[];
    const int W = M - 2;
    int32_t* xs = smem;         // M: the row
    int32_t* vmin = xs + M;     // W
    int32_t* vmax = vmin + W;   // W
    const int64_t b = blockIdx.x;
    const int32_t* xrow = x + b * M;
    for (int i = threadIdx.x; i < M; i += blockDim.x) xs[i] = xrow[i];
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        vmin[i] = kBig;
        vmax[i] = -kBig;
    }
    __syncthreads();

    const int32_t n = word_len[b];
    const int64_t lim = (int64_t)n + 2 - (t.min_pat_len - 1);
    for (int p = threadIdx.x; p < M; p += blockDim.x) {
        if (p >= lim) continue;
        int32_t state = 0;
        for (int q = p; q < M; ++q) {
            const int32_t c = xs[q];
            if (c < 0) break;
            const int64_t raw =
                (int64_t)__ldg(t.base + clamp64(state, 0, t.n_states - 1)) + c;
            if (raw < 0 || raw >= t.n_slots || __ldg(t.owner + raw) != state)
                break;
            state = __ldg(t.nxt + raw);
            if (state < 0) break;
            const int64_t s = clamp64(state, 0, t.n_states - 1);
            if (!__ldg(t.final_ + s) || t.n_pats <= 0) continue;
            const int64_t pid =
                clamp64(__ldg(t.moore_ow + s), 0, t.n_pats - 1);
            const int plen = __ldg(t.pat_len + pid);
            const int64_t oob = (int64_t)p + plen - n;
            const int64_t je = plen - (oob > 0 ? oob : 0);
            const int32_t* vals = t.pat_vals + pid * t.max_pat;
            for (int j = p == 0 ? 1 : 0; j < je && j < t.max_pat; ++j) {
                const int32_t ow = __ldg(vals + j);
                const int oi = p + j - 1;
                if (ow == kDontCare || oi < 0 || oi >= W) continue;
                atomicMin(vmin + oi, ow);
                atomicMax(vmax + oi, ow);
            }
        }
    }
    __syncthreads();

    const int64_t k = n < t.no_hyph_len ? n : t.no_hyph_len;
    int32_t* orow = out + b * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        const int32_t lo = vmin[i], hi = vmax[i];
        int32_t v = lo == kBig ? kUnknown : (lo == hi ? lo : kConflict);
        const bool lead = i < k;
        const bool tail = i >= (int64_t)n - 1 - k && i < (int64_t)n - 1 && i > 0;
        orow[i] = lead || tail ? kNoHyph : v;
    }
}

}  // namespace

extern "C" int bf_hyph_segment(
    const int32_t* base, const int32_t* owner, const int32_t* nxt,
    const uint8_t* final_, const int32_t* moore_ow, int n_states, int n_slots,
    const int32_t* pat_vals, const int32_t* pat_len, int n_pats, int max_pat,
    int min_pat_len, int no_hyph_len, const int32_t* x,
    const int32_t* word_len, int B, int M, int32_t* out, void* stream) {
    if (B <= 0) return 0;
    if (M < 2 || n_states <= 0 || max_pat <= 0) return (int)cudaErrorInvalidValue;
    const Tables t{base,     owner,   nxt,    final_,  moore_ow,    n_states,
                   n_slots,  pat_vals, pat_len, n_pats, max_pat, min_pat_len,
                   no_hyph_len};
    const int threads = M < kMaxThreads ? (M + 31) / 32 * 32 : kMaxThreads;
    const size_t shm = (size_t)(3 * M - 4) * sizeof(int32_t);
    hyph_segment_kernel<<<(unsigned)B, threads, shm, (cudaStream_t)stream>>>(
        t, x, word_len, M, out);
    return (int)cudaGetLastError();
}
