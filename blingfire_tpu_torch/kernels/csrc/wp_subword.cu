// K7 wp_subword_dense and K8 wp_subword_comb: the WordPiece sub-token pass
// over packed unique word units, [L w1 R][L w2 R]... in rows of M <= 128.
//
// K7 replaces blingfire_tpu/ops/lexer.py::wp_subword_pass_dense
// (lexer.py:246-292) with _wp_emit (lexer.py:295-350): a walk of one gather
// a step in the dense finals-first table dnext[state * A + c] (a final is
// ns < n_f), then one ow_perm gather at the deepest final.  K8 replaces
// wp_subword_pass (lexer.py:353-443): the comb walk, five gathers a step
// there (base, owner, nxt, final, moore_ow), each waiting on the one
// before.  K8 reads chained slot records instead (ops/lexer.py::comb_chain,
// int4 (owner, nxt, base[nxt], final[nxt]) a slot), so a step is one
// dependent 16-byte load: the slot's owner decides the hit, and the same
// record carries the next state, whether it is final and the base of the
// next step's slot.  A start's base comes once from K9's state record
// (base, final, Moore Ow, 0), as does the Moore Ow of its deepest final.
// The main path takes K8 when make_dense_sub declines the dense table (a
// multilingual vocabulary: thousands of symbols).  Both end in
// wp_emit.cuh.
//
// One launch takes a batch's rows of both unit-length classes: rows below
// `split` walk lw steps at most, the others lw_hi.  One warp a row, kRows
// rows a block and no block barrier; a thread walks the row's positions
// lane + 32k (k < 4) in lockstep, so their loads are in flight together,
// and a start stops at its first dead state (the JAX walk carries -1 from
// there on).  XLA clamps every gather silently and CUDA does not, so each
// clamp is explicit: the dense flat index to [0, top] (lexer.py:273-276), a
// state index to [0, n_states - 1], ow_perm's index (lexer.py:289) and the
// action lookups (wp_emit.cuh).  The comb slot is not clamped: a slot
// outside [0, n_slots) is no transition.  JAX clamps it (lexer.py:389-392)
// and so takes slot 0's transition from the state that owns slot 0 when
// the slot falls below 0; the automaton has no such transition
// (ROADMAP.md section C).  The token-length gate (d >= max_token_length:
// only the R anchor passes, lexer.py:277-279) is kept though lw <= 42
// never reaches the usual 300.
//
// Bound: bytes.  The rows (x, init: 8 bytes a lane) in, M + 2 int32 out,
// and each table entry the walks and the action lookups read, once.  The
// dense table of a bert-sized vocabulary is tens of MB, near the 50 MB L2,
// so a walk is a chain of L2 (or DRAM) round trips: a row takes as long as
// its longest walk, and one launch puts every row of a batch in flight at
// once.  The comb records are a few MB and stay in L2: K8's step is one
// L2 round trip.

#include "wp_emit.cuh"

namespace {

using wp::clamp64;
using wp::kPer;

constexpr int kRows = 4;  // rows (warps) a block

struct Row {
    const int32_t* x;     // (B, M) dense input weights, -1 padding
    const int32_t* init;  // (B, M) per-lane initial state
    int64_t B;
    int M;
    int32_t l_iw, r_iw;
    int lw, split, lw_hi;  // rows below split walk lw steps, others lw_hi
    int max_tok;
    int32_t* out;  // (B, M + 2)
};

// A table's lockstep step: the next state ns[k] of each of a thread's
// starts from state st[k] on symbol c[k] (-1: none; a dead start or a
// padding symbol has none) and whether it is final, the loads for the kPer
// starts issued together; carry[k] is what a table keeps of a start between
// steps (the comb: its state's base; set by start()).  And the Moore Ow of
// the deepest final, gathered once.
struct Dense {
    const int32_t* dnext;
    int64_t top;  // dnext entries - 1
    const int32_t* ow_perm;
    int n_ow;
    int n_f;
    int n_a;

    __device__ __forceinline__ int32_t start(int32_t) const { return 0; }
    __device__ __forceinline__ void step(const int32_t (&st)[kPer],
                                         const int32_t (&c)[kPer],
                                         int32_t (&)[kPer],
                                         int32_t (&ns)[kPer],
                                         bool (&fin)[kPer]) const {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            ns[k] = st[k] >= 0 && c[k] >= 0
                        ? __ldg(dnext + clamp64((int64_t)st[k] * n_a + c[k],
                                                0, top))
                        : -1;
            fin[k] = ns[k] >= 0 && ns[k] < n_f;  // finals are numbered first
        }
    }
    __device__ __forceinline__ int32_t ow_of(int32_t fin) const {
        return fin >= 0 ? __ldg(ow_perm + clamp64(fin, 0, n_ow - 1)) : -1;
    }
};

struct Comb {
    const int4* chain;      // (owner, nxt, base[nxt], final[nxt]) a slot
    const int4* state_rec;  // (base, final, moore_ow, 0) a state
    int n_states;
    int n_slots;

    __device__ __forceinline__ const int32_t* state(int32_t s) const {
        return reinterpret_cast<const int32_t*>(
            state_rec + clamp64(s, 0, n_states - 1));
    }
    __device__ __forceinline__ int32_t start(int32_t s) const {
        return s >= 0 ? __ldg(state(s)) : 0;
    }
    __device__ __forceinline__ void step(const int32_t (&st)[kPer],
                                         const int32_t (&c)[kPer],
                                         int32_t (&base)[kPer],
                                         int32_t (&ns)[kPer],
                                         bool (&fin)[kPer]) const {
        bool in[kPer];
        int4 rec[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const int64_t raw = (int64_t)base[k] + c[k];
            // no transition outside the slot array (ops/lexer.py::comb_lookup)
            in[k] = st[k] >= 0 && c[k] >= 0 && raw >= 0 && raw < n_slots;
            rec[k] = in[k] ? __ldg(chain + raw) : make_int4(-1, -1, 0, 0);
        }
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const bool hit = in[k] && rec[k].x == st[k];
            ns[k] = hit ? rec[k].y : -1;
            fin[k] = hit && rec[k].w != 0;
            base[k] = rec[k].z;
        }
    }
    __device__ __forceinline__ int32_t ow_of(int32_t fin) const {
        return fin >= 0 ? __ldg(state(fin) + 2) : -1;
    }
};

// The walks from the thread's positions p = 32k + lane whose go[k] is set,
// in lockstep: the deepest final's position and Moore Ow (-1: none).
template <class T>
__device__ __forceinline__ void walk(const T& t, const Row& r, int lw,
                                     const int32_t* xs,
                                     const int32_t (&init)[kPer],
                                     const bool (&go)[kPer],
                                     int32_t (&fin_pos)[kPer],
                                     int32_t (&fin_ow)[kPer]) {
    const int lane = threadIdx.x & 31;
    int32_t st[kPer], carry[kPer], last[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        st[k] = go[k] ? init[k] : -1;
        carry[k] = t.start(st[k]);
        last[k] = -1;
        fin_pos[k] = -1;
    }
    for (int d = 0; d < lw; ++d) {
        bool live = false;
#pragma unroll
        for (int k = 0; k < kPer; ++k) live |= st[k] >= 0;
        if (!live) break;
        int32_t c[kPer], ns[kPer];
        bool fin[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k)
            c[k] = st[k] >= 0 ? xs[32 * k + lane + d] : -1;
        t.step(st, c, carry, ns, fin);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            if (d >= r.max_tok && c[k] != r.r_iw) ns[k] = -1;
            if (ns[k] >= 0 && fin[k]) {
                fin_pos[k] = 32 * k + lane + d;
                last[k] = ns[k];
            }
            st[k] = ns[k];
        }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) fin_ow[k] = t.ow_of(last[k]);
}

template <class T>
__device__ __forceinline__ void wp_subword_row(const T& t, const Row& r,
                                               const wp::Actions& a) {
    extern __shared__ int32_t smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t b = (int64_t)blockIdx.x * kRows + warp;
    if (b >= r.B) return;  // the whole warp: no block barrier follows
    const int M = r.M;
    const int lw = b < r.split ? r.lw : r.lw_hi;
    // the row, then -1 padding for the walks past its end
    int32_t* xs = smem + warp * (M + max(r.lw, r.lw_hi) + 1);
    const int32_t* xrow = r.x + b * M;
    // ---- LOAD
    for (int i = lane; i < M + lw + 1; i += 32) xs[i] = i < M ? xrow[i] : -1;
    __syncwarp();
    // ---- WALK
    int32_t xp[kPer], init[kPer], fin_pos[kPer], fin_ow[kPer];
    bool go[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int p = 32 * k + lane;
        xp[k] = p < M ? xs[p] : -1;
        go[k] = xp[k] >= 0 && xp[k] != r.r_iw;
        init[k] = go[k] ? __ldg(r.init + b * M + p) : -1;
    }
    walk(t, r, lw, xs, init, go, fin_pos, fin_ow);
    // ---- SCAN
    wp::Start s[kPer];
    int32_t next[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int p = 32 * k + lane;
        if (p < M) {
            s[k] = wp::action(a, M, p, xp[k], go[k], r.l_iw, fin_pos[k],
                              fin_ow[k]);
        } else {
            s[k] = wp::Start{0, p + 1, false};
        }
        next[k] = s[k].next;
    }
    const unsigned vis = wp::visited(next);
    // ---- EMIT
    wp::emit_row(M, s, vis, r.out + b * (M + 2));
}

__global__ void __launch_bounds__(32 * kRows)
wp_subword_dense_kernel(Dense t, Row r, wp::Actions a) {
    wp_subword_row(t, r, a);
}

__global__ void __launch_bounds__(32 * kRows)
wp_subword_comb_kernel(Comb t, Row r, wp::Actions a) {
    wp_subword_row(t, r, a);
}

template <class T>
int launch(void (*kernel)(T, Row, wp::Actions), const T& t, const Row& r,
           const wp::Actions& a, cudaStream_t s) {
    if (r.B <= 0) return 0;
    if (r.M < 1 || r.M > wp::kMaxRow) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (r.B + kRows - 1) / kRows;
    const int lw_max = r.lw > r.lw_hi ? r.lw : r.lw_hi;
    const size_t shm = sizeof(int32_t) * kRows * (size_t)(r.M + lw_max + 1);
    kernel<<<(unsigned)blocks, 32 * kRows, shm, s>>>(t, r, a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bf_wp_subword_dense(
    const int32_t* dnext, int64_t n_dnext, const int32_t* ow_perm, int n_ow,
    int n_f, int n_a, const int32_t* act_right, const int32_t* act_tag,
    const int32_t* act_fn, int n_acts, const int32_t* x, const int32_t* init,
    int B, int M, int l_iw, int r_iw, int lw, int split, int lw_hi,
    int max_tok, int32_t* out, void* stream) {
    const Dense t{dnext, n_dnext - 1, ow_perm, n_ow, n_f, n_a};
    const Row r{x, init, B, M, l_iw, r_iw, lw, split, lw_hi, max_tok, out};
    const wp::Actions a{act_right, act_tag, act_fn, n_acts};
    return launch(wp_subword_dense_kernel, t, r, a, (cudaStream_t)stream);
}

extern "C" int bf_wp_subword_comb(
    const int32_t* chain, const int32_t* state_rec, int n_states, int n_slots,
    const int32_t* act_right, const int32_t* act_tag, const int32_t* act_fn,
    int n_acts, const int32_t* x, const int32_t* init, int B, int M, int l_iw,
    int r_iw, int lw, int split, int lw_hi, int max_tok, int32_t* out,
    void* stream) {
    if (((uintptr_t)chain | (uintptr_t)state_rec) & 15)
        return (int)cudaErrorMisalignedAddress;
    const Comb t{reinterpret_cast<const int4*>(chain),
                 reinterpret_cast<const int4*>(state_rec), n_states, n_slots};
    const Row r{x, init, B, M, l_iw, r_iw, lw, split, lw_hi, max_tok, out};
    const wp::Actions a{act_right, act_tag, act_fn, n_acts};
    return launch(wp_subword_comb_kernel, t, r, a, (cudaStream_t)stream);
}
