// K7 wp_subword_dense and K8 wp_subword_comb: the WordPiece sub-token pass
// over packed unique word units, [L w1 R][L w2 R]... in rows of M <= 128.
//
// K7 replaces blingfire_tpu/ops/lexer.py::wp_subword_pass_dense
// (lexer.py:246-292) with _wp_emit (lexer.py:295-350): a walk of one gather
// a step in the dense finals-first table dnext[state * A + c] (a final is
// ns < n_f), then one ow_perm gather at the deepest final.  K8 replaces
// wp_subword_pass (lexer.py:353-443): the comb walk, five gathers a step
// (base, owner, nxt, final, moore_ow); the main path takes it only when
// make_dense_sub declines the dense table.  Both end in wp_emit.cuh.
//
// One block a row, one thread a start position, lw steps at most; a lane
// stops at its first dead state (the JAX walk carries -1 from there on).
// XLA clamps every gather silently and CUDA does not, so each clamp is
// explicit: the dense flat index to [0, top] (lexer.py:273-276), a state
// index to [0, n_states - 1], ow_perm's index (lexer.py:289) and the action
// lookups (wp_emit.cuh).  The comb slot is not clamped: a slot outside
// [0, n_slots) is no transition.  JAX clamps it (lexer.py:389-392) and so
// takes slot 0's transition from the state that owns slot 0 when the slot
// falls below 0; the automaton has no such transition (ROADMAP.md
// section C).  The token-length gate (d >= max_token_length: only the R
// anchor passes, lexer.py:277-279) is kept though lw <= 42 never reaches
// the usual 300.
//
// Bound: bytes.  The rows (x, init: 8 bytes a lane) in, M + 2 int32 out,
// and each table entry the walks and the action lookups read, once.  The
// dense table of a bert-sized vocabulary is tens of MB, near the 50 MB L2;
// the sequential visited scan (128 steps on one thread) and the block of
// 128 threads a row are what keep this kernel from its bound.

#include "wp_emit.cuh"

namespace {

using wp::clamp64;

struct Row {
    const int32_t* x;     // (B, M) dense input weights, -1 padding
    const int32_t* init;  // (B, M) per-lane initial state
    int M;
    int32_t l_iw, r_iw;
    int lw;
    int max_tok;
    int32_t* out;  // (B, M + 2)
};

struct Dense {
    const int32_t* dnext;
    int64_t top;  // dnext entries - 1
    const int32_t* ow_perm;
    int n_ow;
    int n_f;
    int n_a;
};

struct Comb {
    const int32_t* base;
    const int32_t* owner;
    const int32_t* nxt;
    const uint8_t* final_;
    const int32_t* moore_ow;
    int n_states;
    int n_slots;
};

// deepest final of the walk from lane p: (*fin_pos, *fin_ow)
__device__ __forceinline__ void walk(const Dense& t, const Row& r,
                                     const int32_t* xs, int p, int32_t state,
                                     int32_t* fin_pos, int32_t* fin_ow) {
    int32_t fin_state = -1;
    for (int d = 0; d < r.lw && state >= 0; ++d) {
        const int32_t c = xs[p + d];
        int32_t ns = -1;
        if (c >= 0)
            ns = __ldg(t.dnext + clamp64((int64_t)state * t.n_a + c, 0, t.top));
        if (d >= r.max_tok && c != r.r_iw) ns = -1;
        if (ns >= 0 && ns < t.n_f) {
            *fin_pos = p + d;
            fin_state = ns;
        }
        state = ns;
    }
    *fin_ow = fin_state >= 0
                  ? __ldg(t.ow_perm + clamp64(fin_state, 0, t.n_ow - 1))
                  : -1;
}

__device__ __forceinline__ void walk(const Comb& t, const Row& r,
                                     const int32_t* xs, int p, int32_t state,
                                     int32_t* fin_pos, int32_t* fin_ow) {
    for (int d = 0; d < r.lw && state >= 0; ++d) {
        const int32_t c = xs[p + d];
        int32_t ns = -1;
        if (c >= 0) {
            const int32_t bs =
                __ldg(t.base + clamp64(state, 0, t.n_states - 1));
            // no transition outside the slot array (ops/lexer.py::comb_lookup)
            const int64_t raw = (int64_t)bs + c;
            if (raw >= 0 && raw < t.n_slots && __ldg(t.owner + raw) == state)
                ns = __ldg(t.nxt + raw);
        }
        if (d >= r.max_tok && c != r.r_iw) ns = -1;
        if (ns >= 0) {
            const int64_t s = clamp64(ns, 0, t.n_states - 1);
            if (__ldg(t.final_ + s)) {
                *fin_pos = p + d;
                *fin_ow = __ldg(t.moore_ow + s);
            }
        }
        state = ns;
    }
}

template <class T>
__device__ __forceinline__ void wp_subword_row(const T& t, const Row& r,
                                               const wp::Actions& a) {
    extern __shared__ int32_t smem[];
    const int M = r.M;
    int32_t* xs = smem;              // M + lw + 1: the row, then -1 padding
    int32_t* skip = xs + M + r.lw + 1;  // M
    int32_t* vis = skip + M;            // M
    int* buf = vis + M;                 // 32
    const int64_t b = blockIdx.x;
    const int p = threadIdx.x;
    const int32_t* xrow = r.x + b * M;
    for (int i = p; i < M + r.lw + 1; i += blockDim.x)
        xs[i] = i < M ? xrow[i] : -1;
    __syncthreads();
    const bool active = p < M;
    const int32_t xp = active ? xs[p] : -1;
    const bool valid = xp >= 0 && xp != r.r_iw;
    int32_t fin_pos = -1, fin_ow = -1;
    if (valid) walk(t, r, xs, p, __ldg(r.init + b * M + p), &fin_pos, &fin_ow);
    wp::emit_row(a, M, p, active, xp, valid, r.l_iw, fin_pos, fin_ow, skip,
                 vis, buf, r.out + b * (M + 2));
}

__global__ void wp_subword_dense_kernel(Dense t, Row r, wp::Actions a) {
    wp_subword_row(t, r, a);
}

__global__ void wp_subword_comb_kernel(Comb t, Row r, wp::Actions a) {
    wp_subword_row(t, r, a);
}

template <class T>
int launch(void (*kernel)(T, Row, wp::Actions), const T& t, const Row& r,
           const wp::Actions& a, int B, cudaStream_t s) {
    if (B <= 0) return 0;
    const int threads = (r.M + 31) / 32 * 32;
    const size_t shm = sizeof(int32_t) * (size_t)(3 * r.M + r.lw + 1 + 32);
    kernel<<<(unsigned)B, threads, shm, s>>>(t, r, a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bf_wp_subword_dense(
    const int32_t* dnext, int64_t n_dnext, const int32_t* ow_perm, int n_ow,
    int n_f, int n_a, const int32_t* act_right, const int32_t* act_tag,
    const int32_t* act_fn, int n_acts, const int32_t* x, const int32_t* init,
    int B, int M, int l_iw, int r_iw, int lw, int max_tok, int32_t* out,
    void* stream) {
    const Dense t{dnext, n_dnext - 1, ow_perm, n_ow, n_f, n_a};
    const Row r{x, init, M, l_iw, r_iw, lw, max_tok, out};
    const wp::Actions a{act_right, act_tag, act_fn, n_acts};
    return launch(wp_subword_dense_kernel, t, r, a, B, (cudaStream_t)stream);
}

extern "C" int bf_wp_subword_comb(
    const int32_t* base, const int32_t* owner, const int32_t* nxt,
    const uint8_t* final_, const int32_t* moore_ow, int n_states, int n_slots,
    const int32_t* act_right, const int32_t* act_tag, const int32_t* act_fn,
    int n_acts, const int32_t* x, const int32_t* init, int B, int M, int l_iw,
    int r_iw, int lw, int max_tok, int32_t* out, void* stream) {
    const Comb t{base, owner, nxt, final_, moore_ow, n_states, n_slots};
    const Row r{x, init, M, l_iw, r_iw, lw, max_tok, out};
    const wp::Actions a{act_right, act_tag, act_fn, n_acts};
    return launch(wp_subword_comb_kernel, t, r, a, B, (cudaStream_t)stream);
}
