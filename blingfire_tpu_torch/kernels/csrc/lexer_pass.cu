// K9 lexer_pass: the pattern lexer's pass over rows of spans,
// [L_ANCHOR c1 .. cn R_ANCHOR -1 ...], each row walked from its own initial
// state (a grammar function).  Replaces blingfire_tpu/ops/lexer.py::lexer_pass
// (lexer.py:93-176) and the concatenation of its five outputs,
// runtime/lexer_host.py::_pack5 (lexer_host.py:29-41): the block writes
// visited | tag | from2 | to2 | fn as one (B, 5M) int32 row.
//
// One block a row, one thread a start position (a thread takes positions
// p, p + blockDim.x, ... when M exceeds the block).  The row sits in shared
// memory.  A start before the R anchor walks the comb table at most
// max_token_length + 1 steps: the exact lookup, then the IW_ANY lookup for a
// real symbol its state has no slot for; past max_token_length only the R
// anchor may be consumed (lexer.py:126-133).  A thread stops at its first dead state, where
// the JAX while loop runs on until every lane of the batch is dead: a dead
// lane stays dead, so the planes are the same.  The deepest final gives the
// match's end and Moore Ow; the action gathers clamp at both ends, as XLA's
// gather does (lexer.py:152-154 guard only the lower end).
//
// A comb lookup takes no transition when base[s] + c falls outside
// [0, n_slots).  JAX clamps that slot (lexer.py:115) and so, from the state
// that owns slot 0, takes slot 0's transition for a symbol below its lowest
// one: a transition the automaton does not have.  An explicitly DEAD
// transition (a slot s owns with nxt -1) ends the walk: the reference's
// GetDest gives -2 for it and only -1 falls back to IW_ANY; JAX falls back
// on both (lexer.py:131).  The state the L-anchor start reaches on the
// anchor alone is no match: the reference tests finality only after a
// character or the R anchor, JAX at every step (lexer.py:134).  ROADMAP.md
// section C has these faults.
//
// The FromPos skip scan is a sequential recurrence (nv == q -> nv = skip[q]
// + 2); skip[q] >= q - 1, so nv only grows and the visited starts are
// nv = 0, skip[0] + 2, ...: thread 0 follows that chain through the skip
// targets the threads leave in shared memory, one step a visited start.
//
// Bound: bytes.  The rows (x: 4 B a lane, init and ext_len: 8 B a row) in,
// 20 B a lane out, and each table entry the walk and the action lookups
// read, once; the shipped models' tables (4,286 and 102,440 slots) sit in
// L2.  The walks of a row's starts differ in length, so the threads of a
// warp wait for its longest.

#include "common.cuh"

namespace {

constexpr int kPlanes = 5;
constexpr int kMaxThreads = 256;

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
    const int32_t* act_right;
    const int32_t* act_tag;
    const int32_t* act_fn;  // -1: no function call
    int n_acts;             // >= 1
    int32_t any_iw;         // dense id of IW_ANY, -1 when absent
    int max_tok;
};

// the transition of live state s on symbol c >= 0: -1 when s has no slot
// for c, -2 when its slot holds an explicitly DEAD transition (nxt -1)
__device__ __forceinline__ int32_t lookup(const Tables& t, int32_t s,
                                          int32_t c) {
    const int64_t raw =
        (int64_t)__ldg(t.base + clamp64(s, 0, t.n_states - 1)) + c;
    if (raw < 0 || raw >= t.n_slots || __ldg(t.owner + raw) != s) return -1;
    const int32_t ns = __ldg(t.nxt + raw);
    return ns >= 0 ? ns : -2;
}

__global__ void lexer_pass_kernel(Tables t, const int32_t* __restrict__ x,
                                  const int32_t* __restrict__ init,
                                  const int32_t* __restrict__ ext_len, int M,
                                  int32_t* __restrict__ out) {
    extern __shared__ int32_t smem[];
    int32_t* xs = smem;                              // M: the row
    int32_t* skip = xs + M;                          // M: skip targets
    uint8_t* flag = reinterpret_cast<uint8_t*>(skip + M);  // M
    const int64_t b = blockIdx.x;
    const int32_t* xrow = x + b * M;
    for (int i = threadIdx.x; i < M; i += blockDim.x) xs[i] = xrow[i];
    __syncthreads();

    const int32_t r_pos = ext_len[b] - 1;  // ext index of the R anchor
    const int32_t hi = r_pos - 2 > 0 ? r_pos - 2 : 0;  // max(in_size - 1, 0)
    const int32_t ini = init[b];
    const int steps = t.max_tok + 1;
    int32_t* o_vis = out + b * kPlanes * M;
    int32_t* o_tag = o_vis + M;
    int32_t* o_from = o_tag + M;
    int32_t* o_to = o_from + M;
    int32_t* o_fn = o_to + M;
    for (int p = threadIdx.x; p < M; p += blockDim.x) {
        const bool valid = p < r_pos;
        int32_t fin_pos = -1, fin_ow = -1;
        int32_t state = valid ? ini : -1;
        for (int d = 0; d < steps && state >= 0; ++d) {
            const int q = p + d;
            const int32_t c = q < M ? xs[q] : -1;
            int32_t ns = -1;
            if (c >= 0 && (d < t.max_tok || q == r_pos)) {
                ns = lookup(t, state, c);
                if (ns == -1 && t.any_iw >= 0) ns = lookup(t, state, t.any_iw);
                if (ns < 0) ns = -1;
            }
            if (ns >= 0 && q > 0) {  // q == 0: the L anchor alone
                const int64_t s = clamp64(ns, 0, t.n_states - 1);
                if (__ldg(t.final_ + s)) {
                    fin_pos = q;
                    fin_ow = __ldg(t.moore_ow + s);
                }
            }
            state = ns;
        }
        const int64_t o = clamp64(fin_ow, 0, t.n_acts - 1);
        const int32_t right = __ldg(t.act_right + o);
        const int32_t from_orig = p - 1;  // the L-anchor start is FromPos -1
        const int32_t reach = fin_pos - 1 - right;
        const bool has = fin_pos >= 0;
        o_tag[p] = fin_ow >= 0 ? __ldg(t.act_tag + o) : 0;
        o_fn[p] = fin_ow >= 0 ? __ldg(t.act_fn + o) : -1;
        o_from[p] = (int32_t)clamp64(from_orig, 0, hi);
        o_to[p] = (int32_t)clamp64(reach, 0, hi);
        skip[p] = has && reach > from_orig ? reach : from_orig;
        flag[p] = valid && has ? 1 : 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int nv = 0; nv < M; nv = skip[nv] + 2) flag[nv] |= 2;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < M; p += blockDim.x) o_vis[p] = flag[p] == 3;
}

}  // namespace

extern "C" int bf_lexer_pass(
    const int32_t* base, const int32_t* owner, const int32_t* nxt,
    const uint8_t* final_, const int32_t* moore_ow, int n_states, int n_slots,
    const int32_t* act_right, const int32_t* act_tag, const int32_t* act_fn,
    int n_acts, int any_iw, int max_tok, const int32_t* x, const int32_t* init,
    const int32_t* ext_len, int B, int M, int32_t* out, void* stream) {
    if (B <= 0) return 0;
    if (M <= 0 || n_acts <= 0 || n_states <= 0) return (int)cudaErrorInvalidValue;
    const Tables t{base,      owner,   nxt,    final_, moore_ow, n_states, n_slots,
                   act_right, act_tag, act_fn, n_acts, any_iw,   max_tok};
    const int threads = M < kMaxThreads ? (M + 31) / 32 * 32 : kMaxThreads;
    const size_t shm = (size_t)M * (2 * sizeof(int32_t) + 1);
    if (shm > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lexer_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)shm);
        if (e != cudaSuccess) return (int)e;
    }
    lexer_pass_kernel<<<(unsigned)B, threads, shm, (cudaStream_t)stream>>>(
        t, x, init, ext_len, M, out);
    return (int)cudaGetLastError();
}
