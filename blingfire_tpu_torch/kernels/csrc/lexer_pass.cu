// K9 lexer_pass: the pattern lexer's pass over rows of spans,
// [L_ANCHOR c1 .. cn R_ANCHOR -1 ...], each row walked from its own initial
// state (a grammar function).  Replaces blingfire_tpu/ops/lexer.py::lexer_pass
// (lexer.py:93-176) and the concatenation of its five outputs,
// runtime/lexer_host.py::_pack5 (lexer_host.py:29-41): a row's planes
// visited | tag | from2 | to2 | fn are written as one (B, 5M) int32 row.
//
// A block takes a row, one thread a start position (a thread takes
// positions p, p + blockDim.x, ... when M exceeds the block); the row sits
// in shared memory.  A start before the R anchor walks the comb table
// at most max_token_length + 1 steps: the exact lookup, then the IW_ANY
// lookup for a real symbol its state has no slot for; past max_token_length
// only the R anchor may be consumed (lexer.py:126-133).  A thread stops at
// its first dead state, where the JAX while loop runs on until every lane of
// the batch is dead: a dead lane stays dead, so the planes are the same.
// The deepest final gives the match's end and Moore Ow; the action gathers
// clamp at both ends, as XLA's gather does (lexer.py:152-154 guard only the
// lower end).
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
// Tables, packed by ops/lexer.py::make_device_tables: a state's record
// (base, final, moore_ow) is one 16-byte load and a slot's (owner, nxt) one
// 8-byte load, both read through __ldg (L1, then L2).  The exact and the
// IW_ANY probe both hang on base[s] alone, so both slot loads are issued
// together: a step is two dependent loads (the slots, then the next state's
// record), where it was up to six.  Staging a table that fits (wbd's,
// 36 KB) into shared memory measured no faster than L1 at any width
// (kernels/phase_split.py; PERF.md), so the records stay in global memory.
//
// The FromPos skip scan is a sequential recurrence (nv == q -> nv = skip[q]
// + 2, FALexTools_t.h:229-397); f(p) = skip[p] + 2 >= p + 1, so the visited
// starts are the chain 0, f(0), f(f(0)), ...  One thread following it one
// dependent step a start took most of the cycles of a long row.  The chain
// stops at the R anchor (no lane at or past it is valid) and is found by
// pointer doubling: in round k every marked start marks J_k(p), then
// J_{k+1} = J_k(J_k), with jumps to the R anchor or past it saturated;
// after ceil(log2(r_pos)) rounds the marks are exactly the chain (a race
// only marks a chain start a round early), and the rounds stop as soon as
// J_k(0) reaches the R anchor.  ops/lexer.py::visited_chain is the same
// rounds in PyTorch.
//
// Bound: bytes.  The rows (x: 4 B a lane, init and ext_len: 8 B a row) in,
// 20 B a lane out, and each table entry the walk and the action lookups
// read, once.  What bounds the kernel now is the walk's chain of dependent
// table loads (two a step) and, on long rows, the threads of a warp waiting
// for their longest walk.

#include "common.cuh"

namespace {

constexpr int kPlanes = 5;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

struct Tables {
    const int4* state_rec;  // (base, final, moore_ow, 0) a state
    const int2* slot_rec;   // (owner, nxt) a slot
    int n_states;
    int n_slots;
    const int32_t* act_right;
    const int32_t* act_tag;
    const int32_t* act_fn;  // -1: no function call
    int n_acts;             // >= 1
    int32_t any_iw;         // dense id of IW_ANY, -1 when absent
    int max_tok;
};

__global__ void __launch_bounds__(kMaxThreads)
    lexer_pass_kernel(Tables t, const int32_t* __restrict__ x,
                      const int32_t* __restrict__ init,
                      const int32_t* __restrict__ ext_len, int M,
                      int32_t* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    int32_t* xs = reinterpret_cast<int32_t*>(smem);  // M: the row
    int32_t* ja = xs + M;  // M: jumps f(p), then the doubling's even rounds
    int32_t* jb = xs;      // the odd rounds, over the row once walked
    uint8_t* flag = reinterpret_cast<uint8_t*>(ja + M);  // bit 0 has, 1 visited
    const int steps = t.max_tok + 1;
    const uint32_t n_slots = (uint32_t)t.n_slots;
    const int32_t s_max = t.n_states - 1;
    const bool has_any = t.any_iw >= 0;
    const int64_t b = blockIdx.x;
    // ---- LOAD
    const int32_t* xrow = x + b * M;
#pragma unroll 4
    for (int i = threadIdx.x; i < M; i += blockDim.x) xs[i] = __ldg(xrow + i);
    const int32_t r_pos = ext_len[b] - 1;  // ext index of the R anchor
    const int32_t hi = r_pos - 2 > 0 ? r_pos - 2 : 0;  // max(in_size - 1, 0)
    const int32_t ini = init[b];
    int32_t* o_vis = out + b * kPlanes * M;
    int32_t* o_tag = o_vis + M;
    int32_t* o_from = o_tag + M;
    int32_t* o_to = o_from + M;
    int32_t* o_fn = o_to + M;
    __syncthreads();
    // ---- WALK
    for (int p = threadIdx.x; p < M; p += blockDim.x) {
        const bool valid = p < r_pos;
        int32_t fin_pos = -1, fin_ow = -1;
        int32_t state = valid ? ini : -1;
        int4 rec = make_int4(0, 0, -1, 0);
        if (valid)
            rec = __ldg(t.state_rec + (ini < 0 ? 0 : (ini > s_max ? s_max : ini)));
        for (int d = 0; d < steps && state >= 0; ++d) {
            const int q = p + d;
            const int32_t c = q < M ? xs[q] : -1;
            int32_t ns = -1;
            if (c >= 0 && (d < t.max_tok || q == r_pos)) {
                // both probes hang on base[s] alone: load both slots
                // (base + c below 0 wraps past n_slots: no transition)
                const uint32_t raw = (uint32_t)(rec.x + c);
                const uint32_t raw_any = (uint32_t)(rec.x + t.any_iw);
                const bool in = raw < n_slots;
                const bool in_any = has_any && raw_any < n_slots;
                const int2 e = __ldg(t.slot_rec + (in ? raw : 0u));
                const int2 a = __ldg(t.slot_rec + (in_any ? raw_any : 0u));
                if (in && e.x == state) ns = e.y >= 0 ? e.y : -2;
                if (ns == -1 && in_any && a.x == state) ns = a.y;
                if (ns < 0) ns = -1;
            }
            if (ns >= 0) {
                rec = __ldg(t.state_rec + (ns > s_max ? s_max : ns));
                if (q > 0 && rec.y) {  // q == 0: the L anchor alone
                    fin_pos = q;
                    fin_ow = rec.z;
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
        ja[p] = (has && reach > from_orig ? reach : from_orig) + 2;
        flag[p] = (valid && has ? 1 : 0) | (p == 0 && valid ? 2 : 0);
    }
    __syncthreads();
    // ---- CHAIN
    // the chain's starts lie below the R anchor and the row's end (an
    // ext_len past the row walks no further than its last lane)
    const int32_t lim = r_pos < M ? r_pos : M;
    const int rounds = lim > 1 ? 32 - __clz(lim - 1) : 0;
    for (int k = 0; k < rounds; ++k) {
        const int32_t* src = (k & 1) ? jb : ja;
        int32_t* dst = (k & 1) ? ja : jb;
        const bool last = k + 1 == rounds;
        for (int p = threadIdx.x; p < lim; p += blockDim.x) {
            const int32_t j = src[p];
            if (j < lim) {
                if (flag[p] & 2) flag[j] |= 2;
                if (!last) dst[p] = src[j];
            } else if (!last) {
                dst[p] = j;
            }
        }
        __syncthreads();
        // the marks hold f^i(0) for i < 2^(k+1); the chain is whole once
        // f^(2^(k+1))(0) = J_{k+1}(0) lies at the R anchor or past it
        if (!last && dst[0] >= lim) break;
    }
    // ---- WRITE
    for (int p = threadIdx.x; p < M; p += blockDim.x)
        o_vis[p] = flag[p] == 3;
}

}  // namespace

extern "C" int bf_lexer_pass(const int32_t* state_rec, const int32_t* slot_rec,
                             int n_states, int n_slots,
                             const int32_t* act_right, const int32_t* act_tag,
                             const int32_t* act_fn, int n_acts, int any_iw,
                             int max_tok, const int32_t* x, const int32_t* init,
                             const int32_t* ext_len, int B, int M,
                             int32_t* out, void* stream) {
    if (B <= 0) return 0;
    if (M <= 0 || n_acts <= 0 || n_states <= 0 || n_slots <= 0)
        return (int)cudaErrorInvalidValue;
    const Tables t{reinterpret_cast<const int4*>(state_rec),
                   reinterpret_cast<const int2*>(slot_rec),
                   n_states, n_slots, act_right, act_tag, act_fn, n_acts,
                   any_iw, max_tok};
    // the row, the jumps and the flags: 9 bytes a lane
    const size_t shm = (size_t)M * (2 * sizeof(int32_t) + 1);
    if (shm > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lexer_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)shm);
        if (e != cudaSuccess) return (int)e;
    }
    const int threads = M < kMaxThreads ? (M + 31) / 32 * 32 : kMaxThreads;
    lexer_pass_kernel<<<(unsigned)B, threads, shm, (cudaStream_t)stream>>>(
        t, x, init, ext_len, M, out);
    return (int)cudaGetLastError();
}
