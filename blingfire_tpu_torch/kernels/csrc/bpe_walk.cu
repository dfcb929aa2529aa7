// K1 bpe_walk: the lockstep vocabulary walk of byte- and char-BPE.
//
// Replaces blingfire_tpu/ops/bpe.py::_walk_impl (bpe.py:242, jit at :793) in
// its two table modes and its rank mode.  One thread per (row b, start p)
// walks up to LW symbols and writes m_pack[d, b, p] (id in bits 0..19, bit 27
// when the symbol after the match is ▁ or the end of the row), coalesced
// along p, and slot_overflow[b, p] (a live state after the last step, only
// when the caller asks: unbounded rows whose vocabulary is deeper than LW).
// is_spm is derived here as x == spm_iw (the fold of dedup derive_spm).
//
//   trie mode (COMB false)  one gather a step, next = trie[state * A + c]; a
//                           node below V is final with token id == node.
//   comb mode (COMB true)   the minimal automaton's comb table: base[s],
//                           then owner[slot] == s is a hit, then nxt/ow; the
//                           Ow sum picks the id (ids_tab) at a final state.
//                           No transition when base[s] + c lies outside the
//                           table: JAX clamps that probe (bpe.py:307) and so
//                           false-hits below slot 0 (ROADMAP.md section C).
//   rank mode (RANK true)   m_rank[d, b, p] = the match's rank: rank_by_id[id]
//                           (trie) or ranks_tab[Ow sum] (comb), 0 where no
//                           match ends (bpe.py:319-324).
//
// Bound: the table gathers.  Each live lane-step reads one (trie) or two to
// four (comb) int32 at data-dependent addresses, so the kernel is bound by
// memory latency and bytes, not by arithmetic.  A gpt2-sized trie is larger
// than L2; a comb table is about 0.5 MB and stays in L2.  The design keeps
// the row's symbols in L1 (the threads of a row read overlapping windows of
// x), reads the tables through the read-only path (__ldg), and stops
// gathering once a lane's state is dead.  Every gather index is clamped
// explicitly, as XLA clamps its gathers: CUDA would read out of bounds.
//
// In trie mode a step is one dependent gather.  Measured on the H100
// (kernels/phase_split.py), a step costs about 0.2-0.33 us of device
// time beyond its m_pack plane's write: an L2-latency chain (the trie's
// touched lines stay in L2 from launch to launch), not a DRAM one, so the
// dense trie stays.  The symbols ride a window loaded a step ahead (one
// load a step, off the chain, where there were two on it).

#include "common.cuh"

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t hi) {
    return v < 0 ? 0 : (v > hi ? hi : v);
}

template <bool COMB, bool RANK>
__global__ void bpe_walk_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ trie, int64_t size,
    const int32_t* __restrict__ base, const int32_t* __restrict__ owner,
    const int32_t* __restrict__ nxt, const int32_t* __restrict__ ow,
    const uint8_t* __restrict__ final_, const int32_t* __restrict__ ids_tab,
    const float* __restrict__ ranks_tab, const float* __restrict__ rank_by_id,
    int n_states, int n_slots, int nkeys, int B, int N, int LW, int A, int V,
    int root, int spm_iw, int overflow, int32_t* __restrict__ m_pack,
    float* __restrict__ m_rank, uint8_t* __restrict__ slot_overflow) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)B * N) return;
    const int b = (int)(i / N), p = (int)(i % N);
    const int32_t* xr = x + (int64_t)b * N;
    const int len = lengths[b];
    // a window of the row's symbols, c = x[q] and c1 = x[q + 1], loaded a
    // step ahead: no symbol load on the chain of gathers
    int32_t c = xr[p];
    int32_t c1 = p + 1 < N ? __ldg(xr + p + 1) : -1;
    int32_t state = (p < len && c >= 0) ? (COMB ? 0 : root) : -1;
    int32_t sum_ow = 0;
    for (int d = 0; d < LW; ++d) {
        const int q = p + d;
        const int32_t c2 = q + 2 < N ? __ldg(xr + q + 2) : -1;
        int32_t ns = -1, id = -1;
        float rank = 0.0f;
        if (state >= 0 && c >= 0) {
            if (COMB) {
                const int s = state < n_states ? state : n_states - 1;
                const int64_t slot = (int64_t)__ldg(base + s) + c;
                if (slot >= 0 && slot < n_slots && __ldg(owner + slot) == state) {
                    ns = __ldg(nxt + slot);
                    sum_ow += __ldg(ow + slot);
                    if (ns >= 0 &&
                        __ldg(final_ + (ns < n_states ? ns : n_states - 1))) {
                        const int key = (int)clamp64(sum_ow, nkeys - 1);
                        id = __ldg(ids_tab + key);
                        if (RANK) rank = __ldg(ranks_tab + key);
                    }
                }
            } else {
                ns = __ldg(trie + clamp64((int64_t)state * A + c, size - 1));
                if (ns >= 0 && ns < V) {
                    id = ns;
                    if (RANK) rank = __ldg(rank_by_id + ns);
                }
            }
        }
        // spm_iw >= 0 (the wrapper checks it), so padding (-1) is never ▁
        const int nxt_spm = (q + 1 >= len || c1 == spm_iw) ? 1 : 0;
        const int64_t o = ((int64_t)d * B + b) * N + p;
        m_pack[o] = id >= 0 ? (id | (nxt_spm << 27)) : -1;
        if (RANK) m_rank[o] = id >= 0 ? rank : 0.0f;
        state = ns;
        c = c1;
        c1 = c2;
    }
    slot_overflow[i] = (overflow && state >= 0) ? 1 : 0;
}

template <bool COMB, bool RANK>
static int launch(const int32_t* x, const int32_t* lengths, const int32_t* trie,
                  int64_t size, const int32_t* base, const int32_t* owner,
                  const int32_t* nxt, const int32_t* ow, const uint8_t* final_,
                  const int32_t* ids_tab, const float* ranks_tab,
                  const float* rank_by_id, int n_states, int n_slots, int nkeys,
                  int B, int N, int LW, int A, int V, int root, int spm_iw,
                  int overflow, int32_t* m_pack, float* m_rank,
                  uint8_t* slot_overflow, cudaStream_t stream) {
    const int threads = 256;
    const int64_t total = (int64_t)B * N;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    bpe_walk_kernel<COMB, RANK><<<blocks, threads, 0, stream>>>(
        x, lengths, trie, size, base, owner, nxt, ow, final_, ids_tab,
        ranks_tab, rank_by_id, n_states, n_slots, nkeys, B, N, LW, A, V, root,
        spm_iw, overflow, m_pack, m_rank, slot_overflow);
    return (int)cudaGetLastError();
}

// trie == NULL selects comb mode; m_rank == NULL leaves rank mode off (in
// trie mode rank mode needs rank_by_id)
extern "C" int bf_bpe_walk(const int32_t* x, const int32_t* lengths,
                           const int32_t* trie, int64_t size,
                           const int32_t* base, const int32_t* owner,
                           const int32_t* nxt, const int32_t* ow,
                           const uint8_t* final_, const int32_t* ids_tab,
                           const float* ranks_tab, const float* rank_by_id,
                           int n_states, int n_slots, int nkeys, int B, int N,
                           int LW, int A, int V, int root, int spm_iw,
                           int overflow, int32_t* m_pack, float* m_rank,
                           uint8_t* slot_overflow, void* stream) {
    const bool comb = trie == nullptr, rank = m_rank != nullptr;
    if ((comb && (n_states < 1 || n_slots < 1 || nkeys < 1)) ||
        (!comb && (size < 1 || (rank && rank_by_id == nullptr))))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define BF_WALK(C, R)                                                          \
    launch<C, R>(x, lengths, trie, size, base, owner, nxt, ow, final_, ids_tab, \
                 ranks_tab, rank_by_id, n_states, n_slots, nkeys, B, N, LW, A, \
                 V, root, spm_iw, overflow, m_pack, m_rank, slot_overflow, s)
    if (comb) return rank ? BF_WALK(true, true) : BF_WALK(true, false);
    return rank ? BF_WALK(false, true) : BF_WALK(false, false);
#undef BF_WALK
}
