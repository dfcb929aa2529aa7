// K5 unigram_walk: the lockstep vocabulary walk of the unigram LM.
//
// Replaces the WALK of blingfire_tpu/ops/unigram.py::unigram_segment
// (unigram.py:164-213).  One thread per (row b, start p) walks up to L
// symbols; the table mode is a template parameter:
//   dense  one gather per live step: dense[state * A + c] packs
//          (ow << 16) | ((next + 1) << 1) | final;
//   wide   three: base[state], then wide_a and wide_b at the same slot;
//   comb   five: base, owner, nxt, ow, final.
// A score gather happens only at a final.  The thread writes m_key and
// m_score for every depth of its start, (B, N, L) by (start, depth), so the
// output equals the plain version's lane for lane; after a lane's state dies
// it writes the empty value without touching the tables.
//
// Every gather keeps the clamp XLA applies silently (unigram.py:176-180,
// 187-188, 199-200, 205-206): CUDA would read out of bounds instead; but a
// comb or wide slot outside [0, n_slots) is no transition, not clamped.  A
// dead state's base is negative (ops/tables.py:116), and so is that of the
// state placed first when its lowest symbol is above 0: JAX's clamp takes
// slot 0's transition from that state, which owns slot 0, and the automaton
// has no such transition (ROADMAP.md section C).  Like the JAX walk it
// reads x past the row's length after the first step; only the start is
// masked.
//
// Bound: bytes.  The B*N*L*8 bytes of output plus the table gathers of the
// live lane-steps; the tables are small enough to sit in L2 (a 32k-entry
// dense table is tens of MB), so the gathers mostly hit there.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr float kNegInf = -FLT_MAX;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

struct Tables {
    const int32_t* dense;
    int64_t dense_size;
    const int32_t* base;
    const int32_t* owner;
    const int32_t* nxt;
    const int32_t* ow;
    const uint8_t* final_;
    const int32_t* wide_a;
    const int32_t* wide_b;
    int n_slots;
    int n_states;
    const float* scores;
    int nkeys;
    int A;
};

// one transition from a live state on a symbol c >= 0:
// returns the next state (-1 = none) and sets *ow_add and *fin
template <int MODE>
__device__ __forceinline__ int32_t step(const Tables& t, int32_t state,
                                        int32_t c, int32_t* ow_add, bool* fin) {
    if constexpr (MODE == 0) {
        const int64_t flat =
            clamp64((int64_t)state * t.A + c, 0, t.dense_size - 1);
        const int32_t e = __ldg(t.dense + flat);
        *ow_add = e != 0 ? (e >> 16) : 0;
        *fin = (e & 1) == 1;
        return ((e >> 1) & 0x7FFF) - 1;
    }
    const int32_t bs = __ldg(t.base + clamp64(state, 0, t.n_states - 1));
    const int64_t slot = (int64_t)bs + c;
    if (slot < 0 || slot >= t.n_slots) {  // no transition outside the slots
        *ow_add = 0;
        *fin = false;
        return -1;
    }
    if constexpr (MODE == 1) {
        const int32_t ea = __ldg(t.wide_a + slot);
        if ((ea & 0x1FFFF) != state) {
            *ow_add = 0;
            *fin = false;
            return -1;
        }
        const int32_t eb = __ldg(t.wide_b + slot);
        *ow_add = ((ea >> 18) & 0x3FFF) | ((eb >> 17) << 14);
        *fin = ((ea >> 17) & 1) == 1;
        return (eb & 0x1FFFF) - 1;
    }
    if (__ldg(t.owner + slot) != state) {
        *ow_add = 0;
        *fin = false;
        return -1;
    }
    const int32_t ns = __ldg(t.nxt + slot);
    *ow_add = __ldg(t.ow + slot);
    *fin = ns >= 0 && __ldg(t.final_ + clamp64(ns, 0, t.n_states - 1)) != 0;
    return ns;
}

template <int MODE>
__global__ void unigram_walk_kernel(const int32_t* __restrict__ x,
                                    const int32_t* __restrict__ lengths,
                                    Tables t, int B, int N, int L,
                                    int32_t* __restrict__ m_key,
                                    float* __restrict__ m_score) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)B * N) return;
    const int b = (int)(i / N), p = (int)(i % N);
    const int32_t* xr = x + (int64_t)b * N;
    int32_t* kout = m_key + i * L;
    float* sout = m_score + i * L;
    int32_t state = (p < lengths[b] && xr[p] >= 0) ? 0 : -1;
    uint32_t sum_ow = 0;  // int32 wrap-around, as XLA adds
    for (int d = 0; d < L; ++d) {
        const int q = p + d;
        const int32_t c = q < N ? xr[q] : -1;
        int32_t key = -1;
        float score = kNegInf;
        if (state >= 0 && c >= 0) {
            int32_t ow_add;
            bool fin;
            state = step<MODE>(t, state, c, &ow_add, &fin);
            sum_ow += (uint32_t)ow_add;
            if (fin) {
                const int32_t k = (int32_t)clamp64((int32_t)sum_ow, 0, t.nkeys - 1);
                key = k;
                score = __ldg(t.scores + k);
            }
        } else {
            state = -1;
        }
        kout[d] = key;
        sout[d] = score;
    }
}

}  // namespace

extern "C" int bf_unigram_walk(
    const int32_t* x, const int32_t* lengths, int mode, const int32_t* dense,
    int64_t dense_size, const int32_t* base, const int32_t* owner,
    const int32_t* nxt, const int32_t* ow, const uint8_t* final_,
    const int32_t* wide_a, const int32_t* wide_b, int n_slots, int n_states,
    const float* scores, int nkeys, int B, int N, int L, int A,
    int32_t* m_key, float* m_score, void* stream) {
    const Tables t{dense, dense_size, base, owner, nxt, ow, final_,
                   wide_a, wide_b, n_slots, n_states, scores, nkeys, A};
    const int threads = 128;
    const int64_t total = (int64_t)B * N;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (mode == 0) {
        unigram_walk_kernel<0><<<blocks, threads, 0, s>>>(x, lengths, t, B, N,
                                                          L, m_key, m_score);
    } else if (mode == 1) {
        unigram_walk_kernel<1><<<blocks, threads, 0, s>>>(x, lengths, t, B, N,
                                                          L, m_key, m_score);
    } else if (mode == 2) {
        unigram_walk_kernel<2><<<blocks, threads, 0, s>>>(x, lengths, t, B, N,
                                                          L, m_key, m_score);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
