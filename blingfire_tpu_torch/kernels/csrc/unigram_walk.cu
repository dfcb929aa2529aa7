// K5 unigram_walk: the lockstep vocabulary walk of the unigram LM.
//
// Replaces the WALK of blingfire_tpu/ops/unigram.py::unigram_segment
// (unigram.py:164-213).  Every (row b, start p) walks up to L symbols and
// records the Mealy key and score of each final by (start, depth): m_key
// and m_score are (B, N, L), the layout K6 reads.  The table mode is a
// template parameter:
//   dense  one gather per live step: dense[state * A + c] packs
//          (ow << 16) | ((next + 1) << 1) | final;
//   wide   three: base[state], then wide_a and wide_b at the same slot;
//   comb   five: base, owner, nxt, ow, final.
// A score gather happens only at a final.
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
// Bound: bytes, the B*N*L*8 bytes of output above all (the tables sit in
// L2).  So a block takes a tile of T starts of one row and walks it in
// chunks of up to D depths: the row's symbols for the chunk are loaded
// into shared memory once, each lane walks until its state dies (then
// stops stepping), the chunk's keys and scores are staged in shared
// memory by depth, and the block writes the tile's span of m_key and
// m_score with coalesced 16-byte stores (4-byte ones where the span is
// not 16-byte aligned).  Once every lane of a tile is dead, its remaining
// depths are written as the empty value without stepping.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr float kNegInf = -FLT_MAX;
constexpr int T = 128;       // starts a tile: the block's threads
constexpr int D = 32;        // depths a chunk, at most
constexpr int SP = T + 1;    // pitch of a staged depth: no bank conflicts

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

// Writes a tile's chunk: start r < nr, depth column k < w, to gk and gs
// (the score's bits) at r * L + k, from the staged columns sk and ss
// (entry k * SP + r) or, when sk is null, the empty value.  Threads take
// consecutive 16-byte vectors of the chunk's span when it is contiguous
// (w == L) or made of rows of whole vectors, and it is 16-byte aligned;
// else consecutive words.
__device__ __forceinline__ void put(int32_t* __restrict__ gk,
                                    int32_t* __restrict__ gs, int L, int nr,
                                    int w, const int32_t* sk,
                                    const int32_t* ss) {
    const int32_t empty_s = __float_as_int(kNegInf);
    const int n = nr * w;
    const bool vec = (((uintptr_t)gk | (uintptr_t)gs) & 15) == 0 &&
                     (w == L || (L % 4 == 0 && w % 4 == 0));
    const int nv = vec ? n / 4 : 0;
    for (int v = threadIdx.x; v < nv; v += T) {
        int r = 4 * v / w, k = 4 * v - r * w;
        const int64_t off = (int64_t)r * L + k;
        int32_t ka[4], sa[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            ka[u] = sk ? sk[k * SP + r] : -1;
            sa[u] = sk ? ss[k * SP + r] : empty_s;
            if (++k == w) {
                k = 0;
                ++r;
            }
        }
        *reinterpret_cast<int4*>(gk + off) = make_int4(ka[0], ka[1], ka[2], ka[3]);
        *reinterpret_cast<int4*>(gs + off) = make_int4(sa[0], sa[1], sa[2], sa[3]);
    }
    for (int e = 4 * nv + threadIdx.x; e < n; e += T) {
        const int r = e / w, k = e - r * w;
        const int64_t off = (int64_t)r * L + k;
        gk[off] = sk ? sk[k * SP + r] : -1;
        gs[off] = sk ? ss[k * SP + r] : empty_s;
    }
}

// grid: B * tiles blocks of T threads, block i = tile (i % tiles) of row
// (i / tiles); dynamic shared memory: T + D symbols, then two staged
// chunks of min(L, D) depths
template <int MODE>
__global__ void __launch_bounds__(T)
unigram_walk_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ lengths, Tables t, int N,
                    int L, int tiles, int32_t* __restrict__ m_key,
                    int32_t* __restrict__ m_score) {
    extern __shared__ int32_t smem[];
    int32_t* xs = smem;          // T + D: the chunk's symbols
    int32_t* sk = xs + T + D;    // min(L, D) * SP keys, by depth
    int32_t* ss = sk + min(L, D) * SP;  // and the scores' bits
    const int b = (int)(blockIdx.x / tiles);
    const int p0 = (int)(blockIdx.x % tiles) * T;
    const int tid = threadIdx.x;
    const int nr = min(T, N - p0);
    const int32_t* xr = x + (int64_t)b * N;
    const int64_t base = ((int64_t)b * N + p0) * L;
    int32_t state =
        (tid < nr && p0 + tid < lengths[b] && xr[p0 + tid] >= 0) ? 0 : -1;
    uint32_t sum_ow = 0;  // int32 wrap-around, as XLA adds
    for (int d0 = 0; d0 < L; d0 += D) {
        const int w = min(D, L - d0);
        if (!__syncthreads_or(state >= 0)) {
            // every lane is dead: the empty value at every depth left
            put(m_key + base + d0, m_score + base + d0, L, nr, L - d0,
                nullptr, nullptr);
            return;
        }
        for (int i = tid; i < T + w; i += T) {
            const int q = p0 + d0 + i;
            xs[i] = q < N ? xr[q] : -1;
        }
        __syncthreads();
        int j = 0;
        for (; j < w && state >= 0; ++j) {
            const int32_t c = xs[tid + j];
            int32_t key = -1;
            float score = kNegInf;
            if (c >= 0) {
                int32_t ow_add;
                bool fin;
                state = step<MODE>(t, state, c, &ow_add, &fin);
                sum_ow += (uint32_t)ow_add;
                if (fin) {
                    key = (int32_t)clamp64((int32_t)sum_ow, 0, t.nkeys - 1);
                    score = __ldg(t.scores + key);
                }
            } else {
                state = -1;
            }
            sk[j * SP + tid] = key;
            ss[j * SP + tid] = __float_as_int(score);
        }
        for (; j < w; ++j) {  // the lane died: no more steps
            sk[j * SP + tid] = -1;
            ss[j * SP + tid] = __float_as_int(kNegInf);
        }
        __syncthreads();
        put(m_key + base + d0, m_score + base + d0, L, nr, w, sk, ss);
    }
}

template <int MODE>
int launch(const int32_t* x, const int32_t* lengths, const Tables& t, int B,
           int N, int L, int32_t* m_key, int32_t* m_score, cudaStream_t s) {
    const int tiles = (N + T - 1) / T;
    const size_t shm = sizeof(int32_t) * (T + D + 2 * (size_t)(L < D ? L : D) * SP);
    unigram_walk_kernel<MODE><<<(unsigned)((int64_t)B * tiles), T, shm, s>>>(
        x, lengths, t, N, L, tiles, m_key, m_score);
    return (int)cudaGetLastError();
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
    if (B <= 0 || N <= 0 || L < 1 || (int64_t)B * ((N + T - 1) / T) > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    int32_t* ms = reinterpret_cast<int32_t*>(m_score);
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
        case 0: return launch<0>(x, lengths, t, B, N, L, m_key, ms, s);
        case 1: return launch<1>(x, lengths, t, B, N, L, m_key, ms, s);
        case 2: return launch<2>(x, lengths, t, B, N, L, m_key, ms, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
