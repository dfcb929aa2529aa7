// K6 unigram_viterbi: the unigram LM's best segmentation from the walk's arcs.
//
// Replaces everything after the walk in blingfire_tpu/ops/unigram.py::
// unigram_segment (unigram.py:214-351): the re-index of arcs by end
// (roll_d), the DP scan in df64 pairs (dfloat.cuh), the backtrace, the
// deferred id gather and the left compaction with id_offset.
//
// One warp per row.  The row's best (hi, lo) pairs, begins and flags sit in
// shared memory; as the ring of the JAX scan holds best[e-1-k] for k < L,
// a full array of N positions holds the same values.  At each end e the
// L+1 candidates (depth L-1 down to 0, then the unknown arc) are strided
// over the lanes; the arc of depth d is read where the walk wrote it,
// m_key/m_score[b, e-d, d] (start = e - d, no copy).  Each lane keeps its
// first maximum, and a butterfly reduction on (hi, lo, candidate index)
// keeps the first maximum of the warp: a strictly greater (hi, lo) wins,
// equal pairs go to the lower index.  When every candidate is -FLT_MAX that
// is candidate 0, the depth L-1 arc, as in JAX.  Positions at or past the
// row's length are not scanned: no output reads them.  The backtrace is
// serial on lane 0; the id gather and the compaction run over the lanes.
// Every index XLA clamps silently is clamped here (unigram.py:323-331).
//
// Bound: the DP is a serial chain of N steps per row, each a read of L+1
// arcs, a df64 add per candidate and a 5-step warp reduction, so the kernel
// is latency-bound far above both its byte bound (the B*N*L*8 bytes of
// arcs) and its operation bound (about 14 float32 operations per
// candidate); rows run in parallel, one warp each.

#include <cfloat>
#include <climits>
#include <cmath>

#include "common.cuh"
#include "dfloat.cuh"

namespace {

constexpr float kNegInf = -FLT_MAX;
constexpr float kUnkScore = -100000.0f;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// (h, l, j) beats (bh, bl, bj): a strictly greater df64 pair, or an equal
// pair at a lower candidate index
__device__ __forceinline__ bool beats(float h, float l, int j, float bh,
                                      float bl, int bj) {
    if (df_lt(bh, bl, h, l)) return true;
    return !df_lt(h, l, bh, bl) && j < bj;
}

__global__ void unigram_viterbi_kernel(
    const int32_t* __restrict__ m_key, const float* __restrict__ m_score,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ ids_tab,
    int nkeys, int B, int N, int L, int unk_id, int id_offset,
    int32_t* __restrict__ out_ids, int32_t* __restrict__ out_starts,
    int32_t* __restrict__ out_ends, int32_t* __restrict__ counts) {
    extern __shared__ unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wpb = blockDim.x >> 5;
    const int b = blockIdx.x * wpb + warp;
    if (b >= B) return;  // whole warps only: no block-wide barrier below
    float* bhi = reinterpret_cast<float*>(smem) + (size_t)warp * 2 * N;
    float* blo = bhi + N;
    int* beg = reinterpret_cast<int*>(smem) + (size_t)wpb * 2 * N +
               (size_t)warp * 2 * N;
    int* lst = beg + N;  // segment ends, last first
    uint8_t* flg = smem + (size_t)wpb * 16 * N + (size_t)warp * N;

    const int len = lengths[b];
    const int n_act = clampi(len, 0, N);  // valid positions
    const int32_t* kr = m_key + (int64_t)b * N * L;
    const float* sr = m_score + (int64_t)b * N * L;

    // bit 0: no match starts here (unknown start); bit 1: winner is unknown
    for (int p = lane; p < n_act; p += 32) {
        bool has = false;
        for (int d = 0; d < L && !has; ++d) has = kr[(int64_t)p * L + d] >= 0;
        flg[p] = has ? 0 : 1;
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
                    df_add(before ? bhi[st - 1] : 0.0f,
                           before ? blo[st - 1] : 0.0f, esc, ch, cl);
                }
            } else if (flg[e] & 1) {
                df_add(e >= 1 ? bhi[e - 1] : 0.0f, e >= 1 ? blo[e - 1] : 0.0f,
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
            const float oh = __shfl_xor_sync(0xffffffffu, bh, o);
            const float ol = __shfl_xor_sync(0xffffffffu, bl, o);
            const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
            if (beats(oh, ol, oj, bh, bl, bj)) {
                bh = oh;
                bl = ol;
                bj = oj;
            }
        }
        const bool w_unk = bj == L;
        int begin = e - (w_unk ? 0 : L - 1 - bj);
        if (w_unk && prev_unk) begin = prev_begin;  // merge the run
        if (lane == 0) {
            bhi[e] = bh;
            blo[e] = bl;
            beg[e] = begin;
            if (w_unk) flg[e] |= 2;
        }
        prev_unk = w_unk;
        prev_begin = begin;
        __syncwarp();
    }

    // backtrace from the last position; begins never exceed their end
    int n = 0;
    if (lane == 0) {
        for (int cur = len - 1; cur >= 0 && cur < n_act; cur = beg[cur] - 1)
            lst[n++] = cur;
    }
    n = __shfl_sync(0xffffffffu, n, 0);
    __syncwarp();

    // deferred id gather and left compaction; padding: id_offset, 0, 0
    const int64_t ro = (int64_t)b * N;
    for (int k = lane; k < N; k += 32) {
        int id = 0, st = 0, en = 0;
        if (k < n) {
            en = lst[n - 1 - k];
            st = beg[en];
            if (flg[en] & 2) {
                id = unk_id;
            } else {
                const int wd = clampi(en - st, 0, L - 1);
                const int key = kr[(int64_t)clampi(st, 0, N - 1) * L + wd];
                id = __ldg(ids_tab + clampi(key, 0, nkeys - 1));
            }
        }
        out_ids[ro + k] = id + id_offset;
        out_starts[ro + k] = st;
        out_ends[ro + k] = en;
    }
    if (lane == 0) counts[b] = n;
}

}  // namespace

extern "C" int bf_unigram_viterbi(const int32_t* m_key, const float* m_score,
                                  const int32_t* lengths,
                                  const int32_t* ids_tab, int nkeys, int B,
                                  int N, int L, int unk_id, int id_offset,
                                  int32_t* out_ids, int32_t* out_starts,
                                  int32_t* out_ends, int32_t* counts,
                                  void* stream) {
    // per row: best hi/lo (8 B), begin and segment list (8 B), flags (1 B)
    const size_t per_row = (size_t)17 * N;
    int wpb = kWarpsPerBlock;
    while (wpb > 1 && wpb * per_row > 48 * 1024) --wpb;
    const size_t smem = wpb * per_row;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            unigram_viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const unsigned blocks = (unsigned)((B + wpb - 1) / wpb);
    unigram_viterbi_kernel<<<blocks, wpb * 32, smem, (cudaStream_t)stream>>>(
        m_key, m_score, lengths, ids_tab, nkeys, B, N, L, unk_id, id_offset,
        out_ids, out_starts, out_ends, counts);
    return (int)cudaGetLastError();
}
