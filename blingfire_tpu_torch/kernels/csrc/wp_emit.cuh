// Shared SCAN + EMIT tail of the WordPiece sub-token passes (K7 and K8 in
// wp_subword.cu): port of blingfire_tpu/ops/lexer.py::_wp_emit
// (lexer.py:295-350), which the comb pass repeats inline (lexer.py:403-443).
//
// One warp holds one packed row of M <= 128 lanes, each thread the row's
// positions lane, lane + 32, lane + 64 and lane + 96.  Each position's
// deepest final (position, Moore Ow) becomes its action (RightCx, tag,
// function) and the next start of the visited chain, next = skip + 2.  The
// chain 0, next[0], next[next[0]], ... is the reference's sequential
// FromPos scan (a true recurrence: the cummax closed form of the BPE
// filter would be wrong here, lexer.py:298-302).  It moves strictly
// forward, so it is found by pointer doubling with shuffles: within each
// 32-position window every lane doubles its jump five times, which gives
// the window's chain from that lane and where the chain leaves the
// window; then the windows are chained from position 0.  The plain version,
// ops/lexer.py::visited_chain, doubles over the whole row.  The emitted lanes
// are compacted left by ballots and popcounts, which keeps their position
// order, the order of JAX's stable sort by (emitted ? pos : INT32_MAX).
// Lanes pack as uint32 (tag + 1) | from << 17 | to << 24 | nested << 31
// and are stored as int32.
#pragma once

#include "common.cuh"

namespace wp {

constexpr int kMaxRow = 128;         // 7-bit from/to fields of the lane layout
constexpr int kPer = kMaxRow / 32;   // positions a thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

struct Actions {
    const int32_t* right;  // RightCx by rule Ow
    const int32_t* tag;
    const int32_t* fn;  // -1: no function call
    int n;               // >= 1
};

// What the emit needs of one start of the row
struct Start {
    uint32_t lane;  // the packed lane
    int32_t next;   // the chain's next start after this one: skip + 2
    bool cand;      // emitted when the chain visits it
};

// The action of position p (p < M): xp its symbol; valid: a start the walk
// ran from; fin_pos / fin_ow the deepest final (-1: none).
__device__ __forceinline__ Start action(const Actions& a, int M, int p,
                                        int32_t xp, bool valid, int32_t l_iw,
                                        int32_t fin_pos, int32_t fin_ow) {
    // the action gathers clamp at both ends, as XLA's gather does
    // (lexer.py:308-310 guard only the lower end)
    const int64_t o = clamp64(fin_ow, 0, a.n - 1);
    const int32_t right = __ldg(a.right + o);
    int32_t tag = 0, fn = -1;
    if (fin_ow >= 0) {
        tag = __ldg(a.tag + o);
        fn = __ldg(a.fn + o);
    }
    // content coordinates; an L-anchor start binds to its unit's first
    // character (lexer.py:312)
    const int32_t from_orig = xp == l_iw ? p : p - 1;
    const int32_t fpos = fin_pos - 1;
    const int32_t from2 = (int32_t)clamp64(from_orig, 0, M - 1);
    const int32_t to2 = (int32_t)clamp64((int64_t)fpos - right, 0, M - 1);
    const bool has = fin_pos >= 0;
    const int32_t reach = fpos - right;
    Start s;
    s.lane = (uint32_t)(tag + 1) | ((uint32_t)from2 << 17) |
             ((uint32_t)to2 << 24) | ((uint32_t)(fn >= 0 ? 1 : 0) << 31);
    s.next = (has ? (from_orig > reach ? from_orig : reach) : from_orig) + 2;
    s.cand = valid && has && (tag != 0 || fn >= 0);
    return s;
}

// Bit k: position 32k + lane is on the chain from position 0.  next[k] is
// the chain's next start after that position (> the position); positions
// at or past M must be cut by the caller.  Every lane of the warp calls it.
__device__ __forceinline__ unsigned visited(const int32_t (&next)[kPer]) {
    const int lane = threadIdx.x & 31;
    unsigned mask[kPer];  // the window's chain from this lane, so far
    int32_t ex[kPer];     // where it leaves the window, once it has
    int32_t nx[kPer];     // the lane it has reached (>= 32: it has left)
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        mask[k] = 1u << lane;
        ex[k] = next[k];
        nx[k] = next[k] - 32 * k;
    }
    // after round r each lane has followed 2^(r+1) jumps: all 32 after 5
#pragma unroll
    for (int r = 0; r < 5; ++r) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const bool in = nx[k] < 32;
            const int src = in ? nx[k] : lane;
            const unsigned m = __shfl_sync(kFull, mask[k], src);
            const int32_t e = __shfl_sync(kFull, ex[k], src);
            const int32_t n = __shfl_sync(kFull, nx[k], src);
            if (in) {
                mask[k] |= m;
                ex[k] = e;
                nx[k] = n;
            }
        }
    }
    // chain the windows from position 0: e enters window k or lies past it
    unsigned vis = 0;
    int32_t e = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const bool in = e < 32 * (k + 1);
        const int src = in ? e - 32 * k : 0;
        const unsigned m = __shfl_sync(kFull, mask[k], src);
        const int32_t x = __shfl_sync(kFull, ex[k], src);
        if (in) {
            vis |= ((m >> lane) & 1u) << k;
            e = x;
        }
    }
    return vis;
}

// The row's output, out_row[0 .. M + 1]: the emitted lanes left-compacted,
// zeros after them, the count, a zero.  Every lane of the warp calls it.
__device__ __forceinline__ void emit_row(int M, const Start (&s)[kPer],
                                         unsigned vis, int32_t* out_row) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1;
    int total = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const bool emit = 32 * k + lane < M && ((vis >> k) & 1u) && s[k].cand;
        const unsigned bits = __ballot_sync(kFull, emit);
        if (emit) out_row[total + __popc(bits & below)] = (int32_t)s[k].lane;
        total += __popc(bits);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int p = 32 * k + lane;
        if (p < M && p >= total) out_row[p] = 0;
    }
    if (lane == 0) {
        out_row[M] = total;
        out_row[M + 1] = 0;
    }
}

}  // namespace wp
