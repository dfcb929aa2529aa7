// Shared SCAN + EMIT tail of the WordPiece sub-token passes (K7 and K8 in
// wp_subword.cu): port of blingfire_tpu/ops/lexer.py::_wp_emit
// (lexer.py:295-350), which the comb pass repeats inline (lexer.py:403-443).
//
// One block holds one packed row of M <= 128 lanes, one thread a lane.  Each
// thread turns its start's deepest final (position, Moore Ow) into the
// action (RightCx, tag, function) and its skip target; thread 0 then runs
// the visited scan over the row in order, because it is a true sequential
// recurrence (nv == q -> nv = skip[q] + 2): the cummax closed form of the
// BPE filter would be wrong here (lexer.py:298-302).  The emitted lanes are
// compacted left by a block-wide prefix sum over the emit flags, which keeps
// their position order, the order of JAX's stable sort by
// (emitted ? pos : INT32_MAX).  Lanes pack as uint32
// (tag + 1) | from << 17 | to << 24 | nested << 31 and are stored as int32.
#pragma once

#include "common.cuh"

namespace wp {

constexpr int kMaxRow = 128;  // 7-bit from/to fields of the lane layout

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

struct Actions {
    const int32_t* right;  // RightCx by rule Ow
    const int32_t* tag;
    const int32_t* fn;  // -1: no function call
    int n;               // >= 1
};

// Every thread of the block calls this.  p: the thread's lane (active when
// p < M); xp its symbol; valid: a start the walk ran from; fin_pos / fin_ow
// the deepest final (-1: none).  skip, vis: M ints of shared memory; buf: 32.
__device__ __forceinline__ void emit_row(const Actions& a, int M, int p,
                                         bool active, int32_t xp, bool valid,
                                         int32_t l_iw, int32_t fin_pos,
                                         int32_t fin_ow, int32_t* skip,
                                         int32_t* vis, int* buf,
                                         int32_t* out_row) {
    int32_t tag = 0, fn = -1, from2 = 0, to2 = 0;
    bool has = false;
    if (active) {
        // the action gathers clamp at both ends, as XLA's gather does
        // (lexer.py:308-310 guard only the lower end)
        const int64_t o = clamp64(fin_ow, 0, a.n - 1);
        const int32_t right = __ldg(a.right + o);
        if (fin_ow >= 0) {
            tag = __ldg(a.tag + o);
            fn = __ldg(a.fn + o);
        }
        // content coordinates; an L-anchor start binds to its unit's first
        // character (lexer.py:312)
        const int32_t from_orig = xp == l_iw ? p : p - 1;
        const int32_t fpos = fin_pos - 1;
        from2 = (int32_t)clamp64(from_orig, 0, M - 1);
        to2 = (int32_t)clamp64((int64_t)fpos - right, 0, M - 1);
        has = fin_pos >= 0;
        const int32_t reach = fpos - right;
        skip[p] = has ? (from_orig > reach ? from_orig : reach) : from_orig;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int32_t nv = 0;
        for (int q = 0; q < M; ++q) {
            const bool v = nv == q;
            vis[q] = v;
            if (v) nv = skip[q] + 2;
        }
    }
    __syncthreads();
    const bool emit =
        active && vis[p] && valid && has && (tag != 0 || fn >= 0);
    const uint32_t lane = (uint32_t)(tag + 1) | ((uint32_t)from2 << 17) |
                          ((uint32_t)to2 << 24) |
                          ((uint32_t)(fn >= 0 ? 1 : 0) << 31);
    int total = 0;
    const int rank = block_scan(emit ? 1 : 0, buf, OpSum(), 0, nullptr, &total);
    if (emit) out_row[rank] = (int32_t)lane;
    if (active && p >= total) out_row[p] = 0;
    if (threadIdx.x == 0) {
        out_row[M] = total;
        out_row[M + 1] = 0;
    }
}

}  // namespace wp
