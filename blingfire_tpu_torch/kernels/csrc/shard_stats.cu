// K12 shard_stats: one rank's token total and position-weighted checksum.
//
// Replaces the statistics of blingfire_tpu/parallel/mesh.py (``resolve`` and
// ``stats_of``, mesh.py:91-104 and :110-118; ``ShardedWpRunner._step``,
// :222-234): for each row r, total += counts[r], and checksum += ids[r, t] *
// (t * -1640531527 + 1) for every t below counts[r], in int32 wrap-around.
// Unsigned 32-bit arithmetic makes the wrap well defined (0x9E3779B9 is
// -1640531527 as uint32); the sum of the partials mod 2^32 is the JAX
// package's int32 sum, whatever their order.  The total adds the raw
// counts, negatives included, as jnp.sum(counts) does; the checksum reads
// the lanes t < clamp(count, 0, W).
//
// ids come with a row stride and counts with a stride of their own, so the
// WordPiece slab's ``out[:, :-2]`` and its count column need no copy; no row
// at or past R is read.  The caller reduces acc = [total, checksum
// partials] across ranks and takes the checksum mod 2^32
// (parallel/mesh.py::finish_stats); acc is added to, never overwritten.
//
// One wave: at most kMaxBlocks blocks, each a contiguous span of rows, in
// tiles of up to 256 rows.  A tile's counts load coalesced (one a thread),
// a block scan of clamp(count, 0, W) numbers the tile's (row, t) pairs, and
// the threads take those pairs in turn (a binary search over the scan finds
// a pair's row), so no thread idles on the lanes past a count: main-dp's
// rows are 128 lanes wide with 7-56 below their counts, and 7,359 of the
// 9,997 doc rows are empty.  A warp-shuffle and shared-memory reduction
// then adds the block's sums with one atomicAdd pair.
//
// Bound: bytes: the lanes below each count and the counts, read once.  An
// atomic pair a warp (a warp a row: up to 20,000 on one address for a
// 9,997-row slab) took half the time of main-dp's slabs.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 4;  // one wave: four blocks an SM

__global__ void __launch_bounds__(kThreads)
shard_stats_kernel(const int32_t* __restrict__ ids, int64_t row_stride,
                   const int32_t* __restrict__ counts, int64_t count_stride,
                   int64_t R, int W, int64_t span,
                   unsigned long long* __restrict__ acc) {
    __shared__ int off[kThreads];  // exclusive scan of the tile's lanes
    __shared__ int buf[32];
    __shared__ uint32_t red_sum[kWarps];
    __shared__ long long red_tot[kWarps];
    const int tid = threadIdx.x;
    const int64_t lo = (int64_t)blockIdx.x * span;
    const int64_t hi = lo + span < R ? lo + span : R;
    uint32_t sum = 0;
    long long tot = 0;
    for (int64_t r0 = lo; r0 < hi; r0 += kThreads) {
        const int nr = hi - r0 < kThreads ? (int)(hi - r0) : kThreads;
        int n = 0;
        if (tid < nr) {
            const int c = __ldg(counts + (r0 + tid) * count_stride);
            tot += c;
            n = c < 0 ? 0 : (c > W ? W : c);
        }
        int lanes;
        off[tid] = block_scan(n, buf, OpSum(), 0, nullptr, &lanes);
        __syncthreads();
        for (int k = tid; k < lanes; k += kThreads) {
            int a = 0, b = nr - 1;  // the last row of the tile starting <= k
            while (a < b) {
                const int m = (a + b + 1) >> 1;
                if (off[m] <= k) a = m; else b = m - 1;
            }
            const int t = k - off[a];
            sum += (uint32_t)__ldg(ids + (r0 + a) * row_stride + t) *
                   ((uint32_t)t * 0x9E3779B9u + 1u);
        }
        __syncthreads();  // off is the next tile's
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_down_sync(0xffffffffu, sum, o);
        tot += __shfl_down_sync(0xffffffffu, tot, o);
    }
    const int lane = tid & 31, w = tid >> 5;
    if (lane == 0) {
        red_sum[w] = sum;
        red_tot[w] = tot;
    }
    __syncthreads();
    if (tid == 0) {
        for (int i = 1; i < kWarps; ++i) {
            sum += red_sum[i];
            tot += red_tot[i];
        }
        if (sum != 0 || tot != 0) {
            atomicAdd(acc, (unsigned long long)tot);
            atomicAdd(acc + 1, (unsigned long long)sum);
        }
    }
}

}  // namespace

extern "C" int bf_shard_stats(const int32_t* ids, int64_t row_stride,
                              const int32_t* counts, int64_t count_stride,
                              int64_t R, int W, unsigned long long* acc,
                              void* stream) {
    if (R <= 0) return 0;
    if (W < 0 || (int64_t)W * kThreads >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = R < kMaxBlocks ? R : kMaxBlocks;
    const int64_t span = (R + blocks - 1) / blocks;
    shard_stats_kernel<<<(unsigned)((R + span - 1) / span), kThreads, 0,
                         (cudaStream_t)stream>>>(
        ids, row_stride, counts, count_stride, R, W, span, acc);
    return (int)cudaGetLastError();
}
