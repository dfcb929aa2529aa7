// K12 shard_stats: one rank's token total and position-weighted checksum.
//
// Replaces the statistics of blingfire_tpu/parallel/mesh.py (``resolve`` and
// ``stats_of``, mesh.py:91-104 and :110-118; ``ShardedWpRunner._step``,
// :222-234): for each row r, total += counts[r], and checksum += ids[r, t] *
// (t * -1640531527 + 1) for every t below counts[r], in int32 wrap-around.
// Unsigned 32-bit arithmetic makes the wrap well defined (0x9E3779B9 is
// -1640531527 as uint32); the sum of the partials mod 2^32 is the JAX
// package's int32 sum, whatever their order.
//
// ids come with a row stride and counts with a stride of their own, so the
// WordPiece slab's ``out[:, :-2]`` and its count column need no copy; no row
// at or past R is read.  One warp a row (grid-stride over rows), a warp
// reduction, then one 64-bit atomicAdd a warp into acc = [total, checksum
// partials]; the caller reduces acc across ranks and takes the checksum mod
// 2^32 (parallel/mesh.py::finish_stats).
//
// Bound: bytes: the lanes below each count and the counts, read once.

#include "common.cuh"

__global__ void shard_stats_kernel(const int32_t* __restrict__ ids,
                                   int64_t row_stride,
                                   const int32_t* __restrict__ counts,
                                   int64_t count_stride, int64_t R, int W,
                                   unsigned long long* __restrict__ acc) {
    const int lane = threadIdx.x & 31;
    const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
    uint32_t sum = 0;
    unsigned long long tot = 0;
    for (int64_t r = warp; r < R; r += n_warps) {
        const int c = counts[r * count_stride];
        if (lane == 0) tot += (unsigned long long)(long long)c;
        const int n = c < 0 ? 0 : (c > W ? W : c);
        const int32_t* row = ids + r * row_stride;
        for (int t = lane; t < n; t += 32)
            sum += (uint32_t)row[t] * ((uint32_t)t * 0x9E3779B9u + 1u);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_down_sync(0xffffffffu, sum, o);
        tot += __shfl_down_sync(0xffffffffu, tot, o);
    }
    if (lane == 0 && (sum != 0 || tot != 0)) {
        atomicAdd(acc, tot);
        atomicAdd(acc + 1, (unsigned long long)sum);
    }
}

extern "C" int bf_shard_stats(const int32_t* ids, int64_t row_stride,
                              const int32_t* counts, int64_t count_stride,
                              int64_t R, int W, unsigned long long* acc,
                              void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    int64_t blocks = (R * 32 + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    if (blocks < 1) blocks = 1;
    shard_stats_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        ids, row_stride, counts, count_stride, R, W, acc);
    return (int)cudaGetLastError();
}
