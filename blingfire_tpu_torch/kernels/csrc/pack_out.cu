// K11 pack_out and K4 pack_out_compact: the unit paths' output rows.
//
// K11 replaces the ``pack_out`` helper of blingfire_tpu/runtime/dedup.py::
// _helpers (dedup.py:210-215): out[r] = ids[r, :N], starts[r, :N],
// counts[r], fallback[r] as int32, the (B, 2N + 2) layout
// UnitRunner.collect_flat reads.  K4 replaces ``pack_out_compact`` beside
// it (dedup.py:217-226): out[r] = N lanes (id + 1) | (start << shift),
// counts[r], fallback[r], the (B, N + 2) layout native ``stitch`` reads.
//
// Bound: bytes.  Two int32 planes and two values a row are read once and
// written once, with no arithmetic beyond K4's add, shift and or; the
// launches are short (about 2.5 MB on the NumPy unit path's 304 rows of
// 1,024, under 1 MB on a unit path's region), so the host's launch path
// matters as much as the kernel: it is one ctypes call with no Triton
// launcher.
//
// One thread moves one 8-byte pair of an output row: K11 two ids, two
// starts, or the row's (count, flag) as the last pair; K4 two lanes, or the
// (count, flag) pair.  K11's row of 2N + 2 int32 is 8-byte aligned, and
// K4's row of N + 2 when N is even; neither is 16-byte aligned for every N,
// so the vectors are int2 and not int4.  When N is odd (or a pointer is not
// 8-byte aligned) the planes' pairs straddle rows: one thread a value
// instead.  The grid is flat over the pairs (values) of all rows, so a
// short row wastes no threads.  K4 shifts as uint32_t: a negative start,
// or one past 1,023, gives the bits JAX's int32 shift gives, without
// undefined behaviour.

#include "common.cuh"

__global__ void pack_out_pair_kernel(const int32_t* __restrict__ ids,
                                     const int32_t* __restrict__ starts,
                                     const int32_t* __restrict__ counts,
                                     const uint8_t* __restrict__ fb,
                                     int32_t* __restrict__ out, int64_t n,
                                     int N) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int h = N >> 1, pairs = N + 1;  // pairs a row: h ids, h starts, 1
    const int64_t r = i / pairs;
    const int c = (int)(i - r * pairs);
    int2 v;
    if (c < h)
        v = reinterpret_cast<const int2*>(ids + r * N)[c];
    else if (c < N)
        v = reinterpret_cast<const int2*>(starts + r * N)[c - h];
    else
        v = make_int2(counts[r], (int)fb[r]);
    reinterpret_cast<int2*>(out + r * (2 * (int64_t)N + 2))[c] = v;
}

__global__ void pack_out_scalar_kernel(const int32_t* __restrict__ ids,
                                       const int32_t* __restrict__ starts,
                                       const int32_t* __restrict__ counts,
                                       const uint8_t* __restrict__ fb,
                                       int32_t* __restrict__ out, int64_t n,
                                       int N) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int width = 2 * N + 2;
    const int64_t r = i / width;
    const int c = (int)(i - r * width);
    int v;
    if (c < N)
        v = ids[r * N + c];
    else if (c < 2 * N)
        v = starts[r * N + c - N];
    else
        v = c == 2 * N ? counts[r] : (int)fb[r];
    out[i] = v;
}

static bool aligned8(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

// ids, starts int32 (B, N); counts int32 (B,); fb uint8 (B,); out int32
// (B, 2N + 2); all contiguous
extern "C" int bf_pack_out(const int32_t* ids, const int32_t* starts,
                           const int32_t* counts, const uint8_t* fb,
                           int32_t* out, int B, int N, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const bool pairs = (N & 1) == 0 && aligned8(ids) && aligned8(starts) &&
                       aligned8(out);
    const int64_t n = (int64_t)B * (pairs ? N + 1 : 2 * N + 2);
    if (n == 0) return 0;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    if (pairs)
        pack_out_pair_kernel<<<blocks, threads, 0, s>>>(ids, starts, counts,
                                                        fb, out, n, N);
    else
        pack_out_scalar_kernel<<<blocks, threads, 0, s>>>(ids, starts, counts,
                                                          fb, out, n, N);
    return (int)cudaGetLastError();
}

__device__ __forceinline__ int compact_lane(int id, int start, int shift) {
    return (int)(((uint32_t)id + 1u) | ((uint32_t)start << shift));
}

__global__ void pack_compact_pair_kernel(const int32_t* __restrict__ ids,
                                         const int32_t* __restrict__ starts,
                                         const int32_t* __restrict__ counts,
                                         const uint8_t* __restrict__ fb,
                                         int32_t* __restrict__ out, int64_t n,
                                         int N, int shift) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int h = N >> 1, pairs = h + 1;  // pairs a row: h lane pairs, 1
    const int64_t r = i / pairs;
    const int c = (int)(i - r * pairs);
    int2 v;
    if (c < h) {
        const int2 a = reinterpret_cast<const int2*>(ids + r * N)[c];
        const int2 s = reinterpret_cast<const int2*>(starts + r * N)[c];
        v = make_int2(compact_lane(a.x, s.x, shift),
                      compact_lane(a.y, s.y, shift));
    } else {
        v = make_int2(counts[r], (int)fb[r]);
    }
    reinterpret_cast<int2*>(out + r * ((int64_t)N + 2))[c] = v;
}

__global__ void pack_compact_scalar_kernel(const int32_t* __restrict__ ids,
                                           const int32_t* __restrict__ starts,
                                           const int32_t* __restrict__ counts,
                                           const uint8_t* __restrict__ fb,
                                           int32_t* __restrict__ out,
                                           int64_t n, int N, int shift) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int width = N + 2;
    const int64_t r = i / width;
    const int c = (int)(i - r * width);
    int v;
    if (c < N)
        v = compact_lane(ids[r * N + c], starts[r * N + c], shift);
    else
        v = c == N ? counts[r] : (int)fb[r];
    out[i] = v;
}

// ids, starts int32 (B, N); counts int32 (B,); fb uint8 (B,); out int32
// (B, N + 2); all contiguous; shift in [0, 32)
extern "C" int bf_pack_out_compact(const int32_t* ids, const int32_t* starts,
                                   const int32_t* counts, const uint8_t* fb,
                                   int32_t* out, int B, int N, int shift,
                                   void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const bool pairs = (N & 1) == 0 && aligned8(ids) && aligned8(starts) &&
                       aligned8(out);
    const int64_t n = (int64_t)B * (pairs ? N / 2 + 1 : N + 2);
    if (n == 0) return 0;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    if (pairs)
        pack_compact_pair_kernel<<<blocks, threads, 0, s>>>(
            ids, starts, counts, fb, out, n, N, shift & 31);
    else
        pack_compact_scalar_kernel<<<blocks, threads, 0, s>>>(
            ids, starts, counts, fb, out, n, N, shift & 31);
    return (int)cudaGetLastError();
}
