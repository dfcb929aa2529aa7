"""K4 pack_out_compact and K11 pack_out as Triton kernels.

K4 replaces the ``pack_out_compact`` helper of
blingfire_tpu/runtime/dedup.py::_helpers (dedup.py:217-226).  Each output
row is ``N`` lanes ``(id + 1) | (start << shift)`` followed by the row's
token count and its fallback flag: the layout native ``stitch`` reads.

K11 replaces the ``pack_out`` helper beside it (dedup.py:210-215): each
output row is the N ids, the N starts, the token count and the fallback
flag as int32, the (B, 2N + 2) layout the NumPy unit path reads.

Bound: bytes.  Each reads two int32 planes and two per-row values and
writes them once, with no communication across lanes: one fused elementwise
pass.  A K4 program is a tile of rows by the next power of two of N + 2
columns; a K11 program a tile of rows by at most 1,024 output columns,
each column loading from the plane it belongs to.

This module imports nothing of Triton at import time (the CPU tests import
every module): ``tl`` is bound when the kernel is first compiled.
"""

from __future__ import annotations

import functools

tl = None  # triton.language, bound by _compiled()


def _pack_kernel(ids_ptr, starts_ptr, counts_ptr, fb_ptr, out_ptr, B, N,
                 SHIFT: tl.constexpr, BLOCK_R: tl.constexpr,
                 BLOCK_C: tl.constexpr):
    pid = tl.program_id(0)
    r = pid * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
    c = tl.arange(0, BLOCK_C)[None, :]
    rm = r < B
    lm = rm & (c < N)
    ids = tl.load(ids_ptr + r * N + c, mask=lm, other=0)
    starts = tl.load(starts_ptr + r * N + c, mask=lm, other=0)
    cnt = tl.load(counts_ptr + r, mask=rm, other=0)
    fb = tl.load(fb_ptr + r, mask=rm, other=0).to(tl.int32)
    lane = (ids + 1) | (starts << SHIFT)
    val = tl.where(c < N, lane, tl.where(c == N, cnt, fb))
    tl.store(out_ptr + r * (N + 2) + c, val, mask=rm & (c < N + 2))


def _pack_full_kernel(ids_ptr, starts_ptr, counts_ptr, fb_ptr, out_ptr, B, N,
                      BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
    c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)[None, :]
    rm = r < B
    ids = tl.load(ids_ptr + r * N + c, mask=rm & (c < N), other=0)
    starts = tl.load(starts_ptr + r * N + (c - N),
                     mask=rm & (c >= N) & (c < 2 * N), other=0)
    cnt = tl.load(counts_ptr + r, mask=rm, other=0)
    fb = tl.load(fb_ptr + r, mask=rm, other=0).to(tl.int32)
    val = tl.where(c < N, ids,
                   tl.where(c < 2 * N, starts, tl.where(c == 2 * N, cnt, fb)))
    tl.store(out_ptr + r * (2 * N + 2) + c, val, mask=rm & (c < 2 * N + 2))


@functools.cache
def _compiled():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_pack_kernel), triton.jit(_pack_full_kernel)


def launch(ids, starts, counts, fb_u8, out, shift: int) -> None:
    """ids, starts int32 (B, N); counts int32 (B,); fb_u8 uint8 (B,);
    out int32 (B, N + 2).  All contiguous on one CUDA device."""
    import triton

    B, N = ids.shape
    kernel = _compiled()[0]
    block_c = triton.next_power_of_2(N + 2)
    block_r = max(1, 4096 // block_c)
    grid = (triton.cdiv(B, block_r),)
    kernel[grid](ids, starts, counts, fb_u8, out, B, N, SHIFT=shift,
                 BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)


def launch_full(ids, starts, counts, fb_u8, out) -> None:
    """K11: ids, starts int32 (B, N); counts int32 (B,); fb_u8 uint8 (B,);
    out int32 (B, 2N + 2).  All contiguous on one CUDA device."""
    import triton

    B, N = ids.shape
    kernel = _compiled()[1]
    block_c = min(1024, triton.next_power_of_2(2 * N + 2))
    block_r = max(1, 4096 // block_c)
    grid = (triton.cdiv(B, block_r), triton.cdiv(2 * N + 2, block_c))
    kernel[grid](ids, starts, counts, fb_u8, out, B, N, BLOCK_R=block_r,
                 BLOCK_C=block_c, num_warps=4)
