"""K4 pack_out_compact as a Triton kernel.

K4 replaces the ``pack_out_compact`` helper of
blingfire_tpu/runtime/dedup.py::_helpers (dedup.py:217-226).  Each output
row is ``N`` lanes ``(id + 1) | (start << shift)`` followed by the row's
token count and its fallback flag: the layout native ``stitch`` reads.

Bound: bytes.  It reads two int32 planes and two per-row values and writes
them once, with no communication across lanes: one fused elementwise pass.
A program is a tile of rows by the next power of two of N + 2 columns.
(K11 ``pack_out`` beside it is CUDA: ``csrc/pack_out.cu``.)

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


@functools.cache
def _compiled():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_pack_kernel)


def launch(ids, starts, counts, fb_u8, out, shift: int) -> None:
    """ids, starts int32 (B, N); counts int32 (B,); fb_u8 uint8 (B,);
    out int32 (B, N + 2).  All contiguous on one CUDA device."""
    import triton

    B, N = ids.shape
    kernel = _compiled()
    block_c = triton.next_power_of_2(N + 2)
    block_r = max(1, 4096 // block_c)
    grid = (triton.cdiv(B, block_r),)
    kernel[grid](ids, starts, counts, fb_u8, out, B, N, SHIFT=shift,
                 BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
