"""Double-single ("df64") arithmetic on float32 tensors: the port of
blingfire_tpu/ops/dfloat.py.

The reference unigram DP accumulates float32 token scores in a C++ double
(FATokenSegmentationTools_1best_t.h:129-140); the JAX package tracks
compensated (hi, lo) float32 pairs instead (Knuth two-sum, error-free for
each step), and the port follows it bit for bit.  The float32 operations
and their order are those of dfloat.py:14-31: no reassociation, no product.
``kernels/csrc/dfloat.cuh`` holds the same three functions for the card."""

from __future__ import annotations


def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def df_add(hi, lo, f):
    """(hi, lo) + f32 -> normalized (hi, lo)."""
    s, e = two_sum(hi, f)
    e = e + lo
    hi2, lo2 = two_sum(s, e)
    return hi2, lo2


def df_lt(a_hi, a_lo, b_hi, b_lo):
    """a < b for df64 pairs."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))
