"""K6's lane-group shapes on the CPU: the port's unigram_segment (the plain
versions of K5 and K6) against the JAX package's on
testing.unigram_lane_edge_rows, in every table mode, at tolerance 0; and
ops/unigram.py::viterbi_lane_group, the launcher's choice of lanes a row.

Apart from tests/test_torch_unigram.py so that the two files' JAX compiles
(one a row width and walk depth) run on different workers."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_unigram import (MODES, _assert_same, _both_tables,
                                _false_hit_rows, _force_mode)

from blingfire_tpu.ops import unigram as jax_unigram
from blingfire_tpu_torch import testing
from blingfire_tpu_torch.ops import unigram


@functools.lru_cache(maxsize=1)
def _lane_rows():
    return testing.unigram_lane_edge_rows()


@pytest.mark.parametrize("case", testing.LANE_EDGE_CASES,
                         ids=lambda c: f"N{c[0]}-lw{c[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_segment_lane_edge_rows_match_jax(monkeypatch, mode, case):
    """testing.unigram_lane_edge_rows, the shapes of K6's lane groups: L
    from 1 to 40 (past a warp), widths 1, 31, 65 and 200, lengths 0, below
    N, N and past N, unknown runs across the arc tiles' boundaries, exact
    ties between depths, and an end where every candidate is -FLT_MAX."""
    N, lw = case
    blob, rows = _lane_rows()
    x, ln = rows[N]
    _force_mode(monkeypatch, mode)
    jt, pt = _both_tables(blob, testing.LANE_MAX_LEN)
    assert pt.max_len == testing.LANE_MAX_LEN
    L = unigram.walk_depth(pt, lw)
    assert not _false_hit_rows(pt, x, ln, lw).any()
    port = unigram.unigram_segment(pt, torch.from_numpy(x),
                                   torch.from_numpy(ln), 7, lw=lw)
    out = jax_unigram.unigram_segment(jt, jnp.asarray(x), jnp.asarray(ln),
                                      jnp.int32(7), lw=lw)
    _assert_same(port, [np.asarray(o) for o in out])
    if N >= 5 and L >= 5:
        assert port[1].min() < 0, "no end where every candidate is -FLT_MAX"


def test_lane_edge_rows_cover_the_lane_shapes():
    """The cases reach every lane-group shape named in their docstring, and
    viterbi_lane_group picks the launcher's groups: L rounded up to a power
    of two, 32 past a warp, wider only when a warp's rows outgrow shared
    memory."""
    _blob, rows = _lane_rows()
    Ls = {min(lw or testing.LANE_MAX_LEN, testing.LANE_MAX_LEN)
          for _n, lw in testing.LANE_EDGE_CASES}
    assert Ls == {1, 3, 8, 9, 15, 16, 17, 33, 40}
    for N, (x, ln) in rows.items():
        assert x.shape[1] == N and N in (1, 31, 65, 200)
        assert {0, N}.issubset(set(ln.tolist())) and (ln > N).any()
        if N > 1:
            assert ((ln > 0) & (ln < N)).any()
    x, ln = rows[200]
    unk = np.nonzero(x[1] == -1)[0]
    assert {15, 16, 31, 32}.issubset(set(unk.tolist()))
    group = unigram.viterbi_lane_group
    assert [group(L, 128) for L in (1, 3, 8, 9, 15, 16, 17, 33)] == \
        [1, 4, 8, 16, 16, 16, 32, 32]
    assert group(15, 1024) == 16 and group(8, 1024) == 8
    assert group(1, 20000) > 1 and group(32, unigram.VITERBI_MAX_N) == 32
