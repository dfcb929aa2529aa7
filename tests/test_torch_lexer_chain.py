"""K9 lexer_pass's FromPos chain and packed tables, on the CPU.

``ops/lexer.py::visited_chain`` finds the starts the reference's sequential
FromPos scan visits by pointer doubling (K9 runs the same rounds in shared
memory); here it is held to that sequential scan on seeded monotone skip
arrays of 1 to 16,386 lanes, and the plain ``lexer_pass`` built on it to
JAX's ``lexer_pass`` on wbd and sbd rows of 258, 1,026 and 4,098 lanes.
K9's packed records (a state's base, final and Moore Ow; a slot's owner and
next state) are held to the comb arrays for every (state, symbol).  The
module runs on one torch intra-op thread (``test_torch_bpe._one_thread``):
beside the suite's other workers, the walks' loops of small ops slowed
100x and more with the default threads.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_bpe import _one_thread  # noqa: F401  (one intra-op thread)
from test_torch_lexer import MODELS, _hold_rows, _port

from blingfire_tpu_torch import testing
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import lexer
from blingfire_tpu_torch.runtime.lexer_host import WordPieceTpu

KINDS = ("nowhere", "everywhere", "last", "mixed")


def _sequential(skip: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The reference's sequential FromPos scan, lane by lane, cut at
    ``end``: the loop the plain lexer_pass ran before visited_chain."""
    B, M = skip.shape
    vis = np.zeros((B, M), bool)
    nv = np.zeros(B, np.int64)
    for q in range(M):
        v = nv == q
        vis[:, q] = v
        nv = np.where(v, skip[:, q].astype(np.int64) + 2, nv)
    return vis & (np.arange(M)[None, :] < end[:, None])


def _skips(kind: str, M: int, rng, B: int = 3) -> np.ndarray:
    """Monotone skip arrays (skip[p] >= p - 1): no start matches
    ("nowhere": the chain visits every start), every start matches
    ("everywhere"), one match from the first start to the last lane
    ("last"), or a seeded mix."""
    p = np.arange(M)
    skip = np.tile(p - 1, (B, 1))
    if kind == "everywhere":
        skip = skip + rng.integers(1, 12, (B, M))
    elif kind == "last":
        skip[:, 0] = M - 3
    elif kind == "mixed":
        jump = rng.integers(1, 40, (B, M)) * (rng.random((B, M)) < 0.3)
        skip = skip + jump
    return skip.astype(np.int32)


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(M=st.integers(1, lexer.MAX_LEXER_ROW), kind=st.sampled_from(KINDS),
       seed=st.integers(0, 2**32 - 1))
def test_visited_chain_matches_the_sequential_scan(M, kind, seed):
    rng = np.random.default_rng(seed)
    skip = _skips(kind, M, rng)
    end = np.array([M, int(rng.integers(-1, M + 3)), 1], np.int32)
    got = lexer.visited_chain(torch.from_numpy(skip), torch.from_numpy(end))
    np.testing.assert_array_equal(got.numpy(), _sequential(skip, end))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M", [1, 2, 3, 66, lexer.MAX_LEXER_ROW])
def test_visited_chain_at_the_limits(M, kind):
    """The narrowest rows and K9's widest, with the chain ending at the
    row's end, at its last lane but one, and at no lane."""
    rng = np.random.default_rng(M)
    skip = _skips(kind, M, rng)
    end = np.array([M, M - 1, 0], np.int32)
    got = lexer.visited_chain(torch.from_numpy(skip), torch.from_numpy(end))
    want = _sequential(skip, end)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "nowhere":
        assert want[0].all() and not want[2].any()


@functools.lru_cache(maxsize=1)
def _docs() -> list[bytes]:
    return testing.zipf_corpus(64 << 10)


@pytest.mark.parametrize("width", [256, 1024, 4096])
@pytest.mark.parametrize("name", MODELS)
def test_lexer_pass_matches_jax_on_wide_rows(name, width):
    """testing.lexer_wide_rows at 258, 1,026 and 4,098 lanes: text from the
    initial state, a row from a dead-end state that matches nowhere, and a
    row whose R anchor is on its last lane but one; lane for lane against
    JAX's lexer_pass (rows where JAX takes a transition the port does not
    against the scalar engine)."""
    x, init, elen, raws = testing.lexer_wide_rows(_port(name).lex, width,
                                                  _docs(), n_rows=2)
    got, _below, _dead = _hold_rows(name, x, init, elen, raws)
    assert got[0][0].any() and not got[0][2].any()


@functools.lru_cache(maxsize=None)
def _tables(name: str):
    if name == "bert":
        return WordPieceTpu(load_bytes(testing.bert_shaped_model_bytes(2000)),
                            device="cpu").lex
    return _port(name).lex


@pytest.mark.parametrize("name", MODELS + ["bert"])
def test_packed_records_match_the_comb_arrays(name):
    """For every (state, symbol), the IW_ANY and the unmapped sentinel
    included, the lookup through K9's packed records (a state's base, then
    its slot's owner and next state) gives the comb lookup's transition;
    final and Moore Ow match the separate arrays."""
    lex = _tables(name)
    t = lex.tables
    S = t.state_rec.shape[0]
    A = lex.comb.n_iws + 1
    assert t.state_rec.shape == (S, 4) and t.slot_rec.shape == (t.n_slots, 2)
    assert S == t.base.numel() and 0 <= t.any_iw < A
    assert torch.equal(t.state_rec[:, 0], t.base)
    assert torch.equal(t.state_rec[:, 1] != 0, t.final)
    assert torch.equal(t.state_rec[:, 2], t.moore_ow)
    assert not t.state_rec[:, 3].any()
    for lo in range(0, S, 4096):
        s = torch.arange(lo, min(lo + 4096, S)).repeat_interleave(A)
        c = torch.arange(A).repeat(len(s) // A)
        raw = t.state_rec[s, 0].long() + c
        inside = (raw >= 0) & (raw < t.n_slots)
        rec = t.slot_rec[raw.clamp(0, t.n_slots - 1)]
        hit = inside & (rec[:, 0] == s)
        want, want_hit = lexer.comb_lookup(t, s.to(torch.int32),
                                           c.to(torch.int32))
        assert torch.equal(hit, want_hit)
        assert torch.equal(torch.where(hit, rec[:, 1], -1), want)
