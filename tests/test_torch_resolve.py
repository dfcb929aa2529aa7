"""K2 bpe_resolve's claim split at cuts (kernels/csrc/bpe_resolve.cu),
replayed on the CPU against the plain resolve, and the port's rank-mode
resolve against both JAX branches.

A position q is a cut when no kept arc has st < q <= en
(ops/bpe.py::claim_segments).  The replay sorts the plain version's kept
arcs segment-major, in the row's priority order inside each segment, and
runs the greedy claim one segment at a time, every segment's k-th arc at
step k with nothing shared between segments, as K2's threads do; then the
plain EMIT.  Ids, starts, ends, counts and flags must equal _resolve_plain
on every row, flagged rows included: gpt2-shaped unit rows (plain and
merge-priority modes), the spm-BPE-shaped rank rows (trie and comb tables,
unit and classic rows), the rank-fault model's rows and the seeded edge
rows of testing.resolve_edge_rows.

K2's marking mode (every launch whose rows go to the native stitch): the
marks fall on exactly the tokens that cover a start whose walk the depth
cap cut, inside the punctuation-run unit alone; the row's flag keeps
arc_overflow | anomaly; ids, ends and counts, and the starts below the
mark, equal the default mode's."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from test_torch_bpe import (REGIONS, RANK_FAULT_DOCS, _jax_resolve,  # noqa: F401
                            _jax_walk, _one_thread, _rank_setup, _region,
                            _rows, _setup)

from blingfire_tpu_torch import native, testing
from blingfire_tpu_torch.formats.consts import TokAlgo
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import bpe
from blingfire_tpu_torch.runtime.host import SpTokenizer

ALGOS = [TokAlgo.BPE_OPT, TokAlgo.BPE_OPT_WITH_MERGES]


def _stable_sort(order, key):
    """``order`` (B, L) re-sorted stably by ``key`` (B, L) taken along it."""
    return order.gather(1, key.gather(1, order).sort(dim=1, stable=True)
                        .indices)


def _replay(t, m_pack, m_rank, so, x, ln, spm_iw: int, unk_id: int,
            a_max: int):
    """K2's claim order on the CPU: (ids, starts, ends, counts, fallback)."""
    LR, B, N = m_pack.shape
    arcs = bpe.claim_segments(t, m_pack, m_rank, x, ln, spm_iw, unk_id,
                              a_max)
    L = arcs.keep.shape[1]
    # kept arcs first, segment-major, then (rank,) id, start; ties in slab
    # order: stable sorts from the least significant key up
    order = torch.arange(L)[None, :].expand(B, L)
    order = _stable_sort(order, arcs.id.long() * N + arcs.start)
    if m_rank is not None:
        order = _stable_sort(order, bpe.float_desc_key(arcs.rank))
    order = _stable_sort(order, arcs.seg)
    order = _stable_sort(order, (~arcs.keep).to(torch.int32))
    L = int(arcs.keep.sum(dim=1).max()) if B else 0  # the kept arcs lead
    st, en, ids, keep, seg = (a.gather(1, order[:, :L]) for a in (
        arcs.start, arcs.end, arcs.id, arcs.keep, arcs.seg))
    # each arc's index inside its segment
    idx = torch.arange(L)[None, :].expand(B, L)
    head = torch.ones((B, L), dtype=torch.bool)
    head[:, 1:] = seg[:, 1:] != seg[:, :-1]
    local = idx - torch.cummax(torch.where(head, idx, 0), dim=1).values
    occ = torch.zeros((B, N + 1), dtype=torch.bool)
    claimed = torch.zeros((B, L), dtype=torch.bool)
    rows = torch.arange(B)[:, None]
    for k in range(int(arcs.depth.max()) if B else 0):
        m = keep & (local == k)  # at most one arc a segment
        free1 = ~occ.gather(1, st.long())
        free2 = (en + 1 >= ln[:, None]) | ~occ.gather(
            1, (en + 1).clamp(max=N).long())
        claim = m & free1 & free2
        claimed |= claim
        # mark st+1..en of every claim at once (the segments are disjoint)
        delta = torch.zeros((B, N + 2), dtype=torch.int32)
        delta.scatter_add_(1, torch.where(claim, st + 1, N + 1).long(),
                           claim.to(torch.int32))
        delta.scatter_add_(1, torch.where(claim, en + 1, N + 1).long(),
                           -claim.to(torch.int32))
        occ |= delta.cumsum(dim=1)[:, : N + 1] > 0
    # EMIT: last claim wins at a start, interior starts dropped, compacted
    pos = torch.arange(N)
    win = torch.full((B, N + 1), -1, dtype=torch.int64).scatter_reduce(
        1, torch.where(claimed, st, N).long(), torch.where(claimed, idx, -1),
        reduce="amax")[:, :N]
    has = win >= 0
    w = win.clamp(min=0)
    valid = pos[None, :] < ln[:, None]
    tok = has & ~occ[:, :N] & valid
    counts = tok.sum(dim=1).to(torch.int32)
    slot = torch.where(tok, tok.cumsum(dim=1) - 1, N)
    out = []
    for src in (ids.gather(1, w), pos[None, :].expand(B, N),
                en.gather(1, w)):
        o = torch.zeros((B, N + 1), dtype=torch.int32)
        o[rows, slot] = torch.where(tok, src, 0).to(torch.int32)
        out.append(o[:, :N])
    raw = out[0]
    if t.prio2id is not None:
        raw = torch.where(raw == 0, unk_id,
                          t.prio2id[raw.clamp(0, t.trie_v - 1).long()])
        raw = torch.where(pos[None, :] < counts[:, None], raw, 0)
    out[0] = (raw + t.id_offset).to(torch.int32)
    anomaly = bpe._filter_plain(t, m_pack, x, ln, spm_iw)[3]
    fallback = (so & valid).any(dim=1) | (arcs.n_arcs > a_max) | anomaly
    return (*out, counts, fallback), arcs


def _check(t, m_pack, m_rank, so, x, ln, spm_iw, a_max, unk_id=0):
    """The replay equals _resolve_plain; returns the claim arcs."""
    got, arcs = _replay(t, m_pack, m_rank, so, x, ln, spm_iw, unk_id, a_max)
    want = bpe._resolve_plain(t, m_pack, m_rank, so, x, ln, spm_iw, unk_id,
                              a_max)
    for name, a, b in zip(("ids", "starts", "ends", "counts", "fallback"),
                          got, want):
        assert torch.equal(a, b), name
    kept = arcs.keep.sum(dim=1)
    assert (arcs.depth <= kept).all() and (arcs.depth > 0).eq(kept > 0).all()
    return arcs


def _walk_check(t, x, ln, spm_iw, a_max, lw=None, bounded=False):
    xt, lt = torch.from_numpy(x), torch.from_numpy(ln)
    m, mr, so = bpe.bpe_walk(t, xt, lt, spm_iw, lw=lw, bounded=bounded)
    return _check(t, m, mr, so, xt, lt, spm_iw, a_max)


@pytest.mark.parametrize("algo", ALGOS, ids=["bpe_opt", "merges_priority"])
@pytest.mark.parametrize("region,lw,bounded", REGIONS)
def test_claim_split_on_gpt2_unit_rows(algo, region, lw, bounded):
    tok, _jt, spm_iw, x, ln = _region(algo, region)
    arcs = _walk_check(tok.tables, x, ln, spm_iw, tok.a_max, lw, bounded)
    # packed units split each row: the claim is far shallower than the row
    assert int(arcs.depth.max()) < int(arcs.keep.sum(dim=1).max())


@pytest.mark.parametrize("comb_mode", [False, True], ids=["trie", "comb"])
@pytest.mark.parametrize("kind,row", _rows("units") + _rows("classic"))
def test_claim_split_on_rank_rows(kind, row, comb_mode):
    tok, pt, _jt, _c, rows = _rank_setup(kind, comb_mode)
    x, ln, lw, bounded = rows[row]
    _walk_check(pt, x, ln, tok._spm_iw, tok.a_max, lw, bounded)


def test_claim_split_on_rank_fault_rows():
    tok = SpTokenizer(load_bytes(testing.rank_fault_model_bytes()),
                      max_doc_symbols=16, device="cpu")
    x, ln, _status = tok._prep_batch(RANK_FAULT_DOCS)
    _walk_check(tok.tables, x, ln, tok._spm_iw, tok.a_max)


@functools.lru_cache(maxsize=None)
def _mode_tables(mode: str):
    """(tables, spm_iw) of the plain, merge-priority and rank modes."""
    if mode == "rank":
        tok, pt, _jt, _c, _rows = _rank_setup("units", False)
        return pt, tok._spm_iw
    tok, _jt, spm_iw, _regions = _setup(
        TokAlgo.BPE_OPT if mode == "plain" else TokAlgo.BPE_OPT_WITH_MERGES)
    return tok.tables, spm_iw


@pytest.mark.parametrize("mode", ["plain", "priority", "rank"])
def test_claim_split_on_edge_rows(mode):
    t, spm_iw = _mode_tables(mode)
    assert (t.prio2id is not None) == (mode == "priority")
    assert bpe.rank_mode(t) == (mode == "rank")
    # at N = 128 (a_max 512): the plain claim is one step an arc on the CPU;
    # tests/test_torch_gpu.py runs the same rows at 1,024 and 4,096 on K2
    for case in testing.resolve_edge_rows(spm_iw, n=128):
        m_pack, so, x, ln = (torch.from_numpy(case[k]) for k in (
            "m_pack", "slot_overflow", "x", "lengths"))
        m_rank = torch.from_numpy(case["m_rank"]) if mode == "rank" else None
        a_max = case["a_max"]
        arcs = _check(t, m_pack, m_rank, so, x, ln, spm_iw, a_max, unk_id=3)
        kept = arcs.keep.sum(dim=1)
        if case["name"] == "one_segment":
            assert kept.tolist()[0] == arcs.depth.tolist()[0] == a_max
            assert arcs.depth.tolist()[1] < kept.tolist()[1]
        if case["name"] == "truncation":
            # all arcs: one segment; the a_max cut splits it
            whole = bpe.claim_segments(t, m_pack, m_rank, x, ln, spm_iw, 3,
                                       1 << 20)
            assert whole.depth.tolist()[0] == int(whole.n_arcs[0]) > a_max
            assert int(arcs.depth[0]) < kept.tolist()[0] == a_max


@pytest.mark.parametrize("comb_mode", [False, True], ids=["trie", "comb"])
@pytest.mark.parametrize("kind,row", _rows("units") + _rows("classic"))
def test_rank_mode_resolve_matches_both_jax_branches(monkeypatch, kind, row,
                                                     comb_mode):
    """Rank mode on the seeded models: every alphabet symbol is a piece, so
    an unknown run is only a symbol outside the alphabet, which no arc
    spans, and the rank key's order across signs (ROADMAP.md section C
    item 5) changes no lane."""
    tok, pt, jt, _c, rows = _rank_setup(kind, comb_mode)
    x, ln, lw, bounded = rows[row]
    m_pack, m_rank, so = _jax_walk(jt, x, ln, tok._spm_iw, lw, bounded)
    p_pack, p_rank, p_so = bpe.bpe_walk(pt, torch.from_numpy(x),
                                        torch.from_numpy(ln), tok._spm_iw,
                                        lw=lw, bounded=bounded)
    port = [t.numpy() for t in bpe.bpe_resolve(
        pt, p_pack, p_rank, p_so, torch.from_numpy(x), torch.from_numpy(ln),
        tok._spm_iw, 0, tok.a_max)]
    scatter = _jax_resolve(monkeypatch, "0", jt, m_pack, m_rank, so, x, ln,
                           tok._spm_iw, tok.a_max)
    gather = _jax_resolve(monkeypatch, "1", jt, m_pack, m_rank, so, x, ln,
                          tok._spm_iw, tok.a_max)
    for name, a, b in zip(("ids", "starts", "ends", "counts", "fallback"),
                          port, scatter):
        np.testing.assert_array_equal(a, b, err_msg=name)
    ok = ~port[4] & ~gather[4]
    assert ok.sum() > 0
    for name, a, b in zip(("ids", "starts", "ends", "counts"), port, gather):
        np.testing.assert_array_equal(a[ok], b[ok], err_msg=name)


# rare long words: ▁-initial units past 16 symbols, packed into region B
# beside the punctuation runs
LONG_WORDS = [b"internationalization", b"counterrevolutionary",
              b"electroencephalogram", b"uncharacteristically",
              b"incomprehensibilities", b"interdisciplinarity",
              b"telecommunications", b"photosynthetically",
              b"misrepresentations", b"overcompensations"]
# one run a row, past the longest piece the depth-16 walk can finish: "-"
# runs are pieces alone, "=" runs only after a ▁ (testing.LONG_CHARS)
RUN_DOCS = [b"see " + b"-" * 20 + b" end", b"so " + b"=" * 20]


@functools.lru_cache(maxsize=None)
def _run_rows(algo):
    """(tables, spm_iw, region B rows x, lengths, the runs' input weights)
    of one batch of gpt2-shaped units: two rows, each one punctuation run
    among rare long words."""
    tok, _jt, spm_iw, _regions = _setup(algo)
    docs = ([RUN_DOCS[0]] + [b"an " + w for w in LONG_WORDS[:5]]
            + [RUN_DOCS[1]] + [b"the " + w for w in LONG_WORDS[5:]])
    nu = native.units_analyze(docs, tok.n_doc, tok._sym2iw, spm_iw, True,
                              False, None)
    lo, hi = nu.split_rows, nu.n_rows
    x = torch.from_numpy(nu.px[lo:hi].copy())
    ln = torch.from_numpy(nu.plen[lo:hi].copy())
    nu.close()
    runs = {int(tok._sym2iw[c]) for c in b"-="} | {spm_iw}
    return tok.tables, spm_iw, x, ln, runs


def _check_marks(t, m_pack, m_rank, so, x, ln, spm_iw, a_max, unk_id=0):
    """K2's plain version with marks against the default mode on the same
    walk; returns (its output, whether a row's overflowed starts all lie
    inside tokens, arc_overflow | anomaly)."""
    want = bpe._resolve_plain(t, m_pack, m_rank, so, x, ln, spm_iw, unk_id,
                              a_max)
    got = bpe._resolve_plain(t, m_pack, m_rank, so, x, ln, spm_iw, unk_id,
                             a_max, mark=True)
    ids, starts, ends, counts, fb = got
    for name, a, b in (("ids", ids, want[0]), ("ends", ends, want[2]),
                       ("counts", counts, want[3])):
        assert torch.equal(a, b), name
    assert torch.equal(starts & (bpe.MARK_BIT - 1), want[1])
    marks = (starts & bpe.MARK_BIT) != 0
    B, N = x.shape
    valid = torch.arange(N)[None, :] < ln[:, None]
    over = so & valid
    covered = torch.zeros_like(over)
    for b in range(B):
        for k in range(int(counts[b])):
            st, en = int(want[1][b, k]), int(ends[b, k])
            assert bool(marks[b, k]) == bool(over[b, st:en + 1].any()), (b, k)
            covered[b, st:en + 1] = True
        assert not marks[b, int(counts[b]):].any()
    whole = (over & ~covered).any(dim=1)
    survive, run_start, _re, anomaly, _v = bpe._filter_plain(
        t, m_pack, x, ln, spm_iw)
    arcs = survive.sum(dim=(0, 2)) + run_start.sum(dim=1)
    row_flags = (arcs > a_max) | anomaly
    assert torch.equal(fb, whole | row_flags)
    # the default mode flags every row with an overflowed start
    assert torch.equal(want[4], over.any(dim=1) | row_flags)
    return got, ~whole, row_flags


@pytest.mark.parametrize("algo", ALGOS, ids=["bpe_opt", "merges_priority"])
def test_marks_fall_on_the_run_units_tokens_alone(algo):
    t, spm_iw, x, ln, runs = _run_rows(algo)
    m, mr, so = bpe.bpe_walk(t, x, ln, spm_iw, lw=16, bounded=False)
    assert len(x) == 2 and so.any(dim=1).all()
    survive, run_start, _re, _an, _v = bpe._filter_plain(t, m, x, ln, spm_iw)
    arcs = survive.sum(dim=(0, 2)) + run_start.sum(dim=1)
    # a budget that the wider row passes: that row stays flagged whole
    a_max = int(arcs.max()) - 1
    got, covered, row_flags = _check_marks(t, m, mr, so, x, ln, spm_iw, a_max)
    assert covered.all() and row_flags.tolist() == (arcs > a_max).tolist()
    assert row_flags.any() and not row_flags.all()
    _ids, starts, ends, counts, _fb = got
    marks = (starts & bpe.MARK_BIT) != 0
    for b in range(len(x)):
        k = int(counts[b])
        assert 0 < int(marks[b].sum()) < k
        # every marked token lies inside the row's run unit (▁ and the run)
        for j in torch.nonzero(marks[b, :k]).flatten().tolist():
            st = int(starts[b, j]) & (bpe.MARK_BIT - 1)
            en = int(ends[b, j])
            assert set(x[b, st:en + 1].tolist()) <= runs
    # with the model's budget no row is flagged at all
    _got, covered, row_flags = _check_marks(t, m, mr, so, x, ln, spm_iw,
                                            bpe.RESOLVE_MAX_ARCS)
    assert covered.all() and not row_flags.any()


@pytest.mark.parametrize("mode", ["plain", "priority", "rank"])
def test_marks_on_edge_rows(mode):
    t, spm_iw = _mode_tables(mode)
    for case in testing.resolve_edge_rows(spm_iw, n=128):
        m_pack, so, x, ln = (torch.from_numpy(case[k]) for k in (
            "m_pack", "slot_overflow", "x", "lengths"))
        m_rank = torch.from_numpy(case["m_rank"]) if mode == "rank" else None
        _check_marks(t, m_pack, m_rank, so, x, ln, spm_iw, case["a_max"],
                     unk_id=3)
