"""The port's W2H hyphenation (blingfire_tpu_torch/compiler/hyphpats.py,
ops/hyph.py, runtime/hyph.py) against the JAX package, the scalar engine
and the native runtime, on the CPU.

The JAX package clamps a comb slot ``base[s] + c`` into the slot array
(blingfire_tpu/ops/hyph.py:96), so from the state that owns slot 0 a symbol
below that state's base takes slot 0's transition, which the automaton does
not have (ROADMAP.md section C).  In a syllab-shaped model the root owns
slot 0 with base -1 and the apostrophe is dense symbol 0, so every start at
an apostrophe false-hits there.  The port takes no such transition.  So a
row is held to JAX lane for lane unless a replay of its walk finds such a
false hit; a row with one is held to the scalar engine instead.
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import full_corpus
from test_hyph_compiler import DICT

from blingfire_tpu.compiler import hyphpats as jax_hyphpats
from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.ops import hyph as jax_hyph
from blingfire_tpu.ops.tables import build_comb_table as jax_build_comb
from blingfire_tpu.runtime.hyph import HyphTpu as JaxHyphTpu
from blingfire_tpu_torch import kernels, native, testing
from blingfire_tpu_torch.compiler import hyphpats
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import hyph
from blingfire_tpu_torch.runtime import hyph as hyph_rt
from blingfire_tpu_torch.runtime import metrics
from blingfire_tpu_torch.runtime.hyph import HyphEngine, HyphTpu, render

N_SMALL = 3000  # patterns of the small syllab-shaped model
HYPHEN = 0x2D
TABLE_FIELDS = ("base", "owner", "nxt", "final", "moore_ow", "pat_vals",
                "pat_len")
STATIC_FIELDS = ("n_slots", "max_pat", "min_pat_len", "no_hyph_len")


@functools.lru_cache(maxsize=None)
def _blob(kind: str) -> bytes:
    if kind == "small":
        return testing.syllab_shaped_model_bytes(N_SMALL)
    if kind == "ignore_case":
        return testing.syllab_shaped_model_bytes(N_SMALL, seed=1,
                                                 ignore_case=True,
                                                 no_hyph_len=2)
    assert kind == "slot0"
    return testing.hyph_slot0_model_bytes()


@functools.lru_cache(maxsize=None)
def _port(kind: str) -> HyphTpu:
    return HyphTpu(load_bytes(_blob(kind), use_cache=False), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax(kind: str) -> JaxHyphTpu:
    return JaxHyphTpu(jax_load_bytes(_blob(kind), use_cache=False).w2h)


@functools.lru_cache(maxsize=None)
def _native(kind: str) -> int:
    return native.set_model(_blob(kind))


@functools.lru_cache(maxsize=1)
def _words() -> list[list[int]]:
    """The words of tests/corpus.py (bench.py's rule) with duplicates, the
    edge words, and uppercase, Cyrillic and apostrophe words."""
    docs = [d.encode("utf-8") for d in full_corpus()]
    extra = "Hyphenation HYPHEN naïve NAÏVE Ёлка ёлка don't l'été o'clock"
    return (testing.corpus_words(docs) + testing.hyph_edge_words()
            + testing.corpus_words([extra.encode()]))


def _jax_false_hits(t: hyph.HyphDeviceTables, x, word_len) -> np.ndarray:
    """bool (B,): rows where JAX's walk takes a transition the port's does
    not.  The port's walk is replayed with JAX's clamped lookup
    (hyph.py:94-98) beside it: up to the first difference both walks agree,
    so the replay sees it."""
    x = torch.as_tensor(np.asarray(x))
    wl = torch.as_tensor(np.asarray(word_len))[:, None]
    B, M = x.shape
    xp = torch.cat([x, torch.full((B, M + 1), -1, dtype=torch.int32)], 1)
    pos = torch.arange(M, dtype=torch.int32)
    state = torch.where(pos < (wl + 2 - (t.min_pat_len - 1)).clamp(min=0),
                        0, -1).to(torch.int32)
    found = torch.zeros(B, dtype=torch.bool)
    for d in range(M):
        if not bool((state >= 0).any()):
            break
        c = xp[:, d : d + M]
        ns = hyph.comb_lookup(t, state, c)[0]
        raw = t.base[state.clamp(min=0).long()].long() + c.clamp(min=0).long()
        slot = raw.clamp(0, t.n_slots - 1)
        jhit = (t.owner[slot] == state) & (state >= 0) & (c >= 0)
        jns = torch.where(jhit, t.nxt[slot], -1)
        found |= (jns != ns).any(dim=1)
        state = ns
    return found.numpy()


def _rows(h: HyphTpu, words, width: int):
    seqs = [h._map_raw(h._normalize(np.asarray(w, np.int64))) for w in words]
    return h.rows(seqs, width + 2)


def _hold_rows(kind: str, words, width: int, min_pat_len=None,
               no_hyph_len=None) -> np.ndarray:
    """The port's plain hyph_segment against JAX hyph_segment on the rows of
    ``words`` at ``width``: lane for lane on every row where JAX's clamp
    does not false-hit, the scalar engine on each other row.  Returns the
    rows of JAX's false hits."""
    p, j = _port(kind), _jax(kind)
    pt, jt = p.tables, j.tables
    over = {k: v for k, v in (("min_pat_len", min_pat_len),
                              ("no_hyph_len", no_hyph_len)) if v is not None}
    pt = dataclasses.replace(pt, **over)
    jt = dataclasses.replace(jt, **over)
    x, wl = _rows(p, words, width)
    got = hyph.hyph_segment(pt, torch.from_numpy(x), torch.from_numpy(wl))
    assert got.dtype == torch.int32 and got.shape == (len(words), width)
    got = got.numpy()
    want = np.asarray(jax_hyph.hyph_segment(jt, jnp.asarray(x),
                                            jnp.asarray(wl)))
    fh = _jax_false_hits(pt, x, wl)
    np.testing.assert_array_equal(got[~fh], want[~fh])
    eng = HyphEngine(p.model)
    eng.min_pat_len, eng.no_hyph_len = pt.min_pat_len, pt.no_hyph_len
    for r in np.flatnonzero(fh):
        assert got[r, : wl[r]].tolist() == eng.process(list(words[r]))
        assert (got[r, wl[r]:] == hyph.HYPH_UNKNOWN).all()
    return fh


# --------------------------------------------------------------- compiler


@pytest.mark.parametrize("dont_care", [True, False])
def test_hyphpats_copy_matches_jax_on_dict(dont_care):
    kw = dict(min_pat_len=3, max_pat_len=7, dont_care=dont_care,
              runtime_min_len=1)
    blob, sel, unsolved = hyphpats.compile_w2h_model(DICT, **kw)
    jblob, jsel, junsolved = jax_hyphpats.compile_w2h_model(DICT, **kw)
    assert blob == jblob and sel == jsel and unsolved == junsolved


def test_hyphpats_copy_matches_jax_on_syllab_shaped_patterns():
    pats = testing.syllab_shaped_patterns(N_SMALL)
    assert len({k for k, _ in pats}) == N_SMALL
    assert all(not all(o == 7 for o in ops) for _, ops in pats)
    assert all(k[0] != 0x27 for k, _ in pats)
    kw = dict(min_len=2, l_anchor=94, r_anchor=94,
              charmap=testing.syllab_charmap())
    assert hyphpats.build_w2h_ldb(pats, **kw) \
        == jax_hyphpats.build_w2h_ldb(pats, **kw) == _blob("small")


def test_syllab_shaped_model_has_the_slot0_root():
    h = _port("small")
    s, probes = testing.slot0_probes(h.comb)
    assert s == 0 and probes == [0]  # the root, below it the apostrophe
    assert int(h.comb.sym2iw[0x27]) == 0
    assert int(h.comb.sym2iw[testing.SYLLAB_ANCHOR]) == 1
    assert h.engine.trans.step(0, 0) == (-1, -1)
    assert h.tables.min_pat_len == 2 and h.tables.max_pat == 8


# ----------------------------------------------------------------- tables


@pytest.mark.parametrize("kind", ["small", "ignore_case", "slot0"])
def test_device_tables_match_jax(kind):
    m = load_bytes(_blob(kind), use_cache=False).w2h
    jm = jax_load_bytes(_blob(kind), use_cache=False).w2h
    jt = jax_hyph.make_device_tables(jax_build_comb(jm.aut), jm.aut.moore_ow,
                                     jm.i2info, jm.params)
    pt = _port(kind).tables
    for f in TABLE_FIELDS:
        a, b = getattr(pt, f).numpy(), np.asarray(getattr(jt, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in STATIC_FIELDS:
        assert getattr(pt, f) == getattr(jt, f), f
    assert pt.base.device.type == "cpu"
    assert np.array_equal(_port(kind).comb.sym2iw,
                          jax_build_comb(m.aut).sym2iw)


# ---------------------------------------------------------- hyph_segment


@pytest.mark.parametrize("no_hyph_len", [0, 2])
@pytest.mark.parametrize("min_pat_len", [2, 3])
def test_plain_segment_matches_jax(min_pat_len, no_hyph_len):
    words = list({tuple(w): None for w in _words() if len(w) <= 300})
    fh = []
    for width in (16, 32):
        sel = [w for w in words if len(w) <= width]
        fh.append(_hold_rows("small", sel, width, min_pat_len, no_hyph_len))
    edge = [w for w in testing.hyph_edge_words() if len(w) <= 300]
    fh.append(_hold_rows("small", edge, 300, min_pat_len, no_hyph_len))
    # the apostrophe words false-hit in JAX's walk
    assert any(f.any() for f in fh)


def test_plain_segment_on_random_rows():
    """Seeded rows of random symbols, the sentinel, anchors and padding
    inside the row, and lengths that disagree with the row."""
    p = _port("small")
    rng = np.random.default_rng(5)
    B, W = 64, 24
    x = rng.integers(-1, p._n_iws + 1, (B, W + 2)).astype(np.int32)
    x[:, 0] = p._l_iw
    wl = rng.integers(0, W + 1, B).astype(np.int32)
    x[np.arange(B), wl + 1] = p._r_iw
    wl[:4] = [0, W, W + 3, 1]
    got = hyph.hyph_segment(p.tables, torch.from_numpy(x), torch.from_numpy(wl))
    want = np.asarray(jax_hyph.hyph_segment(_jax("small").tables,
                                            jnp.asarray(x), jnp.asarray(wl)))
    fh = _jax_false_hits(p.tables, x, wl)
    np.testing.assert_array_equal(got.numpy()[~fh], want[~fh])
    assert (~fh).sum() > B // 2


def test_plain_segment_notes_its_reads():
    p = _port("small")
    words = [w for w in _words() if 0 < len(w) <= 16][:50]
    x, wl = _rows(p, words, 16)
    r = kernels.Reads()
    got = hyph._hyph_segment_plain(p.tables, torch.from_numpy(x),
                                   torch.from_numpy(wl), reads=r)
    assert torch.equal(got, hyph.hyph_segment(p.tables, torch.from_numpy(x),
                                              torch.from_numpy(wl)))
    assert r.steps > len(words) and r.entries("base") > 0
    assert r.entries("pat_vals") >= r.entries("pat_len") > 0
    assert r.table_bytes() < sum(getattr(p.tables, f).numel() * 4
                                 for f in TABLE_FIELDS)


# ------------------------------------------------------------------ slot 0


def test_slot0_model_follows_the_scalar_engine_not_jax():
    """The five-pattern model: the apostrophe is dense symbol 0 and the
    root owns slot 0 with base -1, so JAX reads an apostrophe at the root
    as the root's ``^`` transition and hyphenates after the ``a`` of
    ``'ab``; the scalar engine, the native runtime and the port do not."""
    p, j, eng = _port("slot0"), _jax("slot0"), HyphEngine(_port("slot0").model)
    s, probes = testing.slot0_probes(p.comb)
    assert (s, probes) == (0, [0]) and int(p.comb.sym2iw[0x27]) == 0
    words = [[ord(c) for c in w] for w in ("'ab", "'abab", "cab'ab")]
    got = p.process_batch(words)
    want = j.process_batch(words)
    h = _native("slot0")
    for w, g, jw in zip(words, got, want):
        s = "".join(map(chr, w))
        assert g == eng.process(w)
        assert native.word_hyphenation(h, s, HYPHEN) == render(w, g, HYPHEN)
        assert jw != g  # JAX's false hit
    assert want[0] == [-1, 1, -1] and got[0] == [-1, -1, -1]
    # every row without an apostrophe equals JAX lane for lane
    more = [[ord(c) for c in w] for w in ("ab", "abcd", "cab", "dab", "b'c",
                                          "xab'", "acd'ab", "")]
    fh = _hold_rows("slot0", words + more, 8)
    assert fh.tolist() == [0x27 in w for w in words + more]


# -------------------------------------------------------------- HyphTpu


@pytest.mark.parametrize("kind", ["small", "ignore_case"])
def test_process_batch_matches_jax_engine_and_native(kind):
    p, j = _port(kind), _jax(kind)
    words = _words()
    long_words = [[0x61 + i % 26 for i in range(n)] for n in (300, 301, 450)]
    words = words + long_words + words[:40]  # duplicates
    c = metrics.Counters()
    got = p.process_batch(words, counters=c)
    st = p.last_stats
    assert st.words == len(words)
    assert st.oversize == sum(len(w) > 300 for w in words) >= 3
    assert 0 < st.unique < len(words) and sum(st.rows.values()) == st.unique
    assert {"dedup", "map", "pack", "device", "unpack"} <= set(c.stage_seconds)
    want = j.process_batch(words)
    eng, h = HyphEngine(p.model), _native(kind)
    uniq = list({tuple(w): None for w in words if len(w) <= 300})
    x, wl = _rows(p, uniq, 300)
    fh_words = {uniq[r] for r in np.flatnonzero(_jax_false_hits(p.tables, x,
                                                                wl))}
    assert fh_words  # words with an apostrophe
    for w, g, jw in zip(words, got, want):
        if len(w) > hyph_rt.MAX_WORD_SIZE:
            assert g is None and jw is None
            continue
        assert g == eng.process(w)
        if tuple(w) not in fh_words:
            assert g == jw
        s = "".join(map(chr, w))
        assert native.word_hyphenation(h, s, HYPHEN) == render(w, g, HYPHEN)
    if kind == "ignore_case":
        a = p.process_batch([[ord(c) for c in "HYPHENATION"],
                             [ord(c) for c in "hyphenation"]])
        assert a[0] == a[1]


def test_tiny_buckets_and_one_row_launches_give_the_same_output(monkeypatch):
    words = _words()
    want = _port("small").process_batch(words)
    monkeypatch.setattr(hyph_rt, "BUCKETS", (4, 8, hyph_rt.MAX_WORD_SIZE))
    monkeypatch.setattr(hyph_rt, "LAUNCH_BYTES", 1)
    tiny = HyphTpu(load_bytes(_blob("small"), use_cache=False), device="cpu")
    trace = []
    assert tiny.process_batch(words, trace=trace) == want
    st = tiny.last_stats
    assert set(st.rows) == {4, 8, hyph_rt.MAX_WORD_SIZE}
    assert all(len(t[1]) == 1 for t in trace)
    assert sum(st.launches.values()) == len(trace) == st.unique


def test_process_batch_edges():
    p = _port("small")
    assert p.process_batch([]) == []
    assert p.process_batch([[0x61] * 301]) == [None]
    assert p.process_batch([[]]) == [[]]
    with pytest.raises(ValueError):
        HyphTpu(load_bytes(testing.shipped_lexer_bytes("wbd"),
                           use_cache=False), device="cpu")


def test_native_word_hyphenation_reads_nul_as_space_and_cuts_at_300():
    h = _native("small")
    eng = _port("small").engine
    w = [0] + [ord(c) for c in "embedded"]
    assert native.word_hyphenation(h, "\x00embedded", HYPHEN) \
        == render(w, eng.process(w), HYPHEN)
    long = "ab" * 200
    assert native.word_hyphenation(h, long, HYPHEN) \
        == native.word_hyphenation(h, long[:300], HYPHEN)
    assert native.word_hyphenation(h, "", HYPHEN) == ""
