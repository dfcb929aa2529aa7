"""K8's chained slot records and the comb pass on a multilingual-bert-shaped
WordPiece model (testing.mbert_shaped_model_bytes), on the CPU:

(a) the tables' chained slot records (ops/lexer.py::comb_chain) against the
    comb arrays, slot for slot, on the bert-shaped model and a small
    mbert-shaped fixture (6,000 lines, 1,500 seeded ideographs); a replay of K8's step (one record a step, the
    base carried, the start's base and the Moore Ow from the state
    records) against the plain comb walk;
(b) the port's comb pass against JAX's wp_subword_pass on the fixture's
    dispatch rows and hand-made edge rows, at both walk depths;
(c) encode_corpus_flat with the comb pass forced against JAX's
    WordPieceHybrid and the scalar oracle, on documents that include the
    fixture's own ideographs;
(d) the full-size vocabulary's layout (119,547 lines), without compiling.

The JAX comb walk clamps a slot ``base[s] + c`` into the slot array, so
from the state that owns slot 0 a symbol below its base takes slot 0's
transition; the port takes none (ROADMAP.md section C).  The comb pass is
held to JAX on every row where that clamp does not false-hit (a replay of
the walk finds them) and to the dense pass, which has no clamp, on all.
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import full_corpus

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.ops import lexer as jax_lexer
from blingfire_tpu.runtime.wp_hybrid import WordPieceHybrid as JaxHybrid
from blingfire_tpu_torch import testing
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import lexer
from blingfire_tpu_torch.runtime import metrics
from blingfire_tpu_torch.runtime.lexer import LexerOracleApi
from blingfire_tpu_torch.runtime.wp_hybrid import LW_CLASSES, WordPieceHybrid

N_SMALL = 6000
UNK = testing.BERT_UNK


@functools.lru_cache(maxsize=None)
def _blob(kind: str) -> bytes:
    if kind == "bert":
        return testing.bert_shaped_model_bytes()
    return testing.mbert_shaped_model_bytes(N_SMALL)


@functools.lru_cache(maxsize=None)
def _port(kind: str = "mbert", comb: bool = True) -> WordPieceHybrid:
    """The port's hybrid on the CPU; comb=True declines the dense table."""
    saved = lexer.DENSE_MAX_ENTRIES
    lexer.DENSE_MAX_ENTRIES = -1 if comb else saved
    try:
        return WordPieceHybrid(load_bytes(_blob(kind), use_cache=False),
                               device="cpu")
    finally:
        lexer.DENSE_MAX_ENTRIES = saved


@functools.lru_cache(maxsize=1)
def _jax() -> JaxHybrid:
    return JaxHybrid(jax_load_bytes(_blob("mbert"), use_cache=False))


def _cjk() -> list[int]:
    return [c for c in testing.mbert_alphabet(0, testing.MBERT_CJK)
            if 0x4E00 <= c < 0xA000]


@functools.lru_cache(maxsize=1)
def _docs() -> list[bytes]:
    """tests/corpus.py, Zipfian documents and testing.mbert_docs: the
    fixture's own ideographs mixed with words, Cyrillic and Greek letters
    and ideographs outside its alphabet."""
    zipf = testing.zipf_corpus(100_000)[len(testing.EDGE_CASES):][:120]
    return ([d.encode("utf-8") for d in full_corpus()] + zipf
            + testing.mbert_docs(10_000))


@functools.lru_cache(maxsize=None)
def _packed(comb: bool = True):
    """(px, pinit, class_rows) of the port's packing of the documents."""
    h = _port(comb=comb)
    nh, u_syms, u_soff, u_fn = h._analyze(_docs())
    h._rt.BtlWpFree(nh)
    px, pinit, class_rows, _r, _o = h._pack(u_syms, u_soff, u_fn)
    return px, pinit, class_rows


def _edge(comb: bool = True):
    """testing.wp_edge_rows and a unit of dense symbol 0, which from the
    FnTokWord state (base -1, the owner of slot 0) probes slot -1."""
    h = _port(comb=comb)
    x, fn = testing.wp_edge_rows(h._l_iw, h._r_iw, h._map_raw)
    probe = np.full((1, x.shape[1]), -1, np.int32)
    probe[0, :4] = [h._l_iw, 0, 0, h._r_iw]
    x = np.concatenate([x, probe])
    fn = np.concatenate([fn, np.where(probe >= 0, testing.BERT_FN, -1)])
    init = np.where(fn >= 0, h._fn2ini[np.clip(fn, 0, len(h._fn2ini) - 1)],
                    -1).astype(np.int32)
    return x, init


def _rows(which: str, cls: int, comb: bool = True):
    lw = LW_CLASSES[cls] + 2
    if which == "edge":
        return (*_edge(comb), lw)
    px, pinit, class_rows = _packed(comb)
    lo, hi, row_lw = class_rows[cls]
    assert row_lw == lw and hi > lo
    return px[lo:hi], pinit[lo:hi], lw


# ------------------------------------------------------------------ (a)


def _chain_walk(t, chain, x, init, r_iw: int, lw: int):
    """(fin_pos, fin_ow) of K8's walk, replayed: a start's base from its
    state record, then one chained record a step, whose owner decides the
    hit and which carries the next state, its finality and its base; the
    Moore Ow from the state record of the deepest final."""
    B, M = x.shape
    n_states, n_slots = t.state_rec.shape[0], chain.shape[0]
    pos = torch.arange(M, dtype=torch.int32)
    xp = torch.cat([x, torch.full((B, lw + 1), -1, dtype=torch.int32)], 1)
    st = torch.where((x >= 0) & (x != r_iw), init, -1)
    base = torch.where(st >= 0, t.state_rec[st.clamp(0, n_states - 1)
                                            .long(), 0], 0)
    empty = torch.tensor([-1, -1, 0, 0], dtype=torch.int32)
    fin_pos = torch.full((B, M), -1, dtype=torch.int32)
    last = torch.full((B, M), -1, dtype=torch.int32)
    for d in range(lw):
        c = xp[:, d : d + M]
        raw = base.long() + c.long()
        inside = (st >= 0) & (c >= 0) & (raw >= 0) & (raw < n_slots)
        rec = torch.where(inside[..., None],
                          chain[raw.clamp(0, n_slots - 1)], empty)
        hit = inside & (rec[..., 0] == st)
        ns = torch.where(hit, rec[..., 1], -1)
        fin = hit & (rec[..., 3] != 0)
        base = rec[..., 2]
        if d >= t.max_token_length:
            ns = torch.where(c == r_iw, ns, -1)
        f = (ns >= 0) & fin
        fin_pos = torch.where(f, pos + d, fin_pos)
        last = torch.where(f, ns, last)
        st = ns
    fin_ow = torch.where(last >= 0, t.state_rec[last.clamp(0, n_states - 1)
                                                .long(), 2], -1)
    return fin_pos, fin_ow


@pytest.mark.parametrize("kind", ["bert", "mbert"])
def test_chain_records_match_the_comb_arrays(kind):
    h = _port(kind)
    comb = h.comb
    owner, nxt = np.asarray(comb.owner), np.asarray(comb.nxt)
    base, final = np.asarray(comb.base), np.asarray(comb.final, bool)
    rec = h.tables.chain.numpy()
    assert rec.shape == (comb.n_slots, 4) and rec.dtype == np.int32
    n_empty = n_dead = 0
    for s in range(comb.n_slots):
        o, n = int(owner[s]), int(nxt[s])
        if o < 0:
            want = (-1, -1, 0, 0)
            n_empty += 1
        elif n < 0:
            want = (o, -1, 0, 0)
            n_dead += 1
        else:
            want = (o, n, int(base[n]), int(final[n]))
        assert tuple(rec[s]) == want, s
    assert n_empty > 0 and n_empty + n_dead < comb.n_slots
    # the records are built at their first use: never for the dense pass
    d = _port(kind, comb=False)
    assert h._dense is None and d._dense is not None
    assert "chain" not in vars(d.tables)


@pytest.mark.parametrize("cls", [0, 1], ids=["lw18", "lw42"])
@pytest.mark.parametrize("which", ["dispatch", "edge", "gate"])
def test_chain_walk_replay_matches_the_plain_walk(which, cls):
    """K8's step, replayed on the records, equals the plain five-gather
    walk: on the fixture's dispatch rows, on the edge rows (symbols below
    the FnTokWord state's negative base, unknown symbols, anchors alone)
    and with the token-length gate cut to 3."""
    h = _port()
    t = h.tables
    if which == "gate":
        t = dataclasses.replace(t, max_token_length=3)
    x, init, lw = _rows("edge" if which == "edge" else "dispatch", cls)
    x, init = torch.from_numpy(x), torch.from_numpy(init)
    got = _chain_walk(t, h.tables.chain, x, init, h._r_iw, lw)
    want = lexer._walk_comb_plain(t, x, init, h._r_iw, lw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[0] >= 0).any()
    ini = int(h._fn2ini[testing.BERT_FN])
    assert int(t.base[ini]) < 0  # a start below slot 0 is possible


# ------------------------------------------------------------------ (b)


def _jax_comb(x, init, lw):
    j = _jax()
    return np.asarray(jax_lexer.wp_subword_pass(
        j.tables, jnp.asarray(x), jnp.asarray(init), jnp.int32(j._l_iw),
        jnp.int32(j._r_iw), lw))


def _clamp_false_hits(t, x, init, r_iw: int, lw: int) -> np.ndarray:
    """bool (B,): rows where JAX's comb walk takes a transition through a
    slot below 0 (clamped to slot 0), replayed on the port's walk: both
    agree up to it (tests/test_torch_lexer.py::_jax_divergence)."""
    s0 = int(t.owner[0])
    b0 = int(t.base[s0])
    x, init = torch.from_numpy(x), torch.from_numpy(init)
    B, M = x.shape
    xp = torch.cat([x, torch.full((B, lw + 1), -1, dtype=torch.int32)], 1)
    state = torch.where((x >= 0) & (x != r_iw), init, -1)
    hit = torch.zeros(B, dtype=torch.bool)
    for d in range(lw):
        c = xp[:, d : d + M]
        gated = (d >= t.max_token_length) & (c != r_iw)
        hit |= ((state == s0) & (c >= 0) & (b0 + c < 0) & ~gated).any(1)
        state = torch.where(gated, -1, lexer.comb_lookup(t, state, c)[0])
    return hit.numpy()


@pytest.mark.parametrize("cls", [0, 1], ids=["lw18", "lw42"])
@pytest.mark.parametrize("which", ["dispatch", "edge"])
def test_comb_pass_matches_jax(which, cls):
    h, d = _port(), _port(comb=False)
    x, init, lw = _rows(which, cls)
    got = lexer.wp_subword_pass(h.tables, torch.from_numpy(x),
                                torch.from_numpy(init), h._l_iw, h._r_iw,
                                lw).numpy()
    fh = _clamp_false_hits(h.tables, x, init, h._r_iw, lw)
    np.testing.assert_array_equal(got[~fh], _jax_comb(x, init, lw)[~fh])
    assert fh.any() == (which == "edge")
    # the dense walk has no clamp: both passes find the same matches
    dx, dinit, _lw = _rows(which, cls, comb=False)
    dnext, ow_perm, _p, n_f, _n = d._dense
    np.testing.assert_array_equal(got, lexer.wp_subword_pass_dense(
        d.tables, dnext, ow_perm, torch.from_numpy(dx),
        torch.from_numpy(dinit), d._l_iw, d._r_iw, lw, n_f,
        d._n_iws).numpy())
    assert got[:, 128].sum() > 0


# ------------------------------------------------------------------ (c)


def test_encode_corpus_flat_comb_matches_jax_and_oracle():
    docs = _docs()
    h = _port()
    c = metrics.Counters()
    ids, bounds = h.encode_corpus_flat(docs, unk_id=UNK, batch_docs=200,
                                       counters=c)
    jids, jbounds = _jax().encode_corpus_flat(docs, unk_id=UNK,
                                              batch_docs=200)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(bounds, jbounds)
    assert c.batches >= 2 and c.dispatched_rows > 0
    oracle = LexerOracleApi(h.model)
    for i, d in enumerate(docs):
        assert ids[bounds[i] : bounds[i + 1]].tolist() == oracle.text_to_ids(
            d, unk_id=UNK), (i, d[:40])
    # the ideographs were walked: ids of their single-character entries,
    # and [UNK] for those outside the alphabet
    vocab = testing.mbert_shaped_vocab(N_SMALL)
    cjk_ids = {vocab.index(chr(c)) for c in _cjk()[:200] if chr(c) in vocab}
    assert len(cjk_ids & set(ids.tolist())) > 50 and (ids == UNK).any()


# ------------------------------------------------------------------ (d)


def test_full_size_vocab_layout():
    lines = testing.mbert_shaped_vocab()
    assert len(lines) == testing.MBERT_VOCAB == 119547
    assert len(set(lines)) == len(lines)
    assert lines[0] == "[PAD]" and lines[1:100] == [
        f"[unused{i}]" for i in range(1, 100)]
    assert lines[100:104] == ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    alphabet = testing.mbert_alphabet()
    assert max(alphabet) < 0x10000
    assert sum(0x4E00 <= c < 0xA000 for c in alphabet) >= testing.MBERT_CJK
    assert set(testing._bert_alphabet()) <= set(alphabet)
    k = len(alphabet)
    assert lines[104 : 104 + k] == [chr(c) for c in alphabet]
    assert lines[104 + k : 104 + 2 * k] == ["##" + chr(c) for c in alphabet]
    words = [w.decode() for w in testing.word_list(0, testing.MBERT_WORDS)]
    whole = set(lines[104 + 2 * k :])
    assert all(w in whole for w in words[: testing.MBERT_WHOLE_WORDS])
    # the small fixture is the full vocabulary's first lines in its layout
    assert testing.mbert_shaped_vocab(N_SMALL) == lines[:N_SMALL]
