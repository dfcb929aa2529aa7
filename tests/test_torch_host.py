"""The port's classic doc-row path (blingfire_tpu_torch/runtime/host.py)
against the JAX package's: the host prep (decode_utf8, prepare_sp_doc, the
native prep_sp_batch), encode_corpus, encode_corpus_flat and encode_batch on
models that are not chunk-safe (a SentencePiece-BPE-shaped merges model in
the comb and trie table modes, a unigram model), encode_batch without dedup
on the gpt2-shaped model (long documents chunked), the fallback
documents through the native runtime, and K2's launch limits at a window
of 2,048 symbols.  Ids compare exactly."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from corpus import full_corpus

import blingfire_tpu.ops.tables as jax_tables
from blingfire_tpu import native as jax_native
from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.runtime import host as jax_host
from blingfire_tpu_torch import native, testing
from blingfire_tpu_torch.compiler.dict import (DictModelSpec, VocabEntry,
                                               compile_dict_model)
from blingfire_tpu_torch.formats.consts import TokAlgo
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import bpe
from blingfire_tpu_torch.runtime import host, metrics
from blingfire_tpu_torch.runtime.host import SpTokenizer

N = 128
ODD_DOCS = [b"", b"\xff", b"ab\xc3", b"\xed\xa0\x80", b"\xc0\xaf x",
            b"\xef\xbb\xbfhello world", b"\xef\xbb\xbf", b"   ", b"a\x00b",
            b"word " * 100, b"ab" * 150, "ﬁ ﬂ Ｆｕｌｌ".encode()]


@functools.lru_cache(maxsize=1)
def _docs() -> tuple[bytes, ...]:
    """tests/corpus.py, odd inputs, and documents of the corpus's frequent
    words (pair pieces, and documents past the 128-symbol window)."""
    zipf = testing.zipf_corpus(60_000)[len(testing.EDGE_CASES):][:120]
    return tuple([d.encode("utf-8") for d in full_corpus(n_random=120)]
                 + ODD_DOCS + zipf)


@functools.lru_cache(maxsize=None)
def _blob(kind: str) -> bytes:
    if kind == "spm":
        return testing.spm_bpe_shaped_model_bytes(2000, n_cjk=20, n_pairs=40)
    if kind == "gpt2":
        return testing.gpt2_shaped_model_bytes(2000, n_long=40)
    if kind == "xlnet":
        return testing.xlnet_shaped_model_bytes(4000, n_cjk=100)
    # a unigram model with a piece that has an internal ▁
    entries = testing.xlnet_shaped_entries(2000, n_cjk=20)
    entries.append(VocabEntry((0x61, 0x2581, 0x62), 3 + len(entries), -20.0))
    return compile_dict_model(DictModelSpec(
        entries=entries, tok_algo=TokAlgo.DEFAULT,
        charmap=testing.xlnet_charmap()))


def _pair(kind: str, monkeypatch=None, comb: bool = False):
    """The port's and the JAX package's SpTokenizer of one model; ``comb``
    declines the vocabulary trie on both sides (JAX reads
    ops.tables.build_trie_table_cached at call time, host.py:206-208)."""
    blob = _blob(kind)
    if comb:
        monkeypatch.setattr(host, "build_trie_table_cached", lambda *a: None)
        monkeypatch.setattr(jax_tables, "build_trie_table_cached",
                            lambda *a: None)
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=N, device="cpu")
    jtok = jax_host.SpTokenizer(jax_load_bytes(blob), max_doc_symbols=N)
    assert (tok.tables.trie_next is None) == comb if tok.is_bpe else True
    return tok, jtok


@pytest.mark.parametrize("kind", ["gpt2", "spm"])
def test_host_prep_matches_jax(kind):
    """decode_utf8, prepare_sp_doc, the native prep_sp_batch binding and
    both branches of _prep_batch, byte mode and char mode with a charmap."""
    tok, jtok = _pair(kind)
    docs = list(_docs())
    seg, jseg = tok.seg, jtok.seg
    for d in docs:
        a, b = host.decode_utf8(d), jax_host.decode_utf8(d)
        assert (a is None) == (b is None)
        if a is not None:
            assert all(np.array_equal(u, v) for u, v in zip(a, b))
        p, q = host.prepare_sp_doc(d, seg), jax_host.prepare_sp_doc(d, jseg)
        assert p.ok == q.ok and np.array_equal(p.syms, q.syms)
        assert np.array_equal(p.offs, q.offs)
    args = (docs, N, tok._sym2iw, seg.use_raw_bytes, seg.no_dummy_prefix,
            seg.charmap)
    x, spm, ln, status = native.prep_sp_batch(*args)
    jx, jspm, jln, _off, jstatus = jax_native.prep_sp_batch(
        docs, N, jtok._sym2iw, jseg.use_raw_bytes, jseg.no_dummy_prefix,
        jseg.charmap)
    for a, b in ((x, jx), (spm, jspm), (ln, jln), (status, jstatus)):
        np.testing.assert_array_equal(a, b)
    assert {0, 1, 2} <= set(status.tolist())
    nat, npy = tok._prep_batch(docs), tok._prep_batch(docs, force_numpy=True)
    for a, b in zip(nat, npy):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(nat[2], status)


@pytest.mark.parametrize("kind,comb", [("spm", True), ("spm", False),
                                       ("unigram", False)],
                         ids=["spm-comb", "spm-trie", "unigram"])
def test_classic_path_matches_jax(monkeypatch, kind, comb):
    """encode_corpus_flat, encode_corpus and encode_batch of a model that is
    not chunk-safe, against JAX's encode_corpus and encode_batch.  The
    port splits documents past the window at a ▁ that no match crosses,
    where JAX sends them to its host path; both give the reference's ids.
    JAX's comb clamp finds no text here: the seeded root has base 0."""
    tok, jtok = _pair(kind, monkeypatch, comb)
    assert not tok._chunk_safe and not tok._native_units_ok()
    if tok.is_bpe:
        assert bpe.rank_mode(tok.tables)
        assert int(tok.comb.base[int(tok.comb.owner[0])]) >= 0
    docs = list(_docs())
    want = jtok.encode_corpus(docs, batch_docs=64)
    c = metrics.Counters()
    ids, bounds = tok.encode_corpus_flat(docs, batch_docs=50, counters=c)
    assert ids.dtype == np.int32 and bounds.dtype == np.int64
    assert [ids[bounds[i]:bounds[i + 1]].tolist()
            for i in range(len(docs))] == want
    assert c.batches > 1 and c.docs_in == len(docs) and c.oracle_docs == 0
    assert c.chunked_docs > 0 and c.fallback_docs > 0
    assert c.tokens_out == len(ids)
    # invalid UTF-8 counts as invalid, as empty documents do
    status = tok._prep_batch(docs)[2]
    assert c.invalid_docs == int((status == 1).sum())
    assert c.invalid_docs > sum(1 for d in docs if not d)
    assert tok.encode_corpus(docs, batch_docs=64) == want
    assert tok.encode_batch(docs) == want
    assert jtok.encode_batch(docs[:60]) == want[:60]


def test_encode_batch_without_dedup_chunks_long_documents():
    """gpt2-shaped (chunk-safe) with dedup=False: the classic rows, and
    documents past the window split at every ▁ (_encode_overflow), against
    JAX's; the unit path gives the same ids."""
    tok, jtok = _pair("gpt2")
    docs = list(_docs())
    c = metrics.global_counters()
    before = c.chunked_docs
    got = tok.encode_batch(docs, dedup=False)
    assert c.chunked_docs > before
    assert got == jtok.encode_batch(docs, dedup=False)
    assert got == tok.encode_batch(docs)
    over = [d for d in docs if len(d) > 2 * N]
    assert tok._encode_overflow(over, 0) == jtok._encode_overflow(over, 0)


@pytest.mark.parametrize("kind", ["gpt2", "xlnet"])
def test_fallback_ids_through_the_native_runtime(kind):
    """The documents each seeded model's unit path flags go to the native
    TextToIds, whose ids equal the scalar oracle's."""
    tok, _jtok = _pair(kind)
    docs = list(_docs()) + [b"see " + bytes([ch]) * k + b" end"
                            for ch in testing.LONG_CHARS[:3] for k in (40, 200)]
    _ids, _b, need, _st = tok._unit_runner().encode_docs(docs, 0)
    fb = [d for d, n in zip(docs, need) if n and d]
    assert len(fb) >= 3
    c = metrics.Counters()
    for d in fb:
        assert tok._fallback_ids(d, 0, c) == tok._oracle.text_to_ids(d)
        assert tok._fallback_ids(d, 5, c) == tok._oracle.text_to_ids(d, unk_id=5)
    assert c.oracle_docs == 0


def test_model_without_spm_in_its_alphabet():
    """No piece holds ▁: raw ▁ has no input weight, and the rows take a ▁
    weight no symbol has; JAX marks raw ▁ there, which changes no id."""
    a, b, c = 0x61, 0x62, 0x63
    vocab = [(a,), (b,), (c,), (a, b), (b, c), (a, b, c), (c, a)]
    blob = compile_dict_model(DictModelSpec(
        entries=[VocabEntry(ch, 3 + i, -float(i + 1)) for i, ch in enumerate(vocab)],
        tok_algo=TokAlgo.BPE_OPT_WITH_MERGES, id_offset=0,
        use_byte_encoding=False))
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=N, device="cpu")
    jtok = jax_host.SpTokenizer(jax_load_bytes(blob), max_doc_symbols=N)
    assert tok._spm_iw == tok.comb.n_iws and tok.tables.prio2id is not None
    docs = [b"abc", b"ab ca", b"a b c", b" abcab ", b"cab bc", b"xx ab"]
    want = jtok.encode_batch(docs)
    assert tok.encode_batch(docs) == want
    assert want == [tok._oracle.text_to_ids(d) for d in docs]


@functools.lru_cache(maxsize=None)
def jax_wide(kind: str):
    """The JAX package's encode_corpus of ``wide_window_docs`` at a window of
    2,048 symbols (rows 2,048 wide, a_max 8,192; seconds on the CPU)."""
    jtok = jax_host.SpTokenizer(jax_load_bytes(_blob(kind)),
                                max_doc_symbols=2048)
    docs = testing.wide_window_docs()
    return jtok.encode_corpus(docs, batch_docs=len(docs))


@pytest.mark.parametrize("kind", ["gpt2", "spm"])
def test_k2_launches_stay_inside_their_limits(monkeypatch, kind):
    """At max_doc_symbols=2048 every K2 launch keeps N <= 1024 and a_max <=
    4096 (before, the classic rows went 2,048 wide with a_max 8,192, which
    the kernel refuses): BPE documents past 1,024 symbols take chunk rows,
    and a row with more arcs is flagged and goes to the native runtime.
    The ids equal the native runtime's TextToIds and JAX's same call."""
    seen = []
    orig = bpe.bpe_resolve

    def record(tables, m_pack, *args):
        seen.append((m_pack.shape[2], args[-1]))
        return orig(tables, m_pack, *args)

    monkeypatch.setattr(bpe, "bpe_resolve", record)
    tok = SpTokenizer(load_bytes(_blob(kind)), max_doc_symbols=2048,
                      device="cpu")
    assert tok.row_max == bpe.RESOLVE_MAX_N and tok.a_max == 8192
    docs = testing.wide_window_docs()
    lens = tok._prep_batch(docs)[1]
    assert ((lens > 1024) & (lens <= 2048)).sum() >= 3
    assert (tok._prep_batch(docs)[2] == 2).any()
    c = metrics.Counters()
    ids, bounds = tok.encode_corpus_flat(docs, batch_docs=16, counters=c)
    got = [ids[bounds[i]:bounds[i + 1]].tolist() for i in range(len(docs))]
    classic = tok.encode_batch(docs, dedup=False)
    assert seen and max(n for n, _a in seen) == bpe.RESOLVE_MAX_N
    assert all(n <= bpe.RESOLVE_MAX_N and a <= bpe.RESOLVE_MAX_ARCS
               for n, a in seen), sorted(set(seen))
    assert c.chunked_docs > 0 and c.oracle_docs == 0
    assert got == [tok._fallback_ids(d, 0) for d in docs]
    assert classic == got
    assert got == jax_wide(kind)
