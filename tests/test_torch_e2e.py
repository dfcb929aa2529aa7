"""The port's corpus path, SpTokenizer(..., device="cpu").encode_corpus_flat,
against the JAX package's on tests/corpus.py::full_corpus(), for a
gpt2-shaped byte-BPE model and an xlnet-shaped unigram-LM model, and for two
models off the unit path: ids and bounds must be identical.  A small batch_docs makes several batches share
the unit cache, and some documents fall back to the host path."""

from __future__ import annotations

import numpy as np
import pytest

from corpus import full_corpus

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.runtime.host import SpTokenizer as JaxSpTokenizer
from blingfire_tpu_torch import testing
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.runtime import metrics
from blingfire_tpu_torch.runtime.host import (SpTokenizer, run_pipeline,
                                              splice_docs)


def _docs():
    return [d.encode("utf-8") for d in full_corpus()] + [
        b"see " + bytes([c]) * k + b" end" for c in testing.LONG_CHARS[:3]
        for k in (18, 40, 200)]


def test_encode_corpus_flat_matches_jax():
    blob = testing.gpt2_shaped_model_bytes(2000, n_long=40)
    docs = _docs()
    c = metrics.Counters()
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=128, device="cpu")
    ids, bounds = tok.encode_corpus_flat(docs, batch_docs=64, counters=c)
    jtok = JaxSpTokenizer(jax_load_bytes(blob), max_doc_symbols=128)
    jids, jbounds = jtok.encode_corpus_flat(docs, batch_docs=64)
    assert ids.dtype == np.int32 and bounds.dtype == np.int64
    np.testing.assert_array_equal(bounds, np.asarray(jbounds))
    np.testing.assert_array_equal(ids, np.asarray(jids))
    assert c.batches > 1 and c.fallback_docs > 0 and c.cache_units > 0
    assert c.tokens_out == len(ids) and c.docs_in == len(docs)
    # encode_batch is the same path for one batch
    some = docs[:40]
    got = tok.encode_batch(some)
    assert got == [ids[bounds[i]:bounds[i + 1]].tolist() for i in range(40)]


def test_unigram_encode_corpus_flat_matches_jax():
    blob = testing.xlnet_shaped_model_bytes(4000, n_cjk=100)
    docs = _docs()
    c = metrics.Counters()
    tok = SpTokenizer(load_bytes(blob), max_doc_symbols=128, device="cpu")
    assert not tok.is_bpe and tok._chunk_safe
    ids, bounds = tok.encode_corpus_flat(docs, batch_docs=64, counters=c)
    jtok = JaxSpTokenizer(jax_load_bytes(blob), max_doc_symbols=128)
    jids, jbounds = jtok.encode_corpus_flat(docs, batch_docs=64)
    assert ids.dtype == np.int32 and bounds.dtype == np.int64
    np.testing.assert_array_equal(bounds, np.asarray(jbounds))
    np.testing.assert_array_equal(ids, np.asarray(jids))
    assert c.batches > 1 and c.fallback_docs > 0 and c.cache_units > 0
    assert (ids == 0).any(), "emoji should give unknown tokens"
    got = tok.encode_batch(docs[:40])
    assert got == [ids[bounds[i]:bounds[i + 1]].tolist() for i in range(40)]


def test_models_off_the_unit_path_match_jax():
    """Models that are not chunk-safe take the classic doc rows; they raised
    before PR 6.  Their encode_corpus_flat equals JAX's."""
    from blingfire_tpu_torch.compiler.dict import (
        DictModelSpec, VocabEntry, compile_dict_model)
    from blingfire_tpu_torch.formats.consts import TokAlgo

    # a piece with an internal ▁: not chunk-safe, so no unit path
    entries = testing.gpt2_shaped_entries(600, n_long=10)
    entries.append(VocabEntry((0x61, 0x2581, 0x62), len(entries) + 1,
                              -float(len(entries) + 1)))
    blob = compile_dict_model(DictModelSpec(
        entries=entries, tok_algo=TokAlgo.BPE_OPT, id_offset=-1,
        use_byte_encoding=True))
    # the same for a unigram model
    entries = testing.xlnet_shaped_entries(2000, n_cjk=20)
    entries.append(VocabEntry((0x61, 0x2581, 0x62), 3 + len(entries), -20.0))
    uni = compile_dict_model(DictModelSpec(
        entries=entries, tok_algo=TokAlgo.DEFAULT,
        charmap=testing.xlnet_charmap()))
    docs = _docs() + [b"a b a ba b", b"xa bx " * 40]
    for model, is_bpe in ((blob, True), (uni, False)):
        tok = SpTokenizer(load_bytes(model), max_doc_symbols=128, device="cpu")
        assert tok.is_bpe == is_bpe and not tok._chunk_safe
        ids, bounds = tok.encode_corpus_flat(docs, batch_docs=64)
        jtok = JaxSpTokenizer(jax_load_bytes(model), max_doc_symbols=128)
        jids, jbounds = jtok.encode_corpus_flat(docs, batch_docs=64)
        np.testing.assert_array_equal(bounds, np.asarray(jbounds))
        np.testing.assert_array_equal(ids, np.asarray(jids))


@pytest.mark.parametrize("n_docs", [0, 1, 7, 40])
def test_run_pipeline_joins_batches_in_order(n_docs):
    """The batch pipeline both entry points share: every batch dispatched
    and collected once, in order, with up to three in flight, and the parts
    joined into one flat (ids, bounds)."""
    docs = [bytes(range(97, 97 + i % 5)) for i in range(n_docs)]
    flights, events = [], []

    def dispatch(chunk):
        flights.append(len(flights) - sum(e == "c" for e in events))
        events.append("d")
        return chunk, len(chunk)

    def collect(chunk, state):
        assert state is chunk
        events.append("c")
        ids = np.frombuffer(b"".join(chunk), np.uint8).astype(np.int32)
        return ids, np.concatenate([[0], np.cumsum([len(d) for d in chunk])])

    c = metrics.Counters()
    ids, bounds = run_pipeline(docs, 3, dispatch, collect, c)
    want = [list(d) for d in docs]
    assert [ids[bounds[i] : bounds[i + 1]].tolist() for i in range(n_docs)] == want
    assert ids.dtype == np.int32 and bounds.tolist()[:1] == [0]
    assert len(bounds) == n_docs + 1 and c.tokens_out == len(ids)
    assert c.batches == events.count("c") == -(-n_docs // 3)
    assert c.docs_in == c.dispatched_rows == n_docs and max(flights + [0]) <= 2


def test_splice_docs_replaces_spans():
    ids = np.arange(10, dtype=np.int32)
    bounds = np.array([0, 2, 2, 5, 10])
    out, nb = splice_docs(ids, bounds, {0: [7], 2: [], 3: [1, 2, 3, 4, 5, 6]})
    assert [out[nb[i] : nb[i + 1]].tolist() for i in range(4)] == [
        [7], [], [], [1, 2, 3, 4, 5, 6]]
    out, nb = splice_docs(ids, bounds, {1: [9, 9]})
    assert out.tolist() == [0, 1, 9, 9, 2, 3, 4, 5, 6, 7, 8, 9]
