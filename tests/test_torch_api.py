"""The port's product API (api.py), its drop-in layer (compat.py) and
profile_trace against the JAX package's on the CPU, on seeded models at small widths (gpt2-, xlnet-, spm-BPE- and
bert-shaped at about 2,000 entries, a syllab-shaped W2H model of 2,000
patterns) and the shipped wbd and sbd.  Ids, strings, offsets and hashes
compare with tolerance 0, with the native runtime and with BTL_NATIVE=0.

The top-level entry points (entry.py) have their own file,
tests/test_torch_entry.py.  The port's batch calls run with ``device="cpu"`` (the kernels' plain
versions); they are held to the JAX API's scalar route
(``use_device=False``: the native runtime, or the scalar engines under
BTL_NATIVE=0), which follows the reference where the JAX device walks do
not (ROADMAP.md section C: the rank-fault model, the slot-0 hyphenation
model, sbd document 107, the bert-shaped ``b"hello world"``).  The port's
kernels are held to JAX's device programs in the other test_torch_* files.
The module runs on one torch intra-op thread (``test_torch_bpe._one_thread``):
beside the suite's other workers, the plain versions' small torch ops
only contend for the cores with more."""

from __future__ import annotations

import ctypes
import glob
import json

import numpy as np
import pytest
import torch

from corpus import full_corpus
from test_torch_bpe import _one_thread  # noqa: F401  (one intra-op thread)

from blingfire_tpu import api as japi
from blingfire_tpu import compat as jcompat
from blingfire_tpu_torch import api, compat, native, testing
from blingfire_tpu_torch.compiler.dict import compile_i2w_model
from blingfire_tpu_torch.formats.consts import NormAlgo
from blingfire_tpu_torch.runtime import metrics
from blingfire_tpu_torch.runtime.lexer_host import WordPieceTpu
from blingfire_tpu_torch.runtime.wp_hybrid import WordPieceHybrid

UNK = {"bert": testing.BERT_UNK}
ID_KINDS = ["gpt2", "xlnet", "spm", "bert"]
WINDOW = 128  # the port's SpTokenizer window here (device_opts)
# sbd document 107 of tests/corpus.py::full_corpus(n_random=60): the JAX
# device lexer breaks a sentence after '."' there (ROADMAP.md C item 1)
DOC_107 = full_corpus(n_random=60)[107]


def _docs() -> list[bytes]:
    zipf = testing.zipf_corpus(40_000)[len(testing.EDGE_CASES):][:12]
    return ([d.encode("utf-8") for d in full_corpus(n_random=24)] + zipf
            + [b"", b"\xff\xfe bad", b"a\x00b c", b"x" * 400,
               b"hello world", b"see " + b"-" * 40 + b" end",
               DOC_107.encode("utf-8")])


DOCS = _docs()


def _i2w_blob(n: int) -> bytes:
    """An [i2w] section for the gpt2-shaped model of ``n`` entries: id k
    (entry k + 1, id offset -1) spells the entry's bytes, ▁ as a space;
    ids above n - 6 are special."""
    strings = [bytes(0x20 if c == testing.SPM else c for c in e.chain)
               for e in testing.gpt2_shaped_entries(n, n_long=40)]
    return compile_i2w_model(strings, token_id_min=0, token_id_max=n - 6)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("api_models")
    blobs = {
        "gpt2": testing.gpt2_shaped_model_bytes(2000, n_long=40),
        "gpt2_i2w": _i2w_blob(2000),
        "xlnet": testing.xlnet_shaped_model_bytes(2000, n_cjk=60),
        "spm": testing.spm_bpe_shaped_model_bytes(2000, n_cjk=60,
                                                  n_pairs=40),
        "bert": testing.bert_shaped_model_bytes(2000),
        "syllab": testing.syllab_shaped_model_bytes(2000),
        "slot0": testing.hyph_slot0_model_bytes(),
        "rank_fault": testing.rank_fault_model_bytes(),
        "wbd": testing.shipped_lexer_bytes("wbd"),
        "sbd": testing.shipped_lexer_bytes("sbd"),
    }
    blobs["not_i2w"] = blobs["wbd"]
    out = {}
    for k, blob in blobs.items():
        p = d / (f"{k}.bin" if "i2w" not in k else f"{k}.i2w")
        p.write_bytes(blob)
        out[k] = str(p)
    return out


@pytest.fixture(params=["native", "scalar"])
def mode(request, monkeypatch):
    """The native runtime, or BTL_NATIVE=0 (the scalar engines)."""
    if request.param == "scalar":
        monkeypatch.setenv("BTL_NATIVE", "0")
    else:
        monkeypatch.delenv("BTL_NATIVE", raising=False)
    return request.param


def _pair(paths, kind, **kw):
    """(port handle on the CPU, JAX handle on its scalar route)."""
    i2w = kw.pop("i2w", None)
    return (api.load_model(paths[kind], i2w, device="cpu",
                           max_doc_symbols=WINDOW, **kw),
            japi.load_model(paths[kind], i2w, use_device=False))


@pytest.mark.parametrize("kind", ID_KINDS)
def test_text_to_ids_and_offsets(kind, mode, paths):
    port, jax = _pair(paths, kind)
    unk = UNK.get(kind, 0)
    for d in DOCS:
        for max_len in (None, 8):
            assert (port.text_to_ids(d, max_len, unk)
                    == jax.text_to_ids(d, max_len, unk)), (d, max_len)
            assert (port.text_to_ids_with_offsets(d, max_len, unk)
                    == jax.text_to_ids_with_offsets(d, max_len, unk)), d
    assert port.text_to_ids("Hello world") == jax.text_to_ids("Hello world")


@pytest.mark.parametrize("kind", ID_KINDS + ["rank_fault", "wbd"])
def test_text_to_ids_batch(kind, paths, monkeypatch):
    """The port's batch on the CPU (SpTokenizer, WordPieceHybrid or
    WordPieceTpu) against the JAX API's scalar route and, where the JAX
    device walks diverge (rank_fault, bert's b"hello world"), the native
    runtime and the scalar oracle alike."""
    port, jax = _pair(paths, kind)
    unk = UNK.get(kind, 0)
    docs = DOCS + [b"aqq b", b"b aqqq", b"baqqb"]
    got = port.text_to_ids_batch(docs, unk_id=unk)
    assert got == jax.text_to_ids_batch(docs, unk_id=unk)
    assert got == [jax.text_to_ids(d, unk_id=unk) for d in docs]
    monkeypatch.setenv("BTL_NATIVE", "0")  # the scalar engines
    scalar = api.load_model(paths[kind], use_device=False)
    assert got[-3:] == [scalar.text_to_ids(d, unk_id=unk) for d in docs[-3:]]
    assert sum(map(len, got)) > len(docs)
    if kind == "rank_fault":
        assert got[-3:] == [[7, 0, 3, 5], [3, 5, 7, 0], [3, 5, 4, 0, 5]]
    if kind == "bert":
        assert got[DOCS.index(b"hello world")] == [175, 403, 410, 410, 413,
                                                   190, 413, 416, 410, 402]


def test_wordpiece_batch_routes(paths, monkeypatch):
    """The hybrid's precondition decides the route: a model with the iw map
    that is pack-safe runs the hybrid; one that is not pack-safe (the
    shipped wbd) runs WordPieceTpu; one without the map never builds the
    hybrid.  Any other error of the hybrid propagates (no fallback)."""
    port, _ = _pair(paths, "bert")
    assert isinstance(port._device_wp(), WordPieceHybrid)
    port, _ = _pair(paths, "wbd")
    assert isinstance(port._device_wp(), WordPieceTpu)
    monkeypatch.setattr(WordPieceHybrid, "available", lambda self: False)
    port, jax = _pair(paths, "bert")
    got = port.text_to_ids_batch(DOCS, unk_id=100)
    assert isinstance(port._wp_dev, WordPieceTpu)
    assert got == jax.text_to_ids_batch(DOCS, unk_id=100)
    monkeypatch.undo()
    built = []
    monkeypatch.setattr(WordPieceHybrid, "__init__",
                        lambda *a, **k: built.append(a))
    port, _ = _pair(paths, "bert")
    port.model.wbd.aut.iw2iw = None
    with pytest.raises(ValueError, match="iw-remapped"):
        port._device_wp()  # WordPieceTpu's own check
    assert not built
    monkeypatch.undo()

    def boom(self):
        raise RuntimeError("pack-safety check failed")

    monkeypatch.setattr(WordPieceHybrid, "_fn_pack_safe", boom)
    port, _ = _pair(paths, "bert")
    with pytest.raises(RuntimeError, match="pack-safety"):
        port.text_to_ids_batch([b"hello world"], unk_id=100)


def test_native_build_failure_raises(paths, monkeypatch):
    """A failed build of the native runtime raises (the JAX API drops to the
    scalar engines instead); BTL_NATIVE=0 is the one way to ask for them."""
    def fail():
        raise RuntimeError("make failed")

    monkeypatch.delenv("BTL_NATIVE", raising=False)
    monkeypatch.setattr(native, "get_runtime", fail)
    port, _ = _pair(paths, "gpt2")
    with pytest.raises(RuntimeError, match="make failed"):
        port.text_to_ids("Hello world")
    monkeypatch.setenv("BTL_NATIVE", "0")
    port, jax = _pair(paths, "gpt2")
    assert port.text_to_ids("Hello world") == jax.text_to_ids("Hello world")


def test_batch_calls_need_the_card_by_default(paths):
    """The default device is the card: single-string calls run without
    one, a batch call on a machine without CUDA raises."""
    port = api.load_model(paths["gpt2"], max_doc_symbols=WINDOW)
    assert port._device == "cuda"
    assert port.text_to_ids("Hello") == japi.load_model(
        paths["gpt2"]).text_to_ids("Hello")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            port.text_to_ids_batch(["Hello world"])


def test_words_and_sentences(mode, paths):
    for kind in ("wbd", "sbd"):
        port, jax = _pair(paths, kind)
        for d in DOCS:
            for meth in ("text_to_words", "text_to_sentences",
                         "text_to_words_with_offsets",
                         "text_to_sentences_with_offsets"):
                assert getattr(port, meth)(d) == getattr(jax, meth)(d), (
                    kind, meth, d)
        # the batch forms: native, or (BTL_NATIVE=0) the card's lexer
        # (WordsTpu on the CPU) against the JAX scalar engine
        words = port.text_to_words_batch(DOCS)
        sents = port.text_to_sentences_batch(DOCS)
        assert words == jax.text_to_words_batch(DOCS)
        assert sents == jax.text_to_sentences_batch(DOCS)
        assert (port._words_dev is None) == (mode == "native")
    assert port.text_to_sentences(DOC_107).count("\n") == 0


def _hyph_words() -> list:
    words = ["".join(map(chr, w)) for w in testing.hyph_edge_words()]
    words += ["".join(map(chr, w)) for w in testing.corpus_words(DOCS[:30])]
    return words + ["hyph\x00enation", "x" * 400, "'ab", "'abab", b"\xff",
                    b"", "hyphenation" * 40]


@pytest.mark.parametrize("kind", ["syllab", "slot0"])
def test_word_hyphenation(kind, mode, paths):
    port, jax = _pair(paths, kind)
    for w in _hyph_words():
        for uhy in (0x2D, 0x2012):
            assert port.word_hyphenation(w, uhy) == jax.word_hyphenation(
                w, uhy), (w, uhy)
    if kind == "slot0":  # ROADMAP.md C item 2: no hyphen in 'ab
        assert port.word_hyphenation("'ab", 0x2D) == "'ab"


def test_ids_to_text(paths):
    port, jax = _pair(paths, "gpt2", i2w=paths["gpt2_i2w"])
    assert port.model.i2w is not None
    for d in DOCS:
        ids = port.text_to_ids(d)
        for skip in (True, False):
            assert port.ids_to_text(ids, skip) == jax.ids_to_text(ids, skip)
    specials = [1999, 5, 6, 1998]
    assert port.ids_to_text(specials) == jax.ids_to_text(specials)
    assert port.ids_to_text([5, 10 ** 6], False) is None
    assert jax.ids_to_text([5, 10 ** 6], False) is None
    port, jax = _pair(paths, "xlnet")  # no [i2w] section
    assert port.ids_to_text([5, 6]) is None and jax.ids_to_text([5, 6]) is None


@pytest.mark.parametrize("kind", ["gpt2", "xlnet"])
def test_set_no_dummy_prefix(kind, mode, paths, monkeypatch):
    """Every path of the port takes the setting, as the reference's
    SetNoDummyPrefix does; it is held to the JAX API's scalar engines.  The
    JAX API's native path keeps the model image's setting (ROADMAP.md C
    item 7)."""
    port = api.load_model(paths[kind], device="cpu", max_doc_symbols=WINDOW)
    monkeypatch.setenv("BTL_NATIVE", "0")
    oracle = japi.load_model(paths[kind], use_device=False)
    oracle.text_to_ids("")  # resolve its (absent) native runtime
    docs = DOCS[:40]
    for value in (True, False, True):
        port.set_no_dummy_prefix(value)
        oracle.set_no_dummy_prefix(value)
        want = [oracle.text_to_ids(d) for d in docs]
        assert [port.text_to_ids(d) for d in docs] == want, value
        assert port.text_to_ids_batch(docs) == want, value
        assert [port.text_to_ids_with_offsets(d) for d in docs] == [
            oracle.text_to_ids_with_offsets(d) for d in docs], value
    if mode == "native" and kind == "gpt2":
        monkeypatch.delenv("BTL_NATIVE")
        jnat = japi.load_model(paths[kind])
        jnat.set_no_dummy_prefix(True)
        assert jnat.text_to_ids("Hello") != port.text_to_ids("Hello")


def test_normalize_spaces_and_text():
    for d in DOCS + ["  a \t b　c  ", " ", " ", "x"]:
        for u in (0x20, 0x2581, 0x5F):
            assert api.normalize_spaces(d, u) == japi.normalize_spaces(d, u)
        for algo in NormAlgo:
            assert api.normalize_text(d, algo) == japi.normalize_text(
                d, int(algo)), (d, algo)
    rng = np.random.default_rng(1)
    cps = np.concatenate([np.arange(0, 0x3000),
                          rng.integers(0x3000, 0x110000, 4000)])
    for f in ("to_lower", "to_upper", "is_lower", "is_upper"):
        assert [getattr(api, f)(int(c)) for c in cps] == [
            getattr(japi, f)(int(c)) for c in cps], f


def test_text_to_hashes():
    """Bit for bit against the JAX function and the native runtime's
    TextToHashes, with bytes >= 0x80 (sign-extended) and int32 wrap."""
    rt = native.get_runtime()
    lines = ["This is ok .", "a b", "hello", "x " * 10, "naïve café ü",
             "\xffé \U0001f642 z", ""]
    lines += [" ".join(d.decode("utf-8", "replace").split()) for d in DOCS[:20]]
    for line in lines:
        for ngrams in (1, 2, 3):
            for bucket in (2_000_000, 97):
                got = api.text_to_hashes(line, ngrams, bucket)
                assert got == japi.text_to_hashes(line, ngrams, bucket)
                data = line.encode("utf-8")
                arr = np.zeros(4096, np.int32)
                n = rt.TextToHashes(data, len(data),
                                    arr.ctypes.data_as(ctypes.c_void_p),
                                    4096, ngrams, bucket)
                assert got == arr[:n].tolist(), (line, ngrams, bucket)
    assert api.EOS_HASH == japi._fnv_hash(b"</s>")
    assert api.get_version() == japi.get_version()


def test_compat(paths, monkeypatch):
    """Every function of compat.py against the JAX package's."""
    s = "Hello, world! Mr. Smith went to Washington. It's naïve."
    assert compat.get_blingfiretok_version() == jcompat.get_blingfiretok_version()
    for f in ("text_to_words", "text_to_sentences", "text_to_words_with_offsets",
              "text_to_sentences_and_offsets", "normalize_spaces"):
        for d in [s, "", "a  b", DOC_107]:
            assert getattr(compat, f)(d) == getattr(jcompat, f)(d), (f, d)
    assert compat.normalize_spaces(s, 0x2581) == jcompat.normalize_spaces(
        s, 0x2581)
    np.testing.assert_array_equal(compat.text_to_hashes(s, 2, 1000),
                                  jcompat.text_to_hashes(s, 2, 1000))
    wbd, jwbd = compat.load_model(paths["wbd"]), jcompat.load_model(paths["wbd"])
    sbd, jsbd = compat.load_model(paths["sbd"]), jcompat.load_model(paths["sbd"])
    assert (compat.text_to_words_with_model(wbd, s)
            == jcompat.text_to_words_with_model(jwbd, s))
    assert (compat.text_to_sentences_with_model(sbd, s)
            == jcompat.text_to_sentences_with_model(jsbd, s))
    syl, jsyl = compat.load_model(paths["syllab"]), jcompat.load_model(
        paths["syllab"])
    for w in ("hyphenation", "computer", ""):
        assert (compat.word_hyphenation_with_model(syl, w, 0x2D)
                == jcompat.word_hyphenation_with_model(jsyl, w, 0x2D))
    for kind in ("gpt2", "bert"):
        h, jh = compat.load_model(paths[kind]), jcompat.load_model(paths[kind])
        for no_padding in (False, True):
            np.testing.assert_array_equal(
                compat.text_to_ids(h, s, 32, 100, no_padding),
                jcompat.text_to_ids(jh, s, 32, 100, no_padding))
            for a, b in zip(
                    compat.utf8text_to_ids_with_offsets(h, s.encode(), 32, 100,
                                                        no_padding),
                    jcompat.utf8text_to_ids_with_offsets(jh, s.encode(), 32,
                                                         100, no_padding)):
                np.testing.assert_array_equal(a, b)
        compat.free_model(h)
    h = compat.load_model(paths["gpt2"])
    assert h.text_to_ids(s) and h._native  # its native runtime, resolved
    # the JAX API's native path ignores the setting (ROADMAP.md C item 7):
    # its scalar engines take it
    monkeypatch.setenv("BTL_NATIVE", "0")
    jh = jcompat.load_model(paths["gpt2"])
    for add in (False, True):
        compat.change_settings_dummy_prefix(h, add)
        jcompat.change_settings_dummy_prefix(jh, add)
        np.testing.assert_array_equal(compat.text_to_ids(h, s, 32),
                                      jcompat.text_to_ids(jh, s, 32))
    i2w, ji2w = (compat.load_model(paths["gpt2_i2w"]),
                 jcompat.load_model(paths["gpt2_i2w"]))
    ids = compat.text_to_ids(h, s, 64, no_padding=True)
    assert compat.ids_to_text(i2w, ids) == jcompat.ids_to_text(ji2w, ids)
    assert compat.ids_to_text(i2w, ids, False) == jcompat.ids_to_text(
        ji2w, ids, False)
    assert compat.ids_to_text(wbd, ids) == jcompat.ids_to_text(jwbd, ids) == ""
    for load in (compat.load_model, jcompat.load_model):
        with pytest.raises(ValueError):
            load(paths["not_i2w"])


def test_profile_trace_writes_a_chrome_trace(paths, tmp_path):
    port, _ = _pair(paths, "gpt2")
    with metrics.profile_trace(str(tmp_path)) as prof:
        ids = port.text_to_ids_batch(DOCS[:20])
    assert ids and prof is not None
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # the batch's stages, as ranges on the trace's clock, each sub-stage
    # inside its parent
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name", "").startswith("stage.")}
    assert {"stage.dispatch", "stage.dispatch.analyze", "stage.collect",
            "stage.collect.wait", "stage.collect.stitch",
            "stage.lists"} <= set(spans)
    for sub, parent in (("dispatch.analyze", "dispatch"),
                        ("collect.stitch", "collect")):
        (a, b), (lo, hi) = spans["stage." + sub], spans["stage." + parent]
        assert lo <= a <= b <= hi
