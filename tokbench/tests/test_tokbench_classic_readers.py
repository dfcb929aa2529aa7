"""CPU tests of the ``mistral-spmbpe.corpus`` cell: the readers of the
classic doc rows' stages and counters (``metrics/*.classic.py``) on fixed
records, their manifest entries, and the harness on the configuration: it
finds it, compiles its image, runs its reference, judges a small run of
the cell as correct and its control and a broken classic path as not.
Run from the repository's root:

    python3 -m pytest -q tokbench/tests/test_tokbench_classic_readers.py"""

from __future__ import annotations

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import control  # noqa: E402
import run  # noqa: E402
from tb import check, find, model, reference  # noqa: E402

MIB = 1 << 20
CELL = "mistral-spmbpe.corpus"
BIG_SEED = 2 ** 31 + 54321
STAGES = {"dispatch": 0.8, "dispatch.prep": 0.3, "collect": 0.4,
          "collect.wait": 0.1, "collect.rows_out": 0.25, "chunk": 1.2,
          "chunk.prep": 0.2, "chunk.crossed": 0.6, "chunk.rows": 0.3,
          "fallback": 0.05}
# (reader, its reading of _rec(), what a record of a program without the
# stage or counter lacks; None where the parent has it too)
READINGS = [
    ("prep_ms_per_MiB.classic", 37.5, ("stage", "dispatch.prep")),
    ("launch_ms_per_MiB.classic", 62.5, ("stage", "dispatch.prep")),
    ("wait_ms_per_MiB.classic", 12.5, ("stage", "collect.wait")),
    ("rows_out_ms_per_MiB.classic", 31.25, ("stage", "collect.rows_out")),
    ("chunk_ms_per_MiB.classic", 150.0, ("stage", "chunk")),
    ("crossed_ms_per_MiB.classic", 75.0, ("stage", "chunk.crossed")),
    ("chunked_doc_pct.classic", 28.0, ("counter", "chunked_docs")),
    ("fallback_doc_pct.classic", 1.0, None),
    ("row_fill_pct.classic", 80.0, ("counter", "classic_lanes")),
    ("kernel_ms_per_MiB.classic", 0.5, None),
    ("kernel_roofline_pct.classic",
     100 * ((8 * MIB) + 4 * 1_000_000) / 3.35e12 / 0.004, None),
]


def _rec(traced=True, loop="corpus"):
    rec = {"loop": loop, "steps": 4, "failed": 0, "bytes": 8 * MIB,
           "docs": 1000, "ids": 1_000_000, "window_s": 2.0,
           "device_name": "NVIDIA H100 80GB HBM3",
           "counters": {"fallback_docs": 10, "chunked_docs": 280,
                        "classic_rows": 1500, "classic_lanes": 500_000,
                        "classic_symbols": 400_000, "chunk_rows": 700,
                        "stage_seconds": dict(STAGES)},
           "launches": {"bpe_walk": 6, "bpe_resolve": 6}}
    if traced:
        rec["trace"] = {"window_s": 2.0, "busy_s": 0.5, "kernel_s": 0.004,
                        "records": {"bpe_walk": [6, 6],
                                    "bpe_resolve": [6, 6]}}
    return rec


def _read(name, rec):
    return find.module("metrics", name).read(rec)


def _classic_metrics():
    return [m for m in find.benchmark()["per_layer"]
            if m["name"].endswith(".classic")]


@pytest.mark.parametrize("name,want,_lacks", READINGS)
def test_reader_on_a_traced_record(name, want, _lacks):
    assert _read(name, _rec()) == pytest.approx(want)


@pytest.mark.parametrize("name,_want,_lacks", READINGS)
def test_reader_of_an_untraced_or_other_loops_record_reads_none(name, _want,
                                                                 _lacks):
    assert _read(name, _rec(traced=False)) is None
    assert _read(name, _rec(loop="requests")) is None


@pytest.mark.parametrize("name,lacks", [(n, k) for n, _w, k in READINGS
                                        if k is not None])
def test_reader_of_a_program_without_the_stage_reads_none(name, lacks):
    rec = copy.deepcopy(_rec())
    kind, key = lacks
    del (rec["counters"]["stage_seconds"] if kind == "stage"
         else rec["counters"])[key]
    assert _read(name, rec) is None


def test_the_split_stages_add_up_to_their_parents():
    rec = _rec()
    d = STAGES["dispatch"] * 1e3 / 8
    assert (_read("prep_ms_per_MiB.classic", rec)
            + _read("launch_ms_per_MiB.classic", rec) == pytest.approx(d))
    assert (_read("wait_ms_per_MiB.classic", rec)
            + _read("rows_out_ms_per_MiB.classic", rec)
            <= STAGES["collect"] * 1e3 / 8)
    assert (_read("crossed_ms_per_MiB.classic", rec)
            <= _read("chunk_ms_per_MiB.classic", rec))


def test_no_lanes_read_no_fill():
    rec = _rec()
    rec["counters"]["classic_lanes"] = 0
    assert _read("row_fill_pct.classic", rec) is None


def test_a_device_reading_of_a_short_profile_reads_none():
    rec = _rec()
    rec["trace"]["records"]["bpe_resolve"] = [5, 6]
    for name in ("kernel_ms_per_MiB.classic", "kernel_roofline_pct.classic"):
        assert _read(name, rec) is None


def test_the_classic_metrics_are_in_the_manifest_for_the_cell_alone():
    b = find.benchmark()
    assert {n for n, _w, _k in READINGS} <= {m["name"]
                                             for m in _classic_metrics()}
    e2e = [m["name"] for m in b["end_to_end"]
           if CELL in m.get("workloads", [CELL])]
    assert "setup_s" in e2e and len(e2e) == 2
    for m in _classic_metrics():
        assert m["workloads"] == [CELL]
        assert m["moves"] in e2e and m["moves"] != "setup_s"
    cell = next(w for w in b["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "mistral-spmbpe", "corpus", 1)
    cfg = find.data("configs", "mistral-spmbpe")
    assert cfg["k1_walk"] in cell["why"]


# -- the harness on the configuration -----------------------------------------


def test_the_harness_finds_compiles_and_references_the_configuration():
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.runtime.host import SpTokenizer

    run.fix_caches()
    cfg = dict(find.data("configs", "mistral-spmbpe"), name="mistral-spmbpe")
    assert cfg["reduced"] == [] and cfg["tok_algo"] == "BPE_OPT"
    entries, charmap = model.vocabulary(cfg)
    assert charmap is None and len(entries) == cfg["vocab_size"] - 259
    path, _built = model.image_path("mistral-spmbpe", cfg)
    with open(path, "rb") as f:
        tok = SpTokenizer(load_bytes(f.read()), max_doc_symbols=128,
                          device="cpu")
    assert not tok._chunk_safe
    assert (tok.tables.trie_next is not None) == (cfg["k1_walk"] == "trie")
    ref = reference.Reference(cfg, entries, charmap)
    docs = [b"hello world", "mixed中文and English".encode(), b"x" * 300,
            " ".join(["ab"] * 200).encode(), "ok ▁▁".encode(), b"\xff"]
    ids, bounds = tok.encode_corpus_flat(docs)
    assert [ids[bounds[i]:bounds[i + 1]].tolist()
            for i in range(len(docs))] == [ref.text_to_ids(d, 0)
                                           for d in docs]


def _small_run():
    return run.run_cell(find.benchmark(), CELL, BIG_SEED, 0.3, 0,
                        device="cpu",
                        traffic_override={"bytes": 120 << 10,
                                          "sample_docs": 60})


def test_a_sound_small_run_is_correct():
    result, checks = _small_run()
    assert result["correct"], checks
    assert checks["wrong_answers"]["of"] > 0


def test_a_broken_classic_path_is_not_correct(monkeypatch):
    from blingfire_tpu_torch.runtime.host import SpTokenizer

    orig = SpTokenizer._rows_out

    def rows_out(handle, c=None):
        ids, counts, fb = orig(handle, c)
        ids = ids.copy()
        ids[::997] += 1
        return ids, counts, fb
    monkeypatch.setattr(SpTokenizer, "_rows_out", staticmethod(rows_out))
    result, checks = _small_run()
    assert not result["correct"]
    assert checks["wrong_answers"]["value"] > 0


def test_the_control_is_not_correct():
    override = {"bytes": 400 << 10, "sample_docs": 400}
    ctl = control.control_checks(CELL, BIG_SEED, "bf16_scores", override)
    assert not check.passed(ctl)
    assert ctl["wrong_answers"]["value"] > 0
