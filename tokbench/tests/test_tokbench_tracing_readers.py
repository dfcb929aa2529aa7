"""CPU tests of the readers of the program's own stages and counters
(``metrics/*.py`` over ``tb/stages.py``) on fixed records.  Run from the
repository's root:

    python3 -m pytest -q tokbench/tests/test_tokbench_tracing_readers.py"""

from __future__ import annotations

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from tb import find  # noqa: E402

MIB = 1 << 20
STAGES = {"dispatch": 0.8, "dispatch.analyze": 0.6, "collect": 0.3,
          "collect.wait": 0.1, "collect.stitch": 0.15, "fallback": 0.5,
          "fallback.native": 0.4, "call.split": 0.02, "call.join": 0.06}
# (reader, its reading of REC, what a record of a program without the
# stage or counter lacks)
READINGS = [
    ("analyze_ms_per_MiB.corpus", 75.0, ("stage", "dispatch.analyze")),
    ("launch_ms_per_MiB.corpus", 25.0, ("stage", "dispatch.analyze")),
    ("wait_ms_per_MiB.corpus", 12.5, ("stage", "collect.wait")),
    ("stitch_ms_per_MiB.corpus", 18.75, ("stage", "collect.stitch")),
    ("fallback_native_ms_per_MiB.corpus", 50.0, ("stage", "fallback.native")),
    ("call_glue_ms_per_MiB.corpus", 10.0, ("stage", "call.join")),
    ("fallback_byte_pct.corpus", 3.125, ("counter", "fallback_bytes")),
    ("fallback_docs_per_flagged_row.corpus", 2.5, ("counter", "flagged_rows")),
]


def _rec(traced=True, loop="corpus"):
    rec = {"loop": loop, "steps": 4, "failed": 0, "bytes": 8 * MIB,
           "docs": 1000, "ids": 1_000_000, "window_s": 2.0,
           "counters": {"fallback_docs": 10, "dispatched_rows": 80,
                        "fallback_bytes": MIB // 4,
                        "flagged_rows": 4, "stage_seconds": dict(STAGES)}}
    if traced:
        rec["trace"] = {"window_s": 2.0, "busy_s": 0.5, "kernel_s": 0.004,
                        "records": {}}
    return rec


def _read(name, rec):
    return find.module("metrics", name).read(rec)


@pytest.mark.parametrize("name,want,_lacks", READINGS)
def test_reader_on_a_traced_record(name, want, _lacks):
    assert _read(name, _rec()) == pytest.approx(want)


@pytest.mark.parametrize("name,_want,_lacks", READINGS)
def test_reader_of_an_untraced_or_other_loops_record_reads_none(name, _want,
                                                                 _lacks):
    assert _read(name, _rec(traced=False)) is None
    assert _read(name, _rec(loop="requests")) is None


@pytest.mark.parametrize("name,_want,lacks", READINGS)
def test_reader_of_a_program_without_the_stage_reads_none(name, _want, lacks):
    rec = copy.deepcopy(_rec())
    kind, key = lacks
    del (rec["counters"]["stage_seconds"] if kind == "stage"
         else rec["counters"])[key]
    assert _read(name, rec) is None


def test_the_split_stages_add_up_to_their_parents():
    rec = _rec()
    assert (_read("analyze_ms_per_MiB.corpus", rec)
            + _read("launch_ms_per_MiB.corpus", rec)
            == pytest.approx(_read("dispatch_ms_per_MiB.corpus", rec)))
    assert (_read("wait_ms_per_MiB.corpus", rec)
            + _read("stitch_ms_per_MiB.corpus", rec)
            <= _read("collect_ms_per_MiB.corpus", rec))


def test_no_flagged_row_reads_none():
    rec = _rec()
    rec["counters"]["flagged_rows"] = 0
    assert _read("fallback_docs_per_flagged_row.corpus", rec) is None


def test_the_new_metrics_are_in_the_manifest_for_the_gpt2_cell():
    per_layer = {m["name"]: m for m in find.benchmark()["per_layer"]}
    for name, _want, _lacks in READINGS:
        m = per_layer[name]
        assert m["moves"] == "corpus_MBps"
        assert m["workloads"] == ["gpt2-bytebpe.corpus"]
