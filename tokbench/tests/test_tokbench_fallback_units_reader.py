"""CPU tests of the reader ``fallback_units_per_flagged_row.corpus`` (the
native stitch's counters ``fallback_units`` over ``flagged_rows``) on fixed
records.  Run from the repository's root:

    python3 -m pytest -q tokbench/tests/test_tokbench_fallback_units_reader.py"""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from tb import find  # noqa: E402

NAME = "fallback_units_per_flagged_row.corpus"
MIB = 1 << 20


def _rec(traced=True, loop="corpus"):
    rec = {"loop": loop, "steps": 4, "failed": 0, "bytes": 8 * MIB,
           "docs": 1000, "ids": 1_000_000, "window_s": 2.0,
           "counters": {"fallback_docs": 10, "dispatched_rows": 80,
                        "fallback_bytes": MIB // 4, "flagged_rows": 4,
                        "fallback_units": 6, "stage_seconds": {}}}
    if traced:
        rec["trace"] = {"window_s": 2.0, "busy_s": 0.5, "kernel_s": 0.004,
                        "records": {}}
    return rec


def _read(rec):
    return find.module("metrics", NAME).read(rec)


def test_reads_units_a_flagged_row_on_a_traced_record():
    assert _read(_rec()) == pytest.approx(1.5)


def test_an_untraced_or_other_loops_record_reads_none():
    assert _read(_rec(traced=False)) is None
    assert _read(_rec(loop="requests")) is None


@pytest.mark.parametrize("key", ["fallback_units", "flagged_rows"])
def test_a_program_without_the_counter_reads_none(key):
    rec = _rec()
    del rec["counters"][key]
    assert _read(rec) is None


def test_no_flagged_row_reads_none():
    rec = _rec()
    rec["counters"]["flagged_rows"] = 0
    assert _read(rec) is None


def test_the_metric_is_in_the_manifest_for_the_gpt2_cell():
    per_layer = {m["name"]: m for m in find.benchmark()["per_layer"]}
    m = per_layer[NAME]
    assert m["source"] == "program_counter"
    assert m["layer"] == "Fallback patch"
    assert m["moves"] == "corpus_MBps"
    assert m["workloads"] == ["gpt2-bytebpe.corpus"]
