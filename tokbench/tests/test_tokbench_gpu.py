"""The benchmark's command on the card: every cell, a short window, with
and without the trace.  Run on a machine with a CUDA card, from the
repository's root:

    python3 -m pytest -q -m gpu tokbench/tests/test_tokbench_gpu.py

Each test decides inside itself whether there is a card, and skips
without one."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card(workload, trace):
    _card()
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = subprocess.run(
        [sys.executable, "tokbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace",
         str(trace)], cwd=REPO, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-4000:]
    metrics = bench["per_layer"] if trace else bench["end_to_end"]
    want = {m["name"] for m in metrics
            if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == want
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] < dev["window_s"]
        assert res["breakdown"]["device_ops"]
        for m, v in res["metrics"].items():
            if m.startswith("kernel_roofline_pct"):
                assert 0 < v["value"] <= 100
    assert out.stderr.strip().splitlines()[-2].startswith("wrong_answers")
