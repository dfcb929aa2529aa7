"""CPU tests of the benchmark's harness: traffic, reference, metric
arithmetic, the manifest, the imports, the faults the comparison must catch
and its control.  Run from the repository's root:

    python3 -m pytest -q tokbench/tests/test_tokbench_harness.py

Cells run here on the CPU (``device="cpu"``: the kernels' plain versions)
at a small size; the command line never does."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
TOKBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(TOKBENCH)
sys.path.insert(0, TOKBENCH)

import control  # noqa: E402
import run  # noqa: E402
from tb import check, corpus, find, model, reference  # noqa: E402
from tb import trace as trace_mod  # noqa: E402

CELLS = ["gpt2-bytebpe.corpus", "xlnet-unigram.corpus"]
SMALL = {"bytes": 120 << 10, "sample_docs": 60}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BIG_SEED = 2 ** 31 + 12345


def small_run(workload, seed=BIG_SEED, seconds=0.3, override=None):
    return run.run_cell(find.benchmark(), workload, seed, seconds, 0,
                        device="cpu",
                        traffic_override=dict(SMALL, **(override or {})))


# -- traffic -------------------------------------------------------------


def test_traffic_is_sized_fixed_and_holds_the_edge_cases():
    t = dict(find.data("traffic", "corpus"), bytes=200 << 10)
    a = corpus.traffic_docs(t)
    assert a == corpus.traffic_docs(t)
    assert sum(map(len, a)) >= t["bytes"]
    head = [e.encode("utf-8") for e in corpus.EDGE_CASES]
    head += [bytes.fromhex(h) for h in t["corpus"]["bytes_docs_hex"]]
    assert len(head) == t["sample_head"]
    assert a[: len(head)] == head
    invalid = 0
    for h in t["corpus"]["bytes_docs_hex"]:
        try:
            bytes.fromhex(h).decode("utf-8")
        except UnicodeDecodeError:
            invalid += 1
    assert invalid >= 5
    # every run's calls take the same orders in turn
    orders = corpus.orders(len(a), len(head))
    assert len(orders) == corpus.ORDERS
    for o, again in zip(orders, corpus.orders(len(a), len(head))):
        assert (o == again).all()
        assert (o[: len(head)] == np.arange(len(head))).all()
        assert sorted(o) == list(range(len(a)))
    assert len({o.tobytes() for o in orders}) == corpus.ORDERS


def test_generator_is_a_frozen_copy_of_the_programs():
    from blingfire_tpu_torch import testing

    assert corpus.zipf_docs(300 << 10, 9, {"lexicon_seed": 9}) == \
        testing.zipf_corpus(300 << 10, 9)


@pytest.mark.parametrize("cfg_name", ["gpt2-bytebpe", "xlnet-unigram"])
def test_vocabularies_are_frozen_copies(cfg_name):
    from blingfire_tpu_torch import testing

    cfg = find.data("configs", cfg_name)
    entries, charmap = model.vocabulary(cfg)
    if cfg["vocab"] == "gpt2_shaped":
        want = testing.gpt2_shaped_entries(cfg["vocab_size"],
                                           cfg["vocab_seed"], cfg["n_long"])
        assert charmap is None
    else:
        want = testing.xlnet_shaped_entries(cfg["vocab_size"],
                                            cfg["vocab_seed"], cfg["n_cjk"])
        assert charmap == testing.xlnet_charmap()
    assert entries == [(e.chain, e.id, e.score) for e in want]
    assert len(entries) == cfg["vocab_size"]


# -- the reference ---------------------------------------------------------


@pytest.mark.parametrize("cfg_name", ["gpt2-bytebpe", "xlnet-unigram"])
def test_reference_equals_the_ports_cpu_path(cfg_name):
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.runtime.host import SpTokenizer

    run.fix_caches()
    cfg = dict(find.data("configs", cfg_name), name=cfg_name)
    t = dict(find.data("traffic", "corpus"), bytes=64 << 10)
    docs = corpus.traffic_docs(t)
    docs += [b"\xef\xbb\xbf", b"\xef\xbb\xbfword", b"x" * 3000,
             " ".join(["ab"] * 400).encode()]
    entries, charmap = model.vocabulary(cfg)
    ref = reference.Reference(cfg, entries, charmap)
    want = [ref.text_to_ids(d, cfg["unk_id"]) for d in docs]
    path, _ = model.image_path(cfg_name, cfg)
    with open(path, "rb") as f:
        tok = SpTokenizer(load_bytes(f.read()),
                          max_doc_symbols=cfg["max_doc_symbols"], device="cpu")
    ids, bounds = tok.encode_corpus_flat(docs, cfg["unk_id"])
    got = [ids[bounds[i]:bounds[i + 1]].tolist() for i in range(len(docs))]
    assert got == want


def test_bf16_rounding():
    assert reference._bf16(1.0) == 1.0
    assert reference._bf16(257.0) == 256.0  # ties to even
    assert reference._bf16(259.0) == 260.0
    assert reference._bf16(50255.0) == 50176.0


# -- the comparison: faults and the control -----------------------------------


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_small_run_is_correct(workload):
    result, checks = small_run(workload)
    assert result["correct"], checks
    assert checks["wrong_answers"]["of"] > 0
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"


def _alter_a_token(monkeypatch):
    from blingfire_tpu_torch.runtime import dedup

    orig = dedup.UnitRunner.collect_docs

    def collect_docs(self, state):
        # one token in every 997 that the device path produces
        ids, bounds, need, status = orig(self, state)
        ids = ids.copy()
        ids[::997] += 1
        return ids, bounds, need, status
    monkeypatch.setattr(dedup.UnitRunner, "collect_docs", collect_docs)


def _leave_out_half_the_batch(monkeypatch):
    from blingfire_tpu_torch.runtime import dedup

    orig = dedup.UnitRunner.collect_docs

    def collect_docs(self, state):
        ids, bounds, need, status = orig(self, state)
        half = (len(bounds) - 1) // 2
        bounds = bounds.copy()
        bounds[half + 1:] = bounds[half]
        return ids[: bounds[half]], bounds, need, status
    monkeypatch.setattr(dedup.UnitRunner, "collect_docs", collect_docs)


def _skip_the_device_pass(monkeypatch):
    from blingfire_tpu_torch.runtime import dedup

    def pack_out_compact(ids, starts, counts, fb, out=None):
        out.zero_()
        return out
    monkeypatch.setattr(dedup, "pack_out_compact", pack_out_compact)


FAULTS = {"token_altered": _alter_a_token,
          "half_the_batch_left_out": _leave_out_half_the_batch,
          "device_pass_skipped": _skip_the_device_pass}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, checks = small_run(workload)
    assert not result["correct"]
    assert checks["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    override = {"bytes": 400 << 10, "sample_docs": 400}
    ctl = control.control_checks(workload, BIG_SEED, "bf16_scores", override)
    assert not check.passed(ctl)
    assert ctl["wrong_answers"]["value"] > 0


def test_the_reference_in_the_programs_place_is_correct():
    ref = control.control_checks("xlnet-unigram.corpus", BIG_SEED, None,
                                 {"bytes": 64 << 10, "sample_docs": 100})
    assert check.passed(ref)


# -- metric arithmetic ---------------------------------------------------------


def _rec(loop, traced=True):
    rec = {"loop": loop, "steps": 4, "failed": 0, "bytes": 8 << 20,
           "docs": 1000, "ids": 1_000_000, "window_s": 2.0,
           "latencies_s": [0.010, 0.020, 0.030, 0.040], "setup_s": 7.5,
           "device_name": "NVIDIA H100 80GB HBM3",
           "counters": {"fallback_docs": 10, "dispatched_rows": 80,
                        "stage_seconds": {"dispatch": 0.4, "collect": 0.2}},
           "launches": {"bpe_walk": 6, "bpe_resolve": 6}}
    if traced:
        rec["trace"] = {"window_s": 2.0, "busy_s": 0.5, "kernel_s": 0.004,
                        "records": {"bpe_walk": [6, 6],
                                    "bpe_resolve": [6, 6]}}
    return rec


def _read(name, rec):
    return find.module("metrics", name).read(rec)


DEVICE_READERS = ["kernel_ms_per_MiB.corpus", "kernel_roofline_pct.corpus",
                  "device_idle_pct.corpus", "device_ms_per_MiB",
                  "kernel_roofline_pct.unigram"]


def test_metric_arithmetic_on_fixed_records():
    c = _rec("corpus")
    assert _read("corpus_MBps", c) == pytest.approx((8 << 20) / 2.0 / 1e6)
    assert _read("setup_s", c) == 7.5
    assert _read("dispatch_ms_per_MiB.corpus", c) == pytest.approx(50.0)
    assert _read("collect_ms_per_MiB.corpus", c) == pytest.approx(25.0)
    assert _read("dispatched_rows_per_MiB.corpus", c) == pytest.approx(10.0)
    assert _read("launches_per_MiB.corpus", c) == pytest.approx(1.5)
    assert _read("kernel_ms_per_MiB.corpus", c) == pytest.approx(0.5)
    assert _read("fallback_doc_pct.corpus", c) == pytest.approx(1.0)
    assert _read("device_idle_pct.corpus", c) == pytest.approx(75.0)
    least = ((8 << 20) + 4 * 1_000_000) / 3.35e12
    assert _read("kernel_roofline_pct.corpus", c) == pytest.approx(
        100 * least / 0.004)
    # the same readings in the cells judged by the card's time
    assert _read("device_ms_per_MiB", c) == pytest.approx(0.5)
    assert _read("corpus_MBps.unigram", c) == _read("corpus_MBps", c)
    for name in ("dispatched_rows_per_MiB", "launches_per_MiB",
                 "kernel_roofline_pct"):
        assert _read(name + ".unigram", c) == _read(name + ".corpus", c)
    # a reader finds nothing in another loop's record or an untraced one
    other = _rec("requests")
    assert _read("corpus_MBps", other) is None
    assert _read("device_idle_pct.corpus", other) is None
    assert _read("dispatch_ms_per_MiB.corpus", _rec("corpus", False)) is None
    for name in DEVICE_READERS:
        assert _read(name, _rec("corpus", False)) is None
    # a failed call counts as missing: no rate
    assert _read("corpus_MBps", dict(c, failed=1)) is None


@pytest.mark.parametrize("name", DEVICE_READERS)
def test_a_profile_short_of_kernel_records_gives_no_device_reading(name):
    """A launch with no record in the profile would read as idle time and
    lower the kernels' time: the device readings read nothing then."""
    rec = _rec("corpus")
    assert _read(name, rec) is not None
    rec["trace"]["records"]["bpe_resolve"] = [5, 6]
    assert _read(name, rec) is None


def test_trace_reading_attributes_idle_time_to_the_innermost_span():
    segs = trace_mod._innermost([(0, 10, "request"), (2, 5, "dispatch_docs")],
                                0, 12, "harness")
    assert segs == [(0, 2, "request"), (2, 5, "dispatch_docs"),
                    (5, 10, "request"), (10, 12, "harness")]
    assert trace_mod._union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert trace_mod.short_name(
        "void (anonymous namespace)::k<4>(int*, float)") == "k<4>"


# -- the manifest ----------------------------------------------------------------


def test_manifest_keeps_to_the_contract():
    b = find.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["tokbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and os.path.isfile(
            os.path.join(REPO, c["file"]))
        assert c["reduced"] == find.data("configs", c["name"])["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] == 1 and len(w["why"]) <= 200
        traffic = find.data("traffic", w["traffic"])
        find.module("loops", traffic["loop"])
        assert w["name"] not in names
        names.add(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert hasattr(find.module("metrics", m["name"]), "read")
        assert set(m.get("workloads", names)) <= names
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                               names))
    for w in names:
        reported = [m["name"] for m in b["end_to_end"]
                    if w in m.get("workloads", names)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])


# -- imports and the card ----------------------------------------------------------


def _subprocess(code: str, cwd: str = REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, **(env or {})))


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys; sys.path.insert(0, 'tokbench')\n"
        "import run\n"
        "res, _ = run.run_cell(run.find.benchmark(), 'xlnet-unigram.corpus',"
        " 3, 0.2, 0, device='cpu', traffic_override={'bytes': 120000,"
        " 'sample_docs': 20})\n"
        "assert res['correct']\n"
        "print('FOUND', run.forbidden_modules())\n"
        "print('TOP', sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = _subprocess(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
    top = out.stdout.split("TOP ")[1]
    for name in ("'jax'", "'jaxlib'", "'flax'", "'blingfire_tpu'"):
        assert name not in top
    assert "'blingfire_tpu_torch'" in top


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'tokbench')\n"
            "from tb import reference, corpus, check, model\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = _subprocess(code)
    assert out.returncode == 0, out.stderr
    for name in ("jax", "blingfire_tpu", "blingfire_tpu_torch", "torch"):
        assert f"'{name}'" not in out.stdout


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "tokbench/run.py", "--workload",
         "gpt2-bytebpe.corpus", "--seed", str(BIG_SEED), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA card" in out.stderr


def test_a_directory_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(TOKBENCH, tmp_path / "tokbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "tokbench/run.py", "--workload",
         "gpt2-bytebpe.corpus", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_a_cell_added_from_new_files_is_found(tmp_path):
    """A later PR adds a cell, its mix and a metric as new files and
    manifest entries only."""
    shutil.copytree(TOKBENCH, tmp_path / "tokbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    cell = "xlnet-unigram.corpus-small"
    b = find.benchmark()
    b["workloads"].append({"name": cell, "config": "xlnet-unigram",
                           "traffic": "corpus-small", "chips": 1,
                           "why": "batches of 64 documents"})
    b["end_to_end"].append({"name": "ids_per_s", "unit": "ids/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    mix = dict(find.data("traffic", "corpus"), batch_docs=64)
    (tmp_path / "tokbench" / "traffic" / "corpus-small.json").write_text(
        json.dumps(mix))
    (tmp_path / "tokbench" / "metrics" / "ids_per_s.py").write_text(
        "def read(rec):\n    return rec['ids'] / rec['window_s']\n")
    code = (
        "import sys; sys.path.insert(0, 'tokbench')\n"
        "import run, json\n"
        f"res, _ = run.run_cell(run.find.benchmark(), {cell!r}, 5, 0.3, 0, "
        "device='cpu', traffic_override={'bytes': 30000, "
        "'sample_docs': 20})\n"
        "print(json.dumps(res))\n")
    out = _subprocess(code, cwd=str(tmp_path),
                      env={"PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"ids_per_s", "setup_s"}
    assert res["metrics"]["ids_per_s"]["value"] > 0


def test_a_run_in_parts_adds_the_work_and_keeps_every_call():
    import collections

    def part(lat, ans):
        rec = _rec("corpus", traced=False)
        rec.update(latencies_s=lat, steps=len(lat), cpu_s=1.0,
                   launches={"bpe_walk": 3})
        return {"rec": rec, "peak": 10 + len(lat), "kind": "k",
                "answers": {5: collections.Counter(ans)}, "docs": {5: b"d"}}
    a = part([0.01, 0.02], [b"x", b"x"])
    b = part([0.03], [b"x", b"y"])
    b = run._decode_part(run._encode_part(b))
    m = run.merge([a, b])["rec"]
    assert m["bytes"] == 2 * (8 << 20) and m["window_s"] == 4.0
    assert m["steps"] == 3 and m["latencies_s"] == [0.01, 0.02, 0.03]
    assert m["setup_s"] == 7.5 and m["launches"] == {"bpe_walk": 6}
    assert m["counters"]["stage_seconds"]["dispatch"] == pytest.approx(0.8)
    merged = run.merge([a, b])
    assert merged["answers"][5] == {b"x": 3, b"y": 1}
    assert merged["peak"] == 12
    assert "trace" not in m


def test_a_run_in_parts_adds_the_device_time_of_every_profiled_part():
    """Where an end-to-end metric is read from the card, every part of an
    untraced run profiles its window; the run reads them all, and reads
    nothing where one part's profile lacks a kernel's records."""
    def part(records):
        rec = _rec("corpus")
        rec.update(cpu_s=1.0, trace=dict(rec["trace"], records=records))
        return {"rec": rec, "peak": 1, "kind": "k", "answers": {},
                "docs": {}}
    full = {"bpe_walk": [6, 6], "bpe_resolve": [6, 6]}
    m = run.merge([part(full), part(full)])["rec"]
    assert m["trace"]["kernel_s"] == pytest.approx(0.008)
    assert m["trace"]["records"] == {"bpe_walk": [12, 12],
                                     "bpe_resolve": [12, 12]}
    assert _read("device_ms_per_MiB", m) == pytest.approx(0.5)
    short = dict(full, bpe_resolve=[5, 6])
    assert _read("device_ms_per_MiB", run.merge(
        [part(short), part(full)])["rec"]) is None
    # more records than launches in one part make up for none in another
    extra = dict(full, bpe_resolve=[7, 6])
    assert _read("device_ms_per_MiB", run.merge(
        [part(short), part(extra)])["rec"]) is None


def test_only_a_cell_with_a_device_end_to_end_metric_profiles_untraced():
    b = find.benchmark()
    assert run.reads_the_card(b, "xlnet-unigram.corpus")
    assert not run.reads_the_card(b, "gpt2-bytebpe.corpus")
