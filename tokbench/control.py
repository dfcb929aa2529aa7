"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed a precision lower (or with a
guarantee broken), on a cell's own traffic and sample, scored by the same
comparison as a run (tb/check.py).  It has to come out as not correct.

    python3 tokbench/control.py --workload <name> --seeds 1 2 3 [--control bf16_scores]

prints one JSON line a seed: the numbers compared, each with its limit.
Controls (tb/reference.py): ``bf16_scores`` (each score or BPE rank rounded
to bfloat16), ``f32_sums`` (the unigram's sums in float32), ``window_cut``
(every document cut to the device window).  It needs no card: the
program is not run."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from array import array

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from tb import check, find, model  # noqa: E402
from tb import corpus as traffic_gen  # noqa: E402
from tb.reference import Reference  # noqa: E402


def control_checks(workload: str, seed: int, control: str | None,
                   traffic_override: dict | None = None,
                   bench: dict | None = None) -> dict:
    """The numbers compared when the control answers every sampled document
    of the cell once (``control=None``: the reference itself)."""
    bench = bench or find.benchmark()
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = dict(find.data("configs", wl["config"]), name=wl["config"])
    traffic = dict(find.data("traffic", wl["traffic"]),
                   **(traffic_override or {}))
    docs = traffic_gen.traffic_docs(traffic)
    n = find.module("loops", traffic["loop"]).served(traffic, docs)
    sample = check.sample(n, [len(d) for d in docs], seed, traffic)
    entries, charmap = model.vocabulary(cfg)
    ctl = Reference(cfg, entries, charmap, control=control)
    unk = int(cfg["unk_id"])
    answers = {k: {array("i", ctl.text_to_ids(docs[k], unk)).tobytes(): 1}
               for k in sample}
    return check.judge(cfg, entries, charmap, docs, answers, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default="bf16_scores")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        checks = control_checks(args.workload, seed, args.control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "correct": check.passed(checks), "checks": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
