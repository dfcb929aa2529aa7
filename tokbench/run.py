"""One run of one cell of the benchmark of ``blingfire_tpu_torch``.

    python3 tokbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``workloads`` of BENCHMARK.json)
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); the mix names its loop (``loops/<loop>.py``) and
each metric is read by ``metrics/<metric>.py``.  A run makes the traffic
(the same work for every seed; ``--seed`` picks the order its calls start
from and the documents judged), sets up the system (model image and tables from fixed
directories inside the checkout, kernels built there at the first run),
warms it, measures for ``--seconds`` seconds, then checks the window's
answers against the plain reference (tb/check.py).  ``--trace 0`` reports
the cell's end-to-end metrics from a window shared among PARTS processes,
one after another, each set up anew (a process's speed on a shared host
varies from one process to the next), each window under torch.profiler
where an end-to-end metric of the cell is read from the device's trace;
``--trace 1`` runs one window in this
process under torch.profiler with the layers' spans and reports the cell's
per-layer metrics.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a CUDA card (or with fewer than the cell asks for) the run fails
and prints no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import base64  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for p in (HERE, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

from tb import check, find, model, readers  # noqa: E402
from tb import corpus as traffic_gen  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "blingfire_tpu")
TRACE_ATTEMPTS = 3  # traced windows tried while the profile drops records
RUN_LIMIT_S = 360  # a run's whole time, the trace's reading included
PARTS = 3  # processes an untraced run's window is shared among
CHECK_RESERVE_S = 20  # a run's time kept for the comparison at its end
NO_CARD = 2  # exit code of a run that finds no card


def fix_caches() -> None:
    """Every cache of the program and its libraries at a fixed path inside
    the checkout, so that only the first run of a checkout builds or
    compiles, and two checkouts share nothing."""
    os.environ["BLINGFIRE_TPU_TORCH_CACHE"] = os.path.join(model.CACHE,
                                                           "tables")
    os.environ["BLINGFIRE_TPU_TORCH_BUILD"] = os.path.join(
        REPO, "build", "blingfire_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(model.CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(model.CACHE,
                                                      "torch_extensions")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's or
    the JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def window(loop, seconds: float, sample: list, answers: dict, span: str,
           traced: bool) -> dict:
    """Steps back to back until ``seconds`` have passed; each started step
    runs to its end, and the window closes with the last.  Keeps the
    answers of the sampled documents (``sample``, sorted)."""
    from torch.profiler import record_function

    rec = {"steps": 0, "failed": 0, "bytes": 0, "docs": 0, "ids": 0,
           "latencies_s": []}
    clock = time.perf_counter
    t0 = clock()
    t_end = t0
    j = 0
    while clock() - t0 < seconds:
        ts = clock()
        try:
            with record_function(span) if traced else contextlib.nullcontext():
                lo, hi, nbytes, ids_of, n_ids = loop.step(j)
        except Exception:  # a failed call is counted, and fails the run
            if rec["failed"] == 0:
                traceback.print_exc()
            rec["failed"] += 1
            t_end = clock()
            rec["latencies_s"].append(math.inf)
        else:
            t_end = clock()
            rec["latencies_s"].append(t_end - ts)
            rec["bytes"] += nbytes
            rec["docs"] += hi - lo
            rec["ids"] += n_ids
            for k in sample[bisect.bisect_left(sample, lo):
                            bisect.bisect_left(sample, hi)]:
                answers.setdefault(k, []).append(ids_of(k))
        rec["steps"] += 1
        j += 1
    rec["window_s"] = t_end - t0
    return rec


def diff(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            out[k] = diff(v, before.get(k, {}))
        elif isinstance(v, (int, float)):
            out[k] = v - before.get(k, 0)
    return out


def measured(loop, seconds, sample, answers, span, traced, device) -> dict:
    """One window with the program's counters and launches over it."""
    from blingfire_tpu_torch import kernels

    c0 = loop.counts()
    l0 = collections.Counter(kernels.launches)
    cpu0 = time.process_time()
    rec = window(loop, seconds, sample, answers, span, traced)
    rec["cpu_s"] = time.process_time() - cpu0
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    rec["counters"] = diff(loop.counts(), c0)
    rec["launches"] = dict(collections.Counter(kernels.launches) - l0)
    return rec


def traced_window(loop, seconds, sample, answers, span,
                  limit_s: float = RUN_LIMIT_S) -> dict:
    """The window under torch.profiler, with the layers' spans; run again
    (up to TRACE_ATTEMPTS, while the process is within ``limit_s``) while
    the profile misses kernel records, keeping the most complete.  Where
    even that one misses some, the device readings (tb/readers.py) read
    nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from blingfire_tpu_torch import measure
    from tb import spans as spans_mod
    from tb import trace

    device = torch.device("cuda")
    best = None
    for attempt in range(TRACE_ATTEMPTS):
        if best is not None and (time.perf_counter() - T_START
                                 + 2 * best["attempt_s"] > limit_s):
            log("[trace] no time left for another attempt")
            break
        t_attempt = time.perf_counter()
        sp = spans_mod.Spans()
        sp.install()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                # a kernel of no interest and a pause first, and a pause
                # before the end: the profiler has been seen to lose the
                # first launches of a profile, and whole profiles
                torch.zeros(1, device=device).add_(1)
                torch.cuda.synchronize()
                time.sleep(0.2)
                with record_function(trace.WINDOW):
                    rec = measured(loop, seconds, sample, answers, span, True,
                                   device)
                time.sleep(0.2)
        finally:
            sp.uninstall()
        names = {s[3] for s in spans_mod.WRAPPED} | {span} | {
            "stage." + s for s in ("dispatch", "collect", "chunk", "fallback")}
        rec["trace"] = trace.read(prof, names, rec["launches"],
                                  measure.KERNEL_NAMES, "harness")
        rec["attempt_s"] = time.perf_counter() - t_attempt
        short = {k: r for k, r in rec["trace"]["records"].items()
                 if r[0] < r[1]}
        log(f"[trace] attempt {attempt + 1}: records (kept, launched) "
            f"{rec['trace']['records']}")
        if best is None or _recorded(rec) > _recorded(best):
            best = rec
        if not short:
            break
        log(f"[trace] kernel records short: {short}; profiling again")
    if not readers.complete(best):
        log("[trace] the profile still lacks kernel records: no device "
            "reading is reported")
    return best


def _recorded(rec) -> float:
    r = rec["trace"]["records"]
    return sum(min(a, b) for a, b in r.values()) / max(1, sum(
        b for _a, b in r.values()))


def reads_the_card(bench: dict, workload: str) -> bool:
    """Whether an end-to-end metric of the cell is read from the device's
    trace: its untraced windows then run under the profiler too."""
    return any(m["source"] == "device_trace"
               and workload in m.get("workloads", [workload])
               for m in bench["end_to_end"])


def serve(bench: dict, workload: str, seed: int, seconds: float,
          trace: int, device: str = "cuda", traffic_override=None,
          t_start: float = T_START, limit_s: float = RUN_LIMIT_S) -> dict:
    """One process's part of a run: traffic, set-up, warm-up, the window
    and its answers.  Returns the window's record, the distinct answers of
    each sampled document with their counts, and those documents."""
    fix_caches()
    import torch

    wl = cell(bench, workload)
    cfg = dict(find.data("configs", wl["config"]), name=wl["config"])
    traffic = dict(find.data("traffic", wl["traffic"]),
                   **(traffic_override or {}))
    dev = torch.device(device)
    phases: dict = {"start": time.perf_counter() - t_start}

    t = time.perf_counter()
    docs = traffic_gen.traffic_docs(traffic)
    t_traffic = time.perf_counter() - t
    log(f"[traffic] {traffic['loop']}: {len(docs)} documents, "
        f"{sum(map(len, docs))} B, made in {t_traffic:.3f} s (not set-up)")

    loop_mod = find.module("loops", traffic["loop"])
    loop = loop_mod.Loop(cfg, traffic, docs, dev, phases, seed)
    t = time.perf_counter()
    loop.warm()
    phases["warm"] = time.perf_counter() - t
    sample = check.sample(loop.n_docs, [len(d) for d in docs], seed, traffic)
    gc.collect()
    gc.freeze()  # the harness's own heap (traffic, tables) out of every GC
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start - t_traffic
    log(f"[setup] {setup_s:.4f} s: " + ", ".join(
        f"{k} {v:.4f}" for k, v in phases.items()))

    answers: dict = {}
    if trace or (dev.type == "cuda" and reads_the_card(bench, workload)):
        t = time.perf_counter()
        rec = traced_window(loop, seconds, sample, answers, loop_mod.SPAN,
                            limit_s)
        log(f"[trace] the window and its profile's reading took "
            f"{time.perf_counter() - t:.3f} s")
    else:
        rec = measured(loop, seconds, sample, answers, loop_mod.SPAN, False,
                       dev)
    rec["setup_s"] = setup_s
    rec["loop"] = traffic["loop"]
    peak = 0
    kind = "cpu"
    if dev.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    rec["device_name"] = kind
    loop.close()
    del loop
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[window] {rec['steps']} calls, {rec['failed']} failed, "
        f"{rec['bytes']} B in {rec['window_s']:.4f} s; peak device memory "
        f"{peak} B; counters {json.dumps(rec['counters'])}; launches "
        f"{json.dumps(rec['launches'])}")
    lat = sorted(rec["latencies_s"])
    if len(lat) >= 4:
        q = statistics.quantiles(lat, n=20, method="inclusive")
        half = len(lat) // 2
        log(f"[calls] ms p5 {q[0] * 1e3:.3f} p25 {q[4] * 1e3:.3f} p50 "
            f"{q[9] * 1e3:.3f} p75 {q[14] * 1e3:.3f} p95 {q[18] * 1e3:.3f} "
            f"max {lat[-1] * 1e3:.3f}; mean of the first and second half "
            f"{statistics.fmean(rec['latencies_s'][:half]) * 1e3:.3f}, "
            f"{statistics.fmean(rec['latencies_s'][half:]) * 1e3:.3f}; "
            f"process CPU {rec['cpu_s']:.3f} s")
    if dev.type == "cuda":
        log(f"[card] {card_info()}")
    return {"rec": rec, "peak": peak, "kind": kind,
            "answers": {k: collections.Counter(v) for k, v in answers.items()},
            "docs": {k: docs[k] for k in answers}}


def merge(parts: list[dict]) -> dict:
    """One run's record from its parts, each a window of its own process:
    the work and the window seconds added up, every call's latency kept,
    the set-up of a part on average, and the device readings added up where
    every part profiled its window."""
    if len(parts) == 1:
        return parts[0]
    rec = {"loop": parts[0]["rec"]["loop"],
           "device_name": parts[0]["rec"]["device_name"],
           "latencies_s": [], "counters": {}, "launches": {}}
    for p in parts:
        r = p["rec"]
        for k in ("steps", "failed", "bytes", "docs", "ids", "window_s",
                  "cpu_s", "setup_s"):
            rec[k] = rec.get(k, 0) + r[k]
        rec["latencies_s"] += r["latencies_s"]
        rec["counters"] = add(rec["counters"], r["counters"])
        rec["launches"] = add(rec["launches"], r["launches"])
    rec["setup_s"] /= len(parts)
    if all("trace" in p["rec"] for p in parts):
        traces = [p["rec"]["trace"] for p in parts]
        records: dict = {}
        for t in traces:
            for k, (kept, launched) in t["records"].items():
                r = records.setdefault(k, [0, 0])
                r[0] += min(kept, launched)
                r[1] += launched
        rec["trace"] = {k: sum(t[k] for t in traces)
                        for k in ("window_s", "busy_s", "kernel_s")}
        rec["trace"]["records"] = records
    answers: dict = {}
    docs: dict = {}
    for p in parts:
        for k, c in p["answers"].items():
            answers.setdefault(k, collections.Counter()).update(c)
        docs.update(p["docs"])
    return {"rec": rec, "peak": max(p["peak"] for p in parts),
            "kind": parts[0]["kind"], "answers": answers, "docs": docs}


def add(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = add(out.get(k, {}), v) if isinstance(v, dict) else \
            out.get(k, 0) + v
    return out


def report(bench: dict, workload: str, trace: int, parts: list[dict]
           ) -> tuple[dict, dict]:
    """(result, the numbers compared) of a run made of ``parts``."""
    wl = cell(bench, workload)
    cfg = dict(find.data("configs", wl["config"]), name=wl["config"])
    merged = merge(parts)
    rec = merged["rec"]
    names = (bench["per_layer"] if trace else bench["end_to_end"])
    metrics = {}
    for m in names:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        v = find.module("metrics", m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t = time.perf_counter()
    entries, charmap = model.vocabulary(cfg)
    checks = check.judge(cfg, entries, charmap, merged["docs"],
                         merged["answers"], rec["failed"])
    log(f"[check] {checks['wrong_answers']['of']} answers of "
        f"{len(merged['answers'])} sampled documents against the reference in "
        f"{time.perf_counter() - t:.3f} s")

    device_out = {"platform": "cpu" if merged["kind"] == "cpu" else "gpu",
                  "kind": merged["kind"], "count": int(wl["chips"]),
                  "memory_peak_bytes": merged["peak"]}
    result = {"correct": check.passed(checks), "attempted": rec["steps"],
              "failed": rec["failed"], "metrics": metrics,
              "device": device_out}
    if trace:
        device_out["busy_s"] = rec["trace"]["busy_s"]
        device_out["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = rec["trace"]["breakdown"]
    result["checks"] = checks
    return result, checks


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: int, device: str = "cuda", traffic_override=None,
             t_start: float = T_START) -> tuple[dict, dict]:
    """(result, the numbers compared) of a run in this process alone.
    ``device="cpu"`` runs the kernels' plain versions, for the harness's
    tests only; the command line never takes it."""
    part = serve(bench, workload, seed, seconds, trace, device,
                 traffic_override, t_start)
    return report(bench, workload, trace, [part])


def _encode_part(part: dict) -> str:
    enc = base64.b64encode
    return json.dumps({
        "rec": part["rec"], "peak": part["peak"], "kind": part["kind"],
        "answers": {str(k): [[enc(a).decode(), n] for a, n in c.items()]
                    for k, c in part["answers"].items()},
        "docs": {str(k): enc(d).decode() for k, d in part["docs"].items()},
        "forbidden": forbidden_modules()})


def _decode_part(line: str) -> dict:
    d = json.loads(line)
    dec = base64.b64decode
    d["answers"] = {int(k): collections.Counter({dec(a): n for a, n in v})
                    for k, v in d["answers"].items()}
    d["docs"] = {int(k): dec(v) for k, v in d["docs"].items()}
    return d


def parts_in_processes(args, n: int) -> list[dict] | None:
    """The window in ``n`` processes, one after another, each with its own
    set-up and an n-th of the seconds: a process's speed on a shared host
    varies from process to process, and a run takes that of several.  None
    when the first finds no card."""
    parts = []
    longest = 0.0
    for i in range(n):
        # what this part may take, a profile's second attempt included:
        # the run's limit less the check's reserve and the later parts, each
        # as long as the longest so far
        t = time.perf_counter()
        est = longest or 2 * args.seconds / n + 30
        limit = (RUN_LIMIT_S - CHECK_RESERVE_S - (t - T_START)
                 - (n - 1 - i) * est)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--workload",
             args.workload, "--seed", str(args.seed), "--seconds",
             repr(args.seconds / n), "--trace", "0", "--part", str(i),
             "--limit", repr(limit)],
            stdout=subprocess.PIPE, text=True, timeout=RUN_LIMIT_S)
        longest = max(longest, time.perf_counter() - t)
        if out.returncode == NO_CARD and i == 0:
            return None
        if out.returncode != 0:
            raise SystemExit(f"part {i} of the run failed "
                             f"(exit {out.returncode})")
        part = _decode_part(out.stdout.strip().splitlines()[-1])
        if part["forbidden"]:
            raise SystemExit(f"part {i} loaded modules of JAX or of the JAX "
                             f"package: {part['forbidden']}")
        parts.append(part)
    return parts


def card_present(chips: int, workload: str) -> bool:
    t = time.perf_counter()
    import torch

    t_import = time.perf_counter() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"no CUDA card for {workload}: it asks for {chips}, torch sees "
            f"{n}")
        return False
    log(f"[start] torch imported in {t_import:.4f} s, the card found "
        f"{time.perf_counter() - t - t_import:.4f} s later")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--part", type=int, default=None,
                    help=argparse.SUPPRESS)  # one process of an untraced run
    ap.add_argument("--limit", type=float, default=RUN_LIMIT_S,
                    help=argparse.SUPPRESS)  # the seconds that part may take
    args = ap.parse_args(argv)
    fix_caches()
    bench = find.benchmark()
    chips = cell(bench, args.workload)["chips"]
    if args.part is not None:
        if not card_present(chips, args.workload):
            return NO_CARD
        part = serve(bench, args.workload, args.seed, args.seconds, 0,
                     limit_s=args.limit)
        print(_encode_part(part), flush=True)
        return 0
    if args.trace:
        if not card_present(chips, args.workload):
            return NO_CARD
        parts = [serve(bench, args.workload, args.seed, args.seconds, 1)]
    else:
        parts = parts_in_processes(args, PARTS)
        if parts is None:
            return NO_CARD
    result, checks = report(bench, args.workload, args.trace, parts)
    found = forbidden_modules() + sorted(
        {m for p in parts for m in p.get("forbidden", [])})
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 3
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        log(f"{name}: {c['value']} (limit {c['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
