"""K9 lexer_pass's and K1 bpe_walk's time split on the card.

    python3 -m blingfire_tpu_torch.kernels.phase_split [--out FILE]
        [k9:LABEL=SOURCE ...] [k1:LABEL=SOURCE ...]

Each SOURCE defaults to this checkout's ``kernels/csrc/lexer_pass.cu``
(K9) and ``bpe_walk.cu`` (K1), labelled "checkout"; another version of a
source (unpacked with ``git archive`` into an ignored directory) is given
as ``k9:LABEL=PATH``.  A source is built by nvcc for sm_90a and launched
in place of the checkout's entry point through the checkout's wrapper, so
its entry point must take the checkout's arguments.

K9: a source with phase marker comments (``// ---- NAME`` in the kernel)
is also built as a copy with a ``clock64()`` stamp at each marker.  Thread
0 of each block adds the cycles since the last marker to the phase it
closes; the block's sums are written at the kernel's end.  The rows are
those of every launch of one uncached 4 MiB batch on the words (wbd),
sentences (sbd) and wp_lexer (bert-shaped) paths, as chip_smoke.py's
kernels-l builds them.  Per launch and source: the planes equal the plain
version (tolerance 0); events and profiler device ms; with markers, each
phase's share of the blocks' cycles and the events ms of the stamped
copy; the FromPos chain's hops a row (to the row's end, and to its R
anchor) and the walk's live lane-steps.

K1: events and device ms of each source's build (the checkout's kernel
swapped out for it) on the gpt2-shaped model's three unit regions of one
4 MiB batch and on main-ww's first launch (304 rows of 1,024), with the walk
capped at LW = 1, 2, 4, 8, 16 on the same rows; the slope of device ms over
LW, per step, tells a DRAM-latency chain from an L2-latency one.  Then the
checkout's wrapper's host ns a call by part at the first region's shape.

Prints the card's name, power limit and SM clock, one log line per launch
and a JSON object per kernel; writes them all to FILE (default
build/blingfire_tpu_torch/phase_split.json).  Needs one card;
imports nothing of JAX or of blingfire_tpu.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

from blingfire_tpu_torch import measure

MARKER = re.compile(r"^[ \t]*// -+ ([A-Z]+)[ \t]*$", re.M)
STAMP_HEAD = r"""
__device__ unsigned long long* bf_phase_clock;
extern "C" int bf_phase_set(unsigned long long* p) {
    return (int)cudaMemcpyToSymbol(bf_phase_clock, &p, sizeof(p));
}
#define BF_PHASE(k)                                                     \
    do {                                                                \
        if (threadIdx.x == 0) {                                         \
            const unsigned long long bf_t = clock64();                  \
            bf_acc[bf_cur] += bf_t - bf_last;                           \
            bf_last = bf_t;                                             \
            bf_cur = (k);                                               \
        }                                                               \
    } while (0)
"""
LW_CAPS = (1, 2, 4, 8, 16)


def _body(src: str, kernel: str) -> tuple[int, int]:
    """(index after the opening brace, index of the closing brace) of the
    __global__ function ``kernel``."""
    m = re.search(r"__global__[^;{]*?\b" + kernel + r"\s*\(", src)
    if m is None:
        raise ValueError(f"no __global__ {kernel} in the source")
    i = src.index("{", m.end())
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return i + 1, j
    raise ValueError(f"{kernel}: unbalanced braces")


def instrument(src: str, kernel: str) -> tuple[str, list[str]]:
    """The source with a stamp at each phase marker of ``kernel`` and at its
    end; the phase names ("START" first: before the first marker)."""
    lo, hi = _body(src, kernel)
    marks = [m for m in MARKER.finditer(src) if lo <= m.start() < hi]
    names = ["START"] + [m.group(1) for m in marks]
    uniq = list(dict.fromkeys(names))
    n = len(uniq)
    out = [src[:lo], f"\n    unsigned long long bf_acc[{n}] = {{}};"
           "\n    unsigned long long bf_last = clock64();"
           "\n    int bf_cur = 0;"]
    last = lo
    for m in marks:
        out += [src[last : m.end()], f"\n    BF_PHASE({uniq.index(m.group(1))});"]
        last = m.end()
    out += [src[last:hi], "\n    BF_PHASE(0);\n    if (threadIdx.x == 0)",
            f"\n        for (int bf_k = 0; bf_k < {n}; ++bf_k)",
            f"\n            bf_phase_clock[(size_t)blockIdx.x * {n} + bf_k] = "
            "bf_acc[bf_k];\n", src[hi:]]
    text = "".join(out)
    inc = text.index('#include "common.cuh"') + len('#include "common.cuh"')
    return text[:inc] + STAMP_HEAD + text[inc:], uniq


def build(tag: str, text: str, entry: str, argtypes, stamped: bool):
    """nvcc ``text`` into a library beside the checkout's kernels: (entry
    point, bf_error_string, phase-buffer setter or None)."""
    from blingfire_tpu_torch import kernels
    from blingfire_tpu_torch.buildutil import build_all, build_dir, source_tag

    d = build_dir("phase_split")
    src = os.path.join(d, f"{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    h = source_tag(src, *[os.path.join(kernels.CSRC, c) for c in
                          sorted(os.listdir(kernels.CSRC))
                          if c.endswith(".cuh")],
                   extra=" ".join(kernels.NVCC_FLAGS))
    lib_path = os.path.join(d, f"lib{tag}.{h}.so")
    build_all([(lib_path, lambda tmp: [kernels.nvcc(), *kernels.NVCC_FLAGS,
                                       "-I", kernels.CSRC, "-o", tmp, src])])
    lib = ctypes.CDLL(lib_path)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    lib.bf_error_string.restype = ctypes.c_char_p
    lib.bf_error_string.argtypes = [ctypes.c_int]
    setter = None
    if stamped:
        setter = lib.bf_phase_set
        setter.restype = ctypes.c_int
        setter.argtypes = [ctypes.c_void_p]
    return fn, lib.bf_error_string, setter


def _entry(text: str, entry: str) -> str:
    """The signature of the extern "C" function ``entry``, spaces folded."""
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    if m is None:
        raise ValueError(f"no extern \"C\" {entry} in the source")
    return " ".join(m.group(1).split())


def read_source(path: str, entry: str) -> str:
    """The text of the source at ``path``, whose ``entry`` must take the
    checkout's arguments."""
    from blingfire_tpu_torch import kernels

    with open(path) as f:
        text = f.read()
    with open(os.path.join(kernels.CSRC, os.path.basename(path))) as f:
        own = f.read()
    if _entry(text, entry) != _entry(own, entry):
        raise ValueError(f"{path}: {entry} takes other arguments than the "
                         f"checkout's")
    return text


def _k9_launcher(fn, err):
    """call(t, x, init, elen, out) of one build of a K9 source."""
    from blingfire_tpu_torch import kernels
    from blingfire_tpu_torch.ops import lexer as lexer_ops

    def call(t, x, i, e, o):
        saved = kernels._fns.get("lexer_pass")
        kernels._fns["lexer_pass"] = (fn, err)
        try:
            return lexer_ops.lexer_pass_packed(t, x, i, e, out=o)
        finally:
            if saved is None:
                kernels._fns.pop("lexer_pass", None)
            else:
                kernels._fns["lexer_pass"] = saved
    return call


def k9_paths(dev):
    """path -> (tables, [(level, bucket, x, init, ext_len) of each launch]):
    one uncached CMP_BYTES batch on each pattern-lexer path."""
    import numpy as np
    import torch

    from blingfire_tpu_torch import testing
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.runtime.lexer_host import (WordPieceTpu,
                                                        WordsTpu, decode_utf8)

    docs = measure.corpus_prefix(testing.zipf_corpus(measure.CORPUS_BYTES),
                                 measure.CMP_BYTES)
    lexers = {
        "words": (WordsTpu(load_bytes(testing.shipped_lexer_bytes("wbd")),
                           device=dev).lex, True),
        "sentences": (WordsTpu(load_bytes(testing.shipped_lexer_bytes("sbd")),
                               device=dev).lex, True),
        "wp_lexer": (WordPieceTpu(load_bytes(testing.bert_shaped_model_bytes()),
                                  device=dev).lex, False),
    }
    out = {}
    for path, (lex, nul_space) in lexers.items():
        decs = [decode_utf8(d) for d in docs]
        cps = [np.where(d[0] == 0, 0x20, d[0]) if nul_space else d[0]
               for d in decs if d is not None and len(d[0])]
        trace = []
        lex._flat_cache.clear()
        lex.process_docs(cps, trace=trace)
        lex._flat_cache.clear()
        out[path] = (lex.tables, [
            (lv, bk, *(torch.from_numpy(a).to(dev) for a in (x, i, e)))
            for lv, bk, x, i, e, _raws in trace])
    return out


def k9_split(sources, dev, results) -> None:
    import torch

    from blingfire_tpu_torch import kernels
    from blingfire_tpu_torch.ops import lexer as lexer_ops

    argt = kernels.KERNELS["lexer_pass"][2]
    built = {}
    for label, path in sources:
        text = read_source(path, "bf_lexer_pass")
        stext, names = instrument(text, "lexer_pass_kernel")
        stamped = None
        if len(names) > 1:  # phase markers: a stamped copy too
            fn_s, err_s, setter = build(f"k9_{label}_stamped", stext,
                                        "bf_lexer_pass", argt, True)
            stamped = (_k9_launcher(fn_s, err_s), setter, names)
        fn, err, _ = build(f"k9_{label}", text, "bf_lexer_pass", argt, False)
        built[label] = (_k9_launcher(fn, err), stamped)
        results[f"k9:{label}"] = {"source": path,
                                  "phases": names if stamped else None,
                                  "paths": {}}
    for path, (t, launches) in k9_paths(dev).items():
        for level, bucket, x, init, elen in launches:
            B, M = x.shape
            r = measure.reads()
            cand, skip, *_ = lexer_ops._lexer_scan_plain(t, x, init, elen,
                                                         reads=r)
            want = lexer_ops.pack5(*lexer_ops._lexer_pass_plain(t, x, init,
                                                                elen))
            hops_m = lexer_ops.visited_chain(
                skip, torch.full_like(elen, M)).sum(1).double()
            hops_r = lexer_ops.visited_chain(skip, elen - 1).sum(1).double()
            starts = (torch.arange(M, device=dev)[None, :]
                      < (elen - 1)[:, None]).sum(1).double()
            del cand, skip
            for label, (call, stamped) in built.items():
                out = torch.empty_like(want)
                got = call(t, x, init, elen, out)
                torch.cuda.synchronize()
                measure.check(torch.equal(got, want), f"k9 {label} on {path} "
                              f"level {level} bucket {bucket} differs from "
                              f"the plain version")
                ms = measure.cuda_ms(lambda: call(t, x, init, elen, out), 10)
                st = measure.new_stats(("lexer_pass",), "probe")
                measure.profiled_device_ms(
                    lambda: call(t, x, init, elen, out), st)
                row = {"level": level, "bucket": bucket, "rows": B,
                       "width": M, "ms": ms,
                       "device_ms": st[("lexer_pass", "probe")]["device_ms"],
                       "hops_to_end_mean": float(hops_m.mean()),
                       "hops_to_end_max": float(hops_m.max()),
                       "hops_to_r_mean": float(hops_r.mean()),
                       "hops_to_r_max": float(hops_r.max()),
                       "valid_starts_mean": float(starts.mean()),
                       "live_lane_steps": r.steps}
                if stamped:
                    call_s, setter, names = stamped
                    clk = torch.zeros((B, len(names)), dtype=torch.int64,
                                      device=dev)
                    measure.check(setter(clk.data_ptr()) == 0,
                                  "cudaMemcpyToSymbol of the stamp buffer "
                                  "failed")
                    got = call_s(t, x, init, elen, torch.empty_like(want))
                    torch.cuda.synchronize()
                    measure.check(torch.equal(got, want), f"k9 {label}'s "
                                  f"stamped copy differs")
                    tot = clk.cpu().double().sum(0)
                    row.update(
                        ms_stamped=measure.cuda_ms(
                            lambda: call_s(t, x, init, elen, out), 10),
                        cycles={p: float(c) for p, c in zip(names, tot)},
                        share={p: float(c / tot.sum())
                               for p, c in zip(names, tot)})
                results[f"k9:{label}"]["paths"].setdefault(path, []).append(
                    row)
                shares = ({p: round(v, 4) for p, v in row["share"].items()}
                          if stamped else None)
                measure.log(
                    f"[k9 {label}] {path} level {level} bucket {bucket}: {B} "
                    f"rows of {M}; {ms:.5f} ms events, device "
                    f"{row['device_ms']} ms, stamped {row.get('ms_stamped')} "
                    f"ms; shares {shares}; hops a row to the end "
                    f"{row['hops_to_end_mean']:.1f} (max "
                    f"{row['hops_to_end_max']:.0f}), to the R anchor "
                    f"{row['hops_to_r_mean']:.1f}; valid starts "
                    f"{row['valid_starts_mean']:.1f}; live lane-steps "
                    f"{r.steps}")


def k1_rows(dev):
    """[(label, tables, spm_iw, x, lengths, lw, bounded)]: the gpt2-shaped
    model's three unit regions of one 4 MiB batch, and main-ww's first
    launch."""
    from blingfire_tpu_torch import native, testing
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.ops import bpe as bpe_ops
    from blingfire_tpu_torch.runtime import dedup
    from blingfire_tpu_torch.runtime.host import SpTokenizer

    docs = testing.zipf_corpus(measure.CORPUS_BYTES)
    gpt2 = load_bytes(testing.gpt2_shaped_model_bytes())
    tok = SpTokenizer(gpt2, max_doc_symbols=128, device=dev.type)
    spm = tok._unit_runner().spm_iw
    rows = [(f"gpt2 region {i}", tok.tables, spm, x, ln, lw, b)
            for i, (x, ln, lw, b) in enumerate(measure.packed_regions(
                native, tok, docs, spm, True, None, dev))]
    wtok = SpTokenizer(gpt2, max_doc_symbols=measure.WIDE_DOC,
                       device=dev.type)
    _ub, _w, launches, _ts, _tp = measure.units_np_launches(
        wtok, measure.corpus_prefix(docs, measure.CMP_BYTES), dedup, bpe_ops,
        dev)
    x, ln = launches[0]
    rows.append(("main-ww launch 0", wtok.tables, wtok._unit_runner().spm_iw,
                 x, ln, None, False))
    return rows


def k1_host_ns(bpe_ops, kernels, t, x, ln, spm, lw, bounded,
               n: int = 1000) -> dict:
    """Host ns a call of the checkout's K1 wrapper and of its parts: the
    checks, the outputs' allocation as a tensor each (as the wrapper makes
    them) and as strided views of one buffer, the table pointers, the
    ctypes call with its launch, the whole wrapper."""
    import torch

    LW = bpe_ops._walk_depth(t, lw)
    B, N = x.shape
    dev = x.device
    fn, _err = kernels._fns["bpe_walk"]
    out = torch.empty((LW, B, N), dtype=torch.int32, device=dev)
    ovf = torch.empty((B, N), dtype=torch.bool, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    trie = t.trie_next
    args = (x.data_ptr(), ln.data_ptr(), trie.data_ptr(), trie.shape[0],
            t.base.data_ptr(), t.owner.data_ptr(), t.nxt.data_ptr(),
            t.ow.data_ptr(), t.final.data_ptr(), t.ids_tab.data_ptr(),
            t.ranks_tab.data_ptr(), None, t.base.shape[0], t.n_slots,
            t.ids_tab.shape[0], B, N, LW, t.trie_a, t.trie_v, t.trie_root,
            spm, 0, out.data_ptr(), None, ovf.data_ptr())
    rank = bpe_ops.rank_mode(t)

    def views():  # one allocation, each output a strided view of it
        n = LW * B * N
        planes = 2 if rank else 1
        buf = x.new_empty(planes * n + (B * N + 3) // 4)
        lanes = (B * N, N, 1)
        return (buf.as_strided((LW, B, N), lanes),
                buf.view(torch.float32).as_strided((LW, B, N), lanes, n)
                if rank else None,
                buf.view(torch.bool).as_strided((B, N), lanes[1:],
                                                4 * planes * n))

    def separate():  # as ops/bpe.py::bpe_walk allocates
        return (torch.empty((LW, B, N), dtype=torch.int32, device=dev),
                torch.empty((LW, B, N), dtype=torch.float32, device=dev)
                if rank else None,
                torch.empty((B, N), dtype=torch.bool, device=dev))

    def pointers():  # the table arguments, as the wrapper takes them
        return (t.trie_next.data_ptr(), t.base.data_ptr(),
                t.owner.data_ptr(), t.nxt.data_ptr(), t.ow.data_ptr(),
                t.final.data_ptr(), t.ids_tab.data_ptr(),
                t.ranks_tab.data_ptr())

    parts = {
        "checks": lambda: (kernels.check(x, torch.int32, (B, N), "x_iw"),
                           kernels.check(ln, torch.int32, (B,), "lengths")),
        "alloc_separate": separate,
        "alloc_views": views,
        "table_pointers": pointers,
        "ctypes_call": lambda: fn(*args, stream),
        "wrapper": lambda: bpe_ops.bpe_walk(t, x, ln, spm, lw=lw,
                                            bounded=bounded),
    }
    # the two allocations in turns (separate, views, views, separate): the
    # host's speed drifts within a call
    order = ["checks", "alloc_separate", "alloc_views", "alloc_views",
             "alloc_separate", "table_pointers", "ctypes_call", "wrapper"]
    runs: dict = {}
    for part in order:
        f = parts[part]
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            f()
        runs.setdefault(part, []).append((time.perf_counter_ns() - t0) / n)
        torch.cuda.synchronize()
    return {part: sum(v) / len(v) for part, v in runs.items()} | {
        "turns": {p: runs[p] for p in ("alloc_separate", "alloc_views")}}


def k1_split(sources, dev, results) -> None:
    import torch

    from blingfire_tpu_torch import kernels
    from blingfire_tpu_torch.ops import bpe as bpe_ops

    kernels._load("bpe_walk")
    own = kernels._fns["bpe_walk"]
    built = {}
    for label, path in sources:
        text = read_source(path, "bf_bpe_walk")
        fn, err, _ = build(f"k1_{label}", text, "bf_bpe_walk",
                           kernels.KERNELS["bpe_walk"][2], False)
        built[label] = (fn, err)
        results[f"k1:{label}"] = {"source": path, "rows": {}}
    rows = k1_rows(dev)
    for name, t, spm, x, ln, lw, bounded in rows:
        B, N = x.shape
        LW = bpe_ops._walk_depth(t, lw)
        ovf = t.max_len > LW and not bounded
        want = bpe_ops._walk_plain(t, x, ln, spm, LW, ovf)
        for label, entry in built.items():
            kernels._fns["bpe_walk"] = entry
            try:
                got = bpe_ops.bpe_walk(t, x, ln, spm, lw=lw, bounded=bounded)
                torch.cuda.synchronize()
                measure.check(all(torch.equal(a, b)
                                  for a, b in zip(got, want) if a is not None),
                              f"k1 {label} on {name} differs from the plain "
                              f"version")
                caps = {}
                for cap in sorted({c for c in LW_CAPS if c < LW} | {LW}):
                    def call(cap=cap):
                        bpe_ops.bpe_walk(t, x, ln, spm, lw=cap,
                                         bounded=bounded or cap < LW)
                    ms = measure.cuda_ms(call, 50)
                    st = measure.new_stats(("bpe_walk",), "probe")
                    measure.profiled_device_ms(call, st)
                    caps[cap] = {"ms": ms,
                                 "device_ms": st[("bpe_walk", "probe")][
                                     "device_ms"]}
            finally:
                kernels._fns["bpe_walk"] = own
            ks = sorted(caps)
            lo, hi = ks[0], ks[-1]
            slope = ((caps[hi]["device_ms"] - caps[lo]["device_ms"])
                     / (hi - lo) * 1e6) if hi > lo else None
            results[f"k1:{label}"]["rows"][name] = {
                "rows": B, "width": N, "lw": LW, "caps": caps,
                "device_ns_a_step": slope}
            by_cap = {c: (round(v["ms"], 5), v["device_ms"])
                      for c, v in caps.items()}
            measure.log(f"[k1 {label}] {name}: {B} rows of {N}, LW {LW}; by "
                        f"cap (events ms, device ms) {by_cap}; device ns a "
                        f"step {slope}")
    name, t, spm, x, ln, lw, bounded = rows[0]
    ns = k1_host_ns(bpe_ops, kernels, t, x, ln, spm, lw, bounded)
    results["k1_host_ns"] = {"rows": list(x.shape), "ns": ns}
    parts = {k: v if k == "turns" else round(v) for k, v in ns.items()}
    measure.log(f"[k1] the checkout's wrapper's host ns a call at {name} "
                f"{tuple(x.shape)} (1,000 calls a part): {parts}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("phase_split: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    from blingfire_tpu_torch import kernels
    from blingfire_tpu_torch.buildutil import build_dir

    os.environ.setdefault("BLINGFIRE_TPU_TORCH_CACHE",
                          build_dir("model_cache"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    measure.log(smi)
    args = sys.argv[1:]
    out_path = os.path.join(build_dir(), "phase_split.json")
    srcs = {"k9": [], "k1": []}
    while args:
        a = args.pop(0)
        if a == "--out":
            out_path = args.pop(0)
        else:
            k, _c, rest = a.partition(":")
            label, eq, path = rest.partition("=")
            if not eq or "/" in label:  # no label
                label, path = os.path.basename(rest), rest
            srcs[k].append((label, path))
    srcs["k9"] = srcs["k9"] or [("checkout", os.path.join(
        kernels.CSRC, "lexer_pass.cu"))]
    srcs["k1"] = srcs["k1"] or [("checkout", os.path.join(
        kernels.CSRC, "bpe_walk.cu"))]
    dev = torch.device("cuda")
    results = {}
    t0 = time.perf_counter()
    k9_split(srcs["k9"], dev, results)
    k1_split(srcs["k1"], dev, results)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"card": smi, "results": results}, f, indent=1)
    for key, res in results.items():
        print(json.dumps({"probe": key, **res}))
    measure.log(f"phase_split: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
