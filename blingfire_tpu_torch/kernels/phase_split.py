"""The time split of K9 lexer_pass, K1 bpe_walk, K5 unigram_walk, K7
wp_subword_dense (with K8 wp_subword_comb), K10 hyph_segment and K12
shard_stats on the card.

    python3 -m blingfire_tpu_torch.kernels.phase_split [--out FILE]
        [--only k9,k1,k5,k7,k10,k12] [k9:LABEL=SOURCE ...]
        [k1:LABEL=SOURCE ...] [k5:LABEL=SOURCE ...] [k7:LABEL=SOURCE ...]
        [k10:LABEL=SOURCE ...] [k12:LABEL=SOURCE ...]

Each SOURCE defaults to this checkout's ``kernels/csrc/lexer_pass.cu``
(K9), ``bpe_walk.cu`` (K1), ``unigram_walk.cu`` (K5) and ``wp_subword.cu``
(K7 and K8), ``hyph_segment.cu`` (K10) and ``shard_stats.cu`` (K12),
labelled "checkout"; another version of a source (unpacked
with ``git archive`` into an ignored directory) is given as
``k9:LABEL=PATH``.  A source is built by nvcc for sm_90a beside the
checkout's headers and launched in place of the checkout's entry point
through the checkout's wrapper, so its entry point must take the
checkout's arguments.  ``--only`` runs the named kernels (by default all six).  Two versions
given in turns under four labels (parent, change, change2, parent2) are
timed against the host's and the card's drift.

Phase stamps: a source with phase marker comments (``// ---- NAME``, in
the kernel or in a device function of the source it calls) is also built as a
copy with a ``clock64()`` stamp at each marker.  Thread 0 of each block
adds the cycles since the last marker to the phase it closes; the block's
sums are written at the kernel's end.

K9: the rows of every launch of one uncached 4 MiB batch on the words
(wbd), sentences (sbd) and wp_lexer (bert-shaped) paths, as chip_smoke.py's
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

K5: events and device ms on the xlnet-shaped model's three unit regions of
one uncached 4 MiB batch in the dense, wide and comb table modes, and on
main-ww's launches (304 rows of 1,024), each equal to the plain version;
the walk's live lane-steps against all B * N * L.

K7 and K8: the packed rows of both unit-length classes of one uncached
4 MiB batch, as chip_smoke.py's kernels-w packs them, of the bert-shaped
model's dense pass (K7, main-w) and comb pass (K8, main-wc: the dense
table declined by force) and of the multilingual-bert-shaped model's comb
pass (K8, main-wm: declined by the cap; and on one 4 MiB batch of its own
multilingual traffic, testing.mbert_docs): events and device ms of the
batch in one launch (as the hybrid launches it), equal to the plain
version, with markers each phase's share and the cycles of the row each
block's thread 0 runs; for K7 also each class alone (as the data-parallel
runner launches a slab); the visited chain's hops a row and the walk's
live lane-steps.

K10: the rows of chip_smoke.py's kernels-h (the syllab-shaped model on
the distinct words of the 32 MiB corpus and the edge words, one segment
a bucket): per bucket and source, exactness against the plain version
(tolerance 0), events and device ms, with markers the phase shares, and
the launch floor: events and device ms of the source with the kernel's
body emptied, at the same grid.  A source with the packed entry point
``bf_hyph_segment_packed`` is also timed in one launch over every bucket.

K12: seeded slabs of main-dp's six shapes and lanes (``measure.DP_SLABS``,
the WordPiece slabs strided with their count column): per slab and
source, exactness, events and device ms, the empty kernel's (the launch
floor), and those of a build whose atomicAdds are replaced by stores
that never happen (timed only: its sums are wrong).

Prints the card's name, power limit and SM clock, one log line per launch
and a JSON object per kernel; writes them all to FILE (default
build/blingfire_tpu_torch/phase_split.json).  Needs one card;
imports nothing of JAX or of blingfire_tpu.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import re
import subprocess
import sys
import time

from blingfire_tpu_torch import measure

MARKER = re.compile(r"^[ \t]*// -+ ([A-Z]+)[ \t]*$", re.M)
INCLUDE = re.compile(r"^#include [^\n]*", re.M)
# the stamps' state lives in shared memory at file scope, so a marker in a
# device function the kernel calls stamps too
STAMP_HEAD = r"""
__device__ unsigned long long* bf_phase_clock;
extern "C" int bf_phase_set(unsigned long long* p) {
    return (int)cudaMemcpyToSymbol(bf_phase_clock, &p, sizeof(p));
}
__shared__ unsigned long long bf_acc[BF_NPHASE];
__shared__ unsigned long long bf_last;
__shared__ int bf_cur;
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


@functools.lru_cache(maxsize=1)
def _corpus():
    from blingfire_tpu_torch import testing

    return testing.zipf_corpus(measure.CORPUS_BYTES)


@contextlib.contextmanager
def swapped(fns: dict):
    """The checkout's wrappers launch the entry points of ``fns`` (name ->
    (entry point, bf_error_string)) in place of their own."""
    from blingfire_tpu_torch import kernels

    saved = {n: kernels._fns.get(n) for n in fns}
    kernels._fns.update(fns)
    try:
        yield
    finally:
        for n, f in saved.items():
            if f is None:
                kernels._fns.pop(n, None)
            else:
                kernels._fns[n] = f


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
    """The source with a stamp at each phase marker (anywhere in it) and at
    the end of ``kernel``, which starts the clock and writes each block's
    sums; the phase names ("START" first: before the first marker)."""
    lo, hi = _body(src, kernel)
    marks = list(MARKER.finditer(src))
    names = ["START"] + [m.group(1) for m in marks]
    uniq = list(dict.fromkeys(names))
    n = len(uniq)
    cuts = sorted([(m.end(), f"\n    BF_PHASE({uniq.index(m.group(1))});")
                   for m in marks]
                  + [(lo, f"\n    if (threadIdx.x == 0) {{"
                          f"\n        for (int bf_k = 0; bf_k < {n}; ++bf_k)"
                          f" bf_acc[bf_k] = 0;"
                          f"\n        bf_last = clock64();"
                          f"\n        bf_cur = 0;\n    }}"),
                     (hi, "\n    BF_PHASE(0);\n    if (threadIdx.x == 0)"
                          f"\n        for (int bf_k = 0; bf_k < {n}; ++bf_k)"
                          f"\n            bf_phase_clock[(size_t)blockIdx.x "
                          f"* {n} + bf_k] = bf_acc[bf_k];\n")])
    out, last = [], 0
    for at, text in cuts:
        out += [src[last:at], text]
        last = at
    text = "".join(out + [src[last:]])
    inc = list(INCLUDE.finditer(text))[-1].end()  # after the last #include
    return (text[:inc] + f"\n#define BF_NPHASE {n}" + STAMP_HEAD
            + text[inc:], uniq)


def build(tag: str, text: str, entries: dict, stamped: bool):
    """nvcc ``text`` into a library beside the checkout's kernels: ({name:
    (entry point, bf_error_string)} of ``entries``, name -> (C entry, its
    argtypes before the stream), and the phase-buffer setter or None)."""
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
    lib.bf_error_string.restype = ctypes.c_char_p
    lib.bf_error_string.argtypes = [ctypes.c_int]
    fns = {}
    for name, (entry, argtypes) in entries.items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fns[name] = (fn, lib.bf_error_string)
    setter = None
    if stamped:
        setter = lib.bf_phase_set
        setter.restype = ctypes.c_int
        setter.argtypes = [ctypes.c_void_p]
    return fns, setter


def _own(name: str) -> dict:
    """{name: (C entry, argtypes)} of the checkout's kernel ``name``."""
    from blingfire_tpu_torch import kernels

    _src, entry, argtypes = kernels.KERNELS[name]
    return {name: (entry, argtypes)}


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


def _k9_launcher(fns):
    """call(t, x, init, elen, out) of one build of a K9 source."""
    from blingfire_tpu_torch.ops import lexer as lexer_ops

    def call(t, x, i, e, o):
        with swapped(fns):
            return lexer_ops.lexer_pass_packed(t, x, i, e, out=o)
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

    docs = measure.corpus_prefix(_corpus(), measure.CMP_BYTES)
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

    from blingfire_tpu_torch.ops import lexer as lexer_ops

    built = {}
    for label, path in sources:
        text = read_source(path, "bf_lexer_pass")
        stext, names = instrument(text, "lexer_pass_kernel")
        stamped = None
        if len(names) > 1:  # phase markers: a stamped copy too
            fns, setter = build(f"k9_{label}_stamped", stext,
                                _own("lexer_pass"), True)
            stamped = (_k9_launcher(fns), setter, names)
        fns, _ = build(f"k9_{label}", text, _own("lexer_pass"), False)
        built[label] = (_k9_launcher(fns), stamped)
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

    docs = _corpus()
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
    built = {}
    for label, path in sources:
        text = read_source(path, "bf_bpe_walk")
        built[label] = build(f"k1_{label}", text, _own("bpe_walk"), False)[0]
        results[f"k1:{label}"] = {"source": path, "rows": {}}
    rows = k1_rows(dev)
    for name, t, spm, x, ln, lw, bounded in rows:
        B, N = x.shape
        LW = bpe_ops._walk_depth(t, lw)
        ovf = t.max_len > LW and not bounded
        want = bpe_ops._walk_plain(t, x, ln, spm, LW, ovf)
        for label, fns in built.items():
            with swapped(fns):
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


def k5_rows(dev):
    """[(rows, mode, tables, x, lengths, lw)]: the xlnet-shaped model's
    three unit regions of one uncached CMP_BYTES batch in the dense, wide
    and comb modes, and main-ww's launches (rows of 1,024, the walk at the
    model's max_len) in the dense mode."""
    from blingfire_tpu_torch import native, testing
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.ops import bpe as bpe_ops
    from blingfire_tpu_torch.ops import unigram as uni_ops
    from blingfire_tpu_torch.runtime import dedup
    from blingfire_tpu_torch.runtime.host import SpTokenizer

    docs = _corpus()
    model = load_bytes(testing.xlnet_shaped_model_bytes())
    tok = SpTokenizer(model, max_doc_symbols=128, device=dev.type)
    regions = measure.packed_regions(native, tok, docs,
                                     tok._unit_runner().spm_iw, False,
                                     tok.seg.charmap, dev)
    rows = []
    for mode in measure.UNI_MODES:
        t = measure.unigram_tables(uni_ops, tok, mode, dev)
        rows += [(f"region {i}", mode, t, x, ln, lw if bounded else None)
                 for i, (x, ln, lw, bounded) in enumerate(regions)]
    wtok = SpTokenizer(model, max_doc_symbols=measure.WIDE_DOC,
                       device=dev.type)
    _ub, _w, launches, _ts, _tp = measure.units_np_launches(
        wtok, measure.corpus_prefix(docs, measure.CMP_BYTES), dedup, bpe_ops,
        dev)
    rows += [(f"main-ww launch {j}", "dense", wtok.tables, x, ln, None)
             for j, (x, ln) in enumerate(launches)]
    return rows


def k5_split(sources, dev, results) -> None:
    import torch

    from blingfire_tpu_torch import kernels
    from blingfire_tpu_torch.ops import unigram as uni_ops

    kernels._load("unigram_walk")
    built = {}
    for label, path in sources:
        text = read_source(path, "bf_unigram_walk")
        built[label] = build(f"k5_{label}", text, _own("unigram_walk"),
                             False)[0]
        results[f"k5:{label}"] = {"source": path, "rows": [], "batch": {}}
    for name, mode, t, x, ln, lw in k5_rows(dev):
        B, N = x.shape
        L = uni_ops.walk_depth(t, lw)
        r = measure.reads()
        want = uni_ops._walk_plain(t, x, ln, L, reads=r)

        def call():
            return uni_ops.unigram_walk(t, x, ln, lw=lw)

        for label, fns in built.items():
            row = {"rows": name, "mode": mode, "B": B, "N": N, "L": L,
                   "live_lane_steps": r.steps, "lane_steps": B * N * L}
            with swapped(fns):
                got = call()
                torch.cuda.synchronize()
                measure.check(all(map(torch.equal, got, want)),
                              f"k5 {label} on {mode} {name} differs from "
                              f"the plain version")
                del got
                row["ms"] = measure.cuda_ms(call, 50)
                st = measure.new_stats(("unigram_walk",), "probe")
                measure.profiled_device_ms(call, st)
                row["device_ms"] = st[("unigram_walk", "probe")]["device_ms"]
            res = results[f"k5:{label}"]
            res["rows"].append(row)
            key = mode if name.startswith("region") else "main-ww"
            for k, v in row.items():
                if k.endswith("ms"):
                    res["batch"].setdefault(key, {}).setdefault(k, 0.0)
                    res["batch"][key][k] += v
            measure.log(f"[k5 {label}] {mode} {name}: {B} rows of {N}, L {L}"
                        f"; live lane-steps {r.steps} of {B * N * L}; "
                        + ", ".join(f"{k} {v:.5f}" for k, v in row.items()
                                    if k.endswith("ms")))
        del want
    for label in built:
        measure.log(f"[k5 {label}] a 4 MiB batch (regions summed) and "
                    f"main-ww: {results[f'k5:{label}']['batch']}")


def k7_rows(dev):
    """[(label, hybrid, x, init, class_rows)]: the packed rows of one
    uncached CMP_BYTES batch of the bert-shaped model's dense pass (K7,
    main-w) and comb pass (K8, main-wc: the dense table declined by force),
    as chip_smoke.py's kernels-w packs them, and of the multilingual-bert-
    shaped model, whose dense table the hybrid declines by itself (K8,
    main-wm), also on a batch of its own multilingual traffic."""
    import torch

    from blingfire_tpu_torch import testing
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.ops import lexer as lexer_ops
    from blingfire_tpu_torch.runtime.wp_hybrid import WordPieceHybrid

    model = load_bytes(testing.bert_shaped_model_bytes())
    hyb = WordPieceHybrid(model, device=dev)
    saved = lexer_ops.DENSE_MAX_ENTRIES
    lexer_ops.DENSE_MAX_ENTRIES = -1
    try:
        hyb_c = WordPieceHybrid(model, device=dev)
    finally:
        lexer_ops.DENSE_MAX_ENTRIES = saved
    hyb_m = WordPieceHybrid(load_bytes(testing.mbert_shaped_model_bytes()),
                            device=dev)
    measure.check(hyb_m._dense is None, "the mbert-shaped model kept its "
                  "dense table")
    sub = measure.corpus_prefix(_corpus(), measure.CMP_BYTES)
    ml = testing.mbert_docs(measure.CMP_BYTES)
    out = []
    for label, h, a, docs in (("main-w", hyb, hyb, sub),
                              ("main-wc", hyb_c, hyb, sub),
                              ("main-wm", hyb_m, hyb_m, sub),
                              ("multilingual", hyb_m, hyb_m, ml)):
        nh, u_syms, u_soff, u_fn = a._analyze(docs)
        a._rt.BtlWpFree(nh)
        px, pinit, class_rows, _r, _o = h._pack(u_syms, u_soff, u_fn)
        out.append((label, h, torch.from_numpy(px).to(dev),
                    torch.from_numpy(pinit).to(dev), class_rows))
    return out


def _wp_plain(h, x, init, lw: int, r):
    """(the plain pass's rows, each start's skip target) of hybrid ``h``
    on rows ``x`` at walk depth ``lw``; ``r`` notes the reads."""
    from blingfire_tpu_torch.ops import lexer as lexer_ops

    if h._dense is None:
        fp, fo = lexer_ops._walk_comb_plain(h.tables, x, init, h._r_iw, lw,
                                            reads=r)
    else:
        dnext, ow_perm, _p, n_f, _n = h._dense
        fp, fo = lexer_ops._walk_dense_plain(h.tables, dnext, ow_perm, x, init,
                                             h._r_iw, lw, n_f, h._n_iws,
                                             reads=r)
    skip = lexer_ops._emit_lanes(h.tables, x, fp, fo, h._l_iw, h._r_iw)[0]
    return (lexer_ops._emit_plain(h.tables, x, fp, fo, h._l_iw, h._r_iw,
                                  reads=r), skip)


def _k7_builds(label: str, path: str):
    """(fns, stamped copies {kernel name: ((fns, setter), phases)}) of one
    source, whose entry points take the checkout's arguments."""
    text = read_source(path, "bf_wp_subword_dense")
    entries = _own("wp_subword_dense") | _own("wp_subword_comb")
    fns, _ = build(f"k7_{label}", text, entries, False)
    stamped = {}
    for name in ("wp_subword_dense", "wp_subword_comb"):
        stext, phases = instrument(text, f"{name}_kernel")
        if len(phases) > 1:  # phase markers: a stamped copy too
            stamped[name] = (build(f"k7_{label}_{name}", stext, entries,
                                   True), phases)
    return fns, stamped


def k7_split(sources, dev, results) -> None:
    import torch

    from blingfire_tpu_torch import kernels
    from blingfire_tpu_torch.ops import lexer as lexer_ops

    kernels._load("wp_subword_dense")
    built = {}
    for label, path in sources:
        built[label] = _k7_builds(label, path)
        results[f"k7:{label}"] = {
            "source": path,
            "phases": {n: v[1] for n, v in built[label][1].items()},
            "classes": [], "batch": {}}
    for batch_label, h, x, init, class_rows in k7_rows(dev):
        name = "wp_subword_comb" if h._dense is None else "wp_subword_dense"
        B, M = x.shape
        classes = [(lo, hi, lw) for lo, hi, lw in class_rows if hi > lo]
        plain = []
        for lo, hi, lw in classes:
            r = measure.reads()
            want, skip = _wp_plain(h, x[lo:hi], init[lo:hi], lw, r)
            hops = lexer_ops.visited_chain(skip, torch.full(
                (hi - lo,), M, dtype=torch.int32, device=dev)).sum(1).double()
            plain.append((want, hops, r.steps))
        want_all = torch.cat([p[0] for p in plain])
        hops_all = torch.cat([p[1] for p in plain])
        out = torch.empty((B, M + 2), dtype=torch.int32, device=dev)

        def batch():
            h._passes(x, init, class_rows, out)
            return out

        for label, (fns, stamped) in built.items():
            res = results[f"k7:{label}"]
            with swapped(fns):
                out.fill_(-7)
                batch()
                torch.cuda.synchronize()
                measure.check(torch.equal(out, want_all), f"k7 {label}: "
                              f"{name} differs from the plain version on "
                              f"{batch_label}")
                ms, dms = _times(batch, name, 50)
            row = {"pass": name, "rows": B, "classes": [
                (hi - lo, lw) for lo, hi, lw in classes], "ms": ms,
                "device_ms": dms, "hops_mean": float(hops_all.mean()),
                "live_lane_steps": sum(p[2] for p in plain)}
            if name in stamped:
                row.update(_stamp_shares(stamped[name], (B + 3) // 4,
                                         batch, want_all))
            res["batch"][batch_label] = row
            measure.log(f"[k7 {label}] {batch_label} {name}: a 4 MiB batch "
                        f"in one launch: " + json.dumps(row))
            if name != "wp_subword_dense":  # K8 runs in the one launch only
                continue
            for (lo, hi, lw), (want, hops, steps) in zip(classes, plain):
                oc = out[lo:hi]

                def one(lo=lo, hi=hi, lw=lw, oc=oc):
                    h._passes(x[lo:hi], init[lo:hi], [(0, hi - lo, lw)], oc)
                    return oc

                with swapped(fns):
                    one()
                    torch.cuda.synchronize()
                    measure.check(torch.equal(oc, want), f"k7 {label}: a "
                                  f"class differs")
                    ms, dms = _times(one, name, 50)
                row = {"pass": name, "lw": lw, "rows": hi - lo, "width": M,
                       "ms": ms, "device_ms": dms,
                       "hops_mean": float(hops.mean()),
                       "hops_max": float(hops.max()),
                       "live_lane_steps": steps}
                if name in stamped:
                    row.update(_stamp_shares(stamped[name],
                                             (hi - lo + 3) // 4, one, want))
                res["classes"].append(row)
                measure.log(f"[k7 {label}] " + json.dumps(row))


def hollow(src: str, kernel: str) -> str:
    """The source with the body of the __global__ ``kernel`` emptied: its
    launcher starts an empty kernel at the same grid, block and dynamic
    shared memory (the launch floor)."""
    lo, hi = _body(src, kernel)
    return src[:lo] + "\n" + src[hi:]


ATOMIC_ADD = re.compile(r"atomicAdd\(([^,;]+),\s*([^;]+)\);")


def no_atomics(src: str) -> str:
    """The source with each ``atomicAdd(p, v);`` replaced by a store that a
    value never met guards, so the sums stay live but nothing is added:
    timed only, to weigh the atomics (its sums are wrong)."""
    out, n = ATOMIC_ADD.subn(r"if ((\2) == 0x5bd1e9955bd1e995ULL) *(\1) = (\2);",
                             src)
    if not n:
        raise ValueError("no atomicAdd in the source")
    return out


def _times(call, name: str, reps: int) -> tuple[float, float]:
    """(events ms, profiler device ms) a call of ``call``, which launches
    kernel ``name`` once."""
    ms = measure.cuda_ms(call, reps)
    st = measure.new_stats((name,), "probe")
    measure.profiled_device_ms(call, st)
    return ms, st[(name, "probe")]["device_ms"]


def _stamp_shares(stamped, blocks: int, call, want) -> dict:
    """Each phase's share of the stamped blocks' cycles ("share") and its
    cycles a block that stamped ("cycles_a_block": thread 0's, which in
    K7 and K8 walks the block's first row): ``stamped`` is ((fns, setter),
    phases) of a stamped build; ``call`` launches at most ``blocks`` blocks
    and must return ``want``."""
    import torch

    (fns, setter), phases = stamped
    clk = torch.zeros((blocks, len(phases)), dtype=torch.int64, device="cuda")
    measure.check(setter(clk.data_ptr()) == 0, "cudaMemcpyToSymbol of the "
                  "stamp buffer failed")
    with swapped(fns):
        got = call()
        torch.cuda.synchronize()
    measure.check(torch.equal(got, want), "the stamped copy differs")
    clk = clk.cpu().double()
    tot = clk.sum(0)
    n = int((clk != 0).any(1).sum())
    return {"share": {p: float(c / tot.sum()) for p, c in zip(phases, tot)},
            "cycles_a_block": {p: float(c) / n
                               for p, c in zip(phases, tot)}}


def k10_rows(dev):
    """(HyphTpu, [(bucket, x, word_len) of each segment]): the rows of
    chip_smoke.py's kernels-h, the syllab-shaped model on the distinct
    words of the 32 MiB corpus and the edge words."""
    import torch

    from blingfire_tpu_torch import testing
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.runtime.hyph import HyphTpu

    hy = HyphTpu(load_bytes(testing.syllab_shaped_model_bytes()), device=dev)
    words = testing.corpus_words(_corpus()) + testing.hyph_edge_words()
    _uniq, trace = measure.hyph_segments(hy, words)
    return hy, [(bk, torch.from_numpy(x).to(dev), torch.from_numpy(wl).to(dev))
                for bk, x, wl, _w in trace]


def k10_split(sources, dev, results) -> None:
    import torch

    from blingfire_tpu_torch import kernels
    from blingfire_tpu_torch.ops import hyph as hyph_ops

    kernels._load("hyph_segment")
    kern = "hyph_segment_kernel"
    built = {}
    for label, path in sources:
        text = read_source(path, "bf_hyph_segment")
        entries = _own("hyph_segment")
        if "bf_hyph_segment_packed(" in text:  # one launch for all buckets
            entries |= _own("hyph_segment_packed")
        stext, phases = instrument(text, kern)
        built[label] = {
            "kernel": build(f"k10_{label}", text, entries, False)[0],
            "floor": build(f"k10_{label}_empty", hollow(text, kern), entries,
                           False)[0],
            "stamped": ((build(f"k10_{label}_stamped", stext, entries, True),
                         phases) if len(phases) > 1 else None)}
        results[f"k10:{label}"] = {"source": path, "phases": phases
                                   if len(phases) > 1 else None,
                                   "buckets": [], "packed": None}
    hy, segs = k10_rows(dev)
    t = hy.tables
    plain = []
    for _bucket, x, wl in segs:
        r = measure.reads()
        plain.append((hyph_ops._hyph_segment_plain(t, x, wl, reads=r),
                      measure.hyph_bytes(x, wl, r), r.steps))
    for label, b in built.items():
        res = results[f"k10:{label}"]
        for (bucket, x, wl), (want, (nb, _ops), steps) in zip(segs, plain):
            B, M = x.shape

            def call(x=x, wl=wl):
                return hyph_ops.hyph_segment(t, x, wl)

            row = {"bucket": bucket, "rows": B, "width": M,
                   "live_lane_steps": steps,
                   "bound_ms": nb / measure.HBM_BYTES_PER_S * 1e3}
            with swapped(b["kernel"]):
                got = call()
                torch.cuda.synchronize()
                measure.check(torch.equal(got, want), f"k10 {label} bucket "
                              f"{bucket} differs from the plain version")
                row["ms"], row["device_ms"] = _times(call, "hyph_segment", 20)
            with swapped(b["floor"]):
                row["floor_ms"], row["floor_device_ms"] = _times(
                    call, "hyph_segment", 20)
            if b["stamped"]:
                row.update(_stamp_shares(b["stamped"], B, call, want))
            res["buckets"].append(row)
            measure.log(f"[k10 {label}] " + json.dumps(row))
        if "hyph_segment_packed" not in b["kernel"]:
            continue
        buf, pk = hyph_ops.pack_rows([(x.cpu().numpy(), wl.cpu().numpy())
                                      for _b, x, wl in segs])
        bufd = torch.from_numpy(buf).to(dev)
        want = torch.cat([p[0].reshape(-1) for p in plain])

        def packed():
            return hyph_ops.hyph_segment_packed(t, bufd, pk)

        row = {"segments": len(segs), "rows": sum(pk.rows),
               "tiles": pk.n_tiles,
               "tile_rows": [hyph_ops.tile_rows(m) for m in pk.widths],
               "bound_ms": sum(p[1][0] for p in plain)
               / measure.HBM_BYTES_PER_S * 1e3}
        with swapped(b["kernel"]):
            got = packed()
            torch.cuda.synchronize()
            measure.check(torch.equal(got, want), f"k10 {label}'s packed "
                          f"launch differs from the plain version")
            row["ms"], row["device_ms"] = _times(packed, "hyph_segment", 20)
        with swapped(b["floor"]):
            row["floor_ms"], row["floor_device_ms"] = _times(
                packed, "hyph_segment", 20)
        if b["stamped"]:
            row.update(_stamp_shares(b["stamped"], pk.n_tiles, packed,
                                     want))
        res["packed"] = row
        measure.log(f"[k10 {label}] one launch: " + json.dumps(row))


def k12_split(sources, dev, results) -> None:
    import torch

    from blingfire_tpu_torch import kernels
    from blingfire_tpu_torch.parallel import mesh

    kernels._load("shard_stats")
    kern = "shard_stats_kernel"
    entries = _own("shard_stats")
    built = {}
    for label, path in sources:
        text = read_source(path, "bf_shard_stats")
        built[label] = {
            "kernel": build(f"k12_{label}", text, entries, False)[0],
            "floor": build(f"k12_{label}_empty", hollow(text, kern), entries,
                           False)[0],
            "no_atomics": build(f"k12_{label}_no_atomics", no_atomics(text),
                                entries, False)[0]}
        results[f"k12:{label}"] = {"source": path, "slabs": [], "sums": {}}
    slabs = measure.dp_slabs(dev)
    for label, b in built.items():
        res = results[f"k12:{label}"]
        for name, ids, counts in slabs:
            lanes, nb, _ops = measure.dp_bytes(ids, counts)
            acc = torch.zeros(2, dtype=torch.int64, device=dev)

            def call(ids=ids, counts=counts, acc=acc):
                return mesh.shard_stats(ids, counts, acc)

            row = {"slab": name, "rows": ids.shape[0], "lanes": lanes,
                   "strided": ids.stride(0) != ids.shape[1],
                   "bound_ms": nb / measure.HBM_BYTES_PER_S * 1e3}
            for part, fns in b.items():
                with swapped(fns):
                    if part == "kernel":
                        acc.zero_()
                        call()
                        got = mesh.finish_stats(acc)
                        want = mesh.finish_stats(mesh._shard_stats_plain(
                            ids, counts))
                        measure.check(got == want, f"k12 {label} on {name}: "
                                      f"{got} differs from the plain {want}")
                    key = "" if part == "kernel" else part + "_"
                    row[key + "ms"], row[key + "device_ms"] = _times(
                        call, "shard_stats", 50)
            res["slabs"].append(row)
            for k, v in row.items():
                if k.endswith("ms"):
                    res["sums"][k] = res["sums"].get(k, 0.0) + v
            measure.log(f"[k12 {label}] " + json.dumps(row))
        measure.log(f"[k12 {label}] six slabs: {res['sums']}")


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
    own = {"k9": "lexer_pass.cu", "k1": "bpe_walk.cu",
           "k5": "unigram_walk.cu", "k7": "wp_subword.cu",
           "k10": "hyph_segment.cu", "k12": "shard_stats.cu"}
    splits = {"k9": k9_split, "k1": k1_split, "k5": k5_split,
              "k7": k7_split, "k10": k10_split, "k12": k12_split}
    srcs = {k: [] for k in own}
    only = list(own)
    while args:
        a = args.pop(0)
        if a == "--out":
            out_path = args.pop(0)
        elif a == "--only":
            only = args.pop(0).split(",")
        else:
            k, _c, rest = a.partition(":")
            label, eq, path = rest.partition("=")
            if not eq or "/" in label:  # no label
                label, path = os.path.basename(rest), rest
            srcs[k].append((label, path))
    dev = torch.device("cuda")
    results = {}
    t0 = time.perf_counter()
    for k in only:
        splits[k](srcs[k] or [("checkout", os.path.join(kernels.CSRC,
                                                        own[k]))],
                  dev, results)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"card": smi, "results": results}, f, indent=1)
    for key, res in results.items():
        print(json.dumps({"probe": key, **res}))
    measure.log(f"phase_split: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
