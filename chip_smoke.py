"""GPU smoke run of the PyTorch/CUDA port (blingfire_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. card     the card's name and power limit (nvidia-smi);
  2. build    every CUDA source of the port, and its host library, compiled
              in parallel from the checkout;
  3. model    a seeded gpt2-shaped byte-BPE vocabulary (50,256 entries, see
              blingfire_tpu_torch/testing.py) compiled by the port's copy of
              the dict compiler, and the seeded 32 MiB Zipfian corpus;
  4. main     the byte-BPE path as a user drives it: SpTokenizer(model,
              max_doc_symbols=128, device="cuda") then encode_corpus_flat
              over the corpus; the launch counts of the path's kernels are
              read around this phase only and must be > 0; sampled
              documents must equal the port's scalar oracle;
  5. kernels  each BPE kernel's wrapper against its plain PyTorch version on
              the card, on packed rows of all three row regions at the main
              path's shapes; integers must agree exactly (tolerance 0);
  6. model-u  a seeded xlnet-shaped unigram-LM vocabulary (32,000 entries)
              with its charmap; its automaton's shape and table mode;
  7. main-u   the unigram path, as phase 4, over the same corpus: K5, K6 and
              K4 must each launch; sampled documents must equal the oracle;
  8. kernels-u K5 unigram_walk and K6 unigram_viterbi against their plain
              versions on the packed rows of all three regions of one
              uncached 4 MiB batch, in the dense, wide and comb table modes
              (forced through the port's module constants); tolerance 0.
Times per launch come from CUDA events after warm-up.  In the JSON line a
kernel's "ms", "plain_ms" and "bound_ms" cover its launches over the three
regions of one uncached 4 MiB batch on its path's main-path table mode
(scatter_trie: one launch over the whole trie); "device_ms" is the
profiler's device time for the same launches; "launches" is the count from
its path's main run (pack_out_compact: both paths, by path in
"launches_by_path").  The second-last line is the kernel table as JSON, the
last line the device.  Imports nothing of JAX or of blingfire_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 peak, taken for 32-bit scalar ops
CORPUS_BYTES = 32 << 20  # end-to-end corpus
CMP_BYTES = 4 << 20  # corpus prefix whose packed rows the kernels are held on
ORACLE_DOCS = 500  # documents checked against the scalar oracle
DF64_OPS = 14  # float32 operations per Viterbi candidate: df_add and compare
UNI_MODES = ("dense", "wide", "comb")
SOURCES = {
    "scatter_trie": ("blingfire_tpu_torch/kernels/csrc/scatter_trie.cu",
                     "blingfire_tpu/ops/bpe.py:161"),
    "bpe_walk": ("blingfire_tpu_torch/kernels/csrc/bpe_walk.cu",
                 "blingfire_tpu/ops/bpe.py:242"),
    "bpe_resolve": ("blingfire_tpu_torch/kernels/csrc/bpe_resolve.cu",
                    "blingfire_tpu/ops/bpe.py:340"),
    "pack_out_compact": ("blingfire_tpu_torch/kernels/pack_triton.py",
                         "blingfire_tpu/runtime/dedup.py:218"),
    "unigram_walk": ("blingfire_tpu_torch/kernels/csrc/unigram_walk.cu",
                     "blingfire_tpu/ops/unigram.py:164"),
    "unigram_viterbi": ("blingfire_tpu_torch/kernels/csrc/unigram_viterbi.cu",
                        "blingfire_tpu/ops/unigram.py:216"),
}
# profiler kernel names of each wrapper
KERNEL_NAMES = {"bpe_walk": ("bpe_walk_kernel",),
                "bpe_resolve": ("bpe_resolve_kernel",),
                "scatter_trie": ("fill_kernel", "scatter_kernel"),
                "pack_out_compact": ("_pack_kernel",),
                "unigram_walk": ("unigram_walk_kernel",),
                "unigram_viterbi": ("unigram_viterbi_kernel",)}


def check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean ms per call of fn over reps back-to-back calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        check(a.shape == b.shape, f"shapes differ: {a.shape} {b.shape}")
        if a.numel():
            d = (a.double() - b.double()).abs().max().item()
            err = max(err, float(d))
    return err


def _self_device_us(ev) -> float:
    """Self device time (us) of a profiler event (name differs by version)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(ev, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profiled_device_ms(fn, names, reps: int = 5) -> dict:
    """Profiler device ms per call of fn, summed over each wrapper's kernel
    names."""
    out = {k: None for k in names}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        t_us = _self_device_us(ev)
        for k in names:
            if any(pt in ev.key for pt in KERNEL_NAMES[k]) and t_us > 0:
                out[k] = (out[k] or 0.0) + t_us / 1e3 / reps
    return out


def new_stats(names) -> dict:
    return {k: dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, err=0.0,
                    library_ms=None) for k in names}


def live_gathers(tables, x, lengths, LW: int) -> int:
    """Trie gathers the BPE walk needs on these rows (live lane-steps)."""
    B, N = x.shape
    pos = torch.arange(N, device=x.device)
    pad = torch.full((B, LW + 1), -1, dtype=torch.int32, device=x.device)
    xp = torch.cat([x, pad], 1)
    state = torch.where((pos[None] < lengths[:, None]) & (x >= 0),
                        tables.trie_root, -1).to(torch.int32)
    trie = tables.trie_next
    n = 0
    for d in range(LW):
        c = xp[:, d : d + N]
        live = (state >= 0) & (c >= 0)
        n += int(live.sum())
        flat = (state.clamp(min=0).long() * tables.trie_a + c.clamp(min=0).long())
        state = torch.where(live, trie[flat.clamp(0, trie.numel() - 1)], -1)
    return n


def unigram_walk_work(uni_ops, tables, x, lengths, L: int) -> tuple[int, int]:
    """(live lane-steps, finals) of the unigram walk on these rows."""
    B, N = x.shape
    pos = torch.arange(N, device=x.device)
    pad = torch.full((B, L + 1), -1, dtype=torch.int32, device=x.device)
    xp = torch.cat([x, pad], 1)
    state = torch.where((pos[None] < lengths[:, None]) & (x >= 0), 0, -1)
    live_n = fin_n = 0
    for d in range(L):
        c = xp[:, d : d + N]
        live_n += int(((state >= 0) & (c >= 0)).sum())
        state, _ow, fin = uni_ops.walk_step(tables, state.to(torch.int32), c)
        fin_n += int(fin.sum())
    return live_n, fin_n


def run_main(tok, docs, label: str, kernels, metrics) -> dict:
    """The path's main run after SpTokenizer init: encode_corpus_flat three
    times (first, second, profiled); launch counts and peak memory from the
    init and the first call only (the caller resets both before init)."""
    n_bytes = sum(map(len, docs))
    c = metrics.Counters()
    t0 = time.perf_counter()
    ids, bounds = tok.encode_corpus_flat(docs, counters=c)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{label}] encode_corpus_flat {t_enc:.3f} s: {n_bytes / t_enc:.0f} "
        f"B/s, {len(ids) / t_enc:.0f} tokens/s, {len(ids)} tokens, "
        f"{c.fallback_docs} fallback docs, {c.batches} batches, "
        f"{c.dispatched_rows} rows, peak device memory {peak} B")
    log(f"[{label}] stage seconds {dict(c.stage_seconds)}")
    log(f"[{label}] launches {launches}")
    # the same call again in the same process: kernels built and compiled
    c2 = metrics.Counters()
    t0 = time.perf_counter()
    ids2, bounds2 = tok.encode_corpus_flat(docs, counters=c2)
    t_enc2 = time.perf_counter() - t0
    check(np.array_equal(ids2, ids) and np.array_equal(bounds2, bounds),
          "a second call gave other ids")
    log(f"[{label}] second call {t_enc2:.3f} s: {n_bytes / t_enc2:.0f} B/s, "
        f"{len(ids) / t_enc2:.0f} tokens/s; stage seconds "
        f"{dict(c2.stage_seconds)}")
    del ids2, bounds2
    # a third call under the profiler (CUDA activity only): device busy time
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tok.encode_corpus_flat(docs, counters=metrics.Counters())
        torch.cuda.synchronize()
    t_enc3 = time.perf_counter() - t0
    busy = sum(_self_device_us(ev) for ev in prof.key_averages()) / 1e6
    log(f"[{label}] profiled call {t_enc3:.3f} s: device busy {busy:.6f} s "
        f"({busy / t_enc3:.6f} of the call), idle share "
        f"{1 - busy / t_enc3:.6f}")
    check(n_bytes > 0 and len(ids) > 0 and peak > 0,
          "bytes, tokens and peak memory must all be > 0")
    check(bounds.shape == (len(docs) + 1,) and bounds[0] == 0
          and np.all(np.diff(bounds) >= 0) and bounds[-1] == len(ids),
          "bounds are not a partition of the ids")
    return dict(ids=ids, bounds=bounds, launches=launches, counters=c)


def check_oracle(tok, docs, ids, bounds, edge, label: str) -> None:
    """The edge cases and seeded sampled documents equal the scalar oracle."""
    rng = np.random.default_rng(0)
    sample = list(range(edge)) + list(
        rng.choice(np.arange(edge, len(docs)), ORACLE_DOCS - edge,
                   replace=False))
    t0 = time.perf_counter()
    for i in sample:
        want = tok._oracle.text_to_ids(docs[i], unk_id=0)
        got = ids[bounds[i] : bounds[i + 1]].tolist()
        check(got == want, f"{label}: doc {i}: ids differ from the oracle")
    log(f"[{label}] {len(sample)} sampled docs equal the oracle "
        f"({time.perf_counter() - t0:.1f} s)")


def packed_regions(native, tok, docs, spm_iw, raw_bytes: bool, charmap, dev):
    """Packed rows of an uncached CMP_BYTES corpus prefix, by region."""
    sub, tot = [], 0
    for d in docs:
        sub.append(d)
        tot += len(d)
        if tot >= CMP_BYTES:
            break
    nu = native.units_analyze(sub, tok.n_doc, tok._sym2iw, spm_iw, raw_bytes,
                              False, charmap)
    R = nu.n_rows
    check(R >= 2048, f"only {R} packed rows for the comparison")
    xd = torch.from_numpy(nu.px[:R]).to(dev)
    ld = torch.from_numpy(nu.plen[:R]).to(dev)
    bounds = [(0, nu.split_rows1, 8, True),
              (nu.split_rows1, nu.split_rows, 16, True),
              (nu.split_rows, R, 16, False)]
    return [(xd[lo:hi], ld[lo:hi], lw, b) for lo, hi, lw, b in bounds if hi > lo]


def bpe_kernels(tok, model, docs, native, bpe_ops, dedup, dev):
    """Phase 5: the BPE path's kernels against their plain versions."""
    tables = tok.tables
    runner = tok._unit_runner()
    regions = packed_regions(native, tok, docs, runner.spm_iw, True, None, dev)
    log(f"[kernels] {sum(len(r[0]) for r in regions)} packed rows: regions "
        f"{[(len(x), lw, b) for x, _l, lw, b in regions]}")
    spm, unk, a_max = runner.spm_iw, 0, tok.a_max
    stats = new_stats(("scatter_trie", "bpe_walk", "bpe_resolve",
                       "pack_out_compact"))

    # K3 at the main path's shape: the whole CSR trie
    from blingfire_tpu_torch.ops.tables import build_trie_table_cached
    edge_idx, edge_val, _rk, _root, _n = build_trie_table_cached(
        tok.comb, model.seg.i2info_ids, model.seg.i2info_scores,
        model.source_key)
    ti = torch.from_numpy(np.asarray(edge_idx, np.int64)).to(dev)
    tv = torch.from_numpy(np.asarray(edge_val, np.int32)).to(dev)
    size = tables.trie_next.numel()
    k3 = bpe_ops.scatter_trie(ti, tv, size)
    p3 = bpe_ops._scatter_trie_plain(ti, tv, size)
    torch.cuda.synchronize()
    s = stats["scatter_trie"]
    s["err"] = max_abs_err([(k3, p3), (k3, tables.trie_next)])
    s["ms"] = cuda_ms(lambda: bpe_ops.scatter_trie(ti, tv, size), 20)
    s["plain_ms"] = cuda_ms(lambda: bpe_ops._scatter_trie_plain(ti, tv, size), 20)
    s["library_ms"] = cuda_ms(
        lambda: torch.full((size,), -1, dtype=torch.int32, device=dev)
        .index_put_((ti,), tv), 20)
    s["bytes"] = ti.numel() * 12 + size * 4
    s["ops"] = ti.numel()
    del k3, p3

    for x, ln, lw, bounded in regions:
        B, N = x.shape
        before = {k: stats[k]["ms"] for k in stats}
        LW = bpe_ops._walk_depth(tables, lw)
        ovf = tables.max_len > LW and not bounded
        # K1
        m_k, so_k = bpe_ops.bpe_walk(tables, x, ln, spm, lw=lw, bounded=bounded)
        m_p, so_p = bpe_ops._walk_plain(tables, x, ln, spm, LW, ovf)
        torch.cuda.synchronize()
        s = stats["bpe_walk"]
        s["err"] = max(s["err"], max_abs_err([(m_k, m_p), (so_k, so_p)]))
        s["ms"] += cuda_ms(lambda: bpe_ops.bpe_walk(
            tables, x, ln, spm, lw=lw, bounded=bounded), 50)
        s["plain_ms"] += cuda_ms(lambda: bpe_ops._walk_plain(
            tables, x, ln, spm, LW, ovf), 5)
        s["bytes"] += B * N * 4 + B * 4 + LW * B * N * 4 + B * N \
            + 4 * live_gathers(tables, x, ln, LW)
        s["ops"] += LW * B * N
        # K2 on the kernel's walk output
        r_k = bpe_ops.bpe_resolve(tables, m_k, so_k, x, ln, spm, unk, a_max)
        r_p = bpe_ops._resolve_plain(tables, m_k, so_k, x, ln, spm, unk, a_max)
        torch.cuda.synchronize()
        s = stats["bpe_resolve"]
        s["err"] = max(s["err"], max_abs_err(zip(r_k, r_p)))
        s["ms"] += cuda_ms(lambda: bpe_ops.bpe_resolve(
            tables, m_k, so_k, x, ln, spm, unk, a_max), 50)
        s["plain_ms"] += cuda_ms(lambda: bpe_ops._resolve_plain(
            tables, m_k, so_k, x, ln, spm, unk, a_max), 2, warm=1)
        surv, rstart, _re, _an, _v = bpe_ops._filter_plain(tables, m_k, x, ln, spm)
        n_arcs = (surv.sum((0, 2)) + rstart.sum(1)).clamp(max=a_max).double()
        lg = torch.log2(n_arcs.clamp(min=2))
        s["bytes"] += LW * B * N * 4 + B * N + B * N * 4 + B * 4 \
            + 3 * B * N * 4 + B * 4 + B
        # least work: read the slots, a comparison sort and a claim per arc
        s["ops"] += LW * B * N + int((n_arcs * lg).sum()) + 2 * int(n_arcs.sum())
        # K4 on the kernel's resolve output
        ids_k, st_k, _e, cnt_k, fb_k = r_k
        pack_vs_plain(stats["pack_out_compact"], dedup, ids_k, st_k, cnt_k, fb_k)
        per = {k: round(stats[k]["ms"] - before[k], 5) for k in
               ("bpe_walk", "bpe_resolve", "pack_out_compact")}
        log(f"[kernels] region rows={B} lw={lw} bounded={bounded}: walk, "
            f"resolve, pack equal their plain versions; fallback rows "
            f"{int(fb_k.sum())}; ms per launch {per}")

    def once():
        bpe_ops.scatter_trie(ti, tv, size)
        for x, ln, lw, bounded in regions:
            m, so = bpe_ops.bpe_walk(tables, x, ln, spm, lw=lw, bounded=bounded)
            r = bpe_ops.bpe_resolve(tables, m, so, x, ln, spm, unk, a_max)
            dedup.pack_out_compact(r[0], r[1], r[3], r[4])

    dev_ms = profiled_device_ms(once, stats)
    log(f"[kernels] profiler device ms per work unit: {dev_ms}")
    return stats, dev_ms


def pack_vs_plain(s, dedup, ids, st, cnt, fb, timed: bool = True) -> None:
    """K4 against its plain version on one region's segment output."""
    B, N = ids.shape
    o_k = dedup.pack_out_compact(ids, st, cnt, fb)
    o_p = dedup._pack_out_compact_plain(ids, st, cnt, fb)
    torch.cuda.synchronize()
    s["err"] = max(s["err"], max_abs_err([(o_k, o_p)]))
    if timed:
        s["ms"] += cuda_ms(lambda: dedup.pack_out_compact(ids, st, cnt, fb), 50)
        s["plain_ms"] += cuda_ms(
            lambda: dedup._pack_out_compact_plain(ids, st, cnt, fb), 50)
        s["bytes"] += 2 * B * N * 4 + B * 4 + B + B * (N + 2) * 4
        s["ops"] += B * N * 3


def unigram_kernels(tok, docs, native, uni_ops, dedup, pack_stats, dev):
    """Phase 8: K5 and K6 against their plain versions in every region and
    table mode; the stats of the main path's mode (dense) go to the JSON
    line, the others to the log."""
    regions = packed_regions(native, tok, docs, tok._unit_runner().spm_iw,
                             False, tok.seg.charmap, dev)
    log(f"[kernels-u] {sum(len(r[0]) for r in regions)} packed rows: regions "
        f"{[(len(x), lw, b) for x, _l, lw, b in regions]}")
    seg = tok.seg
    saved = (uni_ops._DENSE_MAX_ENTRIES, uni_ops._WIDE_OWNER_SENTINEL)
    by_mode = {}
    for mode in UNI_MODES:
        uni_ops._DENSE_MAX_ENTRIES = 0 if mode != "dense" else saved[0]
        uni_ops._WIDE_OWNER_SENTINEL = 0 if mode == "comb" else saved[1]
        try:
            tables = uni_ops.make_device_tables(
                tok.comb, seg.i2info_ids, seg.i2info_scores,
                max_len=tok.max_token_len, id_offset=seg.id_offset, device=dev)
        finally:
            uni_ops._DENSE_MAX_ENTRIES, uni_ops._WIDE_OWNER_SENTINEL = saved
        check(tables.mode == UNI_MODES.index(mode), f"{mode} mode not taken")
        stats = new_stats(("unigram_walk", "unigram_viterbi"))
        gather_bytes = {"dense": 4, "wide": 12, "comb": 17}[mode]
        for x, ln, lw, bounded in regions:
            B, N = x.shape
            lw_eff = lw if bounded else None
            L = uni_ops.walk_depth(tables, lw_eff)
            # K5
            mk, ms = uni_ops.unigram_walk(tables, x, ln, lw=lw_eff)
            pk, ps = uni_ops._walk_plain(tables, x, ln, L)
            torch.cuda.synchronize()
            s = stats["unigram_walk"]
            s["err"] = max(s["err"], max_abs_err([(mk, pk), (ms, ps)]))
            k_ms = cuda_ms(lambda: uni_ops.unigram_walk(tables, x, ln,
                                                        lw=lw_eff), 50)
            s["ms"] += k_ms
            s["plain_ms"] += cuda_ms(lambda: uni_ops._walk_plain(
                tables, x, ln, L), 5)
            live, fins = unigram_walk_work(uni_ops, tables, x, ln, L)
            s["bytes"] += B * N * 4 + B * 4 + B * N * L * 8 \
                + gather_bytes * live + 4 * fins
            s["ops"] += B * N * L
            # K6 on the kernel's walk output
            r_k = uni_ops.unigram_viterbi(tables, mk, ms, ln, 0)
            r_p = uni_ops._viterbi_plain(tables, mk, ms, ln, 0)
            torch.cuda.synchronize()
            s = stats["unigram_viterbi"]
            s["err"] = max(s["err"], max_abs_err(zip(r_k, r_p)))
            v_ms = cuda_ms(lambda: uni_ops.unigram_viterbi(
                tables, mk, ms, ln, 0), 50)
            s["ms"] += v_ms
            s["plain_ms"] += cuda_ms(lambda: uni_ops._viterbi_plain(
                tables, mk, ms, ln, 0), 2, warm=1)
            n_tok = int(r_k[3].sum())
            n_pos = int(ln.clamp(0, N).sum())
            s["bytes"] += B * N * L * 8 + B * 4 + 3 * B * N * 4 + B * 4 \
                + 4 * n_tok
            s["ops"] += n_pos * (L + 1) * DF64_OPS
            # K4 on the kernel's output: held to its plain version; its time
            # stands in the BPE path's row
            fb = torch.zeros(B, dtype=torch.bool, device=dev)
            pack_vs_plain(pack_stats, dedup, r_k[0], r_k[1], r_k[3], fb,
                          timed=False)
            log(f"[kernels-u] {mode} region rows={B} L={L} bounded={bounded}: "
                f"walk and viterbi equal their plain versions; ms per launch "
                f"walk {k_ms:.5f} viterbi {v_ms:.5f}; live lane-steps {live}, "
                f"finals {fins}, tokens {n_tok}")

        def once():
            for x, ln, lw, bounded in regions:
                lw_eff = lw if bounded else None
                mk, ms = uni_ops.unigram_walk(tables, x, ln, lw=lw_eff)
                uni_ops.unigram_viterbi(tables, mk, ms, ln, 0)

        dev_ms = profiled_device_ms(once, stats)
        for name, s in stats.items():
            t_b, t_o = (s["bytes"] / HBM_BYTES_PER_S * 1e3,
                        s["ops"] / SCALAR_OPS_PER_S * 1e3)
            log(f"[kernels-u] {mode} {name}: {s['ms']:.4f} ms, device "
                f"{dev_ms[name]} ms, plain {s['plain_ms']:.4f} ms, bound "
                f"{max(t_b, t_o):.5f} ms (bytes {t_b:.5f}, operations "
                f"{t_o:.5f}), max_abs_err {s['err']}")
        by_mode[mode] = (stats, dev_ms)
    err = {k: max(by_mode[m][0][k]["err"] for m in UNI_MODES)
           for k in ("unigram_walk", "unigram_viterbi")}
    stats, dev_ms = by_mode["dense"]
    for k in err:
        stats[k]["err"] = err[k]
    return stats, dev_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    # model-table cache and builds stay inside the checkout
    os.environ.setdefault("BLINGFIRE_TPU_TORCH_CACHE", os.path.join(
        ROOT, "build", "blingfire_tpu_torch", "model_cache"))
    sys.path.insert(0, ROOT)
    from blingfire_tpu_torch import kernels, native, testing
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.ops import bpe as bpe_ops
    from blingfire_tpu_torch.ops import unigram as uni_ops
    from blingfire_tpu_torch.runtime import dedup, metrics
    from blingfire_tpu_torch.runtime.host import SpTokenizer

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # ------------------------------------------------------------ 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] nvcc x{len(kernels.KERNELS)} + g++ in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    for name in kernels.KERNELS:
        path = kernels.lib_path(name) + ".log"
        if os.path.exists(path):
            for ln in open(path).read().splitlines():
                if "registers" in ln or "spill" in ln:
                    log(f"[build] {name}: {ln.strip()}")

    # ----------------------------------------------------------- 3. model
    t0 = time.perf_counter()
    blob = testing.gpt2_shaped_model_bytes()
    model = load_bytes(blob)
    log(f"[model] gpt2-shaped byte-BPE: {len(model.seg.i2info_ids)} entries, "
        f"{len(blob)} B image, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    docs = testing.zipf_corpus(CORPUS_BYTES)
    log(f"[model] corpus: {len(docs)} docs, {sum(map(len, docs))} B, "
        f"{time.perf_counter() - t0:.1f} s")
    n_edge = len(testing.EDGE_CASES)

    # ------------------------------------------------------- 4. main path
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tok = SpTokenizer(model, max_doc_symbols=128, device="cuda")
    torch.cuda.synchronize()
    log(f"[main] SpTokenizer init {time.perf_counter() - t0:.3f} s (trie "
        f"{tok.tables.trie_next.numel()} int32)")
    main = run_main(tok, docs, "main", kernels, metrics)
    for name in kernels.PATHS["bpe"]:
        check(main["launches"].get(name, 0) > 0, f"kernel {name} never launched")
    check(main["counters"].fallback_docs > 0, "the BPE path had no fallback docs")
    ids, bounds = main["ids"], main["bounds"]
    V = len(model.seg.i2info_ids)
    check(len(ids) and ids.min() >= -1 and ids.max() < V,
          f"ids out of range: {ids.min()}..{ids.max()}")
    check_oracle(tok, docs, ids, bounds, n_edge, "main")
    del ids, bounds

    # ------------------------------------------- 5. kernels vs plain versions
    stats, dev_ms = bpe_kernels(tok, model, docs, native, bpe_ops, dedup, dev)
    del tok

    # --------------------------------------------------------- 6. model-u
    t0 = time.perf_counter()
    blob_u = testing.xlnet_shaped_model_bytes()
    model_u = load_bytes(blob_u)
    log(f"[model-u] xlnet-shaped unigram LM: {len(model_u.seg.i2info_ids)} "
        f"entries, {len(blob_u)} B image, charmap "
        f"{model_u.seg.charmap is not None}, {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------- 7. main-u
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tok_u = SpTokenizer(model_u, max_doc_symbols=128, device="cuda")
    torch.cuda.synchronize()
    tu = tok_u.tables
    log(f"[model-u] SpTokenizer init {time.perf_counter() - t0:.3f} s: "
        f"n_states {tok_u.comb.n_states}, A {tok_u.comb.n_iws}, max_len "
        f"{tu.max_len}, table mode {UNI_MODES[tu.mode]} "
        f"({tu.dense.numel() if tu.dense is not None else 0} int32 dense)")
    check(tu.mode == uni_ops.MODE_DENSE, "the xlnet-shaped model is not dense")
    main_u = run_main(tok_u, docs, "main-u", kernels, metrics)
    for name in kernels.PATHS["unigram"]:
        check(main_u["launches"].get(name, 0) > 0,
              f"kernel {name} never launched on the unigram path")
    ids, bounds = main_u["ids"], main_u["bounds"]
    check(ids.min() >= 0 and ids.max() < len(model_u.seg.i2info_ids) + 3,
          f"ids out of range: {ids.min()}..{ids.max()}")
    check_oracle(tok_u, docs, ids, bounds, n_edge, "main-u")
    del ids, bounds

    # -------------------------------------------------------- 8. kernels-u
    s_u, d_u = unigram_kernels(tok_u, docs, native, uni_ops, dedup,
                               stats["pack_out_compact"], dev)
    stats.update(s_u)
    dev_ms.update(d_u)

    rows = []
    for name, route in kernels.ROUTES.items():
        s = stats[name]
        by_path = {p: runs["launches"].get(name, 0)
                   for p, runs in (("bpe", main), ("unigram", main_u))
                   if name in kernels.PATHS[p]}
        t_bytes = s["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = s["ops"] / SCALAR_OPS_PER_S * 1e3
        check(s["err"] == 0.0, f"{name} disagrees with its plain version")
        rows.append({
            "name": name, "route": route, "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": s["library_ms"], "device_ms": dev_ms[name],
        })
        log(f"[kernels] {name}: {s['ms']:.4f} ms vs plain {s['plain_ms']:.4f} "
            f"ms, bound {max(t_bytes, t_ops):.5f} ms ({s['bytes']} B, "
            f"{s['ops']} ops), max_abs_err {s['err']}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
