"""Measuring the port's kernels on the card: events and profiler times,
and the rows that chip_smoke.py and kernels/phase_split.py hold them on
(a seeded corpus's uncached CMP_BYTES prefix, by region or launch).
Imports nothing of JAX or of blingfire_tpu."""

from __future__ import annotations

import collections
import time

import torch
from torch.profiler import ProfilerActivity, profile

CORPUS_BYTES = 32 << 20  # end-to-end corpus
CMP_BYTES = 4 << 20  # corpus prefix whose packed rows the kernels are held on
WIDE_DOC = 2048  # main-ww's window: past the compact lanes and K2's rows
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# profiler kernel names of each wrapper
KERNEL_NAMES = {"bpe_walk": ("bpe_walk_kernel",),
                "bpe_resolve": ("bpe_resolve_kernel",),
                "scatter_trie": ("fill_kernel", "scatter_kernel"),
                "pack_out_compact": ("pack_compact_pair_kernel",
                                     "pack_compact_scalar_kernel"),
                "unigram_walk": ("unigram_walk_kernel",),
                "unigram_viterbi": ("unigram_viterbi_kernel",
                                    "unigram_viterbi_wide_kernel"),
                "wp_subword_dense": ("wp_subword_dense_kernel",),
                "wp_subword_comb": ("wp_subword_comb_kernel",),
                "lexer_pass": ("lexer_pass_kernel",),
                "hyph_segment": ("hyph_segment_kernel",),
                "pack_out": ("pack_out_pair_kernel",
                             "pack_out_scalar_kernel"),
                "shard_stats": ("shard_stats_kernel",)}


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


def self_device_us(ev) -> float:
    """Self device time (us) of a profiler event (name differs by version)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(ev, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profiled_device_ms(fn, stats, reps: int = 5) -> None:
    """Profiler device ms per call of fn into each (kernel, path) entry of
    ``stats``, summed over the kernel's names, and "records": the launches
    the profile holds a record of, and the launches made (the launch
    counts' rise over the profile); fn launches every kernel of
    ``stats``.  The profiler drops some records (seen on the H100 for K10,
    K5 and K7, up to all of a kernel's, and late in a long process whole
    profiles): a kernel short of records is profiled again, up to four
    times, and keeps its most complete profile; the phase fails when a
    kernel has no record at all."""
    from blingfire_tpu_torch import kernels

    todo = list(stats)
    best = {}  # key -> (records, launches, device ms)
    for attempt in range(5):
        before = collections.Counter(kernels.launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # a kernel of no interest and a pause first: the profiler has
            # been seen to lose the first launches of a profile
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.2)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.2)  # and before it stops: whole profiles were lost
        launched = collections.Counter(kernels.launches) - before
        per_name = collections.Counter()  # records of each name
        us = collections.Counter()
        seen = {}  # every event with device time: key -> (count, us)
        for ev in prof.key_averages():
            t_us = self_device_us(ev)
            if t_us <= 0:
                continue
            seen[ev.key[:100]] = (ev.count, round(t_us, 3))
            for k, _path in todo:
                hits = [pt for pt in KERNEL_NAMES[k] if pt in ev.key]
                us[k] += t_us if hits else 0.0
                for pt in hits:
                    per_name[(k, pt)] += ev.count
        for key in todo:
            k = key[0]
            # a launch runs every name of its kernel once at least
            rec = max(per_name[(k, pt)] for pt in KERNEL_NAMES[k])
            if key not in best or rec > best[key][0]:
                best[key] = (rec, launched[k], us[k] / 1e3 / reps)
        todo = [key for key in todo if best[key][0] < best[key][1]]
        if not todo:
            break
        log(f"[profile] records of {[(key, best[key][:2]) for key in todo]} "
            f"short (attempt {attempt + 1}); the profile's events with "
            f"device time: {seen}")
    for key, (rec, n, ms) in best.items():
        check(n > 0 and rec > 0, f"the profiler recorded no launch of {key}")
        stats[key].update(device_ms=ms, records=[rec, n])


def new_stats(names, path: str) -> dict:
    """Measurements of each kernel on one path, keyed (kernel, path)."""
    return {(k, path): dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, err=0.0,
                            library_ms=None, device_ms=None, records=None)
            for k in names}


def reads():
    from blingfire_tpu_torch.kernels import Reads

    return Reads()


def corpus_prefix(docs, n_bytes: int) -> list[bytes]:
    """The corpus's first documents up to n_bytes (at least)."""
    sub, tot = [], 0
    for d in docs:
        sub.append(d)
        tot += len(d)
        if tot >= n_bytes:
            break
    return sub


def packed_regions(native, tok, docs, spm_iw, raw_bytes: bool, charmap, dev):
    """Packed rows of an uncached CMP_BYTES corpus prefix, by region."""
    sub = corpus_prefix(docs, CMP_BYTES)
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


UNI_MODES = ("dense", "wide", "comb")


def unigram_tables(uni_ops, tok, mode: str, dev):
    """The unigram tables of ``tok``'s model in table mode ``mode``, forced
    through the port's module constants."""
    saved = (uni_ops._DENSE_MAX_ENTRIES, uni_ops._WIDE_OWNER_SENTINEL)
    uni_ops._DENSE_MAX_ENTRIES = 0 if mode != "dense" else saved[0]
    uni_ops._WIDE_OWNER_SENTINEL = 0 if mode == "comb" else saved[1]
    try:
        tables = uni_ops.make_device_tables(
            tok.comb, tok.seg.i2info_ids, tok.seg.i2info_scores,
            max_len=tok.max_token_len, id_offset=tok.seg.id_offset,
            device=dev)
    finally:
        uni_ops._DENSE_MAX_ENTRIES, uni_ops._WIDE_OWNER_SENTINEL = saved
    check(tables.mode == UNI_MODES.index(mode), f"{mode} mode not taken")
    return tables


def units_np_launches(tok, sub, dedup, bpe_ops, dev):
    """The NumPy unit path's rows of ``sub``: (its unit batch, the row
    width, [(x, lengths) of every launch on the card], split and pack
    seconds on the host)."""
    x, spm, ln, _status = tok._prep_batch(sub, with_spm=True)
    t0 = time.perf_counter()
    ub = dedup.split_units(x, spm, ln)
    t_split = time.perf_counter() - t0
    W = min(tok.n_doc, bpe_ops.RESOLVE_MAX_N)
    t0 = time.perf_counter()
    px, plen, _row, _off = dedup.pack_units(ub, W)
    t_pack = time.perf_counter() - t0
    step = dedup.launch_rows(tok, W, None)
    launches = [(torch.from_numpy(px[lo : lo + step]).to(dev),
                 torch.from_numpy(plen[lo : lo + step]).to(dev))
                for lo in range(0, len(px), step)]
    return ub, W, launches, t_split, t_pack


def hyph_segments(hy, words):
    """K10's rows: (the distinct words of at most 300 code points, [(bucket,
    x, word_len, words) of each segment] of one ``hy.process_batch`` call
    over them)."""
    uniq = list(dict.fromkeys(tuple(w) for w in words if len(w) <= 300))
    trace = []
    hy.process_batch(uniq, trace=trace)
    return uniq, trace


def hyph_bytes(x, word_len, r) -> tuple[int, int]:
    """(bytes, operations) of K10 on rows ``x`` (B, M): the rows and word
    lengths in, the ops out, each table entry the plain walk noted in
    ``r`` (a ``Reads``) once; a live lane-step or an output position an
    operation."""
    B, M = x.shape
    return (B * M * 4 + B * 4 + B * (M - 2) * 4 + r.table_bytes(),
            r.steps + B * M)


# main-dp's slabs on one rank (chip_smoke, NVIDIA H100): name, rows, the
# rows with a count (ShardedSpRunner.run leaves a document past its
# 128-symbol window an empty row: 7,359 of the 9,997 documents), the lanes
# below the counts, and whether the slab is the WordPiece runner's strided
# ``out[:, :-2]`` with its count column ``out[:, -2]``
DP_SLABS = (("gpt2 run", 9997, 2638, 73745, False),
            ("gpt2 run_units", 2559, 2559, 142869, False),
            ("xlnet run", 9997, 2638, 69757, False),
            ("xlnet run_units", 2557, 2557, 133656, False),
            ("wordpiece lw 18", 2305, 2305, 66399, True),
            ("wordpiece lw 42", 118, 118, 5013, True))
DP_WIDTH = 128


def dp_slabs(dev, seed: int = 0) -> list:
    """[(name, ids, counts)]: seeded slabs of DP_SLABS's shapes on ``dev``:
    each slab's lanes spread at random over a random choice of its rows
    with a count (at most DP_WIDTH a row), ids in gpt2's range."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    W = DP_WIDTH
    for name, R, busy, lanes, strided in DP_SLABS:
        counts = np.zeros(R, np.int32)
        rows = np.sort(rng.choice(R, busy, replace=False))
        counts[rows] = rng.multinomial(lanes, np.full(busy, 1.0 / busy))
        check(counts.max() <= W, f"{name}: a count over {W}")
        ids = rng.integers(0, 50257, (R, W + 2 if strided else W),
                           dtype=np.int32)
        t = torch.from_numpy(ids).to(dev)
        if strided:
            t[:, -2] = torch.from_numpy(counts).to(dev)
            out.append((name, t[:, :-2], t[:, -2]))
        else:
            out.append((name, t, torch.from_numpy(counts).to(dev)))
    return out


def dp_bytes(ids, counts) -> tuple[int, int, int]:
    """(lanes below the counts, bytes, operations) of K12 on one slab: the
    lanes and the counts read once, acc written; three operations a lane."""
    lanes = int(counts.clamp(0, ids.shape[1]).sum())
    return lanes, lanes * 4 + ids.shape[0] * 4 + 16, 3 * lanes
