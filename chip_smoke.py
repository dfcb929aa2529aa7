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
              path's shapes; integers must agree exactly (tolerance 0); K2's
              claim depth (ops/bpe.py::claim_segments) beside its arcs a
              row; K3 and its library call timed in turns; K4's host time a
              call by part (checks, allocation, device, stream, pointers,
              ctypes call) over 1,000 calls at the first region's shape;
  6. model-u  a seeded xlnet-shaped unigram-LM vocabulary (32,000 entries)
              with its charmap; its automaton's shape and table mode;
  7. main-u   the unigram path, as phase 4, over the same corpus: K5, K6 and
              K4 must each launch; sampled documents must equal the oracle;
  8. kernels-u K5 unigram_walk and K6 unigram_viterbi (and K4 on their
              output) against their plain
              versions on the packed rows of all three regions of one
              uncached 4 MiB batch, in the dense, wide and comb table modes
              (forced through the port's module constants); tolerance 0;
              K6's rows a launch, depth L, lane group G and ns a DP step
              (events over the row width); K4's host time a call by part;
              then K5 in the three modes on testing.unigram_deep_rows at
              the depths on each side of its 32-depth chunks (1, 31, 32,
              33, 64) and at max_len 70;
  9. model-w  a seeded bert-shaped WordPiece model (28,996 entries, [UNK] =
              100) compiled by the port's copy of the lex compiler; its
              automaton's size;
 10. main-w   the WordPiece hybrid as a user drives it:
              WordPieceHybrid(model, device="cuda") (A, dense sub-grammar,
              pack-safety) then encode_corpus_flat(docs, unk_id=100) over
              the same corpus: K3 and K7 must launch, K7 at most once a
              batch; sampled documents must equal the scalar
              LexerOracleApi;
 11. main-wc  the same entry point with the dense table declined (the
              port's DENSE_MAX_ENTRIES forced below it) over the corpus's
              first 4 MiB, the path of a sub-grammar too large for it: K8
              must launch, and the ids equal main-w's;
 12. kernels-w K7 and K8 against their plain versions on the packed rows of
              both unit-length classes (walk depth 18 and 42) of one
              uncached 4 MiB batch, each kernel launched once over both
              classes as dispatch launches it, and K3 on the dense
              sub-grammar's CSR; tolerance 0;
 13. main-wm  a seeded multilingual-bert-shaped WordPiece model (119,547
              lines, about 1,500 CJK ideographs in an alphabet of about
              2,150 characters; testing.mbert_shaped_model_bytes, compiled
              once and cached under build/) as a user drives it:
              WordPieceHybrid(model, device="cuda") declines its dense
              table under the default cap (reachable states x n_iws
              logged), then encode_corpus_flat(docs, unk_id=100) over the
              corpus, first, second and profiled call: K8 must launch, at
              most once a batch, K7 and K3 never; every document must
              equal the native runtime's TextToIds and 500 sampled ones
              the scalar LexerOracleApi; the corpus is English, so one
              call over 4 MiB of the model's own multilingual traffic
              (testing.mbert_docs) is held the same way;
 14. kernels-wm K8 against its plain version on the packed rows of both
              classes of one uncached 4 MiB batch of main-wm, in one
              launch, and likewise on one 4 MiB batch of the model's own
              multilingual traffic (its ideographs and scripts,
              testing.mbert_docs; logged, not in the kernels line);
              tolerance 0;
 15. model-l  the shipped pattern-lexer models of the package, wbd
              (TextToWords) and sbd (TextToSentences): their automata's
              size, functions, and the state that owns slot 0 of the comb
              table with its base;
 16. main-l   the pattern lexer as a user drives it: WordsTpu(wbd,
              device="cuda").text_to_words_batch over the same corpus, a
              first call, a second with the span memo emptied, one answered
              from the memo, one profiled: K9 must launch; every document
              must equal the native runtime's TextToWords and 500 sampled
              ones the scalar LexerOracleApi;
 17. main-s   the same for WordsTpu(sbd).text_to_sentences_batch against
              the native TextToSentences; document 107 of tests/corpus.py
              (U+1F642 after '."'), run apart from the corpus, must be the
              native runtime's single sentence;
 18. main-lw  WordPieceTpu(bert-shaped model, device="cuda")
              .text_to_ids_batch(docs, unk_id=100) over the corpus's first
              4 MiB: K9 must launch and the ids equal main-w's;
 19. kernels-l K9 against its plain version on the rows of every launch
              (every level and bucket width) of one uncached 4 MiB batch on
              each pattern-lexer path, and on rows of 4,098 and 16,386
              lanes (testing.lexer_wide_rows, through lexer_pass_packed
              directly) with a row that matches nowhere; tolerance 0;
 20. model-h  a seeded syllab-shaped W2H hyphenation model (78,000 patterns,
              about syllab.bin's 1.18 MB) built by the port's copy of the
              pattern compiler; its automaton's size and the state that owns
              slot 0 of the comb table with its base;
 21. main-h   W2H hyphenation as a user drives it: HyphTpu(model,
              device="cuda").process_batch(words) over every token of the
              corpus (stripped of .,!?"' at its ends) and the edge words, a
              first call, a second, one profiled: K10 must launch once a
              call (every bucket in one launch); every
              distinct word of at most 300 code points must equal the native
              runtime's WordHyphenationWithModel, 500 sampled words the
              scalar HyphEngine, and longer words give None;
 22. kernels-h K10 against its plain version on one batch of the
              distinct words: each segment (a bucket's rows) alone, then
              the batch in one packed launch as main-h makes it; rows, ms
              and tile shape by bucket; tolerance 0;
 23. model-b  two seeded SentencePiece-BPE-shaped merges models (32,000
              entries, char mode, the xlnet-shaped alphabet with 3,000 and
              with 420 CJK characters, pair pieces ▁w1▁w2, so not
              chunk-safe): their alphabet, automaton, comb slots and table
              mode (comb or trie), rank mode, chunk-safety;
 24. main-b   the classic doc-row path as a user drives it:
              SpTokenizer(comb model, max_doc_symbols=1024, device="cuda")
              then encode_corpus_flat over the corpus, a first call, a
              second and a profiled one: K1 and K2 must launch; every
              document must equal the native runtime's TextToIds, 500
              sampled ones the scalar oracle, and no fallback document may
              reach the oracle; then one call with no chunk rows (every
              document past the window to the native runtime, as JAX
              does for such a model), timed, with the same ids;
 25. main-br  the trie model the same way over the corpus's first 4 MiB:
              K3, K1 and K2 must launch; every document equals the native
              runtime;
 26. main-bc  the gpt2-shaped model's encode_batch(docs, dedup=False) over
              the first 4 MiB at max_doc_symbols=128, so documents past 128
              symbols are split into chunk rows: its ids must equal main's;
 27. kernels-b K1 (comb + rank, trie + rank) and K2 (rank) against their
              plain versions on every launch (every row width) of the
              classic rows of one uncached 4 MiB batch, and on the rows of
              the rank-fault model; tolerance 0; K2's claim depth a launch;
 28. main-ww  a window past the compact lanes and K2's rows: the
              gpt2-shaped model's SpTokenizer(max_doc_symbols=2048)
              .encode_corpus_flat over the corpus (first, second, profiled
              call) on the NumPy unit path: K1, K2 and K11 must launch, the
              ids equal main's; then the spm-BPE comb model (classic rows)
              and the xlnet-shaped model (NumPy unit path) at the same window
              over the first 4 MiB: every document equals the native
              runtime; no K2 launch of the phase passes N <= 1024 or a_max
              <= 4096;
 29. kernels-p K11 pack_out (and K1 and K2, or K5 and K6, whose output it
              packs) against their plain versions on every launch of the
              NumPy unit path of one uncached 4 MiB batch at main-ww's window,
              for both models; K11 (into a given output, as the path calls
              it) against torch.cat(..., out=); tolerance 0;
              K2's claim depth a launch; K6's rows a launch, L, G and ns a
              DP step; K11's host time a call by part (checks, allocation,
              device, stream, pointers, ctypes call) over 1,000 calls at the
              first launch's shape;
 30. main-dp  the data-parallel runners in an NCCL group of one process (one
              card; more ranks are not shown here): ShardedSpRunner.run and
              run_units of the gpt2- and xlnet-shaped models at 128 symbols
              and ShardedWpRunner.run_rows of the bert-shaped hybrid's packed
              rows over the first 4 MiB: totals and checksums equal the
              plain shard_stats on the host over the same rows, run_units'
              ids main's and main-u's, run_rows' rows WordPieceHybrid
              .dispatch's; K12 must launch;
 31. kernels-dp K12 shard_stats against its plain version on main-dp's
              slabs (the WordPiece ones strided), beside its launch floor
              (the source with the kernel's body emptied, at the same
              grid); tolerance 0;
 32. main-api the product API as a user calls it: api.load_model(path) of
              the gpt2-shaped model with the default device, then
              text_to_ids_batch over the corpus, a first and a second call:
              K1, K2 and K4 must launch and every document equal main's;
              the xlnet- and bert-shaped models the same way over the first
              4 MiB (K5 and K6, or K3 and K7, must launch; the ids equal
              main-u's and main-w's); compat.text_to_words,
              text_to_sentences and text_to_hashes of 500 sampled documents
              against the native runtime; entry.entry() on the card (its
              ids equal encode_batch's); entry.dryrun_multichip(1) in an
              NCCL group of one process (K12 must launch); one
              text_to_ids_batch call under runtime/metrics.py::profile_trace,
              whose Chrome trace must hold a CUDA kernel event.
The kernels, every one CUDA (kernels/csrc/, one nvcc a source), each
launched through kernels.launch: K1 bpe_walk, K2 bpe_resolve, K3
scatter_trie, K4 pack_out_compact, K5 unigram_walk, K6 unigram_viterbi, K7
wp_subword_dense, K8 wp_subword_comb, K9 lexer_pass, K10 hyph_segment, K11
pack_out, K12 shard_stats.
Fallback documents of every path go to the native runtime; a run fails if
one reaches the scalar oracle (Counters.oracle_docs).  Times per launch come
from CUDA events after warm-up.  Each kernel is
measured on each path that runs it (kernels.PATHS), over the regions (or
length classes) of one uncached 4 MiB batch in that path's main-path table
mode (scatter_trie: one launch over the whole table, the BPE trie or the
dense WordPiece sub-grammar); "device_ms" is the profiler's device time for
the same launches, "device_records" the launches it holds a record of and
the launches made (the profiler drops some).  A byte bound charges the rows in and out once and each
table entry the plain version reads once (kernels.Reads).  In the JSON line
"by_path" holds each path's numbers and "launches" the count from that
path's main runs; the kernel's own numbers are their sums (errors: the
largest).  The second-last line is the kernel table as JSON, the last line
the device.  Imports nothing of JAX or of blingfire_tpu.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from blingfire_tpu_torch.measure import (CMP_BYTES, CORPUS_BYTES,
                                         HBM_BYTES_PER_S, WIDE_DOC,
                                         UNI_MODES, check, corpus_prefix,
                                         cuda_ms, dp_bytes, hyph_bytes,
                                         hyph_segments, log, new_stats,
                                         packed_regions, profiled_device_ms,
                                         reads, self_device_us,
                                         unigram_tables, units_np_launches)

ROOT = os.path.dirname(os.path.abspath(__file__))
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 peak, taken for 32-bit scalar ops
ORACLE_DOCS = 500  # documents checked against the scalar oracle
DF64_OPS = 14  # float32 operations per Viterbi candidate: df_add and compare
CLASSIC_DOC = 1024  # the classic path's window: K2's widest row
BPE_MODES = {"comb": 3000, "trie": 420}  # table mode -> CJK characters
# kernel -> (source, the TPU kernel it replaces on each path)
SOURCES = {
    "scatter_trie": ("blingfire_tpu_torch/kernels/csrc/scatter_trie.cu",
                     {"bpe": "blingfire_tpu/ops/bpe.py:161",
                      "wordpiece": "blingfire_tpu/ops/lexer.py:179"}),
    "bpe_walk": ("blingfire_tpu_torch/kernels/csrc/bpe_walk.cu",
                 {p: "blingfire_tpu/ops/bpe.py:242"
                  for p in ("bpe", "bpe_classic", "bpe_units_np")}),
    "bpe_resolve": ("blingfire_tpu_torch/kernels/csrc/bpe_resolve.cu",
                    {p: "blingfire_tpu/ops/bpe.py:340"
                     for p in ("bpe", "bpe_classic", "bpe_units_np")}),
    "pack_out_compact": ("blingfire_tpu_torch/kernels/csrc/pack_out.cu",
                         {"bpe": "blingfire_tpu/runtime/dedup.py:218",
                          "unigram": "blingfire_tpu/runtime/dedup.py:218"}),
    "unigram_walk": ("blingfire_tpu_torch/kernels/csrc/unigram_walk.cu",
                     {p: "blingfire_tpu/ops/unigram.py:164"
                      for p in ("unigram", "unigram_units_np")}),
    "unigram_viterbi": ("blingfire_tpu_torch/kernels/csrc/unigram_viterbi.cu",
                        {p: "blingfire_tpu/ops/unigram.py:216"
                         for p in ("unigram", "unigram_units_np")}),
    "wp_subword_dense": ("blingfire_tpu_torch/kernels/csrc/wp_subword.cu",
                         {"wordpiece": "blingfire_tpu/ops/lexer.py:246"}),
    "wp_subword_comb": ("blingfire_tpu_torch/kernels/csrc/wp_subword.cu",
                        {p: "blingfire_tpu/ops/lexer.py:353"
                         for p in ("wordpiece", "wordpiece_comb")}),
    "lexer_pass": ("blingfire_tpu_torch/kernels/csrc/lexer_pass.cu",
                   {p: "blingfire_tpu/ops/lexer.py:93"
                    for p in ("words", "sentences", "wp_lexer")}),
    "hyph_segment": ("blingfire_tpu_torch/kernels/csrc/hyph_segment.cu",
                     {"hyph": "blingfire_tpu/ops/hyph.py:67"}),
    "pack_out": ("blingfire_tpu_torch/kernels/csrc/pack_out.cu",
                 {p: "blingfire_tpu/runtime/dedup.py:210"
                  for p in ("bpe_units_np", "unigram_units_np")}),
    "shard_stats": ("blingfire_tpu_torch/kernels/csrc/shard_stats.cu",
                    {"dp": "blingfire_tpu/parallel/mesh.py:91"}),
}
WP_UNK = 100  # bert's [UNK]
# the kernels the WordPiece main path launches (K8 runs only when the dense
# table is declined: phases main-wc and main-wm)
WP_MAIN = ("scatter_trie", "wp_subword_dense")
# the kernels' numbers, K1..K12
K_IDS = {"bpe_walk": "K1", "bpe_resolve": "K2", "scatter_trie": "K3",
         "pack_out_compact": "K4", "unigram_walk": "K5",
         "unigram_viterbi": "K6", "wp_subword_dense": "K7",
         "wp_subword_comb": "K8", "lexer_pass": "K9", "hyph_segment": "K10",
         "pack_out": "K11", "shard_stats": "K12"}
HYPHEN = 0x2012  # the hyphen WordHyphenationWithModel inserts by default
# document 107 of tests/corpus.py::full_corpus(n_random=60): the JAX
# package's device lexer breaks a sentence after '."' there (ROADMAP.md C)
DOC_107 = ('&%6%9*9/=@#*66nxUktXncIA, \U0001f680\U0001f680\U0001f389'
           '\U0001f642\U0001f680\U0001f642\u03b5hhTdhjy."\U0001f642\U0001d518'
           '\U0001f642\U0001f680\U0001d55e\U0001d55e\U0001f642\U0001f680'
           '\U0001f680\U0001f642\U0001d55e\U0001d518\U0001f389\U0001f389'
           '\U0001f680\U0001d55e\U0001d55e\U0001d518\U0001f389\U0001f642'
           '\U0001f680\U0001f642\U0001d55e\U0001f680')


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        check(a.shape == b.shape, f"shapes differ: {a.shape} {b.shape}")
        if a.numel():
            d = (a.double() - b.double()).abs().max().item()
            err = max(err, float(d))
    return err


def run_main(tok, docs, label: str, kernels, metrics, **kw) -> dict:
    """The path's main run after its entry point's init: encode_corpus_flat
    three times (first, second, profiled; ``kw`` passed on); launch counts
    and peak memory from the init and the first call only (the caller
    resets both before init)."""
    n_bytes = sum(map(len, docs))
    c = metrics.Counters()
    t0 = time.perf_counter()
    ids, bounds = tok.encode_corpus_flat(docs, counters=c, **kw)
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
    ids2, bounds2 = tok.encode_corpus_flat(docs, counters=c2, **kw)
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
        tok.encode_corpus_flat(docs, counters=metrics.Counters(), **kw)
        torch.cuda.synchronize()
    t_enc3 = time.perf_counter() - t0
    busy = sum(self_device_us(ev) for ev in prof.key_averages()) / 1e6
    log(f"[{label}] profiled call {t_enc3:.3f} s: device busy {busy:.6f} s "
        f"({busy / t_enc3:.6f} of the call), idle share "
        f"{1 - busy / t_enc3:.6f}")
    check(n_bytes > 0 and len(ids) > 0 and peak > 0,
          "bytes, tokens and peak memory must all be > 0")
    check(bounds.shape == (len(docs) + 1,) and bounds[0] == 0
          and np.all(np.diff(bounds) >= 0) and bounds[-1] == len(ids),
          "bounds are not a partition of the ids")
    return dict(ids=ids, bounds=bounds, launches=launches, counters=c)


def check_sampled(want_of, got_of, n_docs: int, edge: int, label: str,
                  what: str = "the oracle") -> None:
    """The edge cases and seeded sampled documents: ``got_of(i)`` must
    equal ``want_of(i)``."""
    rng = np.random.default_rng(0)
    sample = list(range(edge)) + list(
        rng.choice(np.arange(edge, n_docs), ORACLE_DOCS - edge,
                   replace=False))
    t0 = time.perf_counter()
    for i in sample:
        check(got_of(i) == want_of(i), f"{label}: doc {i} differs from {what}")
    log(f"[{label}] {len(sample)} sampled docs equal {what} "
        f"({time.perf_counter() - t0:.1f} s)")


def check_oracle(oracle_ids, docs, ids, bounds, edge, label: str) -> None:
    """The edge cases and seeded sampled documents equal the scalar oracle
    (``oracle_ids(doc)``: its ids of one document)."""
    check_sampled(lambda i: oracle_ids(docs[i]),
                  lambda i: ids[bounds[i] : bounds[i + 1]].tolist(),
                  len(docs), edge, label)


def bpe_kernels(tok, model, docs, native, bpe_ops, dedup, dev):
    """Phase 5: the BPE path's kernels against their plain versions."""
    tables = tok.tables
    runner = tok._unit_runner()
    regions = packed_regions(native, tok, docs, runner.spm_iw, True, None, dev)
    log(f"[kernels] {sum(len(r[0]) for r in regions)} packed rows: regions "
        f"{[(len(x), lw, b) for x, _l, lw, b in regions]}")
    spm, a_max = runner.spm_iw, tok.a_max
    stats = new_stats(("scatter_trie", "bpe_walk", "bpe_resolve",
                       "pack_out_compact"), "bpe")

    # K3 at the main path's shape: the whole CSR trie
    from blingfire_tpu_torch.ops.tables import build_trie_table_cached
    edge_idx, edge_val, _rk, _root, _n = build_trie_table_cached(
        tok.comb, model.seg.i2info_ids, model.seg.i2info_scores,
        model.source_key)
    ti = torch.from_numpy(np.asarray(edge_idx, np.int64)).to(dev)
    tv = torch.from_numpy(np.asarray(edge_val, np.int32)).to(dev)
    size = tables.trie_next.numel()
    s = stats[("scatter_trie", "bpe")]
    scatter_vs_plain(s, bpe_ops, ti, tv, size, tables.trie_next, dev)
    log(f"[kernels] scatter_trie on the trie: {size} int32 from {ti.numel()} "
        f"edges, {s['ms']:.4f} ms, library {s['library_ms']:.4f} ms (in "
        f"turns: kernel, library, library, kernel "
        f"{[round(v, 5) for v in s['turns']]})")

    for x, ln, lw, bounded in regions:
        B, N = x.shape
        before = {k: stats[k]["ms"] for k in stats}
        r_k, r, _k_ms, _v_ms, claim = bpe_pair_vs_plain(
            stats, "bpe", bpe_ops, tables, x, ln, spm, a_max, lw, bounded,
            mark=True)
        # K4 on the kernel's resolve output
        ids_k, st_k, _e, cnt_k, fb_k = r_k
        pack_vs_plain(stats[("pack_out_compact", "bpe")], dedup, ids_k, st_k,
                      cnt_k, fb_k)
        if x is regions[0][0]:
            host_ns_log("[kernels]", "pack_out_compact", dedup, ids_k, st_k,
                        cnt_k, fb_k)
        per = {k[0]: round(stats[k]["ms"] - before[k], 5) for k in stats
               if k[0] != "scatter_trie"}
        marked = st_k & bpe_ops.MARK_BIT != 0
        log(f"[kernels] region rows={B} lw={lw} bounded={bounded}: walk, "
            f"resolve (marking), pack equal their plain versions; fallback "
            f"rows {int(fb_k.sum())}, marked tokens {int(marked.sum())} in "
            f"{int(marked.any(dim=1).sum())} rows; trie entries read "
            f"{r.entries('trie_next')} "
            f"in {r.steps} live lane-steps; ms per launch {per}; {claim}")

    def once():
        bpe_ops.scatter_trie(ti, tv, size)
        for x, ln, lw, bounded in regions:
            m, mr, so = bpe_ops.bpe_walk(tables, x, ln, spm, lw=lw,
                                         bounded=bounded)
            r = bpe_ops.bpe_resolve(tables, m, mr, so, x, ln, spm, 0, a_max,
                                    mark=True)
            dedup.pack_out_compact(r[0], r[1], r[3], r[4])

    profiled_device_ms(once, stats)
    log(f"[kernels] profiler device ms per work unit: "
        f"{ {k[0]: s['device_ms'] for k, s in stats.items()} }")
    return stats


def bpe_pair_vs_plain(stats, path: str, bpe_ops, t, x, ln, spm: int,
                      a_max: int, lw=None, bounded: bool = False,
                      reps=(50, 5, 2), mark: bool = False):
    """One K1 and one K2 launch (on K1's output; ``mark``: K2's marking
    mode, as the unit path launches it) against their plain versions on
    rows ``x``: errors, event times (``reps``: kernel, plain
    walk, plain resolve) and the bound's bytes and operations into
    ``stats[(kernel, path)]``.  Returns (K2's output, the walk's reads,
    K1 ms, K2 ms, K2's claim: a log fragment with its depth, the largest
    segment's kept arcs (ops/bpe.py::claim_segments), beside the kept arcs
    a row)."""
    B, N = x.shape
    LW = bpe_ops._walk_depth(t, lw)
    ovf = t.max_len > LW and not bounded
    m_k, mr_k, so_k = bpe_ops.bpe_walk(t, x, ln, spm, lw=lw, bounded=bounded)
    r = reads()
    m_p, mr_p, so_p = bpe_ops._walk_plain(t, x, ln, spm, LW, ovf, reads=r)
    torch.cuda.synchronize()
    s = stats[("bpe_walk", path)]
    pairs = [(m_k, m_p), (so_k, so_p)]
    if mr_k is not None:
        pairs.append((mr_k, mr_p))
    s["err"] = max(s["err"], max_abs_err(pairs))
    del m_p, mr_p
    k_ms = cuda_ms(lambda: bpe_ops.bpe_walk(t, x, ln, spm, lw=lw,
                                            bounded=bounded), reps[0])
    s["ms"] += k_ms
    s["plain_ms"] += cuda_ms(lambda: bpe_ops._walk_plain(
        t, x, ln, spm, LW, ovf), reps[1], warm=1)
    planes = 2 if mr_k is not None else 1  # m_pack, and m_rank in rank mode
    # rows in; the planes and slot_overflow out; table entries once
    s["bytes"] += B * N * 4 + B * 4 + planes * LW * B * N * 4 + B * N \
        + r.table_bytes()
    s["ops"] += LW * B * N
    r_k = bpe_ops.bpe_resolve(t, m_k, mr_k, so_k, x, ln, spm, 0, a_max,
                              mark)
    r_p = bpe_ops._resolve_plain(t, m_k, mr_k, so_k, x, ln, spm, 0, a_max,
                                 mark)
    torch.cuda.synchronize()
    s = stats[("bpe_resolve", path)]
    s["err"] = max(s["err"], max_abs_err(zip(r_k, r_p)))
    del r_p
    v_ms = cuda_ms(lambda: bpe_ops.bpe_resolve(
        t, m_k, mr_k, so_k, x, ln, spm, 0, a_max, mark), reps[0])
    s["ms"] += v_ms
    s["plain_ms"] += cuda_ms(lambda: bpe_ops._resolve_plain(
        t, m_k, mr_k, so_k, x, ln, spm, 0, a_max, mark), reps[2], warm=1)
    surv, rstart, _re, _an, _v = bpe_ops._filter_plain(t, m_k, x, ln, spm)
    n_match = int(surv.sum((0, 2)).clamp(max=a_max).sum()) \
        if mr_k is not None else 0
    n_arcs = (surv.sum((0, 2)) + rstart.sum(1)).clamp(max=a_max).double()
    lg = torch.log2(n_arcs.clamp(min=2))
    # m_pack in full (the filter reads every slot), m_rank of the kept
    # matches only (bpe_resolve.cu reads no other), slot_overflow, x,
    # lengths in; three lanes, counts, flags out
    s["bytes"] += LW * B * N * 4 + n_match * 4 + B * N + B * N * 4 + B * 4 \
        + 3 * B * N * 4 + B * 4 + B
    # least work: read the slots, a comparison sort and a claim per arc
    s["ops"] += LW * B * N + int((n_arcs * lg).sum()) + 2 * int(n_arcs.sum())
    arcs = bpe_ops.claim_segments(t, m_k, mr_k, x, ln, spm, 0, a_max)
    kept = arcs.keep.sum(dim=1).double()
    claim = (f"K2 claim depth {int(arcs.depth.max())} (mean "
             f"{float(arcs.depth.double().mean()):.1f}) against kept arcs a "
             f"row up to {int(kept.max())} (mean {float(kept.mean()):.1f})")
    return r_k, r, k_ms, v_ms, claim


def uni_pair_vs_plain(stats, path: str, uni_ops, tables, x, ln, lw_eff,
                      reps=(50, 5, 2)):
    """One K5 and one K6 launch (on K5's output) against their plain
    versions on rows ``x``, as :func:`bpe_pair_vs_plain`.  Returns (K6's
    output, the walk's reads, K5 ms, K6 ms, K6's shape: a log fragment with
    its rows a launch, depth L, lane group G and ns a DP step, the events
    over the row width)."""
    B, N = x.shape
    L = uni_ops.walk_depth(tables, lw_eff)
    mk, ms = uni_ops.unigram_walk(tables, x, ln, lw=lw_eff)
    r = reads()
    pk, ps = uni_ops._walk_plain(tables, x, ln, L, reads=r)
    torch.cuda.synchronize()
    s = stats[("unigram_walk", path)]
    s["err"] = max(s["err"], max_abs_err([(mk, pk), (ms, ps)]))
    k_ms = cuda_ms(lambda: uni_ops.unigram_walk(tables, x, ln, lw=lw_eff),
                   reps[0])
    s["ms"] += k_ms
    s["plain_ms"] += cuda_ms(lambda: uni_ops._walk_plain(tables, x, ln, L),
                             reps[1])
    s["bytes"] += B * N * 4 + B * 4 + B * N * L * 8 + r.table_bytes()
    s["ops"] += B * N * L
    r_k = uni_ops.unigram_viterbi(tables, mk, ms, ln, 0)
    r_p = uni_ops._viterbi_plain(tables, mk, ms, ln, 0)
    torch.cuda.synchronize()
    s = stats[("unigram_viterbi", path)]
    s["err"] = max(s["err"], max_abs_err(zip(r_k, r_p)))
    v_ms = cuda_ms(lambda: uni_ops.unigram_viterbi(tables, mk, ms, ln, 0),
                   reps[0])
    s["ms"] += v_ms
    s["plain_ms"] += cuda_ms(lambda: uni_ops._viterbi_plain(
        tables, mk, ms, ln, 0), reps[2], warm=1)
    n_tok = int(r_k[3].sum())
    n_pos = int(ln.clamp(0, N).sum())
    s["bytes"] += B * N * L * 8 + B * 4 + 3 * B * N * 4 + B * 4 + 4 * n_tok
    s["ops"] += n_pos * (L + 1) * DF64_OPS
    shape = (f"K6 {B} rows of {N}, L={L} G={uni_ops.viterbi_lane_group(L, N)}"
             f", {v_ms * 1e6 / N:.1f} ns a DP step")
    return r_k, r, k_ms, v_ms, shape


def scatter_vs_plain(s, bpe_ops, ti, tv, size: int, built, dev) -> None:
    """K3 against its plain version and the table its path built, on one
    path's CSR; its library call is torch.full(...).index_put_."""
    k3 = bpe_ops.scatter_trie(ti, tv, size)
    p3 = bpe_ops._scatter_trie_plain(ti, tv, size)
    torch.cuda.synchronize()
    s["err"] = max_abs_err([(k3, p3), (k3, built)])
    del k3, p3
    s["plain_ms"] = cuda_ms(lambda: bpe_ops._scatter_trie_plain(ti, tv, size), 20)

    def kernel():
        return bpe_ops.scatter_trie(ti, tv, size)

    def library():
        return torch.full((size,), -1, dtype=torch.int32,
                          device=dev).index_put_((ti,), tv)

    # in turns (kernel, library, library, kernel): the two in one window
    turns = [cuda_ms(f, 20) for f in (kernel, library, library, kernel)]
    s["ms"] = (turns[0] + turns[3]) / 2
    s["library_ms"] = (turns[1] + turns[2]) / 2
    s["turns"] = turns
    s["bytes"] = ti.numel() * 12 + size * 4
    s["ops"] = ti.numel()


def pack_vs_plain(s, dedup, ids, st, cnt, fb) -> None:
    """K4 against its plain version on one region's segment output."""
    B, N = ids.shape
    o_k = dedup.pack_out_compact(ids, st, cnt, fb)
    o_p = dedup._pack_out_compact_plain(ids, st, cnt, fb)
    torch.cuda.synchronize()
    s["err"] = max(s["err"], max_abs_err([(o_k, o_p)]))
    s["ms"] += cuda_ms(lambda: dedup.pack_out_compact(ids, st, cnt, fb), 50)
    s["plain_ms"] += cuda_ms(
        lambda: dedup._pack_out_compact_plain(ids, st, cnt, fb), 50)
    s["bytes"] += 2 * B * N * 4 + B * 4 + B + B * (N + 2) * 4
    s["ops"] += B * N * 3


def unigram_deep_vs_plain(uni_ops, dev) -> None:
    """K5 against its plain version at the walk depths on each side of its
    32-depth chunks and at the model's max_len, on testing.unigram_deep_rows
    (pieces of up to 70 symbols) at row widths 128 and 130, in the three
    table modes; tolerance 0."""
    from blingfire_tpu_torch import testing
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.runtime.host import SpTokenizer

    for width in (128, 130):
        blob, x, ln = testing.unigram_deep_rows(width)
        tok = SpTokenizer(load_bytes(blob), max_doc_symbols=128, device="cuda")
        x, ln = torch.from_numpy(x).to(dev), torch.from_numpy(ln).to(dev)
        for mode in UNI_MODES:
            t = unigram_tables(uni_ops, tok, mode, dev)
            res = []
            for lw in testing.DEEP_DEPTHS + (None,):
                L = uni_ops.walk_depth(t, lw)
                got = uni_ops.unigram_walk(t, x, ln, lw=lw)
                want = uni_ops._walk_plain(t, x, ln, L)
                torch.cuda.synchronize()
                check(max_abs_err(zip(got, want)) == 0,
                      f"kernels-u: K5 {mode} at depth {L}, width {width}, "
                      f"differs from its plain version")
                res.append((L, int((got[0] >= 0).sum())))
            log(f"[kernels-u] K5 {mode} on {x.shape[0]} deep rows of "
                f"{width}: equal to the plain version at (depth, keys) {res}")


def unigram_kernels(tok, docs, native, uni_ops, dedup, dev):
    """Phase 8: K5 and K6 (and K4 on their output) against their plain
    versions in every region and table mode; the stats of the main path's
    mode (dense) go to the JSON line, the others to the log."""
    regions = packed_regions(native, tok, docs, tok._unit_runner().spm_iw,
                             False, tok.seg.charmap, dev)
    log(f"[kernels-u] {sum(len(r[0]) for r in regions)} packed rows: regions "
        f"{[(len(x), lw, b) for x, _l, lw, b in regions]}")
    fbs = [torch.zeros(len(x), dtype=torch.bool, device=dev)
           for x, *_rest in regions]
    by_mode = {}
    for mode in UNI_MODES:
        tables = unigram_tables(uni_ops, tok, mode, dev)
        stats = new_stats(("unigram_walk", "unigram_viterbi",
                           "pack_out_compact"), "unigram")
        for x, ln, lw, bounded in regions:
            B, N = x.shape
            lw_eff = lw if bounded else None
            r_k, r, k_ms, v_ms, shape = uni_pair_vs_plain(
                stats, "unigram", uni_ops, tables, x, ln, lw_eff)
            # K4 on the kernel's output
            pack_vs_plain(stats[("pack_out_compact", "unigram")], dedup,
                          r_k[0], r_k[1], r_k[3], torch.zeros(
                              B, dtype=torch.bool, device=dev))
            log(f"[kernels-u] {mode} region rows={B} "
                f"L={uni_ops.walk_depth(tables, lw_eff)} bounded={bounded}: "
                f"walk, viterbi and pack equal their plain versions; ms per "
                f"launch walk {k_ms:.5f} viterbi {v_ms:.5f}; live lane-steps "
                f"{r.steps}, table bytes read {r.table_bytes()}, tokens "
                f"{int(r_k[3].sum())}; {shape}")
            if mode == "dense" and x is regions[0][0]:
                host_ns_log("[kernels-u]", "pack_out_compact", dedup, r_k[0],
                            r_k[1], r_k[3], torch.zeros(
                                B, dtype=torch.bool, device=dev))

        def once():
            for (x, ln, lw, bounded), fb in zip(regions, fbs):
                lw_eff = lw if bounded else None
                mk, ms = uni_ops.unigram_walk(tables, x, ln, lw=lw_eff)
                r = uni_ops.unigram_viterbi(tables, mk, ms, ln, 0)
                dedup.pack_out_compact(r[0], r[1], r[3], fb)

        profiled_device_ms(once, stats)
        for (name, _path), s in stats.items():
            bound, bound_by = bound_of(s)
            log(f"[kernels-u] {mode} {name}: {s['ms']:.4f} ms, device "
                f"{s['device_ms']} ms, plain {s['plain_ms']:.4f} ms, bound "
                f"{bound:.5f} ms ({bound_by}), max_abs_err {s['err']}")
        by_mode[mode] = stats
    unigram_deep_vs_plain(uni_ops, dev)
    stats = by_mode["dense"]
    for k, s in stats.items():
        s["err"] = max(by_mode[m][k]["err"] for m in UNI_MODES)
    return stats


def wp_pass_vs_plain(s, label: str, h, name: str, px, pinit, class_rows,
                     lexer_ops, dev) -> tuple:
    """Hybrid ``h``'s kernel ``name`` in one launch over a packed batch of
    both length classes, as WordPieceHybrid.dispatch launches it, against
    the plain version run once a class: its error, events ms, plain ms,
    bytes and operations into ``s``.  Returns the launch's arguments."""
    from blingfire_tpu_torch import kernels

    def plain(x, init, class_rows, r=None):
        out = []
        for lo, hi, lw in class_rows:
            xc, ic = x[lo:hi], init[lo:hi]
            if h._dense is None:
                out.append(lexer_ops._pass_comb_plain(
                    h.tables, xc, ic, h._l_iw, h._r_iw, lw, reads=r))
            else:
                dnext, ow_perm, _p, n_f, _n = h._dense
                out.append(lexer_ops._pass_dense_plain(
                    h.tables, dnext, ow_perm, xc, ic, h._l_iw, h._r_iw, lw,
                    n_f, h._n_iws, reads=r))
        return torch.cat(out)

    x = torch.from_numpy(px).to(dev)
    init = torch.from_numpy(pinit).to(dev)
    B, M = x.shape
    out = torch.empty((B, M + 2), dtype=torch.int32, device=dev)
    n = kernels.launches[name]
    h._passes(x, init, class_rows, out)
    check(kernels.launches[name] == n + 1,
          f"{name}: not one launch over both length classes")
    r = reads()
    p = plain(x, init, class_rows, r)
    torch.cuda.synchronize()
    s["err"] = max_abs_err([(out, p)])
    s["ms"] = cuda_ms(lambda: h._passes(x, init, class_rows, out), 50)
    s["plain_ms"] = cuda_ms(lambda: plain(x, init, class_rows), 2, warm=1)
    # rows in (x, init) and out, and each table entry read once
    s["bytes"] = B * M * 8 + B * (M + 2) * 4 + r.table_bytes()
    s["ops"] = r.steps + B * M
    log(f"[{label}] {name}: one launch over {B} rows of both classes "
        f"{[(hi - lo, lw) for lo, hi, lw in class_rows]}: equal to the "
        f"plain version a class (max_abs_err {s['err']}); {s['ms']:.5f} ms, "
        f"plain {s['plain_ms']:.4f} ms; matches {int(out[:, M].sum())}; "
        f"live lane-steps {r.steps}, table bytes read {r.table_bytes()}, "
        f"actions reached {r.entries('act_tag')}")
    return x, init, class_rows, out


def wordpiece_kernels(hyb, hyb_c, docs, lexer_ops, bpe_ops, dev):
    """Phase 12: K7 and K8 against their plain versions on the packed rows
    of both length classes of one uncached 4 MiB batch, each launched once
    over both classes as WordPieceHybrid.dispatch launches it (the plain
    version runs once a class), and K3 on the dense sub-grammar."""
    nh, u_syms, u_soff, u_fn = hyb._analyze(corpus_prefix(docs, CMP_BYTES))
    hyb._rt.BtlWpFree(nh)
    n_units = len(u_soff) - 1
    runs = []
    for h, name in ((hyb, "wp_subword_dense"), (hyb_c, "wp_subword_comb")):
        px, pinit, class_rows, _r, _o = h._pack(u_syms, u_soff, u_fn)
        runs.append((h, name, px, pinit, class_rows))
    check(len(runs[0][2]) >= 1000, f"only {len(runs[0][2])} packed rows")
    check(np.array_equal(runs[0][2], runs[1][2]), "packed rows differ by mode")
    log(f"[kernels-w] {n_units} unique units in {len(runs[0][2])} packed "
        f"rows: classes (rows, lw) "
        f"{[(hi - lo, lw) for lo, hi, lw in runs[0][4]]}")
    stats = new_stats(("wp_subword_dense", "wp_subword_comb"), "wordpiece")
    dev_rows = {}
    for h, name, px, pinit, class_rows in runs:
        dev_rows[name] = (h, wp_pass_vs_plain(
            stats[(name, "wordpiece")], "kernels-w", h, name, px, pinit,
            class_rows, lexer_ops, dev))

    def once():
        for h, args in dev_rows.values():
            h._passes(*args)

    profiled_device_ms(once, stats)
    # K3 at the dense sub-grammar's shape: its CSR from the host BFS
    idx, vals, _ow, _perm, _n_f, n_reach = lexer_ops.dense_sub_edges(
        hyb.comb, hyb.wbd.aut.moore_ow, hyb._inis)
    ti = torch.from_numpy(idx).to(dev)
    tv = torch.from_numpy(vals).to(dev)
    size = n_reach * hyb._n_iws
    k3 = new_stats(("scatter_trie",), "wordpiece")
    scatter_vs_plain(k3[("scatter_trie", "wordpiece")], bpe_ops, ti, tv, size,
                     hyb._dense[0], dev)
    profiled_device_ms(lambda: bpe_ops.scatter_trie(ti, tv, size), k3)
    s = k3[("scatter_trie", "wordpiece")]
    log(f"[kernels-w] scatter_trie on the dense sub-grammar: {size} int32 "
        f"from {ti.numel()} edges, {s['ms']:.4f} ms, device "
        f"{s['device_ms']} ms, plain {s['plain_ms']:.4f} ms, library "
        f"{s['library_ms']:.4f} ms (in turns: kernel, library, library, "
        f"kernel {[round(v, 5) for v in s['turns']]}), max_abs_err "
        f"{s['err']}")
    stats.update(k3)
    return stats


def mbert_kernels(hyb_m, docs, ml_docs, lexer_ops, dev):
    """Phase 14: K8 against its plain version on the packed rows of both
    length classes of one uncached 4 MiB batch of main-wm (the
    multilingual-bert-shaped model, its dense table declined by the cap),
    in one launch as WordPieceHybrid.dispatch makes it; then the same on
    one batch of the model's own multilingual traffic (``ml_docs``), which
    is logged and kept out of the kernels line."""
    out = {}
    # the multilingual batch's units repeat more: 672 rows of 4 MiB
    for label, batch, n_min in (
            ("main-wm", corpus_prefix(docs, CMP_BYTES), 1000),
            ("multilingual", ml_docs, 500)):
        nh, u_syms, u_soff, u_fn = hyb_m._analyze(batch)
        hyb_m._rt.BtlWpFree(nh)
        px, pinit, class_rows, _r, _o = hyb_m._pack(u_syms, u_soff, u_fn)
        check(len(px) >= n_min, f"only {len(px)} packed rows")
        log(f"[kernels-wm] {label}: {len(batch)} docs, "
            f"{sum(map(len, batch))} B, {len(u_soff) - 1} unique units in "
            f"{len(px)} packed rows: classes (rows, lw) "
            f"{[(hi - lo, lw) for lo, hi, lw in class_rows]}")
        stats = new_stats(("wp_subword_comb",), "wordpiece_comb")
        s = stats[("wp_subword_comb", "wordpiece_comb")]
        args = wp_pass_vs_plain(s, "kernels-wm", hyb_m, "wp_subword_comb",
                                px, pinit, class_rows, lexer_ops, dev)
        profiled_device_ms(lambda: hyb_m._passes(*args), stats)
        bound, bound_by = bound_of(s)
        log(f"[kernels-wm] {label} wp_subword_comb: device {s['device_ms']} "
            f"ms (records {s['records']}), bound {bound:.5f} ms "
            f"({bound_by}), max_abs_err {s['err']}")
        check(s["err"] == 0.0, f"K8 disagrees with its plain version on "
              f"the {label} batch")
        out[label] = stats
    return out["main-wm"]


def run_mbert(docs, n_edge: int, dev) -> tuple[dict, dict]:
    """Phases 13 and 14: the multilingual-bert-shaped model's main run
    (main-wm) and K8 on one uncached 4 MiB batch of it (kernels-wm).
    Returns the main run (its launches and counters) and K8's stats."""
    from blingfire_tpu_torch import kernels, testing
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.ops import lexer as lexer_ops
    from blingfire_tpu_torch.runtime import metrics
    from blingfire_tpu_torch.runtime.lexer import LexerOracleApi
    from blingfire_tpu_torch.runtime.wp_hybrid import WordPieceHybrid

    t0 = time.perf_counter()
    blob_m = testing.mbert_shaped_model_bytes()
    t_compile = time.perf_counter() - t0
    model_m = load_bytes(blob_m)
    log(f"[main-wm] mbert-shaped WordPiece: {testing.MBERT_VOCAB} lines, "
        f"{len(testing.mbert_alphabet())} characters, {len(blob_m)} B image, "
        f"{model_m.wbd.aut.n_states} states; compiled (or read from build/) "
        f"in {t_compile:.1f} s, loaded in "
        f"{time.perf_counter() - t0 - t_compile:.1f} s")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hyb_m = WordPieceHybrid(model_m, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    check(hyb_m._dense is None and hyb_m.available(),
          "the mbert-shaped model kept its dense table or is not pack-safe")
    n_reach = lexer_ops.dense_sub_edges(hyb_m.comb, model_m.wbd.aut.moore_ow,
                                        hyb_m._inis)[-1]
    dense = n_reach * hyb_m._n_iws
    check(dense > lexer_ops.DENSE_MAX_ENTRIES, "the dense table fits its cap")
    log(f"[main-wm] WordPieceHybrid init {t_init:.3f} s: comb "
        f"{hyb_m.comb.n_states} states, {hyb_m.comb.n_slots} slots, n_iws "
        f"{hyb_m._n_iws}; reachable states x n_iws = {n_reach} x "
        f"{hyb_m._n_iws} = {dense} > DENSE_MAX_ENTRIES "
        f"{lexer_ops.DENSE_MAX_ENTRIES} ({dense / lexer_ops.DENSE_MAX_ENTRIES:.3f}"
        f"x): dense table declined; peak device memory after init "
        f"{torch.cuda.max_memory_allocated()} B")
    main_wm = run_main(hyb_m, docs, "main-wm", kernels, metrics,
                       unk_id=WP_UNK)
    check(main_wm["launches"].get("wp_subword_comb", 0) > 0,
          "kernel wp_subword_comb never launched on main-wm")
    check(not main_wm["launches"].get("wp_subword_dense")
          and not main_wm["launches"].get("scatter_trie"),
          "main-wm launched the dense pass")
    check(main_wm["launches"].get("wp_subword_comb", 0)
          <= main_wm["counters"].batches,
          "K8 launched more than once in a batch")
    ids, bounds = main_wm["ids"], main_wm["bounds"]
    check(ids.min() >= 0 and ids.max() < testing.MBERT_VOCAB,
          f"ids out of range: {ids.min()}..{ids.max()}")
    t0 = time.perf_counter()
    bad = [i for i, d in enumerate(docs)
           if native_ids(hyb_m._rt, hyb_m._nh, d, WP_UNK)
           != ids[bounds[i] : bounds[i + 1]].tolist()]
    check(not bad, f"main-wm: {len(bad)} docs differ from the native "
          f"runtime, first {bad[:5]}")
    log(f"[main-wm] all {len(docs)} docs equal the native runtime's "
        f"TextToIds ({time.perf_counter() - t0:.1f} s)")
    oracle_m = LexerOracleApi(model_m)
    check_oracle(lambda d: oracle_m.text_to_ids(d, unk_id=WP_UNK), docs, ids,
                 bounds, n_edge, "main-wm")
    log(f"[main-wm] chained slot records (built at the first K8 launch) "
        f"{hyb_m.tables.chain.numel() * 4} B")
    del ids, bounds, main_wm["ids"], main_wm["bounds"]
    # the model's own traffic: the corpus is English, so its ideographs
    # and scripts come from testing.mbert_docs
    ml_docs = testing.mbert_docs(CMP_BYTES)
    n_ml = sum(map(len, ml_docs))
    n0 = kernels.launches["wp_subword_comb"]
    t0 = time.perf_counter()
    ids, bounds = hyb_m.encode_corpus_flat(ml_docs, unk_id=WP_UNK)
    torch.cuda.synchronize()
    t_ml = time.perf_counter() - t0
    check(kernels.launches["wp_subword_comb"] > n0,
          "K8 never launched on the multilingual documents")
    bad = [i for i, d in enumerate(ml_docs)
           if native_ids(hyb_m._rt, hyb_m._nh, d, WP_UNK)
           != ids[bounds[i] : bounds[i + 1]].tolist()]
    check(not bad, f"main-wm multilingual: {len(bad)} docs differ from the "
          f"native runtime, first {bad[:5]}")
    check_oracle(lambda d: oracle_m.text_to_ids(d, unk_id=WP_UNK), ml_docs,
                 ids, bounds, 0, "main-wm multilingual")
    log(f"[main-wm] multilingual: {len(ml_docs)} docs, {n_ml} B in "
        f"{t_ml:.3f} s ({n_ml / t_ml:.0f} B/s), {len(ids)} tokens, "
        f"{int((ids == WP_UNK).sum())} [UNK], "
        f"{kernels.launches['wp_subword_comb'] - n0} K8 launches; every doc "
        f"equals the native runtime's TextToIds, sampled ones the oracle")
    del ids, bounds, oracle_m

    # kernels-wm
    return main_wm, mbert_kernels(hyb_m, docs, ml_docs, lexer_ops, dev)


def run_lexer_main(prod, call, docs, label: str, unit: str, count,
                   kernels, metrics) -> dict:
    """A pattern-lexer path's main run after its entry point's init:
    ``call(docs, counters)`` four times: first and second with an empty
    span memo (the product keeps it across calls), a third answered from
    the memo the second left, a fourth with an empty memo under the
    profiler.  ``count(out)``: the words, sentences or ids of an output.
    Launch counts and peak memory from the init and the first call only
    (the caller resets both before init)."""
    n_bytes = sum(map(len, docs))
    lex = prod.lex
    c = metrics.Counters()
    t0 = time.perf_counter()
    out = call(docs, c)
    torch.cuda.synchronize()
    t1 = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    st = lex.last_stats
    n = count(out)
    log(f"[{label}] first call {t1:.3f} s: {n_bytes / t1:.0f} B/s, "
        f"{n / t1:.0f} {unit}/s, {n} {unit}, {len(docs)} docs, peak device "
        f"memory {peak} B")
    log(f"[{label}] rows by (level, bucket) {dict(sorted(st.rows.items()))}"
        f"; launches {dict(sorted(st.launches.items()))}; spans walked "
        f"{st.device_spans}, memoized {st.memo_hits}, sent to the scalar "
        f"engine {st.scalar_spans}")
    log(f"[{label}] stage seconds {dict(c.stage_seconds)}")
    log(f"[{label}] launches {launches}")
    lex._flat_cache.clear()
    c2 = metrics.Counters()
    t0 = time.perf_counter()
    check(call(docs, c2) == out, "a second call gave another output")
    t2 = time.perf_counter() - t0
    log(f"[{label}] second call (memo emptied) {t2:.3f} s: "
        f"{n_bytes / t2:.0f} B/s, {n / t2:.0f} {unit}/s; stage seconds "
        f"{dict(c2.stage_seconds)}")
    t0 = time.perf_counter()
    check(call(docs, metrics.Counters()) == out,
          "a call from the memo gave another output")
    t3 = time.perf_counter() - t0
    check(lex.last_stats.device_spans == 0, "the memo missed spans")
    log(f"[{label}] call from the memo {t3:.3f} s: {n_bytes / t3:.0f} B/s")
    lex._flat_cache.clear()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call(docs, metrics.Counters())
        torch.cuda.synchronize()
    t4 = time.perf_counter() - t0
    busy = sum(self_device_us(ev) for ev in prof.key_averages()) / 1e6
    log(f"[{label}] profiled call {t4:.3f} s: device busy {busy:.6f} s "
        f"({busy / t4:.6f} of the call), idle share {1 - busy / t4:.6f}")
    check(n_bytes > 0 and n > 0 and peak > 0,
          "bytes, output and peak memory must all be > 0")
    check(launches.get("lexer_pass", 0) > 0, f"K9 never launched on {label}")
    return dict(out=out, launches=launches)


def lexer_wide_vs_plain(s, path: str, lex, sub, lexer_ops, dev) -> None:
    """K9 against its plain version on testing.lexer_wide_rows at 4,098
    and 16,386 lanes (one launch a width, through lexer_pass_packed); the
    row that matches nowhere must have no visited start.  Errors into
    ``s``."""
    from blingfire_tpu_torch import testing

    t = lex.tables
    for width in (4096, lexer_ops.MAX_LEXER_ROW - 2):
        x, init, elen, _raws = testing.lexer_wide_rows(lex, width, sub)
        xd, idv, ed = (torch.from_numpy(a).to(dev) for a in (x, init, elen))
        B, M = x.shape
        k = lexer_ops.lexer_pass_packed(t, xd, idv, ed)
        p = lexer_ops.pack5(*lexer_ops._lexer_pass_plain(t, xd, idv, ed))
        torch.cuda.synchronize()
        s["err"] = max(s["err"], max_abs_err([(k, p)]))
        dead = B - 2  # lexer_wide_rows: the row from a dead-end state
        check(int(k[dead, :M].sum()) == 0, f"{path}: the row that matches "
              f"nowhere has visited starts at {M} lanes")
        k_ms = cuda_ms(lambda: lexer_ops.lexer_pass_packed(t, xd, idv, ed), 10)
        log(f"[kernels-l] {path} wide rows: {B} rows of {M} lanes (one "
            f"matching nowhere) equal to the plain version; {k_ms:.5f} ms "
            f"per launch; matches {int(k[:, :M].sum())}")


def lexer_kernels(paths, docs, lexer_ops, dev) -> dict:
    """Phase 19: K9 against its plain version on the rows of every launch
    (every level and bucket width) that one uncached CMP_BYTES batch makes
    on each pattern-lexer path, then on wide rows
    (:func:`lexer_wide_vs_plain`; not in the batch's sums).  ``paths``:
    path -> (LexerTpu, whether NUL reads as a space, as WordsTpu
    decodes)."""
    from blingfire_tpu_torch.runtime.lexer_host import decode_utf8

    sub = corpus_prefix(docs, CMP_BYTES)
    stats = {}
    for path, (lex, nul_space) in paths.items():
        decs = [decode_utf8(d) for d in sub]
        cps = [np.where(d[0] == 0, 0x20, d[0]) if nul_space else d[0]
               for d in decs if d is not None and len(d[0])]
        trace = []
        lex._flat_cache.clear()
        lex.process_docs(cps, trace=trace)
        lex._flat_cache.clear()
        t = lex.tables
        key = ("lexer_pass", path)
        st = new_stats(("lexer_pass",), path)
        s = st[key]
        batches = []
        for level, bucket, x, init, elen, _raws in trace:
            xd, idv, ed = (torch.from_numpy(a).to(dev) for a in (x, init, elen))
            batches.append((xd, idv, ed))
            B, M = x.shape
            k = lexer_ops.lexer_pass_packed(t, xd, idv, ed)
            r = reads()
            p = lexer_ops.pack5(*lexer_ops._lexer_pass_plain(t, xd, idv, ed,
                                                             reads=r))
            torch.cuda.synchronize()
            s["err"] = max(s["err"], max_abs_err([(k, p)]))
            k_ms = cuda_ms(lambda: lexer_ops.lexer_pass_packed(t, xd, idv, ed),
                           20)
            s["ms"] += k_ms
            s["plain_ms"] += cuda_ms(lambda: lexer_ops._lexer_pass_plain(
                t, xd, idv, ed), 1, warm=1)
            # rows in (x; init and ext_len), five planes out, and each
            # table entry read once
            s["bytes"] += B * M * 4 + B * 8 + B * M * 20 + r.table_bytes()
            s["ops"] += r.steps + B * M
            log(f"[kernels-l] {path} level {level} bucket {bucket}: {B} rows "
                f"of {M} lanes equal to the plain version; {k_ms:.5f} ms per "
                f"launch; matches {int(k[:, :M].sum())}; live lane-steps "
                f"{r.steps}, table bytes read {r.table_bytes()}")

        def once():
            for xd, idv, ed in batches:
                lexer_ops.lexer_pass_packed(t, xd, idv, ed)

        profiled_device_ms(once, st)
        lexer_wide_vs_plain(s, path, lex, sub, lexer_ops, dev)
        bound, bound_by = bound_of(s)
        log(f"[kernels-l] {path}: {len(batches)} launches, {s['ms']:.4f} ms, "
            f"device {s['device_ms']} ms, plain {s['plain_ms']:.4f} ms, bound "
            f"{bound:.5f} ms ({bound_by}), max_abs_err {s['err']}")
        stats.update(st)
    return stats


def run_hyph_main(hy, words, n_bytes: int, kernels, metrics) -> dict:
    """The hyphenation path's main run after HyphTpu's init: process_batch
    three times (first, second, profiled).  Launch counts and peak memory
    from the init and the first call only (the caller resets both before
    init)."""
    n_cp = sum(map(len, words))
    c = metrics.Counters()
    t0 = time.perf_counter()
    out = hy.process_batch(words, counters=c)
    torch.cuda.synchronize()
    t1 = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    st = hy.last_stats
    log(f"[main-h] first call {t1:.3f} s: {n_bytes / t1:.0f} B/s of the "
        f"corpus, {len(words) / t1:.0f} words/s, {n_cp / t1:.0f} code "
        f"points/s; {len(words)} words ({n_cp} code points), {st.unique} "
        f"distinct, {st.oversize} over 300; peak device memory {peak} B")
    log(f"[main-h] rows by bucket {dict(sorted(st.rows.items()))}; launches "
        f"by bucket {dict(sorted(st.launches.items()))}")
    log(f"[main-h] stage seconds {dict(c.stage_seconds)}")
    log(f"[main-h] launches {launches}")
    c2 = metrics.Counters()
    t0 = time.perf_counter()
    check(hy.process_batch(words, counters=c2) == out,
          "a second call gave other ops")
    t2 = time.perf_counter() - t0
    log(f"[main-h] second call {t2:.3f} s: {n_bytes / t2:.0f} B/s, "
        f"{len(words) / t2:.0f} words/s; stage seconds "
        f"{dict(c2.stage_seconds)}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hy.process_batch(words, counters=metrics.Counters())
        torch.cuda.synchronize()
    t3 = time.perf_counter() - t0
    busy = sum(self_device_us(ev) for ev in prof.key_averages()) / 1e6
    log(f"[main-h] profiled call {t3:.3f} s: device busy {busy:.6f} s "
        f"({busy / t3:.6f} of the call), idle share {1 - busy / t3:.6f}")
    check(len(out) == len(words) and peak > 0 and st.unique > 0,
          "no output, distinct words or peak memory")
    check(launches.get("hyph_segment", 0) == 1,
          f"main-h's first call made {launches.get('hyph_segment', 0)} K10 "
          f"launches, not one")
    return dict(out=out, launches=launches)


def check_hyph(hy, words, out, native, blob: bytes, render) -> None:
    """main-h's output: every distinct word of at most 300 code points
    equals the native WordHyphenationWithModel, 500 seeded sampled words
    the scalar HyphEngine op for op, and longer words are None."""
    first = {}
    for i, w in enumerate(words):
        first.setdefault(tuple(w), i)
    h = native.set_model(blob)
    t0 = time.perf_counter()
    n_cmp = 0
    try:
        for w, i in first.items():
            if len(w) > 300:
                continue
            got = render(w, out[i], HYPHEN)
            want = native.word_hyphenation(h, "".join(map(chr, w)), HYPHEN)
            check(got == want, f"main-h: word {i} {got!r} differs from the "
                  f"native runtime's {want!r}")
            n_cmp += 1
    finally:
        native.get_runtime().FreeModel(h)
    log(f"[main-h] all {n_cmp} distinct words of at most 300 code points "
        f"equal the native WordHyphenationWithModel "
        f"({time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in rng.choice(len(words), ORACLE_DOCS, replace=False).tolist():
        check(out[i] == hy.engine.process(list(words[i])),
              f"main-h: word {i} differs from HyphEngine")
    log(f"[main-h] {ORACLE_DOCS} sampled words equal HyphEngine op for op "
        f"({time.perf_counter() - t0:.1f} s)")
    over = [i for i, w in enumerate(words) if len(w) > 300]
    check(over and all(out[i] is None for i in over),
          "a word over 300 code points did not give None")
    log(f"[main-h] {len(over)} words over 300 code points give None")


def hyph_kernels(hy, words, hyph_ops, dev) -> dict:
    """Phase 22: K10 against its plain version on one batch of the distinct
    words: each segment (a bucket's rows) alone, then the batch in one
    packed launch, as main-h launches it; the packed launch's times are
    K10's."""
    _uniq, trace = hyph_segments(hy, words)
    t = hy.tables
    key = ("hyph_segment", "hyph")
    stats = new_stats(("hyph_segment",), "hyph")
    s = stats[key]
    segs, want = [], []
    for bucket, x, wl, _w in trace:
        xd, wd = (torch.from_numpy(a).to(dev) for a in (x, wl))
        B, M = x.shape
        k = hyph_ops.hyph_segment(t, xd, wd)
        r = reads()
        p = hyph_ops._hyph_segment_plain(t, xd, wd, reads=r)
        torch.cuda.synchronize()
        s["err"] = max(s["err"], max_abs_err([(k, p)]))
        k_ms = cuda_ms(lambda: hyph_ops.hyph_segment(t, xd, wd), 20)
        s["plain_ms"] += cuda_ms(lambda: hyph_ops._hyph_segment_plain(
            t, xd, wd), 1, warm=1)
        nb, ops = hyph_bytes(x, wl, r)
        s["bytes"] += nb
        s["ops"] += ops
        segs.append((x, wl))
        want.append(p.reshape(-1))
        log(f"[kernels-h] bucket {bucket}: {B} rows of {M} lanes, tiles of "
            f"{hyph_ops.tile_rows(M)} rows, alone equal to the plain "
            f"version; {k_ms:.5f} ms per launch alone; positions with an op "
            f"> 0 {int((k > 0).sum())}; live lane-steps {r.steps}, table "
            f"bytes read {r.table_bytes()}")
    buf, pk = hyph_ops.pack_rows(segs)
    bufd = torch.from_numpy(buf).to(dev)
    got = hyph_ops.hyph_segment_packed(t, bufd, pk)
    torch.cuda.synchronize()
    s["err"] = max(s["err"], max_abs_err([(got, torch.cat(want))]))
    s["ms"] = cuda_ms(lambda: hyph_ops.hyph_segment_packed(t, bufd, pk), 20)

    def once():
        hyph_ops.hyph_segment_packed(t, bufd, pk)

    profiled_device_ms(once, stats)
    bound, bound_by = bound_of(s)
    log(f"[kernels-h] one launch over {len(segs)} segments, {sum(pk.rows)} "
        f"rows in {pk.n_tiles} tiles: {s['ms']:.5f} ms, device "
        f"{s['device_ms']} ms, plain {s['plain_ms']:.4f} ms (a segment at a "
        f"time), bound {bound:.5f} ms ({bound_by}), max_abs_err {s['err']}")
    return stats


def native_ids(rt, h, d: bytes, unk_id: int = 0) -> list[int]:
    """The native runtime's TextToIds of one document."""
    import ctypes

    cap = len(d) + 16
    arr = np.empty(cap, np.int32)
    n = rt.TextToIds(ctypes.c_void_p(h), d, len(d),
                     arr.ctypes.data_as(ctypes.c_void_p), cap, unk_id)
    check(0 <= n <= cap, f"the native TextToIds gave {n} for a document")
    return arr[:n].tolist()


def check_native(tok, native, docs, ids, bounds, label: str) -> None:
    """Every document's ids equal the native runtime's TextToIds."""
    rt, h = native.get_runtime(), tok._native_fallback_handle()
    check(h is not None, "the native runtime rejected the model")
    t0 = time.perf_counter()
    bad = [i for i, d in enumerate(docs)
           if native_ids(rt, h, d) != ids[bounds[i] : bounds[i + 1]].tolist()]
    check(not bad, f"{label}: {len(bad)} docs differ from the native runtime, "
          f"first {bad[:5]}")
    log(f"[{label}] all {len(docs)} docs equal the native runtime's TextToIds "
        f"({time.perf_counter() - t0:.1f} s)")


def classic_launches(tok, sub, launch_rows, dev) -> list:
    """(x, lengths) of every launch (every row width) of the classic rows of
    ``sub`` on the card."""
    x, ln, _status = tok._prep_batch(sub)
    keep = np.flatnonzero(ln > 0)
    x, ln = x[keep], ln[keep]
    launches = []
    for w, idx in tok._row_groups(ln):
        step = launch_rows(tok, w, None)
        for lo in range(0, len(idx), step):
            part = idx[lo : lo + step]
            launches.append((
                torch.from_numpy(np.ascontiguousarray(x[part, :w])).to(dev),
                torch.from_numpy(np.ascontiguousarray(ln[part])).to(dev)))
    return launches


def classic_kernels(toks, fault, docs, bpe_ops, launch_rows, dev) -> dict:
    """Phase 27: K1 and K2 against their plain versions on the rows of every
    launch (every row width) of the classic rows of one uncached CMP_BYTES
    batch, in each table mode of ``toks`` (mode -> SpTokenizer; the stats of
    the main path's mode, comb, go to the JSON line, the others to the log),
    and on the rows of the rank-fault model ``fault``."""
    sub = corpus_prefix(docs, CMP_BYTES)
    by_mode = {}
    for mode, tok in toks.items():
        t = tok.tables
        spm, a_max = tok._spm_iw, tok.a_max
        stats = new_stats(("bpe_walk", "bpe_resolve"), "bpe_classic")
        launches = classic_launches(tok, sub, launch_rows, dev)
        for xd, ld in launches:
            B, W = xd.shape
            r_k, r, k_ms, v_ms, claim = bpe_pair_vs_plain(
                stats, "bpe_classic", bpe_ops, t, xd, ld, spm, a_max,
                reps=(20, 2, 1))
            log(f"[kernels-b] {mode} rank: {B} rows of width {W}: walk and "
                f"resolve equal their plain versions; ms per launch walk "
                f"{k_ms:.5f} resolve {v_ms:.5f}; fallback rows "
                f"{int(r_k[4].sum())}; table bytes read {r.table_bytes()} in "
                f"{r.steps} live lane-steps; {claim}")
            del r_k

        def once():
            for xd, ld in launches:
                m, mr, so = bpe_ops.bpe_walk(t, xd, ld, spm)
                bpe_ops.bpe_resolve(t, m, mr, so, xd, ld, spm, 0, a_max)

        profiled_device_ms(once, stats)
        for (name, _path), s in stats.items():
            bound, bound_by = bound_of(s)
            log(f"[kernels-b] {mode} {name}: {len(launches)} launches, "
                f"{s['ms']:.4f} ms, device {s['device_ms']} ms, plain "
                f"{s['plain_ms']:.4f} ms, bound {bound:.5f} ms ({bound_by}), "
                f"max_abs_err {s['err']}")
        by_mode[mode] = stats
    # the rank-fault rows: unknown q runs that a real piece ends inside
    fdocs = [b"aqq b", b"b aqqq", b"baqqb", b"aq b", b"ab a"]
    fx, fl, _status = fault._prep_batch(fdocs)
    fx, fl = torch.from_numpy(fx).to(dev), torch.from_numpy(fl).to(dev)
    ft = fault.tables
    m, mr, so = bpe_ops.bpe_walk(ft, fx, fl, fault._spm_iw)
    pm, pmr, pso = bpe_ops._walk_plain(ft, fx, fl, fault._spm_iw,
                                       bpe_ops._walk_depth(ft, None), False)
    r_k = bpe_ops.bpe_resolve(ft, m, mr, so, fx, fl, fault._spm_iw, 0,
                              fault.a_max)
    r_p = bpe_ops._resolve_plain(ft, m, mr, so, fx, fl, fault._spm_iw, 0,
                                 fault.a_max)
    torch.cuda.synchronize()
    err_f = max(max_abs_err([(m, pm), (mr, pmr), (so, pso)]),
                max_abs_err(zip(r_k, r_p)))
    got = [r_k[0][i, : r_k[3][i]].tolist() for i in range(len(fdocs))]
    want = [fault._oracle.text_to_ids(d) for d in fdocs]
    check(got == want, f"K2 on the rank-fault rows gave {got}, the oracle {want}")
    log(f"[kernels-b] rank-fault rows: K1 and K2 equal their plain versions "
        f"(max_abs_err {err_f}) and the oracle: {got[:3]}")
    stats = by_mode["comb"]
    for k, s in stats.items():
        s["err"] = max([by_mode[m][k]["err"] for m in by_mode] + [err_f])
    return stats


def run_dp(mesh, toks, want, hyb, sub, testing, dedup, native, dev):
    """Phase 30 in a process group: ShardedSpRunner.run and run_units of
    each tokenizer of ``toks`` (kind -> SpTokenizer) and ShardedWpRunner
    .run_rows of ``hyb``'s packed rows, over the documents ``sub``.  Totals
    and checksums must equal the plain shard_stats on the host over the
    same rows; run_units' ids equal ``want[kind]`` (the main runs') on every
    document it does not mark; run_rows' rows equal WordPieceHybrid
    .dispatch's.  Returns the (name, ids, counts) slabs for kernels-dp."""
    slabs = []
    for kind, tok in toks.items():
        runner = mesh.ShardedSpRunner(tok)
        t0 = time.perf_counter()
        ids, counts, _fb, first, st = runner.run(sub)
        t_run = time.perf_counter() - t0
        exp = mesh.finish_stats(mesh._shard_stats_plain(ids.cpu(),
                                                        counts.cpu()))
        check(first == 0 and len(ids) == len(sub)
              and (st.total_tokens, st.checksum) == exp,
              f"main-dp {kind} run: stats {st} differ from the host's {exp}")
        slabs.append((f"{kind} run", ids, counts))
        t0 = time.perf_counter()
        u_ids, u_bounds, need, _status, st_u = runner.run_units(sub)
        t_units = time.perf_counter() - t0
        bad = [i for i in np.flatnonzero(~need)
               if u_ids[u_bounds[i] : u_bounds[i + 1]].tolist() != want[kind][i]]
        check(not bad, f"main-dp {kind} run_units: {len(bad)} docs differ "
              f"from the main run's, first {bad[:5]}")
        # the same rows on one card, one full-depth pass a launch
        units = tok._unit_runner()
        nu = native.units_analyze(sub, tok.n_doc, tok._sym2iw, units.spm_iw,
                                  tok.seg.use_raw_bytes,
                                  tok.seg.no_dummy_prefix, tok.seg.charmap)
        R = nu.n_rows
        xd = torch.from_numpy(nu.px[:R]).to(dev)
        ld = torch.from_numpy(nu.plen[:R]).to(dev)
        nu.close()
        acc = torch.zeros(2, dtype=torch.int64)
        step = dedup.launch_rows(tok, tok.n_doc, None)
        for lo in range(0, R, step):
            u_k, _st, c_k, _f = units._kernel(xd[lo : lo + step],
                                              ld[lo : lo + step], 0)
            acc += mesh._shard_stats_plain(u_k.cpu(), c_k.cpu())
            slabs.append((f"{kind} run_units", u_k, c_k))
        exp_u = mesh.finish_stats(acc)
        check((st_u.total_tokens, st_u.checksum) == exp_u,
              f"main-dp {kind} run_units: stats {st_u} differ from the "
              f"host's {exp_u}")
        log(f"[main-dp] {kind}: run {t_run:.3f} s ({len(sub)} rows, total "
            f"{st.total_tokens}, checksum {st.checksum}); run_units "
            f"{t_units:.3f} s ({R} rows, total {st_u.total_tokens}, "
            f"checksum {st_u.checksum}, {int(need.sum())} docs marked); "
            f"both equal the host's plain shard_stats, run_units' ids the "
            f"main run's")
    runner_w = mesh.ShardedWpRunner(hyb)
    outs = []
    for bx, bi, lw in testing.wp_slabs(hyb, sub):
        t0 = time.perf_counter()
        rows, total, chk = runner_w.run_rows(bx, bi, lw)
        t_rows = time.perf_counter() - t0
        out = torch.from_numpy(rows).to(dev)
        exp = mesh.finish_stats(mesh._shard_stats_plain(out[:, :-2].cpu(),
                                                        out[:, -2].cpu()))
        check((total, chk) == exp, f"main-dp run_rows lw {lw}: stats "
              f"{(total, chk)} differ from the host's {exp}")
        outs.append(rows)
        slabs.append((f"wordpiece lw {lw}", out[:, :-2], out[:, -2]))
        log(f"[main-dp] wordpiece lw {lw}: run_rows {t_rows:.3f} s, "
            f"{len(rows)} rows, total {total}, checksum {chk}")
    h, _b, _row, _off, host, done = hyb.dispatch(sub)
    if done is not None:
        done.synchronize()
    ref = host.numpy().copy()
    hyb._rt.BtlWpFree(h)
    check(np.array_equal(np.concatenate(outs), ref),
          "main-dp: run_rows' rows differ from WordPieceHybrid.dispatch's")
    log(f"[main-dp] run_rows' {len(ref)} rows equal WordPieceHybrid"
        f".dispatch's")
    return slabs


def units_np_kernels(toks, docs, bpe_ops, uni_ops, dedup, dev) -> dict:
    """Phase 29: K11 against its plain version (and the segment kernels
    whose output it packs: K1 and K2, or K5 and K6) on every launch of the
    NumPy unit path of one uncached CMP_BYTES batch, for each tokenizer of
    ``toks`` (path -> SpTokenizer at WIDE_DOC); K11 is timed into an output
    allocated beforehand, as UnitRunner.dispatch calls it, and its library
    call is one torch.cat of the same planes into such an output."""
    sub = corpus_prefix(docs, CMP_BYTES)
    stats = {}
    for path, tok in toks.items():
        seg = (("bpe_walk", "bpe_resolve") if tok.is_bpe
               else ("unigram_walk", "unigram_viterbi"))
        st = new_stats(seg + ("pack_out",), path)
        runner = tok._unit_runner()
        ub, W, launches, t_split, t_pack = units_np_launches(
            tok, sub, dedup, bpe_ops, dev)
        log(f"[kernels-p] {path}: {len(ub.inst_unit)} unit instances, "
            f"{len(ub.u_len)} distinct, {int(ub.classic.sum())} docs with a "
            f"unit past {dedup.UNIT_MAX}; split and dedup {t_split:.3f} s, "
            f"pack {t_pack:.3f} s (host); {sum(len(x) for x, _l in launches)} "
            f"rows of {W} in {len(launches)} launches")
        a_max = min(tok.a_max, bpe_ops.RESOLVE_MAX_ARCS)
        packs = []
        for xd, ld in launches:
            B = xd.shape[0]
            if tok.is_bpe:
                r_k, _r, k_ms, v_ms, claim = bpe_pair_vs_plain(
                    st, path, bpe_ops, tok.tables, xd, ld, runner.spm_iw,
                    a_max, reps=(20, 2, 1))
                fb = r_k[4]
                log(f"[kernels-p] {path}: {B} rows of {xd.shape[1]}: {claim}")
            else:
                r_k, _r, k_ms, v_ms, shape = uni_pair_vs_plain(
                    st, path, uni_ops, tok.tables, xd, ld, None,
                    reps=(20, 2, 1))
                fb = torch.zeros(B, dtype=torch.bool, device=dev)
                log(f"[kernels-p] {path}: {shape}")
            ids, sts, cnt = r_k[0], r_k[1], r_k[3]
            packs.append((ids, sts, cnt, fb))
            N = ids.shape[1]
            s = st[("pack_out", path)]
            o_k = dedup.pack_out(ids, sts, cnt, fb)
            o_p = dedup._pack_out_plain(ids, sts, cnt, fb)
            torch.cuda.synchronize()
            s["err"] = max(s["err"], max_abs_err([(o_k, o_p)]))
            s["plain_ms"] += cuda_ms(
                lambda: dedup._pack_out_plain(ids, sts, cnt, fb), 50)
            cols = [ids, sts, cnt[:, None], fb.to(torch.int32)[:, None]]
            # into an output allocated beforehand, as UnitRunner.dispatch
            # calls it (a slice of the batch's rows), and torch.cat likewise,
            # in turns (kernel, library, library, kernel)
            turns = [cuda_ms(f, 50) for f in (
                lambda: dedup.pack_out(ids, sts, cnt, fb, out=o_k),
                lambda: torch.cat(cols, dim=1, out=o_p),
                lambda: torch.cat(cols, dim=1, out=o_p),
                lambda: dedup.pack_out(ids, sts, cnt, fb, out=o_k))]
            p_ms = (turns[0] + turns[3]) / 2
            s["ms"] += p_ms
            s["library_ms"] = (s["library_ms"] or 0.0) + (turns[1]
                                                           + turns[2]) / 2
            log(f"[kernels-p] {path}: K11 and torch.cat into a given output "
                f"in turns (kernel, library, library, kernel): "
                f"{[round(v, 5) for v in turns]} ms")
            s["bytes"] += 2 * B * N * 4 + B * 4 + B + B * (2 * N + 2) * 4
            s["ops"] += B * (2 * N + 2)
            log(f"[kernels-p] {path}: {B} rows of {N}: segment and pack "
                f"equal their plain versions; ms per launch {seg[0]} "
                f"{k_ms:.5f} {seg[1]} {v_ms:.5f} pack_out {p_ms:.5f}; "
                f"fallback rows {int(fb.sum())}")
            if len(packs) == 1:
                host_ns_log(f"[kernels-p] {path}:", "pack_out", dedup, ids,
                            sts, cnt, fb)

        def once():
            for (xd, ld), (ids, sts, cnt, fb) in zip(launches, packs):
                runner._kernel(xd, ld, 0)
                dedup.pack_out(ids, sts, cnt, fb)

        profiled_device_ms(once, st)
        for (name, _path), s in st.items():
            bound, bound_by = bound_of(s)
            log(f"[kernels-p] {path} {name}: {s['ms']:.4f} ms, device "
                f"{s['device_ms']} ms, plain {s['plain_ms']:.4f} ms, library "
                f"{s['library_ms']} ms, bound {bound:.5f} ms ({bound_by}), "
                f"max_abs_err {s['err']}")
        stats.update(st)
    return stats


def host_ns_log(tag: str, name: str, dedup, ids, sts, cnt, fb) -> None:
    """Log :func:`pack_host_ns` after ``tag`` (the phase's log prefix)."""
    from blingfire_tpu_torch import kernels

    B, N = ids.shape
    ns = pack_host_ns(name, dedup, kernels, ids, sts, cnt, fb)
    log(f"{tag} {K_IDS[name]} {name}'s host ns a call at {B} rows of {N} "
        f"(1,000 calls a part): { {k: round(v) for k, v in ns.items()} }")


def pack_host_ns(name: str, dedup, kernels, ids, sts, cnt, fb,
                 n: int = 1000) -> dict:
    """Host ns per call of K11's (``name`` "pack_out") or K4's
    ("pack_out_compact") wrapper and of its parts, over ``n`` calls each at
    these shapes (perf_counter_ns; the launches are queued, the card
    drained between parts): the checks of the four inputs and the output,
    the output's allocation, the device test, the stream lookup, the
    pointers, the ctypes call that launches the kernel, the whole wrapper
    into a given output (as the unit paths call it) and allocating one;
    beside K11, torch.cat of the same planes, likewise; beside K4, its
    plain version."""
    B, N = ids.shape
    k11 = name == "pack_out"
    width = 2 * N + 2 if k11 else N + 2
    extra = () if k11 else (dedup.ID_SHIFT,)
    wrap = dedup.pack_out if k11 else dedup.pack_out_compact
    out = torch.empty((B, width), dtype=torch.int32, device=ids.device)
    fn, _err = kernels._fns[name]
    idx = ids.device.index
    ptrs = (ids.data_ptr(), sts.data_ptr(), cnt.data_ptr(), fb.data_ptr(),
            out.data_ptr(), B, N) + extra
    stream = torch._C._cuda_getCurrentRawStream(idx)
    parts = {
        "checks": lambda: dedup._check_pack(ids, sts, cnt, fb, out, width),
        "alloc": lambda: ids.new_empty((B, width)),
        "device": lambda: torch._C._cuda_getDevice() == idx,
        "stream": lambda: torch._C._cuda_getCurrentRawStream(idx),
        "pointers": lambda: (ids.data_ptr(), sts.data_ptr(), cnt.data_ptr(),
                             fb.data_ptr(), out.data_ptr()),
        "ctypes_call": lambda: fn(*ptrs, stream),
        "wrapper": lambda: wrap(ids, sts, cnt, fb, out=out),
        "wrapper_alloc": lambda: wrap(ids, sts, cnt, fb),
    }
    if k11:
        cols = [ids, sts, cnt[:, None], fb.to(torch.int32)[:, None]]
        parts["torch_cat"] = lambda: torch.cat(cols, dim=1, out=out)
        parts["torch_cat_alloc"] = lambda: torch.cat(cols, dim=1)
    else:
        parts["plain"] = lambda: dedup._pack_out_compact_plain(ids, sts, cnt,
                                                               fb)
    ns = {}
    for part, f in parts.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            f()
        ns[part] = (time.perf_counter_ns() - t0) / n
        torch.cuda.synchronize()
    return ns


def run_api(blobs, docs, sub, want, native, kernels, metrics) -> None:
    """Phase 32: the product API, its drop-in layer and the top-level
    entry points as a user calls them.  ``blobs``: family (gpt2, xlnet, bert) ->
    model image; ``want``: family -> (ids, bounds) of main, main-u and
    main-w over ``docs`` (the first ``len(sub)`` for xlnet and bert)."""
    import glob
    import tempfile

    from blingfire_tpu_torch import api, compat, entry

    n_bytes = sum(map(len, docs))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for kind, blob in blobs.items():
            paths[kind] = os.path.join(tmp, f"{kind}.bin")
            with open(paths[kind], "wb") as f:
                f.write(blob)
        # the gpt2-shaped model over the whole corpus, the default device
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        h = api.load_model(paths["gpt2"])
        t_load = time.perf_counter() - t0
        check(sum(kernels.launches.values()) == 0,
              "api.load_model launched a kernel")
        t0 = time.perf_counter()
        got = h.text_to_ids_batch(docs)
        t_first = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        again = h.text_to_ids_batch(docs)
        t_second = time.perf_counter() - t0
        check(again == got, "a second text_to_ids_batch gave other ids")
        del again
        for name in ("bpe_walk", "bpe_resolve", "pack_out_compact"):
            check(launches.get(name, 0) > 0,
                  f"kernel {name} never launched on main-api")
        ids, bounds = want["gpt2"]
        bad = [i for i in range(len(docs))
               if got[i] != ids[bounds[i] : bounds[i + 1]].tolist()]
        check(not bad, f"main-api: {len(bad)} docs differ from main's, first "
              f"{bad[:5]}")
        # the split of a call: the same tokenizer's pipelined flat call, and
        # the per-document lists made from its flat ids
        t0 = time.perf_counter()
        f_ids, f_bounds = h._sp.encode_corpus_flat(docs)
        t_flat = time.perf_counter() - t0
        t0 = time.perf_counter()
        lists = [f_ids[f_bounds[i] : f_bounds[i + 1]].tolist()
                 for i in range(len(docs))]
        t_lists = time.perf_counter() - t0
        check(lists == got, "encode_corpus_flat gave other ids")
        del lists, f_ids, f_bounds
        n_tok = sum(map(len, got))
        log(f"[main-api] split: the same tokenizer's encode_corpus_flat "
            f"{t_flat:.3f} s, the {len(docs)} lists from its flat ids "
            f"{t_lists:.3f} s")
        log(f"[main-api] api.load_model(gpt2-shaped) {t_load:.3f} s; "
            f"text_to_ids_batch over {len(docs)} docs, {n_bytes} B: first "
            f"call {t_first:.3f} s ({n_bytes / t_first:.0f} B/s, "
            f"{n_tok / t_first:.0f} tokens/s; the tokenizer built in it), "
            f"second {t_second:.3f} s ({n_bytes / t_second:.0f} B/s); peak "
            f"device memory {peak} B; launches {launches}; the ids of all "
            f"{len(docs)} docs equal main's")
        del got
        # the xlnet- and bert-shaped models over the first 4 MiB
        for kind, unk, names in (
                ("xlnet", 0, ("unigram_walk", "unigram_viterbi",
                              "pack_out_compact")),
                ("bert", WP_UNK, WP_MAIN)):
            kernels.reset_launches()
            hk = api.load_model(paths[kind])
            t0 = time.perf_counter()
            got = hk.text_to_ids_batch(sub, unk_id=unk)
            t_k = time.perf_counter() - t0
            run_k = dict(kernels.launches)
            for name in names:
                check(run_k.get(name, 0) > 0,
                      f"kernel {name} never launched on main-api {kind}")
            ids, bounds = want[kind]
            check(got == [ids[bounds[i] : bounds[i + 1]].tolist()
                          for i in range(len(sub))],
                  f"main-api {kind}: other ids than the main run's")
            log(f"[main-api] {kind}-shaped text_to_ids_batch over {len(sub)} "
                f"docs (unk_id {unk}), first call {t_k:.3f} s; engine "
                f"{type(hk._wp_dev or hk._sp).__name__}; launches {run_k}; "
                f"the ids equal main-{'u' if kind == 'xlnet' else 'w'}'s")
            del hk, got
        # the drop-in layer on sampled documents, against the native runtime
        rt = native.get_runtime()
        rng = np.random.default_rng(0)
        sample = rng.choice(len(docs), ORACLE_DOCS, replace=False)
        t0 = time.perf_counter()
        n_hash = 0
        for i in sample:
            d = docs[i]
            words = compat.text_to_words(d)
            check(words == (native.text_to_words(d) or ""),
                  f"compat.text_to_words: doc {i} differs from the native "
                  f"runtime")
            check(compat.text_to_sentences(d)
                  == (native.text_to_words(d, sentences=True) or ""),
                  f"compat.text_to_sentences: doc {i} differs")
            hashes = compat.text_to_hashes(words, 2, 2_000_000)
            w = words.encode("utf-8")
            arr = np.zeros(3 * len(w) + 16, np.int32)
            n = rt.TextToHashes(w, len(w), arr.ctypes.data_as(ctypes.c_void_p),
                                len(arr), 2, 2_000_000)
            check(np.array_equal(hashes, arr[:n]),
                  f"compat.text_to_hashes: doc {i} differs")
            n_hash += n
        log(f"[main-api] compat.text_to_words, text_to_sentences and "
            f"text_to_hashes (bigrams, {n_hash} hashes) of {ORACLE_DOCS} "
            f"sampled docs equal the native runtime's "
            f"({time.perf_counter() - t0:.1f} s)")
        # the flagship's forward step
        kernels.reset_launches()
        t0 = time.perf_counter()
        fn, args = entry.entry()
        t_init = time.perf_counter() - t0
        t0 = time.perf_counter()
        e_ids, _st, _en, e_counts, e_fb = fn(*args)
        torch.cuda.synchronize()
        t_fn = time.perf_counter() - t0
        run_e = dict(kernels.launches)
        for name in ("bpe_walk", "bpe_resolve"):
            check(run_e.get(name, 0) > 0, f"entry(): {name} never launched")
        e_counts = e_counts.cpu()
        e_ids = e_ids.cpu()
        check(not e_fb.any().item()
              and [e_ids[i, : e_counts[i]].tolist()
                   for i in range(len(e_counts))]
              == entry._flagship("cuda").encode_batch(entry.ENTRY_DOCS),
              "entry(): other ids than encode_batch of the same documents")
        log(f"[main-api] entry(): flagship built {t_init:.3f} s, fn(*args) "
            f"{t_fn:.4f} s on rows {tuple(args[0].shape)}; launches {run_e}; "
            f"ids equal encode_batch's")
        # the data-parallel dry run, one NCCL rank
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = entry.dryrun_multichip(1, models=blobs)
        t_dry = time.perf_counter() - t0
        run_d = dict(kernels.launches)
        check(run_d.get("shard_stats", 0) > 0,
              "dryrun_multichip: K12 never launched")
        log(f"[main-api] dryrun_multichip(1) (NCCL, one rank) {t_dry:.3f} s: "
            f"{res}; launches {run_d}")
        # one text_to_ids_batch call under profile_trace, retried once
        for attempt in (1, 2):
            log_dir = os.path.join(tmp, f"trace{attempt}")
            t0 = time.perf_counter()
            with metrics.profile_trace(log_dir):
                h.text_to_ids_batch(sub)
                torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
            files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
            check(len(files) == 1, f"profile_trace wrote {files}")
            with open(files[0]) as f:
                events = json.load(f)["traceEvents"]
            n_kernel = sum(1 for e in events if e.get("cat") == "kernel")
            log(f"[main-api] profile_trace of text_to_ids_batch over "
                f"{len(sub)} docs (attempt {attempt}): {t_prof:.3f} s, "
                f"{os.path.getsize(files[0])} B trace, {len(events)} events, "
                f"{n_kernel} CUDA kernel events")
            if n_kernel:
                break
        check(n_kernel > 0, "the trace holds no CUDA kernel event")


def dp_kernels(slabs, mesh) -> dict:
    """Phase 31: K12 against its plain version on each (ids, counts) slab
    of main-dp (the WordPiece slabs strided), their times, byte bound and
    launch floor (the source with the kernel's body emptied, launched by
    the same wrapper at the same grid); no one PyTorch call computes it."""
    from blingfire_tpu_torch.kernels import phase_split

    stats = new_stats(("shard_stats",), "dp")
    s = stats[("shard_stats", "dp")]
    text = phase_split.read_source(os.path.join(
        ROOT, SOURCES["shard_stats"][0]), "bf_shard_stats")
    empty = phase_split.build("k12_empty", phase_split.hollow(
        text, "shard_stats_kernel"), phase_split._own("shard_stats"), False)[0]
    floor = new_stats(("shard_stats",), "floor")
    for name, ids, counts in slabs:
        R, W = ids.shape
        acc = torch.zeros(2, dtype=torch.int64, device=ids.device)
        mesh.shard_stats(ids, counts, acc)
        want = mesh._shard_stats_plain(ids, counts)
        torch.cuda.synchronize()
        got, exp = mesh.finish_stats(acc), mesh.finish_stats(want)
        s["err"] = max(s["err"], float(max(abs(a - b) for a, b in
                                           zip(got, exp))))
        k_ms = cuda_ms(lambda: mesh.shard_stats(ids, counts, acc), 50)
        s["ms"] += k_ms
        with phase_split.swapped(empty):
            f_ms = cuda_ms(lambda: mesh.shard_stats(ids, counts, acc), 50)
        floor[("shard_stats", "floor")]["ms"] += f_ms
        s["plain_ms"] += cuda_ms(lambda: mesh._shard_stats_plain(ids, counts),
                                 20)
        lanes, nb, ops = dp_bytes(ids, counts)
        s["bytes"] += nb
        s["ops"] += ops
        log(f"[kernels-dp] {name}: {R} rows of {W} lanes ({lanes} below the "
            f"counts, {int((counts != 0).sum())} rows with a count): K12 "
            f"{got} equals its plain version {exp}; {k_ms:.5f} ms per "
            f"launch, the empty kernel {f_ms:.5f} ms")

    def once():
        acc = torch.zeros(2, dtype=torch.int64, device="cuda")
        for _name, ids, counts in slabs:
            mesh.shard_stats(ids, counts, acc)

    profiled_device_ms(once, stats)
    with phase_split.swapped(empty):
        profiled_device_ms(once, floor)
    f = floor[("shard_stats", "floor")]
    bound, bound_by = bound_of(s)
    log(f"[kernels-dp] {len(slabs)} launches, {s['ms']:.4f} ms, device "
        f"{s['device_ms']} ms; the empty kernel at the same grids "
        f"{f['ms']:.4f} ms, device {f['device_ms']} ms; plain "
        f"{s['plain_ms']:.4f} ms, bound {bound:.5f} ms ({bound_by}), "
        f"max_abs_err {s['err']}")
    return stats


def sum_or_none(vals):
    """The sum, or None when a value is missing."""
    vals = list(vals)
    return None if None in vals else sum(vals)


def bound_of(s) -> tuple[float, str]:
    t_bytes = s["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = s["ops"] / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_rows(stats, path_runs, kernels) -> list[dict]:
    """The kernels line: one row per kernel with its numbers on each path
    (``stats`` keyed (kernel, path); ``path_runs``: (path, main run)) under
    "by_path" and their sums at the top."""
    rows = []
    for name, route in kernels.ROUTES.items():
        by_path = {}
        for (k, path), s in stats.items():
            if k != name:
                continue
            bound, bound_by = bound_of(s)
            by_path[path] = {
                "replaces": SOURCES[name][1][path],
                "launches": sum(run["launches"].get(name, 0)
                                for p, run in path_runs if p == path),
                "max_abs_err": s["err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": bound,
                "bound_by": bound_by, "library_ms": s["library_ms"],
                "device_ms": s["device_ms"], "device_records": s["records"]}
        check(set(by_path) == {p for p in kernels.PATHS
                               if name in kernels.PATHS[p]},
              f"{name} was not measured on every path that runs it")
        per = list(by_path.values())
        tot = {k: sum(s[k] for (n, _p), s in stats.items() if n == name)
               for k in ("bytes", "ops")}
        bound, bound_by = bound_of(tot)
        row = {"name": name, "kernel": K_IDS[name], "route": route,
               "source": SOURCES[name][0],
               "replaces": per[0]["replaces"]}
        row.update({k: sum_or_none(v[k] for v in per) for k in (
            "launches", "ms", "plain_ms", "library_ms", "device_ms")})
        row["device_records"] = [sum(v["device_records"][i] for v in per)
                                 for i in (0, 1)]
        row.update(max_abs_err=max(v["max_abs_err"] for v in per),
                   bound_ms=bound, bound_by=bound_by, by_path=by_path)
        check(row["max_abs_err"] == 0.0,
              f"{name} disagrees with its plain version")
        check(row["launches"] > 0, f"{name} never launched on a main path")
        rows.append(row)
        for path, v in by_path.items():
            log(f"[kernels] {name} on {path}: {v['ms']:.4f} ms vs plain "
                f"{v['plain_ms']:.4f} ms, device {v['device_ms']} ms (records "
                f"{v['device_records']}), bound "
                f"{v['bound_ms']:.5f} ms ({v['bound_by']}), max_abs_err "
                f"{v['max_abs_err']}, launches {v['launches']}")
        log(f"[kernels] {name}: bound {bound:.5f} ms ({tot['bytes']} B, "
            f"{tot['ops']} ops)")
    return rows


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
    from blingfire_tpu_torch.ops import hyph as hyph_ops
    from blingfire_tpu_torch.ops import lexer as lexer_ops
    from blingfire_tpu_torch.runtime import dedup, metrics
    from blingfire_tpu_torch.runtime.host import SpTokenizer
    from blingfire_tpu_torch.runtime.hyph import BUCKETS, HyphTpu, render
    from blingfire_tpu_torch.ops.tables import build_comb_table_cached
    from blingfire_tpu_torch.runtime.lexer import LexerOracleApi
    from blingfire_tpu_torch.runtime.lexer_host import WordPieceTpu, WordsTpu
    from blingfire_tpu_torch.runtime.wp_hybrid import WordPieceHybrid

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
    n_src = len({kernels.KERNELS[n][0] for n in kernels.KERNELS})
    log(f"[build] nvcc x{n_src} + g++ x2 (host library, runtime) in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    for path in sorted({kernels.lib_path(n) for n in kernels.KERNELS}):
        name = os.path.basename(path).split(".")[0]
        if os.path.exists(path + ".log"):
            for ln in open(path + ".log").read().splitlines():
                if "registers" in ln or "spill" in ln or "Compiling" in ln:
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
    check(main["counters"].oracle_docs == 0,
          "a fallback document reached the scalar oracle")
    ids, bounds = main["ids"], main["bounds"]
    V = len(model.seg.i2info_ids)
    check(len(ids) and ids.min() >= -1 and ids.max() < V,
          f"ids out of range: {ids.min()}..{ids.max()}")
    check_oracle(lambda d: tok._oracle.text_to_ids(d, unk_id=0), docs, ids,
                 bounds, n_edge, "main")
    # main-bc holds the classic rows of this model to these
    sub = corpus_prefix(docs, CMP_BYTES)
    main_sub_ids = [ids[bounds[i] : bounds[i + 1]].tolist()
                    for i in range(len(sub))]
    del ids, bounds

    # ------------------------------------------- 5. kernels vs plain versions
    stats = bpe_kernels(tok, model, docs, native, bpe_ops, dedup, dev)
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
    check(main_u["counters"].oracle_docs == 0,
          "a fallback document reached the scalar oracle")
    check_oracle(lambda d: tok_u._oracle.text_to_ids(d, unk_id=0), docs, ids,
                 bounds, n_edge, "main-u")
    del ids, bounds

    # -------------------------------------------------------- 8. kernels-u
    stats.update(unigram_kernels(tok_u, docs, native, uni_ops, dedup, dev))
    del tok_u

    # --------------------------------------------------------- 9. model-w
    t0 = time.perf_counter()
    blob_w = testing.bert_shaped_model_bytes()
    model_w = load_bytes(blob_w)
    wbd = model_w.wbd
    log(f"[model-w] bert-shaped WordPiece: {testing.BERT_VOCAB} entries, "
        f"{len(blob_w)} B image, {wbd.aut.n_states} states, "
        f"{len(wbd.acts)} actions, largest tag "
        f"{max(int(a[2]) for a in wbd.acts.values())}, max token length "
        f"{wbd.max_token_length}, {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------- 10. main-w
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hyb = WordPieceHybrid(model_w, device="cuda")
    torch.cuda.synchronize()
    check(hyb.available() and hyb._dense is not None,
          "the bert-shaped model is not pack-safe or not dense")
    dnext, _ow, _perm, n_f, n_reach = hyb._dense
    log(f"[model-w] WordPieceHybrid init {time.perf_counter() - t0:.3f} s: A "
        f"{hyb._n_iws}, pack-safe {hyb.available()}, dense sub-grammar "
        f"{dnext.numel()} int32 ({n_reach} reachable states, {n_f} finals "
        f"first)")
    main_w = run_main(hyb, docs, "main-w", kernels, metrics, unk_id=WP_UNK)
    for name in WP_MAIN:
        check(main_w["launches"].get(name, 0) > 0,
              f"kernel {name} never launched on the WordPiece path")
    check(main_w["launches"]["wp_subword_dense"]
          <= main_w["counters"].batches,
          "K7 launched more than once in a batch")
    ids, bounds = main_w["ids"], main_w["bounds"]
    check(ids.min() >= 0 and ids.max() < testing.BERT_VOCAB,
          f"ids out of range: {ids.min()}..{ids.max()}")
    oracle_w = LexerOracleApi(model_w)
    check_oracle(lambda d: oracle_w.text_to_ids(d, unk_id=WP_UNK), docs, ids,
                 bounds, n_edge, "main-w")

    # --------------------------------------------------------- 11. main-wc
    saved = lexer_ops.DENSE_MAX_ENTRIES
    kernels.reset_launches()
    lexer_ops.DENSE_MAX_ENTRIES = -1
    try:
        hyb_c = WordPieceHybrid(model_w, device="cuda")
    finally:
        lexer_ops.DENSE_MAX_ENTRIES = saved
    check(hyb_c._dense is None, "the dense table was not declined")
    c_c = metrics.Counters()
    t0 = time.perf_counter()
    ids_c, bounds_c = hyb_c.encode_corpus_flat(sub, unk_id=WP_UNK,
                                               counters=c_c)
    t_c = time.perf_counter() - t0
    main_wc = {"launches": dict(kernels.launches)}
    log(f"[main-wc] encode_corpus_flat (comb pass) over {len(sub)} docs, "
        f"{sum(map(len, sub))} B: {t_c:.3f} s, {c_c.dispatched_rows} rows, "
        f"{c_c.fallback_docs} fallback docs; launches {main_wc['launches']}")
    check(main_wc["launches"].get("wp_subword_comb", 0) > 0,
          "kernel wp_subword_comb never launched")
    n_sub = len(sub)
    check(np.array_equal(bounds_c, bounds[: n_sub + 1])
          and np.array_equal(ids_c, ids[: bounds[n_sub]]),
          "the comb pass gave other ids than the dense one")
    # main-lw holds WordPieceTpu to these
    sub_ids = [ids[bounds[i] : bounds[i + 1]].tolist() for i in range(n_sub)]
    del ids, bounds, ids_c, bounds_c

    # ------------------------------------------------------- 12. kernels-w
    stats.update(wordpiece_kernels(hyb, hyb_c, docs, lexer_ops, bpe_ops, dev))
    del hyb_c  # hyb runs again in main-dp

    # ------------------------------------- 13. main-wm, 14. kernels-wm
    main_wm, k8_wm = run_mbert(docs, n_edge, dev)
    stats.update(k8_wm)

    # --------------------------------------------------------- 15. model-l
    lex_models = {}
    for name in ("wbd", "sbd"):
        t0 = time.perf_counter()
        m = load_bytes(testing.shipped_lexer_bytes(name))
        comb = build_comb_table_cached(m.wbd.aut, m.source_key, "wbd")
        fns = [(f, s) for f, s in enumerate(LexerOracleApi(m).engine.fn2ini)
               if s is not None and s >= 0]
        s0 = int(comb.owner[0])
        log(f"[model-l] {name}: {comb.n_states} states, {comb.n_slots} "
            f"slots, n_iws {comb.n_iws}, max_token_length "
            f"{m.wbd.max_token_length}, max_depth {m.wbd.max_depth}, "
            f"functions (id, initial state) {fns}, owner[0] = state {s0} "
            f"with base {int(comb.base[s0])}, {len(m.wbd.acts)} actions, "
            f"{time.perf_counter() - t0:.1f} s")
        lex_models[name] = m

    # ------------------------------------------- 16. main-l, 17. main-s
    lex_runs = {}
    lex_paths = {}
    for path, name, meth, unit, sep in (
            ("words", "wbd", "text_to_words_batch", "words", " "),
            ("sentences", "sbd", "text_to_sentences_batch", "sentences",
             "\n")):
        label = {"words": "main-l", "sentences": "main-s"}[path]
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prod = WordsTpu(lex_models[name], device="cuda")
        torch.cuda.synchronize()
        log(f"[{label}] WordsTpu({name}) init {time.perf_counter() - t0:.3f} "
            f"s; buckets {prod.lex.buckets}")
        run = run_lexer_main(
            prod, lambda d, c, p=prod, m=meth: getattr(p, m)(d, counters=c),
            docs, label, unit,
            lambda out, sep=sep: sum(len(o.split(sep)) for o in out if o),
            kernels, metrics)
        out = run["out"]
        sentences = path == "sentences"
        t0 = time.perf_counter()
        bad = [i for i, d in enumerate(docs)
               if native.text_to_words(d, sentences) != out[i]]
        check(not bad, f"{label}: {len(bad)} docs differ from the native "
              f"runtime, first {bad[:5]}")
        log(f"[{label}] all {len(docs)} docs equal the native runtime's "
            f"{'TextToSentences' if sentences else 'TextToWords'} "
            f"({time.perf_counter() - t0:.1f} s)")
        oracle_l = LexerOracleApi(lex_models[name])
        want = (oracle_l.text_to_sentences if sentences
                else oracle_l.text_to_words)
        check_sampled(lambda i: want(docs[i]), lambda i: out[i], len(docs),
                      n_edge, label, "LexerOracleApi")
        if sentences:
            got = prod.text_to_sentences_batch([DOC_107])[0]
            nat = native.text_to_words(DOC_107.encode(), sentences=True)
            check(got == nat and "\n" not in got,
                  "document 107 is not the native runtime's single sentence")
            log(f"[{label}] document 107 is one sentence, as the native "
                f"runtime gives it")
        lex_runs[path] = run
        lex_paths[path] = (prod.lex, True)
        del out, run

    # --------------------------------------------------------- 18. main-lw
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wpt = WordPieceTpu(model_w, device="cuda")
    torch.cuda.synchronize()
    log(f"[main-lw] WordPieceTpu(bert-shaped) init "
        f"{time.perf_counter() - t0:.3f} s")
    c_lw = metrics.Counters()
    t0 = time.perf_counter()
    ids_lw = wpt.text_to_ids_batch(sub, unk_id=WP_UNK, counters=c_lw)
    t_lw = time.perf_counter() - t0
    main_lw = {"launches": dict(kernels.launches)}
    st = wpt.lex.last_stats
    n_ids = sum(map(len, ids_lw))
    n_sub_b = sum(map(len, sub))
    log(f"[main-lw] text_to_ids_batch over {n_sub} docs, {n_sub_b} B: "
        f"{t_lw:.3f} s, {n_sub_b / t_lw:.0f} B/s, {n_ids / t_lw:.0f} ids/s; "
        f"rows by (level, bucket) {dict(sorted(st.rows.items()))}; spans "
        f"memoized {st.memo_hits}, scalar {st.scalar_spans}; peak device "
        f"memory {torch.cuda.max_memory_allocated()} B; stage seconds "
        f"{dict(c_lw.stage_seconds)}; launches {main_lw['launches']}")
    check(main_lw["launches"].get("lexer_pass", 0) > 0,
          "K9 never launched on main-lw")
    check(ids_lw == sub_ids, "WordPieceTpu gave other ids than the hybrid")
    log(f"[main-lw] the ids of all {n_sub} docs equal main-w's")
    lex_paths["wp_lexer"] = (wpt.lex, False)
    del ids_lw, sub_ids

    # ------------------------------------------------------- 19. kernels-l
    stats.update(lexer_kernels(lex_paths, docs, lexer_ops, dev))

    # --------------------------------------------------------- 20. model-h
    t0 = time.perf_counter()
    blob_h = testing.syllab_shaped_model_bytes()
    model_h = load_bytes(blob_h)
    w2h = model_h.w2h
    comb_h = build_comb_table_cached(w2h.aut, model_h.source_key, "w2h")
    s0 = int(comb_h.owner[0])
    log(f"[model-h] syllab-shaped W2H: {testing.SYLLAB_PATTERNS} patterns, "
        f"{len(blob_h)} B image, {comb_h.n_states} states, {comb_h.n_slots} "
        f"slots, n_iws {comb_h.n_iws}, {len(w2h.i2info)} op rows, max_pat "
        f"{max(len(v) for v in w2h.i2info.values())}, owner[0] = state {s0} "
        f"with base {int(comb_h.base[s0])} (negative: "
        f"{int(comb_h.base[s0]) < 0}), {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    words = testing.corpus_words(docs) + testing.hyph_edge_words()
    log(f"[model-h] {len(words)} words from the corpus and the edge words, "
        f"{time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------- 21. main-h
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hy = HyphTpu(model_h, device="cuda")
    torch.cuda.synchronize()
    log(f"[main-h] HyphTpu init {time.perf_counter() - t0:.3f} s; buckets "
        f"{BUCKETS}")
    main_h = run_hyph_main(hy, words, sum(map(len, docs)), kernels, metrics)
    check_hyph(hy, words, main_h.pop("out"), native, blob_h, render)

    # -------------------------------------------------------- 22. kernels-h
    stats.update(hyph_kernels(hy, words, hyph_ops, dev))
    del words, hy

    # --------------------------------------------------------- 23. model-b
    models_b = {}
    for mode, n_cjk in BPE_MODES.items():
        t0 = time.perf_counter()
        blob_b = testing.spm_bpe_shaped_model_bytes(n_cjk=n_cjk)
        models_b[mode] = load_bytes(blob_b)
        log(f"[model-b] spm-BPE-shaped, {n_cjk} CJK characters: "
            f"{len(models_b[mode].seg.i2info_ids)} entries, {len(blob_b)} B "
            f"image, {time.perf_counter() - t0:.1f} s")

    def describe(tok, mode: str, t_init: float) -> None:
        t = tok.tables
        table = ("comb" if t.trie_next is None
                 else f"trie ({t.trie_next.numel()} int32)")
        log(f"[model-b] {mode}: SpTokenizer init {t_init:.3f} s: A "
            f"{tok.comb.n_iws}, {tok.comb.n_states} states, "
            f"{tok.comb.n_slots} comb slots, table {table}, rank mode "
            f"{bpe_ops.rank_mode(t)}, chunk-safe {tok._chunk_safe}, max_len "
            f"{t.max_len}, a_max {tok.a_max}")
        check(bpe_ops.rank_mode(t) and not tok._chunk_safe
              and (t.trie_next is None) == (mode == "comb"),
              f"the {mode} model is not in its table and rank modes")

    # ---------------------------------------------------------- 24. main-b
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tok_b = SpTokenizer(models_b["comb"], max_doc_symbols=CLASSIC_DOC,
                        device="cuda")
    torch.cuda.synchronize()
    describe(tok_b, "comb", time.perf_counter() - t0)
    main_b = run_main(tok_b, docs, "main-b", kernels, metrics)
    for name in kernels.PATHS["bpe_classic"]:
        check(main_b["launches"].get(name, 0) > 0,
              f"kernel {name} never launched on main-b")
    c_b = main_b["counters"]
    n_docs = len(docs)
    log(f"[main-b] {c_b.fallback_docs} docs to the native runtime "
        f"(device fallback share {c_b.fallback_docs / n_docs:.6f}), "
        f"{c_b.chunked_docs} docs past {CLASSIC_DOC} symbols split into chunk "
        f"rows, {c_b.invalid_docs} invalid; served by the card "
        f"{1 - c_b.fallback_docs / n_docs:.6f}; oracle docs {c_b.oracle_docs}")
    check(c_b.oracle_docs == 0, "a fallback document reached the scalar oracle")
    ids, bounds = main_b["ids"], main_b["bounds"]
    check_native(tok_b, native, docs, ids, bounds, "main-b")
    check_oracle(lambda d: tok_b._oracle.text_to_ids(d, unk_id=0), docs, ids,
                 bounds, n_edge, "main-b")
    # the design without chunk rows for a model that is not chunk-safe, as
    # JAX's encode_corpus has it: every document past the window to the
    # native runtime; the same ids, and its time beside the calls above
    tok_b._encode_overflow = lambda over, unk_id, c=None: [None] * len(over)
    c_n = metrics.Counters()
    t0 = time.perf_counter()
    ids_n, bounds_n = tok_b.encode_corpus_flat(docs, counters=c_n)
    t_n = time.perf_counter() - t0
    del tok_b._encode_overflow
    check(np.array_equal(ids_n, ids) and np.array_equal(bounds_n, bounds),
          "long documents through the native runtime gave other ids")
    n_bytes = sum(map(len, docs))
    log(f"[main-b] without chunk rows (long documents to the native runtime): "
        f"{t_n:.3f} s, {n_bytes / t_n:.0f} B/s; {c_n.fallback_docs} docs to "
        f"the native runtime (served by the card "
        f"{1 - c_n.fallback_docs / n_docs:.6f}), {c_n.chunked_docs} chunked; "
        f"stage seconds {dict(c_n.stage_seconds)}; the same ids")
    del ids, bounds, ids_n, bounds_n

    # --------------------------------------------------------- 25. main-br
    kernels.reset_launches()
    t0 = time.perf_counter()
    tok_br = SpTokenizer(models_b["trie"], max_doc_symbols=CLASSIC_DOC,
                         device="cuda")
    torch.cuda.synchronize()
    describe(tok_br, "trie", time.perf_counter() - t0)
    c_br = metrics.Counters()
    t0 = time.perf_counter()
    ids, bounds = tok_br.encode_corpus_flat(sub, counters=c_br)
    t_br = time.perf_counter() - t0
    main_br = {"launches": dict(kernels.launches)}
    log(f"[main-br] encode_corpus_flat over {len(sub)} docs, "
        f"{sum(map(len, sub))} B: {t_br:.3f} s, {c_br.fallback_docs} fallback "
        f"docs, {c_br.chunked_docs} chunked, oracle docs {c_br.oracle_docs}; "
        f"stage seconds {dict(c_br.stage_seconds)}; launches "
        f"{main_br['launches']}")
    for name in ("scatter_trie",) + tuple(kernels.PATHS["bpe_classic"]):
        check(main_br["launches"].get(name, 0) > 0,
              f"kernel {name} never launched on main-br")
    check(c_br.oracle_docs == 0, "a fallback document reached the scalar oracle")
    check_native(tok_br, native, sub, ids, bounds, "main-br")
    del ids, bounds

    # --------------------------------------------------------- 26. main-bc
    kernels.reset_launches()
    tok_bc = SpTokenizer(model, max_doc_symbols=128, device="cuda")
    g = metrics.global_counters()
    before = (g.chunked_docs, g.fallback_docs, g.oracle_docs)
    t0 = time.perf_counter()
    got = tok_bc.encode_batch(sub, dedup=False)
    t_bc = time.perf_counter() - t0
    main_bc = {"launches": dict(kernels.launches)}
    log(f"[main-bc] encode_batch(dedup=False) over {len(sub)} docs: "
        f"{t_bc:.3f} s, {g.chunked_docs - before[0]} docs split into chunk "
        f"rows, {g.fallback_docs - before[1]} fallback docs; launches "
        f"{main_bc['launches']}")
    check(g.oracle_docs == before[2], "a fallback document reached the oracle")
    check(g.chunked_docs > before[0], "no document was split into chunks")
    check(got == main_sub_ids, "the classic rows gave other ids than main's")
    log(f"[main-bc] the ids of all {len(sub)} docs equal main's")
    del got, main_sub_ids, tok_bc

    # ------------------------------------------------------- 27. kernels-b
    fault = SpTokenizer(load_bytes(testing.rank_fault_model_bytes()),
                        max_doc_symbols=16, device="cuda")
    stats.update(classic_kernels({"comb": tok_b, "trie": tok_br}, fault, docs,
                                 bpe_ops, dedup.launch_rows, dev))
    del tok_b, tok_br

    # --------------------------------------------------------- 28. main-ww
    seen = []  # (width, a_max) of every K2 launch of main-ww

    def spy(tables, m_pack, *args):
        seen.append((m_pack.shape[2], args[-1]))
        return resolve(tables, m_pack, *args)

    resolve, bpe_ops.bpe_resolve = bpe_ops.bpe_resolve, spy
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tok_ww = SpTokenizer(model, max_doc_symbols=WIDE_DOC, device="cuda")
        torch.cuda.synchronize()
        log(f"[main-ww] SpTokenizer(gpt2-shaped, max_doc_symbols={WIDE_DOC}) "
            f"init {time.perf_counter() - t0:.3f} s: compact lanes "
            f"{tok_ww._unit_runner().compact_ok}, row_max {tok_ww.row_max}, "
            f"a_max {tok_ww.a_max}")
        check(tok_ww._chunk_safe and not tok_ww._unit_runner().compact_ok,
              "the wide window does not take the NumPy unit path")
        main_ww = run_main(tok_ww, docs, "main-ww", kernels, metrics)
        for name in kernels.PATHS["bpe_units_np"]:
            check(main_ww["launches"].get(name, 0) > 0,
                  f"kernel {name} never launched on main-ww")
        c_w = main_ww["counters"]
        check(c_w.units_np_batches == c_w.batches and c_w.oracle_docs == 0,
              "main-ww left the NumPy unit path or reached the oracle")
        check(np.array_equal(main_ww["ids"], main["ids"])
              and np.array_equal(main_ww["bounds"], main["bounds"]),
              "main-ww gave other ids than main")
        t_st = sum(c_w.stage_seconds.values())
        log(f"[main-ww] the ids of all {len(docs)} docs equal main's; "
            f"{c_w.chunked_docs} docs in chunk rows, {c_w.fallback_docs} to "
            f"the native runtime; shares of the staged time: chunk rows "
            f"{c_w.stage_seconds.get('chunk', 0.0) / t_st:.6f}, native "
            f"runtime {c_w.stage_seconds.get('fallback', 0.0) / t_st:.6f}")
        del main_ww["ids"], main_ww["bounds"]
        # the spm-BPE comb model (classic rows) and the xlnet-shaped model
        # (NumPy unit path) at the same window over the first 4 MiB
        for label, m, path in (("spm-comb", models_b["comb"], "bpe_classic"),
                               ("xlnet", model_u, "unigram_units_np")):
            kernels.reset_launches()
            tk = SpTokenizer(m, max_doc_symbols=WIDE_DOC, device="cuda")
            c = metrics.Counters()
            t0 = time.perf_counter()
            ids, bounds = tk.encode_corpus_flat(sub, counters=c)
            t_x = time.perf_counter() - t0
            run_x = {"launches": dict(kernels.launches)}
            log(f"[main-ww] {label}: row_max {tk.row_max}, encode_corpus_flat "
                f"over {len(sub)} docs: {t_x:.3f} s, {c.chunked_docs} chunked, "
                f"{c.fallback_docs} to the native runtime, NumPy unit batches "
                f"{c.units_np_batches} of {c.batches}; stage seconds "
                f"{dict(c.stage_seconds)}; launches {run_x['launches']}")
            for name in kernels.PATHS[path]:
                check(run_x["launches"].get(name, 0) > 0,
                      f"kernel {name} never launched on main-ww {label}")
            check(c.oracle_docs == 0, "a fallback document reached the oracle")
            check_native(tk, native, sub, ids, bounds, f"main-ww {label}")
            if path == "unigram_units_np":
                check(tk.row_max == WIDE_DOC, "unigram rows were cut")
                main_wu, tok_wu = run_x, tk
            del ids, bounds, tk
    finally:
        bpe_ops.bpe_resolve = resolve
    widths, arcs = {n for n, _a in seen}, {a for _n, a in seen}
    check(seen and max(widths) <= bpe_ops.RESOLVE_MAX_N
          and max(arcs) <= bpe_ops.RESOLVE_MAX_ARCS,
          f"a K2 launch passed its limits: widths {widths}, a_max {arcs}")
    log(f"[main-ww] {len(seen)} K2 launches, widths {sorted(widths)}, a_max "
        f"{sorted(arcs)}: all inside N <= {bpe_ops.RESOLVE_MAX_N}, a_max <= "
        f"{bpe_ops.RESOLVE_MAX_ARCS}")

    # ------------------------------------------------------- 29. kernels-p
    stats.update(units_np_kernels(
        {"bpe_units_np": tok_ww, "unigram_units_np": tok_wu}, docs, bpe_ops,
        uni_ops, dedup, dev))
    del tok_ww, tok_wu

    # --------------------------------------------------------- 30. main-dp
    import socket

    import torch.distributed as dist

    from blingfire_tpu_torch.parallel import mesh

    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    toks_dp = {"gpt2": SpTokenizer(model, max_doc_symbols=128, device="cuda"),
               "xlnet": SpTokenizer(model_u, max_doc_symbols=128,
                                    device="cuda")}
    want = {k: [run["ids"][run["bounds"][i] : run["bounds"][i + 1]].tolist()
                for i in range(len(sub))]
            for k, run in (("gpt2", main), ("xlnet", main_u))}
    kernels.reset_launches()
    mesh.init_group("cuda", init_method=f"tcp://localhost:{port}", rank=0,
                    world_size=1)
    try:
        log(f"[main-dp] NCCL group of {dist.get_world_size()} rank on "
            f"{torch.cuda.device_count()} card(s): one process per card; "
            f"ranks beyond one are not shown on one card")
        slabs = run_dp(mesh, toks_dp, want, hyb, sub, testing, dedup, native,
                       dev)
        main_dp = {"launches": dict(kernels.launches)}
    finally:
        dist.destroy_process_group()
    check(main_dp["launches"].get("shard_stats", 0) > 0,
          "K12 never launched on main-dp")
    log(f"[main-dp] launches {main_dp['launches']}")
    del toks_dp, want, hyb

    # ------------------------------------------------------ 31. kernels-dp
    stats.update(dp_kernels(slabs, mesh))
    del slabs

    # --------------------------------------------------------- 32. main-api
    run_api({"gpt2": blob, "xlnet": blob_u, "bert": blob_w}, docs, sub,
            {k: (run["ids"], run["bounds"]) for k, run in (
                ("gpt2", main), ("xlnet", main_u), ("bert", main_w))},
            native, kernels, metrics)

    path_runs = (("bpe", main), ("unigram", main_u), ("wordpiece", main_w),
                 ("wordpiece", main_wc), ("wordpiece_comb", main_wm),
                 ("words", lex_runs["words"]),
                 ("sentences", lex_runs["sentences"]),
                 ("wp_lexer", main_lw), ("hyph", main_h),
                 ("bpe_classic", main_b), ("bpe_units_np", main_ww),
                 ("unigram_units_np", main_wu), ("dp", main_dp))
    rows = kernel_rows(stats, path_runs, kernels)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
