"""K2 bpe_resolve's time by phase on the card, from clock64() stamps.

    python3 k2_phase_split.py [--out FILE] [[LABEL=]SOURCE ...]

Each SOURCE (default: this checkout's
blingfire_tpu_torch/kernels/csrc/bpe_resolve.cu, labelled "checkout") is
copied with a stamp after each phase marker comment (``// ---- FILTER``,
``SORT``, ``CLAIM``, ``EMIT``: the lines that open the phases) and one at
the kernel's end; thread 0 of each block writes clock64() there, at points
the whole block has reached (each marker follows a barrier).  The copy is
built by nvcc for sm_90a beside the checkout's kernels and launched through
ops/bpe.py::bpe_resolve in place of the checkout's entry point, so both
take the same arguments.  The inputs are those of three paths, built as
chip_smoke.py builds them from its seeded 32 MiB corpus:

  gpt2     the gpt2-shaped model's packed unit rows at 128 symbols: the
           three regions of one 4 MiB batch (chip_smoke [kernels]);
  main-ww  its NumPy unit rows at max_doc_symbols 2,048: the first launch
           of one 4 MiB batch, 304 rows of 1,024 (chip_smoke [kernels-p]);
  main-b   the spm-BPE-shaped comb model's classic rows at 1,024 in rank
           mode: the launches of one 4 MiB batch (chip_smoke [kernels-b]).

For every launch and source: the outputs equal the plain version
(tolerance 0); each phase's SM cycles summed over the blocks, its share of
the blocks' cycles, and the largest block's; CUDA-event ms of the stamped
copy and of the checkout's kernel; the claim depth (the largest segment's
kept arcs, ops/bpe.py::claim_segments) and the kept arcs of the row that
has most.  Prints the card, one log line per launch, and one JSON object
per source; writes them all to FILE (default build/k2_phases.json).  Needs
one card; imports nothing of JAX or of blingfire_tpu.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MARKER = re.compile(r"^[ \t]*// -+ ([A-Z]+)[ \t]*$", re.M)
KERNEL_END = "\ntemplate <bool RANK>\nstatic int launch("
STAMP_HEAD = """
__device__ unsigned long long* bf_phase_clock;
extern "C" int bf_phase_set(unsigned long long* p) {
    return (int)cudaMemcpyToSymbol(bf_phase_clock, &p, sizeof(p));
}
#define BF_STAMP(k)                                                     \\
    do {                                                                \\
        if (threadIdx.x == 0)                                           \\
            bf_phase_clock[(size_t)blockIdx.x * BF_NSTAMP + (k)] =      \\
                clock64();                                              \\
    } while (0)
"""


def instrument(src: str) -> tuple[str, list[str]]:
    """The source with a stamp after each phase marker and at the kernel's
    end; the phase names, in order."""
    end = src.index(KERNEL_END)
    close = src.rindex("\n}", 0, end)
    marks = [m for m in MARKER.finditer(src) if m.end() < close]
    names = [m.group(1) for m in marks]
    if not names:
        raise ValueError("no phase marker in the kernel")
    out, last = [], 0
    for i, m in enumerate(marks):
        out += [src[last : m.end()], f"\n    BF_STAMP({i});"]
        last = m.end()
    out += [src[last:close], f"\n    BF_STAMP({len(marks)});", src[close:]]
    text = "".join(out)
    inc = text.index('#include "common.cuh"') + len('#include "common.cuh"')
    head = f"\n#define BF_NSTAMP {len(marks) + 1}\n" + STAMP_HEAD
    return text[:inc] + head + text[inc:], names


def build(label: str, path: str, kernels):
    """Build the stamped copy of ``path``: (entry point, error string,
    phase setter, phase names)."""
    from blingfire_tpu_torch.buildutil import build_all, build_dir, source_tag

    with open(path) as f:
        text, names = instrument(f.read())
    d = build_dir("k2_phases")
    src = os.path.join(d, f"{label}.cu")
    with open(src, "w") as f:
        f.write(text)
    tag = source_tag(src, *[os.path.join(kernels.CSRC, h) for h in
                            sorted(os.listdir(kernels.CSRC))
                            if h.endswith(".cuh")],
                     extra=" ".join(kernels.NVCC_FLAGS))
    lib_path = os.path.join(d, f"lib{label}.{tag}.so")
    build_all([(lib_path, lambda tmp: [kernels.nvcc(), *kernels.NVCC_FLAGS,
                                       "-I", kernels.CSRC, "-o", tmp, src])])
    lib = ctypes.CDLL(lib_path)
    _src, entry, argtypes = kernels.KERNELS["bpe_resolve"]
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [ctypes.c_void_p]
    lib.bf_error_string.restype = ctypes.c_char_p
    lib.bf_error_string.argtypes = [ctypes.c_int]
    lib.bf_phase_set.restype = ctypes.c_int
    lib.bf_phase_set.argtypes = [ctypes.c_void_p]
    return fn, lib.bf_error_string, lib.bf_phase_set, names


def path_launches(dev):
    """path -> (tables, spm_iw, a_max, [(x, lengths) of each launch])."""
    import chip_smoke as cs
    from blingfire_tpu_torch import native, testing
    from blingfire_tpu_torch.models.loader import load_bytes
    from blingfire_tpu_torch.ops import bpe as bpe_ops
    from blingfire_tpu_torch.runtime import dedup
    from blingfire_tpu_torch.runtime.host import SpTokenizer

    docs = testing.zipf_corpus(cs.CORPUS_BYTES)
    sub = cs.corpus_prefix(docs, cs.CMP_BYTES)
    gpt2 = load_bytes(testing.gpt2_shaped_model_bytes())
    tok = SpTokenizer(gpt2, max_doc_symbols=128, device=dev.type)
    spm = tok._unit_runner().spm_iw
    regions = cs.packed_regions(native, tok, docs, spm, True, None, dev)
    out = {"gpt2": (tok.tables, spm, tok.a_max,
                    [(x, ln, lw, b) for x, ln, lw, b in regions])}
    tok = SpTokenizer(gpt2, max_doc_symbols=cs.WIDE_DOC, device=dev.type)
    _ub, _w, launches, _ts, _tp = cs.units_np_launches(tok, sub, dedup,
                                                       bpe_ops, dev)
    out["main-ww"] = (tok.tables, tok._unit_runner().spm_iw,
                      min(tok.a_max, bpe_ops.RESOLVE_MAX_ARCS),
                      [(*launches[0], None, False)])
    tok = SpTokenizer(load_bytes(testing.spm_bpe_shaped_model_bytes(
        n_cjk=cs.BPE_MODES["comb"])), max_doc_symbols=cs.CLASSIC_DOC,
        device=dev.type)
    cs.check(tok.tables.trie_next is None and bpe_ops.rank_mode(tok.tables),
             "the main-b model is not in comb and rank modes")
    out["main-b"] = (tok.tables, tok._spm_iw, tok.a_max,
                     [(x, ln, None, False) for x, ln in cs.classic_launches(
                         tok, sub, dedup.launch_rows, dev)])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_phase_split: no CUDA device; this script runs on the GPU "
              "only", file=sys.stderr)
        return 2
    os.environ.setdefault("BLINGFIRE_TPU_TORCH_CACHE", os.path.join(
        ROOT, "build", "blingfire_tpu_torch", "model_cache"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from blingfire_tpu_torch import kernels
    from blingfire_tpu_torch.ops import bpe as bpe_ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    args = sys.argv[1:]
    out_path = os.path.join(ROOT, "build", "k2_phases.json")
    if args[:1] == ["--out"]:
        out_path, args = args[1], args[2:]
    sources = []
    for arg in args or ["checkout=" + os.path.join(kernels.CSRC,
                                                   "bpe_resolve.cu")]:
        label, _eq, path = arg.rpartition("=")
        sources.append((label or os.path.basename(path), path))
    own = kernels._load("bpe_resolve")  # the checkout's entry point
    built = {label: build(label, path, kernels) for label, path in sources}
    dev = torch.device("cuda")
    paths = path_launches(dev)
    results = {label: {"source": path, "phases": built[label][3],
                       "paths": {}} for label, path in sources}
    for name, (t, spm, a_max, launches) in paths.items():
        for i, (x, ln, lw, bounded) in enumerate(launches):
            B, N = x.shape
            m, mr, so = bpe_ops.bpe_walk(t, x, ln, spm, lw=lw,
                                         bounded=bounded)
            want = bpe_ops._resolve_plain(t, m, mr, so, x, ln, spm, 0, a_max)
            arcs = bpe_ops.claim_segments(t, m, mr, x, ln, spm, 0, a_max)
            kept = arcs.keep.sum(dim=1)
            depth, n_keep = int(arcs.depth.max()), int(kept.max())
            del arcs

            def call():
                return bpe_ops.bpe_resolve(t, m, mr, so, x, ln, spm, 0, a_max)

            kernels._fns["bpe_resolve"] = own
            own_ms = cs.cuda_ms(call, 10)
            for label, (fn, err, set_clock, names) in built.items():
                clk = torch.zeros((B, len(names) + 1), dtype=torch.int64,
                                  device=dev)
                cs.check(set_clock(clk.data_ptr()) == 0,
                         "cudaMemcpyToSymbol of the stamp buffer failed")
                kernels._fns["bpe_resolve"] = (fn, err)
                got = call()
                torch.cuda.synchronize()
                stamps = clk.cpu()
                cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                         f"{label} on {name} launch {i} differs from the "
                         f"plain version")
                ms = cs.cuda_ms(call, 10)
                kernels._fns["bpe_resolve"] = own
                cyc = (stamps[:, 1:] - stamps[:, :-1]).double()
                tot = cyc.sum(dim=0)
                row = {"launch": i, "rows": B, "width": N, "lw": lw,
                       "claim_depth": depth, "arcs_max": n_keep,
                       "arcs_mean": float(kept.double().mean()),
                       "ms_stamped": ms, "ms_checkout": own_ms,
                       "cycles": {p: float(c) for p, c in zip(names, tot)},
                       "share": {p: float(c / tot.sum())
                                 for p, c in zip(names, tot)},
                       "block_max_cycles": {
                           p: float(c) for p, c in
                           zip(names, cyc.max(dim=0).values)}}
                results[label]["paths"].setdefault(name, []).append(row)
                cs.log(f"[{label}] {name} launch {i}: {B} rows of {N}, claim "
                       f"depth {depth}, arcs a row up to {n_keep} (mean "
                       f"{row['arcs_mean']:.1f}); {ms:.4f} ms stamped, "
                       f"{own_ms:.4f} ms the checkout's kernel; shares "
                       f"{ {p: round(v, 4) for p, v in row['share'].items()} }"
                       f"; largest block's cycles {row['block_max_cycles']}")
            del m, mr, so, want
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"card": smi, "results": results}, f, indent=1)
    for label, res in results.items():
        print(json.dumps({"source": label, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
