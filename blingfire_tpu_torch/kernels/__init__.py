"""Build, load and launch the port's hand-written kernels.

CUDA sources live in ``csrc/``; each is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers), loaded
with ctypes.  :func:`build` starts one ``nvcc`` per source, and the
``g++`` of the host library and of the native runtime, all at once, so the
first use pays the slowest single compile.  Libraries land in
``build/blingfire_tpu_torch/kernels/``, one per source, named by the source
and a hash of it and the headers.  Every kernel is CUDA: the port needs no
Triton.

Every launch goes through :func:`launch`, which adds one to
``launches[name]`` (an entry point of COUNTED_AS counts as its kernel): a
run can show that its main path went through each
kernel.  A C entry point returns the
``cudaGetLastError()`` of its launch; a non-zero code raises.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading

from ..buildutil import build_all, build_dir, source_tag

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# name -> (source, C entry point, argtypes before the trailing stream)
KERNELS = {
    "bpe_walk": ("bpe_walk.cu", "bf_bpe_walk",
                 [_P, _P, _P, _I64] + [_P] * 8 + [_I] * 11 + [_P] * 3),
    "bpe_resolve": ("bpe_resolve.cu", "bf_bpe_resolve",
                    [_P] * 6 + [_I] * 10 + [_P] * 5),
    "scatter_trie": ("scatter_trie.cu", "bf_scatter_trie",
                     [_P, _P, _I64, _P, _I64]),
    "unigram_walk": ("unigram_walk.cu", "bf_unigram_walk",
                     [_P, _P, _I, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _I,
                      _I, _P, _I, _I, _I, _I, _I, _P, _P]),
    "unigram_viterbi": ("unigram_viterbi.cu", "bf_unigram_viterbi",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                         _P]),
    "wp_subword_dense": ("wp_subword.cu", "bf_wp_subword_dense",
                         [_P, _I64, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P]
                         + [_I] * 8 + [_P]),
    "wp_subword_comb": ("wp_subword.cu", "bf_wp_subword_comb",
                        [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P]
                        + [_I] * 8 + [_P]),
    "lexer_pass": ("lexer_pass.cu", "bf_lexer_pass",
                   [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I,
                    _P]),
    "hyph_segment": ("hyph_segment.cu", "bf_hyph_segment",
                     [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I,
                      _P]),
    "hyph_segment_packed": ("hyph_segment.cu", "bf_hyph_segment_packed",
                            [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _I,
                             _I, _P]),
    "shard_stats": ("shard_stats.cu", "bf_shard_stats",
                    [_P, _I64, _P, _I64, _I64, _I, _P]),
    "pack_out": ("pack_out.cu", "bf_pack_out", [_P] * 5 + [_I, _I]),
    "pack_out_compact": ("pack_out.cu", "bf_pack_out_compact",
                         [_P] * 5 + [_I, _I, _I]),
}
# every kernel of each corpus path, with the route it takes
PATHS = {
    "bpe": {
        "scatter_trie": "cuda",
        "bpe_walk": "cuda",
        "bpe_resolve": "cuda",
        "pack_out_compact": "cuda",
    },
    # models off the unit path (not chunk-safe), and long documents' chunks:
    # SpTokenizer's classic doc-row pass, in every table and rank mode
    "bpe_classic": {
        "bpe_walk": "cuda",
        "bpe_resolve": "cuda",
    },
    "unigram": {
        "unigram_walk": "cuda",
        "unigram_viterbi": "cuda",
        "pack_out_compact": "cuda",
    },
    # the comb pass runs only for a sub-grammar too large for the dense table
    # (on this path when it is declined by force)
    "wordpiece": {
        "scatter_trie": "cuda",
        "wp_subword_dense": "cuda",
        "wp_subword_comb": "cuda",
    },
    # a WordPiece model whose dense table make_dense_sub declines (a
    # multilingual vocabulary): the comb pass alone
    "wordpiece_comb": {"wp_subword_comb": "cuda"},
    # the pattern lexer: TextToWords, TextToSentences, WordPieceTpu
    "words": {"lexer_pass": "cuda"},
    "sentences": {"lexer_pass": "cuda"},
    "wp_lexer": {"lexer_pass": "cuda"},
    # W2H hyphenation: HyphTpu.process_batch
    "hyph": {"hyph_segment": "cuda"},
    # the NumPy unit path of a chunk-safe model off the compact lanes (a
    # window past 1,024 symbols): its packed rows, then K11; the documents
    # it marks take the classic doc rows
    "bpe_units_np": {
        "bpe_walk": "cuda",
        "bpe_resolve": "cuda",
        "pack_out": "cuda",
    },
    "unigram_units_np": {
        "unigram_walk": "cuda",
        "unigram_viterbi": "cuda",
        "pack_out": "cuda",
    },
    # the data-parallel runners (parallel/mesh.py): each rank's statistics;
    # their segment kernels are those of the bpe, unigram and wordpiece paths
    "dp": {"shard_stats": "cuda"},
}
ROUTES = {name: route for p in PATHS.values() for name, route in p.items()}
# entry points counted as the kernel they launch: K10 takes every bucket of
# a HyphTpu call in one launch (bf_hyph_segment is its one-segment case)
COUNTED_AS = {"hyph_segment_packed": "hyph_segment"}

launches: collections.Counter = collections.Counter()
_fns: dict = {}  # name -> (C entry point, bf_error_string)
_lock = threading.Lock()


def on_card(t) -> bool:
    """True: launch the kernel (CUDA tensor); False: use the plain version
    (CPU tensor).  Any other device raises: nothing falls back silently."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def check(t, dtype, shape: tuple, name: str) -> None:
    """Raise unless t is a contiguous tensor of this dtype and shape."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


class Reads:
    """The table entries a plain version reads, for its kernel's byte
    bound: a plain walk given one notes each gather (``note``) and its live
    lane-steps (``step``); ``table_bytes`` charges each entry once."""

    def __init__(self):
        self._idx: dict = {}
        self._item: dict = {}
        self.steps = 0

    def note(self, name: str, table, idx, mask) -> None:
        self._item[name] = table.element_size()
        self._idx.setdefault(name, []).append(idx[mask].reshape(-1).unique())

    def step(self, live) -> None:
        self.steps += int(live.sum())

    def entries(self, name: str) -> int:
        import torch

        return int(torch.cat(self._idx[name]).unique().numel()) \
            if name in self._idx else 0

    def table_bytes(self) -> int:
        return sum(self.entries(k) * self._item[k] for k in self._idx)


def reset_launches() -> None:
    launches.clear()


def nvcc() -> str:
    cand = "/usr/local/cuda/bin/nvcc"
    return cand if os.path.exists(cand) else "nvcc"


def lib_path(name: str) -> str:
    """The library of kernel ``name``: one per CUDA source (kernels that
    share a source share it)."""
    src_name = KERNELS[name][0]
    src = os.path.join(CSRC, src_name)
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith(".cuh"))
    tag = source_tag(src, *headers, extra=" ".join(NVCC_FLAGS))
    stem = os.path.splitext(src_name)[0]
    return os.path.join(build_dir("kernels"), f"lib{stem}.{tag}.so")


def _job(name: str):
    src = os.path.join(CSRC, KERNELS[name][0])
    return lib_path(name), lambda tmp: [nvcc(), *NVCC_FLAGS, "-o", tmp, src]


def build(with_native: bool = True) -> None:
    """Compile every CUDA source (and, with_native, the host library and
    the native runtime) in parallel."""
    from .. import native

    jobs = list({lib_path(n): _job(n) for n in KERNELS}.values())
    if with_native:
        jobs += [native.build_job(), native.runtime_build_job()]
    build_all(jobs)


def _load(name: str):
    """Build every CUDA source once, load each library, and resolve every
    entry point into ``_fns``: a launch then looks its kernel up in a dict,
    with no lock and no ``getattr``."""
    with _lock:
        if name not in _fns:
            build(with_native=False)
            for n, (_src, fn, argtypes) in KERNELS.items():
                if n in _fns:
                    continue
                lib = ctypes.CDLL(lib_path(n))
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                f.argtypes = argtypes + [_P]
                lib.bf_error_string.restype = ctypes.c_char_p
                lib.bf_error_string.argtypes = [ctypes.c_int]
                _fns[n] = (f, lib.bf_error_string)
    return _fns[name]


def launch(name: str, device, *args) -> None:
    """Launch kernel ``name`` on the current stream of ``device`` (a CUDA
    torch.device with an index), switching the current device only when it
    differs."""
    import torch

    fn, err = _fns.get(name) or _load(name)
    idx = device.index
    # torch.cuda.current_device() less its lazy-init check: a CUDA tensor
    # exists, so CUDA is initialised
    if idx == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"kernel {name} failed to launch: "
                           f"{err(rc).decode()} ({rc})")
    launches[COUNTED_AS.get(name, name)] += 1
