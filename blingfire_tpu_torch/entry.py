"""Top-level entry points of the port, the counterparts of the root
``__graft_entry__.py``: the flagship model's forward step and a
data-parallel dry run, on the seeded models of ``testing.py``.

    from blingfire_tpu_torch import entry
    fn, args = entry.entry()     # fn(*args): bpe_segment (K1, K2) on 8 rows
    entry.dryrun_multichip(4)    # one NCCL rank a card, four cards

Both run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools
import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .parallel import mesh

# the documents of __graft_entry__.py:37 and :97
ENTRY_DOCS = [b"Hello world, this is a test.", b"Another line of text here."] * 4
DRYRUN_DOC = b"Hello world, this is a test line."
DRYRUN_WINDOWS = {"gpt2": 128, "xlnet": 64}  # max_doc_symbols a family
WP_WORD = "hello"  # the word that fills the WordPiece slab (:145)
WP_LW = 16 + 2  # its walk depth
DRYRUN_TIMEOUT = 600.0  # seconds for the spawned ranks to end


@functools.lru_cache(maxsize=2)
def _flagship(device: str = "cuda"):
    """The gpt2-shaped byte-BPE tokenizer (50,256 entries): the flagship."""
    from . import testing
    from .models.loader import load_bytes
    from .runtime.host import SpTokenizer

    return SpTokenizer(load_bytes(testing.gpt2_shaped_model_bytes()),
                       max_doc_symbols=128, device=device)


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): ``fn(x_iw, lengths)`` is ops/bpe.py::bpe_segment
    over the flagship's tables, returning (ids, starts, ends, counts,
    fallback); the arguments are the doc rows of ENTRY_DOCS on ``device``."""
    from .ops import bpe as bpe_ops

    tok = _flagship(str(torch.device(device)))
    tables, spm_iw, a_max = tok.tables, tok._spm_iw, tok.a_max

    def fn(x_iw, lengths):
        return bpe_ops.bpe_segment(tables, x_iw, lengths, spm_iw, 0, a_max)

    x, lengths, _status = tok._prep_batch(ENTRY_DOCS)
    return fn, (torch.from_numpy(x).to(tok.device),
                torch.from_numpy(lengths).to(tok.device))


def dryrun_models() -> dict[str, bytes]:
    """The dry run's models at full width: gpt2-, xlnet- and bert-shaped."""
    from . import testing

    return {"gpt2": testing.gpt2_shaped_model_bytes(),
            "xlnet": testing.xlnet_shaped_model_bytes(),
            "bert": testing.bert_shaped_model_bytes()}


def wp_slab(wp, n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """``n_rows`` packed rows of the hybrid ``wp``, each holding WP_WORD
    between the anchors as many times as a row fits, from the initial
    state of its first function (__graft_entry__.py:144-164)."""
    from .runtime.wp_hybrid import ROW_W

    word = wp._map_raw(np.array([ord(c) for c in WP_WORD], np.int32))
    ext = len(word) + 2
    bx = np.full((n_rows, ROW_W), -1, np.int32)
    bi = np.full((n_rows, ROW_W), -1, np.int32)
    fini = next(int(s) for s in wp._fn2ini[1:] if s >= 0)
    for k in range(ROW_W // ext):
        o = k * ext
        bx[:, o] = wp._l_iw
        bx[:, o + 1 : o + 1 + len(word)] = word[None, :]
        bx[:, o + ext - 1] = wp._r_iw
        bi[:, o : o + ext] = fini
    return bx, bi


def _dryrun_rank(device: torch.device, models: dict[str, bytes],
                 n_devices: int) -> dict[str, list[int]]:
    """This rank's part of the dry run in the running group: the classic
    doc rows of the gpt2- and xlnet-shaped models (ShardedSpRunner.run)
    and a WordPiece slab (ShardedWpRunner.run_rows).  Returns each family's
    [total tokens, checksum] over every rank."""
    from .models.loader import load_bytes
    from .runtime.host import SpTokenizer
    from .runtime.wp_hybrid import WordPieceHybrid

    docs = [DRYRUN_DOC] * (2 * n_devices)
    out = {}
    for kind, window in DRYRUN_WINDOWS.items():
        tok = SpTokenizer(load_bytes(models[kind]), max_doc_symbols=window,
                          device=device)
        *_rows, st = mesh.ShardedSpRunner(tok).run(docs)
        out[kind] = [st.total_tokens, st.checksum]
    wp = WordPieceHybrid(load_bytes(models["bert"]), device=device)
    bx, bi = wp_slab(wp, 2 * n_devices)
    _rows, total, chk = mesh.ShardedWpRunner(wp).run_rows(bx, bi, WP_LW)
    out["bert"] = [total, chk]
    for kind, (total, _chk) in out.items():
        if total <= 0:
            raise RuntimeError(f"the {kind} dry run produced no tokens")
    return out


def _dryrun_worker(rank: int, world: int, init_method: str, device: str,
                   models: dict[str, bytes], out_dir: str) -> None:
    mesh.init_group(device, init_method=init_method, rank=rank,
                    world_size=world)
    try:
        dev = torch.device("cuda", rank) if device == "cuda" else \
            torch.device(device)
        res = _dryrun_rank(dev, models, world)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     models: dict[str, bytes] | None = None
                     ) -> dict[str, list[int]]:
    """Data-parallel tokenization over ``n_devices`` ranks, one a card
    (NCCL; gloo CPU processes with ``device="cpu"``): the runners of
    parallel/mesh.py on the three families, every rank's statistics
    all-reduced.  Returns {family: [total tokens, checksum]}, the same on
    every rank; raises when a total is 0.

    In a running group of ``n_devices`` ranks (torchrun) this process runs
    its rank.  Otherwise a single rank runs in this process, in a group of
    its own, and more ranks are spawned (and must all end within
    DRYRUN_TIMEOUT seconds).  Raises when fewer than ``n_devices`` cards
    are present.  ``models`` maps family to model image (dryrun_models()).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"the dry run needs {n_devices} cards, "
                           f"{torch.cuda.device_count()} present")
    if models is None:
        models = dryrun_models()
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the running group has {dist.get_world_size()} "
                             f"ranks, not {n_devices}")
        return _dryrun_rank(dev, models, n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'init')}"
        if n_devices == 1:
            mesh.init_group(dev, init_method=init_method, rank=0,
                            world_size=1)
            try:
                return _dryrun_rank(dev, models, 1)
            finally:
                dist.destroy_process_group()
        mesh.spawn_ranks(_dryrun_worker,
                         (n_devices, init_method, dev.type, models, tmp),
                         n_devices, DRYRUN_TIMEOUT)
        res = []
        for r in range(n_devices):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
    if any(r != res[0] for r in res):
        raise RuntimeError(f"the ranks' statistics differ: {res}")
    return res[0]
