# Port of blingfire_tpu/runtime/metrics.py (Counters.oracle_docs and
# units_np_batches are the port's; profile_trace takes torch.profiler where
# the JAX package takes jax.profiler).
"""Observability: throughput counters, per-stage host timers and a
torch.profiler trace capture.

A stage (:func:`stage`) is the one span of the program: it adds its seconds
to ``Counters.stage_seconds`` and, while a torch.profiler profile records,
opens the profiler range ``stage.<name>`` on the profile's clock, so that a
trace (:func:`profile_trace`) names what the host did while the card
waited.  A sub-stage is named ``<parent>.<child>`` and runs inside its
parent."""

from __future__ import annotations

import contextlib
import json
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Counters:
    bytes_in: int = 0
    docs_in: int = 0
    tokens_out: int = 0
    fallback_docs: int = 0
    fallback_bytes: int = 0  # the bytes of the fallback documents
    # fallback documents the native runtime did not answer (the scalar
    # oracle took them)
    oracle_docs: int = 0
    chunked_docs: int = 0
    invalid_docs: int = 0
    stage_seconds: dict = field(default_factory=lambda: defaultdict(float))
    batches: int = 0
    # cross-batch unit cache (dedup cumulative over the corpus)
    cache_units: int = 0  # distinct units interned over the run
    dispatched_rows: int = 0  # device rows actually dispatched (cache misses)
    # device rows whose fallback flag was set; on the native unit path,
    # counted by the stitch: rows flagged whole or holding a marked token
    flagged_rows: int = 0
    # units the native stitch made resolved-fallback (a marked token, or a
    # row flagged whole): their documents take the fallback for the call
    fallback_units: int = 0
    # batches through the NumPy unit path (a chunk-safe model off the
    # compact lanes, runtime/dedup.py)
    units_np_batches: int = 0
    # the classic doc rows (runtime/host.py::_classic_rows): rows launched,
    # their lanes (the sum of the rows' widths) and the symbols in them;
    # chunk_rows of them are pieces of documents past the window
    classic_rows: int = 0
    classic_lanes: int = 0
    classic_symbols: int = 0
    chunk_rows: int = 0

    def as_dict(self) -> dict:
        total = sum(self.stage_seconds.values())
        return {
            "bytes_in": self.bytes_in,
            "docs_in": self.docs_in,
            "tokens_out": self.tokens_out,
            "fallback_docs": self.fallback_docs,
            "fallback_bytes": self.fallback_bytes,
            "oracle_docs": self.oracle_docs,
            "chunked_docs": self.chunked_docs,
            "invalid_docs": self.invalid_docs,
            "batches": self.batches,
            "cache_units": self.cache_units,
            "dispatched_rows": self.dispatched_rows,
            "flagged_rows": self.flagged_rows,
            "fallback_units": self.fallback_units,
            "units_np_batches": self.units_np_batches,
            "classic_rows": self.classic_rows,
            "classic_lanes": self.classic_lanes,
            "classic_symbols": self.classic_symbols,
            "chunk_rows": self.chunk_rows,
            "stage_seconds": dict(self.stage_seconds),
            "bytes_per_second": self.bytes_in / total if total > 0 else 0.0,
        }

    def to_json(self) -> str:
        return json.dumps(self.as_dict())


_GLOBAL = Counters()


def global_counters() -> Counters:
    return _GLOBAL


@contextlib.contextmanager
def stage(name: str, counters: Counters | None = None):
    """Time the block into ``counters.stage_seconds[name]`` (the global
    counters by default), inside the profiler range ``stage.<name>`` while
    a torch.profiler profile records.  Keep card work out of a sub-stage:
    the profiler mirrors a range over the card work launched inside it."""
    c = counters or _GLOBAL
    # torch's own flag of a recording profiler; no profiler records before
    # torch is imported
    prof = sys.modules.get("torch.autograd.profiler")
    rng = None
    if prof is not None and prof._is_profiler_enabled:
        rng = prof.record_function("stage." + name)
        rng.__enter__()
    t0 = time.perf_counter()
    try:
        yield c
    finally:
        c.stage_seconds[name] += time.perf_counter() - t0
        if rng is not None:
            rng.__exit__(None, None, None)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace of the host and the card around the
    block (metrics.py:69's counterpart) and write it as a Chrome trace,
    ``<host>_<pid>.<time>.pt.trace.json``, into ``log_dir`` (view it in
    chrome://tracing, Perfetto or TensorBoard).  Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
