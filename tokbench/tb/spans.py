"""Spans of a traced run, made from the benchmark's own files: wrappers
around the program's layer boundaries, put in place for the traced run only
and taken out after it.  Each wrapper opens a profiler range of the span's
name, by which the trace's reading names the card's idle gaps.

Wrapped, never edited: ``UnitRunner.dispatch_docs`` and ``collect_docs``
(runtime/dedup.py), ``SpTokenizer._patch_fallbacks`` (runtime/host.py) and
``metrics.stage`` (runtime/metrics.py, the stages "dispatch", "collect",
"chunk" and "fallback" of the corpus path)."""

from __future__ import annotations

import contextlib
import functools

WRAPPED = (("runtime.dedup", "UnitRunner", "dispatch_docs", "dispatch_docs"),
           ("runtime.dedup", "UnitRunner", "collect_docs", "collect_docs"),
           ("runtime.host", "SpTokenizer", "_patch_fallbacks", "fallback_patch"))


class Spans:
    def __init__(self):
        self._undo: list = []

    @staticmethod
    def _ranged(name: str, fn):
        from torch.profiler import record_function

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapper

    def install(self) -> None:
        import importlib

        from torch.profiler import record_function

        for mod_name, cls_name, attr, name in WRAPPED:
            mod = importlib.import_module("blingfire_tpu_torch." + mod_name)
            cls = getattr(mod, cls_name)
            orig = cls.__dict__[attr]
            setattr(cls, attr, self._ranged(name, orig))
            self._undo.append((cls, attr, orig))
        from blingfire_tpu_torch.runtime import metrics

        orig_stage = metrics.stage

        @contextlib.contextmanager
        def stage(name, counters=None):
            with record_function("stage." + name):
                with orig_stage(name, counters) as c:
                    yield c
        metrics.stage = stage
        self._undo.append((metrics, "stage", orig_stage))

    def uninstall(self) -> None:
        while self._undo:
            obj, attr, orig = self._undo.pop()
            setattr(obj, attr, orig)
