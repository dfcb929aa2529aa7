"""Arithmetic of the readers of the program's own stages and counters
(``runtime/metrics.py``: ``Counters.stage_seconds`` and the counters beside
it) over a traced window.  A program without a stage or counter leaves it
out of its record, and its readings are then None."""

from __future__ import annotations

from tb.readers import per_mib, traced


def seconds(rec: dict, loop: str, name: str) -> float | None:
    """The stage's seconds over the traced window, or None."""
    if not traced(rec, loop):
        return None
    return rec["counters"].get("stage_seconds", {}).get(name)


def ms_per_mib(rec: dict, loop: str, *names: str) -> float | None:
    """Host ms a MiB of input of the stages ``names`` together, or None
    where one of them is missing."""
    s = [seconds(rec, loop, n) for n in names]
    if None in s:
        return None
    return per_mib(rec, sum(s) * 1e3)


def counter(rec: dict, loop: str, name: str) -> int | None:
    """The counter's count over the traced window, or None."""
    if not traced(rec, loop):
        return None
    return rec["counters"].get(name)
