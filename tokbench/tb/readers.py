"""Arithmetic shared by the metric readers (``metrics/<metric>.py``).

A reader takes a run's record (run.py) and returns its number, or None
where the run has nothing to read: a reader of another loop's record, a
trace reading in an untraced run, or a device reading of a profile that
lacks records of some launches."""

from __future__ import annotations

MIB = 1 << 20


def of(rec: dict, loop: str) -> bool:
    return rec.get("loop") == loop and rec.get("steps", 0) > 0


def traced(rec: dict, loop: str) -> bool:
    return of(rec, loop) and "trace" in rec


def per_mib(rec: dict, value: float) -> float:
    return value / (rec["bytes"] / MIB)


def rate_mbps(rec: dict, loop: str) -> float | None:
    """Input bytes of every call of the window over the window, MB/s."""
    if not of(rec, loop) or rec["failed"] or not rec["window_s"] > 0:
        return None
    return rec["bytes"] / rec["window_s"] / 1e6


def fallback_pct(rec: dict, loop: str) -> float | None:
    if not traced(rec, loop) or not rec["docs"]:
        return None
    return 100.0 * rec["counters"]["fallback_docs"] / rec["docs"]


def complete(rec: dict) -> bool:
    """Whether the profile holds a record of every kernel launch of the
    window (tb/trace.py): where one is missing, its device time would read
    as idle time."""
    return all(kept >= launched
               for kept, launched in rec["trace"]["records"].values())


def idle_pct(rec: dict, loop: str) -> float | None:
    if not traced(rec, loop) or not complete(rec):
        return None
    t = rec["trace"]
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]


def kernel_s(rec: dict, loop: str) -> float | None:
    """Profiled device seconds of the window's kernels, when the profile
    holds a record of every launch."""
    if (not traced(rec, loop) or not complete(rec)
            or not rec["trace"]["kernel_s"] > 0):
        return None
    return rec["trace"]["kernel_s"]


def rows_per_mib(rec: dict, loop: str) -> float | None:
    """Unit rows dispatched to the card a MiB of input."""
    if not traced(rec, loop):
        return None
    return per_mib(rec, rec["counters"]["dispatched_rows"])


def launches_per_mib(rec: dict, loop: str) -> float | None:
    if not traced(rec, loop):
        return None
    return per_mib(rec, sum(rec["launches"].values()))


def kernel_ms_per_mib(rec: dict, loop: str) -> float | None:
    s = kernel_s(rec, loop)
    return None if s is None else per_mib(rec, s * 1e3)


def roofline(rec: dict, loop: str) -> float | None:
    """The least time for the window's work (tb/roofline.py) over its
    kernels' profiled device time, %."""
    from tb.roofline import roofline_pct

    s = kernel_s(rec, loop)
    if s is None:
        return None
    return roofline_pct(rec["bytes"], rec["ids"], s, rec["device_name"])
