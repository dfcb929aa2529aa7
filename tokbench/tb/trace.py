"""Reading a traced window: device time, idle share, kernel records and the
breakdown, from one ``torch.profiler`` profile.

The profiler drops kernel records on some runs (PERF.md).  So the window's
kernel records are counted against the launches the program counted over
the same window (``kernels.launches``), as ``measure.profiled_device_ms``
does (a frozen copy of its check): a kernel counts as recorded when the
most frequent of its names has as many records as it had launches.  A
window short of records is run again (run.py); where the last is short
too, the device readings read nothing (tb/readers.py), so that a dropped
record never reads as idle time."""

from __future__ import annotations

import collections

WINDOW = "window"
TOP = 10  # entries of each breakdown list


def _is_device(evt) -> bool:
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CUDA


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespaces'
    parentheses and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:64]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(spans, lo: float, hi: float, outside: str):
    """(start, end, name) segments of [lo, hi], each named by the innermost
    span that covers it (spans of one thread nest), else ``outside``."""
    marks = []
    for i, (a, b, name) in enumerate(spans):
        marks.append((max(a, lo), 1, i))
        marks.append((min(b, hi), 0, i))  # an end sorts before a start
    marks.sort()
    stack: list[int] = []
    segs = []
    t = lo
    for when, is_start, i in marks:
        if when > t:
            segs.append((t, when, spans[stack[-1]][2] if stack else outside))
            t = when
        if is_start:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    if hi > t:
        segs.append((t, hi, outside))
    return segs


def read(prof, span_names, launched: dict, kernel_names: dict,
         outside: str) -> dict:
    """The traced window's readings (seconds): ``window_s``, ``busy_s``
    (any kernel or copy on the card), ``kernel_s`` (kernels), the records
    of each launched kernel against its launches, and ``breakdown``."""
    win = None
    dev = []
    spans = []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name == WINDOW or e.name in span_names:
            # a range of the host's also shows on the card's timeline as a
            # user annotation: it is no device operation
            if _is_device(e):
                continue
        elif _is_device(e):
            dev.append((a, b, e.name))
            continue
        if e.name == WINDOW:
            win = (a, b)
        elif e.name in span_names:
            spans.append((a, b, e.name))
    if win is None:
        raise RuntimeError("the profile holds no window range")
    lo, hi = win
    spans = [s for s in spans if s[1] > lo and s[0] < hi]
    dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    busy = _union([(a, b) for a, b, _n in dev])
    busy_us = sum(b - a for a, b in busy)
    ops = collections.Counter()
    kernel_us = 0.0
    per_name = collections.Counter()
    for a, b, n in dev:
        ops[short_name(n)] += (b - a) / 1e6
        if not n.startswith(("Memcpy", "Memset")):
            kernel_us += b - a
        for k, pats in kernel_names.items():
            for pt in pats:
                if pt in n:
                    per_name[(k, pt)] += 1
    records = {}
    for k, n in launched.items():
        if n <= 0 or k not in kernel_names:
            continue
        records[k] = [max(per_name[(k, pt)] for pt in kernel_names[k]), n]
    idle = collections.Counter()
    gaps = []
    t = lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    segs = _innermost(spans, lo, hi, outside)
    si = 0
    for a, b in gaps:
        while si < len(segs) and segs[si][1] <= a:
            si += 1
        j = si
        while j < len(segs) and segs[j][0] < b:
            s0, s1, name = segs[j]
            idle[name] += (min(b, s1) - max(a, s0)) / 1e6
            j += 1
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernel_s": kernel_us / 1e6,
        "records": records,
        "breakdown": {
            "device_ops": [[n, s] for n, s in ops.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)],
        },
    }
