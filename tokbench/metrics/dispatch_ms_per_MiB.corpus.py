"""Host ms a MiB of the corpus path's stage "dispatch" (native prep, unit
dedup, launches): Counters.stage_seconds."""

from tb.readers import per_mib, traced


def read(rec):
    if not traced(rec, "corpus"):
        return None
    s = rec["counters"]["stage_seconds"].get("dispatch", 0.0)
    return per_mib(rec, s * 1e3)
