"""Host ms a MiB of the classic doc rows' stage "dispatch" less its
sub-stage "dispatch.prep": the rows' copies to the card, the K1 and K2
launches of each width group and the pinned copies back
(Counters.stage_seconds)."""

from tb import stages
from tb.readers import per_mib


def read(rec):
    d = stages.seconds(rec, "corpus", "dispatch")
    p = stages.seconds(rec, "corpus", "dispatch.prep")
    if d is None or p is None:
        return None
    return per_mib(rec, (d - p) * 1e3)
