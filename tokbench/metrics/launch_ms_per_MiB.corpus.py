"""Host ms a MiB of the stage "dispatch" less its sub-stage
"dispatch.analyze": the launch loop (copies to the card, K1, K2 and K4
through ctypes, the pinned copy back) and the call's glue around it
(Counters.stage_seconds)."""

from tb import stages
from tb.readers import per_mib


def read(rec):
    d = stages.seconds(rec, "corpus", "dispatch")
    a = stages.seconds(rec, "corpus", "dispatch.analyze")
    if d is None or a is None:
        return None
    return per_mib(rec, (d - a) * 1e3)
