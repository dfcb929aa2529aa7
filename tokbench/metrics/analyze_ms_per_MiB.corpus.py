"""Host ms a MiB of the stage "dispatch.analyze": native units_analyze
(prep, unit split, dedup against the unit cache, packing), inside
"dispatch" (Counters.stage_seconds)."""

from tb import stages


def read(rec):
    return stages.ms_per_mib(rec, "corpus", "dispatch.analyze")
