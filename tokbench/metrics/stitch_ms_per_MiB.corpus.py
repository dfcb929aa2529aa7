"""Host ms a MiB of the stage "collect.stitch": the native stitch of the
unit rows' ids into documents (Counters.stage_seconds)."""

from tb import stages


def read(rec):
    return stages.ms_per_mib(rec, "corpus", "collect.stitch")
