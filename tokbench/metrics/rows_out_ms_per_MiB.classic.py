"""Host ms a MiB of the classic doc rows' stage "collect.rows_out": the
scatter of the rows' ids from the pinned copies into document order
(Counters.stage_seconds)."""

from tb import stages


def read(rec):
    return stages.ms_per_mib(rec, "corpus", "collect.rows_out")
