"""Share of the documents sent that the chunk rows served
(Counters.chunked_docs), %."""

from tb import stages


def read(rec):
    n = stages.counter(rec, "corpus", "chunked_docs")
    if n is None or not rec["docs"]:
        return None
    return 100.0 * n / rec["docs"]
