"""The ``corpus`` loop: one caller pre-tokenizing a training corpus.

A step is ``SpTokenizer.encode_corpus_flat`` over the whole shard, back to
back (each call starts a fresh cross-batch unit cache).  The steps take the
shard's fixed orders (tb/corpus.py) in turn, from one that ``--seed``
picks, so that every run does the same work.  Set-up builds the tokenizer
from the configuration's image and warms it with one step on the shard, so
every kernel of the window has run once before it."""

from __future__ import annotations

import time

import numpy as np

from tb import corpus, model

SPAN = "corpus_call"


def served(traffic: dict, docs: list) -> int:
    """How many of the documents a step sends: all of them."""
    return len(docs)


class Loop:
    def __init__(self, cfg: dict, traffic: dict, docs: list[bytes], device,
                 phases: dict, seed: int):
        orders = corpus.orders(len(docs), int(traffic["sample_head"]))
        self.shards = [[docs[i] for i in o] for o in orders]
        # where document k of ``docs`` stands in each order
        self.where = [np.argsort(o) for o in orders]
        self.first = seed % len(orders)
        self.unk_id = int(cfg["unk_id"])
        self.batch_docs = int(traffic["batch_docs"])
        t = time.perf_counter()
        path, _built = model.image_path(cfg["name"], cfg)
        with open(path, "rb") as f:
            image = f.read()
        phases["image"] = time.perf_counter() - t
        t = time.perf_counter()
        from blingfire_tpu_torch import kernels
        from blingfire_tpu_torch.runtime import metrics

        if device.type == "cuda":
            kernels.build(with_native=True)
        phases["build"] = time.perf_counter() - t
        t = time.perf_counter()
        from blingfire_tpu_torch.models.loader import load_bytes
        from blingfire_tpu_torch.runtime.host import SpTokenizer

        m = load_bytes(image)
        phases["model"] = time.perf_counter() - t
        t = time.perf_counter()
        self.tok = SpTokenizer(m, max_doc_symbols=int(cfg["max_doc_symbols"]),
                               device=device)
        phases["engine"] = time.perf_counter() - t
        self.counters = metrics.Counters()
        self.n_docs = served(traffic, docs)
        self.step_bytes = sum(map(len, docs))

    def warm(self) -> None:
        from blingfire_tpu_torch.runtime import metrics

        self.tok.encode_corpus_flat(self.shards[self.first], self.unk_id,
                                    self.batch_docs,
                                    counters=metrics.Counters())

    def step(self, j: int):
        """(first doc, end doc, bytes, ids of doc k as int32 bytes, ids),
        with k an index into the documents as generated."""
        o = (self.first + j) % len(self.shards)
        where = self.where[o]
        ids, bounds = self.tok.encode_corpus_flat(
            self.shards[o], self.unk_id, self.batch_docs,
            counters=self.counters)

        def ids_of(k):
            i = where[k]
            return ids[bounds[i]:bounds[i + 1]].tobytes()
        return 0, self.n_docs, self.step_bytes, ids_of, len(ids)

    def counts(self) -> dict:
        """The program's counters of the steps so far."""
        d = self.counters.as_dict()
        d.pop("bytes_per_second")  # over summed stage seconds: not a rate
        return d

    def close(self) -> None:
        self.tok = None
