"""The comparison that decides ``correct``.

What is judged is what the timed path itself produced: after the window,
the ids that the window's calls returned for a sample of the traffic's
documents, drawn from the seed (every edge case and document that is not
UTF-8, the longest documents, and ``sample_docs`` more), each answer of
each call that served one.  The plain reference (tb/reference.py) computes
each sampled document's ids once, from the vocabulary entries; an answer
counts as wrong when it differs in any id.  A call that raised counts as
failed.  Both numbers have the limit 0: the ids are exact."""

from __future__ import annotations

from array import array

import numpy as np

from tb.reference import Reference

LIMITS = {"wrong_answers": 0, "failed_calls": 0}


def sample(n_docs: int, lengths: list[int], seed: int, traffic: dict
           ) -> list[int]:
    """Indices of the sampled documents among the first ``n_docs``."""
    head = int(traffic["sample_head"])  # edge cases and invalid UTF-8 first
    longest = np.argsort(-np.asarray(lengths[:n_docs]), kind="stable")
    rng = np.random.default_rng(seed + 11)
    drawn = rng.choice(n_docs, min(n_docs, int(traffic["sample_docs"])),
                       replace=False)
    picked = set(range(min(head, n_docs)))
    picked |= {int(k) for k in longest[: int(traffic["sample_longest"])]}
    picked |= {int(k) for k in drawn}
    return sorted(picked)


def judge(cfg: dict, entries, charmap, docs, answers: dict, failed: int,
          control: str | None = None) -> dict:
    """The numbers compared, each with its limit: ``answers`` maps a sampled
    document to the int32 bytes of each distinct answer the window gave for
    it and how often it gave it; ``docs[k]`` is document k."""
    ref = Reference(cfg, entries, charmap, control=control)
    unk = int(cfg["unk_id"])
    wrong = 0
    n = 0
    for k, got in answers.items():
        want = array("i", ref.text_to_ids(docs[k], unk)).tobytes()
        wrong += sum(c for g, c in got.items() if g != want)
        n += sum(got.values())
    return {"wrong_answers": {"value": wrong, "limit": LIMITS["wrong_answers"],
                              "of": n},
            "failed_calls": {"value": failed, "limit": LIMITS["failed_calls"]}}


def passed(checks: dict) -> bool:
    return (checks["wrong_answers"]["of"] > 0
            and all(c["value"] <= c["limit"] for c in checks.values()))
