"""The port's data-parallel runners (blingfire_tpu_torch/parallel/mesh.py)
against the JAX package's, on the xlnet-shaped unigram-LM model:
ShardedSpRunner.run and run_units on 1, 2 and 4 gloo CPU ranks against
ShardedSpRunner on meshes of 1, 2 and 4 host devices.  Totals, checksums
and ids compare exactly; unigram rows are never flagged."""

from __future__ import annotations

import functools

import pytest

from test_torch_parallel_bpe import (WORLDS, check_sp_world, dp_cache,  # noqa: F401
                                     dp_docs, jax_sp_runs)


@functools.lru_cache(maxsize=1)
def _want() -> dict:
    return jax_sp_runs("xlnet", dp_docs())


@pytest.mark.parametrize("world", WORLDS)
def test_xlnet_runners_match_jax(world, tmp_path, monkeypatch, dp_cache):
    check_sp_world("xlnet", world, _want()[world], tmp_path, monkeypatch,
                   dp_cache)
