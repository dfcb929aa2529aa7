"""The port's ShardedWpRunner (blingfire_tpu_torch/parallel/mesh.py) against
the JAX package's, on the bert-shaped WordPiece model: run_rows on each
length class of the hybrid's packed rows (testing.wp_slabs) on 1, 2 and 4
gloo CPU ranks against ShardedWpRunner on meshes of 1, 2 and 4 host
devices.  Output rows, totals and checksums compare exactly."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.parallel import mesh as jax_mesh
from blingfire_tpu.runtime.wp_hybrid import WordPieceHybrid as JaxHybrid
from blingfire_tpu_torch import testing
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.runtime.wp_hybrid import WordPieceHybrid
from test_torch_parallel_bpe import WORLDS, dp_cache, dp_docs  # noqa: F401


@functools.lru_cache(maxsize=1)
def _slabs() -> list[tuple]:
    wp = WordPieceHybrid(load_bytes(testing.DP_MODELS["bert"]()),
                         device="cpu")
    return testing.wp_slabs(wp, dp_docs())


@functools.lru_cache(maxsize=1)
def _want() -> dict:
    jwp = JaxHybrid(jax_load_bytes(testing.DP_MODELS["bert"]()))
    return {n: [jax_mesh.ShardedWpRunner(
        jwp, mesh=jax_mesh.data_parallel_mesh(n)).run_rows(bx, bi, lw)
                for bx, bi, lw in _slabs()] for n in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_bert_run_rows_match_jax(world, tmp_path, monkeypatch, dp_cache):
    monkeypatch.setenv("BLINGFIRE_TPU_TORCH_CACHE", dp_cache)
    slabs = _slabs()
    assert [lw for _x, _i, lw in slabs] == [18, 42]
    ranks = testing.run_dp_ranks("bert", dp_docs(), world, str(tmp_path))
    for k, (rows, total, chk) in enumerate(_want()[world]):
        assert total > 0 and rows.shape[1] == 130
        for r in ranks:
            np.testing.assert_array_equal(r[f"rows{k}"], rows)
            assert list(r[f"stats{k}"]) == [total, chk]
