"""The port's data-parallel runners (blingfire_tpu_torch/parallel/mesh.py)
against the JAX package's, on the gpt2-shaped byte-BPE model: the plain
shard_stats against JAX's statistics formula (mesh.py:97-103), then
ShardedSpRunner.run and run_units on 1, 2 and 4 gloo CPU ranks (spawned
processes, testing.dp_rank) against ShardedSpRunner on meshes of 1, 2 and 4
host devices (tests/conftest.py forces 8).  Totals, checksums and ids
compare exactly.  On the CPU both sides run the scatter branch of the
resolve, whose flags are equal row for row (the test asserts it), so every
row is compared, a flagged one too."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import full_corpus

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.parallel import mesh as jax_mesh
from blingfire_tpu.runtime.host import SpTokenizer as JaxSpTokenizer
from blingfire_tpu_torch import testing
from blingfire_tpu_torch.parallel import mesh

WORLDS = [1, 2, 4]


def dp_docs() -> list[bytes]:
    """tests/corpus.py, the Zipfian corpus and two long punctuation runs:
    103 documents (an odd count, so the batch is padded), some past the
    128-symbol window."""
    zipf = testing.zipf_corpus(60_000)[len(testing.EDGE_CASES):][:40]
    runs = [b"see " + bytes([c]) * 40 + b" end" for c in testing.LONG_CHARS[:2]]
    return ([d.encode("utf-8") for d in full_corpus(n_random=20)][:61] + zipf
            + runs)


def jax_stats(ids, counts):
    """mesh.py:97-103 on (R, W) rows: (total, int32 checksum)."""
    ids, counts = jnp.asarray(ids), jnp.asarray(counts)
    total = jnp.sum(counts)
    pos = jnp.arange(ids.shape[1], dtype=jnp.int32)[None, :]
    masked = jnp.where(pos < counts[:, None], ids, 0)
    weights = pos * jnp.int32(-1640531527) + 1
    return int(total), int(jnp.sum(masked * weights, dtype=jnp.int32))


@pytest.mark.parametrize("layout", ["rows", "wordpiece_slab"])
def test_plain_shard_stats_matches_jax_formula(layout):
    """Ids near 2^20 (and negative lanes) at positions up to 1,023, so the
    int32 products and sums wrap; the WordPiece layout takes ``out[:, :-2]``
    and the count column of an (R, W + 2) slab without a copy."""
    rng = np.random.default_rng(3)
    R, W = 53, 1024
    ids = rng.integers((1 << 20) - 4096, 1 << 20, (R, W), dtype=np.int32)
    ids[::7, ::5] = rng.integers(-(1 << 31), -1, ids[::7, ::5].shape,
                                 dtype=np.int32)
    counts = rng.integers(0, W + 1, R, dtype=np.int32)
    counts[:3] = (0, W, W - 1)
    want = jax_stats(ids, counts)
    if layout == "rows":
        t_ids, t_counts = torch.from_numpy(ids), torch.from_numpy(counts)
    else:
        slab = torch.zeros((R, W + 2), dtype=torch.int32)
        slab[:, :W] = torch.from_numpy(ids)
        slab[:, W] = torch.from_numpy(counts)
        t_ids, t_counts = slab[:, :-2], slab[:, -2]
        assert not t_ids.is_contiguous() and t_counts.stride(0) == W + 2
    acc = torch.zeros(2, dtype=torch.int64)
    mesh.shard_stats(t_ids[:20], t_counts[:20], acc)
    mesh.shard_stats(t_ids[20:], t_counts[20:], acc)
    assert mesh.finish_stats(acc) == want
    assert want[1] != int(np.sum(ids[:, :1]))  # the sums wrapped


def jax_sp_runs(kind: str, docs: list[bytes]) -> dict:
    """JAX's ShardedSpRunner.run (with its per-row flags) and run_units on
    meshes of each world size."""
    tok = JaxSpTokenizer(jax_load_bytes(testing.DP_MODELS[kind]()),
                         max_doc_symbols=testing.DP_DOC)
    out = {}
    for n in WORLDS:
        r = jax_mesh.ShardedSpRunner(tok, mesh=jax_mesh.data_parallel_mesh(n))
        padded = docs + [b""] * ((-len(docs)) % n)
        x, spm, lengths, _o, _f = tok._prep_batch(padded)
        ids, _st, counts, fb, total, chk = r._step(
            jax.device_put(jnp.asarray(x), r._data_sh),
            jax.device_put(jnp.asarray(spm), r._data_sh),
            jax.device_put(jnp.asarray(lengths), r._vec_sh), jnp.int32(0))
        _ids, _counts, stats = r.run(docs)
        assert (stats.total_tokens, stats.checksum) == (int(total), int(chk))
        units = r.run_units(docs)
        out[n] = dict(ids=np.asarray(ids), counts=np.asarray(counts),
                      fb=np.asarray(fb), stats=stats, units=units)
    return out


@pytest.fixture(scope="module")
def dp_cache(tmp_path_factory):
    """The ranks' model-table cache, shared by a module's world sizes."""
    return str(tmp_path_factory.mktemp("cache"))


def check_sp_world(kind: str, world: int, want: dict, tmp_path,
                   monkeypatch, cache: str) -> None:
    """The port's runners on ``world`` gloo ranks against JAX's mesh of the
    same size: run's rows (the lanes below each count), counts, flags and
    stats; run_units' ids, bounds, need, status and stats on every rank."""
    monkeypatch.setenv("BLINGFIRE_TPU_TORCH_CACHE", cache)
    docs = dp_docs()
    ranks = testing.run_dp_ranks(kind, docs, world, str(tmp_path))
    B = len(docs)
    Bp = B + (-B) % world
    per = Bp // world
    ids = np.concatenate([r["run_ids"] for r in ranks])
    counts = np.concatenate([r["run_counts"] for r in ranks])
    fb = np.concatenate([r["run_fb"] for r in ranks])
    assert [int(r["run_first"]) for r in ranks] == [k * per
                                                   for k in range(world)]
    np.testing.assert_array_equal(counts, want["counts"])
    np.testing.assert_array_equal(fb, want["fb"])
    lane = np.arange(ids.shape[1])[None, :] < counts[:, None]
    np.testing.assert_array_equal(ids[lane], want["ids"][lane])
    assert counts.sum() > 0 and (counts == 0).any()  # rows past the window
    st = want["stats"]
    ju = want["units"]
    for r in ranks:
        assert list(r["run_stats"]) == [st.total_tokens, st.checksum, B]
        for k, name in enumerate(("ids", "bounds", "need", "status")):
            np.testing.assert_array_equal(r[f"units_{name}"], ju[k], name)
        assert list(r["units_stats"]) == [ju[4].total_tokens, ju[4].checksum,
                                          B]
    assert kind == "gpt2" or not want["fb"].any()  # unigram never flags


@functools.lru_cache(maxsize=1)
def _want() -> dict:
    return jax_sp_runs("gpt2", dp_docs())


@pytest.mark.parametrize("world", WORLDS)
def test_gpt2_runners_match_jax(world, tmp_path, monkeypatch, dp_cache):
    check_sp_world("gpt2", world, _want()[world], tmp_path, monkeypatch,
                   dp_cache)
