"""The port's top-level entry points (blingfire_tpu_torch/entry.py, the
counterparts of the root __graft_entry__.py) against the JAX package's on
the CPU: entry.entry() against JAX's bpe_segment on the same rows of the
seeded flagship model, and entry.dryrun_multichip on gloo CPU ranks against
JAX's data-parallel runners over a mesh of host devices.  Ids, totals and
checksums compare exactly.  (Its own file, so that its JAX compiles run on
another xdist worker than tests/test_torch_api.py's.)"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from blingfire_tpu.models.loader import load_bytes as jax_load_bytes
from blingfire_tpu.ops import bpe as jax_bpe
from blingfire_tpu.parallel import mesh as jax_mesh
from blingfire_tpu.runtime.host import SpTokenizer as JaxSpTokenizer
from blingfire_tpu.runtime.wp_hybrid import WordPieceHybrid as JaxHybrid
from blingfire_tpu_torch import entry, testing
from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.runtime.wp_hybrid import WordPieceHybrid
from test_torch_bpe import _one_thread  # noqa: F401  (one intra-op thread)


def test_entry_matches_jax_bpe_segment():
    """entry.entry() on the CPU against JAX's bpe_segment over the same rows
    of the seeded flagship model (50,256 entries), and against the
    flagship's encode_batch."""
    fn, (x, lengths) = entry.entry(device="cpu")
    ids, starts, ends, counts, fb = fn(x, lengths)
    tok = entry._flagship("cpu")
    jtok = JaxSpTokenizer(jax_load_bytes(testing.gpt2_shaped_model_bytes()),
                          max_doc_symbols=128)
    jx, jspm, jln, _o, _f = jtok._prep_batch(entry.ENTRY_DOCS)
    np.testing.assert_array_equal(x.numpy(), jx)
    np.testing.assert_array_equal(lengths.numpy(), jln)
    want = jax_bpe.bpe_segment(jtok.tables, jnp.asarray(jx), jnp.asarray(jspm),
                               jnp.asarray(jln), jnp.int32(0), jtok.a_max)
    counts = counts.numpy()
    np.testing.assert_array_equal(counts, np.asarray(want[3]))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(want[4]))
    lane = np.arange(ids.shape[1])[None, :] < counts[:, None]
    for got, w in zip((ids, starts, ends), want[:3]):
        np.testing.assert_array_equal(got.numpy()[lane], np.asarray(w)[lane])
    assert counts.min() > 0 and not fb.numpy().any()
    assert tok.encode_batch(entry.ENTRY_DOCS) == [
        ids[i, : counts[i]].tolist() for i in range(len(counts))]


@pytest.fixture(scope="module")
def jax_dryrun():
    """JAX's runners over a mesh of two host devices on the documents and
    models of entry.dryrun_multichip(2, ...), the WordPiece slab the
    port's hybrid packs."""
    models = {k: f() for k, f in testing.DP_MODELS.items()}
    docs = [entry.DRYRUN_DOC] * 4
    mesh = jax_mesh.data_parallel_mesh(2)
    want = {}
    for kind, window in entry.DRYRUN_WINDOWS.items():
        jtok = JaxSpTokenizer(jax_load_bytes(models[kind]),
                              max_doc_symbols=window)
        *_rows, st = jax_mesh.ShardedSpRunner(jtok, mesh=mesh).run(docs)
        want[kind] = [st.total_tokens, st.checksum]
    wp = WordPieceHybrid(load_bytes(models["bert"]), device="cpu")
    bx, bi = entry.wp_slab(wp, 4)
    jwp = JaxHybrid(jax_load_bytes(models["bert"]))
    _rows, total, chk = jax_mesh.ShardedWpRunner(jwp, mesh=mesh).run_rows(
        bx, bi, entry.WP_LW)
    want["bert"] = [total, chk]
    return models, want


@pytest.mark.parametrize("world", [1, 2])
def test_dryrun_multichip_on_gloo_ranks(world, jax_dryrun):
    """dryrun_multichip on CPU ranks (one in this process, two spawned)
    against JAX's runners: the totals and checksums of the whole batch of
    2 x world documents; at world 1 half of JAX's two-device batch."""
    models, want = jax_dryrun
    got = entry.dryrun_multichip(world, device="cpu", models=models)
    if world == 2:
        assert got == want
    assert all(got[k][0] * 2 // world == want[k][0] for k in want)
    assert all(v[0] > 0 for v in got.values())
