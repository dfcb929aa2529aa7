"""K10's one launch for every bucket and K12's block partition, on the CPU.

K10 (kernels/csrc/hyph_segment.cu) takes the rows of every bucket of a
``HyphTpu.process_batch`` call in one launch: ``ops/hyph.py::pack_rows``
writes one int32 buffer (a record a segment, then the rows, then the word
lengths) and ``runtime/hyph.py::launch_plan`` cuts the buckets into
launches of at most LAUNCH_BYTES.  On a CPU buffer
``hyph_segment_packed`` runs the plain version segment by segment from the
records, so these tests hold the records, the launch plan and the host
path to per-bucket launches, to JAX's ``HyphTpu.process_batch`` and to the
scalar engine; ``_tiles`` replays the kernel's block-to-segment search.

K12 (kernels/csrc/shard_stats.cu) numbers the (row, t) pairs of a tile by
a scan of the clamped counts and finds a pair's row by a binary search;
``_k12_replay`` does the same in NumPy over the kernel's block partition
and is held to the plain version and to JAX's formula.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hyph import _blob, _jax, _jax_false_hits, _port, _rows, _words

from blingfire_tpu_torch.models.loader import load_bytes
from blingfire_tpu_torch.ops import hyph
from blingfire_tpu_torch.parallel import mesh
from blingfire_tpu_torch.runtime import hyph as hyph_rt
from blingfire_tpu_torch.runtime.hyph import HyphEngine, HyphTpu

SLOT0_WORDS = ("'ab", "'abab", "cab'ab", "ab", "abcd", "cab", "dab", "b'c",
               "xab'", "acd'ab", "")


def _kind_words(kind: str) -> list[list[int]]:
    if kind == "slot0":
        return [[ord(c) for c in w] for w in SLOT0_WORDS]
    return _words()


def _tiles(buf: np.ndarray, n_segs: int, n_tiles: int):
    """[(segment, first row, rows)] of each block of a packed launch, as
    hyph_segment_kernel finds them: the last record whose first tile is at
    most the block, then the block's tile of that segment."""
    rec = buf[: n_segs * hyph.SEG_INTS].reshape(n_segs, hyph.SEG_INTS)
    out = []
    for b in range(n_tiles):
        s = int(np.searchsorted(rec[:, 0], b, side="right")) - 1
        first, rows, _m, T = (int(v) for v in rec[s, :4])
        row0 = (b - first) * T
        out.append((s, row0, min(T, rows - row0)))
    return out


@pytest.mark.parametrize("kind", ["small", "slot0"])
def test_one_launch_matches_bucket_launches_jax_and_engine(kind):
    """process_batch's one packed launch against K10 launched a bucket at a
    time, and against JAX's HyphTpu (the scalar engine on the words where
    JAX's slot clamp false-hits)."""
    p, j = _port(kind), _jax(kind)
    words = _kind_words(kind)
    trace = []
    got = p.process_batch(words, trace=trace)
    st = p.last_stats
    assert set(st.launches.values()) == {1}  # every bucket in one launch
    assert len(trace) == len(st.rows) and (kind == "slot0" or len(trace) >= 4)
    first = {}
    for i, w in enumerate(words):
        first.setdefault(tuple(w), i)
    for bucket, x, wl, ws in trace:
        alone = hyph.hyph_segment(p.tables, torch.from_numpy(x),
                                  torch.from_numpy(wl)).numpy()
        assert x.shape[1] == bucket + 2
        for k, w in enumerate(ws):
            assert got[first[w]] == alone[k, : wl[k]].tolist()
    want = j.process_batch(words)
    uniq = list({tuple(w): None for w in words if len(w) <= 300})
    x, wl = _rows(p, uniq, 300)
    fh = {uniq[r] for r in np.flatnonzero(_jax_false_hits(p.tables, x, wl))}
    assert fh  # the apostrophe words
    eng = HyphEngine(p.model)
    for w, g, jw in zip(words, got, want):
        if tuple(w) in fh:
            assert g == eng.process(w)
        else:
            assert g == jw


@pytest.mark.parametrize("kind", ["small", "ignore_case", "slot0"])
def test_packed_records_hold_the_comb_arrays(kind):
    """K10 walks state_rec {base, final, Moore Ow, 0} and slot_rec {owner,
    nxt}: the same entries as the arrays the plain version reads."""
    t = _port(kind).tables
    S = t.base.numel()
    assert t.state_rec.shape == (S, 4) and t.slot_rec.shape == (t.n_slots, 2)
    assert torch.equal(t.state_rec[:, 0], t.base)
    assert torch.equal(t.state_rec[:, 1], t.final.to(torch.int32))
    assert torch.equal(t.state_rec[:, 2], t.moore_ow)
    assert not t.state_rec[:, 3].any()
    assert torch.equal(t.slot_rec[:, 0], t.owner)
    assert torch.equal(t.slot_rec[:, 1], t.nxt)
    assert t.state_rec.is_contiguous() and t.slot_rec.is_contiguous()


def _segment(p: HyphTpu, words, B: int, width: int):
    """B rows of ``width`` from ``words``, cycled."""
    return _rows(p, [words[i % len(words)] for i in range(B)], width)


@pytest.mark.parametrize("B", [1, 13, 14, 15, 29])
def test_segment_table_at_tile_boundaries(B):
    """B rows at M = 18 (tiles of 14) between segments of M = 34 and 302 and
    an empty one: the records, every row in exactly one tile of its own
    segment, and the packed ops equal the plain version a segment."""
    p = _port("small")
    ws = [w for w in _words() if len(w) <= 16][B:]
    segs = [_segment(p, ws, B, 16), _segment(p, ws, 0, 64),
            _segment(p, ws, 9, 32), _segment(p, ws, 2, 300)]
    buf, pk = hyph.pack_rows(segs)
    assert pk.rows == (B, 0, 9, 2) and pk.widths == (18, 66, 34, 302)
    assert [hyph.tile_rows(m) for m in pk.widths] == [14, 3, 7, 1]
    tiles = [-(-B // 14), 0, 2, 2]
    assert pk.n_tiles == sum(tiles)
    rec = buf[: 4 * hyph.SEG_INTS].reshape(4, hyph.SEG_INTS)
    assert rec[:, 0].tolist() == np.cumsum([0] + tiles[:-1]).tolist()
    assert rec[:, 3].tolist() == [14, 3, 7, 1] and not rec[:, 7].any()
    seen = []
    for s, row0, nr in _tiles(buf, 4, pk.n_tiles):
        assert 0 < nr <= hyph.tile_rows(pk.widths[s])
        seen += [(s, r) for r in range(row0, row0 + nr)]
    assert sorted(seen) == [(s, r) for s, b in enumerate(pk.rows)
                            for r in range(b)]
    out = hyph.hyph_segment_packed(p.tables, torch.from_numpy(buf), pk)
    assert out.shape == (pk.out_len,) and pk.out_len == sum(
        b * (m - 2) for b, m in zip(pk.rows, pk.widths))
    for (x, wl), ops, (_t, b, m, _T, xo, wo, oo, _z) in zip(
            segs, pk.split(out), rec.tolist()):
        assert np.array_equal(buf[xo : xo + b * m].reshape(b, m), x)
        assert np.array_equal(buf[wo : wo + b], wl)
        assert torch.equal(ops, hyph._hyph_segment_plain(
            p.tables, torch.from_numpy(x), torch.from_numpy(wl)))
        assert ops.data_ptr() == out[oo:].data_ptr() or not b


def test_pack_rows_refuses_what_k10_does_not_take():
    p = _port("small")
    x, wl = _rows(p, [[0x61]], 16)
    with pytest.raises(ValueError):
        hyph.pack_rows([])
    with pytest.raises(ValueError):
        hyph.pack_rows([(np.zeros((1, 303), np.int32), wl)])
    with pytest.raises(ValueError):
        hyph.pack_rows([(x, np.zeros(2, np.int32))])
    buf, pk = hyph.pack_rows([(x, wl)])
    with pytest.raises(ValueError):
        hyph.hyph_segment_packed(p.tables, torch.from_numpy(buf[:-1]), pk)


def test_launches_cut_by_launch_bytes(monkeypatch):
    """A LAUNCH_BYTES of a few rows: launches of several segments, each
    within the limit, the same ops, and HyphStats.launches counting the
    launches that held each bucket."""
    words = _words()
    want = _port("small").process_batch(words)
    row = {b: 4 * (2 * b + 3) for b in hyph_rt.BUCKETS}
    limit = 40 * row[16]
    monkeypatch.setattr(hyph_rt, "LAUNCH_BYTES", limit)
    plan = hyph_rt.launch_plan([(16, np.arange(100)), (32, np.arange(5)),
                                (300, np.arange(2))])
    assert [[(b, len(i)) for b, i in launch] for launch in plan] == [
        [(16, 40)], [(16, 40)], [(16, 20), (32, 5)], [(300, 2)]]
    assert all(sum(row[b] * len(i) for b, i in launch) <= limit
               for launch in plan)
    h = HyphTpu(load_bytes(_blob("small"), use_cache=False), device="cpu")
    trace = []
    assert h.process_batch(words, trace=trace) == want
    st = h.last_stats
    assert sum(len(t[1]) for t in trace) == st.unique
    assert st.launches[16] == -(-st.rows[16] // 40) > 1
    assert sum(st.launches.values()) == len(trace)


# ------------------------------------------------------------------- K12

K12_THREADS = 256  # shard_stats.cu's tile of rows
K12_MAX_BLOCKS = 132 * 4  # and its one wave


def _k12_replay(ids: np.ndarray, counts: np.ndarray, max_blocks: int,
                tile: int) -> tuple[int, int]:
    """(total, checksum mod 2^32) as shard_stats_kernel sums them: spans of
    rows a block, tiles of ``tile`` rows, the tile's pairs numbered by an
    exclusive scan of clamp(count, 0, W), a pair's row the last whose scan
    is at most the pair's number."""
    R, W = ids.shape
    blocks = min(R, max_blocks)
    span = -(-R // blocks)
    total, chk = 0, np.uint64(0)
    for b in range(-(-R // span)):
        lo, hi = b * span, min(b * span + span, R)
        for r0 in range(lo, hi, tile):
            c = counts[r0 : min(r0 + tile, hi)].astype(np.int64)
            total += int(c.sum())
            n = np.clip(c, 0, W)
            off = np.cumsum(n) - n
            k = np.arange(int(n.sum()))
            a = np.searchsorted(off, k, side="right") - 1
            t = (k - off[a]).astype(np.uint64)
            w = (t * np.uint64(0x9E3779B9) + np.uint64(1)) & np.uint64(
                0xFFFFFFFF)
            v = ids[r0 + a, t.astype(np.int64)].astype(np.int64).astype(
                np.uint64) & np.uint64(0xFFFFFFFF)
            chk = (chk + ((v * w) & np.uint64(0xFFFFFFFF)).sum()) & np.uint64(
                0xFFFFFFFF)
    return total, int(chk)


def _jax_stats(ids, counts) -> tuple[int, int]:
    """JAX's formula (blingfire_tpu/parallel/mesh.py:97-103)."""
    ids, counts = jnp.asarray(ids), jnp.asarray(counts)
    pos = jnp.arange(ids.shape[1], dtype=jnp.int32)[None, :]
    masked = jnp.where(pos < counts[:, None], ids, 0)
    weights = pos * jnp.int32(-1640531527) + 1
    return int(jnp.sum(counts)), int(jnp.sum(masked * weights,
                                             dtype=jnp.int32))


@pytest.mark.parametrize("layout", ["rows", "wordpiece_slab"])
@pytest.mark.parametrize("R", [1, 31, 32, 33, 9997])
def test_k12_partition_replay_matches_plain_and_jax(R, layout):
    """Ids near 2^20 and negative (the int32 sums wrap), counts of -5,
    above W and 0: the replay over the kernel's partition, and over one of
    many blocks and tiles of 4 rows, equals the plain version and JAX."""
    W = 128
    rng = np.random.default_rng(R)
    ids = rng.integers((1 << 20) - 4096, 1 << 20, (R, W), dtype=np.int32)
    ids[::7, ::5] = rng.integers(-(1 << 31), -1, ids[::7, ::5].shape,
                                 dtype=np.int32)
    counts = rng.integers(0, W + 1, R, dtype=np.int32)
    counts[::3] = 0
    counts[:3] = (-5, W + 3, W)[:R]
    want = _jax_stats(ids, counts)
    if layout == "rows":
        t_ids, t_counts = torch.from_numpy(ids), torch.from_numpy(counts)
    else:
        slab = torch.zeros((R, W + 2), dtype=torch.int32)
        slab[:, :W] = torch.from_numpy(ids)
        slab[:, W] = torch.from_numpy(counts)
        t_ids, t_counts = slab[:, :-2], slab[:, -2]
    acc = torch.zeros(2, dtype=torch.int64)
    mesh.shard_stats(t_ids, t_counts, acc)
    assert mesh.finish_stats(acc) == want
    for max_blocks, tile in ((K12_MAX_BLOCKS, K12_THREADS), (3, 4)):
        assert mesh.finish_stats(torch.tensor(_k12_replay(
            t_ids.numpy(), t_counts.numpy(), max_blocks, tile))) == want
    if R > 3:
        assert want[1] != int(np.sum(ids[:, :1]))  # the sums wrapped
