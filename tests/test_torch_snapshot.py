"""The port's store snapshots on the CPU (T=480, W=24, L=10, N=300).

Within the port: ``open(save(store))`` is bitwise the store (raw rows,
representation, index arrays, answers) and keeps accepting inserts like
the original; the LATEST pointer, GC and a two-host layout work;
corrupt arrays, drifted breakpoint tables and format 1 are refused.
Across the packages: both compute the same content hash, a store the
JAX package saved (index included) opens in the port with the index
arrays as saved and answers like the reference, and a store the port
saved opens in the JAX package, passing its hash and breakpoint
checks."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    MatchEngine, OneDSAX, from_reference, make_technique)
from repro_torch.data.synthetic import season_dataset  # noqa: E402
from repro_torch.store import (  # noqa: E402
    CorpusEpoch, SymbolicStore, epoch_rows, rep_leaves)
from repro_torch.store.snapshot import (  # noqa: E402
    _content_hash, latest_snap)

T, W, L, N, NQ = 480, 24, 10, 300, 4
TECHS = ("sax", "ssax", "tsax", "stsax")


@pytest.fixture(scope="module")
def season():
    X = season_dataset(N + NQ, T, L, 0.7, per_series_strength=True,
                       seed=21)
    return X[:NQ], X[NQ:]


def _enc(tech):
    return make_technique(tech, T=T, W=W, L=L)


def _open(path):
    return SymbolicStore.open(str(path), device="cpu")


def _answers(store, Q, k=5, source="index"):
    return MatchEngine(store.encoder, store, verify="numpy",
                       device="cpu").topk(Q, k=k, source=source)


def _assert_same_store(a, b):
    """Same rows, representation, encoder and cost model (``a`` and
    ``b`` may come from different packages)."""
    assert a.n == b.n
    assert type(a.encoder).__name__ == type(b.encoder).__name__
    assert dataclasses.asdict(a.encoder) == dataclasses.asdict(b.encoder)
    assert (a.media, a.seek_s, a.read_bps) == (b.media, b.seek_s,
                                               b.read_bps)
    np.testing.assert_array_equal(a.data, b.data)
    for x, y in zip(rep_leaves(a.rep_view()), rep_leaves(b.rep_view())):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _assert_same_index(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    ma, xa = a.to_snapshot()
    mb, xb = b.to_snapshot()
    assert ma == mb and sorted(xa) == sorted(xb)
    for key in xa:
        np.testing.assert_array_equal(xa[key], xb[key], err_msg=key)


@pytest.mark.parametrize("tech", TECHS)
def test_roundtrip_bitwise(tmp_path, season, tech):
    Q, D = season
    store = SymbolicStore(_enc(tech), media="hdd", device="cpu")
    store.append(D[:90])
    store.build_index(leaf_fill=16, max_bits=5)
    store.append(D[90:])
    path = store.save(str(tmp_path))
    assert os.path.basename(path) == "snap_00000001"
    back = _open(tmp_path)
    _assert_same_store(back, store)
    _assert_same_index(back.index, store.index)
    assert back.version == store.version
    r0, r1 = _answers(store, Q), _answers(back, Q)
    np.testing.assert_array_equal(r0.indices, r1.indices)
    np.testing.assert_array_equal(r0.distances, r1.distances)
    np.testing.assert_array_equal(r0.raw_accesses, r1.raw_accesses)
    # the reopened store and index keep inserting like the original
    store.append(Q)
    back.append(Q)
    assert back.n == store.n == N + NQ
    _assert_same_index(back.index, store.index)


@pytest.mark.parametrize("cut", [1, 77, N - 1])
def test_save_open_topk_reproduces_exactly(tmp_path, season, cut):
    Q, D = season
    store = SymbolicStore(_enc("ssax"), device="cpu")
    store.append(D[:cut])
    store.append(D[cut:])
    store.save(str(tmp_path))
    back = _open(tmp_path)
    for k in (1, 8):
        r0, r1 = (_answers(s, Q, k=k, source=None) for s in (store, back))
        np.testing.assert_array_equal(r0.indices, r1.indices)
        np.testing.assert_array_equal(r0.distances, r1.distances)
        np.testing.assert_array_equal(r0.raw_accesses, r1.raw_accesses)


def test_two_host_layout_roundtrip(tmp_path, season):
    Q, D = season
    store = SymbolicStore.from_rows(_enc("ssax"), D, media="hdd",
                                    device="cpu")
    store.build_index(leaf_fill=16, max_bits=5)
    path = store.save(str(tmp_path), n_hosts=2)
    shards = sorted(f for f in os.listdir(path) if f.startswith("shard_"))
    assert shards == ["shard_h000.npz", "shard_h001.npz"]
    with np.load(os.path.join(path, "shard_h000.npz")) as z0, \
            np.load(os.path.join(path, "shard_h001.npz")) as z1:
        assert z0["raw"].shape[0] + z1["raw"].shape[0] == N
        assert "bp_b_seas" in z0.files and "bp_b_seas" not in z1.files
    back = _open(tmp_path)
    _assert_same_store(back, store)
    _assert_same_index(back.index, store.index)


def test_latest_pointer_and_gc(tmp_path, season):
    _, D = season
    store = SymbolicStore.from_rows(_enc("sax"), D, device="cpu")
    for _ in range(4):                       # keep=3: the oldest goes
        store.append(D[:1])
        store.save(str(tmp_path))
    snaps = sorted(p.name for p in tmp_path.iterdir()
                   if p.name.startswith("snap_"))
    assert snaps == [f"snap_{i:08d}" for i in (2, 3, 4)]
    assert (tmp_path / "LATEST").read_text() == snaps[-1]
    assert latest_snap(str(tmp_path)) == 4
    assert _open(tmp_path).n == store.n
    assert SymbolicStore.open(str(tmp_path), snap=3, device="cpu").n == \
        store.n - 1
    with pytest.raises(FileNotFoundError):
        _open(tmp_path / "empty")


def test_open_rejects_corruption_drift_and_format_1(tmp_path, season):
    _, D = season
    store = SymbolicStore.from_rows(_enc("ssax"), D, device="cpu")
    path = store.save(str(tmp_path))
    shard = os.path.join(path, "shard_h000.npz")
    arrays = dict(np.load(shard))
    arrays["bp_b_res"] = arrays["bp_b_res"] + 0.25
    np.savez(shard, **arrays)
    with pytest.raises(ValueError, match="hash mismatch"):
        _open(tmp_path)
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["hash"] = _content_hash(arrays)      # hash intact, tables not
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(ValueError, match="drifted"):
        _open(tmp_path)
    manifest["format"] = 1
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(ValueError, match="format"):
        _open(tmp_path)


def test_append_keeps_index_up_to_date(season):
    Q, D = season
    store = SymbolicStore.from_rows(_enc("ssax"), D[:-2], device="cpu")
    idx = store.build_index(max_bits=4, leaf_fill=32)
    assert store.current_epoch() == CorpusEpoch(epoch=1, n_rows=N - 2,
                                                index_n=N - 2)
    store.append(D[-2:])
    assert store.index is idx and idx.n == store.n == N
    ep = store.current_epoch()
    assert (ep.n_rows, ep.index_n, ep.epoch) == (N, N, store.version)
    assert epoch_rows(ep) == N and epoch_rows(5) == 5
    assert epoch_rows(None) is None
    eng = MatchEngine(store.encoder, store, verify="numpy", device="cpu")
    r_idx, r_lin = eng.topk(Q, k=3, source="index"), eng.topk(Q, k=3)
    np.testing.assert_array_equal(r_idx.indices, r_lin.indices)
    np.testing.assert_array_equal(r_idx.distances, r_lin.distances)
    # an appended row is indexed and found
    got = eng.topk(D[-1:], k=1, source="index")
    assert got.indices[0, 0] == N - 1 and got.distances[0, 0] == 0.0
    # a legacy index built from precomputed features cannot insert raw
    # rows: an append drops it instead of serving stale coverage
    from repro_torch.core.index import SSaxIndex
    feats = store.index.tree.feats
    store.index = SSaxIndex(feats[:, :L], feats[:, L:], T=T,
                            sd_seas=store.encoder.sd_seas,
                            sd_res=store.encoder.sd_res)
    store.append(Q[:1])
    assert store.index is None


def test_engine_append_serves_new_rows_at_once(season):
    Q, D = season
    store = SymbolicStore.from_rows(_enc("tsax"), D[:100], device="cpu")
    store.build_index(leaf_fill=16)
    eng = MatchEngine(store.encoder, store, verify="numpy", device="cpu")
    ids = eng.append(D[100:103])
    np.testing.assert_array_equal(ids, [100, 101, 102])
    res = eng.topk(D[101:102], k=1, source="index")
    assert res.indices[0, 0] == 101
    from repro_torch.core.matching import RawStore
    static = MatchEngine(store.encoder, RawStore.ssd(D), device="cpu")
    with pytest.raises(TypeError, match="SymbolicStore"):
        static.append(D[:1])


# -- across the packages -------------------------------------------------------

def test_content_hash_equals_reference():
    from repro.store.snapshot import _content_hash as ref_hash
    rng = np.random.default_rng(0)
    arrays = {"raw": rng.normal(size=(7, 5)).astype(np.float32),
              "rep_0": rng.integers(0, 9, (7, 3)).astype(np.int32),
              "index/leaf_ids": np.arange(7, dtype=np.int64)}
    assert _content_hash(arrays) == ref_hash(arrays)


def _ref_encoder(tech):
    from repro.core import make_technique as ref_make
    return ref_make(tech, T=T, W=W, L=L)


@pytest.mark.parametrize("tech", ["ssax", "stsax"])
def test_reference_snapshot_opens_in_port(tmp_path, season, tech):
    from repro.core import MatchEngine as RefEngine
    from repro.store import SymbolicStore as RefStore
    Q, D = season
    renc = _ref_encoder(tech)
    ref = RefStore(renc, media="hdd")
    ref.append(D[:100])
    ref.build_index(leaf_fill=16, max_bits=5)
    ref.append(D[100:])
    ref.save(str(tmp_path))
    want = RefEngine(renc, ref, verify="numpy").topk(Q, k=5,
                                                     source="index")

    back = _open(tmp_path)
    assert back.encoder == from_reference(type(renc).__name__,
                                          dataclasses.asdict(renc))
    _assert_same_store(back, ref)
    _assert_same_index(back.index, ref.index)
    got = _answers(back, Q)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)
    # the reopened index keeps inserting as the reference's does
    ref.append(Q)
    back.append(Q)
    assert back.index.tree.leaf_membership() == \
        ref.index.tree.leaf_membership()


@pytest.mark.parametrize("tech", ["sax", "tsax"])
def test_port_snapshot_opens_in_reference(tmp_path, season, tech):
    from repro.core import MatchEngine as RefEngine
    from repro.store import SymbolicStore as RefStore
    Q, D = season
    store = SymbolicStore.from_rows(_enc(tech), D, media="ssd",
                                    device="cpu")
    store.build_index(leaf_fill=16, max_bits=5)
    store.save(str(tmp_path))
    ref = RefStore.open(str(tmp_path))           # hash + breakpoint checks
    assert dataclasses.asdict(ref.encoder) == \
        dataclasses.asdict(store.encoder)
    _assert_same_store(ref, store)
    _assert_same_index(ref.index, store.index)
    want = RefEngine(ref.encoder, ref, verify="numpy").topk(
        Q, k=5, source="index")
    got = _answers(store, Q)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)


def test_onedsax_roundtrips_without_index(tmp_path, season):
    Q, D = season
    enc = OneDSAX(T=T, W=W, A_a=16, A_s=16)
    store = SymbolicStore.from_rows(enc, D, device="cpu")
    store.save(str(tmp_path))
    back = _open(tmp_path)
    _assert_same_store(back, store)
    assert back.index is None
