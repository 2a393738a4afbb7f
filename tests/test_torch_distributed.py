"""The port's sharded engine (``repro_torch.core.distributed``) on the
CPU: S virtual shards of one device (S in 1, 2, 4) at T = 240 and
N <= 200, held against the port's unsharded engine bitwise and against
the JAX package's ``make_engine_service`` on a one-device mesh.

Within the port, bitwise: the device-ordered stream visits candidates in
numpy's stable-argsort order; device verification equals host
verification (store fetch, then the same K1) and the unsharded engine,
for every encoder, with a ragged tail, whole series and windows; a
sharded encode, feature map and index build equal the unsharded ones.
Against the reference: exact ids are equal and distances agree within
rtol 1e-5 (the frameworks' encoders differ in the last bits), the f32
round-down of ``host_order_stream`` gives the same bounds, and the
``match.*`` / ``subseq.*`` transfer metric names are the same."""

import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MatchEngine, make_technique  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DeviceOrderedStream, RoundRobinMirror, ShardMesh, _data_axes,
    encode_sharded, host_order_stream, make_engine_service,
    make_matching_service, make_mesh, repr_distances_sharded,
    repr_topk_sharded, rowwise_sharded)
from repro_torch.core.normalize import znormalize  # noqa: E402
from repro_torch.data.synthetic import season_dataset  # noqa: E402
from repro_torch.index.features import adapter_for  # noqa: E402
from repro_torch.obs import MetricsRegistry, check_trace  # noqa: E402
from repro_torch.store import SymbolicStore  # noqa: E402
from repro_torch.subseq import (  # noqa: E402
    SubseqEngine, WindowView, znorm_windows)

T, L, NQ = 240, 10, 3
TECHS = ("sax", "ssax", "tsax", "stsax")
SHARDS = (1, 2, 4)
TECH_KW = {"sax": {}, "ssax": dict(r2_season=0.7), "tsax": {},
           "stsax": dict(r2_season=0.5)}


def _enc(tech, t=T):
    return make_technique(tech, T=t, W=t // 20, L=L, **TECH_KW[tech])


def _mesh(s):
    return make_mesh(s, device="cpu")


@pytest.fixture(scope="module")
def season():
    X = season_dataset(n=NQ + 199, T=T, L=L, strength=0.7,
                       per_series_strength=True, seed=11)
    return X[:NQ], X[NQ:]            # 199 rows: ragged at S = 2 and 4


def _same(a, b):
    return (np.array_equal(a.indices, b.indices)
            and np.array_equal(a.distances, b.distances))


# ---------------------------------------------------------------------------
# the mesh, the stream and the mirror
# ---------------------------------------------------------------------------

def test_make_mesh_shapes_and_default_device():
    mesh = make_mesh(4, device="cpu")
    assert isinstance(mesh, ShardMesh)
    assert mesh.shape == {"data": 4} and mesh.n_shards == 4
    assert mesh.device.type == "cpu" and _data_axes(mesh) == ("data",)
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    if torch.cuda.is_available():
        assert make_mesh(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2)


def _bounds_with_ties(seed):
    """(5, 300) bounds: quantized values (many ties), zeros, +inf
    stretches, one all-inf row and one all-finite row."""
    rng = np.random.default_rng(seed)
    b = (rng.integers(0, 7, size=(5, 300)) / 4.0).astype(np.float32)
    b[0, rng.random(300) < 0.3] = np.inf
    b[1] = np.inf
    b[2, :40] = 0.0
    b[3, ::3] = np.inf
    return b


def _drain(stream, q_n, batch):
    """Every (bound, id) the stream hands out, per query, in order."""
    got = [[] for _ in range(q_n)]
    while True:
        nxt = stream.peek()
        aq = np.nonzero(np.isfinite(nxt))[0]
        if not aq.size:
            return got
        ids = stream.take(aq, batch)
        for r, qi in enumerate(aq):
            got[qi].extend(int(i) for i in ids[r] if i >= 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_order_equals_numpy_stable_argsort(seed):
    from repro_torch.core.distributed import _order_stream
    b = _bounds_with_ties(seed)
    stream = _order_stream(torch.from_numpy(b), width=b.shape[1])
    np.testing.assert_array_equal(stream.n_finite, np.isfinite(b).sum(1))
    got = _drain(stream, b.shape[0], batch=7)
    for qi in range(b.shape[0]):
        order = np.argsort(b[qi], kind="stable")
        want = order[np.isfinite(b[qi, order])]
        assert got[qi] == want.tolist(), qi


def test_stream_peek_take_exhaustion():
    from repro_torch.core.distributed import _order_stream
    b = np.array([[3.0, 1.0, 2.0], [np.inf, 5.0, np.inf]], np.float32)
    s = _order_stream(torch.from_numpy(b), width=3)
    np.testing.assert_array_equal(s.peek(), [1.0, 5.0])
    np.testing.assert_array_equal(s.take([0, 1], 2), [[1, 2], [1, -1]])
    # query 1 is exhausted; a fully finite row clipped at C stays
    # exhausted too (the guard in peek)
    np.testing.assert_array_equal(s.peek(), [3.0, np.inf])
    np.testing.assert_array_equal(s.take([0], 4), [[0, -1, -1, -1]])
    assert np.isinf(s.peek()).all()
    np.testing.assert_array_equal(s.take([0, 1], 2), [[-1, -1], [-1, -1]])
    empty = DeviceOrderedStream.empty(2)
    assert np.isinf(empty.peek()).all() and empty.width == 0
    np.testing.assert_array_equal(empty.take([1], 3), [[-1, -1, -1]])


def test_host_order_stream_rounds_down_like_the_reference():
    rng = np.random.default_rng(3)
    b = rng.random((4, 64)) * 10.0              # f64, most not f32-exact
    b[1, 5:9] = np.inf
    ids = np.sort(rng.choice(1000, 64, replace=False))
    s = host_order_stream(b, ids, device="cpu")
    sb = s._b.numpy()
    order = np.argsort(b, axis=1, kind="stable")
    # every sorted bound is at or below its f64 bound
    fin = np.isfinite(sb)
    assert (sb[fin].astype(np.float64)
            <= np.take_along_axis(b, order, 1)[fin]).all()
    np.testing.assert_array_equal(s._i.numpy()[:, 0], ids[order[:, 0]])
    with pytest.raises(ValueError):
        host_order_stream(b, ids[::-1], device="cpu")
    pytest.importorskip("jax")
    from repro.core.distributed import host_order_stream as ref_stream
    ref = ref_stream(b, ids)
    np.testing.assert_array_equal(np.asarray(ref._b), sb)
    np.testing.assert_array_equal(np.asarray(ref._i), s._i.numpy())


@pytest.mark.parametrize("S", SHARDS)
def test_mirror_layout_growth_and_h2d(S):
    mesh = _mesh(S)
    mir = RoundRobinMirror(mesh)
    rows = np.arange(40 * S * 3, dtype=np.float32).reshape(-1, 3)
    mir.append(rows[:4 * S])
    assert (mir.per_live, mir.cap, mir.h2d_bytes) == (4, 4, rows[:4 * S].nbytes)
    mir.append(rows[4 * S:5 * S])                  # grows: 4 -> 8 slots
    assert (mir.per_live, mir.cap) == (5, 8)
    assert mir.h2d_bytes == rows[:5 * S].nbytes    # exactly the uploads
    for i in range(5 * S):
        np.testing.assert_array_equal(mir.buf[i % S, i // S].numpy(),
                                      rows[i])
        np.testing.assert_array_equal(
            mir.flat()[(i % S) * mir.cap + i // S].numpy(), rows[i])
    if S > 1:
        with pytest.raises(ValueError, match="multiple"):
            mir.append(rows[:S + 1])
        tail = rows[5 * S:5 * S + S - 1]
        mir.stage_tail(tail)
        assert mir.n_rows == 5 * S + S - 1 and mir.per_live == 5
        assert mir.tail_h2d_bytes == tail.nbytes
        assert mir.h2d_bytes == rows[:5 * S].nbytes
        dead = mir.dead_mask().numpy()
        assert not dead[:S - 1, 5].any() and dead[S - 1, 5]
        with pytest.raises(ValueError):
            mir.stage_tail(rows[:S])
    mir.append(rows[5 * S:30 * S])                 # 25 more slots: 16 -> 30
    assert (mir.per_live, mir.cap, mir.n_tail) == (30, 30, 0)
    for i in range(30 * S):
        np.testing.assert_array_equal(mir.buf[i % S, i // S].numpy(),
                                      rows[i])


# ---------------------------------------------------------------------------
# sharded maps and sweeps over contiguous shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tech", TECHS)
def test_sharded_maps_are_bitwise_the_unsharded(season, tech):
    Q, D = season
    enc = _enc(tech)
    x = torch.from_numpy(D)
    one = enc.encode(x)
    rq = enc.encode(torch.from_numpy(Q))
    want = enc.pairwise_distance(rq, one)
    adapter = adapter_for(enc, "cpu")
    for S in SHARDS:
        mesh = _mesh(S)
        rep = encode_sharded(enc, D, mesh)
        for a, b in zip(rep if isinstance(rep, tuple) else (rep,),
                        one if isinstance(one, tuple) else (one,)):
            assert torch.equal(a, b), (tech, S)
        assert torch.equal(repr_distances_sharded(enc, rq, one, mesh), want)
        np.testing.assert_array_equal(adapter.features_sharded(D, mesh),
                                      adapter.features(D))
        d, i = repr_topk_sharded(enc, rq, one, mesh, k=9)
        order = torch.sort(want, dim=1, stable=True)
        assert torch.equal(d, order.values[:, :9])
        assert torch.equal(i, order.indices[:, :9]), (tech, S)
    rep, query_fn = make_matching_service(enc, D, _mesh(4), k=5)
    d, i = query_fn(Q)
    assert torch.equal(i, torch.sort(want, dim=1, stable=True).indices[:, :5])


def test_rowwise_sharded_keeps_structure(season):
    _, D = season
    enc = _enc("ssax")
    adapter = adapter_for(enc, "cpu")
    want = adapter._device_features(D[:7])
    got = rowwise_sharded(adapter, "_device_features", D[:7], _mesh(4))
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    empty = rowwise_sharded(adapter, "_device_features", D[:0], _mesh(4))
    assert [e.shape[0] for e in empty] == [0, 0]


# ---------------------------------------------------------------------------
# whole series: device == host == unsharded, and the reference's ids
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(season):
    """The JAX package's ``make_engine_service`` answers on a one-device
    mesh, computed once per technique."""
    pytest.importorskip("jax")
    from repro.core import make_technique as ref_make
    from repro.core.distributed import make_engine_service as ref_service
    from repro.launch.mesh import make_mesh_compat
    Q, D = season
    mesh = make_mesh_compat((1,), ("data",))
    cache = {}

    def get(tech):
        if tech not in cache:
            enc = ref_make(tech, T=T, W=T // 20, L=L, **TECH_KW[tech])
            eng = ref_service(enc, D, mesh, verify="numpy", batch_size=16)
            cache[tech] = eng.topk(Q, k=5)
        return cache[tech]
    return get


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("tech", TECHS)
def test_device_equals_host_all_encoders_shards(season, reference, tech, S):
    Q, D = season
    enc = _enc(tech)
    store = SymbolicStore.from_rows(enc, D, device="cpu")
    plain = MatchEngine(enc, store, verify="kernel", batch_size=16,
                        device="cpu").topk(Q, k=5)
    res = {}
    for verify in ("device", "host"):
        eng = make_engine_service(enc, None, _mesh(S), store=store,
                                  verify=verify, batch_size=16)
        res[verify] = r = eng.topk(Q, k=5)
        assert _same(r, plain), (tech, S, verify)
        assert r.rounds == plain.rounds
        np.testing.assert_array_equal(r.raw_accesses, plain.raw_accesses)
    dev, host = res["device"], res["host"]
    assert dev.store_accesses == dev.store_fetches == 0
    assert dev.io_seconds == 0.0 and host.store_accesses > 0
    sweep = eng.sweep
    head = (D.shape[0] // S) * S
    assert sweep._head == head and sweep.mirror_layout == "round_robin"
    from repro_torch.store.snapshot import _shard_ranges
    assert sweep.shard_ranges() == _shard_ranges(head, S)
    for s in range(S):
        np.testing.assert_array_equal(sweep.owned_rows(s),
                                      np.arange(s, head, S))
    ref = reference(tech)
    np.testing.assert_array_equal(dev.indices, np.asarray(ref.indices))
    np.testing.assert_allclose(dev.distances, np.asarray(ref.distances),
                               rtol=1e-5)


def test_device_route_approx_indexed_and_trace(season):
    Q, D = season
    enc = _enc("ssax")
    store = SymbolicStore.from_rows(enc, D, device="cpu")
    dev = make_engine_service(enc, None, _mesh(4), store=store,
                              verify="device", batch_size=16)
    host = MatchEngine(enc, store, verify="host", batch_size=16,
                       device="cpu")
    a_d, a_h = dev.topk(Q, k=5, exact=False), host.topk(Q, k=5, exact=False)
    assert _same(a_d, a_h) and a_d.store_accesses == 0
    store.build_index(leaf_fill=16)
    i_d = dev.topk(Q, k=5, source="index", explain=True)
    assert _same(i_d, host.topk(Q, k=5, source="index"))
    assert _same(i_d, host.topk(Q, k=5)) and i_d.store_accesses == 0
    assert not check_trace(i_d.trace, device=True)
    lin = dev.topk(Q, k=5, explain=True)
    assert not check_trace(lin.trace, device=True)
    assert lin.trace.get("host_order_bytes") == 0
    # the matrix path counts every byte it brings to the host
    before = dev.sweep.host_order_bytes
    rd = dev.sweep.repr_distances(Q)
    assert dev.sweep.host_order_bytes - before == rd.nbytes == 3 * 199 * 4
    with pytest.raises(ValueError, match="mirror_raw"):
        make_engine_service(enc, None, _mesh(2), store=store).sweep \
            .make_dist_fn(Q)


def test_ingest_encodes_each_row_once(season):
    """Ragged ingests run the sharded chunk encode once per ingest; the
    stored representation is bitwise a one-shot encode; each sync uploads
    only the new head-aligned rows."""
    Q, D = season
    enc = _enc("stsax")
    dev = make_engine_service(enc, None, _mesh(4), batch_size=16,
                              verify="device")
    calls = []
    orig = dev.sweep._encode_chunk
    dev.sweep._encode_chunk = \
        lambda rows: (calls.append(rows.shape[0]), orig(rows))[1]
    host = MatchEngine(enc, dev.store, verify="host", batch_size=16,
                       device="cpu")
    h2d = []
    for lo, hi in ((0, 23), (23, 44), (44, 47)):
        before = dev.sweep.h2d_bytes
        dev.ingest(D[lo:hi])
        r = dev.topk(Q, k=3)
        dev.topk(Q, k=3, exact=False)
        h2d.append(dev.sweep.h2d_bytes - before)
        assert _same(r, host.topk(Q, k=3)) and r.store_accesses == 0
    assert calls == [23, 21, 3], calls
    # head-aligned rows only: 20, then 24, then none (the tail of 3 at
    # 47 rows is staged, counted apart)
    leaf_bytes = sum(l.itemsize * int(np.prod(l.shape[1:]))
                     for l in dev.store.rep_view()) + 4 * T
    assert h2d == [20 * leaf_bytes, 24 * leaf_bytes, 0], h2d
    assert dev.sweep.tail_h2d_bytes > 0
    one = enc.encode(torch.from_numpy(D[:47]))
    for got, want in zip(dev.store.rep_view(), one):
        np.testing.assert_array_equal(got, want.numpy())


def test_snapshot_contiguous_save_opens_into_round_robin_mirrors(season):
    Q, D = season
    enc = _enc("ssax")
    with tempfile.TemporaryDirectory() as d:
        SymbolicStore.from_rows(enc, D[:39], device="cpu").save(d, n_hosts=2)
        store = SymbolicStore.open(d, device="cpu")
    want = MatchEngine(enc, store, verify="host", batch_size=16,
                       device="cpu").topk(Q, k=5)
    for S in (2, 4):
        dev = make_engine_service(enc, None, _mesh(S), store=store,
                                  verify="device", batch_size=16)
        assert dev.sweep.mirror_layout == "round_robin"
        r = dev.topk(Q, k=5)
        assert _same(r, want) and r.store_accesses == 0


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_index_build_is_bitwise_the_host_build(season, S):
    _, D = season
    enc = _enc("ssax")
    host = SymbolicStore.from_rows(enc, D, device="cpu")
    host.build_index(leaf_fill=16)
    sharded = SymbolicStore.from_rows(enc, D, device="cpu")
    sharded.build_index(leaf_fill=16, mesh=_mesh(S))
    (ma, xa), (mb, xb) = host.index.to_snapshot(), sharded.index.to_snapshot()
    assert ma == mb and xa.keys() == xb.keys()
    for k in xa:
        np.testing.assert_array_equal(xa[k], xb[k])


@pytest.mark.parametrize("source", ["linear", "index"])
@pytest.mark.parametrize("tech", ["ssax", "sax"])
def test_epoch_pinned_device_route_equals_frozen_store(season, tech, source):
    Q, D = season
    enc = _enc(tech)
    n0 = 40
    dev = make_engine_service(enc, D[:n0], _mesh(4), verify="device",
                              batch_size=16)
    if source == "index":
        dev.store.build_index(leaf_fill=16)
    src = "index" if source == "index" else None
    pins = [dev.store.current_epoch()]
    for lo, hi in ((n0, n0 + 7), (n0 + 7, n0 + 24)):
        dev.ingest(D[lo:hi])
        pins.append(dev.store.current_epoch())
    for ep in pins:
        got = dev.topk(Q, k=3, source=src, epoch=ep)
        frozen = make_engine_service(enc, D[:ep.n_rows], _mesh(4),
                                     verify="device", batch_size=16)
        if source == "index":
            frozen.store.build_index(leaf_fill=16)
        want = frozen.topk(Q, k=3, source=src)
        assert _same(got, want), (tech, source, ep.n_rows)
        assert got.indices.max() < ep.n_rows and got.store_accesses == 0


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

M = 120
WIN_FIELDS = {"sax": dict(W=12), "ssax": dict(W=12, L=10, r2_season=0.5),
              "tsax": dict(W=12), "stsax": dict(W=12, L=10, r2_season=0.4)}


@pytest.fixture(scope="module")
def windows():
    # T ragged against the strides; 10 rows: a tail of 2 at S = 4
    X = season_dataset(n=10, T=610, L=10, strength=0.7, seed=5)
    rng = np.random.default_rng(0)
    Q = np.stack([X[0, 37:37 + M],
                  X[3, 250:250 + M] + 0.1 * rng.normal(size=M)
                  .astype(np.float32),
                  rng.normal(size=M).astype(np.float32)])
    return X, Q


@pytest.fixture(scope="module")
def window_reference(windows):
    """The JAX package's window answers (verify="numpy"), computed once
    per (technique, stride, exclusion)."""
    pytest.importorskip("jax")
    from repro.core import make_technique as ref_make
    from repro.subseq import SubseqEngine as RefEngine
    from repro.subseq import WindowView as RefView
    X, Q = windows
    cache = {}

    def get(tech, stride, excl):
        if (tech, stride, excl) not in cache:
            view = RefView(ref_make(tech, T=M, **WIN_FIELDS[tech]), X,
                           stride=stride)
            cache[tech, stride, excl] = RefEngine(
                view, verify="numpy").topk(Q, k=5, exclusion=excl)
        return cache[tech, stride, excl]
    return get


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("excl", [0, 60])
@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("tech", TECHS)
def test_window_device_verification_equals_host(windows, window_reference,
                                                tech, stride, excl, S):
    """Device window verification equals the host route bitwise (10 rows:
    a tail of 2 at S = 4, 0 at S = 2); window ids equal the reference's
    and distances agree within rtol 1e-5."""
    X, Q = windows
    enc = make_technique(tech, T=M, **WIN_FIELDS[tech])
    view = WindowView(enc, X, stride=stride, device="cpu")
    host = SubseqEngine(view, verify="host")
    dev = SubseqEngine(view, verify="device", mesh=_mesh(S),
                       metrics=MetricsRegistry())
    want = host.topk(Q, k=5, exclusion=excl)
    rows0 = view.accesses
    got = dev.topk(Q, k=5, exclusion=excl, explain=True)
    assert view.accesses == rows0 and got.store_accesses == 0
    np.testing.assert_array_equal(got.window_ids, want.window_ids)
    np.testing.assert_array_equal(got.distances, want.distances)
    assert got.rounds == want.rounds
    assert got.trace.get("rows_to_host") == 0
    if not excl:
        assert not check_trace(got.trace, device=True)
    assert dev.metrics.counter("subseq.rows_to_host").value == 0
    ref = window_reference(tech, stride, excl)
    np.testing.assert_array_equal(got.window_ids, np.asarray(ref.window_ids))
    np.testing.assert_allclose(got.distances, np.asarray(ref.distances),
                               rtol=1e-5)


def test_window_device_route_tail_append_and_index(windows):
    """Rows appended past the head (a staged tail) are verified on the
    device too, on the linear and the indexed path, at S = 2 and 4."""
    X, Q = windows
    enc = make_technique("ssax", T=M, **WIN_FIELDS["ssax"])
    for S in (2, 4):
        view = WindowView(enc, X[:7], stride=4, device="cpu")
        host = SubseqEngine(view, verify="host")
        dev = SubseqEngine(view, verify="device", mesh=_mesh(S))
        dev.topk(Q, k=3)
        view.append(X[7:10])
        q2 = np.concatenate([Q, X[8:9, 100:100 + M]])
        for use_index in (False, True):
            if use_index:
                view.build_index(leaf_fill=16)
            got = dev.topk(q2, k=3, use_index=use_index)
            want = host.topk(q2, k=3, use_index=use_index)
            np.testing.assert_array_equal(got.window_ids, want.window_ids)
            np.testing.assert_array_equal(got.distances, want.distances)
            assert got.rows[-1, 0] == 8 and got.store_accesses == 0
        approx = dev.topk_approx(q2, k=3, collect=view.n)
        np.testing.assert_array_equal(approx.window_ids, want.window_ids)


def test_window_znorm_is_batch_invariant_and_shared():
    """The fixed-order z-normalization gives a window the same bits in
    any batch, shape or axis, and ``znorm_windows`` is it."""
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(97, 240)) * 3 + 5).astype(np.float32)
    full = znormalize(torch.from_numpy(w))
    for lo, hi in ((0, 1), (5, 38), (38, 97)):
        assert torch.equal(znormalize(torch.from_numpy(w[lo:hi])),
                           full[lo:hi])
    assert torch.equal(znormalize(torch.from_numpy(w).reshape(97, 1, 240))
                       .reshape(97, 240), full)
    assert torch.equal(znormalize(torch.from_numpy(w.T.copy()), axis=0).T,
                       full)
    np.testing.assert_array_equal(znorm_windows(w), full.numpy())
    mu = w.astype(np.float64).mean(1, keepdims=True)
    sd = w.astype(np.float64).std(1, keepdims=True)
    np.testing.assert_allclose(full.numpy(), (w - mu) / sd, rtol=0,
                               atol=2e-6)
    flat = np.full((1, 240), 3.0, np.float32)
    assert np.isfinite(znorm_windows(flat)).all()


def test_subseq_device_verify_needs_a_mesh(windows):
    X, _ = windows
    view = WindowView(make_technique("sax", T=M, W=12), X, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        SubseqEngine(view, verify="device")


# ---------------------------------------------------------------------------
# metric names against the reference, and the launcher
# ---------------------------------------------------------------------------

def test_transfer_metric_names_equal_the_reference(season, windows):
    pytest.importorskip("jax")
    from repro.core import make_technique as ref_make
    from repro.core.distributed import make_engine_service as ref_service
    from repro.launch.mesh import make_mesh_compat
    from repro.obs import MetricsRegistry as RefRegistry
    from repro.subseq import SubseqEngine as RefSubseq
    from repro.subseq import WindowView as RefView
    Q, D = season
    X, QW = windows

    def names(reg):
        return sorted(reg.snapshot()["counters"])

    mine, theirs = MetricsRegistry(), RefRegistry()
    make_engine_service(_enc("sax"), D[:40], _mesh(2), verify="device",
                        metrics=mine).topk(Q[:1], k=1)
    ref_mesh = make_mesh_compat((1,), ("data",))
    ref_service(ref_make("sax", T=T, W=T // 20), D[:40], ref_mesh,
                verify="device", metrics=theirs).topk(Q[:1], k=1)
    assert names(mine) == names(theirs)
    assert {"match.host_order_bytes", "match.h2d_bytes",
            "match.rows_to_host"} <= set(names(mine))

    mine, theirs = MetricsRegistry(), RefRegistry()
    enc = make_technique("sax", T=M, W=12)
    SubseqEngine(WindowView(enc, X[:3], stride=8, device="cpu"),
                 verify="device", mesh=_mesh(2),
                 metrics=mine).topk(QW[:1], k=1)
    RefSubseq(RefView(ref_make("sax", T=M, W=12), X[:3], stride=8),
              verify="device", mesh=ref_mesh,
              metrics=theirs).topk(QW[:1], k=1)
    assert names(mine) == names(theirs)
    assert {"subseq.host_order_bytes", "subseq.h2d_bytes",
            "subseq.rows_to_host"} <= set(names(mine))


@pytest.mark.parametrize("argv", [
    ["--dryrun", "--verify", "device", "--explain"],
    ["--dryrun", "--subseq", "--verify", "device", "--explain"]])
def test_launcher_verify_device_on_cpu(capsys, argv):
    from repro_torch.launch.match import main
    main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "4/4 query frontiers == brute force" in out
    assert "transfers: host_order_bytes=0" in out
    assert "rows_to_host=0" in out


def test_device_route_on_card_equals_kernel_bruteforce(season, windows):
    """On the card: an sSAX call sweeps its queries in one K2 launch,
    the device route makes one K1 launch per round, and its answer equals
    the host route's and a K1 brute force bitwise, whole series and
    windows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels import KERNELS, ops
    from repro_torch.launch.match import kernel_bruteforce
    Q, D = season
    enc = _enc("ssax")
    mesh = make_mesh(4)
    store = SymbolicStore.from_rows(enc, D, device="cuda")
    eng = {v: make_engine_service(enc, None, mesh, store=store, verify=v,
                                  pairwise=ops.make_pairwise(enc))
           for v in ("device", "host")}
    n2, n1 = KERNELS["ssax_dist"].launches, KERNELS["euclid"].launches
    res = eng["device"].topk(Q, k=8)
    assert KERNELS["ssax_dist"].launches - n2 == 1
    assert KERNELS["euclid"].launches - n1 == res.rounds
    assert _same(res, eng["host"].topk(Q, k=8)) and res.store_accesses == 0
    bf_i, bf_d = kernel_bruteforce(Q, D, 8, "cuda")
    np.testing.assert_array_equal(res.indices, bf_i)
    np.testing.assert_array_equal(res.distances, bf_d)
    X, QW = windows
    wenc = make_technique("ssax", T=M, **WIN_FIELDS["ssax"])
    view = WindowView(wenc, X, stride=3, device="cuda")
    got = SubseqEngine(view, verify="device", mesh=mesh,
                       pairwise=ops.make_pairwise(wenc)).topk(QW, k=5)
    want = SubseqEngine(view, verify="host").topk(QW, k=5)
    np.testing.assert_array_equal(got.window_ids, want.window_ids)
    np.testing.assert_array_equal(got.distances, want.distances)
