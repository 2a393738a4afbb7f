"""The port's split-tree index on the CPU (T=480, W=24, L=10, N<=512).

Against the JAX package's index: ``ndtri_np`` and ``gauss_breaks`` are
bitwise equal; each adapter's features agree within 1e-6 (the trend
dimension as tan(phi), before its scale of sqrt(T var t) ~ 3e3); a
port ``SplitTree`` fed the reference's features is bitwise the
reference's tree (features drift by ~1e-7 across frameworks, and a
feature on a split breakpoint may route to another child, so the tree
logic is held on identical inputs); indexed top-k ids are equal and
distances within rtol 1e-5.  Within the port: indexed equals linear
bitwise, incremental equals bulk, a grouped build equals a single one,
``epoch=`` equals a frozen store, and the approximate tier's
certificate holds.  The vectorized collect walk equals the reference's
node-by-node walk bitwise, order included, and a one-pass
``insert_rows`` equals the reference's chunk-by-chunk build."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    MatchEngine, OneDSAX, from_reference, make_technique)
from repro_torch.core.matching import RawStore  # noqa: E402
from repro_torch.data.synthetic import season_dataset  # noqa: E402
from repro_torch.index import (  # noqa: E402
    SeriesIndex, SplitTree, TreeCandidates, adapter_for, gauss_breaks,
    ndtri_np)
from repro_torch.kernels import KERNELS  # noqa: E402
from repro_torch.store import SymbolicStore  # noqa: E402

T, W, L, N, NQ = 480, 24, 10, 300, 4
TECHS = ("sax", "ssax", "tsax", "stsax")


@pytest.fixture(scope="module")
def season():
    X = season_dataset(N + NQ, T, L, 0.7, per_series_strength=True,
                       seed=41)
    return X[:NQ], X[NQ:]


def _enc(tech):
    return make_technique(tech, T=T, W=W, L=L)


def _store(tech, D, **kw):
    store = SymbolicStore.from_rows(_enc(tech), D, device="cpu")
    store.build_index(leaf_fill=16, max_bits=5, **kw)
    return store


def _engine(store, verify="numpy"):
    return MatchEngine(store.encoder, store, verify=verify, device="cpu")


@pytest.fixture(scope="module")
def reference(season):
    """The JAX package's stores with their indexes, and its indexed and
    linear answers (k = 5, numpy verification), per technique."""
    from repro.core import MatchEngine as RefEngine
    from repro.core import make_technique as ref_make
    from repro.store import SymbolicStore as RefStore
    Q, D = season
    out = {}
    for tech in TECHS:
        enc = ref_make(tech, T=T, W=W, L=L)
        store = RefStore.from_rows(enc, D)
        store.build_index(leaf_fill=16, max_bits=5)
        eng = RefEngine(enc, store, verify="numpy")
        out[tech] = dict(enc=enc, store=store,
                         idx=eng.topk(Q, k=5, source="index"),
                         lin=eng.topk(Q, k=5))
    return out


# -- against the reference ---------------------------------------------------

def test_ndtri_and_gauss_breaks_bitwise_equal_reference():
    from repro.index.features import gauss_breaks as ref_breaks
    from repro.index.features import ndtri_np as ref_ndtri
    qs = np.concatenate([np.linspace(1e-6, 1 - 1e-6, 1001),
                         [0.02425, 0.5, 1 - 0.02425]])
    np.testing.assert_array_equal(ndtri_np(qs), ref_ndtri(qs))
    for card in (2, 4, 16, 256):
        for sd in (1.0, 0.55, 31.4):
            np.testing.assert_array_equal(gauss_breaks(card, sd),
                                          ref_breaks(card, sd))


@pytest.mark.parametrize("tech", TECHS)
def test_adapter_features_match_reference(season, reference, tech):
    _, D = season
    ref_ad = reference[tech]["store"].index.adapter
    enc = from_reference(type(reference[tech]["enc"]).__name__,
                         dataclasses.asdict(reference[tech]["enc"]))
    ad = adapter_for(enc, "cpu")
    for attr in ("weights", "sds", "priority"):
        np.testing.assert_array_equal(getattr(ad, attr),
                                      getattr(ref_ad, attr))
    got, want = ad.features(D), ref_ad.features(D)
    assert got.dtype == np.float32 and got.shape == want.shape
    if tech in ("tsax", "stsax"):          # compare tan(phi), unscaled
        got, want = got.astype(np.float64), want.astype(np.float64)
        got[:, 0] /= ad.scale
        want[:, 0] /= ref_ad.scale
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("tech", TECHS)
def test_tree_from_reference_features_is_reference_tree(reference, tech,
                                                        grouped):
    ref_tree = reference[tech]["store"].index.tree
    feats = ref_tree.feats
    enc = from_reference(type(reference[tech]["enc"]).__name__,
                         dataclasses.asdict(reference[tech]["enc"]))
    tree = SplitTree(adapter_for(enc, "cpu"), leaf_fill=16, max_bits=5)
    if grouped:
        tree.insert_grouped(feats, 4)
    else:
        for lo, hi in ((0, 7), (7, 130), (130, feats.shape[0])):
            tree.insert(feats[lo:hi])
    assert tree.n_nodes == ref_tree.n_nodes > 1
    assert tree.leaf_membership() == ref_tree.leaf_membership()
    meta, arrays = tree.to_snapshot()
    ref_meta, ref_arrays = ref_tree.to_snapshot()
    assert meta == ref_meta and sorted(arrays) == sorted(ref_arrays)
    for key, want in ref_arrays.items():
        assert arrays[key].dtype == want.dtype, key
        np.testing.assert_array_equal(arrays[key], want, err_msg=key)


@pytest.fixture(scope="module")
def walk_trees(season):
    """The JAX package's sSAX split trees to walk, with their items in
    raw space and their queries: whole series at D = 58 (W = 48) and
    windows at D = 34 (m = 240, W = 24, stride 8 over 12 rows)."""
    from repro.core import make_technique as ref_make
    from repro.store import SymbolicStore as RefStore
    from repro.subseq import WindowView as RefView
    from repro.subseq.windows import znorm_windows as ref_znorm
    Q, D = season
    enc = ref_make("ssax", T=T, W=48, L=L)
    store = RefStore.from_rows(enc, D)
    store.build_index(leaf_fill=8, max_bits=5)
    wenc = ref_make("ssax", T=240, W=24, L=L)
    view = RefView(wenc, D[:12], stride=8)
    view.build_index(leaf_fill=8, max_bits=5)
    return {"series58": (enc, store.index, D, Q),
            "windows34": (wenc, view.index, view.fetch(np.arange(view.n)),
                          ref_znorm(Q[:, 100:340]))}


@pytest.mark.parametrize("kind", ["series58", "windows34"])
def test_collect_bounds_equals_reference_walk(walk_trees, kind,
                                              monkeypatch):
    """The vectorized collect walk returns the reference's node-by-node
    walk's (ids, bounds), order included, bitwise: thresholds 0, a seed
    frontier's k-th distance and inf, live and as-of ``max_id``, on a
    half-built tree whose node table is cached and then on the same
    tree after an ``insert`` (which must drop the cached table)."""
    from repro.index.tree import SplitTree as RefTree
    enc, ridx, items, queries = walk_trees[kind]
    feats = ridx.tree.feats
    tree = SplitTree(adapter_for(from_reference(
        type(enc).__name__, dataclasses.asdict(enc)), "cpu"),
        leaf_fill=8, max_bits=5)
    assert tree.D == {"series58": 58, "windows34": 34}[kind]
    monkeypatch.setattr(tree, "bbox_lb", lambda *a: pytest.fail(
        "collect_bounds evaluated a box bound node by node"))
    qf = ridx.adapter.features(queries)
    half = feats.shape[0] // 2
    ref_half = RefTree(ridx.adapter, leaf_fill=8, max_bits=5)
    for t in (tree, ref_half):
        t.insert(feats[:half])

    def check(want_tree):
        for qi in range(qf.shape[0]):
            seeds = want_tree.seed_candidates(qf[qi], 5)
            d = np.sort(np.sqrt(np.sum(np.square(
                items[seeds] - queries[qi]), axis=-1)))
            for thresh in (0.0, float(d[4]), np.inf):
                for max_id in (None, want_tree.n // 3):
                    got = tree.collect_bounds(qf[qi], thresh, max_id)
                    want = want_tree.collect_bounds(qf[qi], thresh, max_id)
                    for g, w in zip(got, want):
                        assert g.dtype == w.dtype
                        np.testing.assert_array_equal(g, w)
        assert tree._table is not None

    check(ref_half)
    tree.insert(feats[half:])
    assert tree._table is None
    check(ridx.tree)


@pytest.mark.parametrize("tech", TECHS)
def test_one_pass_insert_rows_equals_reference_chunked_build(season, tech,
                                                             monkeypatch):
    """``insert_rows`` computes features chunk by chunk and routes them
    with ONE ``SplitTree.insert``; fed the reference's features, its
    tree is the reference's chunk-by-chunk build bitwise."""
    import repro.index.series as ref_series
    from repro.core import make_technique as ref_make
    from repro.index import SeriesIndex as RefIndex
    import repro_torch.index.series as port_series
    _, D = season
    monkeypatch.setattr(ref_series, "_INSERT_CHUNK", 37)
    monkeypatch.setattr(port_series, "_INSERT_CHUNK", 37)
    renc = ref_make(tech, T=T, W=W, L=L)
    ridx = RefIndex(renc, leaf_fill=16, max_bits=5)
    ridx.insert_rows(D)                       # 9 chunks, 9 tree walks
    idx = SeriesIndex(from_reference(type(renc).__name__,
                                     dataclasses.asdict(renc)),
                      leaf_fill=16, max_bits=5, device="cpu")
    feature_calls, inserts = [], []
    monkeypatch.setattr(idx.adapter, "features", lambda rows: (
        feature_calls.append(len(rows)) or ridx.adapter.features(rows)))
    real_insert = idx.tree.insert
    monkeypatch.setattr(idx.tree, "insert", lambda f: (
        inserts.append(len(f)) or real_insert(f)))
    ids = idx.insert_rows(D)
    assert len(feature_calls) == 9 and inserts == [N]
    np.testing.assert_array_equal(ids, np.arange(N))
    assert idx.tree.leaf_membership() == ridx.tree.leaf_membership()
    (meta, arrays), (ref_meta, ref_arrays) = (idx.tree.to_snapshot(),
                                              ridx.tree.to_snapshot())
    assert meta == ref_meta
    for key, want in ref_arrays.items():
        assert arrays[key].dtype == want.dtype, key
        np.testing.assert_array_equal(arrays[key], want, err_msg=key)


@pytest.mark.parametrize("tech", TECHS)
def test_indexed_topk_matches_reference(season, reference, tech):
    Q, D = season
    res = _engine(_store(tech, D)).topk(Q, k=5, source="index")
    want = reference[tech]["idx"]
    np.testing.assert_array_equal(res.indices, want.indices)
    np.testing.assert_allclose(res.distances, want.distances, rtol=1e-5)


# -- within the port ---------------------------------------------------------

@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("tech", TECHS)
def test_indexed_topk_bitwise_equals_linear(season, tech, k):
    Q, D = season
    eng = _engine(_store(tech, D))
    lin = eng.topk(Q, k=k)
    idx = eng.topk(Q, k=k, source="index")
    np.testing.assert_array_equal(idx.indices, lin.indices)
    np.testing.assert_array_equal(idx.distances, lin.distances)
    assert idx.rounds >= 1


def test_indexed_kernel_route_one_k1_call_per_round(season, monkeypatch):
    """Through the K1 wrapper (its plain version here), the indexed path
    makes one K1 call and one store fetch per round, the seed
    verification included, and answers as the linear sweep does."""
    from repro_torch.kernels import ref
    Q, D = season
    calls = []
    real = ref.euclid_gather_ref
    monkeypatch.setattr(ref, "euclid_gather_ref",
                        lambda *a: calls.append(1) or real(*a))
    store = _store("ssax", D)
    eng = _engine(store, verify="kernel")
    for k in (1, 32):
        store.reset()
        n0 = len(calls)
        res = eng.topk(Q, k=k, source="index")
        assert len(calls) - n0 == res.rounds == res.store_fetches >= 2
        lin = eng.topk(Q, k=k)
        np.testing.assert_array_equal(res.indices, lin.indices)
        np.testing.assert_array_equal(res.distances, lin.distances)


def test_frontier_reuse_never_verifies_an_id_twice(season):
    """A second round seeded with the first round's frontier and the ids
    it verified (``prior_d`` / ``prior_i`` / ``seen``, as exclusion
    widening uses them) verifies no id again and answers the same."""
    Q, D = season
    store = _store("ssax", D)
    idx = store.index
    first = {qi: [] for qi in range(NQ)}
    r1 = idx.topk(Q, store, k=5,
                  on_verified=lambda qi, ids, d: first[qi].extend(ids))
    seen = [np.asarray(first[qi], np.int64) for qi in range(NQ)]
    assert all(len(np.unique(s)) == len(s) for s in seen)
    again = {qi: [] for qi in range(NQ)}
    r2 = idx.topk(Q, store, k=5, prior_d=r1.distances,
                  prior_i=r1.indices, seen=seen,
                  on_verified=lambda qi, ids, d: again[qi].extend(ids))
    np.testing.assert_array_equal(r2.indices, r1.indices)
    np.testing.assert_array_equal(r2.distances, r1.distances)
    for qi in range(NQ):
        assert not np.isin(again[qi], seen[qi]).any()


def test_launcher_index_explain_ingest_snapshot(tmp_path, capsys):
    """The launcher's whole-series flags on the CPU: indexed answers
    bitwise equal to linear before and after an ingest, rendered plans,
    metrics, and a snapshot that both packages reopen with the index."""
    from repro_torch.launch.match import main
    main(["--dryrun", "--device", "cpu", "--index", "--explain",
          "--ingest", "1", "--ingest-rows", "64",
          "--snapshot-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("bitwise==linear yes") == 2
    assert "== match.topk (k=8, queries=4, source=index" in out
    assert "[metrics] match.candidates_verified=" in out
    back = SymbolicStore.open(str(tmp_path), device="cpu")
    assert back.n == 256 + 64 and back.index.n == back.n
    from repro.store import SymbolicStore as RefStore
    ref = RefStore.open(str(tmp_path))
    assert ref.index.tree.leaf_membership() == \
        back.index.tree.leaf_membership()


def test_indexed_examines_fewer_candidates_ssax(season):
    Q, D = season
    eng = _engine(_store("ssax", D))
    lin = eng.topk(Q, k=4)
    idx = eng.topk(Q, k=4, source="index")
    assert idx.raw_accesses.mean() < lin.raw_accesses.mean()


@pytest.mark.parametrize("tech", TECHS)
def test_incremental_insert_equals_bulk_build(season, tech):
    Q, D = season
    inc = SymbolicStore(_enc(tech), device="cpu")
    inc.append(D[:60])
    inc.build_index(leaf_fill=16, max_bits=5)
    for lo, hi in ((60, 61), (61, 150), (150, 151), (151, N)):
        inc.append(D[lo:hi])
    assert inc.index is not None and inc.index.n == inc.n == N
    bulk = _store(tech, D)
    assert inc.index.n_nodes == bulk.index.n_nodes
    assert inc.index.tree.leaf_membership() == \
        bulk.index.tree.leaf_membership()
    r_inc = _engine(inc).topk(Q, k=5, source="index")
    r_blk = _engine(bulk).topk(Q, k=5, source="index")
    np.testing.assert_array_equal(r_inc.indices, r_blk.indices)
    np.testing.assert_array_equal(r_inc.distances, r_blk.distances)


@pytest.mark.parametrize("tech", TECHS)
def test_grouped_build_equals_single(season, tech):
    _, D = season
    one, grouped = _store(tech, D), _store(tech, D, n_shards=4)
    assert grouped.index.n_nodes == one.index.n_nodes
    assert grouped.index.tree.leaf_membership() == \
        one.index.tree.leaf_membership()
    a, b = one.index.tree.to_snapshot()[1], grouped.index.tree.to_snapshot()[1]
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("source", [None, "index"])
@pytest.mark.parametrize("tech", TECHS)
def test_epoch_pinned_topk_equals_frozen_store(season, tech, source):
    Q, D = season
    n0 = 120
    store = _store(tech, D[:n0])
    idx0 = store.index
    eng = _engine(store)
    pins = [store.current_epoch()]
    for lo, hi in ((n0, n0 + 7), (n0 + 7, n0 + 60)):
        store.append(D[lo:hi])
        pins.append(store.current_epoch())
    assert [p.n_rows for p in pins] == [n0, n0 + 7, n0 + 60]
    assert [p.index_n for p in pins] == [p.n_rows for p in pins]
    for ep in pins:
        got = eng.topk(Q, k=3, source=source, epoch=ep)
        want = _engine(_store(tech, D[:ep.n_rows])).topk(Q, k=3,
                                                         source=source)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.distances, want.distances)
        assert got.indices.max() < ep.n_rows
    assert store.index is idx0               # no rebuild


@pytest.mark.parametrize("tech", TECHS)
def test_topk_approx_certificate(season, tech):
    Q, D = season
    eng = _engine(_store(tech, D))
    exact = eng.topk(Q, k=4, source="index")
    res = eng.topk_approx(Q, k=4, collect=4, explain=True)
    assert res.kth_lb.shape == res.error_bar.shape == (NQ,)
    assert np.all(res.error_bar >= 0.0)
    for qi in range(NQ):
        assert res.kth_lb[qi] <= exact.distances[qi, -1] + 1e-5
        assert np.all(res.distances[qi] >= exact.distances[qi] - 1e-5)
        if res.error_bar[qi] == 0.0:         # certified exact
            np.testing.assert_array_equal(res.distances[qi],
                                          exact.distances[qi])
    assert res.trace.get("exact") is False
    assert res.trace.get("source") == "index-approx"
    assert res.trace.get("error_bar") is not None


def test_topk_approx_large_collect_is_exact(season):
    Q, D = season
    eng = _engine(_store("ssax", D))
    exact = eng.topk(Q, k=4, source="index")
    res = eng.topk_approx(Q, k=4, collect=N)
    np.testing.assert_array_equal(res.indices, exact.indices)
    np.testing.assert_array_equal(res.distances, exact.distances)
    assert np.all(res.error_bar == 0.0)


def test_topk_approx_without_index_falls_back(season):
    Q, D = season
    store = SymbolicStore.from_rows(_enc("sax"), D, device="cpu")
    eng = _engine(store)
    res = eng.topk_approx(Q, k=3)
    np.testing.assert_array_equal(res.indices,
                                  eng.topk(Q, k=3, exact=False).indices)
    assert not hasattr(res, "kth_lb")


def test_tree_candidates_rejects_bad_collect_and_device_order(season):
    """Bad arguments raise; ``device_order=True`` (ported with
    ``core/distributed.py``) streams the union bounds from the device and
    answers bitwise as the host-ordered source does."""
    Q, D = season
    store = _store("ssax", D[:48])
    with pytest.raises(ValueError):
        store.index.source(approx_collect=-1)
    with pytest.raises(ValueError):
        TreeCandidates(store.index.tree, store.index.query_features,
                       prior_d=np.zeros((1, 1)))
    src = store.index.source(device_order=True)
    cs = src.candidate_bounds(Q, 4, lambda c: _engine(store)
                              .verify_candidates(Q, c, k=4))
    assert cs.bounds is None and cs.stream is not None
    from repro_torch.index.candidates import topk_from_source
    got = topk_from_source(Q, src, store, k=4, total=store.n)
    want = store.index.topk(Q, store, k=4)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.distances, want.distances)
    assert got.rounds == want.rounds


def test_sharded_paths_name_their_item(season):
    """The sharded paths (ROADMAP item 8) now run and equal their
    unsharded counterparts bitwise, and the FFT profile (item 9) answers
    as the reference's within its documented tolerance."""
    _, D = season
    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels import ops
    mesh = make_mesh(2, device="cpu")
    host = SymbolicStore.from_rows(_enc("ssax"), D[:16], device="cpu")
    host.build_index()
    store = SymbolicStore.from_rows(_enc("ssax"), D[:16], device="cpu")
    store.build_index(mesh=mesh)
    (ma, xa), (mb, xb) = host.index.to_snapshot(), store.index.to_snapshot()
    assert ma == mb and all(np.array_equal(xa[k], xb[k]) for k in xa)
    adapter = adapter_for(_enc("ssax"), "cpu")
    np.testing.assert_array_equal(adapter.features_sharded(D[:5], mesh),
                                  adapter.features(D[:5]))
    # the FFT profile (item 9) is ported: it answers as the reference's
    pytest.importorskip("jax")
    from repro.kernels.fft_dot import windowed_euclid_fft
    from repro_torch.kernels.fft_dot import fft_tolerance
    x, q = D[:2, :64], D[2, :16]
    q = (q - q.mean()) / q.std()
    got = ops.windowed_euclid(torch.from_numpy(x), torch.from_numpy(q),
                              method="fft")
    assert got.shape == (2, 49)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(windowed_euclid_fft(x, q[None]))[0],
        **fft_tolerance(16))


def test_build_index_rejects_rep_only_store():
    store = SymbolicStore(_enc("ssax"), store_raw=False, device="cpu")
    store.append(np.zeros((4, T), np.float32))
    with pytest.raises(TypeError, match="store_raw"):
        store.build_index()


def test_adapter_for_rejects_unknown_encoder():
    with pytest.raises(TypeError, match="adapter"):
        adapter_for(OneDSAX(T=T, W=W, A_a=16, A_s=16), "cpu")


def test_series_index_defaults_to_the_card():
    if torch.cuda.is_available():
        assert SeriesIndex(_enc("sax")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SeriesIndex(_enc("sax"))


# -- the legacy sSAX index (spec: tests/test_index.py) -------------------------

@pytest.fixture(scope="module")
def legacy(season):
    from repro_torch.core.index import SSaxIndex
    Q, D = season
    enc = make_technique("ssax", T=T, W=W, L=L)
    sigma, resbar = (t.numpy() for t in enc.features(torch.as_tensor(D)))
    idx = SSaxIndex(sigma, resbar, T=T, sd_seas=enc.sd_seas,
                    sd_res=enc.sd_res, max_bits=6, leaf_capacity=32)
    return Q, D, enc, idx


def test_legacy_index_structure(legacy):
    _, D, _, idx = legacy
    seen = []

    def walk(node):
        if node.is_leaf:
            seen.extend(node.ids.tolist())
        else:
            for c in node.children.values():
                walk(c)
    walk(idx.root)
    assert idx.n_nodes > 1 and sorted(seen) == list(range(D.shape[0]))


@pytest.mark.parametrize("k", [1, 8])
def test_legacy_topk_bitwise_equals_bruteforce_and_engine(legacy, k):
    Q, D, enc, idx = legacy
    sq, rq = (t.numpy() for t in enc.features(torch.as_tensor(Q)))
    store = RawStore.ssd(D)
    res = idx.topk(sq, rq, store, Q, k=k)
    ed = np.stack([np.sqrt(np.sum((D - q[None]) ** 2, -1)) for q in Q])
    want = np.argsort(ed, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(res.indices, want)
    np.testing.assert_array_equal(res.distances,
                                  np.take_along_axis(ed, want, axis=1))
    assert res.store_fetches == store.fetches
    lin = MatchEngine(enc, RawStore.ssd(D), verify="numpy",
                      device="cpu").topk(Q, k=k)
    np.testing.assert_array_equal(res.indices, lin.indices)
    one = idx.query(sq[0], rq[0], RawStore.ssd(D), Q[0])
    assert one.index == want[0, 0]


def test_index_on_card_equals_kernel_bruteforce(season):
    """On the card the index's features go through K4 and its
    verification through K1 (one launch per round, the seed's
    included), and indexed top-k equals a K1 brute force bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.launch.match import kernel_bruteforce, make_engine
    Q, D = season
    eng = make_engine("ssax", D, device="cuda")
    n_paa = KERNELS["paa"].launches
    eng.store.build_index(leaf_fill=16)
    assert KERNELS["paa"].launches > n_paa
    n0 = KERNELS["euclid"].launches
    res = eng.topk(Q, k=8, source="index")
    assert KERNELS["euclid"].launches - n0 == res.rounds == \
        res.store_fetches
    bf_i, bf_d = kernel_bruteforce(Q, D, 8, "cuda")
    np.testing.assert_array_equal(res.indices, bf_i)
    np.testing.assert_array_equal(res.distances, bf_d)
