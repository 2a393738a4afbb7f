"""The port's window index and subsequence observability on the CPU
(8 rows of T=480, windows of M=120 with W=12, L=10; W*L must divide M
for sSAX), held against the JAX package's ``repro.subseq``.

Against the reference (``verify="numpy"`` on both sides): indexed window
ids are equal and distances agree within rtol 1e-5; raw accesses, rows
read, fetches and modeled I/O are equal; a window tree fed the
reference's own features is the reference's tree bitwise; trace span
names, per-query candidate counts and ``subseq.*`` metric names and
counter values are the reference's.  Within the port, bitwise: indexed
equals linear, a build then an append equals a build after the append,
an epoch-pinned indexed call equals a frozen view, the approximate
tier's certificate holds, a traced or metered call equals the untraced
one, and exclusion widening verifies no window twice."""

import dataclasses
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import from_reference, make_technique  # noqa: E402
from repro_torch.data.synthetic import season_dataset  # noqa: E402
from repro_torch.index import SplitTree, adapter_for  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.match import greedy_nonoverlap  # noqa: E402
from repro_torch.obs import MetricsRegistry, Trace, check_trace  # noqa: E402
from repro_torch.subseq import SubseqEngine, WindowView  # noqa: E402

T, M, W, L, N, NQ = 480, 120, 12, 10, 8, 3
LEAF_FILL, MAX_BITS = 16, 5
TECHS = ("sax", "ssax", "tsax", "stsax")
PLAIN = ("euclid_gather_ref", "euclid_ref", "paa_ref", "sax_dist_ref",
         "ssax_dist_batch_ref")


def _enc(tech):
    return make_technique(tech, T=M, W=W, L=L)


@pytest.fixture(scope="module")
def corpus():
    X = season_dataset(N, T, L, 0.7, per_series_strength=True, seed=11)
    rng = np.random.default_rng(3)
    Q = np.stack([X[r, o:o + M] for r, o in ((1, 40), (5, 300), (7, 10))])
    return X, Q + 0.05 * rng.normal(size=Q.shape).astype(np.float32)


def _view(X, tech, stride, index=True, **kw):
    view = WindowView(_enc(tech), X, stride=stride, device="cpu", **kw)
    if index:
        view.build_index(leaf_fill=LEAF_FILL, max_bits=MAX_BITS)
    return view


@pytest.fixture(scope="module")
def reference(corpus):
    """The JAX package's indexed window views and engines, built once per
    (technique, stride)."""
    pytest.importorskip("jax")
    from repro.core import make_technique as ref_make
    from repro.subseq import SubseqEngine as RefEngine
    from repro.subseq import WindowView as RefView
    X, _ = corpus
    cache = {}

    def get(tech, stride):
        if (tech, stride) not in cache:
            view = RefView(ref_make(tech, T=M, W=W, L=L), X, stride=stride)
            view.build_index(leaf_fill=LEAF_FILL, max_bits=MAX_BITS)
            cache[tech, stride] = (view, RefEngine(view, verify="numpy"))
        return cache[tech, stride]
    return get


def _accounting(res):
    return (res.raw_accesses.tolist(), res.store_accesses,
            res.store_fetches, res.io_seconds)


# -- against the reference ---------------------------------------------------

@pytest.mark.parametrize("excl", [0, M // 2])
@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("tech", TECHS)
def test_indexed_topk_matches_reference(corpus, reference, tech, stride,
                                        excl):
    X, Q = corpus
    rview, reng = reference(tech, stride)
    view = _view(X, tech, stride)
    eng = SubseqEngine(view, verify="numpy")
    assert view.index.n == rview.index.n == view.n
    rview.reset()
    want = reng.topk(Q, k=5, exclusion=excl)
    view.reset()
    got = eng.topk(Q, k=5, exclusion=excl)
    np.testing.assert_array_equal(got.window_ids, want.window_ids)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)
    assert _accounting(got) == _accounting(want)
    lin = eng.topk(Q, k=5, exclusion=excl, use_index=False)
    np.testing.assert_array_equal(got.window_ids, lin.window_ids)
    np.testing.assert_array_equal(got.distances, lin.distances)


@pytest.mark.parametrize("tech", TECHS)
def test_window_tree_from_reference_features_is_reference_tree(
        reference, tech):
    rview, _ = reference(tech, 1)
    ref_tree = rview.index.tree
    enc = from_reference(type(rview.encoder).__name__,
                         dataclasses.asdict(rview.encoder))
    tree = SplitTree(adapter_for(enc, "cpu"), leaf_fill=LEAF_FILL,
                     max_bits=MAX_BITS)
    tree.insert(ref_tree.feats)              # one pass, as build_index
    assert tree.n_nodes == ref_tree.n_nodes > 1
    assert tree.leaf_membership() == ref_tree.leaf_membership()
    meta, arrays = tree.to_snapshot()
    ref_meta, ref_arrays = ref_tree.to_snapshot()
    assert meta == ref_meta and sorted(arrays) == sorted(ref_arrays)
    for key, want in ref_arrays.items():
        assert arrays[key].dtype == want.dtype, key
        np.testing.assert_array_equal(arrays[key], want, err_msg=key)


def test_trace_and_metrics_match_reference(corpus, reference):
    from repro.obs import MetricsRegistry as RefRegistry
    from repro.subseq import SubseqEngine as RefEngine
    X, Q = corpus
    rview, _ = reference("ssax", 3)
    view = _view(X, "ssax", 3)
    rreg, reg = RefRegistry(), MetricsRegistry()
    reng = RefEngine(rview, verify="numpy", metrics=rreg)
    eng = SubseqEngine(view, verify="numpy", metrics=reg)
    for use_index in (True, False):
        for excl in (0, M // 2):
            rview.reset()
            want = reng.topk(Q, k=4, exclusion=excl, use_index=use_index,
                             explain=True)
            view.reset()
            got = eng.topk(Q, k=4, exclusion=excl, use_index=use_index,
                           explain=True)
            label = (use_index, excl)
            np.testing.assert_array_equal(got.window_ids, want.window_ids)
            assert got.trace.span_names() == want.trace.span_names(), label
            for key in ("generated", "verified", "examined",
                        "generated_unique", "pruning_power"):
                np.testing.assert_array_equal(
                    got.trace.get(key), want.trace.get(key),
                    err_msg=f"{label} {key}")
            for key in ("engine", "k", "q_n", "total", "verify", "source",
                        "rows_fetched", "seeks"):
                assert got.trace.get(key) == want.trace.get(key), \
                    (label, key)
            assert [r["phase"] for r in got.trace.rounds] == \
                [r["phase"] for r in want.trace.rounds], label
            assert check_trace(got.trace) == [], label
    want = reng.topk_approx(Q, k=4, collect=6, explain=True)
    got = eng.topk_approx(Q, k=4, collect=6, explain=True)
    np.testing.assert_array_equal(got.window_ids, want.window_ids)
    assert got.trace.get("source") == want.trace.get("source")
    assert got.trace.get("exact") is want.trace.get("exact") is False
    ours, theirs = reg.snapshot(), rreg.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(ours[kind]) == sorted(theirs[kind]), kind
    for name, value in theirs["counters"].items():
        assert ours["counters"][name] == pytest.approx(value, rel=1e-12), \
            name
    assert ours["histograms"]["subseq.topk_latency_s"]["count"] == 5


def test_topk_approx_certificate(corpus, reference):
    """Following ``tests/test_approx_tier.py::
    test_subseq_topk_approx_certificate``, and against the reference's
    ``topk_approx`` at the same collect."""
    X, Q = corpus
    rview, reng = reference("ssax", 3)
    view = _view(X, "ssax", 3)
    eng = SubseqEngine(view, verify="numpy")
    k = 3
    exact = eng.topk(Q, k=k, use_index=True)
    for collect in (k, None):
        res = eng.topk_approx(Q, k=k, collect=collect, explain=True)
        want = reng.topk_approx(Q, k=k, collect=collect)
        np.testing.assert_array_equal(res.window_ids, want.window_ids)
        np.testing.assert_allclose(res.kth_lb, want.kth_lb, rtol=1e-5)
        np.testing.assert_allclose(res.error_bar, want.error_bar,
                                   rtol=1e-5, atol=1e-5)
        assert res.raw_accesses.tolist() == want.raw_accesses.tolist()
        assert np.all(res.error_bar >= 0.0)
        assert np.all(res.kth_lb <= exact.distances[:, -1] + 1e-5)
        assert res.trace.get("exact") is False
        assert check_trace(res.trace) == []
    big = eng.topk_approx(Q, k=k, collect=view.n)
    np.testing.assert_array_equal(big.window_ids, exact.window_ids)
    np.testing.assert_array_equal(big.distances, exact.distances)
    assert np.all(big.error_bar == 0.0)
    bare = SubseqEngine(_view(X, "ssax", 3, index=False), verify="numpy")
    with pytest.raises(ValueError, match="build_index"):
        bare.topk_approx(Q, k=k)


# -- within the port ---------------------------------------------------------

@pytest.mark.parametrize("tech", TECHS)
def test_build_then_sync_equals_build_after_append(corpus, tech):
    """The index a ``sync`` maintains (one insert per encode chunk)
    equals one built over all windows after the append, bitwise, and
    the appended row's windows are found through it."""
    X, Q = corpus
    grown = _view(X[:5], tech, 3, encode_chunk=50)
    grown.append(X[5:7])
    grown.append(X[7:])
    fresh = _view(X, tech, 3)
    assert grown.index.n == grown.n == fresh.index.n
    assert grown.index.tree.leaf_membership() == \
        fresh.index.tree.leaf_membership()
    (ma, xa), (mb, xb) = (grown.index.tree.to_snapshot(),
                          fresh.index.tree.to_snapshot())
    assert ma == mb
    for key in xb:
        np.testing.assert_array_equal(xa[key], xb[key], err_msg=key)
    res = SubseqEngine(grown, verify="numpy").topk(X[7:, 30:30 + M], k=1,
                                                   use_index=True)
    assert res.rows[0, 0] == 7 and res.distances[0, 0] < 1e-3


def test_epoch_pinned_indexed_call(corpus):
    X, Q = corpus
    view = _view(X[:6], "ssax", 3)
    eng = SubseqEngine(view, verify="numpy")
    ep = view.current_epoch()
    want = SubseqEngine(_view(X[:6], "ssax", 3, index=False),
                        verify="numpy").topk(Q, k=4)
    view.append(X[6:])
    assert view.index.n == view.n > ep.n_rows
    for use_index in (True, False):
        got = eng.topk(Q, k=4, epoch=ep, use_index=use_index)
        np.testing.assert_array_equal(got.window_ids, want.window_ids)
        np.testing.assert_array_equal(got.distances, want.distances)
    # a stale index: the live call refuses, the frontier is clamped to
    # what the index covers, and a call pinned there answers
    idx, view.index = view.index, None
    view.append(X[:1])
    view.index = idx
    with pytest.raises(ValueError, match="sync"):
        eng.topk(Q, k=4, use_index=True)
    ep = view.current_epoch()
    assert ep.n_rows == ep.index_n == idx.n < view.n
    got = eng.topk(Q, k=4, epoch=ep)
    lin = eng.topk(Q, k=4, epoch=ep, use_index=False)
    np.testing.assert_array_equal(got.window_ids, lin.window_ids)
    np.testing.assert_array_equal(got.distances, lin.distances)


def test_use_index_rules(corpus):
    X, Q = corpus
    bare = SubseqEngine(_view(X, "ssax", 3, index=False), verify="numpy")
    with pytest.raises(ValueError, match="build_index"):
        bare.topk(Q, k=2, use_index=True)
    assert bare.topk(Q, k=2, explain=True).trace.get("source") == "linear"
    eng = SubseqEngine(_view(X, "ssax", 3), verify="numpy")
    for use_index, source in (("auto", "index"), (True, "index"),
                              (False, "linear")):
        res = eng.topk(Q, k=2, use_index=use_index, explain=True)
        assert res.trace.get("source") == source, use_index


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain kernels' calls (what the wrappers run on the
    CPU in place of K1-K4)."""
    calls = dict.fromkeys(PLAIN, 0)
    for name in PLAIN:
        real = getattr(ref, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ref, name, counted)
    return calls


def _fingerprint(res, view):
    return {"ids": res.window_ids.copy(), "distances": res.distances.copy(),
            "raw_accesses": res.raw_accesses.copy(), "rounds": res.rounds,
            "store_accesses": res.store_accesses,
            "store_fetches": res.store_fetches,
            "io_seconds": res.io_seconds, "accesses": view.accesses,
            "fetches": view.fetches}


@pytest.mark.parametrize("excl", [0, M // 2])
@pytest.mark.parametrize("use_index", [False, True])
@pytest.mark.parametrize("tech", TECHS)
def test_tracing_and_metrics_are_neutral(corpus, plain_calls, tech,
                                         use_index, excl):
    """Following ``tests/test_obs_neutrality.py::
    test_subseq_engine_neutral_all_paths``: a traced, explained or
    metered call returns what the plain call returns, with the same
    accounting and the same kernel calls (the plain versions here)."""
    X, Q = corpus
    view = _view(X[:6], tech, 6)
    kw = dict(verify="kernel", batch_size=64,
              pairwise=ops.make_pairwise(view.encoder))
    plain = SubseqEngine(view, **kw)
    reg = MetricsRegistry()
    metered = SubseqEngine(view, metrics=reg, **kw)
    call = dict(k=3, exclusion=excl, use_index=use_index)
    runs = {}
    for name, fn in (
            ("base", lambda: plain.topk(Q, **call)),
            ("explain", lambda: plain.topk(Q, explain=True, **call)),
            ("trace", lambda: plain.topk(Q, trace=Trace("given"), **call)),
            ("metrics", lambda: metered.topk(Q, **call)),
            ("replay", lambda: plain.topk(Q, **call))):
        view.reset()
        before = dict(plain_calls)
        res = fn()
        runs[name] = (_fingerprint(res, view),
                      {n: plain_calls[n] - before[n] for n in PLAIN}, res)
    base_fp, base_calls, _ = runs["base"]
    assert base_calls["euclid_gather_ref"] == base_fp["rounds"] > 0
    for name, (fp, calls, res) in runs.items():
        assert calls == base_calls, name
        for key, want in base_fp.items():
            assert np.array_equal(fp[key], want), (name, key)
        assert hasattr(res, "trace") == (name in ("explain", "trace"))
    for name in ("explain", "trace"):
        trace = runs[name][2].trace
        assert check_trace(trace) == [], name
        json.dumps(trace.to_dict())
        assert trace.get("source") == ("index" if use_index else "linear")
        assert len(trace.rounds) == base_fp["rounds"]
    snap = reg.snapshot()
    assert snap["counters"]["subseq.queries"] == NQ
    assert snap["counters"]["subseq.rows_fetched"] == base_fp["accesses"]
    assert snap["counters"]["subseq.windows_verified"] == \
        int(base_fp["raw_accesses"].sum())
    assert snap["histograms"]["subseq.topk_latency_s"]["count"] == 1


@pytest.mark.parametrize("use_index", [False, True])
def test_exclusion_widening_never_verifies_window_twice(corpus, use_index):
    """Following ``tests/test_subseq.py::
    test_exclusion_widening_never_verifies_window_twice``: every window
    id is fetched at most once over a widening search (one query), on
    the indexed and the linear path, and the answer is the greedy
    non-overlap filter of the brute-force order."""
    X, Q = corpus
    view = _view(X, "sax", 1, index=use_index)
    eng = SubseqEngine(view, verify="numpy", batch_size=64)
    counts = Counter()
    orig = view.fetch
    view.fetch = lambda wids: (counts.update(
        np.asarray(wids, np.int64).tolist()) or orig(wids))
    res = eng.topk(Q[:1], k=6, exclusion=M // 2, use_index=use_index)
    view.fetch = orig
    assert counts and max(counts.values()) == 1
    lin = SubseqEngine(_view(X, "sax", 1, index=False), verify="numpy",
                       batch_size=64).topk(Q[:1], k=6, exclusion=M // 2)
    np.testing.assert_array_equal(res.window_ids, lin.window_ids)
    np.testing.assert_array_equal(res.distances, lin.distances)
    Wz = view.fetch(np.arange(view.n))
    d = np.sqrt(np.sum(np.square(Wz - eng.normalize_queries(Q[:1])), -1))
    want = greedy_nonoverlap(np.argsort(d, kind="stable"),
                             view.windows_per_row, 1, 6, M // 2)
    np.testing.assert_array_equal(res.window_ids[0], want)


# -- the launcher --------------------------------------------------------------

def test_launcher_subseq_index_explain_dryrun(capsys):
    from repro_torch.launch.match import main
    main(["--subseq", "--dryrun", "--device", "cpu", "--index",
          "--explain"])
    out = capsys.readouterr().out
    assert "[subseq] window index: " in out and "over 372 windows" in out
    assert "index vs linear sweep: bitwise identical yes" in out
    assert ": 4/4 query frontiers == brute force" in out
    assert "== subseq.topk (k=8, queries=4, source=index" in out
    assert "== subseq.topk (k=8, queries=4, source=linear" in out
    assert "[metrics] subseq.modeled_io_s=" in out
    assert "[metrics] subseq.topk_latency_s: n=3" in out
    assert "query of appended row -> row 12 " in out


@pytest.mark.parametrize("flag", [["--ingest", "1"],
                                  ["--snapshot-dir", "snaps"]])
def test_launcher_subseq_rejects_whole_series_flags(flag):
    from repro_torch.launch.match import main
    with pytest.raises(SystemExit, match="whole-series"):
        main(["--subseq", "--dryrun", "--device", "cpu", *flag])


def test_window_index_on_card_equals_kernel_bruteforce(corpus):
    """On the card the window index's features go through K4 and its
    verification through K1 (one launch per round, the seed's included),
    and indexed window top-k equals the linear sweep and a K1 brute
    force over every window, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.match import make_subseq_engine, window_distances
    X, Q = corpus
    view, eng = make_subseq_engine("ssax", X, m=M, stride=3, L=L,
                                   device="cuda")
    n_paa = KERNELS["paa"].launches
    view.build_index(leaf_fill=LEAF_FILL)
    assert KERNELS["paa"].launches > n_paa
    n_k1, n_k2 = KERNELS["euclid"].launches, KERNELS["ssax_dist"].launches
    res = eng.topk(Q, k=5, use_index=True)
    assert KERNELS["euclid"].launches - n_k1 == res.rounds >= 2
    assert KERNELS["ssax_dist"].launches == n_k2
    lin = eng.topk(Q, k=5, use_index=False)
    np.testing.assert_array_equal(res.window_ids, lin.window_ids)
    np.testing.assert_array_equal(res.distances, lin.distances)
    d = window_distances(X, M, 3, eng.normalize_queries(Q), "cuda")
    want = np.argsort(d, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(res.window_ids, want)
    np.testing.assert_array_equal(
        res.distances, np.take_along_axis(d, want, 1).astype(np.float64))
