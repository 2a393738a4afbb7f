"""The slice end to end: the port's ``MatchEngine`` against the JAX
package's, and against its own brute force, on the CPU (T=480, W=24,
L=10, N=500).

Against the reference: exact ids AND distances are bitwise equal under
``verify="numpy"`` (the same numpy host verifier; only the visit order
may differ), and approximate ids are equal on this data.  Within the
port: every verify mode's exact answer equals the port's own brute
force.  The card test (skipped without one) holds the sSAX engine on
the card to a K1 brute force bitwise."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    from_reference, make_technique, rep_from_numpy)
from repro_torch.core.engine import (  # noqa: E402
    MatchEngine, kernel_verifier, merge_topk_device, merge_topk_numpy,
    topk_verify)
from repro_torch.core.matching import (  # noqa: E402
    RawStore, approximate_match, exact_match, pruning_power,
    tightness_of_lower_bound)
from repro_torch.data.synthetic import (  # noqa: E402
    season_dataset, trend_dataset)
from repro_torch.kernels import KERNELS, ops  # noqa: E402
from repro_torch.launch.match import kernel_bruteforce  # noqa: E402

T, W, L, N, NQ = 480, 24, 10, 500, 6
TECHS = ("sax", "ssax", "tsax", "stsax")


@pytest.fixture(scope="module")
def corpora():
    return {"season": season_dataset(N + NQ, T, L, 0.7, seed=11),
            "trend": trend_dataset(N + NQ, T, 0.6, seed=7)}


def _data(corpora, tech):
    X = corpora["trend" if tech == "tsax" else "season"]
    return X[:NQ], X[NQ:]


def _bruteforce(Q, D, k):
    """Stable numpy scan, ties broken by lower index."""
    idx, dist = [], []
    for q in Q:
        d = np.sqrt(np.sum((D - q[None]) ** 2, axis=-1))
        o = np.argsort(d, kind="stable")[:k]
        idx.append(o)
        dist.append(d[o])
    return np.asarray(idx, np.int64), np.asarray(dist)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's engine answers, computed once per technique."""
    pytest.importorskip("jax")
    from repro.core import make_technique as ref_make_technique
    from repro.core import MatchEngine as RefEngine
    from repro.core.matching import RawStore as RefStore
    cache = {}

    def get(corpora, tech):
        if tech not in cache:
            Q, D = _data(corpora, tech)
            enc = ref_make_technique(tech, T=T, W=W, L=L, r2_season=0.7)
            eng = RefEngine(enc, RefStore.ssd(D), verify="numpy")
            cache[tech] = dict(
                enc=enc, rep=eng.rep, rd=eng.repr_distances(Q),
                exact={k: eng.topk(Q, k=k) for k in (1, 32)},
                approx=eng.topk(Q, k=4, exact=False))
        return cache[tech]
    return get


@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("tech", TECHS)
def test_exact_numpy_bitwise_equals_reference(corpora, reference, tech, k):
    Q, D = _data(corpora, tech)
    want = reference(corpora, tech)["exact"][k]
    eng = MatchEngine(make_technique(tech, T=T, W=W, L=L, r2_season=0.7),
                      RawStore.ssd(D), verify="numpy", device="cpu")
    res = eng.topk(Q, k=k)
    np.testing.assert_array_equal(res.indices, want.indices)
    np.testing.assert_array_equal(res.distances, want.distances)
    np.testing.assert_array_equal(res.raw_accesses, want.raw_accesses)


@pytest.mark.parametrize("verify", ["numpy", "auto", "kernel", "host"])
@pytest.mark.parametrize("tech", TECHS)
def test_exact_every_verify_mode_equals_bruteforce(corpora, tech, verify):
    Q, D = _data(corpora, tech)
    eng = MatchEngine(make_technique(tech, T=T, W=W, L=L, r2_season=0.7),
                      RawStore.ssd(D), verify=verify, batch_size=32,
                      device="cpu")
    res = eng.topk(Q, k=32)
    want_i, want_d = _bruteforce(Q, D, 32)
    np.testing.assert_array_equal(res.indices, want_i)
    if verify in ("numpy", "auto"):                # auto is numpy on a CPU
        np.testing.assert_array_equal(res.distances, want_d)
    else:                                          # K1's plain version
        bf_i, bf_d = kernel_bruteforce(Q, D, 32, "cpu")
        np.testing.assert_array_equal(res.indices, bf_i)
        np.testing.assert_array_equal(res.distances, bf_d)


@pytest.mark.parametrize("tech", TECHS)
def test_approximate_ids_equal_reference(corpora, reference, tech):
    Q, D = _data(corpora, tech)
    want = reference(corpora, tech)["approx"]
    eng = MatchEngine(make_technique(tech, T=T, W=W, L=L, r2_season=0.7),
                      RawStore.ssd(D), verify="numpy", device="cpu")
    res = eng.topk(Q, k=4, exact=False)
    np.testing.assert_array_equal(res.indices, want.indices)
    np.testing.assert_allclose(res.distances, want.distances, rtol=1e-5)


@pytest.mark.parametrize("tech", ["sax", "ssax"])
def test_make_pairwise_matches_plain_sweep(corpora, tech):
    Q, D = _data(corpora, tech)
    enc = make_technique(tech, T=T, W=W, L=L, r2_season=0.7)
    rep = enc.encode(torch.from_numpy(D))
    rq = enc.encode(torch.from_numpy(Q))
    pw = ops.make_pairwise(enc)
    np.testing.assert_allclose(pw(rq, rep).numpy(),
                               enc.pairwise_distance(rq, rep).numpy(),
                               rtol=1e-5, atol=1e-5)
    plain = MatchEngine(enc, RawStore.ssd(D), verify="numpy", device="cpu")
    swept = MatchEngine(enc, RawStore.ssd(D), verify="numpy", pairwise=pw,
                        device="cpu")
    for k in (1, 32):
        a, b = plain.topk(Q, k=k), swept.topk(Q, k=k)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.distances, b.distances)


def test_make_pairwise_ssax_one_batch_call_per_sweep(corpora, monkeypatch):
    """The sSAX sweep makes one batched K2 call for all queries, and its
    (Q, N) bounds equal the per-query route (one K2 call per query's
    tables, then scale and square root) bitwise."""
    Q, D = _data(corpora, "ssax")
    enc = make_technique("ssax", T=T, W=W, L=L, r2_season=0.7)
    rep = enc.encode(torch.from_numpy(D))
    rq = enc.encode(torch.from_numpy(Q))
    calls = []
    batch = ops.ssax_dist_batch

    def counting(*args):
        calls.append(args[2].shape)
        return batch(*args)
    monkeypatch.setattr(ops, "ssax_dist_batch", counting)
    pw = ops.make_pairwise(enc)
    got = pw(rq, rep)
    assert calls == [(NQ, L, len(enc.b_seas) + 1)]
    scale = np.sqrt(T / (W * L))
    want = torch.stack([scale * torch.sqrt(ops.ssax_dist(
        *rep, *ops.make_ssax_query_tables(s, w, enc.b_seas, enc.b_res)))
        for s, w in zip(*rq)])
    assert got.shape == (NQ, N) and torch.equal(got, want)
    eng = MatchEngine(enc, RawStore.ssd(D), verify="numpy", pairwise=pw,
                      device="cpu")
    calls.clear()
    eng.topk(Q, k=8)
    assert len(calls) == 1


def test_make_pairwise_keeps_plain_sweep_without_kernel():
    for tech in ("tsax", "stsax"):
        enc = make_technique(tech, T=T, W=W, L=L)
        assert ops.make_pairwise(enc) == enc.pairwise_distance


@pytest.mark.parametrize("tech", TECHS)
def test_from_reference_rep_carry_across(corpora, reference, tech):
    """An engine built from the reference's encoder fields and encoded
    representation sweeps like the reference and answers bitwise."""
    Q, D = _data(corpora, tech)
    r = reference(corpora, tech)
    enc = from_reference(type(r["enc"]).__name__,
                         dataclasses.asdict(r["enc"]))
    rep = r["rep"]
    rep = rep_from_numpy(tuple(np.asarray(a) for a in rep)
                         if isinstance(rep, tuple) else np.asarray(rep),
                         "cpu")
    eng = MatchEngine(enc, RawStore.ssd(D), verify="numpy", rep=rep,
                      pairwise=ops.make_pairwise(enc), device="cpu")
    np.testing.assert_allclose(eng.repr_distances(Q), np.asarray(r["rd"]),
                               rtol=1e-5, atol=1e-5)
    res = eng.topk(Q, k=32)
    np.testing.assert_array_equal(res.indices, r["exact"][32].indices)
    np.testing.assert_array_equal(res.distances, r["exact"][32].distances)


def test_batch_size_and_epoch_invariance(corpora):
    Q, D = _data(corpora, "ssax")
    enc = make_technique("ssax", T=T, W=W, L=L)
    eng = MatchEngine(enc, RawStore.ssd(D), verify="numpy", device="cpu")
    base = eng.topk(Q, k=8)
    assert (base.raw_accesses < N).all()           # the bound prunes
    for b in (1, 7, 500):
        res = eng.topk(Q, k=8, batch_size=b)
        np.testing.assert_array_equal(res.indices, base.indices)
        np.testing.assert_array_equal(res.distances, base.distances)
    pinned = eng.topk(Q, k=8, epoch=300)
    frozen = MatchEngine(enc, RawStore.ssd(D[:300]), verify="numpy",
                         device="cpu").topk(Q, k=8)
    np.testing.assert_array_equal(pinned.indices, frozen.indices)
    np.testing.assert_array_equal(pinned.distances, frozen.distances)


def test_device_merge_tie_break_matches_numpy():
    rng = np.random.default_rng(0)
    d = rng.integers(0, 4, size=(3, 40)).astype(np.float64)  # many ties
    i = rng.permutation(120).reshape(3, 40).astype(np.int64)
    i[0, :5] = -1
    d[0, :5] = np.inf
    nd, ni = merge_topk_numpy(d, i, 10)
    dd, di = merge_topk_device(d, i, 10, device="cpu")
    np.testing.assert_array_equal(ni, di)
    np.testing.assert_array_equal(nd.astype(np.float32), dd)


def test_device_merge_engine_on_duplicated_rows(corpora):
    Q, D = _data(corpora, "sax")
    D = np.concatenate([D[:100], D[:100]])          # exact duplicate rows
    enc = make_technique("sax", T=T, W=W)
    a = MatchEngine(enc, RawStore.ssd(D), verify="numpy", device="cpu")
    b = MatchEngine(enc, RawStore.ssd(D), verify="numpy", device_merge=True,
                    device="cpu")
    ra, rb = a.topk(Q, k=16), b.topk(Q, k=16)
    np.testing.assert_array_equal(ra.indices, rb.indices)
    np.testing.assert_array_equal(ra.distances, rb.distances)
    # each distance appears twice; the smaller dataset index wins the tie
    assert (ra.indices[:, 1::2] == ra.indices[:, ::2] + 100).all()


def test_topk_verify_seeded_never_reverifies_inf_columns():
    rng = np.random.default_rng(1)
    D = rng.normal(size=(50, 16)).astype(np.float32)
    q = rng.normal(size=(16,)).astype(np.float32)
    d = np.sqrt(((D - q) ** 2).sum(-1))
    lb = d * 0.5
    seed = np.argsort(d, kind="stable")[:3]
    lb[seed] = np.inf
    seen = []
    res = topk_verify(q, lb, RawStore.ssd(D), k=5, batch_size=4,
                      init_d=d[seed][None], init_i=seed[None],
                      on_verified=lambda qi, ids, ds: seen.extend(ids))
    np.testing.assert_array_equal(res.indices[0],
                                  np.argsort(d, kind="stable")[:5])
    assert not set(seen) & set(seed.tolist())
    assert res.raw_accesses[0] == len(seen) == 47     # all but the seeds


def test_matching_helpers(corpora):
    Q, D = _data(corpora, "ssax")
    enc = make_technique("ssax", T=T, W=W, L=L)
    rep = enc.encode(torch.from_numpy(D))
    rd = enc.pairwise_distance(enc.encode(torch.from_numpy(Q[:1])),
                               rep).numpy()[0]
    store = RawStore.ssd(D)
    want_i, want_d = _bruteforce(Q[:1], D, 1)
    m = exact_match(Q[0], rd, store)
    assert m.index == want_i[0, 0] and m.distance == want_d[0, 0]
    a = approximate_match(Q[0], rd, store)
    assert 0 <= a.index < N and a.raw_accesses >= 1
    true = np.sqrt(((D - Q[0]) ** 2).sum(-1))
    assert 0.0 <= pruning_power(Q[0], rd, D) <= 1.0
    assert 0.0 < tightness_of_lower_bound(rd, true) <= 1.0 + 1e-6
    store.reset()
    assert store.fetch([]).shape == (0, T) and store.fetches == 0


def test_engine_rejects_unported_paths(corpora):
    Q, D = _data(corpora, "sax")
    enc = make_technique("sax", T=T, W=W)
    with pytest.raises(ValueError):
        MatchEngine(enc, RawStore.ssd(D), verify="device", device="cpu")
    eng = MatchEngine(enc, RawStore.ssd(D), device="cpu")
    with pytest.raises(ValueError):
        eng.topk(Q, k=1, source="index")
    # with a stream factory the index source is device-ordered
    # (core/distributed.py, ported): bitwise the host-ordered answer
    from repro_torch.store import SymbolicStore
    store = SymbolicStore.from_rows(enc, D[:40], device="cpu")
    store.build_index(leaf_fill=16)
    streamed = MatchEngine(enc, store, stream_factory=lambda q: None,
                           device="cpu")
    got = streamed.topk(Q, k=1, source="index")
    want = MatchEngine(enc, store, device="cpu").topk(Q, k=1,
                                                       source="index")
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.distances, want.distances)


def test_launcher_dryrun_on_cpu(capsys):
    from repro_torch.launch.match import main
    main(["--dryrun", "--device", "cpu", "--technique", "ssax"])
    out = capsys.readouterr().out
    assert "exact k=1: 4/4 query frontiers == brute force" in out
    assert "exact k=8: 4/4 query frontiers == brute force" in out


@pytest.mark.parametrize("U,Qa,B", [(700, 8, 256), (3, 2, 5), (1, 1, 1)])
def test_kernel_verifier_cpu_equals_per_query_route(U, Qa, B):
    """One gathered K1 call per round gives bitwise what one K1 call per
    active query over its own gathered rows gave."""
    rng = np.random.default_rng(U)
    rows = rng.normal(size=(U, T)).astype(np.float32)
    qs = rng.normal(size=(Qa, T)).astype(np.float32)
    g = rng.integers(0, U, size=(Qa, B)).astype(np.int64)
    got = kernel_verifier(rows, qs, g, device="cpu")
    rt, qt = torch.from_numpy(rows), torch.from_numpy(qs)
    want = np.sqrt(np.maximum(torch.stack([
        ops.euclid_batch(rt[torch.from_numpy(g[r])], qt[r])
        for r in range(Qa)]).numpy(), 0.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tech", TECHS)
def test_kernel_verify_counts_one_round_per_fetch(corpora, tech):
    """Whole series: every verification round is one store fetch and one
    verifier call, and the exact answer equals the numpy brute force."""
    Q, D = _data(corpora, tech)
    calls = []

    def counting(rows, qs, gather):
        calls.append(gather.shape)
        return kernel_verifier(rows, qs, gather, device="cpu")
    eng = MatchEngine(make_technique(tech, T=T, W=W, L=L, r2_season=0.7),
                      RawStore.ssd(D), verify="kernel", batch_size=32,
                      device="cpu")
    eng.verifier = counting
    res = eng.topk(Q, k=8)
    assert res.rounds == res.store_fetches == len(calls) > 0
    want_i, _ = _bruteforce(Q, D, 8)
    np.testing.assert_array_equal(res.indices, want_i)


def test_engine_on_card_equals_kernel_bruteforce(corpora):
    """On the card every kernel of the path launches, and the exact
    answer equals a K1 brute force bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    Q, D = _data(corpora, "ssax")
    from repro_torch.launch.match import make_engine
    before = {n: k.launches for n, k in KERNELS.items()}
    eng = make_engine("ssax", np.ascontiguousarray(D[:, :480]), device="cuda")
    res = eng.topk(Q, k=32)
    after = {n: k.launches for n, k in KERNELS.items()}
    for name in ("paa", "ssax_dist", "euclid"):
        assert after[name] > before[name], name
    # one gathered K1 launch per verification round, one fetch per round
    n0 = KERNELS["euclid"].launches
    again = eng.topk(Q, k=32)
    assert KERNELS["euclid"].launches - n0 == again.rounds \
        == again.store_fetches > 0
    bf_i, bf_d = kernel_bruteforce(Q, D, 32, "cuda")
    np.testing.assert_array_equal(res.indices, bf_i)
    np.testing.assert_array_equal(res.distances, bf_d)


def test_engine_on_card_one_k2_launch_per_sweep(corpora):
    """On the card an sSAX topk call sweeps all its queries through one
    K2 launch, and answers as the K1 brute force does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    Q, D = _data(corpora, "ssax")
    from repro_torch.launch.match import make_engine
    eng = make_engine("ssax", D, device="cuda")
    n0 = KERNELS["ssax_dist"].launches
    res = eng.topk(Q, k=8)
    assert KERNELS["ssax_dist"].launches - n0 == 1
    bf_i, bf_d = kernel_bruteforce(Q, D, 8, "cuda")
    np.testing.assert_array_equal(res.indices, bf_i)
    np.testing.assert_array_equal(res.distances, bf_d)
