"""The port's matching service over a ``torch.distributed`` world of
ranks (``service.world.WorldChannel``: rank 0 serves, the others replay
its engine calls in order) on the CPU with gloo.

Spec: the reference's service tests (``tests/test_service.py``,
``tests/test_epochs.py``, ``tests/test_metrics_concurrent.py``,
``tests/test_selfjoin.py``), there on one process's devices, here over
worlds of R = 2 and 4 ranks at S = R.  One spawn per world size runs
every case in its ranks (``dist_service_workers.py``, JAX-free), and its
rank 0 runs the cases that do not depend on timing again alone on
``make_mesh(S, "cpu")``; the world's answers are held against those
bitwise, and every rank's hash of its engine calls' results and its
epoch ledger against rank 0's.  Exact answers are held against the JAX
package's ``MatchSession`` over its ``make_engine_service`` on a
one-device mesh (in a process of its own): ids equal, distances within
rtol 1e-5.  The launcher runs under ``torch.distributed.run`` on 2
ranks, with and without replicas, a writer and device verification.
The worlds, the launchers and the reference run at once, in one module
fixture.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dist_service_workers as W  # noqa: E402
from dist_match_workers import TECHS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
LAUNCHES = {"plain": [], "flags": ["--replicas", "2",
                                   "--ingest-while-serving", "--verify",
                                   "device"]}


def reference_answers(path: str) -> None:
    """The JAX package's session answers to the exact case (tiers
    "index" and "linear", every encoder, verify="numpy"), pickled into
    ``path``."""
    from repro.core import make_technique as ref_make
    from repro.core.distributed import make_engine_service as ref_service
    from repro.launch.mesh import make_mesh_compat
    from repro.obs import MetricsRegistry as RefRegistry
    from repro.service import MatchSession as RefSession
    from dist_match_workers import BATCH, L, T, TECH_KW
    mesh = make_mesh_compat((1,), ("data",))
    Q, D = W.season()
    out = {}
    for tech in TECHS:
        eng = ref_service(ref_make(tech, T=T, W=T // 20, L=L,
                                   **TECH_KW[tech]), D, mesh,
                          verify="numpy", batch_size=BATCH)
        eng.store.build_index(leaf_fill=12, max_bits=4)
        for tier in ("index", "linear"):
            sess = RefSession(eng, metrics=RefRegistry(), window_s=0.05,
                              max_batch=8)
            reqs = [sess.submit(q, k=W.K, tier=tier) for q in Q]
            sess.start()
            for r in reqs:
                r.wait(120)
            sess.close()
            out[tech, tier] = [(r.tier_served, np.asarray(r.indices),
                                np.asarray(r.distances)) for r in reqs]
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything this file compares, made at once: both worlds, the
    launcher on 2 ranks (with and without the flags) and in one process
    at S = 2, and the JAX package's answers in a process of its own."""
    import importlib.util
    d = tmp_path_factory.mktemp("svc")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1",
        JAX_PLATFORMS="cpu")
    base = ["-m", "repro_torch.launch.serve_match", "--device", "cpu",
            "--dryrun"]
    cmds = {(name, 2): [sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "2", *base,
                        *extra] for name, extra in LAUNCHES.items()}
    cmds["plain", 1] = [sys.executable, *base, "--shards-per-rank", "2"]
    if importlib.util.find_spec("jax") is not None:
        cmds["reference"] = [
            sys.executable, "-c", "import test_torch_dist_service as T; "
            f"T.reference_answers({str(d / 'reference.pkl')!r})"]
    procs = {k: subprocess.Popen(c, env=env, cwd=ROOT,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    out = {"worlds": {}, "launches": {}}
    ctxs = {}
    try:
        for world in WORLDS:
            (d / f"w{world}").mkdir()
            ctxs[world] = W.start(world, str(d / f"w{world}"))
        for world, ctx in ctxs.items():
            while not ctx.join():
                pass
            with open(d / f"w{world}" / f"world-{world}.pkl", "rb") as f:
                out["worlds"][world] = pickle.load(f)
        for key, p in procs.items():
            so, se = p.communicate(timeout=300)
            out["launches"][key] = (p.returncode, so, se)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for ctx in ctxs.values():     # a world that failed stops the other
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    rc, _, err = out["launches"].pop("reference", (None, "", ""))
    assert rc in (None, 0), err[-3000:]
    out["reference"] = None
    if rc == 0:
        with open(d / "reference.pkl", "rb") as f:
            out["reference"] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


def _equal(a, b, path="") -> None:
    """Bitwise equality of two answer trees."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=True), path
    else:
        assert a == b, path


def _case(worlds, world, name):
    """(answers, every rank's summary, the leader's channel stats)."""
    return worlds[world]["world"][name]


def _same_request(got: dict, want: dict) -> None:
    """A served request equals a direct answer's row (ids, distances)."""
    assert got["ok"], got.get("error")
    _equal(got["indices"], want["indices"])
    _equal(got["distances"], want["distances"])


#: what differs between two runs by their timing alone: replica
#: placement and the counters that follow from it
TIMING = ("replicas", "counters", "moved")


@pytest.mark.parametrize("name", sorted(set(W.CASES) - set(W.WORLD_ONLY)))
@pytest.mark.parametrize("world", WORLDS)
def test_world_equals_single_process_bitwise(worlds, world, name):
    """Every served answer over the world is the single process's at the
    same S, bit for bit (tiers, pins and sheds too)."""
    got, _, _ = _case(worlds, world, name)
    want = worlds[world]["single"][name]
    _equal({k: v for k, v in got.items() if k not in TIMING},
           {k: v for k, v in want.items() if k not in TIMING})


@pytest.mark.parametrize("name", sorted(set(W.CASES) - {"mismatch",
                                                         "refused"}))
@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_replays_rank_zeros_calls(worlds, world, name):
    """``close`` ended every follower, and every rank's op hash, op count
    and epoch ledger equal rank 0's."""
    _, every, _ = _case(worlds, world, name)
    assert [s["rank"] for s in every] == list(range(world))
    for s in every[1:]:
        assert (s["hash"], s["ops"], s["epochs"]) == \
            (every[0]["hash"], every[0]["ops"], every[0]["epochs"])
    assert every[0]["ops"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_exact_tiers_equal_the_oracle(worlds, world):
    """Both exact tiers, all four encoders, both verification routes,
    from three client threads: each answer is the direct ``topk``'s."""
    got, _, _ = _case(worlds, world, "exact")
    Q, D = W.season()
    for tech in TECHS:
        for v in ("device", "host"):
            key = f"{tech}/{v}"
            oracle = got[key + "/oracle"]
            jobs = [(tier, qi) for tier in ("index", "linear")
                    for qi in range(len(Q)) for _ in range(2)]
            assert len(got[key]) == len(jobs)
            for (tier, qi), r in zip(jobs, got[key]):
                assert r["tier"] == tier and r["epoch"] == len(D)
                _same_request(r, {f: oracle[tier][f][qi]
                                  for f in ("indices", "distances")})


@pytest.mark.parametrize("world", WORLDS)
def test_batch_neutrality_every_bucket(worlds, world):
    got, _, _ = _case(worlds, world, "neutral")
    for b in W.BUCKETS:
        assert got[b, "batches"] == W.N_NEUTRAL // b
        for alone, r in zip(got[1], got[b]):
            _same_request(r, alone)


@pytest.mark.parametrize("world", WORLDS)
def test_subseq_session_exact_tiers(worlds, world):
    got, _, _ = _case(worlds, world, "subseq")
    _, Q = W.windows()
    tiers = [tier for tier in ("index", "linear") for _ in Q]
    for i, (tier, r) in enumerate(zip(tiers, got["served"])):
        want = got["oracle"][tier]
        assert r["tier"] == tier
        _same_request(r, {f: want[f][i % len(Q)]
                          for f in ("indices", "distances")})
        assert r["rows"].shape == r["starts"].shape == (3,)


@pytest.mark.parametrize("world", WORLDS)
def test_selfjoin_tier(worlds, world):
    from repro_torch.profile import MatrixProfile, topk_discords, \
        topk_motifs
    from repro_torch.subseq import WindowView
    got, _, _ = _case(worlds, world, "selfjoin")
    X, _ = W.windows()
    view = WindowView(W.enc("ssax", 120), X[:3, :300], stride=4,
                      device="cpu")
    p = got["profile"]
    prof = MatrixProfile(distances=p["distances"], neighbors=p["neighbors"],
                         exclusion=p["exclusion"], source="stream", raw_accesses=None,
                         pruned_fraction=None, store_accesses=0,
                         store_fetches=0, io_seconds=0.0)
    motifs, discords = got["served"]
    assert motifs["tier"] == discords["tier"] == "selfjoin"
    assert motifs["result"] == topk_motifs(prof, view.locate, 2)
    assert discords["result"] == topk_discords(prof, view.locate, 2)
    assert motifs["epoch"] == view.n


@pytest.mark.parametrize("world", WORLDS)
def test_replicas_and_failover(worlds, world):
    """Two replicas, then one killed: nothing shed, every answer exact,
    the second wave all on the survivor."""
    got, _, _ = _case(worlds, world, "replicas")
    for wave in ("first", "second"):
        for i, r in enumerate(got[wave]):
            _same_request(r, {f: got["oracle"][f][i]
                              for f in ("indices", "distances")})
    assert set(got["replicas"][1]) == {0} and got["live"] == [0]
    assert got["counters"].get("serve.rejected", 0) == 0
    assert got["counters"]["serve.replica_killed"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_ingest_while_serving_exact_at_pins(worlds, world):
    """A writer ingests through the channel while two readers are
    served: every answer equals the single process's answer over a
    store frozen at its pin, and every rank ends on the same ledger."""
    from repro_torch.core.distributed import make_mesh
    got, every, _ = _case(worlds, world, "ingest")
    Q, D = W.season()
    assert got["served"] and got["n"] == got["index_n"] == len(D)
    frozen = {}
    for tier, qi, r in got["served"]:
        assert r["ok"], r.get("error")
        n_e = r["epoch"]
        assert 40 <= n_e <= len(D) and r["tier"] == tier
        if n_e not in frozen:
            eng = W._service(W.enc("ssax"), make_mesh(world, "cpu"),
                             W._store("ssax", D[:n_e]), "device")
            frozen[n_e] = eng.topk(Q, k=W.K)
        _same_request(r, {f: getattr(frozen[n_e], f)[qi]
                          for f in ("indices", "distances")})
    assert len({r["epoch"] for _, _, r in got["served"]}) >= 2
    assert all(s["epochs"] == every[0]["epochs"] for s in every)
    assert every[0]["epochs"][0][1] == len(D)


@pytest.mark.parametrize("world", WORLDS)
def test_deadline_wave_downgrades_with_error_bars(worlds, world):
    """5 s budgets against 10 s exact tiers downgrade to the anytime
    tier with an error bar; the answers are the single process's
    ``topk_approx`` of the same batch at the same pin and collect; the
    expired request is shed ``deadline_expired``."""
    got, _, _ = _case(worlds, world, "deadline")
    want = worlds[world]["single"]["deadline"]["direct"]
    served, shed = got["served"][:-1], got["served"][-1]
    assert got["downgraded"][:-1] == [True] * len(served)
    for i, r in enumerate(served):
        assert r["tier"] == "approx" and r["error_bar"] >= 0.0
        _same_request(r, {f: want[f][i] for f in ("indices", "distances")})
        assert r["error_bar"] == want["error_bar"][i]
        assert r["kth_lb"] <= got["exact"]["distances"][i, -1] + 1e-5
    assert not shed["ok"] and shed["shed"] == "deadline_expired"


@pytest.mark.parametrize("world", WORLDS)
def test_engine_error_on_every_rank(worlds, world):
    """An engine that raises at one op on every rank: its request is
    resolved with the error, the next op is exact, and every rank
    counted the one error."""
    got, every, _ = _case(worlds, world, "error")
    assert not got["bad"]["ok"] and got["bad"]["shed"] == "engine_error"
    assert "injected engine failure" in got["bad"]["error"]
    _same_request(got["good"], {f: got["oracle"][f][0]
                                for f in ("indices", "distances")})
    assert [s["errors"] for s in every] == [1] * world


@pytest.mark.parametrize("world", WORLDS)
def test_idle_leader_outlives_the_group_timeout(worlds, world):
    got, every, stats = _case(worlds, world, "idle")
    assert W.IDLE["sleep_s"] > W.IDLE["timeout_s"]
    assert all(r["ok"] for r in got["served"])
    assert stats["keepalives"] >= W.IDLE["sleep_s"] / W.IDLE["timeout_s"]
    assert len(every) == world


@pytest.mark.parametrize("world", WORLDS)
def test_a_rank_that_differs_raises(worlds, world):
    """The last rank's engine answers differently: its ``follow`` raises
    at close, and rank 0 sees only its hash differ."""
    got, every, _ = _case(worlds, world, "mismatch")
    assert "answer" in got
    assert [s["hash"] == every[0]["hash"] for s in every] == \
        [True] * (world - 1) + [False]


@pytest.mark.parametrize("world", WORLDS)
def test_raw_world_engine_is_refused(worlds, world):
    got, _, _ = _case(worlds, world, "refused")
    assert got.startswith("refused: ") and "WorldChannel" in got


@pytest.mark.parametrize("other", [{"a": 1}, torch.zeros(2), object()])
def test_op_hash_refuses_a_result_it_cannot_see_into(other):
    """A result type the op hash does not know raises instead of hashing
    as a constant that would pass a diverged world."""
    import hashlib
    from repro_torch.service.world import _digest
    with pytest.raises(TypeError, match=type(other).__name__):
        _digest(hashlib.sha256(), other)


def test_op_hash_sees_the_index_that_build_index_returns():
    import hashlib
    from repro_torch.service.world import _digest
    _, rows = W.season()
    hashes = []
    for n in (len(rows) - 8, len(rows) - 8, len(rows)):
        h = hashlib.sha256()
        _digest(h, W._store("ssax", rows[:n]).build_index(leaf_fill=8,
                                                          max_bits=4))
        hashes.append(h.hexdigest())
    assert hashes[0] == hashes[1] != hashes[2]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(runs):
    if runs["reference"] is None:
        pytest.skip("the JAX package needs jax")
    return runs["reference"]


@pytest.mark.parametrize("tech", TECHS)
def test_exact_answers_match_the_reference(worlds, reference, tech):
    for world in WORLDS:
        got, _, _ = _case(worlds, world, "exact")
        served = got[f"{tech}/device"]
        for t, tier in enumerate(("index", "linear")):
            for qi, (rtier, ids, dists) in enumerate(reference[tech, tier]):
                r = served[t * 2 * len(reference[tech, tier]) + 2 * qi]
                assert r["tier"] == rtier == tier
                np.testing.assert_array_equal(r["indices"], ids)
                np.testing.assert_allclose(r["distances"], dists, rtol=1e-5)


# ---------------------------------------------------------------------------
# the launcher under torch.distributed.run
# ---------------------------------------------------------------------------

def _answers_line(stdout: str) -> str:
    return [ln for ln in stdout.splitlines()
            if ln.startswith("[answers]")][-1]


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launcher_under_torch_distributed_run(runs, name):
    rc, out, err = runs["launches"][name, 2]
    assert rc == 0, err[-3000:]
    assert "exact-tier bit-identity vs direct topk: 16/16" in out, out
    assert "wave 1: 16/16 served" in out
    line = _answers_line(out)
    assert line.endswith("2 ranks: op hashes and epochs equal on every "
                         "rank yes"), line
    assert "[world] 2 ranks:" in out
    if name == "plain":
        rc1, out1, err1 = runs["launches"]["plain", 1]
        assert rc1 == 0, err1[-3000:]
        # the world's answers hash equal to one process's at the same S
        assert line.split(";")[0] == _answers_line(out1)
    else:
        assert "ingest:" in out and "answers pinned across" in out
