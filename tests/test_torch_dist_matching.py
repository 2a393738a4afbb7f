"""The port's matching over a ``torch.distributed`` world of ranks
(``core.distributed.make_mesh(S, "cpu", group=)``) on the CPU with gloo.

Spec: the reference's ``tests/test_distributed.py`` (sharded encode and
``repr_topk_sharded``, the engine service under ingest) and
``tests/test_sharded_verify.py`` (device verification equal to host
verification for every encoder, ingest, each row encoded once, a
snapshot reopened into the mirrors, the sharded index build, window
verification), there over placeholder devices of one process, here over
worlds of R = 2 and R = 4 ranks with 1 and 2 shards per rank (S = R and
2R).  One spawn per world size runs every case in its ranks
(``dist_match_workers.py``, JAX-free), and its rank 0 runs the same case
functions again alone on ``make_mesh(S, "cpu")``; the world's answers
are held against those bitwise: ids, distances, rounds, rows verified,
pruned fraction and store fetches.  Each rank holds only its
own shards: its uploads are its owned rows' bytes, and they sum to the
single process's.  Exact answers are also held against the JAX package's
``make_engine_service`` on a one-device mesh (in a process of its own):
ids equal, distances within rtol 1e-5 (the frameworks' encoders differ
in the last bits).  The launcher runs under ``torch.distributed.run``
with 2 ranks on all three paths, and its answers hash equal to a single
process's at the same S.  The worlds, the launchers and the reference
run at once, in one module fixture.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dist_match_workers as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
SPR = W.SPR


LAUNCHES = {"series": [], "subseq": ["--subseq", "--verify", "device"],
            "selfjoin": ["--selfjoin", "--verify", "device"]}
EXPECT = {"series": "query frontiers == brute force",
          "subseq": "query frontiers == brute force",
          "selfjoin": "bitwise == oracle yes"}


def reference_answers(part: str, path: str) -> None:
    """The JAX package's answers to the exact (``part="exact"``) or the
    window cases on a one-device mesh (verify="numpy"), pickled into
    ``path``; each part runs in a process of its own beside the
    worlds."""
    from repro.core import make_technique as ref_make
    from repro.core.distributed import make_engine_service as ref_service
    from repro.launch.mesh import make_mesh_compat
    from repro.subseq import SubseqEngine as RefEngine
    from repro.subseq import WindowView as RefView
    out = {}
    if part == "exact":
        mesh = make_mesh_compat((1,), ("data",))
        Q, D = W.season()
        for tech in W.TECHS:
            enc = ref_make(tech, T=W.T, W=W.T // 20, L=W.L,
                           **W.TECH_KW[tech])
            r = ref_service(enc, D, mesh, verify="numpy",
                            batch_size=W.BATCH).topk(Q, k=5)
            out["exact", tech] = (np.asarray(r.indices),
                                  np.asarray(r.distances))
    else:
        X, Q = W.windows()
        m = W.WIN["m"]
        enc = ref_make("ssax", T=m, W=m // 20, L=W.L, **W.TECH_KW["ssax"])
        engines = {}
        for stride, excl in W.WINDOW_CASES:
            if stride not in engines:
                engines[stride] = RefEngine(RefView(enc, X, stride=stride),
                                            verify="numpy")
            r = engines[stride].topk(Q, k=W.WIN["ks"], exclusion=excl)
            out["windows", stride, excl] = (np.asarray(r.window_ids),
                                            np.asarray(r.distances))
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything this file compares, made at once: both worlds (one
    spawn per world size, whose rank 0 also answers every case alone),
    the launcher on all three paths on 2 ranks and in one process at
    S = 2, and the JAX package's answers in a process of its own."""
    import importlib.util
    d = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1")
    procs = {}
    base = ["-m", "repro_torch.launch.match", "--device", "cpu", "--dryrun"]
    for name, extra in LAUNCHES.items():
        procs[name, 2] = [sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", "2", *base,
                          *extra]
        procs[name, 1] = [sys.executable, *base, "--shards-per-rank", "2",
                          *extra]
    refs = ("exact", "windows")
    if importlib.util.find_spec("jax") is not None:
        for part in refs:
            procs[part] = [
                sys.executable, "-c", "import test_torch_dist_matching as "
                f"T; T.reference_answers({part!r}, "
                f"{str(d / (part + '.pkl'))!r})"]
    procs = {k: subprocess.Popen(c, env=dict(env, JAX_PLATFORMS="cpu"),
                                 cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in procs.items()}
    out = {"worlds": {}, "launches": {}}
    try:
        ctxs = {}
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
    out["reference"] = None
    for part in refs:
        rc, _, err = out["launches"].pop(part, (None, "", ""))
        assert rc in (None, 0), err[-3000:]
        if rc == 0:
            with open(d / (part + ".pkl"), "rb") as f:
                out["reference"] = {**(out["reference"] or {}),
                                    **pickle.load(f)}
    return out


@pytest.fixture(scope="module")
def worlds(runs):
    return runs["worlds"]


@pytest.fixture(scope="module")
def single(runs):
    """``single(S, name)``: the case run alone on ``make_mesh(S, "cpu")``
    by the rank 0 of the world that has S shards."""
    def get(S, name):
        for world, got in runs["worlds"].items():
            for spr in SPR:
                if world * spr == S:
                    return got["single"][spr, name]
        raise KeyError(S)
    return get


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


def _world_case(worlds, single, world, spr, name):
    got = worlds[world]["answers"][spr, name]
    return got, single(world * spr, name)


PARAMS = [(w, s) for w in WORLDS for s in SPR]
IDS = [f"R{w}-S{w * s}" for w, s in PARAMS]


def _shared(name, ans):
    return W._shared({(0, name): ans})[0, name]


@pytest.mark.parametrize("name", sorted(set(W.CASES) - {"service"}))
@pytest.mark.parametrize("world,spr", PARAMS, ids=IDS)
def test_world_equals_single_process_bitwise(worlds, single, world, spr,
                                             name):
    """Every case's answers over the world are the single process's at
    the same S, bit for bit (the per-rank uploads aside; the service
    case differs by design)."""
    got, want = _world_case(worlds, single, world, spr, name)
    _equal(_shared(name, got), _shared(name, want))


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_gives_rank_zeros_answers(worlds, world):
    hashes = [h for h, _ in worlds[world]["ranks"]]
    assert len(hashes) == world and len(set(hashes)) == 1


@pytest.mark.parametrize("world,spr", PARAMS, ids=IDS)
def test_exact_answers_and_transfers(worlds, single, world, spr):
    """Exact top-k over the world: K1 distances from the device route
    equal the host route's, no raw row reaches the host on the device
    route, no candidate order on either, for every encoder."""
    got, _ = _world_case(worlds, single, world, spr, "exact")
    S = world * spr
    for tech in W.TECHS:
        dev, host = got[f"{tech}/device"], got[f"{tech}/host"]
        _equal(dev["indices"], host["indices"])
        _equal(dev["distances"], host["distances"])
        assert dev["store_accesses"] == dev["store_fetches"] == 0
        assert host["store_accesses"] > 0
        for v in ("device", "host"):
            t = got[f"{tech}/{v}/transfers"]
            assert t["host_order"] == 0 and t["head"] == (W.N // S) * S
            if v == "device":
                assert t["rows_to_host"] == 0


def _row_bytes(tech, raw: bool) -> int:
    from repro_torch.store import SymbolicStore
    _, D = W.season()
    st = SymbolicStore.from_rows(W.enc(tech), D[:1], device="cpu")
    rep = sum(np.asarray(l).nbytes for l in st.rep_view())
    return rep + (D[:1].nbytes if raw else 0)


@pytest.mark.parametrize("world,spr", PARAMS, ids=IDS)
def test_each_rank_uploads_only_its_own_rows(worlds, single, world, spr):
    """A rank's head uploads are the bytes of the head rows of its own
    shards; over the ranks they sum to the single process's uploads."""
    S = world * spr
    head = (W.N // S) * S
    ranks = [counts for _, counts in worlds[world]["ranks"]]
    one = single(S, "exact")
    for tech in W.TECHS:
        for v in ("device", "host"):
            key = (spr, f"{tech}/{v}/transfers")
            per_row = _row_bytes(tech, raw=v == "device")
            for r, counts in enumerate(ranks):
                mine = sum(1 for i in range(head)
                           if i % S in range(r * spr, (r + 1) * spr))
                assert counts[key][0] == mine * per_row, (tech, v, r)
            assert sum(c[key][0] for c in ranks) == \
                one[f"{tech}/{v}/transfers"]["h2d"]
            assert sum(c[key][1] for c in ranks) == \
                one[f"{tech}/{v}/transfers"]["tail_h2d"]
    for v in ("device", "host"):
        assert sum(c[spr, "ingest/" + v] for c in ranks) == \
            single(S, "ingest")[v]["h2d"]


@pytest.mark.parametrize("world,spr", PARAMS, ids=IDS)
def test_ingest_encodes_each_row_once_and_pins(worlds, single, world, spr):
    got, _ = _world_case(worlds, single, world, spr, "ingest")
    from repro_torch.store import SymbolicStore
    Q, D = W.season()
    one = SymbolicStore.from_rows(W.enc("ssax"), np.concatenate([D, Q]),
                                  device="cpu")
    for v in ("device", "host"):
        g = got[v]
        assert g["encoded"] == [37, 61, 3]
        _equal(g["rep"], [np.asarray(l) for l in one.rep_view()])
        _equal(g["pinned"]["indices"], g["frozen"]["indices"])
        _equal(g["pinned"]["distances"], g["frozen"]["distances"])
        np.testing.assert_array_equal(
            g["answers"][5]["indices"][:, 0], g["ids"])
        np.testing.assert_array_equal(
            g["answers"][6]["indices"][:, 0], g["ids"])


@pytest.mark.parametrize("world,spr", PARAMS, ids=IDS)
def test_index_build_and_windows_hold(worlds, single, world, spr):
    """The sharded index equals a host-built one; indexed answers equal
    the linear ones, with no candidate order on the host; windows are
    verified without moving a source row."""
    idx, _ = _world_case(worlds, single, world, spr, "index")
    ex, _ = _world_case(worlds, single, world, spr, "exact")
    from repro_torch.index import SeriesIndex
    from repro_torch.store import SymbolicStore
    _, D = W.season()
    for tech in W.TECHS:
        ref = SeriesIndex.from_store(
            SymbolicStore.from_rows(W.enc(tech), D, device="cpu"),
            leaf_fill=12, max_bits=4)
        assert idx[tech]["nodes"] == ref.n_nodes
        assert idx[tech]["leaves"] == ref.tree.leaf_membership()
        _equal(idx[tech]["answer"]["indices"],
               ex[f"{tech}/device"]["indices"])
        _equal(idx[tech]["answer"]["distances"],
               ex[f"{tech}/device"]["distances"])
        assert idx[tech]["answer"]["store_accesses"] == 0
        assert idx[tech]["host_order"] == 0
    win, _ = _world_case(worlds, single, world, spr, "windows")
    for case in W.WINDOW_CASES:
        assert win[case]["rows_to_host"] == 0
        if not case[1]:
            assert win[case]["host_order"] == 0
    _equal(win["indexed"]["window_ids"], win["indexed/linear"]["window_ids"])
    _equal(win["indexed"]["distances"], win["indexed/linear"]["distances"])


@pytest.mark.parametrize("world,spr", PARAMS, ids=IDS)
def test_selfjoin_profile_equals_scan(worlds, single, world, spr):
    got, _ = _world_case(worlds, single, world, spr, "selfjoin")
    for v in ("device", "host"):
        assert got[v]["source"] == "stream"
        _equal(got[v]["distances"], got["scan"]["distances"])
        _equal(got[v]["neighbors"], got["scan"]["neighbors"])


@pytest.mark.parametrize("world,spr", PARAMS, ids=IDS)
def test_merge_on_tied_bounds_is_the_stable_order(worlds, single, world,
                                                  spr):
    got, _ = _world_case(worlds, single, world, spr, "merge")
    b = W.tied_bounds()
    for qi in range(b.shape[0]):
        fin = np.isfinite(b[qi])
        want = np.argsort(b[qi], kind="stable")[:fin.sum()]
        assert got["order"][qi] == want.tolist(), qi
    np.testing.assert_array_equal(got["n_finite"],
                                  np.isfinite(b).sum(axis=1))


@pytest.mark.parametrize("world,spr", PARAMS, ids=IDS)
def test_service_and_mesh_refusals(worlds, single, world, spr):
    """No fallback hides a rank: the service refuses a raw engine over a
    world mesh (it names the leader's front to serve instead), and a
    world mesh refuses a CUDA device on a gloo group and a shard count
    that does not split over the ranks."""
    got, want = _world_case(worlds, single, world, spr, "service")
    assert got["service"].startswith("refused: ") and \
        "WorldChannel" in got["service"]
    assert want == {"service": "accepted"}
    assert "needs a nccl process group" in got["cuda_on_gloo"]
    assert "not a multiple of the world size" in got["not_a_multiple"]


def test_world_mesh_needs_an_initialized_group():
    import torch.distributed as dist
    from repro_torch.core.distributed import make_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized"):
        make_mesh(2, "cpu", group=object())     # a group handle, no world


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(runs):
    if runs["reference"] is None:
        pytest.skip("the JAX package needs jax")
    return runs["reference"]


@pytest.mark.parametrize("tech", W.TECHS)
@pytest.mark.parametrize("world", WORLDS)
def test_exact_answers_match_the_reference(worlds, reference, world, tech):
    ids, dists = reference["exact", tech]
    for spr in SPR:
        got = worlds[world]["answers"][spr, "exact"][f"{tech}/device"]
        np.testing.assert_array_equal(got["indices"], ids)
        np.testing.assert_allclose(got["distances"], dists, rtol=1e-5)


@pytest.mark.parametrize("case", W.WINDOW_CASES,
                         ids=[f"stride{s}-excl{e}" for s, e in
                              W.WINDOW_CASES])
def test_window_answers_match_the_reference(worlds, reference, case):
    ids, dists = reference[("windows",) + case]
    for world in WORLDS:
        for spr in SPR:
            got = worlds[world]["answers"][spr, "windows"][case]["answer"]
            np.testing.assert_array_equal(got["window_ids"], ids)
            np.testing.assert_allclose(got["distances"], dists, rtol=1e-5)


# ---------------------------------------------------------------------------
# the launcher under torch.distributed.run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launches(runs):
    return runs["launches"]


def _answers_line(stdout: str) -> str:
    return [ln for ln in stdout.splitlines()
            if ln.startswith("[answers]")][-1]


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launcher_under_torch_distributed_run(launches, name):
    rc, out, err = launches[name, 2]
    assert rc == 0, err[-3000:]
    lines = out.splitlines()
    if name == "selfjoin":
        assert any(EXPECT[name] in ln for ln in lines), out
    else:
        exact = [ln for ln in lines if EXPECT[name] in ln]
        assert exact and all(": 4/4 query" in ln for ln in exact), out
    line = _answers_line(out)
    assert line.endswith("2 ranks: equal on every rank yes"), line
    rc1, out1, err1 = launches[name, 1]
    assert rc1 == 0, err1[-3000:]
    # the world's answers hash equal to one process's at the same S
    assert line.split(";")[0] == _answers_line(out1)
