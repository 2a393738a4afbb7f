"""The plain reference against a NumPy brute force, the comparison, and
the control, which has to come out not correct."""

import numpy as np
import pytest
import torch

from bench.corpora import season
from bench.references import exact_knn as ref

SPEC = {"n": 1500, "T": 960, "L": 10, "strength": 0.5, "spread": 0.09,
        "chunk": 512}
LIMITS = {"nn_err": 1e-05}


def _data(seed, n_q=24):
    x = torch.cat(list(season.corpus_chunks(SPEC, seed, "cpu"))).numpy()
    q = season.query_pool(SPEC, n_q, seed, "cpu").numpy()
    return x, q


def _brute(x, q):
    d = np.sqrt(((x[None].astype(np.float64)
                  - q[:, None].astype(np.float64)) ** 2).sum(-1))
    return d.argmin(1), d.min(1), d


@pytest.mark.parametrize("k", [1, 5])
def test_reference_matches_numpy_brute_force(k):
    x, q = _data(11)
    ids, best, d = _brute(x, q)
    served = np.argsort(d, 1)[:, 1:k + 1]
    got_best, got_served, seen = ref.reference(
        season.corpus_chunks(SPEC, 11, "cpu"), q, served, "cpu")
    assert seen == len(x)
    np.testing.assert_allclose(got_best, np.sort(d, 1)[:, :k], rtol=1e-12)
    np.testing.assert_allclose(
        got_served, np.take_along_axis(d, served, 1), rtol=1e-12)


def _answers(order, d, rows=None):
    rows = range(len(order)) if rows is None else rows
    return [(i, order[i], np.float32(d[i, order[i]]).astype(np.float64))
            for i in rows]


@pytest.mark.parametrize("k", [1, 4])
def test_judge_passes_exact_answers_and_fails_wrong_ones(k):
    x, q = _data(12)
    _, _, d = _brute(x, q)
    order = np.argsort(d, 1)

    def judge(answers):
        return ref.judge(answers, len(q),
                         season.corpus_chunks(SPEC, 12, "cpu"), q, LIMITS,
                         len(x), "cpu")
    exact = _answers(order[:, :k], d)
    v = judge(exact)
    assert v["correct"] and v["checks"]["nn_err"]["value"] < 1e-6
    # the last query's k-th neighbour replaced by the (k+1)-th
    wrong = order[:, :k].copy()
    wrong[-1, -1] = order[-1, k]
    assert not judge(_answers(wrong, d))["correct"]
    v = judge(exact[:-1])
    assert not v["correct"] and v["checks"]["unserved"]["value"] == 1
    bad = order[:, :k].copy()
    bad[-1, 0] = len(x)
    dd = np.concatenate([d, np.ones((len(q), 1))], 1)
    assert judge(_answers(bad, dd))["checks"]["nn_err"]["value"] == np.inf
    if k > 1:
        twice = order[:, :k].copy()
        twice[-1, 1] = twice[-1, 0]
        assert judge(_answers(twice, d))["checks"]["nn_err"]["value"] \
            == np.inf


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -12, 3.0e-3], dtype=torch.float32)
    r = ref.to_tf32(x)
    assert r[:2].tolist() == [1.0, 1.0 + 2 ** -10]
    assert r[2].item() == 1.0                  # tie to even
    assert r[3].item() == 1.0 + 2 ** -9        # tie to even, upward
    assert r[4].item() == -1.0
    assert (r.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("seed", [21, 2 ** 31 + 22])
def test_control_is_not_correct(seed):
    """The control (the brute force in TF32) reads nn_err far above the
    limit; the exact answers far below it."""
    x, q = _data(seed, n_q=64)
    ids, dists = ref.control_answers(season.corpus_chunks(SPEC, seed, "cpu"),
                                     q, 1, "cpu")
    answers = [(i, ids[i], dists[i]) for i in range(len(q))]
    v = ref.judge(answers, len(q), season.corpus_chunks(SPEC, seed, "cpu"),
                  q, LIMITS, len(x), "cpu")
    assert not v["correct"]
    assert v["checks"]["nn_err"]["value"] > 3 * LIMITS["nn_err"]


@pytest.fixture
def cuda():
    """The card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 products run "
                    "on its tensor cores")
    return torch.device("cuda")


def test_control_on_card_is_not_correct(cuda):
    spec = dict(SPEC, n=65536, chunk=16384)
    q = season.query_pool(spec, 256, 31, cuda).cpu().numpy()
    ids, dists = ref.control_answers(season.corpus_chunks(spec, 31, cuda),
                                     q, 1, cuda)
    answers = [(i, ids[i], dists[i]) for i in range(len(q))]
    v = ref.judge(answers, len(q), season.corpus_chunks(spec, 31, cuda), q,
                  LIMITS, spec["n"], cuda)
    assert not v["correct"]


def test_control_command_at_a_small_size():
    """``bench/control.py``'s run: the cell's corpus and queries, the
    control's answers, the cell's comparison."""
    from bench import control, manifest
    cell = manifest.load()["workloads"][0]["name"]
    v = control.control_run(cell, 2 ** 31 + 41, 48, "cpu",
                            sizes={"corpus": {"n": 1200, "chunk": 512}})
    assert not v["correct"] and v["checks"]["unserved"]["value"] == 0
