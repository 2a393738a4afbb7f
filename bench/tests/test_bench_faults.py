"""The timed path broken underneath a whole run on the CPU: the check
has to come out not correct for each fault a cell of exact matching can
have."""

import pytest

from bench import cell, manifest

SIZES = {"corpus": {"n": 2000, "chunk": 1024}, "pool": 128, "clients": 8,
         "session": {"window_s": 0.002, "max_batch": 8}}
CELL = manifest.load()["workloads"][0]["name"]


def _alter_answer(system):
    """An answer altered where it is produced: the engine's first row
    of every call points at another corpus row."""
    eng = system.engine
    topk = eng.topk

    def altered(*a, **kw):
        res = topk(*a, **kw)
        res.indices[0, 0] = (res.indices[0, 0] + 1) % eng.store.n
        return res
    eng.topk = altered


def _half_batch(system):
    """Half of each coalesced batch left out of the dispatch."""
    start = system.start

    def started():
        start()
        q = system.session.queue
        dispatch = q._dispatch
        q._dispatch = lambda batch, *a: dispatch(
            batch[:(len(batch) + 1) // 2], *a)
    system.start = started


def _stale(system):
    """A dispatch that returns the state it had: every call answers with
    the first call's result."""
    eng = system.engine
    topk, first = eng.topk, []

    def stale(*a, **kw):
        if not first:
            first.append(topk(*a, **kw))
        return first[0]
    eng.topk = stale


@pytest.mark.parametrize("fault", [_alter_answer, _half_batch, _stale])
def test_broken_path_is_not_correct(fault):
    r = cell.run(CELL, 2 ** 31 + 9, 0.4, False, device="cpu", sizes=SIZES,
                 wrap=fault)
    assert not r["correct"]
