"""Engine layer (``core/engine.py::topk_verify``): the engine loop's
host self time per round, in us: the ``match.round`` spans' seconds
less their blocking device-to-host copies (``wait``), over the
rounds. Read over the card's traced window: None where it held no
device work or no K1 launch. None too where the program records no
such span."""

from bench.records import counter, kernels, ratio

K1 = r"(?<!windowed_)euclid_kernel"


def read(rec):
    if (rec["trace"]["busy_s"] <= 0 or not kernels(rec, K1)[1]
            or "match.round_s" not in rec["counters"]):
        return None
    host = counter(rec, "match.round_s") - counter(rec, "match.round.wait_s")
    return ratio(1e6 * host, counter(rec, "match.rounds"))
