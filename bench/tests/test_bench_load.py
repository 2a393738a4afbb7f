"""The load generator's closed loop against a stand-in service, and the
resend bursts read from its record."""

import threading

from bench import load


class _Req:
    def __init__(self):
        self.done = threading.Event()
        self.error = None

    def wait(self, timeout=None):
        return self.done.wait(timeout)

    @property
    def ok(self):
        return self.done.is_set()


def test_closed_loop_keeps_every_caller_busy():
    """A service that answers each request at once: every caller sends
    again as soon as its answer is back, until the window closes."""
    def submit(row, k):
        r = _Req()
        r.done.set()
        return r
    win = load.closed_loop(submit, 5, clients=4, k=1, seconds=0.05)
    assert len(win.sent) > 8
    assert [s.query for s in win.sent[:7]] == [0, 1, 2, 3, 4, 0, 1]
    assert all(s.t_back is not None for s in win.sent)
    assert all(s.resend is not None for s in win.sent[:4])
    assert len(win.done_in_window()) <= len(win.sent)


def _sent(t_back, t_sent, t_submitted):
    s = load.Sent(0, 0.0)
    s.t_back = t_back
    s.resend = load.Sent(0, t_sent, t_submitted)
    return s


def test_resend_bursts_group_answers_by_batch():
    gap = load.BATCH_GAP_S
    win = load.Window(0.0, 10.0, [
        _sent(1.0, 1.0001, 1.0002), _sent(1.0, 1.0002, 1.0004),
        _sent(1.0 + gap / 2, 1.0050, 1.0060),
        _sent(2.0, 2.0001, 2.0003)])
    win.sent.append(load.Sent(0, 0.0))        # never came back
    rows = load.resend_bursts(win)
    assert rows.shape == (2, 3)
    assert rows[0][0] == 3 and abs(rows[0][1] - 0.0059) < 1e-9
    assert abs(rows[0][2] - 0.0013) < 1e-9
    assert rows[1][0] == 1 and abs(rows[1][1] - 0.0002) < 1e-9
    assert load.resend_bursts(load.Window(0.0, 1.0)).shape == (0, 3)
