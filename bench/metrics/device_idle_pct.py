"""Device: the share of the traced window in which no kernel, copy or
fill ran on the card, in percent."""


def read(rec):
    w = rec["window_s"]
    if not w or rec["trace"]["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["trace"]["busy_s"] / w)
