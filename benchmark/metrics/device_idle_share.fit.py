"""The share of the traced window in which no kernel, copy or memset ran
on the card, in %, in the fit cells."""


def read(m):
    tr = m["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
