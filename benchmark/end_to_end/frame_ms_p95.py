"""The 95th percentile (nearest rank) of every request's latency in the
window, from the call to its synchronize, in ms."""


def read(values):
    return values["p95_ms"]
