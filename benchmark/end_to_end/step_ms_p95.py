"""The 95th percentile (nearest rank) of every step's latency in the
window, from the call to the loss read on the host, in ms."""


def read(values):
    return values["p95_ms"]
