"""K3's device time a frame, from the trace, in ms."""

KERNEL = r"\bmega_clustered_kernel\b"


def read(m):
    k3 = m["trace"].kernel_seconds(KERNEL)
    return 1e3 * k3 / m["stats"]["requests"] if k3 else None
