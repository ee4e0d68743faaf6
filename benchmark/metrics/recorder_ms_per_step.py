"""The tape recorder's device time a step, from the trace, in ms: its
closest hit (K11, the dense sweep, or K5, the clustered one) and its pass
(K12)."""

KERNELS = r"\b(dense_hit_kernel|intersect_clustered_kernel|record_step_kernel)\b"


def read(m):
    t = m["trace"].kernel_seconds(KERNELS)
    return 1e3 * t / m["stats"]["requests"] if t else None
