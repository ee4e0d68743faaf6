"""The tape replay's device time a step, from the trace, in ms: K14 (the
value) and K15 (the gradient, with its order and rounding launches)."""

KERNELS = (r"\b(replay_forward_kernel|replay_backward_kernel"
           r"|replay_order_kernel|round_kernel)\b")


def read(m):
    t = m["trace"].kernel_seconds(KERNELS)
    return 1e3 * t / m["stats"]["requests"] if t else None
