"""Every input stream of a run, drawn from its ``--seed``.

``--seed`` may be any whole number (past 2^31 too); each stream
is a 32-bit word of ``numpy.random.SeedSequence(seed)``, so one seed gives
the same draws, perturbation and checked sample in every run.  The scene
is the configuration's own (``scenes.build``): every seed does the same
work.
"""
from __future__ import annotations

import numpy as np

_STREAMS = ("render", "check", "perturb")


def streams(seed: int):
    """{stream name: 32-bit word} of ``seed``."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return dict(zip(_STREAMS, (int(w) for w in ss.generate_state(
        len(_STREAMS)))))


def render_seed(base: int, i: int) -> int:
    """The render seed (an int32, as the port's keys take) of request
    ``i``: a Weyl sequence from the stream's word."""
    return (base + i * 0x9E3779B1) & 0x7FFFFFFF
