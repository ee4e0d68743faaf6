"""The wavefront integrator's loops as CUDA graphs, one per static signature.

The JAX package jits the regenerative pool (``render_rays_regenerative``)
and the chunked batch (``render_ray_batch``) into one XLA program each: a
``lax.while_loop`` whose shapes are fixed and whose test runs on the
device.  ``LoopCache`` is the port's counterpart on a CUDA device.  A loop
is two bodies over a state of fixed shape: ``init(**inputs, **static)``
returns the state (a dict of tensors with an ``alive`` mask), and
``step(state, **inputs, **static)`` advances it by one pass IN PLACE, with
no host read and no tensor made from host data.  The first call of a
signature copies its inputs into static buffers and captures ``init`` and a
block of ``PASSES_PER_READ`` steps as two ``torch.cuda.CUDAGraph``s, each
with a private memory pool; the state the init graph writes is what the
block graph reads and rewrites, so nothing is copied in or out per pass.
Every call then copies its inputs into the buffers, replays the init graph
and replays the block until a flag the block computes on the card says no
lane is alive: one host sync per block (a ``non_blocking`` copy into
pinned memory, then an event wait), as ``while_loop`` tests every pass.
Passes past the last live one are inert (the bodies change nothing once
every lane is dead), so a block may overrun the end.  The outputs named by
the caller are cloned out once per call.

A capture or a replay that fails raises; there is no eager fallback.  On
the CPU the same bodies run eagerly over the same buffers and state, with
the same blocks and the flag read per block.

Kernel launches under a graph: K4's to K15's wrappers count their
launches in Python, which runs only while a graph is captured.  The cache takes the launches a capture recorded off the
counters and adds them back on every replay, so the counters count what
ran on the card (``diff.graphed.launch_counters``).
"""
from __future__ import annotations

import collections
import logging
import time

import torch

from ..diff.graphed import (_flatten, _map, add_launches, copy_leaves,
                            launches_now, take_launches)

__all__ = ["LoopCache", "LOOPS", "PASSES_PER_READ", "graphed_route",
           "run_eager", "run_loop"]

logger = logging.getLogger("first_raytracer_tpu_torch")

# Passes (pool passes or trips of a chunk) per graph replay, and so per
# read of the alive flag.  On an H100 (probes/wavefront_graph.py) 1, 2 and
# 4 were within 2% of each other on the final scene's pool and chunked
# frames and on field20000's (a read and a replay's launch cost ~10 us, a
# pass 1-2 ms); 8 was up to 11% slower (its inert passes).
PASSES_PER_READ = 2


def _block(step, state, inputs, static, passes):
    """``passes`` steps of the loop, then the flag (2,) int64: whether a
    lane is still alive, and how many of these passes began with a live
    lane."""
    live = torch.zeros((), dtype=torch.int64, device=state["alive"].device)
    for _ in range(passes):
        live = live + state["alive"].any()
        step(state, **inputs, **static)
    return torch.stack([state["alive"].any().to(torch.int64), live])


def run_eager(init, step, static, inputs, passes):
    """The loop op by op on the inputs themselves, the flag read back per
    block of ``passes``: the path a caller asks for with ``graphed=False``.
    Returns the final state."""
    state = init(**inputs, **static)
    while bool(_block(step, state, inputs, static, passes)[0]):
        pass
    return state


def graphed_route(device, accel, intersect_fn, graphed):
    """Whether a wavefront loop goes through ``LOOPS``: on the CPU (which
    runs the same bodies eagerly there) unless ``graphed`` is False; on a
    CUDA device as ``graphed`` says, by default for the package's closest
    hits (the dense sweep, K11, K4, K5 and K6, the flat-BVH walk).  A Python
    ``intersect_fn`` of the caller's must be asked for either way: it may
    keep host state that a graph would not update."""
    if graphed is not None or torch.device(device).type != "cuda":
        return graphed is not False
    from ..accel.traverse import intersect_bvh
    from ..kernels.dense_hit import dense_hit
    from ..kernels.intersect_clustered import intersect_clustered
    from ..kernels.intersect_pallas import intersect_pallas
    from .integrator import default_intersect
    if intersect_fn in (None, default_intersect, dense_hit, intersect_pallas,
                        intersect_clustered, intersect_bvh):
        return True
    raise ValueError(
        f"{getattr(intersect_fn, '__name__', intersect_fn)!r} on "
        f"{type(accel).__name__}: pass graphed=False to run the wavefront "
        "loop eagerly, or graphed=True to capture it in a CUDA graph")


def run_loop(init, step, static, inputs, device, outputs, graphed=None):
    """The loop of ``init`` and ``step`` (``static`` holds its
    ``intersect_fn``), ``PASSES_PER_READ`` passes a read of the flag:
    through ``LOOPS`` where ``graphed_route`` says so, else op by op
    (``run_eager``).  Returns ``{name: state[name]}`` for the names in
    ``outputs``."""
    if graphed_route(device, inputs["accel"], static["intersect_fn"],
                     graphed):
        return LOOPS.run(init, step, static, inputs, device, outputs,
                         PASSES_PER_READ)
    state = run_eager(init, step, static, inputs, PASSES_PER_READ)
    return {k: state[k] for k in outputs}


class _Loop:
    """One signature: its input buffers, the state, and on a CUDA device
    the two graphs and the pinned flag."""

    def __init__(self, inputs, device):
        self.buffers = _map(lambda t: torch.empty_like(t, device=device),
                            inputs)
        self.leaves = _flatten(self.buffers)[0]
        self.state = self.flag = None
        self.init_graph = self.block_graph = None
        # (wrapper, attribute, launches) an init replay and a block replay
        # make.
        self.init_launches = self.launches = ()
        self.host = self.done = None
        if device.type == "cuda":
            self.host = torch.zeros((2,), dtype=torch.int64).pin_memory()
            self.done = torch.cuda.Event()


class LoopCache:
    """CUDA graphs of wavefront loops, one pair per static signature, the
    ``maxsize`` most recently used kept.

    ``run(init, step, static, inputs, device, outputs, passes)``
    runs the loop (module docstring) and returns ``{name: state[name]}``
    for each name of ``outputs``, cloned.  ``static`` holds the bodies'
    hashable static arguments (``cfg`` among them); they, the bodies, the
    block length and the inputs' structure, shapes and dtypes form the
    signature.

    Before the first capture of a pair of bodies on a device with a given
    ``static`` and accel type, init and one block run once eagerly on a
    side stream (the warm-up): it builds the kernels' library and readies
    the constants that the bodies take from ``core/vecmath.constant``.
    Counters: ``captures``, ``warmups``, ``replays`` (block replays),
    ``passes`` (passes run, the inert ones included), ``live_passes``
    (passes that began with a live lane), ``syncs`` (flag reads); ``last``
    holds the latest capture's warm-up seconds, its two captures' seconds
    and their pools' bytes (the memory reserved during the captures).
    """

    def __init__(self, maxsize: int = 4):
        self.maxsize = maxsize
        self.entries = collections.OrderedDict()
        self.warm = set()
        self.last = None
        self.reset_counts()

    def reset_counts(self):
        self.captures = self.warmups = self.replays = 0
        self.passes = self.live_passes = self.syncs = 0

    def run(self, init, step, static, inputs, device, outputs, passes):
        device = torch.device(device)
        leaves, structure = _flatten(inputs)
        sig = (init, step, tuple(sorted(static.items())), passes,
               device, structure)
        entry = self.entries.get(sig)
        if entry is None:
            entry = self.entries[sig] = _Loop(inputs, device)
            while len(self.entries) > self.maxsize:
                self.entries.popitem(last=False)
        else:
            self.entries.move_to_end(sig)
        copy_leaves(entry.leaves, leaves)
        if device.type != "cuda":
            self._run_cpu(entry, init, step, static, passes)
        else:
            if entry.block_graph is None:
                self._capture(entry, init, step, static, passes,
                              device, (init, step, sig[2], device,
                                       type(inputs.get("accel"))))
            self._run_cuda(entry, passes)
        return {k: entry.state[k].clone() for k in outputs}

    def _run_cpu(self, entry, init, step, static, passes):
        state = init(**entry.buffers, **static)
        if entry.state is None:
            entry.state = state
        else:  # the same state tensors every call, as the graphs keep them
            for k, v in state.items():
                entry.state[k].copy_(v)
        while True:
            flag = _block(step, entry.state, entry.buffers, static, passes)
            self._count(passes, int(flag[1]))
            if not bool(flag[0]):
                return

    def _run_cuda(self, entry, passes):
        entry.init_graph.replay()
        add_launches(entry.init_launches)
        while True:
            entry.block_graph.replay()
            add_launches(entry.launches)
            entry.host.copy_(entry.flag, non_blocking=True)
            entry.done.record()
            entry.done.synchronize()
            self.replays += 1
            self._count(passes, int(entry.host[1]))
            if not entry.host[0]:
                return

    def _count(self, passes, live):
        self.passes += passes
        self.live_passes += live
        self.syncs += 1

    def _capture(self, entry, init, step, static, passes, device, warm_key):
        b = entry.buffers
        with torch.cuda.device(device):
            t0 = time.perf_counter()
            if warm_key not in self.warm:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    _block(step, init(**b, **static), b, static, passes)
                torch.cuda.current_stream().wait_stream(side)
                torch.cuda.synchronize()
                self.warm.add(warm_key)
                self.warmups += 1
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved(device)
            # The wrappers run once while capturing; the card runs their
            # kernels on each replay, which adds them back.
            before = launches_now()
            init_graph, block_graph = (torch.cuda.CUDAGraph(),
                                       torch.cuda.CUDAGraph())
            # capture_begin/end rather than torch.cuda.graph, which also
            # collects garbage and empties the allocator's cache.
            with torch.cuda.stream(torch.cuda.Stream()):
                init_graph.capture_begin()
                try:
                    state = init(**b, **static)
                finally:
                    init_graph.capture_end()
                init_launches = take_launches(before)
                block_graph.capture_begin()
                try:
                    flag = _block(step, state, b, static, passes)
                finally:
                    block_graph.capture_end()
            torch.cuda.synchronize()
            entry.init_launches = init_launches
            entry.launches = take_launches(before)
            entry.state, entry.flag = state, flag
            entry.init_graph, entry.block_graph = init_graph, block_graph
        self.captures += 1
        self.last = dict(warmup_s=t1 - t0, capture_s=time.perf_counter() - t1,
                         pool_bytes=torch.cuda.memory_reserved(device)
                         - reserved)
        logger.info("captured %s/%s on %s: warm-up %.3f s, capture %.3f s, "
                    "pool %d bytes", init.__name__, step.__name__, device,
                    self.last["warmup_s"], self.last["capture_s"],
                    self.last["pool_bytes"])


# The wavefront paths' graphs (render/regenerative.py, render/integrator.py).
LOOPS = LoopCache()
