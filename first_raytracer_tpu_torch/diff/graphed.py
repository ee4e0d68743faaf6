"""The replay's value and gradient as one CUDA graph per static signature.

The JAX package jits ``_loss_grads_planned`` (and
``render_loss_and_grads_tape``) so that the bucketed replay's value and
gradient run as ONE XLA program: the plan's groups, ``cfg`` and the shapes
are static and select the program, while the parameters, the scene, the
key, the tape, the ray ids, the target and the plan's order are data.
``GraphCache`` is the port's counterpart on a CUDA device.  The first call
of a signature copies its inputs into static buffers and captures a run
of the body, autograd's backward included, into a ``torch.cuda.CUDAGraph``
with a private memory pool; every call then copies its inputs into the
buffers and replays the graph, which launches the same kernels with no
Python or dispatch cost.  The body must create no tensor from host data
and read nothing back to the host once it has run once on a device with
its ``cfg`` (``core/vecmath.constant``, the key read as data by
``core/rng``); a capture or a replay that fails raises.

The outputs are cloned out of the graph's pool, so a later replay cannot
overwrite what a caller holds.  On the CPU the same static buffers feed
the body eagerly.

The kernels' wrappers count their launches in Python, which runs only
while a graph is captured: the caches here and in ``render/graphed.py``
take a capture's launches off the counters (``take_launches``) and add
them back on every replay (``add_launches``), so a counter counts what
ran on the card.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import time

import torch

__all__ = ["GraphCache", "launch_counters", "launches_now",
           "take_launches", "add_launches"]

logger = logging.getLogger("first_raytracer_tpu_torch")


def _flatten(obj):
    """(tensors, structure) of a tree of tensors, dicts, tuples, lists and
    dataclasses: its tensors in a fixed order, and a hashable key of the
    rest, in which each tensor stands as its shape and dtype and anything
    else as its value."""
    leaves = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            leaves.append(o)
            return ("tensor", tuple(o.shape), o.dtype)
        if isinstance(o, dict):
            return ("dict", tuple((k, walk(v)) for k, v in o.items()))
        if isinstance(o, (tuple, list)):
            return (type(o), tuple(walk(v) for v in o))
        if dataclasses.is_dataclass(o):
            return (type(o), tuple(walk(getattr(o, f.name))
                                   for f in dataclasses.fields(o)))
        return ("value", o)

    return leaves, walk(obj)


def _map(fn, obj):
    """``obj`` with ``fn`` applied to each of its tensors."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def launch_counters():
    """(wrapper, attribute) of the launch counters a graphed body can move:
    K4's, K5's, K6's, K7's, K8's, K9's, K10's, K11's, K12's (each mode),
    K13's (its refills, folded into K12's pool launch), K14's and K15's
    (the tape replay's value and gradient)."""
    from ..accel import traverse
    from ..core import rng
    from ..kernels import dense_hit, intersect_clustered, intersect_pallas
    from ..render import camera, wavefront_pass
    from . import record_pass, replay_pass
    return ((intersect_pallas.intersect_pallas, "launches"),
            (intersect_clustered.intersect_clustered, "launches"),
            (traverse.intersect_bvh, "launches"),
            (rng.uniforms, "launches"),
            (camera.camera_rays, "launches"),
            (wavefront_pass.shade, "launches"),
            (wavefront_pass.regenerate, "launches"),
            (dense_hit.dense_hit, "launches"),
            (record_pass.record_step, "launches"),
            (record_pass.record_step, "length_launches"),
            (record_pass.record_shade, "launches"),
            (record_pass.record_shade, "refill_launches"),
            (replay_pass.replay, "launches"),
            (replay_pass.replay, "backward_launches"))


def launches_now():
    """The counters' values: (wrapper, attribute, count) each."""
    return [(fn, attr, getattr(fn, attr)) for fn, attr in launch_counters()]


def take_launches(before):
    """The launches counted since ``before`` (``launches_now()``), taken
    back off the counters: (wrapper, attribute, launches) of each that
    moved."""
    made = [(fn, attr, getattr(fn, attr) - n) for fn, attr, n in before]
    for fn, attr, n in before:
        setattr(fn, attr, n)
    return [m for m in made if m[2]]


def add_launches(made):
    """Adds ``take_launches``' counts back: a replay launched them."""
    for fn, attr, n in made:
        setattr(fn, attr, getattr(fn, attr) + n)


def copy_leaves(buffers, leaves):
    """Copies the tensors ``leaves`` into ``buffers``, with no host
    synchronization: a host tensor (the key) goes through pinned memory
    (the pinned block is not reused until its copy has run)."""
    for dst, src in zip(buffers, leaves):
        src = src.detach()
        if dst.device.type == "cuda" and src.device.type == "cpu":
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)


class _Graphed:
    """One signature: its static input buffers, and on a CUDA device its
    graph and the outputs the graph writes."""

    def __init__(self, body, static, inputs, device):
        self.body, self.static = body, static
        self.buffers = _map(lambda t: torch.empty_like(t, device=device),
                            inputs)
        self.leaves = _flatten(self.buffers)[0]
        self.graph = self.outputs = None
        self.launches = ()  # (wrapper, attribute, launches) a replay makes

    def call(self):
        return self.body(**self.buffers, **self.static)


class GraphCache:
    """CUDA graphs of a body, one per static signature, the ``maxsize``
    most recently used kept.

    ``run(body, static, inputs, device)`` returns ``body(**inputs,
    **static)``: ``static`` holds the body's hashable static arguments, its
    ``cfg`` among them (they and the inputs' structure, shapes and dtypes
    form the signature), ``inputs`` its tensor arguments (tensors, dicts,
    tuples or dataclasses of tensors), copied into the signature's buffers
    on ``device`` before each replay.

    Before the first capture of a body on a device with a ``cfg`` the body
    runs once eagerly on a side stream (the warm-up): it readies CUDA's and
    autograd's lazy state and the constants that the body takes from
    ``core/vecmath.constant``, which depend on ``cfg``'s frame.  Another
    signature of the same body, device and ``cfg`` (a fit whose plan
    changes every step) captures with no warm-up.  ``captures``,
    ``warmups`` and ``replays`` count them; ``last`` holds the latest
    capture's warm-up seconds (about 0 where it had none), its capture
    seconds and its pool's bytes (the memory reserved during the capture).
    """

    def __init__(self, maxsize: int = 4):
        self.maxsize = maxsize
        self.entries = collections.OrderedDict()
        self.warm = set()
        self.captures = 0
        self.warmups = 0
        self.replays = 0
        self.last = None

    def run(self, body, static, inputs, device):
        device = torch.device(device)
        leaves, structure = _flatten(inputs)
        sig = (body, tuple(sorted(static.items())), device, structure)
        entry = self.entries.get(sig)
        if entry is None:
            entry = self.entries[sig] = _Graphed(body, static, inputs,
                                                 device)
            while len(self.entries) > self.maxsize:
                self.entries.popitem(last=False)
        else:
            self.entries.move_to_end(sig)
        copy_leaves(entry.leaves, leaves)
        if device.type != "cuda":
            return _map(torch.clone, entry.call())
        if entry.graph is None:
            self._capture(entry, (body, device, static.get("cfg")), device)
        entry.graph.replay()
        add_launches(entry.launches)
        self.replays += 1
        return _map(torch.clone, entry.outputs)

    def _capture(self, entry, warm_key, device):
        with torch.cuda.device(device):
            t0 = time.perf_counter()
            if warm_key not in self.warm:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    entry.call()
                torch.cuda.current_stream().wait_stream(side)
                torch.cuda.synchronize()
                self.warm.add(warm_key)
                self.warmups += 1
            t1 = time.perf_counter()
            # capture_begin/end rather than torch.cuda.graph, which also
            # collects garbage and empties the allocator's cache on every
            # capture, and a fit whose plan changes captures every step.
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved(device)
            graph = torch.cuda.CUDAGraph()
            before = launches_now()
            with torch.cuda.stream(torch.cuda.Stream()):
                graph.capture_begin()
                try:
                    outputs = entry.call()
                finally:
                    graph.capture_end()
            torch.cuda.synchronize()
            entry.launches = take_launches(before)
            entry.graph, entry.outputs = graph, outputs
        self.captures += 1
        self.last = dict(warmup_s=t1 - t0, capture_s=time.perf_counter() - t1,
                         pool_bytes=torch.cuda.memory_reserved(device)
                         - reserved)
        logger.info("captured %s on %s: warm-up %.3f s, capture %.3f s, "
                    "pool %d bytes", entry.body.__name__, device,
                    self.last["warmup_s"], self.last["capture_s"],
                    self.last["pool_bytes"])
