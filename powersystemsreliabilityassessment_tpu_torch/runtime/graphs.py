"""CUDA graphs of fixed-shape chains of small operations.

A step of the m <= 72 LP tier enqueues hundreds of small PyTorch
operations between its hand-written kernels' launches, the screened
evaluator's tier-1 pass hundreds more, and the host, not the card, sets
the pace. A :class:`Chain` runs each such segment as a
CUDA graph: the first call of a segment runs it once eagerly on a side
stream (cuBLAS handles, workspaces and lazy set-up), captures it, and
every call replays it. Whatever runs between the segments (the
hand-written kernels' own launches, which the benchmark records) stays
eager.

A segment is a function of tensors that returns a tuple of tensors. Its
inputs are copied into the graph's static inputs before each replay,
except an input that is itself an output of an earlier segment of the
same chain, which the graph reads where it lies. Its outputs are the
graph's static outputs, which the next replay overwrites: the caller
takes :meth:`Chain.fresh` copies of whatever it hands on.

:data:`EAGER` has the same interface and runs each segment as a plain
call, so one code path serves both. :func:`chain_for` is the one rule
that picks one or the other; each layer (``engines/lp_ipm_structured.
lp_chain``, ``engines/dcopf.tier1_chain``) hands it its own bounded
:class:`ChainCache`, its key and its lane cap.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from powersystemsreliabilityassessment_tpu_torch.utils.profiling import (
    count, span)

# device -> the side stream every chain on it warms up and captures on.
_side_streams: dict = {}


def _side_stream(device: torch.device):
    stream = _side_streams.get(device)
    if stream is None:
        stream = _side_streams[device] = torch.cuda.Stream(device)
    return stream


class _Segment(NamedTuple):
    graph: object            # torch.cuda.CUDAGraph
    inputs: tuple            # static inputs
    outputs: tuple           # static outputs
    launched: tuple          # per launch counter: {kernel: launches a replay}


class Chain:
    """The CUDA graphs of one chain of segments on ``device``, captured
    on first use. ``layer`` names the span of each replay
    (``psra.<layer>.replay``) and the counters ``<layer>.graph_replays``
    and ``<layer>.graph_captures``. ``keep`` holds the objects whose
    identity the chain's cache key names, so the identity stays theirs.
    ``launches`` are the hand-written kernels' launch counters
    (``ops/*.launches``); a replay advances them by the launches the
    graph holds, so they count what the card runs."""

    graphed = True

    def __init__(self, device: torch.device, layer: str, keep=(),
                 launches: tuple = ()):
        self.device, self.layer = device, layer
        self.keep, self.launches = keep, launches
        self.segments: dict[str, _Segment] = {}

    def run(self, name: str, fn: Callable, *inputs: torch.Tensor) -> tuple:
        """Segment ``name``: ``fn(*inputs)`` replayed as a graph (captured
        on this first call of ``name``); returns its static outputs."""
        with span(f"{self.layer}.replay"):
            seg = self.segments.get(name)
            if seg is None:
                seg = self.segments[name] = self._capture(fn, inputs)
                count(f"{self.layer}.graph_captures", 1)
            if len(inputs) != len(seg.inputs):
                raise ValueError(f"segment {name}: {len(inputs)} inputs, "
                                 f"captured with {len(seg.inputs)}")
            for static, t in zip(seg.inputs, inputs):
                if static is not t:
                    if static.shape != t.shape:
                        raise ValueError(
                            f"segment {name}: input of shape "
                            f"{tuple(t.shape)}, captured with "
                            f"{tuple(static.shape)}")
                    static.copy_(t)
            seg.graph.replay()
            for counter, n in zip(self.launches, seg.launched):
                for kernel, k in n.items():
                    counter[kernel] += k
        count(f"{self.layer}.graph_replays", 1)
        return seg.outputs

    def fresh(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of a static output that no later replay overwrites."""
        return t.clone()

    def _capture(self, fn: Callable, inputs: tuple) -> _Segment:
        earlier = [o for s in self.segments.values() for o in s.outputs]
        static = tuple(
            t if any(t is o for o in earlier)
            else t.clone(memory_format=torch.contiguous_format)
            for t in inputs)
        side = _side_stream(self.device)
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                fn(*static)
            main.wait_stream(side)
            before = tuple(dict(c) for c in self.launches)
            graph = torch.cuda.CUDAGraph()
            # PyTorch keeps a cuBLAS workspace per stream (32 MiB on an
            # H100), held for the life of the process. Dropped before the
            # capture, the side stream's is made again inside the graph's
            # private pool; dropped after it, it stays there, reserved
            # for the graph's replays, and no longer counts as allocated.
            # Other streams make theirs again at their next product.
            torch._C._cuda_clearCublasWorkspaces()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                outputs = tuple(fn(*static))
            torch._C._cuda_clearCublasWorkspaces()
        # The capture ran nothing: its launches count at each replay.
        launched = tuple({k: c[k] - b.get(k, 0) for k in c}
                         for c, b in zip(self.launches, before))
        for c, n in zip(self.launches, launched):
            for k, v in n.items():
                c[k] -= v
        return _Segment(graph, static, outputs, launched)


class _Eager:
    """:class:`Chain`'s interface, each segment a plain call."""

    graphed = False

    def run(self, name: str, fn: Callable, *inputs: torch.Tensor) -> tuple:
        return tuple(fn(*inputs))

    def fresh(self, t: torch.Tensor) -> torch.Tensor:
        return t


EAGER = _Eager()


class ChainCache:
    """The chains of the ``size`` keys used last; a new key past that
    drops the least recently used chain, which releases its graphs and
    their memory."""

    def __init__(self, size: int):
        self.size = size
        self._chains: OrderedDict = OrderedDict()

    def get(self, key, make: Callable[[], Chain]) -> Chain:
        chain = self._chains.get(key)
        if chain is None:
            chain = self._chains[key] = make()
            while len(self._chains) > self.size:
                self._chains.popitem(last=False)
        else:
            self._chains.move_to_end(key)
        return chain

    def __len__(self) -> int:
        return len(self._chains)

    def __contains__(self, key) -> bool:
        return key in self._chains


def chain_for(cache: ChainCache, key, device, layer: str, route_graphs: bool,
              lanes: int, max_lanes: float = float("inf"), keep=(),
              launches: tuple = ()):
    """The chain of ``key`` for ``lanes`` lanes on ``device`` from
    ``cache`` (made on first use: a :class:`Chain` of ``layer``, holding
    ``keep`` and advancing ``launches``), or :data:`EAGER`. A chain only
    where the LP route allows graphs (``route_graphs``:
    ``engines/lp_ipm_batched.LPRoute.graphs``), on a CUDA device, at most
    ``max_lanes`` lanes and while no capture is under way (a segment may
    call a layer that asks for a chain of its own, as ``dcopf._finalize``'s
    certificate pass does). The cache key is
    ``(key, device, lanes)``: the same call hits it every time."""
    dev = torch.device(device)
    if (not route_graphs or dev.type != "cuda" or lanes > max_lanes
            or torch.cuda.is_current_stream_capturing()):
        return EAGER
    return cache.get((key, dev, lanes),
                     lambda: Chain(dev, layer, keep, launches))
