"""CUDA-graph replay of a cascade level of one scene.

A level of one scene is a few hundred launches (tiling, stats, the model
call, stitching, V-cycles, the modal correction), and at 80^2 and 160^2 the
host took longer to enqueue them than the device took to run them. Given the
shapes, nothing inside a level depends on a value read back on the host: the
tiling, chunking and V-cycle counts come from shapes, and the stats, the
resize and DST bases and the multigrid hierarchy stay on the device (the last
three cached per shape and never freed). So
:func:`~superresolution_for_pdes_tpu_torch.cascade.upscale.level_program`
runs a level of one scene on a card through :data:`LEVEL_GRAPHS`, which, by
the call's key (:meth:`LevelGraphs.key`):

- at the first sighting runs the level eagerly (this also warms cuDNN's plans
  and the caches above);
- at the second runs it eagerly on the capture stream and returns that
  result, then captures it as a CUDA graph on static copies of its inputs,
  in a memory pool shared by the levels of one cascade, captured in the
  order they run;
- at later sightings copies the inputs into those buffers, replays the graph
  and returns a clone of its output, so a caller never holds memory that the
  next replay overwrites.

The key holds the address of every tensor the graph reads in place: the
level's weights, the gains, precomputed stats. New weights (another
state_dict) are another key; weights updated in place keep it, and the
replay reads their new values. A replay runs the captured kernels in the
captured order, so its fields are the eager path's bit for bit; it opens the
span ``cascade.replay`` and advances the stencil kernels' launch counters by
what the capture counted.

A cascade is a level 0 and the levels called after it in order (a level whose
predecessor was not the last call here starts one of its own). The cache
keeps :data:`MAX_CASCADES` of them, dropping the least recently used with its
graphs and pool, and at most :data:`MAX_LEVELS` level keys in each; a level
beyond that runs eagerly.
"""

from __future__ import annotations

import collections
import itertools
import math
import weakref
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence

import torch
from torch import nn

from superresolution_for_pdes_tpu_torch.ops.stencil_kernels import add_launches, launch_tally
from superresolution_for_pdes_tpu_torch.utils.profiling import span

MAX_CASCADES = 4
MAX_LEVELS = 8


def _module_tensors(module: nn.Module):
    return itertools.chain(module.parameters(), module.buffers())


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple            # static input buffers (None where the level has no such input)
    output: torch.Tensor
    launches: tuple          # the stencil kernels' launches the capture counted

    def replay(self, inputs) -> torch.Tensor:
        for buf, x in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(x)
        self.graph.replay()
        add_launches(self.launches)
        return self.output.clone()


class _Cascade:
    """The graphs of one cascade's levels and the memory pool they share;
    ``levels`` maps a level key to its graph, or to ``None`` once seen."""

    def __init__(self, key: tuple, device: torch.device):
        self.key, self.device = key, device
        self.pool = torch.cuda.graph_pool_handle()
        self.levels: Dict[tuple, Optional[_Graph]] = {}


class LevelGraphs:
    """Captured levels by key (module docstring); ``captures`` and
    ``replays`` count what it did."""

    def __init__(self):
        self._cascades: collections.OrderedDict = collections.OrderedDict()
        self._last: Optional[tuple] = None  # (cascade, level) of the last call
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        # the names of a model's parameters and buffers, read at its first key
        self._names: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self.captures = 0
        self.replays = 0

    def clear(self) -> None:
        """Drop every graph and pool, and zero the counts."""
        self.__init__()

    def key(self, model: nn.Module, weights, level: int,
            inputs: Sequence[Optional[torch.Tensor]], settings: tuple, read: Sequence,
            tile_devices: Optional[Sequence[torch.device]] = None) -> Optional[tuple]:
        """The key of a level call, or ``None`` where the call runs eagerly:
        fields not on a card, more than one scene, inputs not contiguous,
        tiles split over another device than the fields', or something read
        in place (``read``: gains, stats fields; ``None`` entries skipped)
        that is not a tensor on the fields' device. ``inputs`` are the
        tensors copied into the graph's buffers (``None`` where a level has no
        such input); ``settings`` every other argument the level's program
        depends on. Weights given as a state_dict are read by address; the
        model's own tensors too, unless the state_dict names them all."""
        current = inputs[0]
        if not current.is_cuda or math.prod(current.shape[:-2]) != 1:
            return None
        device = current.device
        if tile_devices is not None and any(d != device for d in tile_devices):
            return None
        if any(x is not None and (x.device != device or not x.is_contiguous()) for x in inputs):
            return None
        read = [t for t in read if t is not None]
        if any(not isinstance(t, torch.Tensor) or t.device != device for t in read):
            return None
        if isinstance(weights, Mapping):
            names = self._names.get(model)
            if names is None:
                names = self._names[model] = frozenset(
                    n for n, _ in itertools.chain(model.named_parameters(),
                                                  model.named_buffers()))
            tensors = (weights.values() if names <= weights.keys()
                       else itertools.chain(weights.values(), _module_tensors(model)))
            names = tuple(weights)
        else:
            tensors = _module_tensors(model if weights is None else weights)
            names = id(weights)
        return (level, device, settings, id(model), names,
                tuple(None if x is None else (x.shape, x.dtype) for x in inputs),
                tuple((t.data_ptr(), t.shape, t.dtype) for t in read),
                tuple(t.data_ptr() for t in tensors))

    def run(self, key: tuple, level: int, program: Callable[..., torch.Tensor],
            inputs: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """``program(*inputs)``: eagerly, captured, or replayed, by ``key``."""
        cascade = self._cascade(key, level, inputs[0].device)
        self._last = (cascade, level)
        if key not in cascade.levels:
            if len(cascade.levels) < MAX_LEVELS:
                cascade.levels[key] = None
            return program(*inputs)
        graph = cascade.levels[key]
        if graph is None:
            out, cascade.levels[key] = self._capture(program, inputs, cascade)
            return out
        with span("cascade.replay", 1):
            self.replays += 1
            return graph.replay(inputs)

    def _cascade(self, key: tuple, level: int, device: torch.device) -> _Cascade:
        if level > 0 and self._last is not None:
            cascade, last_level = self._last
            if (last_level == level - 1 and cascade.device == device
                    and self._cascades.get(cascade.key) is cascade):
                return cascade
        cascade = self._cascades.get(key)
        if cascade is None:
            cascade = self._cascades[key] = _Cascade(key, device)
            while len(self._cascades) > MAX_CASCADES:
                self._cascades.popitem(last=False)
        self._cascades.move_to_end(key)
        return cascade

    def _capture(self, program, inputs, cascade: _Cascade):
        """Run ``program`` eagerly on the capture stream (which warms the
        stream's library handles), then capture it on static copies of the
        inputs; returns the eager result and the graph."""
        device = cascade.device
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        static = tuple(None if x is None else x.clone() for x in inputs)
        stream.wait_stream(current)
        with torch.cuda.device(device):
            with torch.cuda.stream(stream):
                out = program(*inputs)
            out.record_stream(current)
            before = launch_tally()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=cascade.pool, stream=stream):
                output = program(*static)
        launches = tuple(b - a for a, b in zip(before, launch_tally()))
        add_launches(tuple(-n for n in launches))  # captured, not run
        current.wait_stream(stream)
        self.captures += 1
        return out, _Graph(graph, static, output, launches)


LEVEL_GRAPHS = LevelGraphs()
