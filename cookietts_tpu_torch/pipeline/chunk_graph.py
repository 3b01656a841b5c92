"""The decode chunk as a CUDA graph, captured once per shape and replayed.

The counterpart of the JAX package's ``jax.jit`` of ``Tacotron2.decode_chunk``
(cookietts_tpu/pipeline/streaming.py:72-86) and of its jitted early-exit
decode (pipeline/text2speech.py:232-290): the decode is host-bound (each of a
step's kernels issued from Python costs more host time than the card spends
on it), and a replayed graph issues a whole chunk of steps at once.

``DecodeChunkGraphs(decoder)`` is called like ``Decoder.decode_chunk``:
``(memory, const, state, steps, generator) -> (mel_raw, gate, weights,
state)``. On the CPU it runs the chunk eagerly (there are no graphs there).
On the card the first call at a shape (B, T_enc, memory width, steps) runs
eagerly, then the chunk is captured; every later call at that shape copies
its inputs into the graph's buffers and replays it.

- Randomness: the prenet draws from a generator registered with the graph.
  A call copies the caller's generator state (the default CUDA generator for
  None) into it before the replay and back after, so a replay draws what the
  eager chunk would draw and leaves the caller's generator where the eager
  chunk would.
- Launch counts: capturing launches nothing, so the counts the capture added
  to ``hopper_kernels.LAUNCHES`` are taken back, and every replay adds them.
- ``lstm_gates`` gives each capture its own ticket counters
  (``ops/hopper_kernels.py:_tickets``), and each program captures on a
  stream of its own, so cuBLAS gives its graphs a workspace of their own
  (cuBLAS keeps one per stream, and a graph keeps the one it was captured
  with). Graphs of two programs may run at once; two graphs of one program
  (one worker's) must not.
- The cache is bounded: past ``max_graphs`` shapes (a server meets a new
  batch size with every client that asks for one), the least recently
  replayed graph is released, with its memory pool and its ``lstm_gates``
  counters, after the card has finished what was queued.
- A failed capture raises; nothing falls back to the eager chunk.
- A bf16 decoder's chunk captures the same way: its static buffers (memory,
  the processed memory, the context and previous frame) are bf16, the cells'
  states and attention's f32, and a replay equals the eager bf16 chunk bit
  for bit as the f32 one does.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
from typing import Any, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from ..ops import hopper_kernels as hk


@dataclasses.dataclass
class _Captured:
    graph: Any                      # torch.cuda.CUDAGraph
    generator: torch.Generator      # registered with the graph
    inputs: List[torch.Tensor]      # (memory, const, state) leaves
    outputs: List[torch.Tensor]     # (mel, gate, weights, state) leaves
    out_spec: Any
    launches: Dict[str, int]        # kernel launches of one replay
    tickets: List[tuple]            # keys of the capture's lstm_gates counters


class DecodeChunkGraphs:
    """A decoder's chunk program: eager on the CPU, one CUDA graph per shape
    on the card, at most ``max_graphs`` kept (see the module docstring).
    ``captures``, ``replays``, ``eager_calls`` and ``releases`` count what
    it did."""

    def __init__(self, decoder, max_graphs: int = 16):
        self.decoder = decoder
        self.max_graphs = max_graphs
        self.stream = None            # the capture stream, made at first capture
        # by (memory shape, steps), least recently used first
        self.graphs: Dict[tuple, _Captured] = collections.OrderedDict()
        self.captures = self.replays = self.eager_calls = self.releases = 0

    @torch.no_grad()
    def __call__(self, memory: torch.Tensor, const: Dict[str, Any], state,
                 steps: int, generator: Optional[torch.Generator] = None):
        if memory.device.type != "cuda":
            self.eager_calls += 1
            return self.decoder.decode_chunk(memory, const, state, steps, generator)
        key = (tuple(memory.shape), int(steps))
        captured = self.graphs.get(key)
        if captured is None:
            out = self.decoder.decode_chunk(memory, const, state, steps, generator)
            self.eager_calls += 1
            self.graphs[key] = self._capture(memory, const, state, steps)
            self.captures += 1
            while len(self.graphs) > self.max_graphs:
                self._release(self.graphs.popitem(last=False)[1])
            return out
        self.graphs.move_to_end(key)
        return self._replay(captured, (memory, const, state), generator)

    def _release(self, captured: _Captured) -> None:
        torch.cuda.synchronize(captured.inputs[0].device)   # no replay in flight
        hk.release_tickets(captured.tickets)
        captured.graph.reset()
        self.releases += 1

    def _capture(self, memory, const, state, steps) -> _Captured:
        leaves, spec = pytree.tree_flatten((memory, const, state))
        inputs = [t.clone() for t in leaves]
        memory_s, const_s, state_s = pytree.tree_unflatten(inputs, spec)
        generator = torch.Generator(device=memory.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        if self.stream is None:
            self.stream = torch.cuda.Stream(memory.device)
        before = dict(hk.LAUNCHES)
        sets = set(hk._TICKETS)
        # a collection during the capture may free an earlier program's
        # CUDAGraph, whose reset is not permitted while a stream captures
        # and invalidates this capture (CUDA error 901): collect after it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = self.decoder.decode_chunk(memory_s, const_s, state_s, steps,
                                                generator)
        except Exception:
            # torch leaves the default CUDA generator marked as capturing
            # when a capture fails; a fresh copy of its state (same seed and
            # offset) lets later draws from it work
            default = torch.cuda.default_generators[torch.cuda.current_device()]
            default.graphsafe_set_state(default.clone_state())
            hk.release_tickets([k for k in hk._TICKETS if k not in sets])
            raise
        finally:
            if collecting:
                gc.enable()
            launches = {k: hk.LAUNCHES[k] - before[k] for k in before}
            hk.LAUNCHES.update(before)
        tickets = [k for k in hk._TICKETS if k not in sets]
        outputs, out_spec = pytree.tree_flatten(out)
        return _Captured(graph, generator, inputs, outputs, out_spec, launches,
                         tickets)

    def _replay(self, captured: _Captured, args, generator):
        leaves, _ = pytree.tree_flatten(args)
        torch._foreach_copy_(captured.inputs, leaves)
        source = generator or torch.cuda.default_generators[
            captured.inputs[0].device.index or 0]
        captured.generator.set_state(source.get_state())
        captured.graph.replay()
        source.set_state(captured.generator.get_state())
        for name, n in captured.launches.items():
            hk.LAUNCHES[name] += n
        self.replays += 1
        return pytree.tree_unflatten([t.clone() for t in captured.outputs],
                                     captured.out_spec)
