"""Decode steps replayed as CUDA graphs.

The JAX package compiles each decode step into one program and
dispatches it once a tick.  The port runs its steps eagerly, and on the
card an eager step is bound by the host: each of its hundreds to
thousands of launches is issued from Python.  :class:`StepGraph`
captures one step of one engine as a CUDA graph over that engine's own
buffers (slot cache, pool, weights, and the static input buffers the
engine fills before each replay) and replays it as one launch.

* The step writes every buffer it changes in place, ``pos`` included,
  so a replay reads and writes the addresses the capture saw.
* The first call runs the step for real, eagerly, on the capture stream.
  That is the warm-up (libraries, workspaces and the kernels' arrival
  counters are set up), and its result is that step's result.  The
  capture follows at once.  A capture runs nothing, so the state is not
  advanced twice.  Every later call replays.
* A capture that fails raises: there is no eager fallback.
* The kernel wrappers count their launches in Python, which a replay
  does not run.  The launches recorded during the capture are taken back
  from the counts, and each replay adds them again, so a replayed step
  counts the launches it makes.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels import COUNTED_KERNELS

# one capture stream per device: the warm-up runs on it too, so the
# kernels' per-stream arrival counters exist before the capture
_STREAMS: Dict[Optional[int], "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    stream = _STREAMS.get(device.index)
    if stream is None:
        stream = _STREAMS[device.index] = torch.cuda.Stream(device)
    return stream


class StepGraph:
    """One engine's decode step, replayed as a CUDA graph.

    ``step`` takes no arguments and returns one tensor; it must read its
    inputs from buffers that stay in place between calls.  Calling the
    object runs the step (eagerly the first time, then as a replay) and
    returns its output, which a replay overwrites: copy it out before
    the next call."""

    def __init__(self, step: Callable[[], torch.Tensor],
                 device: torch.device):
        self._step = step
        self._device = device
        self._graph: Optional["torch.cuda.CUDAGraph"] = None
        self._out: Optional[torch.Tensor] = None
        self._launches: Tuple[Tuple[Callable, int], ...] = ()

    def __call__(self) -> torch.Tensor:
        if self._graph is None:
            return self._warm_up_and_capture()
        self._graph.replay()
        for fn, n in self._launches:
            fn.launches += n
        return self._out

    def _warm_up_and_capture(self) -> torch.Tensor:
        dev = self._device
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out = self._step()
        torch.cuda.current_stream(dev).wait_stream(stream)
        before = [(fn, fn.launches) for fn in COUNTED_KERNELS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            self._out = self._step()
        self._launches = tuple((fn, fn.launches - n) for fn, n in before
                               if fn.launches != n)
        for fn, n in before:
            fn.launches = n
        self._graph = graph
        return out
