"""Model-adaptive memory swapping (paper §III-C2 ❽).

On mobile the paper swaps activations between GPU and CPU memory; on one
GPU the same move is device memory <-> pinned host memory over the host
link.  ``Swapper(use_memory_kinds=True)`` performs it: ``offload`` copies
a card tensor into a pinned host buffer on a side stream, and ``fetch``
copies it back to the device it came from.  Events order each copy
after the work that produced its source and before the work that reads
its result, so neither call blocks the host.  A move that fails raises:
the JAX package keeps the tensor on the device when its move fails, the
port does not.  With ``use_memory_kinds=False`` the Swapper only tracks
the bytes, and the transfer is modelled at the host-link rate, as the
JAX package does on a CPU-only container.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch

# bytes/s each way over the H100 SXM's host link, PCIe Gen5 x16: the
# data sheet's figure, not a measurement (chip_smoke.py measures the
# pinned copy rates of the card it runs on)
HOST_LINK_BW = 64e9


@dataclass
class SwapRecord:
    name: str
    bytes: int
    direction: str   # "out" (to host) | "in" (to device)


@dataclass
class Swapper:
    """Tracks (and with ``use_memory_kinds``, performs) device<->host
    transfers.  A host copy made by ``offload`` is written asynchronously:
    read it on the host only after ``torch.cuda.synchronize()`` or a
    ``fetch``."""
    use_memory_kinds: bool = False      # real moves to pinned host memory
    records: List[SwapRecord] = field(default_factory=list)
    resident_host: Dict[str, Any] = field(default_factory=dict)
    # name -> (device the tensor came from, event after its copy to host)
    _moves: Dict[str, Tuple[torch.device, torch.cuda.Event]] = field(
        default_factory=dict, repr=False)
    _streams: Dict[torch.device, torch.cuda.Stream] = field(
        default_factory=dict, repr=False)

    def _side(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def offload(self, name: str, x: torch.Tensor) -> torch.Tensor:
        self.records.append(SwapRecord(name, x.numel() * x.element_size(),
                                       "out"))
        if self.use_memory_kinds:
            if x.device.type != "cuda":
                raise ValueError(f"offload {name!r}: the tensor is on "
                                 f"{x.device}, not on a CUDA card")
            side = self._side(x.device)
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            side.wait_stream(torch.cuda.current_stream(x.device))
            with torch.cuda.stream(side):
                host.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
            x.record_stream(side)       # x's memory outlives the copy
            self._moves[name] = (x.device, done)
            x = host
        self.resident_host[name] = x
        return x

    def fetch(self, name: str) -> torch.Tensor:
        x = self.resident_host.pop(name)
        self.records.append(SwapRecord(name, x.numel() * x.element_size(),
                                       "in"))
        if self.use_memory_kinds:
            device, done = self._moves.pop(name)
            side = self._side(device)
            current = torch.cuda.current_stream(device)
            out = torch.empty(x.shape, dtype=x.dtype, device=device)
            side.wait_stream(current)   # out's memory is free on `current`
            side.wait_event(done)
            with torch.cuda.stream(side):
                out.copy_(x, non_blocking=True)
            out.record_stream(side)
            current.wait_stream(side)
            x = out
        return x

    def total_bytes(self) -> int:
        return sum(r.bytes for r in self.records)

    def transfer_seconds(self, link_bw: float = HOST_LINK_BW) -> float:
        return self.total_bytes() / link_bw


def swap_plan(act_bytes_per_layer: List[int], budget_bytes: float
              ) -> Tuple[List[int], int]:
    """Choose which layers' saved activations to host-offload.

    DL inference is sequential (the paper's observation), so activations
    needed latest in the backward pass (earliest layers) are the best swap
    candidates: they have the longest idle window to prefetch back.
    Returns (layer indices to swap, resident bytes after swapping)."""
    total = sum(act_bytes_per_layer)
    swapped: List[int] = []
    resident = total
    for i, b in enumerate(act_bytes_per_layer):      # earliest first
        if resident <= budget_bytes:
            break
        swapped.append(i)
        resident -= b
    return swapped, int(resident)


def swap_overlap_latency(swapped_bytes: int, compute_seconds: float,
                         link_bw: float = HOST_LINK_BW) -> float:
    """Exposed (non-overlapped) transfer time: transfers hide under compute
    when the sequential window allows; only the excess is charged."""
    xfer = swapped_bytes / link_bw
    return max(0.0, xfer - compute_seconds)
