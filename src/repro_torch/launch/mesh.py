"""Device meshes, for one card.

The JAX package builds a (16, 16) TPU mesh with axes ("data", "model"),
or (2, 16, 16) with ("pod", "data", "model") across two pods.  The port
runs on one GPU: it has no multi-device execution, so a mesh here is the
named axis sizes over the devices that exist, and every axis but one of
size 1 needs devices that one card does not have.
:func:`make_production_mesh` raises, as the reference does, when there
are fewer devices than its shape; :func:`make_debug_mesh` (1, 1) is the
one card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """Named axis sizes over a list of devices (row-major)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))


def _devices(device: str) -> Tuple[torch.device, ...]:
    if device == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device(device),)


def _make_mesh(shape, axes, device: str) -> Mesh:
    n = int(np.prod(shape))
    devices = _devices(device)
    if len(devices) < n:
        raise RuntimeError(f"mesh {shape} needs {n} devices, found "
                           f"{len(devices)} ({device})")
    return Mesh(tuple(axes), tuple(shape), devices[:n])


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device: str = "cuda") -> Mesh:
    """A (data, model) mesh over the devices that exist: (1, 1) is one
    card (or the CPU with ``device="cpu"``)."""
    return _make_mesh((data, model), ("data", "model"), device)


def batch_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
