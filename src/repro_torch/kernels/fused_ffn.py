"""Fused gated FFN: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``fused_ffn`` of the JAX package
(``kernels/fused_ffn.py``).  The kernel itself is ``csrc/fused_ffn.cu``
(its header notes the design, the bound on the H100 and the workspace);
its plain version is :func:`repro_torch.kernels.ref.fused_ffn_ref`.

A tensor on the CPU takes the plain version.  A tensor on the card
launches the kernel or raises — there is no fallback.  Each launch adds
one to ``fused_ffn.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import fused_ffn_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"silu": 0, "gelu": 1}
# the kernel's tiles (csrc/fused_ffn.cu: kBM, kBD, kBF)
BLOCK_M, BLOCK_D, BLOCK_F = 64, 256, 64
# blocks wanted in flight: two per SM of an H100 (132 SMs)
TARGET_BLOCKS = 264


def _kernel_fn():
    fn = _build.load("fused_ffn").fused_ffn
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
    return fn


def split_plan(m: int, d: int, f: int):
    """``(nsplit, f_tiles_per_split)``: how many blocks share one output
    tile's F loop.  Only small M splits F, so the grid reaches about
    ``TARGET_BLOCKS`` blocks; the plan depends on the shapes alone, so a
    result repeats from run to run."""
    tiles = -(-m // BLOCK_M) * -(-d // BLOCK_D)
    f_tiles = max(1, -(-f // BLOCK_F))
    nsplit = min(f_tiles, max(1, TARGET_BLOCKS // tiles))
    per = -(-f_tiles // nsplit)
    return -(-f_tiles // per), per


def _check(x, w_gate, w_up, w_down, activation) -> None:
    for name, t in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not supported (f32 or bf16)")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (M, D), got "
                         f"{tuple(x.shape)}")
    m, d = x.shape
    f = w_up.shape[-1]
    if w_gate.shape != (d, f) or w_up.shape != (d, f) \
            or w_down.shape != (f, d):
        raise ValueError(f"weights must be (D, F), (D, F), (F, D) for "
                         f"D={d}: got {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)}")
    if activation not in _ACT_CODES:
        raise ValueError(f"activation {activation!r} not in "
                         f"{sorted(_ACT_CODES)}")


def fused_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, activation: str = "silu"
              ) -> torch.Tensor:
    """``(act(x @ w_gate) * (x @ w_up)) @ w_down`` in one kernel.

    x: (M, D) contiguous; w_gate, w_up: (D, F); w_down: (F, D), all
    contiguous and of x's dtype (f32 or bf16).  ``activation`` is silu
    or tanh-gelu.  Sums are f32 across all of F, rounded once to x's
    dtype.  Returns (M, D)."""
    if x.device.type == "cpu":
        return fused_ffn_ref(x, w_gate, w_up, w_down, activation)
    if x.device.type != "cuda":
        raise ValueError(f"no fused FFN kernel for device {x.device}")
    _check(x, w_gate, w_up, w_down, activation)
    m, d = x.shape
    f = w_up.shape[1]
    nsplit, per = split_plan(m, d, f)
    out = torch.empty_like(x)
    ws = (torch.empty((nsplit, m, d), dtype=torch.float32, device=x.device)
          if nsplit > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel_fn()(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), m, d, f,
        nsplit, per, _ACT_CODES[activation], _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_ffn launch failed: CUDA error {err}")
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0
