"""Mamba2 chunked SSD scan: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``ssd_scan`` of the JAX package
(``kernels/ssd_scan.py``), which computes what the model's jnp
``ssm.ssd_scan_ref`` computes.  The kernel itself is
``csrc/ssd_scan.cu`` (its header notes the design and the bound on the
H100); its plain version is :func:`repro_torch.kernels.ref.ssd_scan_ref`.

A tensor on the CPU takes the plain version.  A tensor on the card
launches the kernel or raises — there is no fallback.  Each launch adds
one to ``ssd_scan.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import ssd_scan_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)
STATE_DIMS = (32, 64, 128)
MAX_CHUNK = 1024


def _kernel_fn():
    fn = _build.load("ssd_scan").ssd_scan
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 8 + [i] * 7 + [ll] * 15 + [i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, dt, a, b, c, initial_state, out_dtype) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not supported (f32 or bf16)")
    if (_DTYPE_CODES[x.dtype], _DTYPE_CODES.get(out_dtype)) not in (
            (0, 0), (1, 1), (1, 0)):
        raise ValueError(f"no kernel for x {x.dtype} -> y {out_dtype}")
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x {x.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(
            f"want x (B,S,H,P), dt (B,S,H), b, c (B,S,G,N); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(b.shape)}, "
            f"{tuple(c.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,) \
            or tuple(b.shape[:2]) != (bsz, s) or g == 0 or h % g:
        raise ValueError("dt, a, b, c do not match x (G must divide H)")
    if s < 1:
        raise ValueError("empty sequence")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"(P, N) = ({p}, {n}) not in {HEAD_DIMS} x "
                         f"{STATE_DIMS}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be dense in its last dim")
    if initial_state is not None and (
            tuple(initial_state.shape) != (bsz, h, p, n)
            or initial_state.device != x.device):
        raise ValueError(f"initial_state must be (B,H,P,N) = "
                         f"{(bsz, h, p, n)} on {x.device}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None,
             out_dtype: Optional[torch.dtype] = None):
    """Chunked SSD in the model's layout, f32 inside.

    x: (B, S, H, P); dt: (B, S, H) step sizes after softplus; a: (H,)
    negative decay rates; b, c: (B, S, G, N) with G dividing H (head h
    reads group ``h // (H // G)``, no broadcast copy); optional
    ``initial_state`` (B, H, P, N).  Any strides with a dense last dim:
    the model's views of the conv output are read in place.  The chunk
    is ``min(chunk, S)``, and a ragged S needs no padding.  Returns
    ``(y (B, S, H, P) in out_dtype — x's dtype unless given —, final
    state (B, H, P, N) f32)``."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        # x*dt promotes to f32 as in the model, so the f32 copy of x
        # gives the same sums; y is rounded once to out_dtype
        y, state = ssd_scan_ref(x.float(), dt, a, b, c, chunk=chunk,
                                initial_state=initial_state)
        return y.to(out_dtype), state
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan kernel for device {x.device}")
    _check(x, dt, a, b, c, initial_state, out_dtype)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    chunk = min(chunk, s)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    dt = dt.float()
    a = a.float().contiguous()
    init = (initial_state.float().contiguous()
            if initial_state is not None else None)
    y = torch.empty((bsz, s, h, p), dtype=out_dtype, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    strides = [t.stride(i) for t in (x, dt, b, c, y) for i in range(3)]
    err = _kernel_fn()(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), None if init is None else init.data_ptr(),
        y.data_ptr(), state.data_ptr(), bsz, s, h, g, p, n, chunk,
        *strides, _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
