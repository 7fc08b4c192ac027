"""Blockwise activation quantization: the CUDA kernels' wrappers, and the
per-row int8 quantization of paged-KV storage.

``act_quant`` / ``act_dequant`` (int8) and ``act_quant4`` /
``act_dequant4`` (packed int4) replace the Pallas TPU kernels of the
same names in the JAX package (``kernels/act_quant.py``).  The kernels
are ``csrc/act_quant.cu`` (its header notes the design and the bound on
the H100); their plain versions are
:func:`repro_torch.kernels.ref.act_quant_ref` and its siblings.

Each row of ``x`` (M, n) is cut into blocks of 128 elements, with one
f32 scale per block.  The JAX kernels take ``n % 128 == 0``; these take
any ``n``: the last block is short and its missing columns count as
zeros, which is the JAX codec's zero padding (``engine/act_compress``)
without the padding copy.  int8 codes keep the row's length; int4 packs
the padded row, ``ceil(n / 128) * 64`` bytes, and every padded byte is
``0x88`` (code 0, biased by 8).

A tensor on the CPU takes the plain version.  A tensor on the card
launches the kernel or raises — there is no fallback.  Each launch adds
one to the wrapper's ``launches``.  The kernels' arithmetic is the plain
version's element by element (IEEE division, round half to even), so
their codes, packed bytes, scales and dequantized values are bit-equal
to it for finite inputs.  A NaN in a block gives codes that are not
defined: the kernel's absmax drops it, the plain version's keeps it.

``kv_quant_rows`` / ``kv_dequant_rows`` are plain PyTorch, as the JAX
package computes them outside any kernel too; the paged decode kernel
dequantizes inside its block loop with the scales made here.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import (QBLOCK, act_dequant4_ref, act_dequant_ref,
                  act_quant4_ref, act_quant_ref)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel_fn(name: str):
    fn = getattr(_build.load("act_quant"), name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _blocks(n: int) -> int:
    return -(-n // QBLOCK)


def _launch(wrapper, name: str, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, rows: int, n: int, dtype: torch.dtype,
            vec: bool) -> None:
    """Launch ``name`` and count it on ``wrapper``; no rows, no launch."""
    if not rows:
        return
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _kernel_fn(name)(a.data_ptr(), b.data_ptr(), c.data_ptr(), rows, n,
                           _DTYPE_CODES[dtype], int(vec), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    wrapper.launches += 1


def _on_card(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {t.device}")
    return True


def _check_x(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"x must be (M, n), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not supported (f32 or bf16)")
    if x.shape[1] < 1:
        raise ValueError("rows must not be empty")
    return x.contiguous()


def _check_out(out_dtype: torch.dtype) -> None:
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"out_dtype {out_dtype} not supported (f32 or "
                         "bf16)")


def _check_scales(scales: torch.Tensor, rows: int, n: int,
                  device: torch.device) -> torch.Tensor:
    if scales.dtype != torch.float32 or tuple(scales.shape) != (
            rows, _blocks(n)) or scales.device != device:
        raise ValueError(f"scales must be f32 ({rows}, {_blocks(n)}) on "
                         f"{device}, got {scales.dtype} "
                         f"{tuple(scales.shape)} on {scales.device}")
    return scales.contiguous()


def _vec_ok(n: int, *tensors: torch.Tensor) -> bool:
    """Vector loads and stores: 4 elements a lane, so n % 4 == 0 and each
    tensor aligned to 4 of its elements."""
    if n % 4:
        return False
    return all(t.data_ptr() % (4 * t.element_size()) == 0
               for t in tensors)


def act_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, n) f32/bf16 -> (codes int8 (M, n), scales f32 (M,
    ceil(n/128))), ``scale = amax/127 + 1e-12`` per 128-wide block."""
    if not _on_card(x, "act_quant"):
        return act_quant_ref(x)
    x = _check_x(x)
    m, n = x.shape
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    s = torch.empty((m, _blocks(n)), dtype=torch.float32, device=x.device)
    _launch(act_quant, "act_quant8", x, q, s, m, n, x.dtype,
            _vec_ok(n, x, q))
    return q, s


def act_dequant(q: torch.Tensor, scales: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """codes int8 (M, n), scales f32 (M, ceil(n/128)) -> (M, n) in
    ``out_dtype`` (f32 or bf16): code * scale in f32, rounded once."""
    if not _on_card(q, "act_dequant"):
        return act_dequant_ref(q, scales, out_dtype)
    if q.dim() != 2 or q.dtype != torch.int8 or q.shape[1] < 1:
        raise ValueError(f"codes must be int8 (M, n), got {q.dtype} "
                         f"{tuple(q.shape)}")
    _check_out(out_dtype)
    m, n = q.shape
    q = q.contiguous()
    scales = _check_scales(scales, m, n, q.device)
    out = torch.empty((m, n), dtype=out_dtype, device=q.device)
    _launch(act_dequant, "act_dequant8", q, scales, out, m, n, out_dtype,
            _vec_ok(n, q, out))
    return out


def act_quant4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, n) f32/bf16 -> (packed uint8 (M, ceil(n/128) * 64), scales
    f32 (M, ceil(n/128))): codes in [-7, 7] biased by +8, byte j holding
    column 2j in its low nibble and column 2j+1 in its high nibble;
    ``scale = amax/7 + 1e-12``."""
    if not _on_card(x, "act_quant4"):
        return act_quant4_ref(x)
    x = _check_x(x)
    m, n = x.shape
    nb = _blocks(n)
    packed = torch.empty((m, nb * QBLOCK // 2), dtype=torch.uint8,
                         device=x.device)
    s = torch.empty((m, nb), dtype=torch.float32, device=x.device)
    _launch(act_quant4, "act_quant4", x, packed, s, m, n, x.dtype,
            _vec_ok(n, x))
    return packed, s


def act_dequant4(packed: torch.Tensor, scales: torch.Tensor,
                 out_dtype: torch.dtype = torch.bfloat16,
                 n: Optional[int] = None) -> torch.Tensor:
    """packed uint8 (M, ceil(n/128) * 64) from :func:`act_quant4`, scales
    f32 (M, ceil(n/128)) -> (M, n) in ``out_dtype``.  ``n`` defaults to
    twice the packed width (the JAX kernel's contract)."""
    if not _on_card(packed, "act_dequant4"):
        return act_dequant4_ref(packed, scales, out_dtype, n)
    if packed.dim() != 2 or packed.dtype != torch.uint8:
        raise ValueError(f"packed must be uint8 (M, W), got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    _check_out(out_dtype)
    m, width = packed.shape
    n = 2 * width if n is None else n
    if n < 1 or width != _blocks(n) * QBLOCK // 2:
        raise ValueError(f"packed width {width} does not hold n={n} "
                         f"(want {_blocks(max(n, 1)) * QBLOCK // 2})")
    packed = packed.contiguous()
    if packed.data_ptr() % 2:
        packed = packed.clone()
    scales = _check_scales(scales, m, n, packed.device)
    out = torch.empty((m, n), dtype=out_dtype, device=packed.device)
    _launch(act_dequant4, "act_dequant4", packed, scales, out, m, n,
            out_dtype, _vec_ok(n, out))
    return out


act_quant.launches = 0
act_dequant.launches = 0
act_quant4.launches = 0
act_dequant4.launches = 0


# ----------------------------------------------------- paged-KV helpers ----
def kv_quant_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization.

    ``x``: (..., kvh, hd) — one KV row (one token, all kv heads) per
    leading index.  One f32 scale per row (amax over the trailing
    (kvh, hd)), ``scale = amax/127 + 1e-12``; codes round half to even.
    Returns (q int8 same shape, scale f32 with the last two dims gone)."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequant_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`kv_quant_rows`: q (..., kvh, hd) int8 with
    per-row scale (...) -> (..., kvh, hd) in ``dtype``."""
    return (q.float() * scale[..., None, None]).to(dtype)
