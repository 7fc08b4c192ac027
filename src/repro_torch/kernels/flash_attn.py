"""Flash attention for prefill: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``flash_attention`` of the JAX package
(``kernels/flash_attn.py``).  The kernel itself is ``csrc/flash_attn.cu``
(its header notes the design and the bound on the H100); its plain
version is :func:`repro_torch.kernels.ref.flash_attn_ref`.

:func:`attention_route` picks the route from q's dtype: bf16 runs on
the tensor cores (``mma.sync``), f32 on the CUDA cores, since the
tensor cores would round f32 to TF32.  A tensor on the CPU takes the
plain version.  A tensor on the card launches its route's kernel or
raises — there is no fallback.  Each launch adds one to
``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import flash_attn_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
_ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}


def attention_route(dtype: torch.dtype) -> str:
    """The kernel route for q's dtype: ``"tensor_cores"`` (bf16) or
    ``"cuda_cores"`` (f32)."""
    if dtype not in _ROUTES:
        raise ValueError(f"dtype {dtype} not supported (f32 or bf16)")
    return _ROUTES[dtype]


def _kernel_fn():
    fn = _build.load("flash_attn").flash_attn
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 4 + [i] * 5 + [ll] * 12
                       + [i, i, i, ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, kv_len) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (f32 or bf16)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, S, hd) and k, v (B, K, S, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, hd = q.shape
    kb, kvh, ks, khd = k.shape
    if (kb, ks, khd) != (b, s, hd) or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (K must divide H)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be dense in its last dim")
    if attention_route(q.dtype) == "tensor_cores":
        # the tensor-core route copies 16-byte row segments
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)
                                        if t.shape[i] > 1):
                raise ValueError(f"bf16 needs {name}'s rows 16-byte "
                                 f"aligned (base and strides)")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if kv_len is not None and kv_len < 0:
        raise ValueError(f"kv_len {kv_len} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Masked attention, f32 sums inside, out in q's dtype.

    q: (B, H, S, hd); k, v: (B, K, S, hd) with K dividing H (query head h
    reads kv head ``h // (H // K)``; K == H is the JAX package's
    pre-broadcast layout).  Any strides with a dense last dim: the
    model's (B, S, H, hd) tensors pass as ``.transpose(1, 2)`` views and
    are read in place.  Masks: ``causal`` (col <= row), ``window``
    (col > row - window) and ``kv_len`` (col < kv_len); a row with no
    valid key is exactly 0.  The output has q's strides, so a transposed
    view of a contiguous q gives an output whose ``.transpose(1, 2)`` is
    contiguous."""
    if q.device.type == "cpu":
        b, h, s, hd = q.shape
        group = h // k.shape[1]
        return flash_attn_ref(q, k.repeat_interleave(group, dim=1),
                              v.repeat_interleave(group, dim=1),
                              causal=causal, window=window, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    _check(q, k, v, window, kv_len)
    b, h, s, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, k.shape[1], s, hd, *strides, int(causal), window,
        -1 if kv_len is None else kv_len, 1.0 / math.sqrt(hd),
        _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attn launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
