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

Gradients: when autograd records (grad mode on and q, k or v requiring
grad), the launch runs inside a ``torch.autograd.Function`` that saves
q, k, v and the output, and whose backward is
:func:`flash_attention_backward`, the analytic gradient in PyTorch ops.
The JAX package has no backward kernel either (its gradients are XLA's
products outside the Pallas call).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import flash_attn_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
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
        fn.argtypes = ([p] * 4 + [i] * 6 + [ll] * 12
                       + [i, i, i, ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, kv_len, causal=False) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (f32 or bf16)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, hd) and k, v (B, K, Sk, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, hd = q.shape
    kb, kvh, ks, khd = k.shape
    if (kb, khd) != (b, hd) or ks == 0 or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (K must divide H)")
    if ks != s and (causal or window):
        # these masks compare a key's column with a query's row: one
        # sequence on both sides
        raise ValueError(f"causal or window masks need as many keys as "
                         f"queries, got {ks} keys for {s} queries")
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

    q: (B, H, Sq, hd); k, v: (B, K, Sk, hd) with K dividing H (query head
    h reads kv head ``h // (H // K)``; K == H is the JAX package's
    pre-broadcast layout).  Sk may differ from Sq (a decoder's
    cross-attention over encoder frames), and then ``causal`` and
    ``window`` raise.  Any strides with a dense last dim: the model's
    (B, S, H, hd) tensors pass as ``.transpose(1, 2)`` views and are read
    in place.  Masks: ``causal`` (col <= row), ``window`` (col > row -
    window) and ``kv_len`` (col < kv_len); a row with no valid key is
    exactly 0.  The output has q's strides, so a transposed view of a
    contiguous q gives an output whose ``.transpose(1, 2)`` is
    contiguous."""
    if q.device.type == "cpu":
        group = q.shape[1] // k.shape[1]
        return flash_attn_ref(q, k.repeat_interleave(group, dim=1),
                              v.repeat_interleave(group, dim=1),
                              causal=causal, window=window, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    _check(q, k, v, window, kv_len, causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, kv_len)
    return _launch(q, k, v, causal, window, kv_len)


def _launch(q, k, v, causal, window, kv_len) -> torch.Tensor:
    b, h, s, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, k.shape[1], s, k.shape[2], hd, *strides, int(causal),
        window, -1 if kv_len is None else kv_len, 1.0 / math.sqrt(hd),
        _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attn launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The kernel's launch, differentiable: the forward launches it, the
    backward is :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len):
        out = _launch(q, k, v, causal, window, kv_len)
        ctx.save_for_backward(q, k, v, out)
        ctx.masks = dict(causal=causal, window=window, kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout,
                                              **ctx.masks)
        return dq, dk, dv, None, None, None


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool = True,
                             window: int = 0, kv_len: Optional[int] = None):
    """The gradient of :func:`flash_attention`: ``(dq, dk, dv)`` in the
    dtypes of q, k and v, f32 inside (f64 for f64 inputs).

    P is recomputed under the forward's masks (causal, window,
    ``kv_len``; a row with no valid key has P = 0), then ``dV = P^T dO``,
    ``dP = dO V^T``, ``dS = P * (dP - rowsum(dO * O))``, ``dQ = dS K``
    and ``dK = dS^T Q`` (both scaled by 1/sqrt(hd)); dK and dV are summed
    over each GQA group of query heads.  ``out`` is the forward's output.
    Any strides; memory is O(B H Sq Sk)."""
    b, h, s, hd = q.shape
    sk = k.shape[2]
    group = h // k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(hd)
    qf, of, dof = q.to(acc), out.to(acc), dout.to(acc)
    kf = k.to(acc).repeat_interleave(group, dim=1)
    vf = v.to(acc).repeat_interleave(group, dim=1)
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= cols <= rows
    if window:
        valid &= cols > rows - window
    if kv_len is not None:
        valid &= cols < kv_len
    scores = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=-1)
    p = torch.nan_to_num(p, nan=0.0)          # rows with no valid key
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    kvh = k.shape[1]
    dk = dk.reshape(b, kvh, group, sk, hd).sum(dim=2)
    dv = dv.reshape(b, kvh, group, sk, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
