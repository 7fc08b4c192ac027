"""Flash attention for prefill: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``flash_attention`` of the JAX package
(``kernels/flash_attn.py``).  The kernel itself is ``csrc/flash_attn.cu``
(its header notes the design and the bound on the H100); its plain
version is :func:`repro_torch.kernels.ref.flash_attn_ref`.

:func:`attention_route` names the unit q's dtype runs on: bf16 on the
tensor cores, f32 on the CUDA cores, since the tensor cores would round
f32 to TF32.  :func:`flash_plan` picks the kernel and its tiles: bf16 on
``wgmma`` with TMA loads issued by a producer warpgroup (at hd 64..256
two consumer warpgroups, ``WgTile``; at hd 16 and 32 one, three blocks
an SM, ``NwTile``), f32 on the CUDA cores.  :func:`tma_map` gives the
tensor maps the ``wgmma`` route reads q, k and v through, and refuses a
view that TMA cannot read.  A tensor
on the CPU takes the plain version.  A tensor on the card launches its
plan's kernel or raises — there is no fallback.  Each launch adds one to
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
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .ref import flash_attn_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
# the C entry's route codes
_ROUTE_CODES = {"cuda_cores": 0, "wgmma": 2}
# bf16 head dims on the wgmma route: every one
WGMMA_HEAD_DIMS = (16, 32, 64, 96, 128, 256)
# the wgmma route's register budget a thread (setmaxnreg): the producer
# warpgroup's and, at hd 64..256, each of the two consumer warpgroups'
PRODUCER_REGS, CONSUMER_REGS = 24, 240
# the hd 16/32 kernel's (NwTile): keys a tile, K/V ring stages, and the
# registers of each thread of its one consumer warpgroup (three blocks an
# SM)
NW_BLOCK_K, NW_STAGES, NW_CONSUMER_REGS = 64, 3, 136
TMA_BOX_COLS = 64              # at hd >= 64: a 128-byte swizzle row of bf16
TMA_SWIZZLE_BYTES = 128


class FlashPlan(NamedTuple):
    """One launch of K2: the route, the query rows and keys of a tile,
    the K/V ring's stages, threads, shared memory and registers of a
    block, and the query tiles of a head."""
    route: str
    block_q: int
    block_k: int
    stages: int
    threads: int
    smem: int
    regs: int
    q_tiles: int


class TmaMap(NamedTuple):
    """A 4-d TMA tensor map of a (B, H, S, hd) bf16 view: ``dims``
    innermost first (hd, S, H, B), the byte ``strides`` of S, H and B,
    the ``box`` (columns, rows) one load copies, the swizzle span."""
    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int]
    swizzle: int


def attention_route(dtype: torch.dtype) -> str:
    """The unit q's dtype runs on: ``"tensor_cores"`` (bf16) or
    ``"cuda_cores"`` (f32)."""
    if dtype not in _ROUTES:
        raise ValueError(f"dtype {dtype} not supported (f32 or bf16)")
    return _ROUTES[dtype]


def flash_plan(dtype: torch.dtype, hd: int, seq: int, seq_k: int,
               heads: int, kv_heads: int) -> FlashPlan:
    """The route and launch geometry of one K2 call: a pure function of
    its arguments, mirroring the kernels' constants (``WgTile``,
    ``NwTile``, the f32 kernel's); the C entry refuses
    a ``wgmma`` plan that differs from them."""
    attention_route(dtype)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if seq <= 0 or seq_k <= 0 or kv_heads <= 0 or heads % kv_heads:
        raise ValueError(f"no plan for S {seq}, S_k {seq_k}, {heads} heads "
                         f"over {kv_heads}")
    if dtype == torch.float32:
        bq = bk = 64
        smem = 4 * (bq * (hd + 1) + bk * (hd + 1) + bk * hd + bq * (bk + 1))
        return FlashPlan("cuda_cores", bq, bk, 1, 256, smem, 256 * 255,
                         -(-seq // bq))
    if hd <= 32:
        # NwTile: 64 query rows; two Q slots, the ring of K and V tiles
        # and a tile of ones (the row sums' columns), rows of hd bf16 (the
        # swizzle span); barriers and tile indices
        bq, bk = 64, NW_BLOCK_K
        tile = bk * 2 * hd
        smem = 1024 + 2 * bq * 2 * hd + NW_STAGES * 2 * tile + tile \
            + 8 * (2 * NW_STAGES + 4) + 16
        return FlashPlan("wgmma", bq, bk, NW_STAGES, 256, smem,
                         128 * (PRODUCER_REGS + NW_CONSUMER_REGS),
                         -(-seq // bq))
    hdp = 128 if hd == 96 else hd            # hd 96 in hd 128's layout
    bq, bk = 128, 64 if hd == 256 else 128
    q_slots, stages = (1, 2) if hd == 256 else (2, 4 if hd == 64 else 2)
    smem = 1024 + q_slots * 2 * bq * hdp + stages * 2 * 2 * bk * hdp \
        + 8 * (2 * stages + 2 * q_slots) + 16
    return FlashPlan("wgmma", bq, bk, stages, 384, smem,
                     128 * PRODUCER_REGS + 256 * CONSUMER_REGS,
                     -(-seq // bq))


def tma_map(t: torch.Tensor, box_rows: int,
            box_cols: int = TMA_BOX_COLS) -> TmaMap:
    """The tensor map through which the ``wgmma`` route reads a (B, H, S,
    hd) bf16 view in place: dims (hd, S, H, B), the views' own strides
    in bytes, boxes of ``box_cols`` columns by ``box_rows`` rows, the
    box's row the swizzle span (64 columns: 128 bytes, the hd >= 64
    kernel's and K6's; the hd 16/32 kernel's box is hd columns, 32 or 64
    bytes).  A dim of extent 1 is never stepped along, so its
    stride is taken as the span of the dims inside it.  Raises
    ``ValueError`` where TMA cannot read the view: a base not 16-byte
    aligned, a stride not a positive multiple of 16 bytes or not below
    2**40, a last dim that is not dense, a box row that is no swizzle
    span."""
    shape, stride = t.shape, t.stride()
    if len(shape) != 4 or t.dtype != torch.bfloat16:
        raise ValueError(f"tma_map takes a 4-d bf16 view, got "
                         f"{tuple(shape)} {t.dtype}")
    if not 0 < box_rows <= 256:
        raise ValueError(f"TMA boxes hold 1..256 rows, not {box_rows}")
    if stride[3] != 1:
        raise ValueError("TMA needs the last dim dense")
    if t.data_ptr() % 16:
        raise ValueError(f"TMA needs a 16-byte aligned base, got "
                         f"{t.data_ptr() % 16} bytes off")
    b, h, s, hd = shape
    span = 2 * hd
    strides = []
    for n, st in ((s, 2 * stride[2]), (h, 2 * stride[1]), (b, 2 * stride[0])):
        if n == 1:
            st = max(span, 16)
        if st <= 0 or st % 16 or st >= 1 << 40:
            raise ValueError(f"TMA needs each stride a positive multiple "
                             f"of 16 bytes below 2**40, got {st} bytes "
                             f"in {tuple(shape)} with strides {stride}")
        strides.append(st)
        span = max(span, st * n)
    if 2 * box_cols not in (32, 64, 128):
        raise ValueError(f"TMA's swizzles span 32, 64 or 128 bytes: no "
                         f"box of {box_cols} bf16 columns")
    return TmaMap((hd, s, h, b), tuple(strides), (box_cols, box_rows),
                  2 * box_cols)


def tma_numbers(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                plan: FlashPlan) -> list:
    """The 27 numbers the C entry encodes its tensor maps from: for q
    (boxes of ``block_q`` rows), k and v (``block_k`` rows) in turn, the
    4 dims, the 3 byte strides and the box (columns, rows): 64 columns,
    or hd at hd 16 and 32."""
    cols = min(q.shape[3], TMA_BOX_COLS)
    return [x for t, rows in ((q, plan.block_q), (k, plan.block_k),
                              (v, plan.block_k))
            for m in (tma_map(t, rows, cols),)
            for x in (*m.dims, *m.strides, *m.box)]


def _kernel_fn():
    fn = _build.load("flash_attn").flash_attn
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 4 + [i] * 6 + [ll] * 12
                       + [i, i, i, ctypes.c_float, i, i, p, p, p, p])
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
        # TMA copies 16-byte row segments
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


class _LaunchNumbers(NamedTuple):
    """What the C entry takes besides the base pointers and the masks,
    for one layout of q, k and v."""
    plan: FlashPlan
    strides: Tuple[int, ...]     # B, H and S strides of q, k, v and out
    plan_arr: ctypes.Array       # block_q, block_k, stages, threads, smem
    maps_arr: ctypes.Array       # tma_numbers (zeros on the f32 route)


# _LaunchNumbers by q's dtype and the shapes and strides of q, k and v:
# a prefill repeats a few layouts once a layer, so the plan and tensor
# map numbers are worked out and validated once a layout, not each
# launch.  They depend on nothing else: the bases' alignment, all that
# changes from call to call, is checked by _check on every call.
_LAYOUTS: dict = {}
_LAYOUTS_MAX = 256


def _launch_numbers(q, k, v, out) -> _LaunchNumbers:
    key = (q.dtype, q.shape, q.stride(), k.shape, k.stride(), v.stride())
    nums = _LAYOUTS.get(key)
    if nums is None:
        b, h, s, hd = q.shape
        plan = flash_plan(q.dtype, hd, s, k.shape[2], h, k.shape[1])
        maps = (tma_numbers(q, k, v, plan) if plan.route == "wgmma"
                else [0] * 27)
        nums = _LaunchNumbers(
            plan, tuple(t.stride(i) for t in (q, k, v, out)
                        for i in range(3)),
            (ctypes.c_int * 5)(plan.block_q, plan.block_k, plan.stages,
                               plan.threads, plan.smem),
            (ctypes.c_longlong * 27)(*maps))
        if len(_LAYOUTS) >= _LAYOUTS_MAX:
            _LAYOUTS.clear()
        _LAYOUTS[key] = nums
    return nums


def _launch(q, k, v, causal, window, kv_len) -> torch.Tensor:
    b, h, s, hd = q.shape
    # empty_like's strides follow q's layout, which is in the key
    out = torch.empty_like(q)
    nums = _launch_numbers(q, k, v, out)
    plan = nums.plan
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counter = (_build.arrival_counters(q.device, stream, 1).data_ptr()
               if plan.route == "wgmma" else None)
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, k.shape[1], s, k.shape[2], hd, *nums.strides, int(causal),
        window, -1 if kv_len is None else kv_len, 1.0 / math.sqrt(hd),
        _DTYPE_CODES[q.dtype], _ROUTE_CODES[plan.route], nums.plan_arr,
        nums.maps_arr, counter, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn launch failed ({plan.route}): CUDA "
                           f"error {err}")
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
