"""Paged single-query decode attention: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``paged_decode_attention`` of the JAX
package (``kernels/paged_decode_attn.py``).  The kernel itself is
``csrc/paged_decode_attn.cu`` (its header notes the design and the bound
on the H100: bytes); its plain version is
:func:`repro_torch.kernels.ref.paged_decode_attn_ref`.

:func:`decode_plan` sizes a launch from host-known shapes alone: the
table is split across blocks in runs of ``SPLIT_COLS`` pool columns, so
the split count follows the table's width, never the positions (device
data).  The plan also gives the f32 workspace of the splits' partials,
the arrival counters, the ring depth and the shared memory.

A tensor on the CPU takes the plain version.  A tensor on the card
launches the kernel or raises — there is no fallback.  Each launch adds
one to ``paged_decode_attention.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build
from .ref import paged_decode_attn_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
# csrc/paged_decode_attn.cu: pool columns a block (kSplitCols), columns
# a warp scores at once (kTile), warps a block (kWarps)
SPLIT_COLS, TILE_COLS, WARPS = 128, 16, 4
# dynamic shared memory a block may ask for on the H100 (227 KB, less the
# kernel's own static word); a two-slot ring is kept while it fits here
MAX_SMEM, RING_SMEM = 232448 - 1024, 200 * 1024


@dataclass(frozen=True)
class DecodePlan:
    """How one call runs: its splits (the grid is ``(slots * kvh,
    splits)``), the ring depth of each warp (``stages``), the dynamic
    shared memory, the f32 workspace (``ws_floats``: each split's
    ``group * hd`` partial sums, then its ``(m, l)`` per query head) and
    the int32 arrival counters, one a (slot, kv head), zero between
    launches."""
    splits: int
    stages: int
    smem: int
    ws_floats: int
    counters: int


@functools.lru_cache(maxsize=256)
def decode_plan(slots: int, heads: int, kv_heads: int, head_dim: int,
                block_size: int, max_blocks: int,
                kv_dtype: torch.dtype) -> DecodePlan:
    """The launch geometry of a decode step over ``(slots, max_blocks)``
    tables of ``block_size``-row pool blocks: a pure function of its
    arguments (kept, since every decode step asks again)."""
    if kv_dtype not in _DTYPE_CODES:
        raise ValueError(f"pool dtype {kv_dtype} not supported")
    esize = _ESIZE[kv_dtype]
    if (head_dim * esize) % 16:
        raise ValueError(f"a pool row of one head ({head_dim} x {esize} "
                         "bytes) must be a whole number of 16-byte chunks")
    group = heads // kv_heads
    splits = -(-(max_blocks * block_size) // SPLIT_COLS)

    def smem(stages):
        slot = 2 * TILE_COLS * head_dim * esize + 2 * TILE_COLS * 4
        warp = stages * slot + 4 * (2 * -(-group // 4) * 4
                                    + group * head_dim)
        return 4 * group * head_dim + WARPS * warp

    stages = 2 if smem(2) <= RING_SMEM else 1
    if smem(stages) > MAX_SMEM:
        raise ValueError(f"group {group} x head dim {head_dim} needs "
                         f"{smem(stages)} bytes of shared memory")
    n_rec = slots * kv_heads * splits
    return DecodePlan(splits, stages, smem(stages),
                      n_rec * group * (head_dim + 2), slots * kv_heads)


def _kernel_fn():
    fn = _build.load("paged_decode_attn").paged_decode_attn
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 12 + [i] * 6 + [ll, ll, i, ctypes.c_float,
                                              i, i, ll, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_blocks, v_blocks, tables, pos, k_new, v_new, k_scale,
           v_scale, window) -> None:
    dev = q.device
    named = dict(q=q, k_blocks=k_blocks, v_blocks=v_blocks, tables=tables,
                 pos=pos, k_new=k_new, v_new=v_new)
    if k_scale is not None:
        named.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dim() != 3 or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be (slots, H, hd) f32/bf16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    slots, h, hd = q.shape
    if k_blocks.dim() != 4 or k_blocks.shape[3] != hd:
        raise ValueError(f"k_blocks must be (num_blocks, bs, kvh, {hd}), "
                         f"got {tuple(k_blocks.shape)}")
    nb, bs, kvh, _ = k_blocks.shape
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if v_blocks.shape != k_blocks.shape or v_blocks.dtype != k_blocks.dtype \
            or v_blocks.stride() != k_blocks.stride():
        raise ValueError("v_blocks must match k_blocks in shape, dtype and "
                         "strides")
    if k_blocks.dtype not in _DTYPE_CODES:
        raise ValueError(f"pool dtype {k_blocks.dtype} not supported")
    # any block stride (one layer of a layer-interleaved pool); each block
    # itself must be dense
    if k_blocks.stride()[1:] != (kvh * hd, hd, 1):
        raise ValueError(f"pool blocks must be dense inside, got strides "
                         f"{k_blocks.stride()}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (slots, kvh, hd) or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({slots}, {kvh}, "
                             f"{hd}) {q.dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if tables.dim() != 2 or tables.shape[0] != slots \
            or tables.dtype != torch.int32 or not tables.is_contiguous():
        raise ValueError("tables must be contiguous (slots, mb) int32")
    if pos.shape != (slots,) or pos.dtype != torch.int32 \
            or not pos.is_contiguous():
        raise ValueError("pos must be contiguous (slots,) int32")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if (k_scale is not None) != (k_blocks.dtype == torch.int8):
        raise ValueError("int8 pools take row scales, other pools none")
    if k_scale is not None:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != (nb, bs) or t.dtype != torch.float32 \
                    or t.stride(1) != 1 or t.stride() != k_scale.stride():
                raise ValueError(f"{name} must be ({nb}, {bs}) f32 with "
                                 "dense rows")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    # rows are copied 16 bytes at a time
    if k_blocks.data_ptr() % 16 or v_blocks.data_ptr() % 16 \
            or (k_blocks.stride(0) * k_blocks.element_size()) % 16:
        raise ValueError("pool blocks must start on 16-byte boundaries")


def paged_decode_attention(q: torch.Tensor, k_blocks: torch.Tensor,
                           v_blocks: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: int = 0) -> torch.Tensor:
    """Single-query GQA attention straight off the block table.

    q: (slots, H, hd) f32/bf16; k/v_blocks: (num_blocks, bs, kvh, hd) —
    ONE layer's pool slice, int8/bf16/f32, any stride between blocks;
    tables: (slots, mb) int32; pos: (slots,) int32 tokens already
    resident (at most mb * bs); k_new/v_new: (slots, kvh, hd) in q's
    dtype — the current token's KV, not yet scattered.  int8 pools pass
    k/v_scale: (num_blocks, bs) f32 per-row scales.  Returns
    (slots, H, hd) in q's dtype, accumulated in f32.  Table entries must
    be valid block ids; the kernel does not check them."""
    if q.device.type == "cpu":
        return paged_decode_attn_ref(q, k_blocks, v_blocks, tables, pos,
                                     k_new, v_new, k_scale=k_scale,
                                     v_scale=v_scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    _check(q, k_blocks, v_blocks, tables, pos, k_new, v_new, k_scale,
           v_scale, window)
    slots, h, hd = q.shape
    _, bs, kvh, _ = k_blocks.shape
    mb = tables.shape[1]
    plan = decode_plan(slots, h, kvh, hd, bs, mb, k_blocks.dtype)
    out = torch.empty_like(q)
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _build.arrival_counters(q.device, stream, plan.counters)
    err = _kernel_fn()(
        q.data_ptr(), k_blocks.data_ptr(), v_blocks.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), out.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), slots, h, kvh, hd, bs, mb,
        k_blocks.stride(0), 0 if k_scale is None else k_scale.stride(0),
        window, 1.0 / math.sqrt(hd), plan.splits, plan.stages, plan.smem,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_blocks.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attn launch failed: CUDA error "
                           f"{err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
