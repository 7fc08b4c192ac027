"""Paged single-query decode attention: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``paged_decode_attention`` of the JAX
package (``kernels/paged_decode_attn.py``).  The kernel itself is
``csrc/paged_decode_attn.cu`` (its header notes the design and the bound
on the H100: bytes); its plain version is
:func:`repro_torch.kernels.ref.paged_decode_attn_ref`.

:func:`decode_plan` picks the route and sizes a launch from host-known
shapes alone, never from the positions (device data): bf16 q over an
int8 or bf16 pool runs on the tensor cores (``wgmma``: splits sized to
the card's 132 SMs, TMA loads into an mbarrier ring), f32 q or an f32
pool on the CUDA cores (splits of ``SPLIT_COLS`` columns).  The plan also
gives the f32 workspace of the splits' partials, the arrival counters,
the ring depth and the shared memory.  :func:`tma_numbers` gives the
tensor maps the ``wgmma`` route reads the pool through, and refuses a
pool TMA cannot read.

A tensor on the CPU takes the plain version.  A tensor on the card
launches its plan's kernel or raises — there is no fallback.  Each
launch adds one to ``paged_decode_attention.launches``.
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


# the wgmma route (csrc/paged_decode_attn.cu, namespace wg): pool columns
# a tile (wgmma's 64 rows), bytes of a box of row scales in a stage,
# query heads a kv head at most (N 8 or 16), the ring's stages, splits a
# table at most, table entries a split's producer reads at most
WG_TILE, WG_SCALE_SLOT, WG_MAX_GROUP, WG_STAGES = 64, 128, 16, 2
WG_MAX_SPLITS, MAX_ENTRIES = 64, 1024
# the H100: SMs, and the shared memory one block may use, bytes
SMS, BLOCK_SMEM = 132, 232448


@dataclass(frozen=True)
class DecodePlan:
    """How one call runs: its route, its splits (the grid is ``(slots *
    kvh, splits)``) of ``split_cols`` pool columns each, the ring depth
    (``stages``: of each warp on ``cuda_cores``, of the block on
    ``wgmma``), the dynamic shared memory, the f32 workspace
    (``ws_floats``: each split's ``group * hd`` partial sums, then its
    ``(m, l)`` per query head) and the int32 arrival counters, one a
    (slot, kv head), zero between launches.  On ``wgmma`` also: ``n``,
    the group padded to the products' N (8 or 16), ``hd_pad``, the head
    dim padded to whole 64-column blocks, ``rows``, the pool rows of one
    TMA box (a table block's, at most 64), ``pieces``, the boxes of a
    64-column tile, and ``entries``, the table entries a split reads at
    most."""
    splits: int
    stages: int
    smem: int
    ws_floats: int
    counters: int
    route: str = "cuda_cores"
    split_cols: int = SPLIT_COLS
    n: int = 0
    hd_pad: int = 0
    rows: int = 0
    pieces: int = 0
    entries: int = 0


def route_of(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """The route a call takes: ``"wgmma"`` for bf16 q over an int8 or
    bf16 pool, ``"cuda_cores"`` for f32 q or an f32 pool (kept exact for
    the f32 serving path's card == CPU streams)."""
    if q_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q_dtype} not supported (f32 or bf16)")
    if kv_dtype not in _DTYPE_CODES:
        raise ValueError(f"pool dtype {kv_dtype} not supported")
    if q_dtype == torch.bfloat16 and kv_dtype != torch.float32:
        return "wgmma"
    return "cuda_cores"


def wg_smem(hd_pad: int, n: int, hd: int, esize: int, scaled: bool,
            pieces: int, stages: int, entries: int) -> int:
    """The ``wgmma`` route's shared memory as the kernel lays it out
    (``wg::layout``): 1024 bytes of alignment slack; the converted V
    tile and Q (64-column blocks of 128-byte rows) and P^T; the ring's
    stages (K's and V's rows, each box's row scales in a 128-byte slot);
    a full and an empty barrier a stage; the warps' maxima and row sums;
    the new token's 16 scores; a flag; the table entries."""
    stage = 2 * WG_TILE * hd * esize + (2 * pieces * WG_SCALE_SLOT
                                        if scaled else 0)
    stage = -(-stage // 128) * 128
    return (1024 + hd_pad * 128 + (hd_pad // 64) * n * 128 + n * 128
            + stages * stage + 16 * stages + 2 * 16 * n + 4 * WG_MAX_GROUP
            + 16 + 4 * entries)


@functools.lru_cache(maxsize=256)
def decode_plan(slots: int, heads: int, kv_heads: int, head_dim: int,
                block_size: int, max_blocks: int, kv_dtype: torch.dtype,
                q_dtype: torch.dtype = torch.float32) -> DecodePlan:
    """The route and launch geometry of a decode step over ``(slots,
    max_blocks)`` tables of ``block_size``-row pool blocks: a pure
    function of its arguments (kept, since every decode step asks
    again), never of the positions."""
    if route_of(q_dtype, kv_dtype) == "wgmma":
        return _wg_plan(slots, heads, kv_heads, head_dim, block_size,
                        max_blocks, kv_dtype)
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


def _wg_plan(slots, heads, kv_heads, hd, bs, mb, kv_dtype) -> DecodePlan:
    if kv_heads < 1 or heads % kv_heads:
        raise ValueError(f"{heads} query heads do not group over {kv_heads} "
                         "kv heads")
    group = heads // kv_heads
    if group > WG_MAX_GROUP:
        raise ValueError(f"group {group} > {WG_MAX_GROUP}: the bf16 route "
                         "scores at most 16 query heads a kv head")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"head dim {hd}: the bf16 route takes multiples of "
                         "16 from 16 to 256")
    rows = min(bs, WG_TILE)
    if (WG_TILE % bs) if bs < WG_TILE else (bs % WG_TILE):
        raise ValueError(f"block size {bs} must divide {WG_TILE} or be a "
                         f"multiple of it")
    esize, scaled = _ESIZE[kv_dtype], kv_dtype == torch.int8
    if (rows * hd * esize) % 128 or (scaled and (rows * 4) % 16):
        raise ValueError(f"a TMA box of {rows} pool rows (hd {hd}, "
                         f"{kv_dtype}) is not whole 128-byte lines, or its "
                         "row scales not 16-byte ones")
    n = 8 if group <= 8 else 16
    hd_pad = -(-hd // 64) * 64
    pieces = WG_TILE // rows
    base = functools.partial(wg_smem, hd_pad, n, hd, esize, scaled, pieces)
    stages = WG_STAGES
    if base(stages, MAX_ENTRIES + 2) > BLOCK_SMEM:
        raise ValueError(f"hd {hd} over a {kv_dtype} pool needs "
                         f"{base(stages, MAX_ENTRIES + 2)} bytes of shared "
                         "memory")
    # as many splits as fill the SMs' block slots once (the kernel's launch
    # bounds: three blocks an SM below hd 256, two at it): fewer leave
    # SMs idle, more lengthen the merge after the last split (measured by
    # tools/k1_ab.py)
    pairs = slots * kv_heads
    tiles = -(-(mb * bs) // WG_TILE)
    per_sm = 2 if hd_pad == 256 else 3
    splits = max(1, min(tiles, WG_MAX_SPLITS, SMS * per_sm // pairs))
    per = max(-(-tiles // splits), -(-tiles // WG_MAX_SPLITS))
    per = max(1, min(per, (MAX_ENTRIES - 2) * bs // WG_TILE))
    split_cols = per * WG_TILE
    splits = -(-(mb * bs) // split_cols)
    entries = split_cols // bs + 2
    return DecodePlan(splits, stages, base(stages, entries),
                      pairs * splits * group * (hd + 2), pairs, "wgmma",
                      split_cols, n, hd_pad, rows, pieces, entries)


def tma_numbers(k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor], plan: DecodePlan) -> list:
    """The 26 numbers the ``wgmma`` route's C entry encodes its tensor
    maps from: for k_blocks and v_blocks (``(num_blocks, bs, kvh, hd)``,
    one layer's slice, any block stride) the 4 dims (hd, kvh, bs,
    num_blocks), the byte strides of kvh, bs and num_blocks and the box
    (hd columns, ``plan.rows`` rows); then for k_scale and v_scale
    (``(num_blocks, bs)`` f32) the dims (bs, num_blocks), the byte stride
    of num_blocks and the box's ``plan.rows`` scales (zeros for a bf16
    pool).  A dim of extent 1 is never stepped along, so its stride is
    taken as the span of the dims inside it.  Raises ``ValueError`` where
    TMA cannot read a tensor: a base not 16-byte aligned, a stride not a
    positive multiple of 16 bytes or not below 2**40."""
    nums = []
    for name, t in (("k_blocks", k_blocks), ("v_blocks", v_blocks)):
        nb, bs, kvh, hd = t.shape
        es = t.element_size()
        if t.stride()[1:] != (kvh * hd, hd, 1):
            raise ValueError(f"{name}: pool blocks must be dense inside")
        dims = (hd, kvh, bs, nb)
        strides, span = [], hd * es
        for ext, st in ((kvh, hd * es), (bs, kvh * hd * es),
                        (nb, t.stride(0) * es)):
            st = max(span, 16) if ext == 1 else st
            if st <= 0 or st % 16 or st >= 1 << 40:
                raise ValueError(f"{name}: TMA needs each stride a positive "
                                 f"multiple of 16 bytes below 2**40, got "
                                 f"{st} bytes (strides {t.stride()})")
            strides.append(st)
            span = max(span, st * ext)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: TMA needs a 16-byte aligned base")
        nums += [*dims, *strides, hd, plan.rows]
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is None:
            nums += [0, 0, 0, 0]
            continue
        nb, bs = t.shape
        st = 4 * t.stride(0) if nb > 1 else max(4 * bs, 16)
        if t.stride(1) != 1 or st % 16 or st >= 1 << 40 \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: TMA needs dense rows, a 16-byte "
                             f"aligned base and a block stride of whole "
                             f"16 bytes, got strides {t.stride()}")
        nums += [bs, nb, st, plan.rows]
    return nums


def _kernel_fn(route: str):
    lib = _build.load("paged_decode_attn")
    if route == "wgmma":
        fn = lib.paged_decode_attn_wg
        if fn.argtypes is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = ([p] * 12 + [i] * 7 + [ctypes.c_float, p, p, i,
                                                 p])
            fn.restype = ctypes.c_int
        return fn
    fn = lib.paged_decode_attn
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
    plan = decode_plan(slots, h, kvh, hd, bs, mb, k_blocks.dtype, q.dtype)
    out = torch.empty_like(q)
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _build.arrival_counters(q.device, stream, plan.counters)
    bases = (q.data_ptr(), k_blocks.data_ptr(), v_blocks.data_ptr(),
             None if k_scale is None else k_scale.data_ptr(),
             None if v_scale is None else v_scale.data_ptr(),
             tables.data_ptr(), pos.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), out.data_ptr(), ws.data_ptr(),
             counters.data_ptr())
    if plan.route == "wgmma":
        for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new),
                        ("k_scale", k_scale), ("v_scale", v_scale)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
        plan_arr, maps_arr = _wg_numbers(k_blocks, v_blocks, k_scale,
                                         v_scale, plan)
        err = _kernel_fn("wgmma")(
            *bases, slots, h, kvh, hd, bs, mb, window, 1.0 / math.sqrt(hd),
            plan_arr, maps_arr, _DTYPE_CODES[k_blocks.dtype], stream)
    else:
        err = _kernel_fn("cuda_cores")(
            *bases, slots, h, kvh, hd, bs, mb,
            k_blocks.stride(0), 0 if k_scale is None else k_scale.stride(0),
            window, 1.0 / math.sqrt(hd), plan.splits, plan.stages,
            plan.smem, _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_blocks.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attn launch failed ({plan.route})"
                           f": CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


# the wgmma route's plan and tensor-map numbers as ctypes arrays, by the
# pool's and scales' shapes and strides and the plan: a decode step
# repeats one layout a layer, so they are worked out and validated once.
# The bases' alignment, all that changes from call to call, is checked on
# every call.
_LAYOUTS: dict = {}
_LAYOUTS_MAX = 256


def _wg_numbers(k_blocks, v_blocks, k_scale, v_scale, plan):
    key = (k_blocks.dtype, k_blocks.shape, k_blocks.stride(),
           None if k_scale is None else (k_scale.shape, k_scale.stride()),
           plan)
    nums = _LAYOUTS.get(key)
    if nums is None:
        maps = tma_numbers(k_blocks, v_blocks, k_scale, v_scale, plan)
        nums = ((ctypes.c_int * 9)(plan.splits, plan.split_cols,
                                   plan.stages, plan.smem, plan.n,
                                   plan.hd_pad, plan.rows, plan.pieces,
                                   plan.entries),
                (ctypes.c_longlong * 26)(*maps))
        if len(_LAYOUTS) >= _LAYOUTS_MAX:
            _LAYOUTS.clear()
        _LAYOUTS[key] = nums
    return nums


paged_decode_attention.launches = 0
