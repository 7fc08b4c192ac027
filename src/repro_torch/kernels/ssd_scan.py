"""Mamba2 chunked SSD scan: the CUDA kernels' wrapper.

Replaces the Pallas TPU kernel ``ssd_scan`` of the JAX package
(``kernels/ssd_scan.py``), which computes what the model's jnp
``ssm.ssd_scan_ref`` computes.  The kernels themselves are in
``csrc/ssd_scan.cu`` (its header notes the design and the bound on the
H100); their plain version is :func:`repro_torch.kernels.ref.ssd_scan_ref`.

:func:`ssd_plan` sizes a call from its shapes alone.  bf16 x, b and c
take the ``wgmma`` route: one persistent launch whose blocks take work
items (one chunk of one batch element and head) from a ticket counter
in chunk order and chain the state through L2, with per-(batch, head)
flags; it reads x, b and c through
the tensor maps of :func:`ssd_tma_numbers`, and takes chunks of up to
``WG_MAX_CHUNK`` rows.  f32 takes the ``cuda_cores`` route: two launches
(chunk state, whose last block of each head carries the state across the
chunks; chunk scan) through two f32 workspaces, which the wrapper
allocates on the caller's stream.  Both count on zeroed counters from
``_build.arrival_counters`` and leave them at zero.

A tensor on the CPU takes the plain version.  A tensor on the card
launches the kernels or raises — there is no fallback.  Each call adds
one to ``ssd_scan.launches``.

Gradients: when autograd records (grad mode on and any input requiring
grad), the launch runs inside a ``torch.autograd.Function`` that saves
its inputs, and whose backward is :func:`ssd_scan_backward`, the
gradient of the plain version in PyTorch ops (the JAX package
differentiates its jnp scan; it has no backward kernel either).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build
from .flash_attn import tma_map
from .ref import ssd_scan_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)
STATE_DIMS = (32, 64, 128)
MAX_CHUNK = 1024
# the wgmma route keeps a whole chunk's B and X in shared memory
WG_MAX_CHUNK = 256
# rows of a tile: a query tile of the scan, a TMA box of the wgmma route
TILE_ROWS = 64
_ROUTES = {torch.float32: "cuda_cores", torch.bfloat16: "wgmma"}
# the wgmma route's block (csrc/ssd_scan.cu, namespace wg): a producer
# warpgroup and two consumer warpgroups, one block an SM
WG_THREADS = 384
# C tiles in flight for each consumer group (Smem<NP, HPI>::kCSlots)
C_SLOTS = 2


@dataclass(frozen=True)
class SsdPlan:
    """How one call runs: its route, chunk, chunk count and 64-row tiles
    a chunk.  ``wgmma``: ``items`` items (tickets: one a (chunk, batch
    element, head)), ``threads`` and ``smem`` of a block (the grid is
    the SMs, or fewer where there are fewer items), ``flags`` (one a
    (batch, head)) after the ticket counter in ``counters``.
    ``cuda_cores``: a chunk-state launch of a block a (batch x head,
    chunk) and a chunk-scan launch of a block a (batch x head, chunk,
    query tile) (no items, threads or smem: the C entry sizes them), f32
    workspaces
    (``cs_floats``: the cumulative decay of every row; ``state_floats``:
    one (P, N) state a chunk) and ``counters`` arrival counters (one a
    (batch x head)).  Every counter is zero between launches."""
    route: str                   # "wgmma" | "cuda_cores"
    chunk: int
    chunks: int
    q_tiles: int
    items: int
    threads: int
    smem: int
    cs_floats: int
    state_floats: int
    flags: int
    counters: int


def wg_smem(state_dim: int) -> int:
    """Shared memory of one block of the wgmma route (``Smem<NP>`` of
    ``csrc/ssd_scan.cu``): 1024 bytes of alignment; B (N padded to NP =
    max(N, 64) columns) and X over ``WG_MAX_CHUNK`` rows; the split
    state (high and low parts, 64 rows x NP); two 64-row C tiles for
    each consumer group; two buffers of the per-row values (dt, cs, the
    state weights, the scores' decay factors; the decay at each 64-row
    tile's end; cs_last); the 23 barriers and two tickets."""
    np_ = 128 if state_dim == 128 else 64
    rows, box = WG_MAX_CHUNK, TILE_ROWS * 128
    return (1024 + np_ * rows * 2 + rows * 128 + 2 * (np_ // 64) * box
            + 2 * C_SLOTS * (np_ // 64) * box + 2 * 4 * (4 * rows + 8)
            + 8 * 23 + 16)


@functools.lru_cache(maxsize=256)
def ssd_plan(dtype: torch.dtype, batch: int, seq: int, heads: int,
             head_dim: int, state_dim: int, chunk: int) -> SsdPlan:
    """The route and launch geometry of a scan of ``batch`` sequences of
    ``seq`` rows in ``dtype``: a pure function of its arguments (kept,
    since every layer of a prefill asks again).  The chunk is
    ``min(chunk, seq)``."""
    if dtype not in _ROUTES:
        raise ValueError(f"dtype {dtype} not supported (f32 or bf16)")
    if seq < 1:
        raise ValueError("empty sequence")
    route = _ROUTES[dtype]
    chunk = min(chunk, seq)
    limit = WG_MAX_CHUNK if route == "wgmma" else MAX_CHUNK
    if not 1 <= chunk <= limit:
        raise ValueError(f"chunk {chunk} not in [1, {limit}] ({route})")
    chunks = -(-seq // chunk)
    q_tiles = -(-chunk // TILE_ROWS)
    bh = batch * heads
    if route == "wgmma":
        if head_dim not in HEAD_DIMS or state_dim not in STATE_DIMS:
            raise ValueError(f"(P, N) = ({head_dim}, {state_dim}) not in "
                             f"{HEAD_DIMS} x {STATE_DIMS}")
        return SsdPlan(route, chunk, chunks, q_tiles,
                       items=batch * chunks * heads, threads=WG_THREADS,
                       smem=wg_smem(state_dim),
                       cs_floats=0, state_floats=0, flags=bh,
                       counters=1 + bh)
    return SsdPlan(route, chunk, chunks, q_tiles, 0, 0, 0,
                   cs_floats=bh * seq,
                   state_floats=bh * chunks * head_dim * state_dim,
                   flags=0, counters=bh)


def ssd_tma_numbers(x: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> list:
    """The 27 numbers the wgmma route encodes its tensor maps from: for
    x (B, S, H, P), b and c (B, S, G, N) in turn, the 4 dims (columns, S,
    heads or groups, B), the 3 byte strides of S, heads and B, and the
    box (64 columns, 64 rows) (:func:`flash_attn.tma_map` of the (B,
    H|G, S, P|N) view).  Raises ``ValueError`` where TMA cannot read a
    view in place."""
    return [v for t in (x, b, c)
            for m in (tma_map(t.permute(0, 2, 1, 3), TILE_ROWS),)
            for v in (*m.dims, *m.strides, *m.box)]


# the wgmma route's tensor-map numbers as a ctypes array, by the dtype,
# shapes and strides of x, b and c: a prefill repeats a few layouts once
# a layer, so they are worked out and checked once a layout; only the
# bases' alignment changes from call to call (checked by _check)
_MAPS: dict = {}
_MAPS_MAX = 256


def _wg_maps(x, b, c) -> ctypes.Array:
    key = (x.dtype, x.shape, x.stride(), b.shape, b.stride(), c.stride())
    maps = _MAPS.get(key)
    if maps is None:
        maps = (ctypes.c_longlong * 27)(*ssd_tma_numbers(x, b, c))
        if len(_MAPS) >= _MAPS_MAX:
            _MAPS.clear()
        _MAPS[key] = maps
    return maps


def _kernel_fn():
    fn = _build.load("ssd_scan").ssd_scan
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 11 + [i] * 9 + [ll] * 15 + [i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _wg_fn():
    fn = _build.load("ssd_scan").ssd_scan_wg
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 9 + [i] * 8 + [ll] * 6 + [i, p, p, p]
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
    if x.dtype == torch.bfloat16:
        # the wgmma route reads x, b and c through TMA maps: their
        # strides once a layout, their bases every call
        _wg_maps(x, b, c)
        for name, t in (("x", x), ("b", b), ("c", c)):
            if t.data_ptr() % 16:
                raise ValueError(f"TMA needs {name}'s base 16-byte "
                                 f"aligned, got {t.data_ptr() % 16} bytes "
                                 f"off")


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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, initial_state)):
        return _SsdScan.apply(x, dt, a, b, c, initial_state, chunk,
                              out_dtype)
    return _launch(x, dt, a, b, c, initial_state, chunk, out_dtype)


def _launch(x, dt, a, b, c, initial_state, chunk, out_dtype):
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    plan = ssd_plan(x.dtype, bsz, s, h, p, n, chunk)
    dt = dt.float()
    a = a.float().contiguous()
    init = (initial_state.float().contiguous()
            if initial_state is not None else None)
    dev = x.device
    y = torch.empty((bsz, s, h, p), dtype=out_dtype, device=dev)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = _build.arrival_counters(dev, stream, plan.counters)
    if plan.route == "wgmma":
        err = _wg_fn()(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), None if init is None else init.data_ptr(),
            y.data_ptr(), state.data_ptr(), counters.data_ptr(), bsz, s, h,
            g, p, n, plan.chunk, plan.chunks,
            *(t.stride(i) for t in (dt, y) for i in range(3)),
            _DTYPE_CODES[out_dtype],
            (ctypes.c_int * 4)(plan.q_tiles, plan.items, plan.threads,
                               plan.smem), _wg_maps(x, b, c), stream)
    else:
        cs_ws = torch.empty(plan.cs_floats, dtype=torch.float32, device=dev)
        st_ws = torch.empty(plan.state_floats, dtype=torch.float32,
                            device=dev)
        strides = [t.stride(i) for t in (x, dt, b, c, y) for i in range(3)]
        err = _kernel_fn()(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), None if init is None else init.data_ptr(),
            y.data_ptr(), state.data_ptr(), cs_ws.data_ptr(),
            st_ws.data_ptr(), counters.data_ptr(), bsz, s, h, g, p, n,
            plan.chunk, plan.chunks, plan.q_tiles, *strides,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed ({plan.route}): CUDA "
                           f"error {err}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0


class _SsdScan(torch.autograd.Function):
    """The kernels' launch, differentiable: the forward launches them,
    the backward is :func:`ssd_scan_backward`."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, initial_state, chunk, out_dtype):
        ctx.save_for_backward(x, dt, a, b, c, initial_state)
        ctx.chunk, ctx.out_dtype = chunk, out_dtype
        return _launch(x, dt, a, b, c, initial_state, chunk, out_dtype)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, init = ctx.saved_tensors
        grads = ssd_scan_backward(x, dt, a, b, c, dy, dstate,
                                  chunk=ctx.chunk, initial_state=init,
                                  out_dtype=ctx.out_dtype)
        return (*grads, None, None)


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                      dstate: Optional[torch.Tensor] = None, *, chunk: int,
                      initial_state: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None):
    """The gradient of :func:`ssd_scan`: ``(dx, ddt, da, db, dc,
    dinitial_state)`` in the inputs' dtypes and shapes (``None`` for an
    absent initial state), given ``dy`` and, optionally, the final
    state's ``dstate``.

    The plain version (:func:`ssd_scan_ref` on x in f32, y rounded to
    ``out_dtype``, as the CPU path computes it) is recomputed under
    autograd and differentiated with ``torch.autograd.grad``: f32 inside,
    as the plain version computes, and memory that of its forward (the
    (B, S/chunk, H, chunk, chunk) decays).  Inputs may be views:
    each gradient has its input's shape, and autograd carries it on to
    the view's base."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, dt, a, b, c, initial_state) if t is not None]
        xl, dtl, al, bl, cl = leaves[:5]
        init = leaves[5] if initial_state is not None else None
        y, state = ssd_scan_ref(
            xl.float(), dtl, al, bl, cl, chunk=chunk, initial_state=init)
        outs, douts = [y.to(out_dtype)], [dy]
        if dstate is not None:
            outs.append(state)
            douts.append(dstate)
        grads = torch.autograd.grad(outs, leaves, douts, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    if initial_state is None:
        grads.append(None)
    return tuple(grads)
