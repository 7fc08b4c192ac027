"""Fused gated FFN: the CUDA kernels' wrapper.

Replaces the Pallas TPU kernel ``fused_ffn`` of the JAX package
(``kernels/fused_ffn.py``).  The kernels are in ``csrc/fused_ffn.cu``
(its header notes the designs, the bound on the H100 and the
workspace); their plain version is
:func:`repro_torch.kernels.ref.fused_ffn_ref`.

:func:`ffn_plan` picks the route from the dtype and the shapes alone:
bf16 runs on the tensor cores in 64-row tiles on ``wgmma``
(``"tiles"``), or, for a decode step's few rows, in the one-launch
F-split kernel on ``mma.sync`` (``"small_m"``); f32 runs on the CUDA
cores (``"cuda_cores"``), since the tensor cores would round f32 to
TF32.  The plan is the one place that sizes a bf16 launch: the kernels
launch its grid and shared memory as given.  A tensor on the CPU takes the plain version.  A tensor on the card
launches its route's kernel or raises — there is no fallback.  Each
launch adds one to ``fused_ffn.launches``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from . import _build
from .ref import fused_ffn_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"silu": 0, "gelu": 1}
# the f32 kernel's tiles (csrc/fused_ffn.cu: kBM, kBD, kBF)
BLOCK_M, BLOCK_D, BLOCK_F = 64, 256, 64
# blocks wanted in flight: two per SM of an H100 (132 SMs)
TARGET_BLOCKS = 264
# the bf16 tile kernel (csrc/fused_ffn.cu, namespace wg): rows and
# output columns a block; the largest D whose x tile stays in shared
# memory
TC_BLOCK_M, TC_BLOCK_D, TC_X_RESIDENT = 64, 256, 512
# the bf16 small-M kernel (namespace sm): F columns and output columns a
# block, its warps, the most rows it holds, and the shared memory it may
# ask for
SMALL_F, SMALL_D, SMALL_WARPS = 16, 64, 8
SMALL_MAX_M, SMALL_SMEM = 64, 200 * 1024


@dataclass(frozen=True)
class FfnPlan:
    """How one call runs: its route, its grid, and the f32 workspace and
    arrival counters it needs (``ws_floats`` f32 elements; ``counters``
    int32 entries, zero between launches)."""
    route: str               # "cuda_cores" | "tiles" | "small_m"
    grid: Tuple[int, int, int]
    nsplit: int = 1          # F splits summed through the workspace
    per: int = 0             # cuda_cores: F tiles a split
    ws_floats: int = 0
    counters: int = 0
    x_resident: bool = False   # tiles: x staged once, not per D chunk
    smem: int = 0              # small_m: dynamic shared memory, bytes


def split_plan(m: int, d: int, f: int):
    """``(nsplit, f_tiles_per_split)`` of the f32 kernel: how many blocks
    share one output tile's F loop.  Only small M splits F, so the grid
    reaches about ``TARGET_BLOCKS`` blocks; the plan depends on the
    shapes alone, so a result repeats from run to run."""
    tiles = -(-m // BLOCK_M) * -(-d // BLOCK_D)
    f_tiles = max(1, -(-f // BLOCK_F))
    nsplit = min(f_tiles, max(1, TARGET_BLOCKS // tiles))
    per = -(-f_tiles // nsplit)
    return -(-f_tiles // per), per


def small_smem_bytes(m: int, d: int) -> int:
    """Shared memory of the small-M kernel, in the order the kernel lays
    it out: x (M padded to 16, rows of D padded to 16 plus 8), the
    Wg/Wu slices (rows of 16 F columns plus 8) and the Wd rows in bf16,
    then the warps' f32 partials of G and U, and H."""
    mp, dp = -(-m // 16) * 16, -(-d // 16) * 16
    return (2 * (mp * (dp + 8) + 2 * dp * (SMALL_F + 8) + SMALL_F * SMALL_D)
            + 4 * (SMALL_WARPS * mp * SMALL_F * 2 + mp * SMALL_F))


def ffn_plan(dtype: torch.dtype, m: int, d: int, f: int) -> FfnPlan:
    """The route and launch geometry for ``(M, D) x (D, F)`` in ``dtype``:
    a pure function of its arguments."""
    if dtype == torch.float32:
        nsplit, per = split_plan(m, d, f)
        return FfnPlan("cuda_cores", (-(-m // BLOCK_M), -(-d // BLOCK_D),
                                      nsplit), nsplit, per,
                       nsplit * m * d if nsplit > 1 else 0)
    if dtype != torch.bfloat16:
        raise ValueError(f"dtype {dtype} not supported (f32 or bf16)")
    smem = small_smem_bytes(m, d)
    if m <= SMALL_MAX_M and smem <= SMALL_SMEM:
        nsplit, chunks = -(-f // SMALL_F), -(-d // SMALL_D)
        return FfnPlan("small_m", (nsplit, chunks, 1), nsplit,
                       ws_floats=nsplit * m * d, counters=chunks, smem=smem)
    return FfnPlan("tiles", (-(-m // TC_BLOCK_M), -(-d // TC_BLOCK_D), 1),
                   x_resident=d <= TC_X_RESIDENT)


def _fn(name: str, argtypes):
    fn = getattr(_build.load("fused_ffn"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"fused_ffn": [_P] * 6 + [_I] * 7 + [_P],
             "fused_ffn_bf16_tiles": [_P] * 5 + [_I] * 7 + [_P],
             "fused_ffn_bf16_small": [_P] * 7 + [_I] * 7 + [_P]}
# arrival counters of the small-M kernel, by (device, stream): the last
# block of a launch resets its counters, so launches on one stream reuse
# them; another stream gets its own
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


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
    if x.dtype == torch.bfloat16:
        # the bf16 routes copy 16-byte row segments
        if d % 8 or f % 8:
            raise ValueError(f"bf16 needs D and F multiples of 8, got "
                             f"D={d}, F={f}")
        for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up),
                        ("w_down", w_down)):
            if t.data_ptr() % 16:
                raise ValueError(f"bf16 needs a 16-byte aligned {name}")


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
    plan = ffn_plan(x.dtype, m, d, f)
    out = torch.empty_like(x)
    ws = (torch.empty(plan.ws_floats, dtype=torch.float32, device=x.device)
          if plan.ws_floats else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), out.data_ptr())
    act = _ACT_CODES[activation]
    if plan.route == "cuda_cores":
        err = _fn("fused_ffn", _ARGTYPES["fused_ffn"])(
            *ptrs, None if ws is None else ws.data_ptr(), m, d, f,
            plan.nsplit, plan.per, act, _DTYPE_CODES[x.dtype], stream)
    elif plan.route == "tiles":
        err = _fn("fused_ffn_bf16_tiles", _ARGTYPES["fused_ffn_bf16_tiles"])(
            *ptrs, m, d, f, act, int(plan.x_resident), plan.grid[0],
            plan.grid[1], stream)
    else:
        counters = _counters(x.device, stream, plan.counters)
        err = _fn("fused_ffn_bf16_small", _ARGTYPES["fused_ffn_bf16_small"])(
            *ptrs, ws.data_ptr(), counters.data_ptr(), m, d, f, act,
            plan.nsplit, plan.grid[1], plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"fused_ffn ({plan.route}) launch failed: CUDA "
                           f"error {err}")
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0
