"""Fused gated FFN: the CUDA kernels' wrapper.

Replaces the Pallas TPU kernel ``fused_ffn`` of the JAX package
(``kernels/fused_ffn.py``).  The kernels are in ``csrc/fused_ffn.cu``
(its header notes the designs, the bound on the H100 and the
workspace); their plain version is
:func:`repro_torch.kernels.ref.fused_ffn_ref`.

:func:`ffn_plan` picks the route from the dtype and the shapes alone.
bf16 runs on the tensor cores:

- a decode step's few rows take ``"small_m"`` (every M <= 64 at D <=
  576, M <= 32 up to D 1040, M <= 16 up to D 1440: :func:`small_m_fits`):
  one launch of thread-block clusters of up to 16 blocks
  (:func:`small_plan`).  A cluster's blocks split F into 64-column units,
  each streaming its Wg/Wu/Wd tiles by TMA through an mbarrier ring (a
  producer warp) into ``wgmma`` products (a consumer warpgroup, the
  weight tile as the 64-row operand, x and then H as bf16 hi + lo on the
  N side); each cluster owns a group of output columns, and its blocks'
  f32 shares are summed through distributed shared memory in rank order.
  At large D x F a few clusters split F as well, their sums added in
  order by the last to arrive through an f32 workspace;
- otherwise M <= 24 (at D > 512) takes ``"stream"``: two persistent
  launches on ``wgmma`` (at most one block an SM), each block a producer
  warp streaming the weights by TMA through a ring and a consumer
  warpgroup; pass 1 forms H = act(x Wg) (x Wu) in units of 64 F columns
  over all of D into an (2 MP, F) bf16 hi + lo workspace, pass 2 splits
  the (output tile, F chunk) steps of H Wd evenly over the blocks
  (stream-K), tiles split between blocks summed in block order from
  two f32 partials a block (:func:`stream_plan`, :func:`ffn_tma_map`);
- larger M takes ``"two_pass"``: two persistent launches of one kernel
  on ``wgmma`` (at most one block an SM, each a producer warpgroup
  issuing TMA loads into an mbarrier ring and two consumer warpgroups on
  128 x 256 tiles, written back by TMA stores); pass 1 forms H = act(x
  Wg) (x Wu) once per row into an (M, F) bf16 workspace, pass 2 H Wd.
  A last wave that would leave half the SMs idle is cut into K parts
  whose f32 shares the last block of a tile sums in part order
  (:func:`two_pass_plan`).  Its bound is the 6 M
  D F operations; its share of it on the H100 at the served prefill and
  train shapes, beside the unfused cuBLAS chain, is in PERF.md.

f32 runs on the CUDA cores (``"cuda_cores"``), since the tensor cores
would round f32 to TF32.  The plan is the one place that sizes a bf16
launch: the kernels launch its grids (and its shared memory) as given,
on the workspaces the wrapper allocates.  A
tensor on the CPU takes the plain version.  A tensor on the card
launches its route's kernel or raises — there is no fallback.  Each call
adds one to ``fused_ffn.launches`` (the two kernels of ``two_pass`` and
of ``stream`` count as one call).

Gradients: when autograd records (grad mode on and any input requiring
grad), the call goes through the custom operator
``torch.ops.repro_torch.fused_ffn``, which saves its inputs and whose
backward is :func:`fused_ffn_backward`, the analytic gradient in PyTorch
ops (the JAX package has no backward kernel either).  The operator runs
the kernel on the card and the plain version on the CPU.  Being one
operator to the dispatcher, it is what a selective checkpoint policy
sees, so the ``dots`` recomputation policy can keep its output
(``models/transformer.py``) as the JAX policy keeps the FFN's products.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
# TMA boxes of 64 bf16 columns, one 128-byte swizzle row, as K2's
from .flash_attn import TMA_BOX_COLS, TMA_SWIZZLE_BYTES
from .ref import fused_ffn_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"silu": 0, "gelu": 1}
# the f32 kernel's tiles (csrc/fused_ffn.cu: kBM, kBD, kBF)
BLOCK_M, BLOCK_D, BLOCK_F = 64, 256, 64
# blocks wanted in flight: two per SM of an H100 (132 SMs)
TARGET_BLOCKS = 264
# the most dynamic shared memory a block may have on the H100
MAX_SMEM = 232448
# the bf16 small-M kernel (namespace sm): F columns of a unit, D rows of
# a gate chunk, output columns of a tile, bytes of a ring slot, ring slots
# and blocks a cluster at most; the row counts it is built for (M padded
# up to one of them); the most rows the route takes, and its largest D at
# M padded to 16 (PR 16's kernel's reach: x and D x 16 weight slices in
# 200 KiB)
SMALL_UNIT_F, SMALL_KC, SMALL_TILE_D, SMALL_SLOT = 64, 64, 64, 16384
SMALL_MAX_STAGES, SMALL_MAX_CLUSTER = 8, 16
SMALL_ROWS = (8, 16, 24, 32, 48, 64)
SMALL_MAX_M = 64
SMALL_MAX_D = {16: 1440, 32: 1040, 48: 768, 64: 576}
# the clusters of a small_m launch at most (6 x 16 blocks ran at once on
# the H100; 8 did not, PERF.md), and what an F range beyond the first
# costs its blocks in weight bytes' worth of time
SMALL_MAX_CLUSTERS = 6
SMALL_SPLIT_BYTES = 48 * 1024
# the bf16 two-pass kernels (namespace tp): rows, columns and K of a
# tile, ring slots, the row tiles of a raster group, dynamic shared memory
# a block (1024 to align the swizzle atoms, the ring, four 64 x 64 bf16
# staging boxes, barriers and flags).  The tiles of a last wave that
# would leave at least half the SMs idle are cut into K parts, at most
# PASS_MAX_PARTS, each at least PASS_PART_MIN_CHUNKS K chunks.
PASS_BM, PASS_BN, PASS_KC, PASS_STAGES, PASS_GROUP_M = 128, 256, 64, 4, 8
PASS_SMEM = (1024 + PASS_STAGES * (PASS_BM * 128 + PASS_KC * PASS_BN * 2)
             + 4 * 64 * 128 + 16 * PASS_STAGES + 16)
PASS_MAX_PARTS, PASS_PART_MIN_CHUNKS = 8, 8
# the bf16 stream kernels (namespace st): F columns of a pass-1 unit, D
# rows of its ring chunk, output columns of a pass-2 tile, F rows of its
# ring chunk, ring slots, the most rows the route takes, and the H100's
# SMs (at most one block each)
STREAM_UNIT_F, STREAM_KC, STREAM_TILE_D, STREAM_FC = 64, 64, 64, 128
STREAM_STAGES, STREAM_MAX_M, H100_SMS = 4, 24, 132


@dataclass(frozen=True)
class SmallPlan:
    """The one launch of the ``small_m`` route: ``groups`` clusters of
    ``cluster`` blocks for each of ``fsplits`` F ranges.  ``rows``: M
    padded to one of ``SMALL_ROWS``, wgmma's N for G and U (twice it for H
    Wd: H's hi and lo rows).  Cluster k takes column group ``k % groups``
    (output tiles ``[g tiles_g, (g + 1) tiles_g)`` of ``SMALL_TILE_D``
    columns) and F range ``k // groups`` (units ``[s units / fsplits, (s
    + 1) units / fsplits)`` of ``SMALL_UNIT_F`` columns), of which its
    block r runs the r-th of ``cluster`` even runs, over D in ``nk``
    chunks of ``SMALL_KC`` rows.  ``stages``: ring slots."""
    rows: int
    cluster: int
    groups: int
    tiles_g: int
    units: int
    nk: int
    stages: int
    fsplits: int


@dataclass(frozen=True)
class StreamPlan:
    """The two launches of the ``stream`` route.  ``rows``: M padded to
    8, wgmma's N in pass 1 (twice it in pass 2: H's hi and lo rows).
    Pass 1 has ``units`` of ``STREAM_UNIT_F`` F columns over all of D in
    ``nk`` chunks of ``STREAM_KC`` rows: the first ``rounds * blocks[0]``
    run whole, unit u on block u mod ``blocks[0]``, and the ``tail``
    (unit, chunk) steps of the rest are cut into one even run a block
    (block b runs ``[b tail / blocks[0], (b + 1) tail / blocks[0])``).
    Pass 2 has ``steps`` (``STREAM_TILE_D``-column output tile,
    ``STREAM_FC``-row F chunk) steps, tile-major, ``chunks`` a tile, cut
    the same way over ``blocks[1]``.  ``smem``: each pass's dynamic
    shared memory a block."""
    rows: int
    units: int
    nk: int
    rounds: int
    tail: int
    steps: int
    chunks: int
    blocks: Tuple[int, int]
    smem: Tuple[int, int]
    stages: int


@dataclass(frozen=True)
class TwoPassPlan:
    """The two launches of the ``two_pass`` route (pass 1: x [Wg | Wu]
    into H; pass 2: H Wd), each a persistent grid over tiles of
    ``PASS_BM`` rows by ``PASS_BN`` product columns (pass 1: 128 F
    columns of G and U; pass 2: 256 output columns), each tile K chunks
    of ``PASS_KC``: a pass's ``blocks`` (at most one an SM) and the K
    ``parts`` its last wave's tiles are cut into (1: whole).  The kernel
    derives the rest of its schedule (``tp_tile``, ``TpSegments``) from
    these and the shapes."""
    parts: Tuple[int, int]
    blocks: Tuple[int, int]


@dataclass(frozen=True)
class FfnPlan:
    """How one call runs: its route, its grid, and the f32 workspace and
    arrival counters it needs (``ws_floats`` f32 elements; ``counters``
    int32 entries, zero between launches)."""
    route: str   # "cuda_cores" | "small_m" | "stream" | "two_pass"
    grid: Tuple[int, int, int]   # two_pass, stream: (pass-1 blocks,
    #                              pass-2 blocks, 1); small_m: (blocks, 1,
    #                              1) in clusters of small.cluster
    nsplit: int = 1          # cuda_cores: F splits summed through ws
    per: int = 0             # cuda_cores: F tiles a split
    ws_floats: int = 0
    counters: int = 0
    smem: int = 0            # dynamic shared memory a block, bytes
    h_elems: int = 0         # two_pass, stream: the bf16 H workspace
    stream: Optional[StreamPlan] = None
    two_pass: Optional[TwoPassPlan] = None
    small: Optional[SmallPlan] = None


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


def small_m_fits(m: int, d: int) -> bool:
    """Whether ``(M, D)`` is in the ``small_m`` route's domain: M <= 64
    and D at most ``SMALL_MAX_D`` of M padded to 16."""
    return 0 < m <= SMALL_MAX_M and d <= SMALL_MAX_D[-(-m // 16) * 16]


def small_owned_quads(tiles_g: int, cluster: int) -> int:
    """The most quads (4 output columns) of a column group that one block
    of a cluster owns, sums and writes (``sm::owned_quads``)."""
    return -(-(tiles_g * SMALL_TILE_D // 4) // cluster)


def small_smem(rows: int, nk: int, tiles_g: int, stages: int,
               cluster: int) -> int:
    """Dynamic shared memory of a ``small_m`` block, in the kernel's
    layout (``sm::smem_bytes``): 1024 bytes to align the swizzle atoms,
    the ring's slots, H's 2 MP rows of 128 bytes (hi, then lo), x's
    ``nk`` blocks of MP rows x 128 bytes, the block's f32 share of the
    group's output (MP rows of ``tiles_g * 64 + 4`` floats), the shares it
    receives of the quads it owns (``cluster`` x MP rows of owned quads x
    16 bytes), 16 bytes of barriers a slot and 16 for x's and a flag."""
    return (1024 + stages * SMALL_SLOT + 2 * rows * 128 + nk * rows * 128
            + rows * (tiles_g * SMALL_TILE_D + 4) * 4
            + cluster * rows * small_owned_quads(tiles_g, cluster) * 16
            + 16 * stages + 16)


def _small_fit(rows: int, units: int, nk: int, tiles: int, cs: int,
               groups: int):
    """``(tiles_g, stages)`` of the fewest column groups, at least
    ``groups``, whose block fits its shared memory with at least 2 ring
    slots (as many as a block's loads need, up to ``SMALL_MAX_STAGES``)."""
    while True:
        tiles_g = -(-tiles // groups)
        loads = -(-units // cs) * (nk + -(-tiles_g // 2))
        stages = min(SMALL_MAX_STAGES, loads)
        while stages > 2 and small_smem(rows, nk, tiles_g, stages,
                                        cs) > MAX_SMEM:
            stages -= 1
        if small_smem(rows, nk, tiles_g, stages, cs) <= MAX_SMEM:
            return tiles_g, stages
        groups += 1


def small_plan(m: int, d: int, f: int, groups: Optional[int] = None,
               fsplits: Optional[int] = None) -> FfnPlan:
    """The ``small_m`` route's plan: clusters of ``min(16, units)``
    blocks, ``groups`` column groups (the fewest that fit a block's
    shared memory, at least the number asked for) and ``fsplits`` F
    ranges.  What is not given is chosen: the geometry whose blocks
    stream the fewest weight bytes, an F range beyond the first counted
    ``SMALL_SPLIT_BYTES`` more (its sums' round trip through the f32
    workspace), among those of at most ``SMALL_MAX_CLUSTERS`` clusters.
    Several F ranges take an f32 workspace of their sums and one arrival
    counter a (group, rank).  As many ring slots (up to
    ``SMALL_MAX_STAGES``) as a block's loads and the shared memory allow,
    at least 2."""
    if not small_m_fits(m, d):
        raise ValueError(f"the small_m route does not take M {m} at D {d}")
    rows = next(r for r in SMALL_ROWS if r >= m)
    units, nk = -(-f // SMALL_UNIT_F), -(-d // SMALL_KC)
    tiles = -(-d // SMALL_TILE_D)
    cs = min(SMALL_MAX_CLUSTER, units)
    if fsplits is not None and not 1 <= fsplits <= units // cs:
        raise ValueError(f"{fsplits} F ranges of {units} units do not give "
                         f"each of {cs} blocks a unit")

    def geometry(g, c):
        """(cost, groups, F ranges, tiles a group, ring slots)"""
        tiles_g, stages = _small_fit(rows, units, nk, tiles, cs, g)
        block = (-(-units // (c * cs)) * (nk * SMALL_SLOT
                                            + tiles_g * SMALL_SLOT // 2))
        return (block + (SMALL_SPLIT_BYTES if c > 1 else 0),
                -(-tiles // tiles_g), c, tiles_g, stages)

    cands = [geometry(g, c)
             for g in ([min(groups, tiles)] if groups else range(1, tiles + 1))
             for c in ([fsplits] if fsplits else range(1, units // cs + 1))]
    _, groups, fsplits, tiles_g, stages = min(
        [x for x in cands if x[1] * x[2] <= SMALL_MAX_CLUSTERS] or cands)
    return FfnPlan("small_m", (cs * groups * fsplits, 1, 1),
                   ws_floats=fsplits * m * d if fsplits > 1 else 0,
                   counters=groups * cs if fsplits > 1 else 0,
                   smem=small_smem(rows, nk, tiles_g, stages, cs),
                   small=SmallPlan(rows, cs, groups, tiles_g, units, nk,
                                   stages, fsplits))


def pass_parts(tiles: int, nk: int) -> int:
    """The K parts of a two-pass launch's last wave: the ``tiles %
    132`` tiles that a wave of whole tiles would leave to fewer than half
    the SMs are cut into as many parts as fill them (at most
    ``PASS_MAX_PARTS``, each at least ``PASS_PART_MIN_CHUNKS`` chunks):
    qwen1.5-32b's pass 2 at M 1024 (160 tiles: 132, then 28 in 4 parts),
    the decode steps of 25..64 rows (yi-34b's pass 2: 28 tiles in 4)."""
    rem = tiles % H100_SMS
    if rem == 0:
        return 1
    return max(1, min(H100_SMS // rem, PASS_MAX_PARTS,
                      nk // PASS_PART_MIN_CHUNKS))


def two_pass_plan(m: int, d: int, f: int) -> FfnPlan:
    """The ``two_pass`` route's plan (``ffn_plan``'s for M > 24 at D >
    512 and M > 64 below): persistent grids of at most one block an
    SM and the (M, F) bf16 H workspace; where a pass cuts its last wave
    into K parts, a 64 x 256 f32 share a block and consumer warpgroup
    and two arrival counters a tile of that wave (one a warpgroup)."""
    rt = -(-m // PASS_BM)
    nk = (-(-d // PASS_KC), -(-f // PASS_KC))
    tiles = (rt * -(-f // (PASS_BN // 2)), rt * -(-d // PASS_BN))
    parts = tuple(pass_parts(t, k) for t, k in zip(tiles, nk))
    blocks = tuple(H100_SMS if t >= H100_SMS else t * p
                   for t, p in zip(tiles, parts))
    cut = [(b, t % b) for b, t, p in zip(blocks, tiles, parts) if p > 1]
    return FfnPlan("two_pass", (*blocks, 1),
                   ws_floats=max((b * 2 * 64 * PASS_BN for b, _ in cut),
                                 default=0),
                   counters=max((2 * r for _, r in cut), default=0),
                   smem=PASS_SMEM, h_elems=m * f,
                   two_pass=TwoPassPlan(parts, blocks))


def stream_plan(m: int, d: int, f: int) -> FfnPlan:
    """The ``stream`` route's plan for M <= 24 rows at D > 512: grids of
    at most one block an SM, the (2 MP, F) bf16 H workspace, two slots of
    f32 partials a block for the items split between blocks (pass 1: G
    and U, two 64 x MP tiles a slot; pass 2: one) and one arrival counter
    a split item (a tail unit in pass 1, a 64-column output tile in pass
    2).  Shared memory, in the kernels' layout: 1024 bytes to align the
    swizzle atoms, then the ring's slots (pass 1: Wg's and Wu's 64 x 64
    tiles and x's 64 columns of MP rows; pass 2: Wd's 128 x 64 tile and
    H's 128 columns of 2 MP rows) with 16 bytes of barriers each."""
    if not 0 < m <= STREAM_MAX_M:
        raise ValueError(f"the stream route takes 1..{STREAM_MAX_M} rows, "
                         f"not {m}")
    mp = -(-m // 8) * 8
    units, nk = -(-f // STREAM_UNIT_F), -(-d // STREAM_KC)
    chunks, tiles = -(-f // STREAM_FC), -(-d // STREAM_TILE_D)
    steps = tiles * chunks
    blocks = (min(H100_SMS, units * nk), min(H100_SMS, steps))
    rounds = units // blocks[0]
    tail = (units - rounds * blocks[0]) * nk
    stage1 = 2 * STREAM_KC * STREAM_UNIT_F * 2 + STREAM_KC // 64 * mp * 128
    stage2 = STREAM_FC * STREAM_TILE_D * 2 + STREAM_FC // 64 * 2 * mp * 128
    smem = (1024 + STREAM_STAGES * (stage1 + 16),
            1024 + STREAM_STAGES * (stage2 + 16))
    return FfnPlan("stream", (*blocks, 1),
                   ws_floats=max(2 * blocks[0], blocks[1]) * 2 * 64 * mp,
                   counters=max(tiles, units - rounds * blocks[0]),
                   smem=max(smem), h_elems=2 * mp * f,
                   stream=StreamPlan(mp, units, nk, rounds, tail, steps,
                                     chunks, blocks, smem, STREAM_STAGES))


def stream_shares(plan: FfnPlan, d: int, f: int):
    """The weight bytes each block of a ``stream`` plan reads, per pass:
    ``(pass 1 list, pass 2 list)``, ragged edges counted as read (the
    tensor maps fetch nothing past D or F)."""
    sp = plan.stream
    nb1, nb2 = sp.blocks
    tail0 = sp.rounds * nb1

    def unit_bytes(u, c0=0, c1=None):
        rows = min(d, (sp.nk if c1 is None else c1) * STREAM_KC) \
            - c0 * STREAM_KC
        return 2 * rows * min(STREAM_UNIT_F, f - u * STREAM_UNIT_F) * 2

    def step_bytes(q):
        tile, c = divmod(q, sp.chunks)
        return (min(STREAM_TILE_D, d - tile * STREAM_TILE_D)
                * min(STREAM_FC, f - c * STREAM_FC) * 2)

    one = [sum(unit_bytes(b + r * nb1) for r in range(sp.rounds))
           + sum(unit_bytes(tail0 + q // sp.nk, q % sp.nk, q % sp.nk + 1)
                 for q in range(b * sp.tail // nb1,
                                (b + 1) * sp.tail // nb1))
           for b in range(nb1)]
    two = [sum(step_bytes(q) for q in range(b * sp.steps // nb2,
                                            (b + 1) * sp.steps // nb2))
           for b in range(nb2)]
    return one, two


class TmaMap2d(NamedTuple):
    """A 2-d TMA tensor map of a row-major bf16 matrix: ``dims``
    (columns, rows), the row ``stride`` in bytes, the ``box`` (columns,
    rows) one load copies, the ``swizzle`` span in bytes (the box's row,
    128)."""
    dims: Tuple[int, int]
    stride: int
    box: Tuple[int, int]
    swizzle: int


def ffn_tma_map(t: torch.Tensor, box: Tuple[int, int]) -> TmaMap2d:
    """The tensor map through which the ``small_m``, ``stream`` and
    ``two_pass`` routes read (or write) a 2-d bf16 matrix in place, boxes
    of ``box`` (columns, rows) swizzled over the box's row (128 bytes).
    Raises ``ValueError`` where TMA cannot read it: a base not 16-byte
    aligned, a row stride not a positive multiple of 16 bytes or not
    below 2**40, rows that are not dense, a box TMA
    does not take."""
    if t.dim() != 2 or t.dtype != torch.bfloat16:
        raise ValueError(f"ffn_tma_map takes a 2-d bf16 matrix, got "
                         f"{tuple(t.shape)} {t.dtype}")
    cols, rows = box
    if cols != TMA_BOX_COLS or not 0 < rows <= 256:
        raise ValueError(f"TMA boxes here are {TMA_BOX_COLS} columns by "
                         f"1..256 rows, not {box}")
    if t.stride(1) != 1:
        raise ValueError("TMA needs the rows dense")
    if t.data_ptr() % 16:
        raise ValueError(f"TMA needs a 16-byte aligned base, got "
                         f"{t.data_ptr() % 16} bytes off")
    stride = 2 * t.stride(0) if t.shape[0] > 1 else max(2 * t.shape[1], 16)
    if stride <= 0 or stride % 16 or stride >= 1 << 40:
        raise ValueError(f"TMA needs the row stride a positive multiple of "
                         f"16 bytes below 2**40, got {stride} bytes")
    return TmaMap2d((t.shape[1], t.shape[0]), stride, box,
                    TMA_SWIZZLE_BYTES)


class _EntryNumbers(NamedTuple):
    """What the ``small_m``, ``stream`` and ``two_pass`` entries take
    besides the pointers: the plan's numbers (11, 10 and 9) and 6 numbers
    a tensor map (4, 5 and 6 maps)."""
    plan_arr: ctypes.Array
    maps_arr: ctypes.Array


def small_numbers(x, w_gate, w_up, w_down, plan: FfnPlan) -> list:
    """The 24 numbers the ``small_m`` entry encodes its tensor maps from:
    for x (boxes of 64 columns by MP rows), Wg and Wu (64 by 64) and Wd
    (64 by 64) in turn, the dims, the row stride, the box and the swizzle
    span."""
    return [v for t, box in ((x, (64, plan.small.rows)),
                             (w_gate, (SMALL_UNIT_F, SMALL_KC)),
                             (w_up, (SMALL_UNIT_F, SMALL_KC)),
                             (w_down, (SMALL_TILE_D, SMALL_UNIT_F)))
            for tm in (ffn_tma_map(t, box),)
            for v in (*tm.dims, tm.stride, *tm.box, tm.swizzle)]


def small_entry_plan(plan: FfnPlan) -> list:
    """The 11 plan numbers the ``small_m`` entry takes (and checks against
    its constants): rows, unit columns, gate chunk, tile columns, slot
    bytes, cluster size, column groups, tiles a group, ring slots, shared
    memory, F ranges."""
    sp = plan.small
    return [sp.rows, SMALL_UNIT_F, SMALL_KC, SMALL_TILE_D, SMALL_SLOT,
            sp.cluster, sp.groups, sp.tiles_g, sp.stages, plan.smem,
            sp.fsplits]


def stream_numbers(x, w_gate, w_up, w_down, h, plan: FfnPlan) -> list:
    """The 30 numbers the ``stream`` entry encodes its tensor maps from:
    for x (boxes of 64 columns by MP rows), Wg and Wu (64 by 64), Wd (64
    by 128) and the (2 MP, F) H workspace (64 by 2 MP) in turn, the dims,
    the row stride, the box and the swizzle span."""
    mp = plan.stream.rows
    return [v for t, box in ((x, (64, mp)), (w_gate, (STREAM_UNIT_F,
                                                       STREAM_KC)),
                             (w_up, (STREAM_UNIT_F, STREAM_KC)),
                             (w_down, (STREAM_TILE_D, STREAM_FC)),
                             (h, (64, 2 * mp)))
            for tm in (ffn_tma_map(t, box),)
            for v in (*tm.dims, tm.stride, *tm.box, tm.swizzle)]


def two_pass_numbers(x, w_gate, w_up, w_down, h, out) -> list:
    """The 36 numbers the ``two_pass`` entry encodes its tensor maps
    from: for x, Wg, Wu, Wd, the (M, F) H workspace and the output in
    turn (boxes of 64 columns by 64 rows, all), the dims, the row stride,
    the box and the swizzle span."""
    return [v for t in (x, w_gate, w_up, w_down, h, out)
            for tm in (ffn_tma_map(t, (64, 64)),)
            for v in (*tm.dims, tm.stride, *tm.box, tm.swizzle)]


# _EntryNumbers by (M, D, F): the operands are contiguous (``_check``),
# so the route, plan and map numbers depend on the shapes alone and are
# worked out once a shape; the bases' alignment is checked on every call
_ENTRY_SHAPES: dict = {}
_ENTRY_SHAPES_MAX = 256


def _entry_numbers(x, w_gate, w_up, w_down, h, out, plan) -> _EntryNumbers:
    key = (x.shape[0], x.shape[1], w_up.shape[1])
    nums = _ENTRY_SHAPES.get(key)
    if nums is None:
        if plan.route == "small_m":
            nums = _EntryNumbers(
                (ctypes.c_int * 11)(*small_entry_plan(plan)),
                (ctypes.c_longlong * 24)(*small_numbers(
                    x, w_gate, w_up, w_down, plan)))
        elif plan.route == "stream":
            sp = plan.stream
            nums = _EntryNumbers(
                (ctypes.c_int * 10)(
                    sp.rows, STREAM_UNIT_F, STREAM_KC, STREAM_TILE_D,
                    STREAM_FC, sp.stages, *sp.blocks, *sp.smem),
                (ctypes.c_longlong * 30)(*stream_numbers(
                    x, w_gate, w_up, w_down, h, plan)))
        else:
            tp = plan.two_pass
            nums = _EntryNumbers(
                (ctypes.c_int * 9)(PASS_BM, PASS_BN, PASS_KC, PASS_STAGES,
                                   PASS_SMEM, *tp.blocks, *tp.parts),
                (ctypes.c_longlong * 36)(*two_pass_numbers(
                    x, w_gate, w_up, w_down, h, out)))
        if len(_ENTRY_SHAPES) >= _ENTRY_SHAPES_MAX:
            _ENTRY_SHAPES.clear()
        _ENTRY_SHAPES[key] = nums
    return nums


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
    if small_m_fits(m, d):
        return small_plan(m, d, f)
    if m <= STREAM_MAX_M:
        return stream_plan(m, d, f)
    return two_pass_plan(m, d, f)


def _fn(name: str, argtypes):
    fn = getattr(_build.load("fused_ffn"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"fused_ffn": [_P] * 6 + [_I] * 7 + [_P],
             "fused_ffn_bf16_small": [_P] * 7 + [_I] * 4 + [_P] * 3,
             "fused_ffn_bf16_stream": [_P] * 8 + [_I] * 4 + [_P] * 3,
             "fused_ffn_bf16_two_pass": [_P] * 8 + [_I] * 4 + [_P] * 3}


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_gate, w_up, w_down)):
        return fused_ffn_op(x, w_gate, w_up, w_down, activation)
    return _forward(x, w_gate, w_up, w_down, activation)


def _forward(x, w_gate, w_up, w_down, activation) -> torch.Tensor:
    """The plain version for a tensor on the CPU, the kernel's launch for
    one on the card."""
    if x.device.type == "cpu":
        return fused_ffn_ref(x, w_gate, w_up, w_down, activation)
    if x.device.type != "cuda":
        raise ValueError(f"no fused FFN kernel for device {x.device}")
    _check(x, w_gate, w_up, w_down, activation)
    return _launch(x, w_gate, w_up, w_down, activation)


def _launch(x, w_gate, w_up, w_down, activation) -> torch.Tensor:
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
    elif plan.route == "stream":
        h = torch.empty(2 * plan.stream.rows, f, dtype=torch.bfloat16,
                        device=x.device)
        nums = _entry_numbers(x, w_gate, w_up, w_down, h, out, plan)
        counters = _build.arrival_counters(x.device, stream,
                                            plan.counters)
        err = _fn("fused_ffn_bf16_stream",
                  _ARGTYPES["fused_ffn_bf16_stream"])(
            *ptrs, h.data_ptr(), ws.data_ptr(), counters.data_ptr(), m, d, f,
            act, nums.plan_arr, nums.maps_arr, stream)
    elif plan.route == "two_pass":
        h = torch.empty(m, f, dtype=torch.bfloat16, device=x.device)
        nums = _entry_numbers(x, w_gate, w_up, w_down, h, out, plan)
        counters = _build.arrival_counters(x.device, stream,
                                            plan.counters)
        err = _fn("fused_ffn_bf16_two_pass",
                  _ARGTYPES["fused_ffn_bf16_two_pass"])(
            *ptrs, h.data_ptr(), None if ws is None else ws.data_ptr(),
            counters.data_ptr(), m, d, f, act, nums.plan_arr, nums.maps_arr,
            stream)
    else:
        nums = _entry_numbers(x, w_gate, w_up, w_down, None, out, plan)
        counters = (_build.arrival_counters(x.device, stream, plan.counters)
                    .data_ptr() if plan.counters else None)
        err = _fn("fused_ffn_bf16_small", _ARGTYPES["fused_ffn_bf16_small"])(
            *ptrs, None if ws is None else ws.data_ptr(), counters, m, d, f,
            act, nums.plan_arr, nums.maps_arr, stream)
    if err != 0:
        raise RuntimeError(f"fused_ffn ({plan.route}) launch failed: CUDA "
                           f"error {err}")
    fused_ffn.launches += 1
    fused_ffn.last_route = plan.route
    return out


fused_ffn.launches = 0
fused_ffn.last_route = None     # the route of the last launch on the card


@torch.library.custom_op("repro_torch::fused_ffn", mutates_args=())
def fused_ffn_op(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, activation: str) -> torch.Tensor:
    """:func:`fused_ffn` as one differentiable operator: the kernel's
    launch on the card, the plain version on the CPU; its backward is
    :func:`fused_ffn_backward`."""
    return _forward(x, w_gate, w_up, w_down, activation)


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:4])
    ctx.activation = inputs[4]


def _op_backward(ctx, dy):
    return (*fused_ffn_backward(*ctx.saved_tensors, dy, ctx.activation),
            None)


fused_ffn_op.register_autograd(_op_backward, setup_context=_save_inputs)


def _act_and_slope(name: str, g: torch.Tensor):
    """``(act(g), act'(g))`` for silu and tanh-gelu."""
    if name == "silu":
        sig = torch.sigmoid(g)
        return g * sig, sig * (1.0 + g * (1.0 - sig))
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (g + 0.044715 * g ** 3))
    return (0.5 * g * (1.0 + t),
            0.5 * (1.0 + t)
            + 0.5 * g * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * g * g))


def fused_ffn_backward(x: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, w_down: torch.Tensor,
                       dy: torch.Tensor, activation: str = "silu"):
    """The gradient of :func:`fused_ffn`: ``(dx, dw_gate, dw_up,
    dw_down)`` in the inputs' dtypes, f32 inside (f64 for f64 inputs).

    G = x Wg and U = x Wu are recomputed, H = act(G) U; then
    ``dWd = H^T dy``, ``dH = dy Wd^T``, ``dU = dH act(G)``,
    ``dG = dH U act'(G)``, ``dx = dG Wg^T + dU Wu^T``, ``dWg = x^T dG``
    and ``dWu = x^T dU``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, wg, wu, wd = (t.to(acc) for t in (x, w_gate, w_up, w_down))
    dyf = dy.to(acc)
    a, slope = _act_and_slope(activation, xf @ wg)
    u = xf @ wu
    dh = dyf @ wd.T
    du = dh * a
    dg = dh * u * slope
    dx = dg @ wg.T + du @ wu.T
    return (dx.to(x.dtype), (xf.T @ dg).to(w_gate.dtype),
            (xf.T @ du).to(w_up.dtype), ((a * u).T @ dyf).to(w_down.dtype))
