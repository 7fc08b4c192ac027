"""K3's ``small_m``, ``stream`` and ``two_pass`` routes planned on the CPU:
the plan at every config's FFN, the clusters of ``small_m`` (every F
unit and output column once, the fixed order of the cluster's sum, the F
ranges, shared memory in the kernel's layout, an emulation of its
rounding points against the plain version), the even split of the weight
bytes over the SMs (``stream``), the persistent tile schedule
(``two_pass``: every tile and K chunk once, the raster groups, the last
wave's K parts summed in part order), the workspaces, and the numbers of
the 2-d TMA tensor maps (``kernels/fused_ffn.py``). The kernels
themselves run only on the card (``test_torch_cuda.py``,
``chip_smoke.py`` phase 2); what they take from these plans is checked
here, shape by shape. No JAX: the plans are the port's own."""
import re
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.fused_ffn import (H100_SMS, MAX_SMEM, PASS_BM,
                                           PASS_BN, PASS_GROUP_M, PASS_KC,
                                           PASS_MAX_PARTS,
                                           PASS_PART_MIN_CHUNKS, PASS_SMEM,
                                           PASS_STAGES, SMALL_KC,
                                           SMALL_MAX_CLUSTER,
                                           SMALL_MAX_CLUSTERS, SMALL_MAX_D,
                                           SMALL_MAX_M, SMALL_MAX_STAGES,
                                           SMALL_ROWS,
                                           SMALL_SLOT, SMALL_TILE_D,
                                           SMALL_UNIT_F, STREAM_FC, STREAM_KC,
                                           STREAM_STAGES, STREAM_TILE_D,
                                           STREAM_UNIT_F, ffn_plan,
                                           ffn_tma_map, small_entry_plan,
                                           small_m_fits, small_numbers,
                                           small_owned_quads, small_plan,
                                           small_smem, stream_numbers,
                                           stream_shares, two_pass_numbers,
                                           two_pass_plan)
from repro_torch.kernels.ref import fused_ffn_ref

torch.set_num_threads(2)

ARCHS = sorted(set(list_archs()) | {"mixtral-8x7b", "phi3-mini"})
# (D, F) of every config's dense gated FFN above D 512
WIDE = sorted({(c.d_model, c.d_ff) for c in map(get_config, ARCHS)
               if c.d_model > 512 and c.d_ff > 0})
# the served decode shapes (PERF.md's K3 rows at M 8)
SERVED = ((7168, 20480), (5120, 27392), (6144, 16384), (3072, 24576),
          (3840, 15360), (3072, 8192), (2048, 8192))


def _wants_stream(m, d):
    return not small_m_fits(m, d)


@pytest.mark.parametrize("m", [1, 8, 24])
@pytest.mark.parametrize("d,f", WIDE)
def test_stream_plan_at_every_config(m, d, f):
    """Every config's FFN above D 512 at M 1, 8 and 24: the stream route
    wherever small_m does not take the shape (whisper-small's D 768 keeps
    small_m),
    units of 64 F columns over D in 64-row chunks, pass 2's (64-column
    tile, 128-row F chunk) steps, at most one block an SM in each pass,
    shared memory within the H100's 232,448 bytes."""
    plan = ffn_plan(torch.bfloat16, m, d, f)
    if not _wants_stream(m, d):
        assert plan.route == "small_m"
        return
    sp = plan.stream
    assert plan.route == "stream" and sp.rows == -(-m // 8) * 8
    assert (sp.units, sp.nk) == (-(-f // 64), -(-d // 64))
    assert sp.steps == -(-d // 64) * sp.chunks and sp.chunks == -(-f // 128)
    assert plan.grid == (min(H100_SMS, sp.units * sp.nk),
                         min(H100_SMS, sp.steps), 1)
    assert sp.rounds == sp.units // plan.grid[0]
    assert sp.tail == (sp.units - sp.rounds * plan.grid[0]) * sp.nk
    assert sp.stages == STREAM_STAGES >= 4
    assert 0 < plan.smem == max(sp.smem) <= MAX_SMEM == 232448


@pytest.mark.parametrize("d,f", [s for s in sorted(set(WIDE) | set(SERVED))
                                 if _wants_stream(8, s[0])])
def test_stream_splits_the_weight_bytes_evenly(d, f):
    """Each pass reads every weight byte once, and no SM reads more than
    10 % above the mean in either pass or in both together (the time is
    the most loaded SM's); at the served shapes no SM reads less than
    10 % below it either.  Pass 1 alone, whole units only, would give
    one SM ceil(units / 132) units against units / 132 (2 against 1.82 at
    gemma3-12b, 2 against 1.70 at mixtral-8x7b); the split tail evens it
    to a 64-row chunk."""
    plan = ffn_plan(torch.bfloat16, 8, d, f)
    one, two = stream_shares(plan, d, f)
    assert sum(one) == 2 * d * f * 2 and sum(two) == d * f * 2
    both = [a + b for a, b in zip(one, two)]
    for share in (one, two, both):
        mean = statistics.mean(share)
        assert max(share) <= 1.10 * mean
        if (d, f) in SERVED:
            assert min(share) >= 0.90 * mean


def test_stream_workspace_does_not_grow_with_the_split():
    """The f32 workspace is two slots of G's and U's 64 x MP partials a
    block whatever D and F (split_f's was one (M, D) partial an F slice:
    50 MB at internvl2-26b), H is (2 MP, F) bf16, and the counters are
    one a split item (a 64-column output tile or a tail unit)."""
    for m in (1, 8, 24):
        mp = -(-m // 8) * 8
        for d, f in SERVED:
            plan = ffn_plan(torch.bfloat16, m, d, f)
            assert plan.ws_floats == 2 * 2 * 132 * 64 * mp
            assert plan.h_elems == 2 * mp * f
            assert plan.counters <= max(-(-d // 64), 132)
    assert 4 * ffn_plan(torch.bfloat16, 8, 7168, 20480).ws_floats \
        == 1081344


def test_stream_tma_map_numbers():
    """The 30 numbers of the five maps (x, Wg, Wu, Wd, H): dims (columns,
    rows), the row stride in bytes, the box (columns, rows) and the
    swizzle span, for a (9, 2056) x (2056, 1000) FFN: MP 16."""
    m, d, f = 9, 2056, 1000
    plan = ffn_plan(torch.bfloat16, m, d, f)
    assert plan.route == "stream" and plan.stream.rows == 16
    x = torch.zeros(m, d, dtype=torch.bfloat16)
    wg = torch.zeros(d, f, dtype=torch.bfloat16)
    wd = torch.zeros(f, d, dtype=torch.bfloat16)
    h = torch.zeros(32, f, dtype=torch.bfloat16)
    assert stream_numbers(x, wg, wg, wd, h, plan) == [
        2056, 9, 4112, 64, 16, 128,           # x: boxes of 64 x MP
        1000, 2056, 2000, 64, 64, 128,        # Wg: 64 columns x 64 rows
        1000, 2056, 2000, 64, 64, 128,        # Wu
        2056, 1000, 4112, 64, 128, 128,       # Wd: 64 x 128
        1000, 32, 2000, 64, 32, 128]          # H: 64 x 2 MP


def test_stream_tma_map_refuses_what_tma_cannot_read():
    base = torch.zeros(64, 1024, dtype=torch.bfloat16)
    assert ffn_tma_map(base, (64, 128)).stride == 2048
    with pytest.raises(ValueError, match="16-byte aligned"):
        ffn_tma_map(base.view(-1)[1:1 + 63 * 1024].view(63, 1024), (64, 8))
    with pytest.raises(ValueError, match="multiple of 16"):
        ffn_tma_map(torch.zeros(8, 1004, dtype=torch.bfloat16), (64, 8))
    with pytest.raises(ValueError, match="rows dense"):
        ffn_tma_map(base.t(), (64, 8))
    with pytest.raises(ValueError, match="boxes"):
        ffn_tma_map(base, (32, 8))
    with pytest.raises(ValueError, match="boxes"):
        ffn_tma_map(base, (64, 512))
    with pytest.raises(ValueError, match="2-d bf16"):
        ffn_tma_map(base.float(), (64, 8))


def test_stream_constants_match_the_kernels():
    """The C entry refuses a plan whose numbers differ from the kernels'
    constants (namespace st of csrc/fused_ffn.cu): the plan mirrors them."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "kernels" / "csrc" / "fused_ffn.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src[
        src.index("namespace st {"):src.index("}  // namespace st")]))
    assert {k: int(v) for k, v in consts.items()} == {
        "kUnitF": STREAM_UNIT_F, "kKC": STREAM_KC, "kTileD": STREAM_TILE_D,
        "kFC": STREAM_FC, "kStages": STREAM_STAGES, "kThreads": 160}


# the two_pass route's shapes: (M, D, F) of the served prefill and train
# shapes, the 32-slot decode steps at yi-34b's and internvl2-26b's widths,
# paper-backbone's D 256 and chip_smoke.py phase 2's ragged edges
TWO_PASS = ((16384, 3840, 15360), (4096, 7168, 20480), (4096, 6144, 16384),
            (1024, 5120, 27392), (4096, 3072, 24576), (4096, 3072, 8192),
            (4096, 2048, 8192), (8192, 2048, 8192), (2048, 6144, 16384),
            (32, 7168, 20480), (64, 7168, 20480), (32, 6144, 16384),
            (64, 6144, 16384), (1024, 256, 1024), (16384, 256, 1024),
            (25, 2048, 1000), (65, 1544, 1032), (129, 2048, 8192),
            (300, 1544, 4104), (65, 256, 1024))


# The tests' own model of the two_pass kernel's schedule (tp_tile and
# TpSegments in csrc/fused_ffn.cu), walked from the plan's blocks and
# parts and the shapes, as the kernel walks it.
def _geometry(m, d, f):
    """Row tiles, and each pass's column tiles, K chunks and tiles."""
    rt = -(-m // PASS_BM)
    col_tiles = (-(-f // (PASS_BN // 2)), -(-d // PASS_BN))
    nk = (-(-d // PASS_KC), -(-f // PASS_KC))
    return rt, col_tiles, nk, tuple(rt * c for c in col_tiles)


def _tile(tile, row_tiles, col_tiles):
    """``(row tile, column tile)`` of a tile, as ``tp_tile`` numbers them:
    groups of PASS_GROUP_M row tiles walk the column tiles, rows
    fastest."""
    per_group = PASS_GROUP_M * col_tiles
    first = tile // per_group * PASS_GROUP_M
    rows_in = min(row_tiles - first, PASS_GROUP_M)
    in_group = tile - first * col_tiles
    return first + in_group % rows_in, in_group // rows_in


def _segments(m, d, f, p):
    """Block by block, the segments ``(tile, c0, c1)`` of pass ``p``, as
    ``TpSegments`` walks them: the whole waves' tiles b, b + blocks, ...,
    then part b // rem of the last wave's tile b % rem."""
    tp = two_pass_plan(m, d, f).two_pass
    _, _, nk, tiles = _geometry(m, d, f)
    nk, tiles, nb, parts = nk[p], tiles[p], tp.blocks[p], tp.parts[p]
    full = tiles // nb * nb
    rem = tiles - full
    out = []
    for b in range(nb):
        segs = [(t, 0, nk) for t in range(b, full, nb)]
        if b < rem * parts:
            q = b // rem
            segs.append((full + b % rem, q * nk // parts,
                         (q + 1) * nk // parts))
        out.append(segs)
    return out


def _fixups(m, d, f, p):
    """The tiles of pass ``p`` cut into K parts: ``{tile: [block, ...]}``
    in the order the last of them to finish sums their shares (part
    order: ``tp_fixup`` reads slot ``r + q * rem`` for part q)."""
    nk = _geometry(m, d, f)[2][p]
    fix = {}
    for b, segs in enumerate(_segments(m, d, f, p)):
        for t, c0, c1 in segs:
            if c0 > 0 or c1 < nk:
                fix.setdefault(t, []).append((c0, b))
    return {t: [b for _, b in sorted(v)] for t, v in fix.items()}


@pytest.mark.parametrize("m,d,f", TWO_PASS)
def test_two_pass_schedule_runs_every_tile_chunk_once(m, d, f):
    """Both passes: every (tile, K chunk) is run by exactly one block, no
    block is idle beyond the last wave's, at most one block an SM; the
    whole waves' tiles are whole and only the last wave's tiles are cut
    into K parts, each of at least PASS_PART_MIN_CHUNKS chunks but where
    a tile has fewer."""
    plan = two_pass_plan(m, d, f)
    tp = plan.two_pass
    _, _, nks, tiles_of = _geometry(m, d, f)
    assert plan.route == "two_pass" and plan.grid == (*tp.blocks, 1)
    for p in (0, 1):
        nk, tiles, nb = nks[p], tiles_of[p], tp.blocks[p]
        assert nb <= H100_SMS and 1 <= tp.parts[p] <= PASS_MAX_PARTS
        seen = {}
        for b, segs in enumerate(_segments(m, d, f, p)):
            assert segs, f"block {b} of pass {p + 1} has no work"
            for t, c0, c1 in segs:
                assert 0 <= c0 < c1 <= nk
                for c in range(c0, c1):
                    assert (t, c) not in seen
                    seen[(t, c)] = b
        assert len(seen) == tiles * nk
        full = tiles // nb * nb
        for t, parts in _fixups(m, d, f, p).items():
            assert t >= full and len(parts) == tp.parts[p] > 1
            assert nk // tp.parts[p] >= min(PASS_PART_MIN_CHUNKS, nk)


@pytest.mark.parametrize("m,d,f", TWO_PASS)
def test_two_pass_parts_are_summed_in_part_order(m, d, f):
    """A tile cut into K parts: its blocks (one a part, each holding no
    other share) are listed in the order of their K ranges, which tile
    [0, nk) without a gap; the last of them to arrive sums the shares in
    that order, so a call repeats bit for bit.  The workspace holds one
    64 x 256 f32 share a block and consumer warpgroup, the counters two a
    tile of the last wave."""
    plan = two_pass_plan(m, d, f)
    tp = plan.two_pass
    _, _, nks, tiles_of = _geometry(m, d, f)
    for p in (0, 1):
        segs = _segments(m, d, f, p)
        holders = []
        for t, blocks in _fixups(m, d, f, p).items():
            ranges = [next((c0, c1) for tt, c0, c1 in segs[b] if tt == t)
                      for b in blocks]
            assert ranges[0][0] == 0 and ranges[-1][1] == nks[p]
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            holders += blocks
        assert len(holders) == len(set(holders))
        if holders:
            rem = tiles_of[p] % tp.blocks[p]
            assert plan.ws_floats >= tp.blocks[p] * 2 * 64 * PASS_BN
            assert plan.counters >= 2 * rem
    if max(tp.parts) == 1:
        assert plan.ws_floats == plan.counters == 0


@pytest.mark.parametrize("m,d,f", [(16384, 3840, 15360), (4096, 7168, 20480),
                                   (1000, 2048, 1000), (300, 1544, 4104)])
def test_two_pass_raster_groups(m, d, f):
    """Tiles are numbered in groups of PASS_GROUP_M row tiles (the last
    group what is left) that walk the column tiles together, rows
    fastest: the numbering is a bijection onto (row tile, column tile),
    and the blocks of a wave (132 consecutive tiles) touch at most
    PASS_GROUP_M x 2 row tiles and ceil(132 / rows) + 1 column tiles of
    a group, so they share x / H rows and weight columns in L2."""
    rt, col_tiles, _, tiles_of = _geometry(m, d, f)
    for p in (0, 1):
        ct = col_tiles[p]
        coords = [_tile(t, rt, ct) for t in range(tiles_of[p])]
        assert sorted(coords) == [(r, c) for r in range(rt)
                                  for c in range(ct)]
        for t, (r, c) in enumerate(coords):
            first = t // (PASS_GROUP_M * ct) * PASS_GROUP_M
            rows_in = min(rt - first, PASS_GROUP_M)
            assert first <= r < first + rows_in
            assert t - first * ct == (c * rows_in + r - first)
        for w in range(0, tiles_of[p], H100_SMS):
            wave = coords[w:w + H100_SMS]
            assert len({r for r, _ in wave}) <= 2 * PASS_GROUP_M


def test_two_pass_plan_at_every_config():
    """Every config's FFN above D 512 at a prefill burst (M 4096) and at
    a decode step of 32 and 64 rows: two_pass, at most one block an SM,
    the shared memory of the kernel's layout within the H100's 232,448
    bytes; the served decode steps of 32 and 64 rows use at least 64 SMs
    in each pass (a last wave cut into up to 8 K parts), where whole
    tiles would leave pass 2 on D / 256 of them (8 at zamba2-1.2b's D
    2048, 28 at yi-34b's 7168)."""
    for d, f in WIDE:
        for m in (32, 64, 4096):
            plan = ffn_plan(torch.bfloat16, m, d, f)
            if m <= 64 and not _wants_stream(m, d):
                continue
            tp = plan.two_pass
            assert plan.route == "two_pass"
            assert max(tp.blocks) <= H100_SMS
            assert plan.smem == PASS_SMEM == 230480 <= MAX_SMEM
            if m <= 64 and (d, f) in SERVED:
                assert min(tp.blocks) >= 64 and tp.blocks[1] > d // 256


def test_two_pass_tma_map_numbers():
    """The 36 numbers of the six maps (x, Wg, Wu, Wd, H, y), each read or
    written in boxes of 64 columns by 64 rows in the 128-byte swizzle,
    for a (300, 1544) x (1544, 4104) FFN."""
    m, d, f = 300, 1544, 4104
    x = torch.zeros(m, d, dtype=torch.bfloat16)
    w = torch.zeros(d, f, dtype=torch.bfloat16)
    wd = torch.zeros(f, d, dtype=torch.bfloat16)
    h = torch.zeros(m, f, dtype=torch.bfloat16)
    assert two_pass_numbers(x, w, w, wd, h, x) == [
        1544, 300, 3088, 64, 64, 128,         # x
        4104, 1544, 8208, 64, 64, 128,        # Wg
        4104, 1544, 8208, 64, 64, 128,        # Wu
        1544, 4104, 3088, 64, 64, 128,        # Wd
        4104, 300, 8208, 64, 64, 128,         # H
        1544, 300, 3088, 64, 64, 128]         # y


def test_two_pass_constants_match_the_kernels():
    """The C entry refuses a plan whose numbers differ from the kernel's
    constants (namespace tp of csrc/fused_ffn.cu): the plan mirrors them,
    and its shared memory is the kernel's layout."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "kernels" / "csrc" / "fused_ffn.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src[
        src.index("namespace tp {"):src.index("}  // namespace tp")]))
    assert {k: int(v) for k, v in consts.items()} == {
        "kBM": PASS_BM, "kBN": PASS_BN, "kKC": PASS_KC, "kBox": 64,
        "kStages": PASS_STAGES, "kGroupM": PASS_GROUP_M, "kThreads": 384,
        "kProducerRegs": 24, "kConsumerRegs": 240}
    assert PASS_SMEM == (1024 + PASS_STAGES * (PASS_BM * 128
                                               + PASS_KC * PASS_BN * 2)
                         + 4 * 64 * 128 + 16 * PASS_STAGES + 16)


# ------------------------------------------------------------ small_m ----
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "fused_ffn.cu")


def _pr16_bytes(m, d):
    """The shared memory of PR 16's small_m kernel at (M, D), whose reach
    (200 KiB) is the route's domain: x, D x 16 Wg/Wu slices and a 16 x 64
    Wd block in bf16, 8 warps' f32 partials of G and U, and H."""
    mp, dp = -(-m // 16) * 16, -(-d // 16) * 16
    return (2 * (mp * (dp + 8) + 2 * dp * 24 + 16 * 64)
            + 4 * (8 * mp * 16 * 2 + mp * 16))


# (D, F) of every config's dense gated FFN in small_m's reach, at full
# width and reduced (the tiny test configs, d 64 and 256), paper-backbone's
# among them, beside ragged shapes of the card tests
SMALL_SHAPES = sorted(
    {(c.d_model, c.d_ff)
     for a in sorted(set(ARCHS) | {"paper-backbone"})
     for c in (get_config(a), get_config(a).reduced(),
               get_config(a).reduced(d_model=64))
     if c.d_ff > 0 and small_m_fits(1, c.d_model)}
    | {(16, 64), (96, 200), (264, 1000), (512, 2048), (512, 1032),
       (1024, 4096), (1024, 4104), (1440, 200), (576, 8192)})
SMALL_M = (1, 7, 8, 9, 16, 24, 32, 33, 48, 64)


def test_small_domain_is_that_of_pr16s_kernel():
    """small_m takes exactly the shapes PR 16's kernel took: M <= 64 where
    its x and slices fit 200 KiB (every M at D <= 576, M <= 32 up to D
    1040, M <= 16 up to D 1440)."""
    for m in range(1, 80):
        for d in range(8, 2049, 8):
            assert small_m_fits(m, d) == (
                m <= SMALL_MAX_M and _pr16_bytes(m, d) <= 200 * 1024), (m, d)
    assert SMALL_MAX_D == {16: 1440, 32: 1040, 48: 768, 64: 576}


def _small_blocks(plan, f):
    """Block by block, as the kernel derives them from its cluster and
    rank: ``(block, cluster, rank, group, F range, units [u0, u1))``."""
    sp = plan.small
    out = []
    for b in range(plan.grid[0]):
        k, r = divmod(b, sp.cluster)
        g, s = k % sp.groups, k // sp.groups
        c0 = s * sp.units // sp.fsplits
        c1 = (s + 1) * sp.units // sp.fsplits
        out.append((b, k, r, g, s, c0 + r * (c1 - c0) // sp.cluster,
                    c0 + (r + 1) * (c1 - c0) // sp.cluster))
    return out


@pytest.mark.parametrize("m", SMALL_M)
@pytest.mark.parametrize("d,f", SMALL_SHAPES)
def test_small_plan_covers_every_column_once(m, d, f):
    """At every config's FFN in reach and every row count: the cluster
    size divides the grid and is at most 16, every block runs at least
    one 64-column F unit, each column group sees every unit exactly once
    (over its F ranges), the groups cover every 64-column output tile
    exactly once, at most ``SMALL_MAX_CLUSTERS`` clusters, and the
    workspace and counters exist exactly when F is split over
    clusters."""
    if not small_m_fits(m, d):
        assert ffn_plan(torch.bfloat16, m, d, f).route != "small_m"
        return
    plan = ffn_plan(torch.bfloat16, m, d, f)
    sp = plan.small
    assert plan.route == "small_m" and plan == small_plan(m, d, f)
    assert sp.rows == min(r for r in SMALL_ROWS if r >= m)
    assert 1 <= sp.cluster <= SMALL_MAX_CLUSTER == 16
    assert plan.grid[0] % sp.cluster == 0 and plan.grid[1:] == (1, 1)
    assert plan.grid[0] == sp.cluster * sp.groups * sp.fsplits
    assert sp.groups * sp.fsplits <= SMALL_MAX_CLUSTERS
    units, tiles = -(-f // SMALL_UNIT_F), -(-d // SMALL_TILE_D)
    assert (sp.units, sp.nk) == (units, -(-d // SMALL_KC))
    seen = {}
    for b, k, r, g, s, u0, u1 in _small_blocks(plan, f):
        assert u0 < u1, f"block {b} runs no unit"
        for u in range(u0, u1):
            assert (g, u) not in seen
            seen[(g, u)] = b
    assert len(seen) == sp.groups * units
    groups = [range(g * sp.tiles_g, min((g + 1) * sp.tiles_g, tiles))
              for g in range(sp.groups)]
    assert all(groups) and sorted(t for g in groups for t in g) \
        == list(range(tiles))
    split = sp.fsplits > 1
    assert plan.ws_floats == (sp.fsplits * m * d if split else 0)
    assert plan.counters == (sp.groups * sp.cluster if split else 0)
    assert plan.h_elems == 0


@pytest.mark.parametrize("m", (1, 8, 33, 64))
@pytest.mark.parametrize("d,f", SMALL_SHAPES)
def test_small_sum_order_is_fixed(m, d, f):
    """The cluster's sum: each rank owns one run of the group's quads (4
    columns within D) in rank order, the runs tile the quads without a
    gap, and the kernel's owner formula (the largest rank whose run
    begins at or before the quad) picks that run's rank; every owner's
    receive rows (one run a rank) fit its receive buffer.  The owner adds
    ranks 0, 1, ... in turn, and the F ranges' sums are added in range
    order: no order depends on timing."""
    if not small_m_fits(m, d):
        return
    plan = ffn_plan(torch.bfloat16, m, d, f)
    sp = plan.small
    cs = sp.cluster
    for g in range(sp.groups):
        t0 = g * sp.tiles_g
        t1 = min(t0 + sp.tiles_g, -(-d // SMALL_TILE_D))
        quads = (min(t1 * SMALL_TILE_D, d) - t0 * SMALL_TILE_D) // 4
        runs = [range(r * quads // cs, (r + 1) * quads // cs)
                for r in range(cs)]
        assert [q for run in runs for q in run] == list(range(quads))
        for r, run in enumerate(runs):
            assert len(run) <= small_owned_quads(sp.tiles_g, cs)
            for q in run:
                assert ((q + 1) * cs - 1) // quads == r


@pytest.mark.parametrize("m", SMALL_M)
@pytest.mark.parametrize("d,f", SMALL_SHAPES)
def test_small_shared_memory_fits(m, d, f):
    """A block's shared memory is the kernel's layout (ring, H, x, its
    share, the received shares, barriers) at no fewer than 2 ring slots,
    within the H100's 232,448 bytes."""
    if not small_m_fits(m, d):
        return
    plan = ffn_plan(torch.bfloat16, m, d, f)
    sp = plan.small
    assert plan.smem == small_smem(sp.rows, sp.nk, sp.tiles_g, sp.stages,
                                   sp.cluster) <= MAX_SMEM == 232448
    assert 2 <= sp.stages <= SMALL_MAX_STAGES


def test_small_paper_backbone_decode_step():
    """paper-backbone's decode step (M 8, D 256, F 1024): four clusters
    of 16 blocks, each cluster one 64-column output tile over all of F,
    each block one 64-column F unit; no workspace, no counter; five ring
    slots (a block's four Wg/Wu chunks and its Wd tile, all in flight at
    once)."""
    plan = ffn_plan(torch.bfloat16, 8, 256, 1024)
    assert plan.route == "small_m" and plan.grid == (64, 1, 1)
    sp = plan.small
    assert (sp.rows, sp.cluster, sp.groups, sp.tiles_g, sp.units, sp.nk,
            sp.stages, sp.fsplits) == (8, 16, 4, 1, 16, 4, 5, 1)
    assert plan.ws_floats == plan.counters == 0
    # 1024 + 5 slots + H (16 rows of 128 bytes) + x (4 blocks of 8 rows)
    # + share (8 x 68 floats) + received (16 ranks x 8 rows x 1 quad)
    # + barriers
    assert plan.smem == (1024 + 5 * 16384 + 2048 + 4096 + 8 * 68 * 4
                         + 16 * 8 * 16 + 96) == 93408


def test_small_splits_f_at_large_d_times_f():
    """Where one cluster's blocks would each stream several units' tiles
    over a wide D (D 1024, F 4096: 1.5 MB a block), F is split over
    clusters (4 ranges of 16 units), so each block streams one unit."""
    plan = ffn_plan(torch.bfloat16, 16, 1024, 4096)
    sp = plan.small
    assert sp.fsplits > 1 and plan.grid[0] >= 64
    assert -(-sp.units // (sp.fsplits * sp.cluster)) == 1
    assert plan.ws_floats == sp.fsplits * 16 * 1024
    with pytest.raises(ValueError, match="do not give"):
        small_plan(8, 256, 1024, groups=1, fsplits=2)
    with pytest.raises(ValueError, match="does not take"):
        small_plan(65, 256, 1024)


def _c_expr(name):
    """The return expression of ``sm::<name>`` in the kernel's source, as
    Python (integer division)."""
    src = CSRC.read_text()
    ns = src[src.index("namespace sm {"):src.index("}  // namespace sm")]
    body = ns[ns.index(f" {name}("):]
    expr = body[body.index("return") + 6:body.index(";")]
    return " ".join(expr.split()).replace("/", "//")


def test_small_constants_match_the_kernel():
    """The C entry refuses a plan whose numbers differ from the kernel's
    constants (namespace sm of csrc/fused_ffn.cu): the plan mirrors them,
    and its shared-memory formula is the kernel's ``smem_bytes``
    (evaluated from the source) at every planned shape."""
    src = CSRC.read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);",
        src[src.index("namespace sm {"):src.index("}  // namespace sm")])}
    assert consts == {"kUnitF": SMALL_UNIT_F, "kKC": SMALL_KC,
                      "kTileD": SMALL_TILE_D, "kSlot": SMALL_SLOT,
                      "kMaxStages": SMALL_MAX_STAGES,
                      "kMaxCluster": SMALL_MAX_CLUSTER, "kThreads": 160}
    owned, smem = _c_expr("owned_quads"), _c_expr("smem_bytes")
    for d, f in SMALL_SHAPES:
        for m in SMALL_M:
            if not small_m_fits(m, d):
                continue
            sp = small_plan(m, d, f).small
            env = dict(consts, mp=sp.rows, nk=sp.nk, tiles_g=sp.tiles_g,
                       stages=sp.stages, cluster=sp.cluster)
            env["owned_quads"] = lambda t, c: eval(
                owned, dict(consts, tiles_g=t, cluster=c))
            assert eval(smem, env) == small_smem(
                sp.rows, sp.nk, sp.tiles_g, sp.stages, sp.cluster)
            assert eval(owned, env) == small_owned_quads(sp.tiles_g,
                                                         sp.cluster)


def test_small_entry_numbers():
    """The 11 plan numbers and the 24 map numbers the entry takes, for a
    (9, 264) x (264, 1000) FFN: MP 16, x in boxes of 64 columns by 16
    rows, Wg/Wu/Wd in 64 x 64 boxes."""
    m, d, f = 9, 264, 1000
    plan = ffn_plan(torch.bfloat16, m, d, f)
    sp = plan.small
    assert small_entry_plan(plan) == [16, 64, 64, 64, 16384, sp.cluster,
                                      sp.groups, sp.tiles_g, sp.stages,
                                      plan.smem, sp.fsplits]
    x = torch.zeros(m, d, dtype=torch.bfloat16)
    w = torch.zeros(d, f, dtype=torch.bfloat16)
    wd = torch.zeros(f, d, dtype=torch.bfloat16)
    assert small_numbers(x, w, w, wd, plan) == [
        264, 9, 528, 64, 16, 128,             # x: 64 columns x MP rows
        1000, 264, 2000, 64, 64, 128,         # Wg
        1000, 264, 2000, 64, 64, 128,         # Wu
        264, 1000, 528, 64, 64, 128]          # Wd


def _emulate_small(x, wg, wu, wd, act, plan):
    """The small_m kernel's arithmetic, block by block, at its rounding
    points: G and U f32 over all of D, H = act(G) U as bf16 hi + lo, each
    block's f32 share (its units' hi and lo products, units in order),
    the cluster's sum over ranks in order, the F ranges' sums in order,
    one rounding to bf16.  The products' own summation order is left to
    torch (the card's wgmma sums in its own)."""
    sp = plan.small
    m, d = x.shape
    xf, gf, uf, df = (t.float() for t in (x, wg, wu, wd))
    share = {}
    for b, k, r, g, s, u0, u1 in _small_blocks(plan, wg.shape[1]):
        cols = slice(g * sp.tiles_g * SMALL_TILE_D,
                     (g + 1) * sp.tiles_g * SMALL_TILE_D)
        acc = None
        for u in range(u0, u1):
            fs = slice(u * SMALL_UNIT_F, (u + 1) * SMALL_UNIT_F)
            gg, uu = xf @ gf[:, fs], xf @ uf[:, fs]
            h = (torch.nn.functional.silu(gg) if act == "silu"
                 else torch.nn.functional.gelu(gg, approximate="tanh")) * uu
            hi = h.to(torch.bfloat16).float()
            lo = (h - hi).to(torch.bfloat16).float()
            v = hi @ df[fs, cols] + lo @ df[fs, cols]
            acc = v if acc is None else acc + v
        share[(g, s, r)] = (cols, acc)
    out = torch.zeros(m, d)
    for g in range(sp.groups):
        total = None
        for s in range(sp.fsplits):
            cols, y = share[(g, s, 0)]
            for r in range(1, sp.cluster):
                y = y + share[(g, s, r)][1]
            total = y if total is None else total + y
        out[:, cols] = total
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("m,d,f", [(8, 256, 1024), (1, 256, 1000),
                                   (33, 96, 200), (64, 512, 1032),
                                   (16, 1024, 4104), (9, 264, 1000)])
def test_small_emulation_matches_the_plain_version(m, d, f, act):
    """The kernel's rounding points and its plan's split of F and of the
    output (emulated on the CPU) give the plain version's output within
    the card tests' bf16 tolerance, and a repeat of the emulation is bit
    for bit (no order depends on anything but the plan)."""
    rng = np.random.default_rng(m + d + f)

    def normal(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(
            np.float32)).to(torch.bfloat16)

    x = normal((m, d), 1.0)
    wg, wu = normal((d, f), d ** -0.5), normal((d, f), d ** -0.5)
    wd = normal((f, d), f ** -0.5)
    plan = ffn_plan(torch.bfloat16, m, d, f)
    got = _emulate_small(x, wg, wu, wd, act, plan)
    torch.testing.assert_close(got.float(), fused_ffn_ref(
        x, wg, wu, wd, act).float(), atol=2e-2, rtol=1e-2)
    assert torch.equal(got, _emulate_small(x, wg, wu, wd, act, plan))
