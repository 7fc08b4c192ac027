"""K3's ``stream`` and ``two_pass`` routes planned on the CPU: the plan at
every config's FFN, the even split of the weight bytes over the SMs
(``stream``), the persistent tile schedule (``two_pass``: every tile and
K chunk once, the raster groups, the last wave's K parts summed in part
order), the workspaces, and the numbers of the 2-d TMA tensor maps
(``kernels/fused_ffn.py``).  The kernels themselves run only on the card
(``test_torch_cuda.py``, ``chip_smoke.py`` phase 2); what they take from
these plans is checked here, shape by shape.  No JAX: the plans are the
port's own."""
import re
import statistics
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.fused_ffn import (H100_SMS, MAX_SMEM, PASS_BM,
                                           PASS_BN, PASS_GROUP_M, PASS_KC,
                                           PASS_MAX_PARTS,
                                           PASS_PART_MIN_CHUNKS, PASS_SMEM,
                                           PASS_STAGES, SMALL_MAX_M,
                                           SMALL_SMEM, STREAM_FC, STREAM_KC,
                                           STREAM_STAGES, STREAM_TILE_D,
                                           STREAM_UNIT_F, ffn_plan,
                                           ffn_tma_map,
                                           small_smem_bytes, stream_numbers,
                                           stream_shares, two_pass_numbers,
                                           two_pass_plan)

torch.set_num_threads(2)

ARCHS = sorted(set(list_archs()) | {"mixtral-8x7b", "phi3-mini"})
# (D, F) of every config's dense gated FFN above D 512
WIDE = sorted({(c.d_model, c.d_ff) for c in map(get_config, ARCHS)
               if c.d_model > 512 and c.d_ff > 0})
# the served decode shapes (PERF.md's K3 rows at M 8)
SERVED = ((7168, 20480), (5120, 27392), (6144, 16384), (3072, 24576),
          (3840, 15360), (3072, 8192), (2048, 8192))


def _wants_stream(m, d):
    return not (m <= SMALL_MAX_M and small_smem_bytes(m, d) <= SMALL_SMEM)


@pytest.mark.parametrize("m", [1, 8, 24])
@pytest.mark.parametrize("d,f", WIDE)
def test_stream_plan_at_every_config(m, d, f):
    """Every config's FFN above D 512 at M 1, 8 and 24: the stream route
    wherever small_m does not fit (whisper-small's D 768 keeps small_m),
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
