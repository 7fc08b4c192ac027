"""K3's ``stream`` route planned on the CPU: the plan at every config's
FFN, the even split of the weight bytes over the SMs, the workspaces, and
the numbers of its 2-d TMA tensor maps (``kernels/fused_ffn.py``).  The
kernels themselves run only on the card (``test_torch_cuda.py``,
``chip_smoke.py`` phase 2); what they take from this plan is checked
here, shape by shape.  No JAX: the plan is the port's own."""
import re
import statistics
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.fused_ffn import (H100_SMS, MAX_SMEM, SMALL_MAX_M,
                                           SMALL_SMEM, STREAM_FC, STREAM_KC,
                                           STREAM_STAGES, STREAM_TILE_D,
                                           STREAM_UNIT_F, ffn_plan,
                                           ffn_tma_map, small_smem_bytes,
                                           stream_numbers, stream_shares)

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
