"""K2's launch plan and TMA tensor maps, on the CPU.

``flash_plan`` picks the route and tiles of every flash-attention launch
on the card (bf16 on ``wgmma`` at every head dim, hd 16 and 32 in their
own geometry, f32 on the CUDA cores) and ``tma_map`` / ``tma_numbers``
give the tensor maps the ``wgmma`` route reads q, k and v through.  Both
are host-side functions: a config they refuse cannot prefill on the
card, and a view TMA cannot read must be refused with ``ValueError``
before any launch.  Shapes are each config's own (heads, KV heads, head
dim) at its prefill bucket; the tensors are views on the meta device, so
no attention is computed here (the plain version is held to the JAX package
in ``test_torch_kernels.py``; the kernel to the plain version by the
``gpu`` tests in ``test_torch_cuda.py``).
"""
import pytest
import torch

from repro_torch.configs import BONUS_ARCHS, get_config, list_archs
from repro_torch.kernels import flash_attn
from repro_torch.kernels.flash_attn import (WGMMA_HEAD_DIMS, flash_plan,
                                            tma_map, tma_numbers)

H100_SMEM = 232_448          # shared memory one block may use, bytes
H100_REGS = 65_536           # 32-bit registers of one SM

ARCHS = [a for a in list(list_archs()) + list(BONUS_ARCHS)
         if not get_config(a).is_attention_free]


def _views(b, s, h, kvh, hd, sk=None):
    """q (B,S,H,hd) and k/v (B,S_k,K,hd) in the model's layout, passed as
    (B,H,S,hd) / (B,K,S_k,hd) views, as ``attention._attend`` passes
    them; on the meta device (shapes and strides, no memory)."""
    sk = s if sk is None else sk
    return tuple(torch.empty(b, n, heads, hd, dtype=torch.bfloat16,
                             device="meta").transpose(1, 2)
                 for n, heads in ((s, h), (sk, kvh), (sk, kvh)))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_plans_k2_on_its_route(arch):
    cfg = get_config(arch)
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for s, sk in ((2048, 2048), (16, cfg.encoder_seq_len)):
        plan = flash_plan(torch.bfloat16, hd, s, sk, h, kvh)
        assert hd in WGMMA_HEAD_DIMS and plan.route == "wgmma"
        assert 0 < plan.smem <= H100_SMEM and plan.regs <= H100_REGS
        assert plan.q_tiles == -(-s // plan.block_q)
        f32 = flash_plan(torch.float32, hd, s, sk, h, kvh)
        assert f32.route == "cuda_cores" and f32.smem <= H100_SMEM


@pytest.mark.parametrize("hd,bk,q_slots,stages,smem", [
    (64, 128, 2, 4, 164_976), (96, 128, 2, 2, 197_712),
    (128, 128, 2, 2, 197_712), (256, 64, 1, 2, 197_696)])
def test_wgmma_plan_tiles(hd, bk, q_slots, stages, smem):
    """The wgmma route's tiles, as ``WgTile`` in flash_attn.cu holds them:
    128 query rows (two consumer warpgroups of 64) beside a producer
    warpgroup, Q in one or two slots, a ring of K/V tiles; hd 96 in hd
    128's layout.  Shared memory = 1024 (alignment) + the Q slots + the
    ring + the barriers and the tile indices."""
    plan = flash_plan(torch.bfloat16, hd, 1000, 1000, 8, 2)
    assert plan == flash_attn.FlashPlan("wgmma", 128, bk, stages, 384, smem,
                                        128 * 24 + 256 * 240, 8)
    hdp = 128 if hd == 96 else hd
    assert smem == 1024 + q_slots * 2 * 128 * hdp \
        + stages * 2 * 2 * bk * hdp + 8 * (2 * stages + 2 * q_slots) + 16


def test_mma_sync_plan_at_head_dims_16_and_32():
    """hd 16 and 32 left ``mma.sync`` for ``wgmma``: ``NwTile``'s geometry
    (a producer warpgroup beside one consumer warpgroup of 64 query rows,
    64-key tiles in a 3-stage ring, three blocks an SM).  Shared memory =
    1024 (alignment) + two Q slots + the ring + a tile of ones + the
    barriers and tile indices; three blocks' shared memory (and the 1 KB
    each reserves) and registers fit one H100 SM."""
    assert (flash_attn.NW_BLOCK_K, flash_attn.NW_STAGES,
            flash_attn.NW_CONSUMER_REGS) == (64, 3, 136)
    for hd, smem in ((16, 19_552), (32, 37_984)):
        plan = flash_plan(torch.bfloat16, hd, 2048, 2048, 8, 8)
        assert (plan.route, plan.block_q, plan.block_k, plan.stages,
                plan.threads, plan.smem, plan.q_tiles) == (
                    "wgmma", 64, 64, 3, 256, smem, 32)
        tile = 64 * 2 * hd
        assert smem == 1024 + 2 * tile + 3 * 2 * tile + tile + 8 * 10 + 16
        assert 3 * (plan.smem + 1024) <= 233_472
        # setmaxnreg's split of what the launch gives a thread at three
        # blocks an SM: 65536 / 768 down to a multiple of 8
        assert plan.regs == 128 * 24 + 128 * 136 == 256 * 80
        assert 3 * plan.regs <= H100_REGS


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_plan(torch.bfloat16, 48, 64, 64, 4, 4)
    with pytest.raises(ValueError):
        flash_plan(torch.float16, 64, 64, 64, 4, 4)
    with pytest.raises(ValueError):
        flash_plan(torch.bfloat16, 64, 64, 64, 6, 4)    # 4 does not divide 6
    with pytest.raises(ValueError):
        flash_plan(torch.bfloat16, 64, 0, 64, 4, 4)


@pytest.mark.parametrize("b,s,h,kvh,hd", [
    (8, 2048, 16, 8, 256),          # gemma3-12b
    (8, 512, 56, 8, 128),           # yi-34b: group 7
    (8, 512, 48, 8, 128),           # internvl2-26b: group 6
    (8, 512, 32, 32, 96),           # phi3-mini
    (8, 1024, 32, 32, 64),          # zamba2-1.2b
    (1, 1, 8, 2, 64),               # one row: extent-1 dims
])
def test_tma_maps_of_the_models_views(b, s, h, kvh, hd):
    """The model's (B,S,H,hd).transpose(1,2) views read in place: dims
    innermost first (hd, S, H, B), byte strides of S, H and B, boxes of 64
    columns by the plan's rows; 27 numbers for the C entry."""
    q, k, v = _views(b, s, h, kvh, hd)
    plan = flash_plan(torch.bfloat16, hd, s, s, h, kvh)
    mq, mk = tma_map(q, plan.block_q), tma_map(k, plan.block_k)
    assert mq.dims == (hd, s, h, b) and mk.dims == (hd, s, kvh, b)
    assert mq.box == (64, plan.block_q) and mk.box == (64, plan.block_k)
    assert mq.swizzle == 128
    if s > 1:
        assert mq.strides[0] == 2 * h * hd and mk.strides[0] == 2 * kvh * hd
    assert mq.strides[1] == 2 * hd
    if b > 1:
        assert mq.strides[2] == 2 * s * h * hd
    for st in mq.strides + mk.strides:
        assert st > 0 and st % 16 == 0 and st < 1 << 40
    nums = tma_numbers(q, k, v, plan)
    assert len(nums) == 27
    assert nums[:9] == [*mq.dims, *mq.strides, *mq.box]
    assert nums[9:18] == nums[18:] == [*mk.dims, *mk.strides, *mk.box]


@pytest.mark.parametrize("b,s,h,kvh,hd", [
    (8, 2048, 8, 8, 32),            # paper-backbone, the long wave
    (8, 16, 8, 8, 32),              # a short bucket
    (4, 256, 8, 8, 32),             # an adaptation infer
    (2, 77, 8, 2, 16),              # hd 16, group 4
    (1, 1, 8, 8, 32),               # one row: extent-1 dims
])
def test_tma_maps_at_narrow_head_dims(b, s, h, kvh, hd):
    """hd 32 and 16 are read in one box of hd columns a tile: 64- and
    32-byte rows, each the swizzle span (CU_TENSOR_MAP_SWIZZLE_64B /
    32B), at the model's transposed views; 27 numbers for the C entry,
    whose box columns (numbers 7, 16, 25) the kernel checks against hd."""
    q, k, v = _views(b, s, h, kvh, hd)
    plan = flash_plan(torch.bfloat16, hd, s, s, h, kvh)
    mq, mk = tma_map(q, plan.block_q, hd), tma_map(k, plan.block_k, hd)
    assert mq.box == (hd, plan.block_q) and mk.box == (hd, plan.block_k)
    assert mq.swizzle == mk.swizzle == 2 * hd
    assert mq.dims == (hd, s, h, b) and mk.dims == (hd, s, kvh, b)
    if s > 1:
        assert mq.strides[0] == 2 * h * hd and mk.strides[0] == 2 * kvh * hd
    nums = tma_numbers(q, k, v, plan)
    assert nums[:9] == [*mq.dims, *mq.strides, *mq.box]
    assert nums[9:18] == [*mk.dims, *mk.strides, *mk.box]
    assert nums[7] == nums[16] == nums[25] == hd
    assert nums[8] == plan.block_q and nums[17] == nums[26] == plan.block_k


def test_tma_map_refuses_narrow_views_tma_cannot_read():
    """At hd 16 and 32 as at 64: a base off 16 bytes, a row stride off
    16 bytes; and a box row that is no swizzle span (24 columns: 48
    bytes)."""
    with pytest.raises(ValueError, match="16-byte aligned base"):
        tma_map(torch.zeros(2, 4, 64, 40, dtype=torch.bfloat16)
                [..., 1:33], 64, 32)
    with pytest.raises(ValueError, match="multiple of 16"):   # 72-byte rows
        tma_map(torch.zeros(2, 4, 64, 36, dtype=torch.bfloat16)
                [..., :32], 64, 32)
    with pytest.raises(ValueError, match="multiple of 16"):   # 36-byte rows
        tma_map(torch.zeros(2, 4, 64, 18, dtype=torch.bfloat16)
                [..., :16], 64, 16)
    with pytest.raises(ValueError, match="swizzles span"):
        tma_map(torch.zeros(2, 4, 64, 24, dtype=torch.bfloat16), 64, 24)


def test_tma_maps_at_cross_attention_lengths():
    """whisper-small's cross-attention: 448 and 16 decoder queries over
    the 1500 encoder frames; q's and k's maps differ only in S."""
    cfg = get_config("whisper-small")
    sk, hd = cfg.encoder_seq_len, cfg.resolved_head_dim
    for sq in (448, 16):
        q, k, v = _views(8, sq, 12, 12, hd, sk)
        plan = flash_plan(torch.bfloat16, hd, sq, sk, 12, 12)
        assert plan.q_tiles == -(-sq // 128)
        nums = tma_numbers(q, k, v, plan)
        assert nums[:4] == [hd, sq, 12, 8] and nums[9:13] == [hd, sk, 12, 8]
        assert nums[13:16] == [2 * 12 * hd, 2 * hd, 2 * sk * 12 * hd]


def test_tma_map_refuses_what_tma_cannot_read():
    q, _, _ = _views(2, 64, 4, 4, 64)
    with pytest.raises(ValueError, match="16-byte aligned base"):
        tma_map(torch.zeros(2, 4, 64, 72, dtype=torch.bfloat16)
                [..., 1:65], 128)
    with pytest.raises(ValueError, match="multiple of 16"):   # 40-byte rows
        tma_map(torch.zeros(2, 4, 64, 20, dtype=torch.bfloat16)
                [..., :16], 128)
    with pytest.raises(ValueError, match="positive multiple"):  # broadcast
        tma_map(torch.zeros(2, 1, 64, 64, dtype=torch.bfloat16)
                .expand(2, 4, 64, 64), 128)
    with pytest.raises(ValueError, match="last dim dense"):
        tma_map(q.transpose(2, 3), 64)
    with pytest.raises(ValueError, match="bf16"):
        tma_map(torch.zeros(1, 4, 64, 64), 128)
    with pytest.raises(ValueError, match="1..256 rows"):
        tma_map(q, 512)


def test_launch_numbers_are_worked_out_once_a_layout():
    """The plan, strides and tensor map numbers the C entry takes are kept
    by the layout of q, k and v (dtype, shapes, strides): a second call
    with that layout reuses them, another layout gets its own."""
    q, k, v = _views(8, 512, 56, 8, 128)
    nums = flash_attn._launch_numbers(q, k, v, torch.empty_like(q))
    plan = flash_plan(torch.bfloat16, 128, 512, 512, 56, 8)
    assert nums.plan == plan
    assert list(nums.maps_arr) == tma_numbers(q, k, v, plan)
    assert list(nums.plan_arr) == [plan.block_q, plan.block_k, plan.stages,
                                   plan.threads, plan.smem]
    assert nums.strides == tuple(t.stride(i) for t in (q, k, v, q)
                                 for i in range(3))
    q2, k2, v2 = _views(8, 512, 56, 8, 128)
    assert flash_attn._launch_numbers(q2, k2, v2,
                                      torch.empty_like(q2)) is nums
    qc = q.contiguous()
    other = flash_attn._launch_numbers(qc, k, v, torch.empty_like(qc))
    assert other is not nums and other.strides[:3] == qc.stride()[:3]
    qs, ks, vs = _views(2, 64, 4, 4, 32)
    small = flash_attn._launch_numbers(qs, ks, vs, torch.empty_like(qs))
    assert small.plan.route == "wgmma"
    assert list(small.maps_arr) == tma_numbers(qs, ks, vs, small.plan)


def test_a_kept_layout_still_checks_each_base():
    """What the kept numbers do not cover, the base's alignment, is
    checked on every call: a view 2 bytes off, with the layout of one
    already seen, is refused."""
    z = torch.zeros(2, 4, 64, 72, dtype=torch.bfloat16)
    good, bad = z[..., :64], z[..., 1:65]
    assert good.stride() == bad.stride()
    flash_attn._launch_numbers(good, good, good, torch.empty_like(good))
    flash_attn._check(good, good, good, 0, None, causal=True)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attn._check(bad, bad, bad, 0, None, causal=True)
