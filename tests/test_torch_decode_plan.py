"""K1's bf16 route (``wgmma``) on the CPU: its plan and its arithmetic.

* ``decode_plan`` as a pure function of host-known shapes: the route by
  q's dtype, the split count against the H100's 132 SMs (never a
  function of the positions), N padding of the GQA group, head-dim
  padding, shared memory within one block's 232,448 bytes at every
  served shape, the refusals.
* ``tma_numbers``: the numbers the C entry encodes its tensor maps from
  (4-d maps of the pool slice, 2-d maps of the row scales), and what TMA
  cannot read.
* An emulation of the route, written here in plain PyTorch with the
  kernel's splits, 64-column tiles and rounding points (q unscaled in
  bf16, int8 codes exact in bf16, the row scales on the f32 scores,
  P x v_scale rounded to bf16, f32 sums, the split-order merge in
  log2 units), held against the JAX package's paged oracle within the
  bf16 tolerance the card's tests use (atol 2e-2, rtol 1e-2).  The
  kernel itself is held against the plain version on the card
  (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.act_quant import kv_quant_rows as j_quant
from repro_torch.kernels import paged_decode_attn as pda
from repro_torch.kernels.paged_decode_attn import (decode_plan, route_of,
                                                   tma_numbers, wg_smem)

torch.set_num_threads(2)

BF16_TOL = dict(atol=2e-2, rtol=1e-2)
JAX_REF = jax.jit(jref.paged_decode_attn_ref, static_argnames=("window",))
H100_SMEM = 232_448

# (label, heads, kv heads, hd, mb): the served decode shapes, 8 slots,
# block size 16
SERVED = [("paper-backbone", 8, 8, 32, 32),
          ("paper-backbone-2048", 8, 8, 32, 128),
          ("olmoe-1b-7b", 16, 16, 128, 64),
          ("whisper-small", 12, 12, 64, 32),
          ("internvl2-26b", 48, 8, 128, 64),
          ("gemma3-12b", 16, 8, 256, 128),
          ("phi3-mini", 32, 32, 96, 64),
          ("gemma-7b", 16, 16, 256, 64),
          ("yi-34b", 56, 8, 128, 64),
          ("qwen1.5-32b", 40, 40, 128, 64)]


@pytest.mark.parametrize("q_dtype,kv_dtype,route", [
    (torch.bfloat16, torch.int8, "wgmma"),
    (torch.bfloat16, torch.bfloat16, "wgmma"),
    (torch.bfloat16, torch.float32, "cuda_cores"),
    (torch.float32, torch.int8, "cuda_cores"),
    (torch.float32, torch.bfloat16, "cuda_cores"),
    (torch.float32, torch.float32, "cuda_cores")])
def test_route_by_dtype(q_dtype, kv_dtype, route):
    assert route_of(q_dtype, kv_dtype) == route
    plan = decode_plan(8, 8, 2, 32, 16, 32, kv_dtype, q_dtype)
    assert plan.route == route
    if route == "cuda_cores":          # the CUDA-core kernel's plan
        assert plan == decode_plan(8, 8, 2, 32, 16, 32, kv_dtype)
        assert plan.split_cols == pda.SPLIT_COLS


@pytest.mark.parametrize("label,h,kvh,hd,mb", SERVED,
                         ids=[s[0] for s in SERVED])
@pytest.mark.parametrize("pool", [torch.int8, torch.bfloat16])
def test_wg_plan_at_served_shapes(label, h, kvh, hd, mb, pool):
    """Splits are whole 64-column tiles; as many as fill the SMs' block
    slots once (three blocks an SM below hd 256, two at it), and one at
    least; the shared memory is what the kernel lays out and fits one
    block; the workspace holds every split's partial."""
    plan = decode_plan(8, h, kvh, hd, 16, mb, pool, torch.bfloat16)
    pairs = 8 * kvh
    slots_on_card = pda.SMS * (2 if plan.hd_pad == 256 else 3)
    assert plan.route == "wgmma"
    assert plan.split_cols % 64 == 0
    assert plan.splits == -(-(mb * 16) // plan.split_cols)
    assert 1 <= plan.splits <= max(1, slots_on_card // pairs)
    if pairs <= slots_on_card:
        assert pairs * plan.splits <= slots_on_card
    assert (plan.rows, plan.pieces) == (16, 4)
    assert plan.entries == plan.split_cols // 16 + 2
    assert plan.stages == pda.WG_STAGES
    esize = 1 if pool == torch.int8 else 2
    assert plan.smem == wg_smem(plan.hd_pad, plan.n, hd, esize,
                                pool == torch.int8, 4, plan.stages,
                                plan.entries)
    assert plan.smem <= H100_SMEM
    group = h // kvh
    assert plan.ws_floats == pairs * plan.splits * group * (hd + 2)
    assert plan.counters == pairs


def test_wg_plan_is_a_function_of_shapes_alone():
    """The plan takes no positions and is kept by its arguments: a graph
    captured at one step replays with the same geometry at the next."""
    a = decode_plan(8, 56, 8, 128, 16, 64, torch.int8, torch.bfloat16)
    b = decode_plan(8, 56, 8, 128, 16, 64, torch.int8, torch.bfloat16)
    assert a is b
    assert (a.splits, a.split_cols) == (6, 192)       # 384 blocks
    g3 = decode_plan(8, 16, 8, 256, 16, 128, torch.int8, torch.bfloat16)
    assert (g3.splits, g3.split_cols) == (4, 512)
    wide = decode_plan(8, 40, 40, 128, 16, 64, torch.int8, torch.bfloat16)
    assert (wide.splits, wide.split_cols) == (1, 1024)  # 320 pairs > 264
    one = decode_plan(1, 1, 1, 64, 16, 2048, torch.int8, torch.bfloat16)
    assert one.splits == pda.WG_MAX_SPLITS             # the merge's cap


@pytest.mark.parametrize("group", range(1, 17))
def test_wg_plan_pads_the_group_to_n(group):
    plan = decode_plan(4, 2 * group, 2, 64, 16, 8, torch.int8,
                       torch.bfloat16)
    assert plan.n == (8 if group <= 8 else 16)


@pytest.mark.parametrize("hd,hd_pad", [(16, 64), (32, 64), (64, 64),
                                       (96, 128), (128, 128), (256, 256)])
def test_wg_plan_pads_the_head_dim(hd, hd_pad):
    assert decode_plan(8, 8, 8, hd, 16, 32, torch.bfloat16,
                       torch.bfloat16).hd_pad == hd_pad


@pytest.mark.parametrize("bs,mb,rows,pieces", [(1, 64, 1, 64), (4, 16, 4, 16),
                                               (8, 16, 8, 8), (16, 4, 16, 4),
                                               (64, 2, 64, 1),
                                               (128, 1, 64, 1)])
def test_wg_plan_boxes_of_a_tile(bs, mb, rows, pieces):
    """A 64-column tile is ``pieces`` TMA boxes of ``rows`` pool rows,
    each inside one table block."""
    plan = decode_plan(2, 4, 2, 128, bs, mb, torch.bfloat16, torch.bfloat16)
    assert (plan.rows, plan.pieces) == (rows, pieces)
    assert plan.split_cols % max(64, 1) == 0


@pytest.mark.parametrize("args,why", [
    ((8, 34, 2, 64, 16, 8, torch.int8), "group 17"),
    ((8, 8, 8, 24, 16, 8, torch.int8), "hd 24"),
    ((8, 8, 8, 512, 16, 8, torch.bfloat16), "hd 512"),
    ((8, 8, 8, 64, 48, 8, torch.int8), "block 48"),
    ((8, 8, 8, 64, 2, 8, torch.int8), "int8 scales of 8 bytes"),
    ((8, 8, 8, 16, 4, 8, torch.int8), "a 64-byte box"),
    ((8, 8, 3, 64, 16, 8, torch.int8), "8 heads over 3")])
def test_wg_plan_refuses_what_it_does_not_take(args, why):
    with pytest.raises(ValueError):
        decode_plan(*args, torch.bfloat16)


def _pool(nb, layers, bs, kvh, hd, dtype, layer=1):
    k = torch.zeros(nb, layers, bs, kvh, hd, dtype=dtype)
    s = torch.zeros(nb, layers, bs, dtype=torch.float32)
    return k[:, layer], s[:, layer]


def test_tma_numbers_of_a_layer_slice():
    """One layer of a (num_blocks, layers, bs, kvh, hd) pool: dims (hd,
    kvh, bs, num_blocks), byte strides of kvh, bs and the block (the
    layer-interleaved stride), a box of one table block's rows of one kv
    head; the scales' (bs, num_blocks) with the block's byte stride."""
    kb, ks = _pool(9, 3, 16, 8, 128, torch.int8)
    plan = decode_plan(8, 56, 8, 128, 16, 1, torch.int8, torch.bfloat16)
    nums = tma_numbers(kb, kb, ks, ks, plan)
    assert nums[:9] == [128, 8, 16, 9, 128, 8 * 128, 3 * 16 * 8 * 128, 128,
                        16]
    assert nums[9:18] == nums[:9]
    assert nums[18:] == [16, 9, 3 * 16 * 4, 16] * 2
    vb, _ = _pool(9, 2, 16, 2, 96, torch.bfloat16)
    plan = decode_plan(8, 16, 2, 96, 16, 1, torch.bfloat16, torch.bfloat16)
    nums = tma_numbers(vb, vb, None, None, plan)
    assert nums[:9] == [96, 2, 16, 9, 192, 2 * 192, 2 * 16 * 2 * 192, 96,
                        16]
    assert nums[18:] == [0] * 8
    one, _ = _pool(1, 1, 16, 1, 64, torch.bfloat16, layer=0)
    plan = decode_plan(1, 1, 1, 64, 16, 1, torch.bfloat16, torch.bfloat16)
    assert tma_numbers(one, one, None, None, plan)[4:7] == [128, 128,
                                                            16 * 128]


def test_tma_numbers_refuse_what_tma_cannot_read():
    plan = decode_plan(8, 8, 8, 32, 16, 1, torch.int8, torch.bfloat16)
    full = torch.zeros(10, 16 * 8 * 32 + 8, dtype=torch.int8)
    odd = full[:, :16 * 8 * 32].unflatten(1, (16, 8, 32))   # block stride
    ks = torch.zeros(10, 16)
    with pytest.raises(ValueError):                      # 4104 bytes
        tma_numbers(odd, odd, ks, ks, plan)
    kb = torch.zeros(10, 16, 8, 32, dtype=torch.int8)
    bad_s = torch.zeros(10, 17)[:, :16]                  # 68-byte stride
    with pytest.raises(ValueError):
        tma_numbers(kb, kb, bad_s, bad_s, plan)
    shifted = torch.zeros(16 * 10 * 8 * 32 + 1, dtype=torch.int8)[1:]
    with pytest.raises(ValueError):                      # base 1 byte off
        tma_numbers(*(2 * [shifted.view(10, 16, 8, 32)]), ks, ks, plan)


# ------------------------------------------------ the route's arithmetic --
LOG2E = 1.4426950408889634


def emulate_wg(q, kb, vb, tables, pos, kn, vn, k_scale, v_scale, window,
               plan):
    """The ``wgmma`` route's arithmetic in plain PyTorch: each split's
    64-column tiles in order, the tile's max of each head, weights
    ex2(score - max) with the scores in log2 units, P x v_scale rounded
    to bf16 before its product with V, f32 sums; then the merge of the
    splits in order with the new token's key, rounded once to bf16."""
    slots, h, hd = q.shape
    nb, bs, kvh, _ = kb.shape
    mb = tables.shape[1]
    group = h // kvh
    sl2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.empty(slots, h, hd, dtype=torch.bfloat16)
    L = plan.split_cols
    for slot in range(slots):
        p = int(pos[slot])
        hi = min(p, mb * bs)
        lo = max(0, p - window + 1) if window else 0
        for kh in range(kvh):
            qg = q[slot, kh * group:(kh + 1) * group].float()
            parts = []
            for split in range(plan.splits):
                s0 = split * L
                cb, ce = max(s0, lo), min(s0 + L, hi)
                if cb >= ce:
                    continue
                m = torch.full((group,), -1e30)
                l = torch.zeros(group)
                o = torch.zeros(group, hd)
                c0 = s0 + (cb - s0) // 64 * 64
                while c0 < ce:
                    cols = torch.arange(c0, c0 + 64)
                    valid = (cols >= cb) & (cols < ce)
                    cv = cols.clamp(max=mb * bs - 1)
                    blk = tables[slot, cv // bs].long()
                    r = cv % bs
                    kt = kb[blk, r, kh].float() * valid[:, None]
                    vt = vb[blk, r, kh].float() * valid[:, None]
                    s = kt @ qg.T                       # (64, group) f32
                    ks = k_scale[blk, r] if k_scale is not None \
                        else torch.ones(64)
                    vs = v_scale[blk, r] if v_scale is not None \
                        else torch.ones(64)
                    x = torch.where(valid[:, None], s * (ks * sl2)[:, None],
                                    torch.tensor(-1e30))
                    mn = torch.maximum(m, x.max(0).values)
                    corr = torch.exp2(m - mn)
                    pe = torch.where(valid[:, None], torch.exp2(x - mn),
                                     torch.tensor(0.0))
                    l = l * corr + pe.sum(0)
                    pb = (pe * torch.where(valid, vs, torch.tensor(0.0))
                          [:, None]).to(torch.bfloat16).float()
                    o = o * corr[:, None] + pb.T @ vt
                    m = mn
                    c0 += 64
                parts.append((m, l, o))
            sn = (qg @ kn[slot, kh].float()) * sl2
            mx = sn.clone()
            for m, _, _ in parts:
                mx = torch.maximum(mx, m)
            num = torch.zeros(group, hd)
            den = torch.zeros(group)
            for m, l, o in parts:
                e = torch.exp2(m - mx)
                num = num + o * e[:, None]
                den = den + l * e
            pn = torch.exp2(sn - mx)
            num = num + pn[:, None] * vn[slot, kh].float()[None]
            den = den + pn
            out[slot, kh * group:(kh + 1) * group] = \
                (num / den.clamp(min=1e-30)[:, None]).to(torch.bfloat16)
    return out


def _served_case(seed, h, kvh, hd, mb, kv_dtype, pos, slots=4, bs=16):
    rng = np.random.default_rng(seed)
    nb = slots * mb + 1
    q = rng.standard_normal((slots, h, hd)).astype(np.float32)
    kbf = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
    vbf = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
    tables = rng.integers(0, nb, (slots, mb)).astype(np.int32)
    kn = rng.standard_normal((slots, kvh, hd)).astype(np.float32)
    vn = rng.standard_normal((slots, kvh, hd)).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)   # noqa: E731
    t = dict(q=bf(q), tables=torch.from_numpy(tables),
             pos=torch.tensor(pos, dtype=torch.int32), kn=bf(kn), vn=bf(vn))
    if kv_dtype == "int8":
        kq, ks = j_quant(jnp.asarray(kbf))
        vq, vs = j_quant(jnp.asarray(vbf))
        t.update(kb=torch.from_numpy(np.array(kq)),
                 vb=torch.from_numpy(np.array(vq)),
                 ks=torch.from_numpy(np.array(ks)),
                 vs=torch.from_numpy(np.array(vs)))
    else:
        t.update(kb=bf(kbf), vb=bf(vbf), ks=None, vs=None)
    return t


EMU_CASES = [
    # (heads, kv heads, hd, mb, pool, positions, window)
    (8, 8, 32, 32, "int8", [16, 130, 288, 1], 0),
    (8, 2, 32, 128, "bfloat16", [140, 130, 2048, 0], 20),
    (12, 12, 64, 8, "int8", [0, 128, 64, 65], 0),
    (48, 8, 128, 16, "int8", [200, 256, 1, 63], 0),
    (16, 8, 256, 8, "int8", [127, 128, 90, 33], 64),
    (32, 32, 96, 4, "bfloat16", [64, 17, 48, 5], 0),
    (56, 8, 128, 8, "int8", [100, 128, 77, 64], 0),
    (32, 2, 64, 2, "int8", [32, 31, 1, 0], 4),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=[
    f"H{c[0]}-kvh{c[1]}-hd{c[2]}-mb{c[3]}-{c[4]}-w{c[6]}" for c in EMU_CASES])
def test_route_arithmetic_matches_jax_oracle(case):
    """The route's rounding points keep it within the card's bf16
    tolerance of the f32 oracle (q, k_new and v_new bf16 on both sides;
    int8 codes and scales from the JAX quantizer); pos 0 gives v_new
    exactly."""
    h, kvh, hd, mb, pool, pos, window = case
    t = _served_case(sum(pos) + hd, h, kvh, hd, mb, pool, pos)
    plan = decode_plan(4, h, kvh, hd, 16, mb,
                       torch.int8 if pool == "int8" else torch.bfloat16,
                       torch.bfloat16)
    emu = emulate_wg(t["q"], t["kb"], t["vb"], t["tables"], t["pos"],
                     t["kn"], t["vn"], t["ks"], t["vs"], window, plan)
    f32 = lambda x: jnp.asarray(x.float().numpy())          # noqa: E731
    kw = {} if t["ks"] is None else dict(k_scale=jnp.asarray(t["ks"].numpy()),
                                         v_scale=jnp.asarray(t["vs"].numpy()))
    pools = ((jnp.asarray(t["kb"].numpy()), jnp.asarray(t["vb"].numpy()))
             if pool == "int8" else (f32(t["kb"]), f32(t["vb"])))
    ref = np.asarray(JAX_REF(f32(t["q"]), *pools,
                             jnp.asarray(t["tables"].numpy()),
                             jnp.asarray(t["pos"].numpy()), f32(t["kn"]),
                             f32(t["vn"]), **kw, window=window))
    np.testing.assert_allclose(emu.float().numpy(), ref, **BF16_TOL)
    for slot, p in enumerate(pos):
        if p == 0:
            assert torch.equal(emu[slot], t["vn"][slot].repeat_interleave(
                h // kvh, dim=0))
