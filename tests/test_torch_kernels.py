"""The port's kernel layer held against the JAX package's.

* ``kv_quant_rows`` / ``kv_dequant_rows``: codes and scales bit-equal.
* The paged decode kernel's plain version
  (``repro_torch.kernels.ref.paged_decode_attn_ref``) against the JAX
  oracle ``repro.kernels.ref.paged_decode_attn_ref`` and the Pallas
  kernel in interpret mode, on a fixed-seed sample of the grid kvh
  1/2/4 x group 1/2/3 x bs 4/8/16 x mb 1-4 x f32/bf16/int8 pools x
  ragged/zero/full-tail positions x window 0/1/5.  Both sides compute in
  f32 from identical inputs: atol 1e-5.  int8 pools stay inside the JAX
  suite's own error bound (0.05) of the f32 pool.
* The flash attention kernel's plain version (``flash_attn_ref``, through
  ``ops.attention``) against the JAX oracle and the Pallas kernel in
  interpret mode, over the masks of the JAX flash and window suites.
* The fused FFN's plain version (``fused_ffn_ref``, through
  ``ops.gated_ffn``) against the JAX oracle and the Pallas kernel.
* The activation-quantization kernels' plain versions (``act_quant_ref``,
  ``act_dequant_ref``, ``act_quant4_ref``, ``act_dequant4_ref``, through
  the wrappers and ``ops.quantize_activations``) against the JAX oracles
  run op by op: codes, packed bytes, scales and dequantized values
  bit-equal.  Against the Pallas kernels in interpret mode (and the
  jitted JAX ``ops``), bit-equality does not hold: XLA compiles the
  kernel body as one program and divides by the constant 127 (7) as a
  product with its reciprocal, so a scale can be one ulp away and a code
  on a tie one level away.  There the JAX suite's own floor holds
  (``test_kernels.py``): int8 codes within one level on fewer than 1e-3
  of the elements, int4 nibbles within one level, scales within 1e-6
  relative; dequantizing the same codes and scales is bit-equal.
* The CUDA kernels themselves are held against these plain versions on
  the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import importlib
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import flash_attention as pallas_flash
from repro.kernels import fused_ffn as pallas_ffn
from repro.kernels import paged_decode_attention as pallas_paged
from repro.kernels import ref as jref
from repro.kernels.act_quant import kv_dequant_rows as j_dequant
from repro.kernels.act_quant import kv_quant_rows as j_quant
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.act_quant import kv_dequant_rows, kv_quant_rows
from repro_torch.kernels.paged_decode_attn import paged_decode_attention

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
# the JAX oracle, jitted: one compile per shape instead of op-by-op calls
JAX_REF = jax.jit(jref.paged_decode_attn_ref, static_argnames=("window",))


@pytest.mark.parametrize("shape", [(3, 2, 16), (4, 5, 1, 8), (2, 8, 32)])
def test_kv_quant_rows_bit_equal(shape):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 5.0)).astype(np.float32)
    x[0] = 0.0                                 # an all-zero row
    q_j, s_j = j_quant(jnp.asarray(x))
    q_t, s_t = kv_quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    d_j = j_dequant(q_j, s_j, jnp.float32)
    d_t = kv_dequant_rows(q_t, s_t, torch.float32)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def _case(seed, slots, kvh, group, hd, bs, mb, kv_dtype, pos_spec,
          q_dtype=np.float32):
    """One paged-decode problem as numpy; int8 pools are quantized by the
    JAX package (the codes are bit-equal, see above)."""
    rng = np.random.default_rng(seed)
    nb = mb * slots + 2
    h = kvh * group
    arrs = dict(
        q=rng.standard_normal((slots, h, hd)).astype(q_dtype),
        kb=rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32),
        vb=rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32),
        tables=rng.integers(0, nb, (slots, mb)).astype(np.int32),
        kn=rng.standard_normal((slots, kvh, hd)).astype(q_dtype),
        vn=rng.standard_normal((slots, kvh, hd)).astype(q_dtype))
    if pos_spec == "ragged":
        arrs["pos"] = rng.integers(0, mb * bs + 1, (slots,)).astype(np.int32)
    elif pos_spec == "zero":
        arrs["pos"] = np.zeros((slots,), np.int32)
    else:                                      # every tail block just filled
        arrs["pos"] = np.full((slots,), mb * bs, np.int32)
    scales = {}
    if kv_dtype == "int8":
        kq, ks = j_quant(jnp.asarray(arrs["kb"]))
        vq, vs = j_quant(jnp.asarray(arrs["vb"]))
        arrs["kb"], arrs["vb"] = np.asarray(kq), np.asarray(vq)
        scales = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    return arrs, scales


def _run_both(arrs, scales, kv_dtype, window):
    order = ("q", "kb", "vb", "tables", "pos", "kn", "vn")
    jargs = [jnp.asarray(arrs[k]) for k in order]
    targs = [torch.from_numpy(np.array(arrs[k])) for k in order]
    if kv_dtype == "bfloat16":
        jargs[1], jargs[2] = (a.astype(jnp.bfloat16) for a in jargs[1:3])
        targs[1], targs[2] = (a.to(torch.bfloat16) for a in targs[1:3])
    jkw = {k: jnp.asarray(v) for k, v in scales.items()}
    tkw = {k: torch.from_numpy(v) for k, v in scales.items()}
    out_t = ops.paged_attention(*targs, **tkw, window=window)
    return jargs, jkw, out_t


# a fixed-seed sample of the grid; every value of every axis appears
_GRID_RNG = np.random.default_rng(2026)
GRID = [dict(kvh=int(_GRID_RNG.choice([1, 2, 4])),
             group=int(_GRID_RNG.choice([1, 2, 3])),
             bs=int(_GRID_RNG.choice([4, 8, 16])),
             mb=int(_GRID_RNG.integers(1, 5)),
             kv_dtype=str(_GRID_RNG.choice(["float32", "bfloat16", "int8"])),
             pos_spec=str(_GRID_RNG.choice(["ragged", "zero", "full_tail"])),
             window=int(_GRID_RNG.choice([0, 1, 5])))
        for _ in range(24)]


def test_grid_sample_covers_every_axis_value():
    axes = dict(kvh=[1, 2, 4], group=[1, 2, 3], bs=[4, 8, 16],
                mb=[1, 2, 3, 4], kv_dtype=["float32", "bfloat16", "int8"],
                pos_spec=["ragged", "zero", "full_tail"], window=[0, 1, 5])
    for axis, values in axes.items():
        assert sorted({c[axis] for c in GRID}, key=values.index) == values


@pytest.mark.parametrize("case", GRID, ids=[
    "kvh{kvh}-g{group}-bs{bs}-mb{mb}-{kv_dtype}-{pos_spec}-w{window}"
    .format(**c) for c in GRID])
def test_paged_plain_matches_jax(case):
    arrs, scales = _case(100 + GRID.index(case),
                         slots=3, kvh=case["kvh"], group=case["group"],
                         hd=16, bs=case["bs"], mb=case["mb"],
                         kv_dtype=case["kv_dtype"], pos_spec=case["pos_spec"])
    jargs, jkw, out_t = _run_both(arrs, scales, case["kv_dtype"],
                                  case["window"])
    out_ref = JAX_REF(*jargs, **jkw, window=case["window"])
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_ref),
                               **F32_TOL)
    if GRID.index(case) % 3 == 0:          # a third of it: Pallas too
        out_k = pallas_paged(*jargs, **jkw, window=case["window"],
                             interpret=True)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_k),
                                   **F32_TOL)


def test_paged_plain_bf16_activations():
    """bf16 q / new-token KV, as the serving path passes them: the port
    and the JAX oracle both compute in f32 and round once to bf16, so
    they may differ by one bf16 ulp (2**-8 relative)."""
    arrs, scales = _case(5, slots=4, kvh=2, group=4, hd=32, bs=16, mb=3,
                         kv_dtype="int8", pos_spec="ragged")
    order = ("q", "kb", "vb", "tables", "pos", "kn", "vn")
    bf16 = ("q", "kn", "vn")
    jargs = [jnp.asarray(arrs[k], jnp.bfloat16 if k in bf16 else None)
             for k in order]
    targs = [torch.from_numpy(arrs[k]).to(torch.bfloat16) if k in bf16
             else torch.from_numpy(arrs[k]) for k in order]
    tkw = {k: torch.from_numpy(v) for k, v in scales.items()}
    out_t = ops.paged_attention(*targs, **tkw)
    out_j = JAX_REF(*jargs, **{
        k: jnp.asarray(v) for k, v in scales.items()})
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=1e-2, rtol=2 ** -8)


def test_paged_plain_pos_zero_is_new_token_only():
    arrs, _ = _case(23, slots=2, kvh=2, group=2, hd=16, bs=4, mb=3,
                    kv_dtype="float32", pos_spec="zero")
    _, _, out = _run_both(arrs, {}, "float32", 0)
    np.testing.assert_allclose(out.numpy(),
                               np.repeat(arrs["vn"], 2, axis=1), atol=2e-6)


def test_paged_plain_v_new_lines_up_when_group_equals_kvh():
    """group == kvh: v_new must be taken per kv head, not per group index
    (the regression the JAX kernel fixed before it landed)."""
    arrs, _ = _case(31, slots=2, kvh=2, group=2, hd=8, bs=4, mb=2,
                    kv_dtype="float32", pos_spec="zero")
    arrs["vn"][:, 1] += 10.0
    _, _, out = _run_both(arrs, {}, "float32", 0)
    np.testing.assert_allclose(out.numpy()[:, 2:], arrs["vn"][:, 1:2]
                               .repeat(2, axis=1), atol=2e-6)


def test_paged_plain_int8_error_bound():
    """int8 KV stays within the JAX suite's error envelope of the f32
    pool (per-row scales: relative error ~1/254 per element)."""
    arrs, _ = _case(29, slots=4, kvh=2, group=4, hd=32, bs=8, mb=3,
                    kv_dtype="float32", pos_spec="ragged")
    arrs8, scales = _case(29, slots=4, kvh=2, group=4, hd=32, bs=8, mb=3,
                          kv_dtype="int8", pos_spec="ragged")
    _, _, o_f32 = _run_both(arrs, {}, "float32", 0)
    _, _, o_i8 = _run_both(arrs8, scales, "int8", 0)
    assert float((o_i8 - o_f32).abs().max()) < 0.05


def test_wrapper_on_cpu_never_launches():
    arrs, _ = _case(3, slots=2, kvh=1, group=2, hd=8, bs=4, mb=2,
                    kv_dtype="float32", pos_spec="ragged")
    before = paged_decode_attention.launches
    _run_both(arrs, {}, "float32", 0)
    assert paged_decode_attention.launches == before


# ------------------------------------------------------- flash attention --
def _qkv(seed, b, h, s, hd, kvh=None):
    rng = np.random.default_rng(seed)
    kvh = kvh or h
    return (rng.standard_normal((b, h, s, hd)).astype(np.float32),
            rng.standard_normal((b, kvh, s, hd)).astype(np.float32),
            rng.standard_normal((b, kvh, s, hd)).astype(np.float32))


# the masks of tests/test_kernels.py's flash and window suites
FLASH_CASES = [
    dict(s=256, hd=64, causal=True, window=0),
    dict(s=256, hd=64, causal=True, window=64),
    dict(s=128, hd=32, causal=True, window=0),
    dict(s=128, hd=32, causal=True, window=64),
    dict(s=64, hd=32, causal=False, window=0),
    dict(s=64, hd=32, causal=True, window=0, kv_len=0),
    dict(s=64, hd=32, causal=True, window=1, kv_len=24),
    dict(s=64, hd=32, causal=True, window=0, kv_len=32),
    dict(s=64, hd=32, causal=True, window=1),
    dict(s=64, hd=32, causal=True, window=1000),
    dict(s=64, hd=32, causal=False, window=8),
    dict(s=64, hd=256, causal=True, window=16, kv_len=40),   # gemma's hd
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[
    "-".join(f"{k}{v}" for k, v in c.items()) for c in FLASH_CASES])
def test_flash_plain_matches_jax(case):
    """The port's ``flash_attn_ref`` (through ``ops.attention``) against
    the JAX oracle and the Pallas kernel in interpret mode (blocks of 32,
    so the online softmax crosses blocks).  All compute in f32 from the
    same inputs and differ in the order of sums: atol 2e-5."""
    case = dict(case)
    s, hd = case.pop("s"), case.pop("hd")
    q, k, v = _qkv(s + hd, 2, 2, s, hd)
    out_t = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **case).numpy()
    out_j = np.asarray(jref.flash_attn_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), **case))
    np.testing.assert_allclose(out_t, out_j, atol=2e-5, rtol=1e-4)
    out_k = np.asarray(pallas_flash(
        jnp.asarray(q.reshape(4, s, hd)), jnp.asarray(k.reshape(4, s, hd)),
        jnp.asarray(v.reshape(4, s, hd)), block_q=32, block_k=32,
        interpret=True, **case)).reshape(2, 2, s, hd)
    np.testing.assert_allclose(out_t, out_k, atol=2e-5, rtol=1e-4)
    # rows left with no valid key are exactly zero in all three
    rows = np.arange(s)[:, None]
    cols = np.arange(s)[None, :]
    valid = np.broadcast_to(cols < case.get("kv_len", s), (s, s)).copy()
    if case["causal"]:
        valid &= cols <= rows
    if case["window"]:
        valid &= cols > rows - case["window"]
    dead = ~valid.any(axis=1)
    for out in (out_t, out_j, out_k):
        assert (out[:, :, dead] == 0).all()


def test_flash_grouped_kv_heads_equal_broadcast():
    """K < H (the model's GQA layout) reads kv head h // (H/K): equal to
    the JAX oracle on KV heads broadcast to the query heads."""
    q, k, v = _qkv(7, 2, 8, 48, 16, kvh=2)
    out_t = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=9).numpy()
    kb, vb = (np.repeat(a, 4, axis=1) for a in (k, v))
    out_j = jref.flash_attn_ref(jnp.asarray(q), jnp.asarray(kb),
                                jnp.asarray(vb), window=9)
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=2e-5)


# ---------------------------------------------------------- fused FFN ----
@pytest.mark.parametrize("m,d,f", [(128, 64, 256), (64, 96, 128),
                                   (100, 64, 128)])
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_fused_ffn_plain_matches_jax(m, d, f, activation):
    """f32: the port's plain version against the JAX oracle and the
    Pallas kernel in interpret mode; sums in another order only."""
    rng = np.random.default_rng(m + d + f)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    wg, wu = (rng.standard_normal((d, f)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.standard_normal((f, d)).astype(np.float32) * 0.1
    out_t = ops.gated_ffn(*(torch.from_numpy(a) for a in (x, wg, wu, wd)),
                          activation).numpy()
    out_j = jref.fused_ffn_ref(*(jnp.asarray(a) for a in (x, wg, wu, wd)),
                               activation)
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=2e-5,
                               rtol=1e-4)
    if m % 64 == 0:                     # Pallas takes whole tiles only
        out_k = pallas_ffn(*(jnp.asarray(a) for a in (x, wg, wu, wd)),
                           activation=activation, block_m=64, block_f=64,
                           interpret=True)
        np.testing.assert_allclose(out_t, np.asarray(out_k), atol=2e-5,
                                   rtol=1e-4)


def test_fused_ffn_plain_bf16():
    """bf16: the port and the JAX oracle both sum in f32 and round once,
    so they differ by at most one bf16 ulp (2**-8 relative).  The Pallas
    kernel rounds its output in bf16 after each F tile (two tiles here):
    two more roundings of partial sums up to the output's magnitude, so
    it is held at the JAX suite's own atol 3e-2."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((128, 64)) * 0.5).astype(np.float32)
    wg, wu = (rng.standard_normal((64, 256)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.standard_normal((256, 64)).astype(np.float32) * 0.1
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, wg, wu, wd)]
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, wg, wu, wd)]
    out_t = ops.gated_ffn(*targs).float().numpy()
    assert ops.gated_ffn(*targs).dtype == torch.bfloat16
    out_j = np.asarray(jref.fused_ffn_ref(*jargs, "silu"), np.float32)
    np.testing.assert_allclose(out_t, out_j, atol=1e-6, rtol=2 ** -8)
    out_k = np.asarray(pallas_ffn(*jargs, block_m=64, block_f=128,
                                  interpret=True), np.float32)
    np.testing.assert_allclose(out_t, out_k, atol=3e-2)


def test_cpu_calls_of_attention_and_gated_ffn_never_launch():
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.fused_ffn import fused_ffn
    before = (flash_attention.launches, fused_ffn.launches)
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 2, 16, 16))
    ops.attention(q, k, v)
    x = torch.ones(4, 16)
    ops.gated_ffn(x, torch.ones(16, 32), torch.ones(16, 32),
                  torch.ones(32, 16), "gelu")
    assert (flash_attention.launches, fused_ffn.launches) == before


# ----------------------------------------------- K2/K3 route dispatch ----
def test_flash_route_is_chosen_by_dtype():
    from repro_torch.kernels.flash_attn import attention_route
    assert attention_route(torch.bfloat16) == "tensor_cores"
    assert attention_route(torch.float32) == "cuda_cores"
    with pytest.raises(ValueError):
        attention_route(torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_checks_accept_head_dim_256_and_reject_48(dtype):
    """The wrapper's checks (run before any launch on the card) take hd
    16..256 on both routes and refuse hd 48; the bf16 route also refuses
    rows that are not 16-byte aligned."""
    from repro_torch.kernels import flash_attn

    def qkv(hd, s=8):
        return (torch.zeros(1, s, 4, hd, dtype=dtype).transpose(1, 2),
                torch.zeros(1, s, 2, hd, dtype=dtype).transpose(1, 2),
                torch.zeros(1, s, 2, hd, dtype=dtype).transpose(1, 2))

    for hd in (16, 32, 64, 128, 256):
        flash_attn._check(*qkv(hd), 0, None)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_attn._check(*qkv(48), 0, None)
    q, k, v = qkv(40)
    q, k, v = q[..., 1:33], k[..., 1:33], v[..., 1:33]   # 2 bytes in
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="16-byte"):
            flash_attn._check(q, k, v, 0, None)
    else:
        flash_attn._check(q, k, v, 0, None)


@pytest.mark.parametrize("m,d,f,route,grid", [
    (8, 256, 1024, "small_m", (64, 4, 1)),        # a decode step
    (1, 256, 1000, "small_m", (63, 4, 1)),        # ragged F
    (64, 256, 1024, "small_m", (64, 4, 1)),
    (65, 256, 1024, "tiles", (2, 1, 1)),
    (16384, 256, 1024, "tiles", (256, 1, 1)),     # the prefill burst
    (100, 1024, 4096, "tiles", (2, 4, 1)),        # D > 256: column tiles
    (64, 1024, 4096, "tiles", (1, 4, 1)),         # x too wide for small M
    (16, 1024, 4096, "small_m", (256, 16, 1)),
])
def test_ffn_plan_bf16(m, d, f, route, grid):
    """bf16: small M splits F into 16-column slices and D into 64-column
    chunks (at least 132 blocks at the served shapes), with an f32
    workspace of one (M, D) partial a slice, one counter a chunk and the
    shared memory the kernel lays out (it takes M up to 64 while that
    fits in 200 KiB); large M takes 64-row tiles, x resident in shared
    memory up to D 512."""
    from repro_torch.kernels.fused_ffn import SMALL_SMEM, ffn_plan
    plan = ffn_plan(torch.bfloat16, m, d, f)
    assert (plan.route, plan.grid) == (route, grid)
    if route == "small_m":
        assert plan.nsplit == grid[0] and plan.counters == grid[1]
        assert plan.ws_floats == grid[0] * m * d
        assert 0 < plan.smem <= SMALL_SMEM
        if (m, d, f) == (8, 256, 1024):
            assert grid[0] * grid[1] >= 132
            # bf16 x (M padded to 16, D to 16, +8), two D x 16 slices in
            # rows of 24, a 16 x 64 Wd block; f32 partials of 8 warps, H
            assert plan.smem == 2 * (16 * 264 + 2 * 256 * 24 + 16 * 64) \
                + 4 * (8 * 16 * 16 * 2 + 16 * 16)
    else:
        assert plan.ws_floats == plan.counters == plan.smem == 0
        assert plan.x_resident == (d <= 512)


def test_ffn_plan_f32_keeps_the_cuda_core_split():
    """f32 keeps the CUDA-core kernel and its F split (small M only)."""
    from repro_torch.kernels.fused_ffn import ffn_plan, split_plan
    for m, d, f in ((8, 256, 1024), (100, 256, 1024), (16384, 256, 1024),
                    (33, 96, 200)):
        plan = ffn_plan(torch.float32, m, d, f)
        nsplit, per = split_plan(m, d, f)
        assert plan.route == "cuda_cores"
        assert (plan.nsplit, plan.per) == (nsplit, per)
        assert plan.grid == (-(-m // 64), -(-d // 256), nsplit)
        assert plan.ws_floats == (nsplit * m * d if nsplit > 1 else 0)
    assert ffn_plan(torch.float32, 8, 256, 1024).nsplit == 16
    assert ffn_plan(torch.float32, 16384, 256, 1024).nsplit == 1
    with pytest.raises(ValueError):
        ffn_plan(torch.float16, 8, 256, 1024)


# ------------------------------------------- activation quantization ----
J_ACT = importlib.import_module("repro.kernels.act_quant")
T_ACT = importlib.import_module("repro_torch.kernels.act_quant")
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _act_input(m, n, dtype, seed):
    x = (np.random.default_rng(seed).standard_normal((m, n)) * 3).astype(
        np.float32)
    x[0, :128] = 0.0                            # an all-zero block
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(TDT[dtype])


def _f32(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


@pytest.mark.parametrize("m,n", [(128, 256), (256, 512), (64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quant_plain_matches_jax(m, n, dtype):
    xj, xt = _act_input(m, n, dtype, m + n)
    q, s = T_ACT.act_quant(xt)
    qr, sr = jref.act_quant_ref(xj)                  # op by op: IEEE division
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    # the Pallas kernel in interpret mode: the JAX suite's floor
    qp, sp = J_ACT.act_quant(xj, interpret=True, block_m=64, block_n=128)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(qp, np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(sp), rtol=1e-6)
    for od in ("float32", "bfloat16"):
        np.testing.assert_array_equal(
            _f32(T_ACT.act_dequant(q, s, TDT[od])),
            _f32(jref.act_dequant_ref(qr, sr, getattr(jnp, od))))
        # the same codes and scales dequantize to the same bits
        np.testing.assert_array_equal(
            _f32(T_ACT.act_dequant(torch.from_numpy(np.array(qp)),
                                   torch.from_numpy(np.array(sp)),
                                   TDT[od])),
            _f32(J_ACT.act_dequant(qp, sp, out_dtype=getattr(jnp, od),
                                   interpret=True, block_m=64,
                                   block_n=128)))
    # roundtrip error bounded by scale/2 per element
    err = (T_ACT.act_dequant(q, s, torch.float32) - xt.float()).abs()
    assert bool((err <= s.repeat_interleave(128, -1) * 0.51 + 1e-6).all())


@pytest.mark.parametrize("m,n", [(64, 256), (128, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quant4_plain_matches_jax(m, n, dtype):
    xj, xt = _act_input(m, n, dtype, m * n)
    packed, s = T_ACT.act_quant4(xt)
    assert packed.shape == (m, n // 2) and packed.dtype == torch.uint8
    pr, sr = jref.act_quant4_ref(xj)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(pr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    pp, sp = J_ACT.act_quant4(xj, interpret=True, block_m=64, block_n=128)
    for shift in (0, 4):                        # each nibble within a level
        d = np.abs(((packed.numpy() >> shift) & 0xF).astype(np.int32)
                   - ((np.asarray(pp) >> shift) & 0xF).astype(np.int32))
        assert d.max() <= 1 and (d != 0).mean() < 5e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(sp), rtol=1e-6)
    for od in ("float32", "bfloat16"):
        np.testing.assert_array_equal(
            _f32(T_ACT.act_dequant4(packed, s, TDT[od])),
            _f32(jref.act_dequant4_ref(pr, sr, getattr(jnp, od))))
        np.testing.assert_array_equal(
            _f32(T_ACT.act_dequant4(torch.from_numpy(np.array(pp)),
                                    torch.from_numpy(np.array(sp)),
                                    TDT[od])),
            _f32(J_ACT.act_dequant4(pp, sp, out_dtype=getattr(jnp, od),
                                    interpret=True, block_m=64,
                                    block_n=128)))


def test_act_quant4_roundtrip_is_exact_on_codes():
    """pack -> unpack -> repack is the identity on the packed bytes and
    the scales (twin of the JAX suite's test)."""
    x = torch.from_numpy((np.random.default_rng(11).standard_normal(
        (64, 256)) * 3).astype(np.float32))
    p1, s1 = tref.act_quant4_ref(x)
    d1 = tref.act_dequant4_ref(p1, s1, torch.float32)
    p2, s2 = tref.act_quant4_ref(d1)
    assert torch.equal(p1, p2)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-6)


def test_act_quant4_range_is_symmetric():
    """Biased nibbles live in [1, 15] (code -8 unused), so negating the
    input negates the codes exactly (twin of the JAX suite's test)."""
    x = torch.from_numpy((np.random.default_rng(12).standard_normal(
        (32, 256)) * 4).astype(np.float32))
    packed, _ = tref.act_quant4_ref(x)
    lo, hi = (packed & 0xF).int(), (packed >> 4).int()
    assert lo.min() >= 1 and hi.min() >= 1
    neg, _ = tref.act_quant4_ref(-x)
    assert torch.equal((neg & 0xF).int() - 8, -(lo - 8))
    assert torch.equal((neg >> 4).int() - 8, -(hi - 8))


@pytest.mark.parametrize("n", [1, 100, 129, 200, 50280])
def test_act_quant_ragged_rows_are_zero_padded(n):
    """A short last block is the zero-padded block: the codes are the
    padded row's, cut to n; int4 packs the padded row (bytes 0x88)."""
    x = torch.from_numpy((np.random.default_rng(n).standard_normal(
        (3, n)) * 2).astype(np.float32))
    pad = (-n) % 128
    xp = torch.nn.functional.pad(x, (0, pad))
    q, s = T_ACT.act_quant(x)
    qp, sp = T_ACT.act_quant(xp)
    assert torch.equal(q, qp[:, :n]) and torch.equal(s, sp)
    p4, s4 = T_ACT.act_quant4(x)
    pp4, sp4 = T_ACT.act_quant4(xp)
    assert torch.equal(p4, pp4) and torch.equal(s4, sp4)
    assert bool((p4[:, (n + 1) // 2:] == 0x88).all())
    assert torch.equal(T_ACT.act_dequant4(p4, s4, torch.float32, n=n),
                       T_ACT.act_dequant4(pp4, sp4, torch.float32)[:, :n])


def test_ops_quantize_activations_dispatch():
    """The JAX ``ops`` signature without ``use_pallas``/``interpret``;
    N % 128 == 0 is asserted, the default output is bf16.  The jitted JAX
    entry multiplies by the reciprocal: its codes stay within a level."""
    xj, xt = _act_input(64, 256, "float32", 0)
    q, s = ops.quantize_activations(xt)
    q1, s1 = jops.quantize_activations(xj, use_pallas=False)
    assert int(np.abs(q.numpy().astype(np.int32)
                      - np.asarray(q1, np.int32)).max()) <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(s1), rtol=1e-6)
    d = ops.dequantize_activations(q, s)
    assert d.dtype == torch.bfloat16 and d.shape == (64, 256)
    np.testing.assert_array_equal(
        _f32(d), _f32(jops.dequantize_activations(jnp.asarray(q.numpy()),
                                                  jnp.asarray(s.numpy()))))
    with pytest.raises(AssertionError):
        ops.quantize_activations(xt[:, :200])
    with pytest.raises(AssertionError):
        ops.dequantize_activations(q[:, :200], s[:, :2])


def test_act_quant_wrappers_on_cpu_never_launch():
    fns = (T_ACT.act_quant, T_ACT.act_dequant, T_ACT.act_quant4,
           T_ACT.act_dequant4)
    before = [f.launches for f in fns]
    x = torch.randn(4, 256)
    q, s = T_ACT.act_quant(x)
    T_ACT.act_dequant(q, s)
    p, s4 = T_ACT.act_quant4(x)
    T_ACT.act_dequant4(p, s4)
    assert [f.launches for f in fns] == before
    with pytest.raises(ValueError, match="no act_quant kernel"):
        T_ACT.act_quant(x.to("meta"))
