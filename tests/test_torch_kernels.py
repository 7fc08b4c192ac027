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
* The CUDA kernel itself is held against this plain version on the
  card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import paged_decode_attention as pallas_paged
from repro.kernels import ref as jref
from repro.kernels.act_quant import kv_dequant_rows as j_dequant
from repro.kernels.act_quant import kv_quant_rows as j_quant
from repro_torch.kernels import ops
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
