"""The port's SSM stack held against the JAX package's, on the JAX
suites' tiny ``mamba2-370m`` (``.reduced(d_model=64)``, vocab 300, chunk
16, 2 layers: 4 heads of head_dim 32, state 32, one group) with the JAX
weights brought across by the bridge, and the plain version of the SSD
scan kernel (K6) against the Pallas kernel in interpret mode.

Tolerances: in f32 both packages compute the same sums in another order
(the SSD's four-operand einsums, the conv taps), so the scan's outputs
of magnitude ~1-10 agree within atol 1e-5 and rtol 1e-5, and a block's
output, a sum over d_inner of such terms, within atol 1e-4; the JAX kernel
suite's own tolerance (atol 1e-4, rtol 1e-3) holds the plain K6 to the
Pallas kernel.  On the default bf16 variant the two frameworks round to
bf16 at different places; logits agree within 0.1, as for the dense
stack.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import layers as jl
from repro.models import model as jm
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import init_params as t_init_params
from repro_torch.models.transformer import mamba_block
from repro_torch.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

SMALL = dict(vocab_size=300, ssm_chunk=16)
J_CFG = j_get_config("mamba2-370m").reduced(d_model=64).with_updates(**SMALL)
T_CFG = get_config("mamba2-370m").reduced(d_model=64).with_updates(**SMALL)
J_PARAMS = jm.init_params(J_CFG, jax.random.PRNGKey(1))
NP_PARAMS = jax.tree_util.tree_map(np.asarray, J_PARAMS)
T_PARAMS = params_from_numpy(NP_PARAMS, "cpu")
F32 = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or F32))


def _ssd_inputs(seed, bsz, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bsz, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    b = (rng.standard_normal((bsz, s, g, n)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((bsz, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, a, b, c


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


# -------------------------------------------------------------- the scan --
def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((3, 7)).astype(np.float32)
    j = np.asarray(jssm.segsum(jnp.asarray(x)))
    t = tssm.segsum(torch.from_numpy(x)).numpy()
    assert (np.isneginf(j) == np.isneginf(t)).all()
    fin = np.isfinite(j)
    np.testing.assert_allclose(t[fin], j[fin], atol=1e-6)


# (B, S, H, P, G, N, chunk): whole chunks, a ragged S, one chunk longer
# than S, and grouped b/c
SSD_CASES = [(2, 32, 4, 8, 2, 4, 8), (2, 40, 4, 8, 2, 4, 16),
             (1, 12, 2, 16, 1, 8, 16), (1, 64, 4, 32, 4, 32, 16)]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_ref_matches_reference(case, with_state):
    bsz, s, h, p, g, n, chunk = case
    arrs = _ssd_inputs(s + h, bsz, s, h, p, g, n)
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = _both(arrs)
    init = (np.random.default_rng(1).standard_normal((bsz, h, p, n))
            .astype(np.float32) if with_state else None)
    jy, jst = jssm.ssd_scan_ref(
        jx, jdt, ja, jb, jc, chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init))
    ty, tst = tssm.ssd_scan_ref(
        tx, tdt, ta, tb, tc, chunk=chunk,
        initial_state=None if init is None else torch.from_numpy(init))
    assert ty.shape == (bsz, s, h, p) and tst.shape == (bsz, h, p, n)
    _close(ty, jy)
    _close(tst, jst)
    # the model-layout dispatch takes the plain version on the CPU
    before = ssd_scan.launches
    dy, dst = ops.ssd_scan(tx, tdt, ta, tb, tc, chunk=chunk,
                           initial_state=None if init is None
                           else torch.from_numpy(init))
    assert ssd_scan.launches == before
    assert torch.equal(dy, ty) and torch.equal(dst, tst)


def test_ssd_step_matches_reference():
    bsz, h, p, g, n = 2, 4, 8, 2, 4
    x, dt, a, b, c = _ssd_inputs(3, bsz, 1, h, p, g, n)
    state = np.random.default_rng(2).standard_normal((bsz, h, p, n)) \
        .astype(np.float32)
    arrs = (state, x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0])
    jy, jst = jssm.ssd_step(*_both(arrs)[0])
    ty, tst = tssm.ssd_step(*_both(arrs)[1])
    _close(ty, jy)
    _close(tst, jst)


def test_conv_and_gated_norm_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    _close(tl.causal_conv1d(*_both((x, w, bias))[1]),
           jl.causal_conv1d(*_both((x, w, bias))[0]))
    for j, t in zip(jl.causal_conv1d_step(*_both((x[:, 0], state, w,
                                                  bias))[0]),
                    tl.causal_conv1d_step(*_both((x[:, 0], state, w,
                                                  bias))[1])):
        _close(t, j)
    z = rng.standard_normal((2, 11, 6)).astype(np.float32)
    scale = rng.standard_normal(6).astype(np.float32) * 0.1
    _close(tl.gated_rms_norm(*_both((x, z, scale))[1]),
           jl.gated_rms_norm(*_both((x, z, scale))[0]))


def _layer(tree, j):
    return jax.tree_util.tree_map(lambda a: a[j], tree)


def test_mamba_forward_and_step_match_reference():
    """A full-sequence block over a ragged 21-token input, then three
    decode steps from its state, in f32."""
    jp = _layer(J_PARAMS["layers"], 0)["mamba"]
    tp = tl.layer_slice(T_PARAMS["layers"], 0)["mamba"]
    x = np.random.default_rng(5).standard_normal((2, 21, 64)).astype(
        np.float32)
    _close(tssm.mamba_forward(tp, torch.from_numpy(x), T_CFG),
           jssm.mamba_forward(jp, jnp.asarray(x), J_CFG), atol=1e-4,
           rtol=1e-5)
    jy, jst, jcv = jm._mamba_prefill_states(jp, jnp.asarray(x), J_CFG)
    ty, tst, tcv = tssm.mamba_forward_states(tp, torch.from_numpy(x), T_CFG)
    _close(ty, jy, atol=1e-4, rtol=1e-5)
    _close(tst, jst)
    _close(tcv, jcv)
    for t in range(3):
        xt = np.random.default_rng(10 + t).standard_normal((2, 64)).astype(
            np.float32)
        jy, jst, jcv = jssm.mamba_step(jp, jnp.asarray(xt), jst, jcv, J_CFG)
        ty, tst, tcv = tssm.mamba_step(tp, torch.from_numpy(xt), tst, tcv,
                                       T_CFG)
        _close(ty, jy, atol=1e-4, rtol=1e-5)
        _close(tst, jst)
        _close(tcv, jcv)
    _close(mamba_block(tl.layer_slice(T_PARAMS["layers"], 0),
                       torch.from_numpy(x), T_CFG),
           np.asarray(x) + np.asarray(jssm.mamba_forward(
               jp, jl.rms_norm(jnp.asarray(x),
                               _layer(J_PARAMS["layers"], 0)["ln"]),
               J_CFG)), atol=1e-4, rtol=1e-5)


# -------------------------------------------------- K6's plain version --
@pytest.mark.parametrize("s,p,n,chunk", [(64, 16, 8, 16), (128, 32, 16, 32),
                                         (96, 8, 4, 32)])
def test_plain_k6_matches_pallas_interpret(s, p, n, chunk):
    """The cases of the JAX kernel suite: the port's plain K6 in the
    kernel layout, and ``ops.ssd`` on the CPU, against the Pallas kernel
    in interpret mode and the JAX oracle."""
    bh = 3
    x, dt, a, b, c = _ssd_inputs(s + p, 1, s, bh, p, bh, n)
    arrs = (x[0].transpose(1, 0, 2).copy(), dt[0].T.copy(), a,
            b[0].transpose(1, 0, 2).copy(), c[0].transpose(1, 0, 2).copy())
    jarrs, tarrs = _both(arrs)
    py, pst = pallas_ssd_scan(*jarrs, chunk=chunk, interpret=True)
    jy, jst = jref.ssd_scan_kernel_ref(*jarrs, chunk)
    ty, tst = tref.ssd_scan_kernel_ref(*tarrs, chunk)
    before = ssd_scan.launches
    oy, ost = ops.ssd(*tarrs, chunk=chunk)
    assert ssd_scan.launches == before
    assert oy.dtype == torch.float32 and ost.dtype == torch.float32
    assert oy.shape == (bh, s, p) and ost.shape == (bh, p, n)
    for y, st in ((ty, tst), (oy, ost)):
        _close(y, py, atol=1e-4, rtol=1e-3)
        _close(st, pst, atol=1e-4, rtol=1e-3)
        _close(y, jy)
        _close(st, jst)


def test_plain_k6_is_chunk_invariant_and_takes_a_ragged_length():
    x, dt, a, b, c = _ssd_inputs(6, 2, 100, 4, 16, 2, 8)
    tarrs = _both((x, dt, a, b, c))[1]
    y16, st16 = ssd_scan(*tarrs, chunk=16)
    y64, st64 = ssd_scan(*tarrs, chunk=64)
    _close(y16, y64, atol=1e-4, rtol=1e-4)
    _close(st16, st64, atol=1e-4, rtol=1e-4)
    yb, _ = ssd_scan(tarrs[0].bfloat16(), *tarrs[1:3],
                     tarrs[3].bfloat16(), tarrs[4].bfloat16(), chunk=16)
    assert yb.dtype == torch.bfloat16


# ------------------------------------------------------------- weights --
def test_ssm_tree_through_the_bridge_keeps_f32_keys():
    """The SSM tree crosses the bridge with its layout and dtypes;
    ``cast_params`` keeps a_log, d_skip and dt_bias in f32 under bf16,
    and the port's own init has the JAX tree's paths, shapes and
    dtypes."""
    jflat = jax.tree_util.tree_flatten_with_path(NP_PARAMS)[0]
    for own in (params_to_numpy(T_PARAMS),
                params_to_numpy(t_init_params(T_CFG, seed=0, device="cpu"))):
        tflat = jax.tree_util.tree_flatten_with_path(own)[0]
        assert [k for k, _ in jflat] == [k for k, _ in tflat]
        for (_, a), (_, b) in zip(jflat, tflat):
            assert a.shape == b.shape and a.dtype == b.dtype
    cast = tl.cast_params(T_PARAMS, torch.bfloat16)["layers"]["mamba"]
    for key in ("a_log", "d_skip", "dt_bias"):
        assert cast[key].dtype == torch.float32
    for key in ("in_proj", "conv_w", "out_proj", "norm_scale"):
        assert cast[key].dtype == torch.bfloat16
    assert torch.equal(T_PARAMS["layers"]["mamba"]["a_log"],
                       torch.from_numpy(NP_PARAMS["layers"]["mamba"]
                                        ["a_log"].copy()))


# ------------------------------------------------------------- prefill --
@pytest.mark.parametrize("act,atol", [("float32", 1e-4), ("bfloat16", 0.1)])
def test_prefill_logits_and_caches_match_reference(act, atol):
    """Two left-padded prompts of bucket 48 (a ragged last chunk of 16)
    through the whole reduced model, then two decode steps."""
    jcfg, tcfg = (J_CFG.with_updates(activation_dtype=act),
                  T_CFG.with_updates(activation_dtype=act))
    toks = np.random.default_rng(8).integers(0, 300, (2, 48)).astype(
        np.int32)
    toks[1, :30] = 0
    jlog, jc = jm.prefill(J_PARAMS, jcfg, jnp.asarray(toks),
                          jm.init_cache(jcfg, 2, 48))
    tlog, tc = tm.prefill(T_PARAMS, tcfg, torch.from_numpy(toks),
                          tm.init_cache(tcfg, 2, 48, device="cpu"))
    _close(tlog, jlog, atol=atol, rtol=1e-4)
    assert set(tc) == set(jc) == {"pos", "ssm", "conv"}
    assert tc["ssm"].dtype == torch.float32
    assert tc["conv"].dtype == torch.bfloat16
    assert int(tc["pos"]) == int(jc["pos"]) == 48
    _close(tc["ssm"], jc["ssm"], atol=atol, rtol=1e-3)
    _close(tc["conv"], jc["conv"], atol=max(atol, 2e-2), rtol=1e-2)
    tok = jnp.asarray(toks[:, -1])
    for _ in range(2):
        jlog, jc = jm.decode_step(J_PARAMS, jcfg, jc, tok)
        tlog, tc = tm.decode_step(T_PARAMS, tcfg, tc,
                                  torch.from_numpy(np.array(tok)))
        _close(tlog, jlog, atol=atol, rtol=1e-4)
        tok = jnp.argmax(jlog[:, :300], axis=-1).astype(jnp.int32)
    _close(tc["ssm"], jc["ssm"], atol=atol, rtol=1e-3)
    assert int(tc["pos"]) == 50
