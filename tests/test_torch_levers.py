"""Twins of ``test_perf_levers.py`` (fp8 KV decode, windowed decode, the
sequence-sharding option) and ``test_model_properties.py`` (rms scale
invariance, rotary, causality, padded-vocab masking, ``lm_loss`` bounds)
for the port, each held against the JAX package on the same inputs and
the same weights (brought across by the bridge).  The MoE twins of both
files (dense dispatch, capacity drops) are in ``test_torch_moe.py``.

Tolerances: bf16 activations (the reference tests' default) put the two
frameworks' logits within atol 0.1, as in the model twins (they round to
bf16 at different places); f32 quantities agree within 1e-5 (norms,
rotary, losses).  The property bounds are the reference tests' own.  The
hypothesis tests keep the reference tests' example counts.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytest.importorskip("hypothesis")
import hypothesis.strategies as st
from hypothesis import given, settings

from repro.configs import get_config as j_get_config
from repro.models import layers as jl
from repro.models import model as jm
from repro.models import transformer as jt
from repro.models.runtime import RuntimeOptions as JOpts
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

BF16_ATOL = 0.1
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=300)
J_CFG = j_get_config("paper-backbone").with_updates(**TINY)
T_CFG = get_config("paper-backbone").with_updates(**TINY)
J_PARAMS = jm.init_params(J_CFG, jax.random.PRNGKey(0))
T_PARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, J_PARAMS),
                             "cpu")
J_FORWARD = jax.jit(jt.forward, static_argnums=(1, 3))


def _bridge(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _np(t):
    return t.detach().float().numpy()


def _rel(a, b):
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


# ------------------------------------------------------------ fp8 KV ----
@pytest.mark.parametrize("arch", ["yi-34b", "gemma3-12b", "zamba2-1.2b"])
def test_fp8_kv_cache_decode_close(arch):
    """fp8 KV decode within 0.15 (relative) of bf16 in the port, as in
    the reference, and each cache dtype's decode logits equal the JAX
    package's within the bf16 tolerance."""
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = _bridge(jp)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                       jcfg.vocab_size), np.int32)
    outs = {}
    for name in ("bfloat16", "fp8"):
        jo = JOpts(kv_cache_dtype=name)

        def j_run(p, t):
            _, cache = jm.prefill(p, jcfg, t[:, :11],
                                  jm.init_cache(jcfg, 2, 24, jo), jo)
            return jm.decode_step(p, jcfg, cache, t[:, 11], jo)[0]

        lj = np.asarray(jax.jit(j_run)(jp, jnp.asarray(toks)), np.float32)
        to = RuntimeOptions(kv_cache_dtype=name)
        cache = tm.init_cache(tcfg, 2, 24, to, device="cpu")
        if name == "fp8":
            # the hybrid's shared K/V and conv tail take the cache dtype
            for leaf in ("k", "shared_k", "conv"):
                if leaf in cache:
                    assert cache[leaf].dtype == torch.float8_e4m3fn, leaf
        _, cache = tm.prefill(tp, tcfg, torch.from_numpy(toks[:, :11]),
                              cache, to)
        lt, _ = tm.decode_step(tp, tcfg, cache,
                               torch.from_numpy(toks[:, 11]), to)
        np.testing.assert_allclose(_np(lt), lj, atol=BF16_ATOL)
        outs[name] = _np(lt)
    rel = _rel(outs["fp8"], outs["bfloat16"])
    assert rel < 0.15, f"{arch}: fp8 KV decode drifted {rel}"


# ------------------------------------------------------ windowed decode --
def test_windowed_decode_matches_windowed_forward():
    """``decode_window`` on the plain config == a model whose layers are
    all local with that window (rel < 0.06, as in the reference); the
    decode logits equal the JAX package's within the bf16 tolerance."""
    kw = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
              head_dim=16, d_ff=128, vocab_size=256)
    jcfg = j_get_config("paper-backbone").with_updates(**kw)
    tcfg = get_config("paper-backbone").with_updates(**kw)
    win = dict(local_global_ratio=100, sliding_window=8)
    jw, tw = jcfg.with_updates(**win), tcfg.with_updates(**win)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = _bridge(jp)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 24), 0,
                                       256), np.int32)
    ref, _ = tt.forward(tp, tw, torch.from_numpy(toks),
                        RuntimeOptions(attn_impl="full"))
    pre = dict(attn_impl="full", kv_cache_dtype="float32")
    dec = dict(decode_window=8, kv_cache_dtype="float32")

    def j_run(p, t):
        _, cache = jm.prefill(p, jw, t[:, :23],
                              jm.init_cache(jcfg, 1, 48, JOpts(**dec)),
                              JOpts(**pre))
        return jm.decode_step(p, jcfg, cache, t[:, 23], JOpts(**dec))[0]

    lj = np.asarray(jax.jit(j_run)(jp, jnp.asarray(toks)), np.float32)
    cache = tm.init_cache(tcfg, 1, 48, RuntimeOptions(**dec), device="cpu")
    _, cache = tm.prefill(tp, tw, torch.from_numpy(toks[:, :23]), cache,
                          RuntimeOptions(**pre))
    lt, _ = tm.decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, 23]),
                           RuntimeOptions(**dec))
    np.testing.assert_allclose(_np(lt), lj, atol=BF16_ATOL)
    assert _rel(_np(lt), _np(ref[:, -1])) < 0.06
    # the window matters: the full-cache decode differs
    cache = tm.init_cache(tcfg, 1, 48, RuntimeOptions(**pre), device="cpu")
    _, cache = tm.prefill(tp, tcfg, torch.from_numpy(toks[:, :23]), cache,
                          RuntimeOptions(**pre))
    full, _ = tm.decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, 23]),
                             RuntimeOptions(**pre))
    assert not torch.allclose(full, lt)


# ------------------------------------------------------ seq sharding ----
def test_seq_shard_noop_on_one_device():
    """Twin of ``test_seq_shard_noop_without_mesh_axis`` (R3: the JAX test
    raises on JAX 0.9, and stays as it is): the port runs on one device,
    so ``seq_shard_axis`` changes nothing, bit for bit; both equal the JAX
    package's forward without the option (bf16 tolerance)."""
    jcfg = j_get_config("paper-backbone").with_updates(num_layers=2)
    tcfg = get_config("paper-backbone").with_updates(num_layers=2)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = _bridge(jp)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                       jcfg.vocab_size), np.int32)
    lj, _ = J_FORWARD(jp, jcfg, jnp.asarray(toks), JOpts())
    lg1, _ = tt.forward(tp, tcfg, torch.from_numpy(toks), RuntimeOptions())
    lg2, _ = tt.forward(tp, tcfg, torch.from_numpy(toks),
                        RuntimeOptions(seq_shard_axis="model"))
    assert torch.equal(lg1, lg2)
    np.testing.assert_allclose(_np(lg1), np.asarray(lj, np.float32),
                               atol=BF16_ATOL)


# ------------------------------------------------- model properties ----
@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1), st.floats(0.5, 8.0))
def test_rms_norm_scale_invariance(seed, scale):
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed), (4, 32)))
    g = np.zeros((32,), np.float32)
    out = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(
        _np(tl.rms_norm(torch.from_numpy(x * np.float32(scale)),
                        torch.from_numpy(g))), _np(out), atol=1e-5)
    np.testing.assert_allclose(
        _np(out), np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(g))),
        atol=1e-5)


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, 500))
def test_rotary_preserves_norm_and_relative_phase(seed, offset):
    hd = 32
    q = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                   (1, 4, 2, hd)))
    k = np.array(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                   (1, 4, 2, hd)))
    pos = np.arange(4)[None, :] + offset

    def rot(a, p):
        sin, cos = tl.rotary_embedding(torch.from_numpy(p), hd)
        return _np(tl.apply_rotary(torch.from_numpy(a), sin, cos))

    qr, kr = rot(q, pos), rot(k, pos)
    sj, cj = jl.rotary_embedding(jnp.asarray(pos), hd)
    np.testing.assert_allclose(
        qr, np.asarray(jl.apply_rotary(jnp.asarray(q), sj, cj)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(qr, axis=-1),
                               np.linalg.norm(q, axis=-1), rtol=1e-5)
    dot1 = np.einsum("bshd,bthd->bst", qr, kr)
    dot2 = np.einsum("bshd,bthd->bst", rot(q, pos + 37), rot(k, pos + 37))
    np.testing.assert_allclose(dot1, dot2, atol=1e-3)


def test_model_causality():
    """Changing token t leaves the logits before t as they were."""
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 16),
                                         0, 300), np.int32)
    tokens2 = tokens.copy()
    tokens2[0, 10] = (tokens[0, 10] + 7) % 300
    full = RuntimeOptions(attn_impl="full")
    lg1, _ = tt.forward(T_PARAMS, T_CFG, torch.from_numpy(tokens), full)
    lg2, _ = tt.forward(T_PARAMS, T_CFG, torch.from_numpy(tokens2), full)
    np.testing.assert_allclose(_np(lg1[:, :10]), _np(lg2[:, :10]),
                               atol=1e-3)
    assert not np.allclose(_np(lg1[:, 10:]), _np(lg2[:, 10:]))
    lj, _ = J_FORWARD(J_PARAMS, J_CFG, jnp.asarray(tokens2),
                      JOpts(attn_impl="full"))
    np.testing.assert_allclose(_np(lg2), np.asarray(lj, np.float32),
                               atol=BF16_ATOL)


def test_padded_vocab_masked_everywhere():
    """Vocab 300 pads to 512; a padded logit never wins an argmax."""
    assert T_CFG.padded_vocab == 512
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(2), (2, 8),
                                         0, 300), np.int32)
    logits, _ = tt.forward(T_PARAMS, T_CFG, torch.from_numpy(tokens))
    assert logits.shape[-1] == 512
    assert bool((logits.argmax(-1) < 300).all())
    lj, _ = J_FORWARD(J_PARAMS, J_CFG, jnp.asarray(tokens), JOpts())
    lj = np.asarray(lj, np.float32)
    np.testing.assert_array_equal(_np(logits)[..., 300:], lj[..., 300:])
    np.testing.assert_allclose(_np(logits)[..., :300], lj[..., :300],
                               atol=BF16_ATOL)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_lm_loss_bounds(seed):
    """Cross entropy of uniform logits == log(V); mask semantics hold."""
    v = 64
    logits = torch.zeros((2, 8, v))
    labels = np.array(jax.random.randint(jax.random.PRNGKey(seed), (2, 8),
                                         0, v), np.int32)
    loss = float(tt.lm_loss(logits, torch.from_numpy(labels)))
    np.testing.assert_allclose(loss, np.log(v), rtol=1e-5)
    mask = torch.zeros((2, 8))
    mask[:, 0] = 1.0
    masked = float(tt.lm_loss(logits, torch.from_numpy(labels), mask))
    assert masked == pytest.approx(np.log(v), rel=1e-5)
    assert masked == pytest.approx(float(jt.lm_loss(
        jnp.zeros((2, 8, v)), jnp.asarray(labels), jnp.asarray(mask))),
        rel=1e-6)
