"""The port's full-sequence model core (``forward``, ``apply_stack``,
``lm_loss``), its optimizer (``repro_torch.optim``) and the analytic
backward functions of the flash attention (K2) and fused FFN (K3)
wrappers, on the CPU.

* ``forward`` / ``apply_stack`` / ``lm_loss`` against the JAX package on
  the tiny ``paper-backbone`` of the model twins (2 layers, d_model 64, 4
  heads, 2 KV heads, head_dim 16, d_ff 128, vocab 300) and the reduced
  ``mamba2-370m`` (``.reduced(d_model=64)``, vocab 300, chunk 16), JAX
  weights brought across by the bridge.  Tolerances as in the model
  twins: f32 activations atol 1e-4 on logits of magnitude ~1 (the same
  sums in another order); bf16 activations atol 0.1 (the frameworks
  round to bf16 at different places); ``lm_loss`` 1e-5 relative.
* AdamW (3 steps) and the schedules against ``repro.optim``: f32 update
  arithmetic in both, so parameters agree within 1e-6.
* ``flash_attention_backward`` and ``fused_ffn_backward`` against
  ``torch.autograd.grad`` of the plain versions (``kernels/ref.py``) in
  f64, where both are exact up to f64 rounding: atol 1e-10.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.models import transformer as jt
from repro.models.runtime import DEFAULT_OPTIONS as J_OPTS
from repro.optim import adamw as j_adamw
from repro.optim import schedule as j_schedule
from repro_torch import optim as t_optim
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import flash_attention_backward
from repro_torch.kernels.fused_ffn import fused_ffn_backward
from repro_torch.kernels.ref import flash_attn_ref, fused_ffn_ref
from repro_torch.models import apply_stack, forward, lm_loss
from repro_torch.models import layers as tl
from repro_torch.models.model import forward as model_forward
from repro_torch.models.runtime import DEFAULT_OPTIONS
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=300)
SSM = dict(vocab_size=300, ssm_chunk=16)
F32 = dict(activation_dtype="float32")
# the reference jitted: one compile is cheaper than eager op-by-op dispatch
J_FORWARD = jax.jit(jt.forward, static_argnums=(1,),
                    static_argnames=("num_layers",))
J_APPLY_STACK = jax.jit(jt.apply_stack, static_argnums=(2, 3),
                        static_argnames=("num_layers",))


def _pair(name, **kw):
    if name == "dense":
        jcfg = j_get_config("paper-backbone").with_updates(**TINY, **kw)
        tcfg = get_config("paper-backbone").with_updates(**TINY, **kw)
    else:
        jcfg = j_get_config("mamba2-370m").reduced(d_model=64).with_updates(
            **SSM, **kw)
        tcfg = get_config("mamba2-370m").reduced(d_model=64).with_updates(
            **SSM, **kw)
    return jcfg, tcfg


_PARAMS = {}


def _params(name):
    if name not in _PARAMS:
        jcfg, _ = _pair(name)
        jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
        _PARAMS[name] = (jp, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return _PARAMS[name]


def _tokens(seed=1, shape=(2, 24)):
    return np.random.default_rng(seed).integers(0, 300, shape).astype(
        np.int32)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("name", ["dense", "ssm"])
@pytest.mark.parametrize("variant,atol", [(F32, 1e-4), ({}, 0.1)],
                         ids=["f32", "bf16"])
def test_forward_matches_reference(name, variant, atol):
    jcfg, tcfg = _pair(name, **variant)
    jp, tp = _params(name)
    toks = _tokens()
    j_logits, j_aux = J_FORWARD(jp, jcfg, jnp.asarray(toks))
    t_logits, t_aux = forward(tp, tcfg, torch.from_numpy(toks))
    assert t_logits.dtype == tl.dtype_of(tcfg.activation_dtype)
    np.testing.assert_allclose(_np(t_logits),
                               np.asarray(j_logits, np.float32), atol=atol)
    assert float(t_aux) == float(j_aux) == 0.0
    # the model module re-exports the same entry point, as in JAX
    assert model_forward is forward


@pytest.mark.parametrize("name", ["dense", "ssm"])
def test_apply_stack_num_layers_matches_reference(name):
    """η5's depth cut: only the first layer of the stack runs."""
    jcfg, tcfg = _pair(name, **F32)
    jp, tp = _params(name)
    x = np.random.default_rng(2).standard_normal((2, 16, 64)).astype(
        np.float32)
    jx, _ = J_APPLY_STACK(jp["layers"], jnp.asarray(x), jcfg, J_OPTS,
                          num_layers=1)
    tx, _ = apply_stack(tp["layers"], torch.from_numpy(x), tcfg,
                        DEFAULT_OPTIONS, num_layers=1)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=1e-4)
    full, _ = apply_stack(tp["layers"], torch.from_numpy(x), tcfg,
                          DEFAULT_OPTIONS)
    assert not torch.allclose(full, tx)


def test_forward_with_logit_bias_and_depth_matches_reference():
    jcfg, tcfg = _pair("dense", **F32)
    jp, tp = _params("dense")
    bias = np.random.default_rng(4).standard_normal(
        jcfg.padded_vocab).astype(np.float32)
    toks = _tokens(5)
    j_logits, _ = J_FORWARD({**jp, "logit_bias": jnp.asarray(bias)}, jcfg,
                            jnp.asarray(toks), num_layers=1)
    t_logits, _ = forward({**tp, "logit_bias": torch.from_numpy(bias)}, tcfg,
                          torch.from_numpy(toks), num_layers=1)
    np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits), atol=1e-4)
    # vocab padding (300 -> padded) is masked as in the reference
    assert tcfg.padded_vocab > tcfg.vocab_size
    assert bool((t_logits[..., tcfg.vocab_size:] == -1e30).all())


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 10, 37)).astype(np.float32) * 3
    labels = rng.integers(0, 37, (2, 10)).astype(np.int32)
    mask = (rng.random((2, 10)) > 0.3).astype(np.float32) if masked else None
    j = jt.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                   None if mask is None else jnp.asarray(mask))
    t = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def test_unported_families_raise():
    """The families that once raised in ``forward`` run it now: the VLM
    stub with projected patch embeddings in its first positions, the
    encoder-decoder with and without encoder frames; the logits are
    finite and the stub inputs move them."""
    from repro_torch.models import init_params as t_init_params
    for name in ("internvl2-26b", "whisper-small"):
        cfg = get_config(name).reduced(d_model=64)
        params = t_init_params(cfg, seed=0, device="cpu")
        tokens = torch.zeros((1, 6), dtype=torch.int32)
        plain, _ = forward(params, cfg, tokens)
        g = torch.Generator().manual_seed(0)
        if cfg.vision_embed_dim:
            kw = dict(vision_embeds=0.1 * torch.randn(
                1, cfg.num_vision_tokens, cfg.vision_embed_dim, generator=g))
        else:
            kw = dict(encoder_frames=0.1 * torch.randn(
                1, cfg.encoder_seq_len, cfg.d_model, generator=g))
        stub, _ = forward(params, cfg, tokens, **kw)
        for logits in (plain, stub):
            assert logits.shape == (1, 6, cfg.padded_vocab)
            assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
        assert not torch.equal(plain, stub)


# ------------------------------------------------------------ optim ----
def test_adamw_three_steps_match_reference():
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 8)).astype(np.float32),
              "b": {"c": rng.standard_normal(8).astype(np.float32),
                    "i": np.arange(3, dtype=np.int32)}}
    grads = [{"a": rng.standard_normal((4, 8)).astype(np.float32) * s,
              "b": {"c": rng.standard_normal(8).astype(np.float32) * s,
                    "i": np.zeros(3, np.int32)}} for s in (0.1, 3.0, 0.5)]
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = j_adamw.init(jp)
    tp = params_from_numpy(params, "cpu")
    ts = t_optim.init(tp)
    for i, g in enumerate(grads):
        scale = float(j_schedule.warmup_cosine(i, warmup_steps=1,
                                               total_steps=3))
        jp, js = j_adamw.apply(jax.tree_util.tree_map(jnp.asarray, g), jp,
                               js, j_adamw.AdamWConfig(**cfg), scale)
        tp, ts = t_optim.apply(params_from_numpy(g, "cpu"), tp, ts,
                               t_optim.AdamWConfig(**cfg), scale)
    assert int(ts.step) == int(js.step) == 3
    for t, j in ((tp["a"], jp["a"]), (tp["b"]["c"], jp["b"]["c"]),
                 (ts.m["a"], js.m["a"]), (ts.v["b"]["c"], js.v["b"]["c"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    np.testing.assert_array_equal(tp["b"]["i"].numpy(),
                                  np.asarray(jp["b"]["i"]))
    np.testing.assert_allclose(
        float(t_optim.global_norm(params_from_numpy(grads[1], "cpu"))),
        float(j_adamw.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                         grads[1]))),
        rtol=1e-6)


def test_schedules_match_reference():
    steps = [0, 1, 50, 100, 101, 5000, 10000, 20000]
    kw = dict(warmup_steps=100, total_steps=10000, min_ratio=0.1)
    np.testing.assert_allclose(
        [float(t_optim.warmup_cosine(s, **kw)) for s in steps],
        [float(j_schedule.warmup_cosine(s, **kw)) for s in steps],
        rtol=1e-6)
    assert float(t_optim.constant(7, value=0.5)) == \
        float(j_schedule.constant(7, value=0.5)) == 0.5


# ------------------------------------------------- K2/K3 backwards ----
@pytest.mark.parametrize("h,kvh,causal,window,kv_len", [
    (4, 4, True, 0, None), (4, 2, True, 0, None), (4, 1, True, 3, None),
    (4, 2, False, 0, 6), (4, 4, True, 0, 0), (2, 2, False, 2, 5),
], ids=["causal", "gqa", "window", "kv_len", "no_key", "all_masks"])
def test_flash_attention_backward_matches_autograd(h, kvh, causal, window,
                                                   kv_len):
    """The K2 wrapper's backward on the model's strided (B,H,S,hd) views
    (transposes of (B,S,H,hd)), dK/dV summed over each GQA group."""
    gen = torch.Generator().manual_seed(h * 10 + kvh)
    b, s, hd = 2, 11, 8
    mk = lambda n: torch.randn(b, s, n, hd, generator=gen,
                               dtype=torch.float64).transpose(1, 2)
    q, k, v = mk(h).requires_grad_(), mk(kvh).requires_grad_(), \
        mk(kvh).requires_grad_()
    g = h // kvh
    masks = dict(causal=causal, window=window, kv_len=kv_len)
    out = flash_attn_ref(q, k.repeat_interleave(g, 1),
                         v.repeat_interleave(g, 1), **masks)
    dout = torch.randn(out.shape, generator=gen, dtype=torch.float64)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = flash_attention_backward(q.detach(), k.detach(), v.detach(),
                                   out.detach(), dout, **masks)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        torch.testing.assert_close(a, w, atol=1e-10, rtol=0)
    if kv_len == 0:
        assert all(bool((a == 0).all()) for a in got)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_fused_ffn_backward_matches_autograd(activation):
    gen = torch.Generator().manual_seed(3)
    m, d, f = 13, 24, 40
    x = torch.randn(m, d, generator=gen, dtype=torch.float64)
    ws = [torch.randn(*shape, generator=gen, dtype=torch.float64) / 4
          for shape in ((d, f), (d, f), (f, d))]
    leaves = [t.requires_grad_() for t in (x, *ws)]
    y = fused_ffn_ref(*leaves, activation)
    dy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    want = torch.autograd.grad(y, leaves, dy)
    got = fused_ffn_backward(*(t.detach() for t in leaves), dy, activation)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-10, rtol=0)
