"""Twins of ``test_arch_smoke.py`` on every config of ``list_archs()``:
the reference's smoke checks run on the port, and the port's logits are
held against the JAX package's on the same weights (brought across by
the bridge) and the same inputs.

Configs: each config's ``reduced()`` (2 layers, d_model 256, the
reference test's), with the stub inputs ``test_arch_smoke.py`` gives the
encoder-decoder (frames) and the VLM (patch embeddings), drawn from a
numpy seed (std normal x 0.1).

Tolerances: the reference's own checks (shapes, finite values, decode
within rel 0.06 of the forward's last position) run at each config's
bf16 activations.  Against the JAX package the configs run with f32
activations and caches, where both compute the same sums in another
order: logits within 1e-4 of the reference's largest magnitude (those
of ``test_torch_hybrid.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.models import transformer as jt
from repro.models.runtime import RuntimeOptions as JOpts
from repro_torch.configs import get_config, list_archs
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

F32 = dict(activation_dtype="float32")
SMOKE = dict(moe_capacity_factor=2.0)
NO_DROP = dict(moe_capacity_factor=8.0)

_PARAMS = {}


def _params(arch):
    """The JAX weights of seed 0 for ``arch``'s reduced config and their
    bridge (the same weights serve the bf16 and the f32 runs: the
    parameter dtype is the config's in both)."""
    if arch not in _PARAMS:
        jp = jm.init_params(j_get_config(arch).reduced(),
                            jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return _PARAMS[arch]


def _inputs(cfg, seq, seed, batch=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["encoder_frames"] = (rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)) * 0.1).astype(
                np.float32)
    if cfg.vision_embed_dim:
        kw["vision_embeds"] = (rng.standard_normal(
            (batch, cfg.num_vision_tokens, cfg.vision_embed_dim))
            * 0.1).astype(np.float32)
    return toks, kw


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _close_rel(t, j, rel=1e-4):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.detach().float().numpy(), j,
                               atol=rel * float(np.abs(j).max()) + 1e-12,
                               rtol=0)


@pytest.mark.parametrize("arch", list_archs())
def test_forward_smoke(arch):
    """The reference's forward smoke on the port (bf16: logits of shape
    (2, 16, vocab), no NaN), then the f32 logits against the JAX
    package's."""
    jp, tp = _params(arch)
    cfg = get_config(arch).reduced()
    toks, kw = _inputs(cfg, 16, 0)
    logits, aux = tt.forward(tp, cfg, torch.from_numpy(toks),
                             RuntimeOptions(**SMOKE), **_t(kw))
    assert logits[..., :cfg.vocab_size].shape == (2, 16, cfg.vocab_size)
    assert not bool(torch.isnan(logits.float()).any())
    assert not bool(torch.isnan(aux).any())
    jcfg = j_get_config(arch).reduced().with_updates(**F32)
    lj, _ = jax.jit(lambda p, t, kw: jt.forward(p, jcfg, t, JOpts(**SMOKE),
                                                **kw))(
        jp, jnp.asarray(toks), _j(kw))
    lt, _ = tt.forward(tp, cfg.with_updates(**F32), torch.from_numpy(toks),
                       RuntimeOptions(**SMOKE), **_t(kw))
    _close_rel(lt, lj)


@pytest.mark.parametrize("arch", list_archs())
def test_decode_matches_forward(arch):
    """Decode with the cache agrees with the full forward at the last
    position in the port (bf16, rel < 0.06, the reference test's bound;
    capacity high enough that MoE drops nothing), and in f32 with f32
    caches the port's decode logits equal the JAX package's."""
    jp, tp = _params(arch)
    cfg = get_config(arch).reduced()
    opts = RuntimeOptions(**NO_DROP)
    toks, kw = _inputs(cfg, 12, 3)
    t_toks, t_kw = torch.from_numpy(toks), _t(kw)
    ref, _ = tt.forward(tp, cfg, t_toks, opts, **t_kw)
    cache = tm.init_cache(cfg, 2, 24, opts, device="cpu")
    _, cache = tm.prefill(tp, cfg, t_toks[:, :11], cache, opts, **t_kw)
    lg, cache = tm.decode_step(tp, cfg, cache, t_toks[:, 11], opts)
    assert lg.shape == (2, cfg.padded_vocab) and int(cache["pos"]) == 12
    ref = ref[:, -1].float()
    rel = float((ref - lg.float()).abs().max()) / (float(ref.abs().max())
                                                  + 1e-9)
    assert rel < 0.06, f"{arch}: decode diverges from forward (rel={rel})"
    jcfg = j_get_config(arch).reduced().with_updates(**F32)
    tcfg = cfg.with_updates(**F32)
    jo = JOpts(kv_cache_dtype="float32", **NO_DROP)
    to = RuntimeOptions(kv_cache_dtype="float32", **NO_DROP)

    def j_run(p, t, kw):
        _, c = jm.prefill(p, jcfg, t[:, :11], jm.init_cache(jcfg, 2, 24, jo),
                          jo, **kw)
        return jm.decode_step(p, jcfg, c, t[:, 11], jo)[0]

    lj = jax.jit(j_run)(jp, jnp.asarray(toks), _j(kw))
    cache = tm.init_cache(tcfg, 2, 24, to, device="cpu")
    _, cache = tm.prefill(tp, tcfg, t_toks[:, :11], cache, to, **t_kw)
    lt, _ = tm.decode_step(tp, tcfg, cache, t_toks[:, 11], to)
    _close_rel(lt, lj)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-26b"])
def test_train_step_smoke(arch):
    """The reference's train-step smoke on the two families this slice
    ports (bf16, with frames / patch embeddings): a finite loss within
    0.1 of the JAX package's, finite gradients on every leaf, nonzero in
    all, and nonzero on the encoder / the vision projection.  Leaf-by-
    leaf f32 gradients against JAX are in ``test_torch_encdec.py``."""
    jp, tp = _params(arch)
    cfg = get_config(arch).reduced()
    jcfg = j_get_config(arch).reduced()
    toks, kw = _inputs(cfg, 16, 1)
    labels = np.roll(toks, -1, axis=1)

    def j_loss(p, t, kw):
        logits, aux = jt.forward(p, jcfg, t, JOpts(**SMOKE), **kw)
        return jt.lm_loss(logits, jnp.roll(t, -1, axis=1)) \
            + jcfg.router_aux_weight * aux

    lj = float(jax.jit(j_loss)(jp, jnp.asarray(toks), _j(kw)))
    leaves = []

    def live(tree):
        if isinstance(tree, dict):
            return {k: live(v) for k, v in tree.items()}
        leaf = tree.clone().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    params = live(tp)
    logits, aux = tt.forward(params, cfg, torch.from_numpy(toks),
                             RuntimeOptions(**SMOKE), **_t(kw))
    loss = tt.lm_loss(logits, torch.from_numpy(labels)) \
        + cfg.router_aux_weight * aux
    loss.backward()
    assert bool(torch.isfinite(loss))
    np.testing.assert_allclose(float(loss.detach()), lj, atol=0.1)
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in leaves)
    assert sum(float(t.grad.abs().sum()) for t in leaves) > 0
    side = (params["encoder"]["attn"]["wq"] if cfg.is_encoder_decoder
            else params["vision_proj"]["w"])
    assert float(side.grad.abs().sum()) > 0
