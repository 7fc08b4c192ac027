"""The port's elastic package (``repro_torch.elastic``) held against the
JAX package's ``repro.elastic``: twins of the 11 tests of
``tests/test_elastic.py``, every variant of the supernet's action space
against JAX ``derive_variant`` + ``forward``, and η6's kept channels and
heads equal to the JAX package's.

Model: the model twins' tiny ``paper-backbone`` (d_model 64, 4 heads, 2
KV heads, head_dim 16, d_ff 128, vocab 300) at 4 layers, so that the η5
ratios 0.75 and 0.5 and η3's 0.8 cut distinct depths; JAX weights
brought across by the bridge.

Tolerances: with f32 activations both packages compute the same sums in
another order, so logits of magnitude ~1 agree within atol 1e-4 (the
model twins' f32 tolerance).  η1's SVD is computed by two LAPACK
builds: the singular vectors may differ in sign, so the factors are
compared as the product ``u @ v``; a truncated SVD's kept subspace moves
by ~eps·‖W‖/gap (the gap between the last kept and first dropped
singular values), so the products agree within atol 1e-4 on entries
~0.1.
Selections (η5, η6, η4's kept half) copy weights, so they must be
equal.  TTA's objective and updated norm scales agree within 1e-5 (two
f32 gradients of the same loss).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.elastic as J
from repro.configs import get_config as j_get_config
from repro.elastic import operators as j_ops
from repro.models import model as jm
from repro.models import transformer as jt
import repro_torch.elastic as T
from repro_torch.configs import get_config
from repro_torch.elastic import operators as t_ops
from repro_torch.models import forward
from repro_torch.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=300)
F32 = dict(activation_dtype="float32")
J_CFG = j_get_config("paper-backbone").with_updates(**SMALL)
CFG = get_config("paper-backbone").with_updates(**SMALL)
J_PARAMS = jm.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, J_PARAMS),
                           "cpu")
TOKENS_NP = np.random.default_rng(1).integers(0, 300, (2, 32)).astype(
    np.int32)
TOKENS = torch.from_numpy(TOKENS_NP)
J_FORWARD = jax.jit(jt.forward, static_argnums=(1,),
                    static_argnames=("num_layers",))


def _np(t):
    return t.detach().float().numpy()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _assert_same_tree(t_tree, j_tree, exact=True):
    t_items = dict(_leaves(params_to_numpy(t_tree)))
    j_items = dict(_leaves(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a),
        j_tree)))
    assert sorted(t_items) == sorted(j_items)
    for path, t in t_items.items():
        j = j_items[path]
        assert t.shape == j.shape, path
        if exact:
            np.testing.assert_array_equal(t, j, err_msg=str(path))
        else:
            np.testing.assert_allclose(t, j, atol=1e-5, err_msg=str(path))


# ------------------------------------------------- twins of test_elastic --
@pytest.mark.parametrize("name", sorted(T.NAMED_COMBOS))
def test_variant_runs_and_shrinks(name):
    spec = T.NAMED_COMBOS[name]
    assert dataclasses.asdict(spec) == dataclasses.asdict(J.NAMED_COMBOS[name])
    vcfg, vparams = T.derive_variant(CFG, PARAMS, spec)
    logits, _ = forward(vparams, vcfg, TOKENS)
    assert logits.shape == (2, 32, CFG.padded_vocab)
    assert not bool(torch.isnan(logits.float()).any())
    cost = T.variant_cost(CFG, spec)
    full = T.variant_cost(CFG, T.FULL_SPEC)
    assert cost["flops_per_token"] < full["flops_per_token"]
    j_spec = J.VariantSpec(**dataclasses.asdict(spec))
    assert cost == J.variant_cost(J_CFG, j_spec)
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(
        J.derive_variant(J_CFG, J_PARAMS, j_spec)[0])


def test_variant_output_close_to_backbone():
    """Weight recycling: a mild variant must stay close to the backbone."""
    base, _ = forward(PARAMS, CFG, TOKENS)
    vcfg, vparams = T.derive_variant(CFG, PARAMS,
                                     T.VariantSpec(rank_ratio=0.9))
    lg, _ = forward(vparams, vcfg, TOKENS)
    base = torch.softmax(base.float(), -1)
    lg = torch.softmax(lg.float(), -1)
    tv = float(0.5 * (base - lg).abs().sum(-1).mean())
    assert tv < 0.30, f"rank-0.9 variant drifted too far (TV={tv})"


def test_eta5_depth_slices_layers():
    vcfg, vparams = T.derive_variant(CFG, PARAMS,
                                     T.VariantSpec(depth_ratio=0.5))
    assert vcfg.num_layers == CFG.num_layers // 2
    for _, leaf in _leaves(vparams["layers"]):
        assert leaf.shape[0] == vcfg.num_layers and leaf.is_contiguous()


def test_eta6_importance_ordering_and_kept_sets_match_reference():
    """Channel slicing keeps the highest-importance channels — the same
    channels (and, for head slicing, the same KV groups) as the JAX
    package keeps, so the derived weights are equal."""
    imp = t_ops._ffn_channel_importance(
        {k: v[0] for k, v in PARAMS["layers"]["ffn"].items()})
    j_imp = j_ops._ffn_channel_importance(
        {k: np.asarray(v)[0] for k, v in J_PARAMS["layers"]["ffn"].items()})
    np.testing.assert_allclose(imp.numpy(), j_imp, rtol=1e-6)
    spec = T.VariantSpec(width_ratio=0.5, head_ratio=0.5)
    vcfg, vparams = T.derive_variant(CFG, PARAMS, spec)
    kept = vcfg.d_ff
    s = imp.sort(descending=True).values
    assert float(s[:kept].mean()) >= float(imp.mean())
    for li in range(CFG.num_layers):
        layer = {k: v[li] for k, v in PARAMS["layers"]["ffn"].items()}
        j_layer = {k: np.asarray(v)[li]
                   for k, v in J_PARAMS["layers"]["ffn"].items()}
        t_set = set(t_ops._descending(
            t_ops._ffn_channel_importance(layer))[:kept].tolist())
        j_set = set(np.argsort(-j_ops._ffn_channel_importance(j_layer))
                    [:kept].tolist())
        assert t_set == j_set, li
        wo = PARAMS["layers"]["attn"]["wo"][li]
        t_heads = t_ops._descending(t_ops._head_importance(
            wo, CFG.num_heads, 16).reshape(2, 2).sum(1))[:1].tolist()
        j_heads = np.argsort(-j_ops._head_importance(
            np.asarray(wo), CFG.num_heads, 16).reshape(2, 2).sum(1))[:1]
        assert t_heads == j_heads.tolist(), li
    j_cfg, j_params = J.derive_variant(J_CFG, J_PARAMS,
                                       J.VariantSpec(width_ratio=0.5,
                                                     head_ratio=0.5))
    assert (vcfg.d_ff, vcfg.num_heads, vcfg.num_kv_heads) == \
        (j_cfg.d_ff, j_cfg.num_heads, j_cfg.num_kv_heads) == (64, 2, 1)
    _assert_same_tree(vparams["layers"], j_params["layers"])


def test_eta2_kv_merge_halves_heads():
    vcfg, vparams = T.derive_variant(CFG, PARAMS, T.VariantSpec(kv_merge=2))
    assert vcfg.num_kv_heads == CFG.num_kv_heads // 2
    wk = vparams["layers"]["attn"]["wk"]
    assert wk.shape[-1] == vcfg.num_kv_heads * vcfg.resolved_head_dim
    _, j_params = J.derive_variant(J_CFG, J_PARAMS, J.VariantSpec(kv_merge=2))
    _assert_same_tree(vparams["layers"], j_params["layers"], exact=False)


def test_supernet_caching_and_action_space():
    sn = T.ElasticSupernet(CFG, PARAMS, max_cached=2)
    space = sn.action_space()
    assert T.FULL_SPEC in space and len(space) >= 6
    assert [dataclasses.asdict(s) for s in space] == [
        dataclasses.asdict(s)
        for s in J.ElasticSupernet(J_CFG, J_PARAMS).action_space()]
    a = sn.variant(space[1])
    b = sn.variant(space[1])
    assert a is b  # cached
    sn.variant(space[2])
    sn.variant(space[3])  # evicts
    assert len(sn._cache) <= 2


def test_ssm_action_space_is_depth_only():
    ssm_cfg = get_config("mamba2-370m").reduced(d_model=64)
    sn = T.ElasticSupernet(ssm_cfg, {})
    assert sn.applicable_operators() == ("eta5",)
    for spec in sn.action_space():
        assert spec.width_ratio == 1.0 and spec.rank_ratio == 1.0
    j_sn = J.ElasticSupernet(j_get_config("mamba2-370m").reduced(d_model=64),
                             {})
    assert [dataclasses.asdict(s) for s in sn.action_space()] == \
        [dataclasses.asdict(s) for s in j_sn.action_space()]


def test_early_exit_monotone_threshold_and_depths_match_reference():
    cfg, j_cfg = CFG.with_updates(**F32), J_CFG.with_updates(**F32)
    p2 = T.attach_exits(cfg, PARAMS, positions=(1, 3))
    j_p2 = J.attach_exits(j_cfg, J_PARAMS, jax.random.PRNGKey(0),
                          positions=(1, 3))
    _, depth_strict = T.early_exit_predict(p2, cfg, TOKENS, threshold=0.99)
    _, depth_loose = T.early_exit_predict(p2, cfg, TOKENS, threshold=0.0)
    # threshold 0 exits everything at the first branch
    assert int(depth_loose.max()) == 0
    assert float(depth_strict.float().mean()) >= \
        float(depth_loose.float().mean())
    # the reference, jitted with the exit positions closed over
    def j_run(fn, **kw):
        return jax.jit(lambda norms, t: fn(
            dict(J_PARAMS, exits=dict(j_p2["exits"], norms=norms)), j_cfg,
            t, **kw))(j_p2["exits"]["norms"], jnp.asarray(TOKENS_NP))
    outs = T.forward_with_exits(p2, cfg, TOKENS)
    for o, jo in zip(outs, j_run(J.forward_with_exits)):
        np.testing.assert_allclose(_np(o), np.asarray(jo), atol=1e-4)
    # a threshold inside the exits' confidence range, in its widest gap
    # near the median (not at a token's own confidence, where the two
    # packages' last-bit differences would decide), splits the tokens
    conf = torch.cat([torch.softmax(o.float(), -1).amax(-1).flatten()
                      for o in outs[:-1]]).sort().values
    gaps = conf[1:] - conf[:-1]
    lo, hi = len(gaps) // 4, 3 * len(gaps) // 4
    i = lo + int(gaps[lo:hi].argmax())
    thr = float(conf[i] + conf[i + 1]) / 2
    lg, depth = T.early_exit_predict(p2, cfg, TOKENS, threshold=thr)
    j_lg, j_depth = j_run(J.early_exit_predict, threshold=thr)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(j_depth))
    assert 0 < int((depth == 0).sum()) < depth.numel()
    np.testing.assert_allclose(_np(lg), np.asarray(j_lg), atol=1e-4)
    assert T.expected_exit_flops(cfg, depth, (1, 3), 32) == pytest.approx(
        J.early_exit.expected_exit_flops(j_cfg, j_depth, (1, 3), 32),
        rel=1e-6)


def test_tta_reduces_entropy_and_touches_only_norms():
    # sharpen the random-init logits so the entropy objective has signal
    cfg, j_cfg = CFG.with_updates(**F32), J_CFG.with_updates(**F32)
    sharp = dict(PARAMS, embed=PARAMS["embed"] * 8.0)
    p1, e1 = T.tta_step(sharp, cfg, TOKENS, lr=5e-2)
    p2, e2 = T.tta_step(p1, cfg, TOKENS, lr=5e-2)
    assert float(e2) < float(e1)
    for path, a in _leaves(p1):
        if path == ("logit_bias",):
            assert a.dtype == torch.float32 and bool((a != 0).any())
            continue
        b = dict(_leaves(sharp))[path]
        if not torch.equal(a, b):
            assert any(n in T.NORM_KEYS for n in path), \
                f"non-norm leaf changed: {path}"
        else:
            assert a is b, path      # frozen leaves are not copied
    assert not torch.equal(p1["layers"]["ln1"], sharp["layers"]["ln1"])
    # the reference takes the same step
    j_step = jax.jit(lambda p, t: J.tta_step(p, j_cfg, t, lr=5e-2))
    j_sharp = dict(J_PARAMS, embed=J_PARAMS["embed"] * 8.0)
    j_p1, j_e1 = j_step(j_sharp, jnp.asarray(TOKENS_NP))
    np.testing.assert_allclose(float(e1), float(j_e1), rtol=1e-5)
    for path in (("layers", "ln1"), ("layers", "ln2"), ("final_norm",),
                 ("logit_bias",)):
        t = dict(_leaves(p1))[path]
        j = j_p1
        for k in path:
            j = j[k]
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5)


@pytest.mark.parametrize("sub_batches", [1, 2])
def test_tta_grads_match_jax_grad(sub_batches):
    # every floating leaf's gradient (norm scales, logit_bias, weights)
    # against jax.grad of the reference objective: two f32 gradients of
    # the same loss, within 1e-4 of each leaf's largest entry
    cfg, j_cfg = CFG.with_updates(**F32), J_CFG.with_updates(**F32)
    sharp = dict(PARAMS, embed=PARAMS["embed"] * 8.0)
    p, grads, ent = T.tta_grads(sharp, cfg, TOKENS, sub_batches=sub_batches)
    assert p["logit_bias"].dtype == torch.float32
    assert set(grads) == {path for path, a in _leaves(p)}
    j_sharp = dict(J_PARAMS, embed=J_PARAMS["embed"] * 8.0,
                   logit_bias=jnp.zeros((cfg.padded_vocab,), jnp.float32))
    j_ent, j_g = jax.jit(jax.value_and_grad(
        lambda q: J.tta_loss(q, j_cfg, jnp.asarray(TOKENS_NP))))(j_sharp)
    np.testing.assert_allclose(float(ent), float(j_ent), rtol=1e-5)
    for path, g in grads.items():
        assert g.dtype == torch.float32, path
        j = j_g
        for k in path:
            j = j[k]
        j = np.asarray(j)
        np.testing.assert_allclose(_np(g), j, rtol=0,
                                   atol=1e-4 * float(np.abs(j).max()) + 1e-9,
                                   err_msg="/".join(path))


def test_ensemble_loss_trains_slices():
    cfg, j_cfg = CFG.with_updates(**F32), J_CFG.with_updates(**F32)
    labels_np = np.roll(TOKENS_NP, -1, 1)
    spec = T.VariantSpec(depth_ratio=0.5, width_ratio=0.5)
    params = {k: v for k, v in PARAMS.items()}
    leaves = dict(_leaves(params))
    w_up = leaves[("layers", "ffn", "w_up")].clone().requires_grad_()
    params["layers"] = dict(params["layers"],
                            ffn=dict(params["layers"]["ffn"], w_up=w_up))
    loss = T.ensemble_loss(params, cfg, TOKENS, torch.from_numpy(labels_np),
                           (spec,))
    g, = torch.autograd.grad(loss, [w_up])
    assert bool(torch.isfinite(loss))
    # gradient must reach the FULL ffn tensor (recycled weights)
    assert float(g[:, :, : CFG.d_ff // 2].abs().sum()) > 0
    assert float(g[:, :, CFG.d_ff // 2:].abs().sum()) > 0
    assert bool(torch.isfinite(g).all())
    j_spec = J.VariantSpec(depth_ratio=0.5, width_ratio=0.5)
    j_loss = jax.jit(lambda p: J.ensemble_loss(
        p, j_cfg, jnp.asarray(TOKENS_NP), jnp.asarray(labels_np),
        jax.random.PRNGKey(0), (j_spec,)))(J_PARAMS)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)


def test_sliced_forward_prefix_semantics():
    spec = T.VariantSpec(depth_ratio=0.5, width_ratio=0.5)
    lg = T.sliced_forward(PARAMS, CFG, TOKENS, spec)
    assert lg.shape == (2, 32, CFG.padded_vocab)
    assert not bool(torch.isnan(lg.float()).any())
    cfg = CFG.with_updates(**F32)
    j_lg = J.sliced_forward(J_PARAMS, J_CFG.with_updates(**F32),
                            jnp.asarray(TOKENS_NP),
                            J.VariantSpec(depth_ratio=0.5, width_ratio=0.5))
    np.testing.assert_allclose(_np(T.sliced_forward(PARAMS, cfg, TOKENS,
                                                    spec)),
                               np.asarray(j_lg), atol=1e-4)


def test_sample_variant_specs_menu():
    specs = T.sample_variant_specs(torch.Generator().manual_seed(0), n=16)
    j_specs = J.sample_variant_specs(jax.random.PRNGKey(0), n=16)
    menu = {0.5, 0.75, 1.0}
    for s in specs + j_specs:
        assert s.depth_ratio in menu and s.width_ratio in menu
        assert s.operators() in ((), ("eta5",), ("eta6",), ("eta5", "eta6"))
    assert len({(s.depth_ratio, s.width_ratio) for s in specs}) > 1


# ---------------------------------------- every variant against JAX ----
SPACE = T.ElasticSupernet(CFG, PARAMS).action_space()


def _spec_id(spec):
    fields = dataclasses.asdict(spec)
    return ",".join(f"{k}={v}" for k, v in fields.items()
                    if v != getattr(T.FULL_SPEC, k)) or "full"


@pytest.mark.parametrize("spec", SPACE, ids=[_spec_id(s) for s in SPACE])
def test_variant_logits_match_reference(spec):
    cfg, j_cfg = CFG.with_updates(**F32), J_CFG.with_updates(**F32)
    vcfg, vparams = T.derive_variant(cfg, PARAMS, spec)
    j_spec = J.VariantSpec(**dataclasses.asdict(spec))
    j_vcfg, j_vparams = J.derive_variant(j_cfg, J_PARAMS, j_spec)
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(j_vcfg)
    for path, leaf in _leaves(vparams):
        assert leaf.is_contiguous(), path
    if spec.rank_ratio < 1.0:
        ffn, j_ffn = vparams["layers"]["ffn"], j_vparams["layers"]["ffn"]
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(
                _np(ffn[name]["u"] @ ffn[name]["v"]),
                np.asarray(j_ffn[name]["u"]) @ np.asarray(j_ffn[name]["v"]),
                atol=1e-4)
    else:
        _assert_same_tree(vparams["layers"], j_vparams["layers"],
                          exact=not (spec.kv_merge > 1 or spec.ghost))
    logits, _ = forward(vparams, vcfg, TOKENS)
    j_logits, _ = J_FORWARD(j_vparams, j_vcfg, jnp.asarray(TOKENS_NP))
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), atol=1e-4)
