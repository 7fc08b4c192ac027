"""The port's MoE family (``repro_torch.models.moe`` and the MoE branches
of the model core) held against the JAX package on the CPU.

Configs: ``olmoe-1b-7b`` and ``llama4-scout-17b-a16e`` as
``test_arch_smoke.py`` reduces them (``.reduced()``: 2 layers, d_model
256, 4 experts; olmoe top-4, llama4 top-1 with a shared expert),
``mixtral-8x7b`` as ``test_bonus_archs.py`` does (top-2 of 4), and olmoe
at ``reduced(max_experts=16)`` (top-8 of 16, so capacity factor 1.0
drops tokens), all with f32 activations and the JAX weights brought
across by the bridge.

Tolerances: f32 in both packages, the same sums in another order.  The
MoE outputs and the aux loss agree within atol 1e-5 (outputs of
magnitude ~1); logits within atol 1e-4 (as the dense model twins);
gradients within 1e-4 of each leaf's largest gradient.  The routing is
held *equal*: the chosen experts, each expert's kept tokens in order
(``sel_idx``) and their validity, including llama4's top-1 ties, where
every gate is 1.0 and the tie order alone decides what an over-full
expert keeps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.models import moe as j_moe
from repro.models import transformer as jt
from repro.models.runtime import RuntimeOptions as JOpts
from repro.serving import CompileCache as JCompileCache
from repro.serving import Request as JRequest
from repro.serving import SamplingOpts as JSampling
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as tt
from repro_torch.models.layers import cast_params
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import (CompileCache, Request, SamplingOpts,
                                 ServingEngine)
from repro_torch.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

F32 = dict(activation_dtype="float32")
ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e", "mixtral-8x7b")
J_FORWARD = jax.jit(jt.forward, static_argnums=(1, 3))


def _cfgs(arch, **reduce):
    return (j_get_config(arch).reduced(**reduce).with_updates(**F32),
            get_config(arch).reduced(**reduce).with_updates(**F32))


_PARAMS = {}


def _params(arch, **reduce):
    """JAX weights of the reduced config and their bridged copy."""
    key = (arch, tuple(sorted(reduce.items())))
    if key not in _PARAMS:
        jcfg, _ = _cfgs(arch, **reduce)
        jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
        _PARAMS[key] = (jp, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return _PARAMS[key]


def _layer(tree, j=0):
    return jax.tree_util.tree_map(lambda a: a[j], tree)


def _t_layer(tree, j=0):
    return {k: _t_layer(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------- capacity --
def test_capacity_matches_reference():
    jcfg = j_get_config("olmoe-1b-7b")
    tcfg = get_config("olmoe-1b-7b")
    for t in (1, 7, 8, 33, 64, 250, 1024, 8192):
        for e, k in ((4, 1), (4, 2), (16, 8), (64, 8)):
            for cf in (0.5, 1.0, 1.25, 2.0, 8.0, 16.0):
                kw = dict(num_experts=e, experts_per_token=k)
                assert t_moe._capacity(t, tcfg.with_updates(**kw), cf) == \
                    j_moe._capacity(t, jcfg.with_updates(**kw), cf), \
                    (t, e, k, cf)


# ------------------------------------------------------ moe_apply ----
def _j_routing(params, x, cfg, cap):
    """The JAX package's routing steps (``moe.py`` :57-69) on its own
    ops: the chosen experts, ``sel_idx`` and ``valid``."""
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ params["router"], -1)
    topk_p, topk_i = jax.lax.top_k(probs, cfg.experts_per_token)
    topk_p = topk_p / jnp.maximum(jnp.sum(topk_p, -1, keepdims=True), 1e-9)
    gates = jnp.sum(jax.nn.one_hot(topk_i, cfg.num_experts)
                    * topk_p[..., None], axis=1)
    scores = jnp.where(gates > 0, gates, -1.0).T
    sel_score, sel_idx = jax.lax.top_k(scores, cap)
    return (np.asarray(topk_i), np.asarray(sel_idx),
            np.asarray(sel_score > 0))


MOE_CASES = [("olmoe-1b-7b", dict(max_experts=16)),
             ("llama4-scout-17b-a16e", {}), ("mixtral-8x7b", {})]


@pytest.mark.parametrize("cf", [1.0, 16.0])
@pytest.mark.parametrize("arch,reduce", MOE_CASES,
                         ids=[a for a, _ in MOE_CASES])
def test_moe_apply_matches_reference(arch, reduce, cf):
    jcfg, tcfg = _cfgs(arch, **reduce)
    jp, tp = _params(arch, **reduce)
    jl, tl_ = _layer(jp["layers"])["moe"], _t_layer(tp["layers"])["moe"]
    x = _x((2, 32, tcfg.d_model), 7)
    yj, auxj = jax.jit(lambda p, v: j_moe.moe_apply(
        p, v, jcfg, capacity_factor=cf))(jl, jnp.asarray(x))
    yt, auxt = t_moe.moe_apply(tl_, torch.from_numpy(x), tcfg,
                               capacity_factor=cf)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(float(auxt), float(auxj), atol=1e-5)

    cap = t_moe._capacity(64, tcfg, cf)
    ti, sel, valid = _j_routing(jl, jnp.asarray(x), jcfg, cap)
    _, gates, topk_i = t_moe._route(tl_["router"],
                                    torch.from_numpy(x).reshape(64, -1),
                                    tcfg.experts_per_token)
    t_sel, t_valid = t_moe._select(gates, cap)
    np.testing.assert_array_equal(topk_i.numpy(), ti)
    np.testing.assert_array_equal(t_sel.numpy(), sel)
    np.testing.assert_array_equal(t_valid.numpy(), valid)
    dropped = int((gates > 0).sum()) - int(t_valid.sum())
    if cf == 16.0:
        assert dropped == 0
    elif arch != "mixtral-8x7b":
        # top-8 of 16 and top-1 of 4 over-fill experts at factor 1.0;
        # for llama4 all gates tie at 1.0, so the tie order decides
        assert dropped > 0
        if arch == "llama4-scout-17b-a16e":
            assert bool((gates.max(-1).values == 1.0).all())


def test_moe_apply_decode_matches_reference_and_gather():
    """Dense dispatch against the JAX package's (atol 1e-5) and the
    literal per-token gather of ``test_perf_levers.py``'s
    ``test_dense_dispatch_matches_gather_dispatch`` (atol 1e-4, rtol
    1e-3, as there)."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    jp, tp = _params("olmoe-1b-7b")
    params = jax.tree_util.tree_map(np.asarray, _layer(jp["layers"])["moe"])
    x = _x((8, tcfg.d_model), 1, 0.3)
    yj = j_moe.moe_apply_decode(params, jnp.asarray(x), jcfg)
    yt = t_moe.moe_apply_decode(_t_layer(tp["layers"])["moe"],
                                torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=1e-5)

    logits = x @ params["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ref = np.zeros_like(x)
    for t in range(x.shape[0]):
        top = np.argsort(-probs[t], kind="stable")[:tcfg.experts_per_token]
        p = probs[t, top] / probs[t, top].sum()
        for e, w in zip(top, p):
            h = x[t] @ params["w_gate"][e]
            u = x[t] @ params["w_up"][e]
            h = h / (1 + np.exp(-np.clip(h, -30, 30))) * u
            ref[t] += w * (h @ params["w_down"][e])
    np.testing.assert_allclose(_np(yt), ref, atol=1e-4, rtol=1e-3)


def test_moe_capacity_drops_bounded():
    """Twin of ``test_model_properties.py::test_moe_capacity_drops_bounded``
    on the JAX weights: factor 16 drops nothing, factor 1.0 only loses
    mass; both outputs equal the JAX package's."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    jp, tp = _params("olmoe-1b-7b")
    jl, tl_ = _layer(jp["layers"])["moe"], _t_layer(tp["layers"])["moe"]
    x = _x((2, 32, tcfg.d_model), 1, 0.3)
    out = {}
    for cf in (1.0, 16.0):
        y, _ = t_moe.moe_apply(tl_, torch.from_numpy(x), tcfg,
                               capacity_factor=cf)
        yj, _ = j_moe.moe_apply(jl, jnp.asarray(x), jcfg,
                                capacity_factor=cf)
        np.testing.assert_allclose(_np(y), np.asarray(yj), atol=1e-5)
        out[cf] = y
    assert out[1.0].shape == out[16.0].shape
    diff = float((out[1.0] - out[16.0]).abs().mean())
    assert diff < float(out[16.0].abs().mean())


# ------------------------------------------------------ layout, bridge --
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    """The port's ``init_params`` has the JAX layout (paths, shapes,
    dtypes: f32 router, bf16 experts, llama4's shared FFN), and the bridge
    carries the ``moe`` subtree with its dtypes both ways."""
    jcfg = j_get_config(arch).reduced()
    jp = jax.eval_shape(lambda: jm.init_params(jcfg,
                                               jax.random.PRNGKey(0)))
    tp = params_to_numpy(tt.init_params(get_config(arch).reduced(),
                                        device="cpu"))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    moe = tp["layers"]["moe"]
    assert "ffn" not in tp["layers"]
    assert ("shared" in moe) == (arch == "llama4-scout-17b-a16e")
    # bf16 weights across the bridge: the router stays f32, and so it
    # does under cast_params
    jmoe = jm.init_params(jcfg.with_updates(param_dtype="bfloat16"),
                          jax.random.PRNGKey(0))["layers"]["moe"]
    back = params_from_numpy(jax.tree_util.tree_map(np.asarray, jmoe),
                             "cpu")
    for name, leaf in _flat(back).items():
        assert leaf.dtype == (torch.float32 if name == "router"
                              else torch.bfloat16), name
        np.testing.assert_array_equal(
            _np(leaf), np.asarray(_flat(jmoe)[name], np.float32))
    assert cast_params(back, torch.bfloat16)["router"].dtype == \
        torch.float32


# ------------------------------------------------- the model twins ----
def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Twin of ``test_arch_smoke.py::test_forward_smoke`` (capacity factor
    2.0): logits and aux against the JAX package's."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    toks = _tokens(tcfg, (2, 16), 0)
    lj, auxj = J_FORWARD(jp, jcfg, jnp.asarray(toks),
                         JOpts(moe_capacity_factor=2.0))
    lt, auxt = tt.forward(tp, tcfg, torch.from_numpy(toks),
                          RuntimeOptions(moe_capacity_factor=2.0))
    assert lt.shape == (2, 16, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=1e-4)
    np.testing.assert_allclose(float(auxt), float(auxj), atol=1e-5)
    assert float(auxt) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference_and_forward(arch):
    """Twins of ``test_arch_smoke.py::test_decode_matches_forward`` and
    ``test_bonus_archs.py::test_bonus_forward_and_decode`` (capacity
    factor 8.0, nothing dropped): prefill of 11 tokens then one decode
    step against the JAX package's, and the decode logits against the
    forward's last position (rel < 0.06, as there).  The KV cache is f32,
    as in the dense model twins: a bf16 cache rounds K/V values that
    differ in their last f32 bits to neighbouring bf16 values."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    kw = dict(moe_capacity_factor=8.0, kv_cache_dtype="float32")
    jo, to = JOpts(**kw), RuntimeOptions(**kw)
    toks = _tokens(tcfg, (2, 12), 3)

    def j_run(p, t):
        _, cache = jm.prefill(p, jcfg, t[:, :11],
                              jm.init_cache(jcfg, 2, 24, jo), jo)
        lg, cache = jm.decode_step(p, jcfg, cache, t[:, 11], jo)
        return lg, cache["pos"]

    lj, pj = jax.jit(j_run)(jp, jnp.asarray(toks))
    cache = tm.init_cache(tcfg, 2, 24, to, device="cpu")
    _, cache = tm.prefill(tp, tcfg, torch.from_numpy(toks[:, :11]), cache,
                          to)
    lt, cache = tm.decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, 11]),
                               to)
    assert int(cache["pos"]) == int(pj) == 12
    np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=1e-4)
    ref, _ = tt.forward(tp, tcfg, torch.from_numpy(toks), to)
    ref = ref[:, -1].float()
    rel = float((ref - lt.float()).abs().max()) / (float(ref.abs().max())
                                                   + 1e-9)
    assert rel < 0.06, f"{arch}: decode diverges from forward (rel={rel})"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_grads_match_reference(arch):
    """Twin of ``test_arch_smoke.py::test_train_step_smoke``: the loss
    ``lm_loss + router_aux_weight * aux`` and its gradients by autograd
    against ``jax.value_and_grad``, leaf by leaf."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    toks = _tokens(tcfg, (2, 16), 1)
    labels = np.roll(toks, -1, axis=1)
    jo, to = JOpts(moe_capacity_factor=2.0), RuntimeOptions(
        moe_capacity_factor=2.0)

    def j_loss(p):
        logits, aux = jt.forward(p, jcfg, jnp.asarray(toks), jo)
        return jt.lm_loss(logits, jnp.asarray(labels)) \
            + jcfg.router_aux_weight * aux

    lj, gj = jax.jit(jax.value_and_grad(j_loss))(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in
              _flat(tp).items()}
    logits, aux = tt.forward(_unflat(leaves), tcfg, torch.from_numpy(toks),
                             to)
    lt = tt.lm_loss(logits, torch.from_numpy(labels)) \
        + tcfg.router_aux_weight * aux
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    gj = _flat(jax.tree_util.tree_map(np.asarray, gj))
    assert sorted(gj) == sorted(leaves)
    for name, g in gj.items():
        gt = leaves[name].grad
        assert gt is not None and bool(torch.isfinite(gt).all()), name
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(_np(gt), g, atol=1e-4 * scale + 1e-12,
                                   err_msg=name)
    assert float(np.abs(gj["layers/moe/router"]).max()) > 0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "/"))
        else:
            out[name] = v
    return out


def _unflat(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# -------------------------------------------------- paged kernel step --
@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_paged_prefill_and_kernel_step_match_reference(kv):
    """Reduced olmoe (16 experts top-8) through ``paged_prefill_admit`` and
    the paged kernel step, int8 and bf16 pools, against the JAX package:
    first and next tokens and keys equal, last logits within 1e-4, the
    pools' int8 codes within one step and scales/bf16 rows within the f32
    tolerance."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", max_experts=16)
    jp, tp = _params("olmoe-1b-7b", max_experts=16)
    slots, max_seq, bs, nb = 2, 64, 8, 17
    kw = (dict(kv_dtype="int8", kv_cache_dtype="float32") if kv == "int8"
          else dict(kv_cache_dtype="bfloat16"))
    jopts = JOpts(paged_kernel=True, **kw)
    topts = RuntimeOptions(paged_kernel=True, **kw)
    toks = _tokens(tcfg, (2, 16), 9)
    slot_ids = np.array([0, 1], np.int32)
    keys = np.stack([np.array([3, 4], np.uint32),
                     np.array([5, 6], np.uint32)])
    temps = np.array([0.0, 0.9], np.float32)
    top_ks = np.zeros(2, np.int32)
    dest = np.array([[1, 2], [3, 4]], np.int32)
    tables = np.zeros((slots, max_seq // bs), np.int32)
    tables[0, :3], tables[1, :3] = [1, 2, 5], [3, 4, 6]

    def j_run(p, pool, slot):
        first, last, slot, pool = jm.paged_prefill_admit(
            p, jcfg, slot, pool, jnp.asarray(toks), jnp.asarray(slot_ids),
            jnp.asarray(keys), jnp.asarray(temps), jnp.asarray(top_ks),
            jnp.asarray(dest), jopts)
        nxt, pos, slot, pool = jm.paged_kernel_sample_batched_step(
            p, jcfg, slot, pool, first, jnp.asarray(tables), jopts)
        return first, last, nxt, pos, slot, pool

    jf, jlast, jn, jpos, jslot, jpool = jax.jit(j_run)(
        jp, jm.init_paged_pool(jcfg, nb, bs, jopts),
        jm.init_paged_slot_cache(jcfg, slots, max_seq, jopts))
    tpool = tm.init_paged_pool(tcfg, nb, bs, topts, device="cpu")
    tslot = tm.init_paged_slot_cache(tcfg, slots, max_seq, topts,
                                     device="cpu")
    tf, tlast, tslot, tpool = tm.paged_prefill_admit(
        tp, tcfg, tslot, tpool, torch.from_numpy(toks),
        torch.from_numpy(slot_ids), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(temps), torch.from_numpy(top_ks),
        torch.from_numpy(dest), topts)
    tn, tpos, tslot, tpool = tm.paged_kernel_sample_batched_step(
        tp, tcfg, tslot, tpool, tf, torch.from_numpy(tables), topts)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(_np(tlast), np.asarray(jlast, np.float32),
                               atol=1e-4)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tslot["sample"]["key"].numpy(),
                                  np.asarray(jslot["sample"]["key"]))
    for name in jpool:
        a, b = _np(tpool[name]), np.asarray(jpool[name], np.float32)
        if name in ("k", "v") and kv == "int8":
            # codes of values within an ulp of a rounding boundary may
            # differ by one step
            assert np.abs(a - b).max() <= 1
        elif kv == "bfloat16":
            # bf16 rows of the same f32 K/V: one bf16 rounding apart
            np.testing.assert_allclose(a, b, atol=1e-2, rtol=1e-2)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5)


# ------------------------------------------------------ batched engine --
def test_batched_engine_matches_reference_with_drops(monkeypatch):
    """The port's batched ``ServingEngine`` against the JAX engine on
    reduced olmoe (16 experts top-8, capacity factor 1.0): greedy and
    sampled streams and the engine counters equal.  The mix admits two
    same-bucket prompts in one prefill call, so their tokens share the
    experts' capacity, and that call drops tokens."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", max_experts=16)
    jp, tp = _params("olmoe-1b-7b", max_experts=16)
    mix = [(20, 4, 0.0), (27, 4, 0.8), (9, 3, 0.0)]
    drops = []
    select = t_moe._select

    def counting(gates, cap):
        sel, valid = select(gates, cap)
        drops.append(int((gates > 0).sum()) - int(valid.sum()))
        return sel, valid

    monkeypatch.setattr(t_moe, "_select", counting)
    streams, stats = {}, {}
    for port in (False, True):
        req_t, samp_t = (Request, SamplingOpts) if port else (JRequest,
                                                              JSampling)
        eng = (ServingEngine(tcfg, tp, slots=2, max_seq=64,
                             compile_cache=CompileCache(), device="cpu")
               if port else JEngine(jcfg, jp, slots=2, max_seq=64,
                                    compile_cache=JCompileCache()))
        rng = np.random.default_rng(5)
        reqs = [req_t(rid=i, prompt=rng.integers(0, tcfg.vocab_size, n)
                      .astype(np.int32), max_new_tokens=b,
                      sampling=samp_t(temperature=t, seed=5))
                for i, (n, b, t) in enumerate(mix)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams[port] = [tuple(r.generated) for r in reqs]
        stats[port] = (eng.stats.prefill_calls, eng.stats.prefills,
                       eng.stats.tokens_out, eng.stats.steps)
    assert streams[True] == streams[False]
    assert stats[True] == stats[False]
    assert stats[True][0] < stats[True][1]        # a burst of two
    assert max(drops) > 0
