"""The port's hybrid stack (Zamba2: Mamba2 blocks and ONE shared
attention block after every full period of ``shared_attn_period``
blocks) held against the JAX package's, with the JAX weights brought
across by the bridge.

Two reductions of ``zamba2-1.2b`` at d_model 256 (4 attention heads of
64, 16 SSM heads of 32, state 32, d_ff 1024, vocab 1024): the default
``reduced()`` (2 layers, period 1: a site after every layer) and 5
layers at period 2 (2 sites and one leftover layer, which the default
hides: a site placed one layer off passes there and fails here).

Tolerances: with f32 activations and caches both packages compute the
same sums in another order, so every f32 quantity (logits, cache
leaves, gradients) agrees within 1e-4 of the reference's largest
magnitude.  The twins of ``test_arch_smoke.py`` run the config's own
bf16 activations, where the two frameworks round to bf16 at different
places: logits within 0.1 (the other model twins' bf16 tolerance).  The
engines' greedy and sampled streams and counters are equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.elastic as J
from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.models import transformer as jt
from repro.models.runtime import RuntimeOptions as JOpts
from repro.serving import CompileCache as JCompileCache
from repro.serving import Request as JRequest
from repro.serving import SamplingOpts as JSampling
from repro.serving import ServingEngine as JEngine
import repro_torch.elastic as T
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import (CompileCache, Request, SamplingOpts,
                                 ServingEngine)
from repro_torch.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

NAME = "zamba2-1.2b"
F32 = dict(activation_dtype="float32")
# id -> (layers, shared_attn_period)
SHAPES = {"period1": (2, 1), "period2": (5, 2)}
BF16_ATOL = 0.1


def _cfgs(shape, **kw):
    layers, period = SHAPES[shape]
    return tuple(get(NAME).reduced(num_layers=layers).with_updates(
        shared_attn_period=period, **kw) for get in (j_get_config,
                                                     get_config))


_PARAMS = {}


def _params(shape):
    """JAX weights of seed 0 and their bridge, one set per shape."""
    if shape not in _PARAMS:
        jcfg, _ = _cfgs(shape)
        jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
        _PARAMS[shape] = (jp, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return _PARAMS[shape]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close_rel(t, j, rel=1e-4, what=""):
    """Within ``rel`` of the reference's largest magnitude."""
    j = _np(j)
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(_np(t), j, atol=rel * scale + 1e-12,
                               rtol=0, err_msg=what)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


J_FORWARD = jax.jit(jt.forward, static_argnums=(1, 3),
                    static_argnames=("num_layers",))


# ------------------------------------------------------ layout, sites --
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_init_params_and_cache_layout_match_reference(shape):
    """The port's ``init_params`` has the JAX tree (paths, shapes,
    dtypes: ``layers`` the Mamba stack, ``shared_attn`` one attention
    layer with a gated FFN), and ``init_cache`` the JAX cache: the SSM
    state, the conv tail and one shared K/V per site."""
    jcfg, tcfg = _cfgs(shape)
    jp = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_to_numpy(tt.init_params(tcfg, device="cpu"))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert set(tp["shared_attn"]) == {"ln1", "attn", "ln2", "ffn"}
    assert "w_gate" in tp["shared_attn"]["ffn"]
    jc = jm.init_cache(jcfg, 2, 24)
    tc = tm.init_cache(tcfg, 2, 24, device="cpu")
    assert set(tc) == set(jc) == {"pos", "ssm", "conv", "shared_k",
                                  "shared_v"}
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
    sites = SHAPES[shape][0] // SHAPES[shape][1]
    assert tm._n_shared_sites(tcfg) == jm._n_shared_sites(jcfg) == sites
    assert tc["shared_k"].shape[0] == sites
    # a site follows the last layer of each full period, none the rest
    follows = [j for j in range(tcfg.num_layers)
               if tm._shared_site(tcfg, j) >= 0]
    period = SHAPES[shape][1]
    assert follows == [period * (i + 1) - 1 for i in range(sites)]


# ---------------------------------------------------------- forward ----
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_matches_reference(shape):
    jcfg, tcfg = _cfgs(shape, **F32)
    jp, tp = _params(shape)
    toks = _tokens(tcfg, (2, 24), 0)
    lj, auxj = J_FORWARD(jp, jcfg, jnp.asarray(toks))
    lt, auxt = tt.forward(tp, tcfg, torch.from_numpy(toks))
    assert lt.shape == (2, 24, tcfg.padded_vocab)
    _close_rel(lt, lj)
    assert float(auxt) == float(auxj) == 0.0


@pytest.mark.parametrize("depth", [1, 3, 4])
def test_forward_depth_eta5_matches_reference(depth):
    """η5's ``num_layers`` truncates before the periods are counted: at
    period 2, depth 1 runs no site, 3 one site and a leftover layer, 4
    two sites."""
    jcfg, tcfg = _cfgs("period2", **F32)
    jp, tp = _params("period2")
    toks = _tokens(tcfg, (2, 24), 1)
    lj, _ = J_FORWARD(jp, jcfg, jnp.asarray(toks), num_layers=depth)
    lt, _ = tt.forward(tp, tcfg, torch.from_numpy(toks), num_layers=depth)
    _close_rel(lt, lj)
    full, _ = tt.forward(tp, tcfg, torch.from_numpy(toks))
    assert not torch.allclose(lt, full)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_train_step_grads_match_reference(shape):
    """``lm_loss`` and its gradients by autograd against
    ``jax.value_and_grad``, leaf by leaf; the shared block's leaves
    gather a gradient from every site."""
    jcfg, tcfg = _cfgs(shape, **F32)
    jp, tp = _params(shape)
    toks = _tokens(tcfg, (2, 16), 2)
    labels = np.roll(toks, -1, axis=1)

    def j_loss(p):
        logits, _ = jt.forward(p, jcfg, jnp.asarray(toks))
        return jt.lm_loss(logits, jnp.asarray(labels))

    lj, gj = jax.jit(jax.value_and_grad(j_loss))(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in
              _flat(tp).items()}
    logits, _ = tt.forward(_unflat(leaves), tcfg, torch.from_numpy(toks))
    lt = tt.lm_loss(logits, torch.from_numpy(labels))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    gj = _flat(jax.tree_util.tree_map(np.asarray, gj))
    assert sorted(gj) == sorted(leaves)
    for name, g in gj.items():
        gt = leaves[name].grad
        assert gt is not None and bool(torch.isfinite(gt).all()), name
        _close_rel(gt, g, what=name)
    assert float(np.abs(gj["shared_attn/ffn/w_gate"]).max()) > 0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


# -------------------------------------------------- prefill, decode ----
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prefill_and_decode_steps_match_reference(shape):
    """Two left-padded prompts of 20 tokens into a 32-row cache (f32
    activations and caches), then three decode steps on the reference's
    tokens: logits and every cache leaf (``ssm``, ``conv``,
    ``shared_k``/``shared_v`` zero-padded past ``pos``, ``pos``) after
    each."""
    jcfg, tcfg = _cfgs(shape, **F32)
    jp, tp = _params(shape)
    kw = dict(kv_cache_dtype="float32")
    jo, to = JOpts(**kw), RuntimeOptions(**kw)
    toks = _tokens(tcfg, (2, 20), 3)
    toks[1, :7] = 0

    def j_steps(p, t):
        lg, cache = jm.prefill(p, jcfg, t, jm.init_cache(jcfg, 2, 32, jo),
                               jo)
        out = [(lg, dict(cache))]
        tok = t[:, -1]
        for _ in range(3):
            lg, cache = jm.decode_step(p, jcfg, cache, tok, jo)
            out.append((lg, dict(cache)))
            tok = jnp.argmax(lg[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        return out

    j_out = jax.jit(j_steps)(jp, jnp.asarray(toks))
    cache = tm.init_cache(tcfg, 2, 32, to, device="cpu")
    lt, cache = tm.prefill(tp, tcfg, torch.from_numpy(toks), cache, to)
    for i, (lj, jc) in enumerate(j_out):
        if i:
            tok = (toks[:, -1] if i == 1 else np.array(jnp.argmax(
                j_out[i - 1][0][:, :jcfg.vocab_size], -1), np.int32))
            lt, cache = tm.decode_step(tp, tcfg, cache,
                                       torch.from_numpy(tok), to)
        _close_rel(lt, lj, what=f"logits after step {i}")
        assert set(cache) == set(jc)
        assert int(cache["pos"]) == int(jc["pos"]) == 20 + i
        for name in ("ssm", "conv", "shared_k", "shared_v"):
            assert cache[name].dtype == torch.float32, name
            _close_rel(cache[name], jc[name], what=f"{name} after {i}")
        assert not bool(cache["shared_k"][:, :, 20 + i:].any())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_with_exits_matches_reference(shape):
    """Exits at layers 1 and 3 (one layer for period 1): the shared
    block's placement restarts in every segment, as in the JAX
    package."""
    jcfg, tcfg = _cfgs(shape, **F32)
    jp, tp = _params(shape)
    positions = (1, 3) if tcfg.num_layers > 3 else (1,)
    p2 = T.attach_exits(tcfg, tp, positions=positions)
    j_p2 = J.attach_exits(jcfg, jp, jax.random.PRNGKey(0),
                          positions=positions)
    toks = _tokens(tcfg, (2, 16), 4)
    j_outs = jax.jit(lambda norms, t: J.forward_with_exits(
        dict(jp, exits=dict(j_p2["exits"], norms=norms)), jcfg, t))(
        j_p2["exits"]["norms"], jnp.asarray(toks))
    outs = T.forward_with_exits(p2, tcfg, torch.from_numpy(toks))
    assert len(outs) == len(j_outs) == len(positions) + 1
    for o, jo in zip(outs, j_outs):
        _close_rel(o, jo)


# ----------------------------------------- twins of test_arch_smoke.py --
ARCH_OPTS = dict(moe_capacity_factor=2.0)


def _smoke():
    """The configs ``test_arch_smoke.py`` runs (``reduced()``: bf16
    activations), the JAX package's and the port's."""
    jcfg, tcfg = j_get_config(NAME).reduced(), get_config(NAME).reduced()
    return jcfg, tcfg


def test_forward_smoke():
    jcfg, tcfg = _smoke()
    key = jax.random.PRNGKey(0)
    jp = jm.init_params(jcfg, key)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = jax.random.randint(key, (2, 16), 0, jcfg.vocab_size)
    lj, _ = J_FORWARD(jp, jcfg, toks, JOpts(**ARCH_OPTS))
    lt, aux = tt.forward(tp, tcfg, torch.from_numpy(np.array(toks)),
                         RuntimeOptions(**ARCH_OPTS))
    assert lt.shape == (2, 16, tcfg.vocab_size)
    assert not bool(torch.isnan(lt.float()).any())
    assert not bool(torch.isnan(aux).any())
    np.testing.assert_allclose(_np(lt), np.asarray(lj, np.float32),
                               atol=BF16_ATOL)


def test_train_step_smoke():
    jcfg, tcfg = _smoke()
    key = jax.random.PRNGKey(1)
    jp = jm.init_params(jcfg, key)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.array(jax.random.randint(key, (2, 16), 0, jcfg.vocab_size))
    labels = np.roll(toks, -1, axis=1)

    def j_loss(p):
        logits, aux = jt.forward(p, jcfg, jnp.asarray(toks),
                                 JOpts(**ARCH_OPTS))
        return jt.lm_loss(logits, jnp.asarray(labels)) \
            + jcfg.router_aux_weight * aux

    lj = float(jax.jit(j_loss)(jp))
    leaves = {k: v.clone().requires_grad_(True) for k, v in
              _flat(tp).items()}
    logits, aux = tt.forward(_unflat(leaves), tcfg, torch.from_numpy(toks),
                             RuntimeOptions(**ARCH_OPTS))
    loss = tt.lm_loss(logits, torch.from_numpy(labels)) \
        + tcfg.router_aux_weight * aux
    loss.backward()
    assert bool(torch.isfinite(loss))
    np.testing.assert_allclose(float(loss.detach()), lj, atol=BF16_ATOL)
    grads = [v.grad for v in leaves.values()]
    assert all(g is not None and bool(torch.isfinite(g.float()).all())
               for g in grads)
    assert sum(float(g.float().abs().sum()) for g in grads) > 0
    assert float(leaves["shared_attn/attn/wq"].grad.float().abs().sum()) > 0


def test_decode_smoke():
    jcfg, tcfg = _smoke()
    key = jax.random.PRNGKey(2)
    jp = jm.init_params(jcfg, key)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.array(jax.random.randint(key, (2, 8), 0, jcfg.vocab_size))
    jo, to = JOpts(**ARCH_OPTS), RuntimeOptions(**ARCH_OPTS)

    def j_run(p, t):
        _, cache = jm.prefill(p, jcfg, t, jm.init_cache(jcfg, 2, 32, jo), jo)
        return jm.decode_step(p, jcfg, cache, t[:, -1], jo)[0]

    lj = jax.jit(j_run)(jp, jnp.asarray(toks))
    cache = tm.init_cache(tcfg, 2, 32, to, device="cpu")
    _, cache = tm.prefill(tp, tcfg, torch.from_numpy(toks), cache, to)
    assert int(cache["pos"]) == 8
    lg, cache = tm.decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, -1]),
                               to)
    assert lg.shape == (2, tcfg.vocab_size)
    assert not bool(torch.isnan(lg.float()).any())
    assert int(cache["pos"]) == 9
    np.testing.assert_allclose(_np(lg), np.asarray(lj, np.float32),
                               atol=BF16_ATOL)


def test_decode_matches_forward():
    """Decode with the cache agrees with the full forward at the last
    position (rel < 0.06, the reference test's bound), in the port as in
    the JAX package."""
    jcfg, tcfg = _smoke()
    opts = dict(moe_capacity_factor=8.0)
    key = jax.random.PRNGKey(3)
    jp = jm.init_params(jcfg, key)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.array(jax.random.randint(key, (2, 12), 0, jcfg.vocab_size))
    to = RuntimeOptions(**opts)
    ref, _ = tt.forward(tp, tcfg, torch.from_numpy(toks), to)
    cache = tm.init_cache(tcfg, 2, 24, to, device="cpu")
    _, cache = tm.prefill(tp, tcfg, torch.from_numpy(toks[:, :11]), cache,
                          to)
    lg, _ = tm.decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, 11]),
                           to)
    ref = ref[:, -1].float()
    rel = float((ref - lg.float()).abs().max()) / (float(ref.abs().max())
                                                  + 1e-9)
    assert rel < 0.06, f"decode diverges from forward (rel={rel})"
    jo = JOpts(**opts)

    def j_run(p, t):
        _, cache = jm.prefill(p, jcfg, t[:, :11],
                              jm.init_cache(jcfg, 2, 24, jo), jo)
        return jm.decode_step(p, jcfg, cache, t[:, 11], jo)[0]

    np.testing.assert_allclose(
        _np(lg), np.asarray(jax.jit(j_run)(jp, jnp.asarray(toks)),
                            np.float32), atol=BF16_ATOL)


# ------------------------------------------------------------ engines --
MIX = [(5, 6, 0, 0.0), (20, 6, 1, 0.8), (33, 5, 2, 1.4), (9, 4, 2, 0.0)]
COUNTERS = ("steps", "tokens_out", "prefills", "prefill_calls",
            "sampled_tokens", "freezes", "thaws", "requeues")
_ENGINE_CC = {}


def _engine(port, shape="period2", slots=2, **kw):
    jcfg, tcfg = _cfgs(shape, **F32)
    jp, tp = _params(shape)
    if port:
        return ServingEngine(tcfg, tp, slots=slots, max_seq=64,
                             compile_cache=CompileCache(), device="cpu",
                             **kw)
    cc = _ENGINE_CC.setdefault(shape, JCompileCache())
    return JEngine(jcfg, jp, slots=slots, max_seq=64, compile_cache=cc,
                   **kw)


def _requests(port, mix, rid_base=0):
    req_t, samp_t = (Request, SamplingOpts) if port else (JRequest,
                                                          JSampling)
    vocab = _cfgs("period2")[1].vocab_size
    return [req_t(rid=rid_base + i, prompt=np.random.default_rng(
        31 * n + rid_base + i).integers(0, vocab, n).astype(np.int32),
        max_new_tokens=b, sampling=samp_t(temperature=t, seed=5))
        for i, (n, b, _, t) in enumerate(mix)]


def _drive(eng, reqs, mix, max_steps=200):
    step = 0
    while any(not r.done for r in reqs):
        for r, (_, _, at, _) in zip(reqs, mix):
            if at == step:
                eng.submit(r)
        eng.step()
        step += 1
        assert step < max_steps, "engine failed to drain"
    return [tuple(r.generated) for r in reqs]


@pytest.mark.parametrize("decode_mode", ["batched", "per_slot"])
def test_engine_streams_match_reference_at_period_2(decode_mode):
    """Staggered admits, shared buckets and sampled requests through the
    5-layer period-2 hybrid: the streams and counters equal the JAX
    engine's."""
    runs = []
    for port in (False, True):
        eng = _engine(port, decode_mode=decode_mode)
        runs.append((_drive(eng, _requests(port, MIX), MIX),
                     {c: getattr(eng.stats, c) for c in COUNTERS}))
    assert runs[1] == runs[0]


def _blob_bytes(frozen):
    return {name: (int(v.numel()) * v.element_size()
                   if isinstance(v, torch.Tensor) else int(v.nbytes))
            for name, v in frozen.leaves.items()}


@pytest.mark.parametrize("decode_mode", ["batched", "per_slot"])
def test_frozen_slot_trims_shared_kv_and_thaws_exactly(decode_mode):
    """A frozen hybrid slot's blob holds ``shared_k``/``shared_v``
    trimmed to ``pos`` rows, with the JAX engine's bytes leaf for leaf;
    thawed on the same engine the streams equal the uninterrupted run's
    and the JAX engine's, with no prefill call."""
    mix = [(9, 7, 0, 1.2), (25, 7, 0, 0.0)]
    baseline = _drive(_engine(True, decode_mode=decode_mode),
                      _requests(True, mix), mix)
    runs = []
    for port in (False, True):
        eng = _engine(port, decode_mode=decode_mode)
        reqs = _requests(port, mix)
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        calls = eng.stats.prefill_calls
        moved = eng.freeze_all("migrate")
        blobs = [_blob_bytes(r.frozen) for r in moved]
        for r in moved:
            k = r.frozen.leaves["shared_k"]
            assert tuple(k.shape)[2] == r.frozen.pos
            assert tuple(k.shape)[:2] == (2, 1)
            assert eng.thaw(r)
        eng.drain()
        assert eng.stats.prefill_calls == calls
        runs.append(([tuple(r.generated) for r in reqs], blobs,
                     eng.stats.freezes, eng.stats.thaws))
    assert runs[1] == runs[0]
    assert runs[1][0] == baseline
    assert runs[1][2] == runs[1][3] == 2


def test_swap_model_same_weights_mid_wave_keeps_the_streams():
    """``swap_model`` to the same weights after 3 steps freezes, rebuilds
    and thaws the hybrid's slots: zero extra prefill calls and the
    unswapped streams, as in the JAX engine."""
    mix = [(9, 6, 0, 1.2), (25, 6, 0, 0.8), (14, 6, 0, 0.0)]
    baseline = _drive(_engine(True, slots=3), _requests(True, mix), mix)
    jcfg, tcfg = _cfgs("period2", **F32)
    jp, tp = _params("period2")
    runs = []
    for port in (False, True):
        eng = _engine(port, slots=3)
        reqs = _requests(port, mix)
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        calls = eng.stats.prefill_calls
        if port:
            eng.swap_model(tcfg, tp, eng.opts)
        else:
            eng.swap_model(jcfg, jp, eng.opts)
        eng.drain()
        assert eng.stats.prefill_calls == calls
        runs.append(([tuple(r.generated) for r in reqs],
                     eng.stats.requeues, eng.stats.thaws))
    assert runs[1] == runs[0]
    assert runs[1][0] == baseline
    assert runs[1][1] == runs[1][2] == 3


def test_paged_mode_refuses_the_hybrid():
    """The hybrid has no paged mode: its stack holds no per-layer
    attention KV, so the block pool raises ``ValueError`` in both
    packages."""
    jcfg, tcfg = _cfgs("period1")
    with pytest.raises(ValueError):
        jm.init_paged_pool(jcfg, 9, 16)
    with pytest.raises(ValueError):
        tm.init_paged_pool(tcfg, 9, 16, device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(tcfg, _params("period1")[1], decode_mode="paged",
                      max_seq=64, device="cpu")
