"""The port's encoder-decoder (Whisper) and VLM stub (InternVL2) held
against the JAX package's, with the JAX weights brought across by the
bridge.

Configs: ``whisper-small.reduced(d_model=64)`` (2 encoder and 2 decoder
layers, 2 heads of 32, a non-gated gelu FFN of 256, 64 encoder frames,
vocab 1024) and ``internvl2-26b.reduced(d_model=64)`` (2 layers, 2
heads of 32, a gated silu FFN of 192, a vision projection from 128 to
64 over 4 patch positions), both with f32 activations.  Frames and patch
embeddings are drawn as ``test_arch_smoke.py`` draws them (std normal x
0.1), from a numpy seed.

K2's plain version at a key length apart from the query length (a
cross-attention's) is held against JAX ``full_attention(causal=False)``
and its backward against autograd in f64.

Tolerances (those of ``test_torch_hybrid.py``): with f32 activations
and caches both packages compute the same sums in another order, so
every f32 quantity (logits, cache leaves, gradients, adapted norm
scales) agrees within 1e-4 of the reference's largest magnitude.  The
engines' greedy and sampled streams and counters are equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.elastic import tta as j_tta
from repro.models import attention as j_attn
from repro.models import model as jm
from repro.models import transformer as jt
from repro.models.runtime import RuntimeOptions as JOpts
from repro.serving import CompileCache as JCompileCache
from repro.serving import Request as JRequest
from repro.serving import SamplingOpts as JSampling
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.elastic import tta as t_tta
from repro_torch.kernels.flash_attn import (flash_attention,
                                            flash_attention_backward)
from repro_torch.kernels.ref import flash_attn_ref
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import (CompileCache, Request, SamplingOpts,
                                 ServingEngine)
from repro_torch.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

WHISPER, VLM = "whisper-small", "internvl2-26b"
F32 = dict(activation_dtype="float32")
F32_CACHE = dict(kv_cache_dtype="float32")


def _cfgs(name, **kw):
    return tuple(get(name).reduced(d_model=64).with_updates(**F32, **kw)
                 for get in (j_get_config, get_config))


_PARAMS = {}


def _params(name):
    """JAX weights of seed 0 and their bridge, one set per config."""
    if name not in _PARAMS:
        jcfg, _ = _cfgs(name)
        jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
        _PARAMS[name] = (jp, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return _PARAMS[name]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close_rel(t, j, rel=1e-4, what=""):
    """Within ``rel`` of the reference's largest magnitude."""
    j = _np(j)
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(_np(t), j, atol=rel * scale + 1e-12,
                               rtol=0, err_msg=what)


def _inputs(cfg, batch, seq, seed):
    """Tokens and the family's stub inputs (``encoder_frames`` or
    ``vision_embeds``) as numpy arrays."""
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


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


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


# ------------------------------------------------- K2 at sq != sk ----
@pytest.mark.parametrize("h,kvh,sq,sk", [(4, 2, 5, 37), (4, 4, 16, 64),
                                         (6, 2, 33, 7)])
def test_flash_plain_cross_lengths_match_reference(h, kvh, sq, sk):
    """K2's plain version (its CPU path) with ``sq`` queries over ``sk``
    keys, non-causal, GQA, f32: JAX ``full_attention(causal=False)``."""
    rng = np.random.default_rng(sq * sk)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, kvh, 16)).astype(np.float32)
            for _ in range(2))
    out = flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                            for a in (q, k, v)), causal=False)
    ref = j_attn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref),
                               atol=1e-5)


def test_flash_backward_cross_lengths_match_autograd():
    """K2's analytic backward at sq 9 over sk 40 (GQA 4/2, a kv_len
    mask) against autograd through the plain version, f64."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, 9, 16, generator=g, dtype=torch.float64)
    k = torch.randn(2, 2, 40, 16, generator=g, dtype=torch.float64)
    v = torch.randn(2, 2, 40, 16, generator=g, dtype=torch.float64)
    dout = torch.randn(2, 4, 9, 16, generator=g, dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attn_ref(leaves[0], leaves[1].repeat_interleave(2, 1),
                         leaves[2].repeat_interleave(2, 1), causal=False,
                         kv_len=31)
    out.backward(dout)
    got = flash_attention_backward(q, k, v, out.detach(), dout,
                                   causal=False, kv_len=31)
    for a, b in zip(got, leaves):
        torch.testing.assert_close(a, b.grad, atol=1e-10, rtol=1e-9)


def test_flash_refuses_causal_or_window_at_unequal_lengths():
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(1, 2, 9, 16)
    for mask in (dict(causal=True), dict(causal=False, window=3)):
        with pytest.raises(ValueError):
            flash_attention(q, k, k, **mask)
        with pytest.raises(ValueError):
            flash_attn_ref(q, k, k, **mask)
    assert flash_attention(q, k, k, causal=False).shape == q.shape


# ---------------------------------------------- layout, bridge -------
@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_init_params_and_caches_match_reference_layout(name):
    """``init_params`` has the JAX tree (paths, shapes, dtypes: the
    encoder stack, ``encoder_norm``, the decoder's ``cross`` and
    ``ln_cross``; ``vision_proj``), ``init_cache`` and
    ``init_paged_slot_cache`` the JAX caches (the cross K/V leaves)."""
    jcfg, tcfg = _cfgs(name)
    jp = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_to_numpy(tt.init_params(tcfg, device="cpu"))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    if name == WHISPER:
        assert {"encoder", "encoder_norm"} <= set(tp)
        assert {"cross", "ln_cross"} <= set(tp["layers"])
        assert "cross" not in tp["encoder"]
    else:
        assert set(tp["vision_proj"]) == {"w", "b"}
        assert "cross" not in tp["layers"]
    for make_j, make_t in (
            (lambda: jm.init_cache(jcfg, 2, 24),
             lambda: tm.init_cache(tcfg, 2, 24, device="cpu")),
            (lambda: jm.init_paged_slot_cache(jcfg, 3, 32),
             lambda: tm.init_paged_slot_cache(tcfg, 3, 32, device="cpu"))):
        jc, tc = make_j(), make_t()
        assert set(tc) == set(jc)
        for key in jc:
            if key != "sample":
                assert tuple(tc[key].shape) == jc[key].shape, key
    assert ("cross_k" in tc) == (name == WHISPER)


@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_weights_bridge_carries_the_new_leaves(name):
    """``params_from_numpy`` / ``params_to_numpy`` carry ``encoder``,
    ``encoder_norm``, ``layers/cross``, ``layers/ln_cross`` and
    ``vision_proj`` bit for bit."""
    jp, tp = _params(name)
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jp))
    back = _flat(params_to_numpy(tp))
    assert sorted(back) == sorted(jflat)
    for key, a in jflat.items():
        assert back[key].dtype == a.dtype and np.array_equal(back[key], a)
    want = ({"encoder/attn/wq", "encoder_norm", "layers/cross/wk",
             "layers/ln_cross"} if name == WHISPER
            else {"vision_proj/w", "vision_proj/b"})
    assert want <= set(back)


# --------------------------------------------------- blocks, forward --
def test_transformer_block_cross_src_matches_reference():
    """One decoder block over an encoder output (12 queries, 64 frames):
    self-attention, ``ln_cross`` and the non-causal cross-attention,
    then the FFN."""
    jcfg, tcfg = _cfgs(WHISPER)
    jp, tp = _params(WHISPER)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    src = rng.standard_normal((2, 64, 64)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    tl = {k: ({kk: vv[1] for kk, vv in v.items()} if isinstance(v, dict)
              else v[1]) for k, v in tp["layers"].items()}
    yj, _ = jax.jit(lambda l, x, s: jt.transformer_block(
        l, x, jcfg, JOpts(), window=0, cross_src=s))(
        jl, jnp.asarray(x), jnp.asarray(src))
    yt, _ = tt.transformer_block(tl, torch.from_numpy(x), tcfg,
                                 RuntimeOptions(), window=0,
                                 cross_src=torch.from_numpy(src))
    _close_rel(yt, yj)
    y0, _ = tt.transformer_block(tl, torch.from_numpy(x), tcfg,
                                 RuntimeOptions(), window=0)
    assert not torch.allclose(y0, yt)


J_FORWARD = jax.jit(jt.forward, static_argnums=(1, 3))


@pytest.mark.parametrize("name,stub", [(WHISPER, True), (WHISPER, False),
                                       (VLM, True), (VLM, False)])
def test_forward_matches_reference(name, stub):
    """Logits of ``forward`` with and without the stub inputs: whisper's
    encoder over its frames (the cross blocks then run), internvl2's
    projected patch embeddings in the first 4 positions."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    toks, kw = _inputs(tcfg, 2, 12, 0)
    kw = kw if stub else {}
    lj, _ = J_FORWARD(jp, jcfg, jnp.asarray(toks), JOpts(), **_j(kw))
    lt, aux = tt.forward(tp, tcfg, torch.from_numpy(toks), **_t(kw))
    assert lt.shape == (2, 12, tcfg.padded_vocab) and float(aux) == 0.0
    _close_rel(lt, lj)


@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_prefill_and_decode_steps_match_reference(name):
    """A prefill of 2 prompts of 10 tokens into a 24-row cache with the
    stub inputs (f32 caches), then three greedy decode steps on the
    reference's tokens: logits and every cache leaf after each (the
    cross K/V captured once by the prefill, unchanged by decode)."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    jo, to = JOpts(**F32_CACHE), RuntimeOptions(**F32_CACHE)
    toks, kw = _inputs(tcfg, 2, 10, 1)

    def j_steps(p, t, kw):
        lg, cache = jm.prefill(p, jcfg, t, jm.init_cache(jcfg, 2, 24, jo),
                               jo, **kw)
        out = [(lg, dict(cache))]
        tok = t[:, -1]
        for _ in range(3):
            lg, cache = jm.decode_step(p, jcfg, cache, tok, jo)
            out.append((lg, dict(cache)))
            tok = jnp.argmax(lg[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        return out

    j_out = jax.jit(j_steps)(jp, jnp.asarray(toks), _j(kw))
    cache = tm.init_cache(tcfg, 2, 24, to, device="cpu")
    lt, cache = tm.prefill(tp, tcfg, torch.from_numpy(toks), cache, to,
                           **_t(kw))
    for i, (lj, jc) in enumerate(j_out):
        if i:
            tok = (toks[:, -1] if i == 1 else np.array(jnp.argmax(
                j_out[i - 1][0][:, :jcfg.vocab_size], -1), np.int32))
            lt, cache = tm.decode_step(tp, tcfg, cache,
                                       torch.from_numpy(tok), to)
        _close_rel(lt, lj, what=f"logits after step {i}")
        assert set(cache) == set(jc)
        assert int(cache["pos"]) == int(jc["pos"]) == 10 + i
        for key in jc:
            if key != "pos":
                assert cache[key].dtype == torch.float32, key
                _close_rel(cache[key], jc[key], what=f"{key} after {i}")
    if name == WHISPER:
        assert bool(cache["cross_k"].any()) and bool(cache["cross_v"].any())


def _vlm_structure_cfgs():
    """internvl2-26b at depth 2 with its widths cut as far as its
    structure allows: group 6 (6 heads of 128 over 1 KV head), hd 128,
    d_model = heads x hd as published, F / D = 8 / 3 as published, and
    256 patch positions (their width cut to 256, the vocabulary to
    1024)."""
    kw = dict(num_layers=2, d_model=768, num_heads=6, num_kv_heads=1,
              head_dim=128, d_ff=2048, vocab_size=1024,
              vision_embed_dim=256, **F32)
    return tuple(get(VLM).with_updates(**kw)
                 for get in (j_get_config, get_config))


def test_vlm_at_internvl2_structure_matches_reference():
    """The CPU twin of the card's full-width depth-2 check: a prefill of
    2 prompts of 256 patch embeddings and 16 text tokens (f32 caches),
    then four greedy decode steps; logits and the K/V cache after each,
    and the greedy streams, equal the JAX package's."""
    jcfg, tcfg = _vlm_structure_cfgs()
    assert (tcfg.num_heads // tcfg.num_kv_heads, tcfg.resolved_head_dim,
            tcfg.num_vision_tokens) == (6, 128, 256)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jo, to = JOpts(**F32_CACHE), RuntimeOptions(**F32_CACHE)
    s, steps = tcfg.num_vision_tokens + 16, 4
    toks, kw = _inputs(tcfg, 2, s, 11)

    def j_steps(p, t, kw):
        lg, cache = jm.prefill(p, jcfg, t, jm.init_cache(
            jcfg, 2, s + steps, jo), jo, **kw)
        out = [(lg[:, -1], cache["k"], cache["v"])]
        tok = jnp.argmax(lg[:, -1, :jcfg.vocab_size], -1).astype(jnp.int32)
        for _ in range(steps):
            lg, cache = jm.decode_step(p, jcfg, cache, tok, jo)
            out.append((lg, cache["k"], cache["v"]))
            tok = jnp.argmax(lg[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        return out

    j_out = jax.jit(j_steps)(jp, jnp.asarray(toks), _j(kw))
    cache = tm.init_cache(tcfg, 2, s + steps, to, device="cpu")
    lt, cache = tm.prefill(tp, tcfg, torch.from_numpy(toks), cache, to,
                           **_t(kw))
    lt = lt[:, -1]
    for i, (lj, kj, vj) in enumerate(j_out):
        if i:
            lt, cache = tm.decode_step(tp, tcfg, cache, tok, to)
        _close_rel(lt, lj, what=f"logits after step {i}")
        _close_rel(cache["k"], kj, what=f"k after step {i}")
        _close_rel(cache["v"], vj, what=f"v after step {i}")
        tok = torch.argmax(lt[:, :tcfg.vocab_size], -1).to(torch.int32)
        assert tok.tolist() == np.asarray(jnp.argmax(
            lj[:, :jcfg.vocab_size], -1)).tolist()
    assert int(cache["pos"]) == s + steps


@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_train_step_grads_match_reference(name):
    """``lm_loss`` through ``forward`` with the stub inputs and its
    gradients by autograd against ``jax.value_and_grad``, leaf by leaf:
    the encoder's, ``encoder_norm``'s and the cross blocks' leaves
    (whisper) and ``vision_proj``'s (internvl2) are nonzero."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    toks, kw = _inputs(tcfg, 2, 12, 2)
    labels = np.roll(toks, -1, axis=1)

    def j_loss(p):
        logits, _ = jt.forward(p, jcfg, jnp.asarray(toks), **_j(kw))
        return jt.lm_loss(logits, jnp.asarray(labels))

    lj, gj = jax.jit(jax.value_and_grad(j_loss))(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in
              _flat(tp).items()}
    logits, _ = tt.forward(_unflat(leaves), tcfg, torch.from_numpy(toks),
                           **_t(kw))
    lt = tt.lm_loss(logits, torch.from_numpy(labels))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    gj = _flat(jax.tree_util.tree_map(np.asarray, gj))
    assert sorted(gj) == sorted(leaves)
    for key, g in gj.items():
        gt = leaves[key].grad
        assert gt is not None and bool(torch.isfinite(gt).all()), key
        _close_rel(gt, g, what=key)
    new = (("encoder/ffn/w_up", "encoder_norm", "layers/cross/wk",
            "layers/ln_cross") if name == WHISPER else ("vision_proj/w",))
    for key in new:
        assert float(np.abs(gj[key]).max()) > 0, key


def test_tta_step_adapts_the_cross_norms_as_reference():
    """A TTA step on reduced whisper with frames: the norm scales
    ``NORM_KEYS`` names (``ln_cross`` and ``encoder_norm`` among them)
    move as the JAX package moves them, and nothing else does."""
    jcfg, tcfg = _cfgs(WHISPER)
    jp, tp = _params(WHISPER)
    toks, kw = _inputs(tcfg, 2, 12, 4)
    jnew, jobj = jax.jit(lambda p, t, kw: j_tta.tta_step(
        p, jcfg, t, lr=0.05, **kw))(jp, jnp.asarray(toks), _j(kw))
    tnew, tobj = t_tta.tta_step(tp, tcfg, torch.from_numpy(toks), lr=0.05,
                                **_t(kw))
    np.testing.assert_allclose(float(tobj), float(jobj), rtol=1e-5)
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jnew))
    tflat, before = _flat(tnew), _flat(tp)
    assert sorted(jflat) == sorted(tflat)
    for key in ("layers/ln_cross", "encoder_norm", "encoder/ln1"):
        assert not torch.equal(tflat[key], before[key]), key
    for key, a in jflat.items():
        if key in before and not any(
                n in key.split("/") for n in t_tta.NORM_KEYS):
            assert tflat[key] is before[key], key
        _close_rel(tflat[key] - before.get(key, 0), a - np.asarray(
            before[key]) if key in before else a, what=key)


# ----------------------------------------------------------- engines --
MIX = [(5, 6, 0, 0.0), (20, 6, 1, 0.8), (33, 5, 2, 1.4), (9, 4, 2, 0.0)]
COUNTERS = ("steps", "tokens_out", "prefills", "prefill_calls",
            "sampled_tokens", "freezes", "thaws", "requeues")
MODES = {"batched": dict(decode_mode="batched"),
         "per_slot": dict(decode_mode="per_slot"),
         "paged": dict(decode_mode="paged",
                       opts=dict(paged_kernel=True, kv_dtype="int8"))}
_ENGINE_CC = {}


def _engine(port, name, mode, slots=2):
    kw = dict(MODES[mode])
    opts = kw.pop("opts", {})
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    if port:
        return ServingEngine(tcfg, tp, slots=slots, max_seq=64,
                             compile_cache=CompileCache(), device="cpu",
                             opts=RuntimeOptions(**opts), **kw)
    cc = _ENGINE_CC.setdefault((name, mode), JCompileCache())
    return JEngine(jcfg, jp, slots=slots, max_seq=64, compile_cache=cc,
                   opts=JOpts(**opts), **kw)


def _requests(port, mix, vocab=1024, rid_base=0):
    req_t, samp_t = (Request, SamplingOpts) if port else (JRequest,
                                                          JSampling)
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


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_engine_streams_match_reference(name, mode):
    """Staggered admits, shared buckets and sampled requests through each
    decode mode (``paged`` with the block-table step over an int8 pool):
    the streams and counters equal the JAX engine's.  The engines serve
    whisper as the JAX engine does, with no frames (zero cross K/V)."""
    runs = []
    for port in (False, True):
        eng = _engine(port, name, mode)
        runs.append((_drive(eng, _requests(port, MIX), MIX),
                     {c: getattr(eng.stats, c) for c in COUNTERS}))
    assert runs[1] == runs[0]


def _blob_shapes(frozen):
    return {name: tuple(v.shape) for name, v in frozen.leaves.items()}


@pytest.mark.parametrize("mode", ["batched", "paged"])
def test_frozen_slot_carries_cross_leaves_and_thaws_exactly(mode):
    """A frozen whisper slot's blob holds ``cross_k``/``cross_v`` whole
    (every encoder frame, not trimmed to ``pos``), leaf for leaf the
    JAX engine's shapes; thawed on the same engine the streams equal the
    uninterrupted run's and the JAX engine's, with no prefill call."""
    mix = [(9, 7, 0, 1.2), (25, 7, 0, 0.0)]
    baseline = _drive(_engine(True, WHISPER, mode), _requests(True, mix),
                      mix)
    _, tcfg = _cfgs(WHISPER)
    runs = []
    for port in (False, True):
        eng = _engine(port, WHISPER, mode)
        reqs = _requests(port, mix)
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        calls = eng.stats.prefill_calls
        moved = eng.freeze_all("migrate")
        shapes = [_blob_shapes(r.frozen) for r in moved]
        for r in moved:
            assert tuple(r.frozen.leaves["cross_k"].shape) == (
                tcfg.num_layers, 1, tcfg.encoder_seq_len,
                tcfg.num_kv_heads, tcfg.resolved_head_dim)
            assert eng.thaw(r)
        eng.drain()
        assert eng.stats.prefill_calls == calls
        runs.append(([tuple(r.generated) for r in reqs], shapes,
                     eng.stats.freezes, eng.stats.thaws))
    assert runs[1] == runs[0]
    assert runs[1][0] == baseline
    assert runs[1][2] == runs[1][3] == 2


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("mode", ["batched", "paged"])
def test_cross_leaves_stay_in_place(mode):
    """A CUDA graph replays fixed addresses, so admission, decode steps,
    a freeze and a thaw write the slot cache's cross K/V in place: the
    leaves keep their tensors and ``data_ptr()``s, and a slot written by
    a thaw holds the frozen blob's cross K/V."""
    eng = _engine(True, WHISPER, mode)
    before = {k: (v, v.data_ptr()) for k, v in _leaves(eng._cache)}
    assert {"cross_k", "cross_v"} <= set(before)
    mix = [(9, 8, 0, 0.0), (20, 8, 0, 0.7)]
    reqs = _requests(True, mix)
    for r in reqs:
        eng.submit(r)
    for _ in range(2):
        eng.step()
    # a thaw writes a blob's leaves into the captured storage: put
    # recognisable cross K/V into the blob and find them in the slot
    moved = eng.freeze(reqs[0].rid)
    for key in ("cross_k", "cross_v"):
        moved.frozen.leaves[key] = torch.full_like(
            moved.frozen.leaves[key], 0.25)
    assert eng.thaw(moved)
    eng.step()
    after = dict(_leaves(eng._cache))
    for k, (leaf, ptr) in before.items():
        assert after[k] is leaf and leaf.data_ptr() == ptr, k
    slot = eng._active.index(reqs[0])
    assert bool((eng._cache["cross_k"][slot] == 0.25).all())
    assert not bool(eng._cache["cross_k"][1 - slot].any())


def test_paged_kernel_step_reads_cross_leaves_as_reference():
    """The block-table step over slot cross K/V taken from a prefill with
    frames (not the engine's zeros; the pool's self K/V from the
    engine's admission, without frames): greedy tokens of four steps
    equal the JAX package's ``paged_kernel_sample_batched_step`` on the
    same state, and the port's dense ``decode_step`` on it."""
    jcfg, tcfg = _cfgs(WHISPER)
    jp, tp = _params(WHISPER)
    toks, kw = _inputs(tcfg, 2, 16, 6)
    bs, nb = 16, 9
    jo = JOpts(paged_kernel=True, **F32_CACHE)
    to = RuntimeOptions(paged_kernel=True, **F32_CACHE)
    dest = np.array([[1], [2]], np.int32)
    tables = np.zeros((2, 4), np.int32)
    tables[:, 0] = dest[:, 0]
    tables[:, 1] = [3, 4]
    zeros = dict(keys=np.zeros((2, 2), np.uint32),
                 temps=np.zeros(2, np.float32), top_ks=np.zeros(2, np.int32))

    def j_run(p, t, frames):
        cache = jm.init_cache(jcfg, 2, 16, jo)
        _, cache = jm.prefill(p, jcfg, t, cache, jo, encoder_frames=frames)
        sc = jm.init_paged_slot_cache(jcfg, 2, 64, jo)
        pool = jm.init_paged_pool(jcfg, nb, bs, jo)
        _, _, sc, pool = jm.paged_prefill_admit(
            p, jcfg, sc, pool, t, jnp.arange(2), jnp.asarray(zeros["keys"]),
            jnp.asarray(zeros["temps"]), jnp.asarray(zeros["top_ks"]),
            jnp.asarray(dest), jo)
        sc = dict(sc, cross_k=jnp.moveaxis(cache["cross_k"], 1, 0)[:, :, None],
                  cross_v=jnp.moveaxis(cache["cross_v"], 1, 0)[:, :, None])
        tok, out = t[:, -1], []
        for _ in range(4):
            tok, _, sc, pool = jm.paged_kernel_sample_batched_step(
                p, jcfg, sc, pool, tok, jnp.asarray(tables), jo)
            out.append(tok)
        return jnp.stack(out, 1)

    j_toks = np.asarray(jax.jit(j_run)(jp, jnp.asarray(toks),
                                       jnp.asarray(kw["encoder_frames"])))
    tt_toks = torch.from_numpy(toks)
    cache = tm.init_cache(tcfg, 2, 16, to, device="cpu")
    _, cache = tm.prefill(tp, tcfg, tt_toks, cache, to, **_t(kw))
    sc = tm.init_paged_slot_cache(tcfg, 2, 64, to, device="cpu")
    pool = tm.init_paged_pool(tcfg, nb, bs, to, device="cpu")
    tm.paged_prefill_admit(
        tp, tcfg, sc, pool, tt_toks, torch.arange(2),
        torch.zeros((2, 2), dtype=torch.int64), torch.zeros(2),
        torch.zeros(2, dtype=torch.int32), torch.from_numpy(dest), to)
    sc["cross_k"].copy_(cache["cross_k"].transpose(0, 1)[:, :, None])
    sc["cross_v"].copy_(cache["cross_v"].transpose(0, 1)[:, :, None])
    tok, out = tt_toks[:, -1], []
    for _ in range(4):
        tok, _, _, _ = tm.paged_kernel_sample_batched_step(
            tp, tcfg, sc, pool, tok, torch.from_numpy(tables), to)
        out.append(tok)
    p_toks = torch.stack(out, 1).numpy()
    np.testing.assert_array_equal(p_toks, j_toks)
    # the same state dense: self K/V of a prefill without frames (as the
    # admission's), cross K/V of the prefill with them
    tok, dense = tt_toks[:, -1], []
    crossed = cache
    _, cache = tm.prefill(tp, tcfg, tt_toks,
                          tm.init_cache(tcfg, 2, 64, to, device="cpu"), to)
    cache["cross_k"], cache["cross_v"] = crossed["cross_k"], crossed["cross_v"]
    for _ in range(4):
        lg, cache = tm.decode_step(tp, tcfg, cache, tok, to)
        tok = torch.argmax(lg[:, :tcfg.vocab_size], -1).to(torch.int32)
        dense.append(tok)
    np.testing.assert_array_equal(p_toks, torch.stack(dense, 1).numpy())
