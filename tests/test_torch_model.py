"""The port's model layer held against the JAX package's, on the JAX
suites' tiny ``paper-backbone`` (2 layers, d_model 64, 4 heads, 2 KV
heads, head_dim 16, d_ff 128, vocab 300) with the JAX weights brought
across by the bridge.

Tolerances: on the f32-activation variant both packages compute in f32
and differ only in the order of sums (atol 1e-4 on logits of magnitude
~1).  On the default bf16 variant the two frameworks round to bf16 at
different places; logits agree within 0.1 (bf16 keeps 8 bits of
mantissa, and the error compounds over two layers).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import _REGISTRY as J_REGISTRY
from repro.configs import get_config as j_get_config
from repro.models import layers as jl
from repro.models import model as jm
from repro.models import transformer as jt
from repro.models.configs import INPUT_SHAPES as J_SHAPES
from repro.models.runtime import RuntimeOptions as JOpts
from repro_torch.configs import _REGISTRY as T_REGISTRY
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import prng
from repro_torch.models import transformer as tt
from repro_torch.models.configs import INPUT_SHAPES as T_SHAPES
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.models.transformer import init_params as t_init_params
from repro_torch.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=300)
J_CFG = j_get_config("paper-backbone").with_updates(**TINY)
J_PARAMS = jm.init_params(J_CFG, jax.random.PRNGKey(0))
NP_PARAMS = jax.tree_util.tree_map(np.asarray, J_PARAMS)
T_PARAMS = params_from_numpy(NP_PARAMS, "cpu")
F32 = dict(activation_dtype="float32")


def _cfgs(**kw):
    return (J_CFG.with_updates(**kw),
            get_config("paper-backbone").with_updates(**TINY, **kw))


# ------------------------------------------------------------- configs ----
def test_config_registry_matches_reference():
    assert sorted(T_REGISTRY) == sorted(J_REGISTRY)
    for name, jcfg in J_REGISTRY.items():
        assert dataclasses.asdict(T_REGISTRY[name]) == dataclasses.asdict(jcfg)
        assert T_REGISTRY[name].block_pattern() == jcfg.block_pattern()
        assert T_REGISTRY[name].param_count() == jcfg.param_count()
    assert {k: dataclasses.asdict(v) for k, v in T_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert dataclasses.asdict(RuntimeOptions()) == dataclasses.asdict(JOpts())


# ---------------------------------------------------------- weights ----
def test_init_params_layout_matches_reference():
    t_params = params_to_numpy(t_init_params(
        get_config("paper-backbone").with_updates(**TINY), seed=0,
        device="cpu"))
    jflat = jax.tree_util.tree_flatten_with_path(NP_PARAMS)[0]
    tflat = jax.tree_util.tree_flatten_with_path(t_params)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_bridge_round_trip_keeps_tree_and_dtypes():
    tree = {"layers": {"ffn": {"w_up": {"u": np.ones((2, 4, 3), np.float32),
                                         "v": np.ones((2, 3, 5), np.float32)}},
                       "router": np.zeros((2, 4), np.float32)},
            "embed": np.asarray(jnp.ones((8, 4), jnp.bfloat16))}
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert back["layers"]["ffn"]["w_up"]["u"].shape == (2, 4, 3)
    cast = tl.cast_params(params_from_numpy(tree, "cpu"), torch.bfloat16)
    assert cast["layers"]["router"].dtype == torch.float32       # f32 key
    assert cast["layers"]["ffn"]["w_up"]["v"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["embed"], np.ones((8, 4)))


# -------------------------------------------------------------- layers ----
def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-5, rtol=1e-5)
    posn = np.arange(5)[None, :]
    sj, cj = jl.rotary_embedding(jnp.asarray(posn), 16)
    st, ct = tl.rotary_embedding(torch.from_numpy(posn), 16)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(
        tl.apply_rotary(torch.from_numpy(x), st, ct).numpy(),
        np.asarray(jl.apply_rotary(jnp.asarray(x), sj, cj)), atol=1e-5)
    ffn = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
           (("w_gate", (16, 32)), ("w_up", (16, 32)), ("w_down", (32, 16)))}
    for act in ("silu", "gelu"):
        np.testing.assert_allclose(
            tl.ffn_apply(params_from_numpy(ffn, "cpu"), torch.from_numpy(x),
                         gated=True, activation=act).numpy(),
            np.asarray(jl.ffn_apply(ffn, jnp.asarray(x), gated=True,
                                    activation=act)), atol=1e-5)
    lg = rng.standard_normal((3, 512)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.mask_padded_logits_raw(torch.from_numpy(lg), 300).numpy(),
        np.asarray(jl.mask_padded_logits_raw(jnp.asarray(lg), 300)))


@pytest.mark.parametrize("window", [0, 8])     # s <= 2*window: "full"
def test_transformer_block_matches_reference(window):
    jcfg, tcfg = _cfgs(**F32)
    x = np.random.default_rng(window).standard_normal((2, 16, 64))
    x = x.astype(np.float32)
    yj, _ = jt.transformer_block(
        jax.tree_util.tree_map(lambda a: a[1], J_PARAMS["layers"]),
        jnp.asarray(x), jcfg, JOpts(), window=window)
    yt, _ = tt.transformer_block(tl.layer_slice(T_PARAMS["layers"], 1),
                                 torch.from_numpy(x), tcfg, RuntimeOptions(),
                                 window=window)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)


# ------------------------------------------------------------ threefry ----
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_threefry_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    np.testing.assert_array_equal(prng.split(tkey).numpy(),
                                  np.asarray(jax.random.split(key)))
    np.testing.assert_array_equal(
        prng.random_bits(tkey, 257).numpy(),
        np.asarray(jax.random.bits(key, (257,), jnp.uint32)))
    np.testing.assert_array_equal(prng.uniform(tkey, 257).numpy(),
                                  np.asarray(jax.random.uniform(key, (257,))))
    lg = np.random.default_rng(seed % 97).standard_normal(300)
    lg = lg.astype(np.float32)
    subkeys = jax.random.split(key, 40)
    draws_j = [int(jax.random.categorical(k, jnp.asarray(lg)))
               for k in subkeys]
    draws_t = prng.categorical(
        torch.from_numpy(np.asarray(subkeys).astype(np.int64)),
        torch.from_numpy(lg)[None].expand(40, -1)).tolist()
    assert draws_t == draws_j


@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.8, 0), (1.4, 5),
                                        (0.8, 1)])
def test_sample_logits_matches_reference(temp, top_k):
    from repro.serving.sampling import request_key
    rng = np.random.default_rng(int(temp * 10) + top_k)
    logits = rng.standard_normal((4, 512)).astype(np.float32)
    keys = np.stack([request_key(5, rid) for rid in range(4)])
    j_tok, j_key = jax.vmap(
        lambda lg, k: jm.sample_logits(lg, k, jnp.float32(temp),
                                       jnp.int32(top_k), 300)
    )(jnp.asarray(logits), jnp.asarray(keys))
    t_tok, t_key = tm.sample_logits(
        torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
        torch.full((4,), temp), torch.full((4,), top_k, dtype=torch.int32),
        300)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(t_key.numpy(), np.asarray(j_key))


# ------------------------------------------------------ prefill + step ----
@pytest.mark.parametrize("variant,atol", [(F32, 1e-4), ({}, 0.1)],
                         ids=["f32", "bf16"])
def test_prefill_logits_match_reference(variant, atol):
    jcfg, tcfg = _cfgs(**variant)
    toks = np.random.default_rng(3).integers(0, 300, (2, 32)).astype(np.int32)
    opts = JOpts(kv_cache_dtype="float32")
    j_logits, j_cache = jm.prefill(J_PARAMS, jcfg, jnp.asarray(toks),
                                   jm.init_cache(jcfg, 2, 48, opts), opts)
    t_logits, t_cache = tm.prefill(
        T_PARAMS, tcfg, torch.from_numpy(toks),
        tm.init_cache(tcfg, 2, 48, RuntimeOptions(kv_cache_dtype="float32"),
                      device="cpu"),
        RuntimeOptions(kv_cache_dtype="float32"))
    np.testing.assert_allclose(t_logits.float().numpy(),
                               np.asarray(j_logits, np.float32), atol=atol)
    np.testing.assert_allclose(t_cache["k"].numpy(), np.asarray(j_cache["k"]),
                               atol=atol)
    assert int(t_cache["pos"]) == int(j_cache["pos"]) == 32


def _admit_and_step(kv_dtype, rows_to_step=1):
    """Prefill two prompts into a paged pool and take one kernel step in
    both packages (f32 activations); returns both sides' outputs."""
    jcfg, tcfg = _cfgs(**F32)
    slots, max_seq, bs, nb = 2, 64, 8, 17
    jopts = JOpts(paged_kernel=True, kv_dtype=kv_dtype,
                  kv_cache_dtype="float32")
    topts = RuntimeOptions(paged_kernel=True, kv_dtype=kv_dtype,
                           kv_cache_dtype="float32")
    toks = np.random.default_rng(9).integers(0, 300, (2, 16)).astype(np.int32)
    slot_ids = np.array([0, 1], np.int32)
    keys = np.stack([np.array([3, 4], np.uint32), np.array([5, 6], np.uint32)])
    temps = np.array([0.0, 0.9], np.float32)
    top_ks = np.zeros(2, np.int32)
    dest = np.array([[1, 2], [3, 4]], np.int32)
    tables = np.zeros((slots, max_seq // bs), np.int32)
    tables[0, :3], tables[1, :3] = [1, 2, 5], [3, 4, 6]

    jpool = jm.init_paged_pool(jcfg, nb, bs, jopts)
    jslot = jm.init_paged_slot_cache(jcfg, slots, max_seq, jopts)
    jfirst, jlast, jslot, jpool = jm.paged_prefill_admit(
        J_PARAMS, jcfg, jslot, jpool, jnp.asarray(toks),
        jnp.asarray(slot_ids), jnp.asarray(keys), jnp.asarray(temps),
        jnp.asarray(top_ks), jnp.asarray(dest), jopts)
    jnxt, jpos, jslot, jpool = jm.paged_kernel_sample_batched_step(
        J_PARAMS, jcfg, jslot, jpool, jfirst, jnp.asarray(tables), jopts)

    tpool = tm.init_paged_pool(tcfg, nb, bs, topts, device="cpu")
    tslot = tm.init_paged_slot_cache(tcfg, slots, max_seq, topts,
                                     device="cpu")
    tfirst, tlast, tslot, tpool = tm.paged_prefill_admit(
        T_PARAMS, tcfg, tslot, tpool, torch.from_numpy(toks),
        torch.from_numpy(slot_ids), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(temps), torch.from_numpy(top_ks),
        torch.from_numpy(dest), topts)
    tnxt, tpos, tslot, tpool = tm.paged_kernel_sample_batched_step(
        T_PARAMS, tcfg, tslot, tpool, tfirst, torch.from_numpy(tables), topts)
    return ((jfirst, jlast, jnxt, jpos, jslot, jpool),
            (tfirst, tlast, tnxt, tpos, tslot, tpool))


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_paged_prefill_and_kernel_step_match_reference(kv_dtype):
    (jf, jl_, jn, jp, js, jpool), (tf, tl_, tn, tp, ts, tpool) = \
        _admit_and_step(kv_dtype)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), atol=1e-4)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts["sample"]["key"].numpy(),
                                  np.asarray(js["sample"]["key"]))
    for name in jpool:
        a, b = tpool[name].float().numpy(), np.asarray(jpool[name], np.float32)
        if name in ("k", "v") and kv_dtype == "int8":
            # codes of values within an ulp of a rounding boundary may
            # differ by one step
            assert np.abs(a - b).max() <= 1
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5)


def test_paged_copy_block_copies_every_leaf():
    tcfg = _cfgs(**F32)[1]
    pool = tm.init_paged_pool(tcfg, 4, 4, RuntimeOptions(kv_dtype="int8"),
                              device="cpu")
    for arr in pool.values():
        arr[1] = 3
    tm.paged_copy_block(pool, 1, 2)
    for arr in pool.values():
        assert bool((arr[2] == 3).all()) and bool((arr[3] == 0).all())


def test_not_ported_families_raise():
    with pytest.raises(NotImplementedError):
        tm.init_cache(get_config("zamba2-1.2b"), 1, 16, device="cpu")
    with pytest.raises(NotImplementedError):
        t_init_params(get_config("whisper-small").reduced(), device="cpu")


# ----------------------------------------------- chunked / long prefill ----
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_chunked_attention_matches_reference(causal, window):
    """Several query and KV chunks (q_chunk 64, k_chunk 128 over S 256),
    GQA 4/2: the same online softmax in both packages, f32."""
    from repro.models.attention import chunked_attention as j_chunked
    from repro_torch.models.attention import chunked_attention
    rng = np.random.default_rng(11 + window)
    q = rng.standard_normal((2, 256, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 256, 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_chunk=64, k_chunk=128)
    out_t = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              **kw)
    out_j = j_chunked(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)


@pytest.mark.parametrize("bucket", [1024, 2048])
def test_long_prefill_matches_reference(bucket):
    """A prompt at bucket 1024 (JAX picks ``full``) and 2048 (JAX picks
    ``chunked``, q_chunk 512 / k_chunk 1024), f32 activations: logits,
    K and V of the port's prefill equal the JAX package's within the
    f32 tolerance of the other prefill tests (sums in another order)."""
    jcfg, tcfg = _cfgs(**F32)
    assert tt._select_impl(tcfg, RuntimeOptions(), bucket, 0) == \
        jt._select_impl(jcfg, JOpts(), bucket, 0) == \
        ("full" if bucket == 1024 else "chunked")
    toks = np.random.default_rng(bucket).integers(0, 300, (1, bucket))
    toks = toks.astype(np.int32)
    opts = JOpts(kv_cache_dtype="float32")
    topts = RuntimeOptions(kv_cache_dtype="float32")
    j_logits, j_cache = jax.jit(
        lambda t: jm.prefill(J_PARAMS, jcfg, t,
                             jm.init_cache(jcfg, 1, bucket, opts), opts)
    )(jnp.asarray(toks))
    t_logits, t_cache = tm.prefill(
        T_PARAMS, tcfg, torch.from_numpy(toks),
        tm.init_cache(tcfg, 1, bucket, topts, device="cpu"), topts)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache[name].numpy(),
                                   np.asarray(j_cache[name]), atol=1e-4)
