"""The dense families (gemma3-12b, gemma-7b, phi3-mini, yi-34b,
qwen1.5-32b) held against the JAX package at the structures that their
full widths give the kernels.

* Every config with attention has a plan for each kernel its serving
  path runs: its head dim among K2's (``flash_attn.HEAD_DIMS``) and K2's
  ``flash_plan`` at 8 x 2048 on its bf16 route within the H100's shared
  memory and registers, K1's ``decode_plan`` for int8 and bf16 pools at
  8 slots and mb 128 within the H100's shared memory, K3's ``ffn_plan``
  at M 8 and M 4096 within the same.  These are the host-side functions that size each launch on
  the card, so a config they refuse cannot serve there.
* K2's plain version at hd 96 (phi3-mini) against the JAX oracle and the
  Pallas kernel in interpret mode, as ``test_torch_kernels.py`` holds
  the other head dims: atol 2e-5 (f32, sums in another order).
* Three structures at a narrow width (d_model 64, vocab 300, f32
  activations), the head dims forced with ``reduced(...).with_updates``:
  hd 96 at MHA (phi3-mini's), hd 256 at group 2 over 6 layers (5 local,
  1 global) with a window of 16 that the prompts cross (gemma3-12b's),
  and group 7 (7 heads over 1 KV head, yi-34b's).  The weights are drawn
  from a numpy seed in the JAX tree's layout and carried across by
  ``repro_torch.weights``.  Prefill logits and K/V agree within 1e-4 of
  the reference's largest magnitude (the tolerance of
  ``test_torch_encdec.py``: the same f32 sums in another order); the
  paged int8 engines' greedy streams and counters are equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.kernels import flash_attention as pallas_flash
from repro.kernels import ref as jref
from repro.models import model as jm
from repro.models.runtime import RuntimeOptions as JOpts
from repro.serving import CompileCache as JCompileCache
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import BONUS_ARCHS, get_config, list_archs
from repro_torch.kernels import flash_attn, ops
from repro_torch.kernels.fused_ffn import ffn_plan
from repro_torch.kernels.paged_decode_attn import decode_plan
from repro_torch.models import model as tm
from repro_torch.models.configs import ATTN, LOCAL
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import CompileCache, Request, ServingEngine
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

H100_SMEM = 232_448          # shared memory one block may use, bytes


@pytest.mark.parametrize("arch", [a for a in list(list_archs())
                                  + list(BONUS_ARCHS)
                                  if not get_config(a).is_attention_free])
def test_every_config_has_kernel_plans(arch):
    cfg = get_config(arch)
    hd = cfg.resolved_head_dim
    assert hd in flash_attn.HEAD_DIMS, f"{arch}: K2 has no hd {hd}"
    plan = flash_attn.flash_plan(torch.bfloat16, hd, 2048, 2048,
                                 cfg.num_heads, cfg.num_kv_heads)
    assert plan.route == ("wgmma" if hd in flash_attn.WGMMA_HEAD_DIMS
                          else "mma_sync")
    assert 0 < plan.smem <= H100_SMEM and plan.regs <= 65536
    for pool in (torch.int8, torch.bfloat16):
        plan = decode_plan(8, cfg.num_heads, cfg.num_kv_heads, hd, 16, 128,
                           pool)
        assert plan.splits == 16 and 0 < plan.smem <= H100_SMEM
    for m in (8, 4096):
        plan = ffn_plan(torch.bfloat16, m, cfg.d_model, cfg.d_ff)
        assert plan.route in ("small_m", "stream", "two_pass")
        assert plan.smem <= H100_SMEM


HD96_CASES = [dict(causal=True, window=0),
              dict(causal=True, window=40, kv_len=90),
              dict(causal=False, window=0, kv_len=0)]


@pytest.mark.parametrize("case", HD96_CASES, ids=[
    "-".join(f"{k}{v}" for k, v in c.items()) for c in HD96_CASES])
def test_flash_plain_matches_jax_at_head_dim_96(case):
    s, hd = 128, 96
    rng = np.random.default_rng(96 + len(case))
    q, k, v = (rng.standard_normal((2, 2, s, hd)).astype(np.float32)
               for _ in range(3))
    out_t = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          **case).numpy()
    out_j = np.asarray(jref.flash_attn_ref(*(jnp.asarray(a)
                                             for a in (q, k, v)), **case))
    np.testing.assert_allclose(out_t, out_j, atol=2e-5, rtol=1e-4)
    out_k = np.asarray(pallas_flash(
        *(jnp.asarray(a.reshape(4, s, hd)) for a in (q, k, v)),
        block_q=32, block_k=32, interpret=True, **case)).reshape(2, 2, s, hd)
    np.testing.assert_allclose(out_t, out_k, atol=2e-5, rtol=1e-4)


NARROW = dict(d_model=64)
F32 = dict(activation_dtype="float32", vocab_size=300)
STRUCTURES = {
    "hd96": ("phi3-mini", dict(num_layers=2),
             dict(num_heads=2, num_kv_heads=2, head_dim=96)),
    "hd256_group2_local_global": (
        "gemma3-12b", dict(num_layers=6),
        dict(num_heads=4, num_kv_heads=2, head_dim=256, sliding_window=16)),
    "group7": ("yi-34b", dict(num_layers=2),
               dict(num_heads=7, num_kv_heads=1, head_dim=16)),
}
_MADE = {}


def _structure(name):
    """``(jcfg, tcfg, jax params, port params)`` of one structure: the
    weights drawn from a numpy seed, each leaf at the spread of the
    reference's own init (the zero-initialised norm offsets and biases
    at 0.1), then bridged."""
    if name not in _MADE:
        arch, red, upd = STRUCTURES[name]
        jcfg, tcfg = (get(arch).reduced(**red, **NARROW).with_updates(
            **upd, **F32) for get in (j_get_config, get_config))
        rng = np.random.default_rng(len(_MADE) + 26)

        def draw(leaf):
            a = np.asarray(leaf, np.float32)
            std = float(a.std()) or 0.1
            return (rng.standard_normal(a.shape) * std).astype(np.float32)

        jp = jax.tree_util.tree_map(
            draw, jm.init_params(jcfg, jax.random.PRNGKey(0)))
        _MADE[name] = (jcfg, tcfg, jp, params_from_numpy(jp, "cpu"))
    return _MADE[name]


def test_structures_have_the_full_widths_kernel_shapes():
    shapes = {}
    for name in STRUCTURES:
        _, cfg, _, _ = _structure(name)
        shapes[name] = (cfg.num_heads // cfg.num_kv_heads,
                        cfg.resolved_head_dim, cfg.block_pattern())
    assert shapes["hd96"] == (1, 96, (ATTN, ATTN))
    assert shapes["hd256_group2_local_global"] == (
        2, 256, (LOCAL,) * 5 + (ATTN,))
    assert shapes["group7"] == (7, 16, (ATTN, ATTN))


def _close_rel(t, j, what):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.float().numpy(), j,
                               atol=1e-4 * float(np.abs(j).max()), rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_prefill_logits_match_reference(name):
    """Model-level prefill of 2 prompts of 48 tokens (past 2 x the window
    of 16, so the local layers take ``banded`` in both packages), f32
    caches: all positions' logits and every layer's K/V."""
    jcfg, tcfg, jp, tp = _structure(name)
    s, max_seq = 48, 64
    toks = np.random.default_rng(5).integers(0, 300, (2, s)).astype(
        np.int32)
    jo, to = (opts(kv_cache_dtype="float32") for opts in (JOpts,
                                                          RuntimeOptions))

    def j_prefill(p, t):
        return jm.prefill(p, jcfg, t, jm.init_cache(jcfg, 2, max_seq, jo), jo)

    lj, cj = jax.jit(j_prefill)(jp, jnp.asarray(toks))
    lt, ct = tm.prefill(tp, tcfg, torch.from_numpy(toks),
                        tm.init_cache(tcfg, 2, max_seq, to, device="cpu"), to)
    _close_rel(lt, lj, f"{name} prefill logits")
    for leaf in ("k", "v"):
        _close_rel(ct[leaf], cj[leaf], f"{name} prefill {leaf}")


J_CC = JCompileCache()


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_paged_int8_engine_matches_reference(name):
    """Greedy streams of prompts of 9..60 tokens x 12 new tokens through
    the paged int8 engines (``paged_kernel=True``, 2 slots, max_seq 128,
    block 16): positions cross the window of 16 and block boundaries;
    streams, prefill calls and tokens out equal the JAX engine's."""
    jcfg, tcfg, jp, tp = _structure(name)
    kw = dict(slots=2, max_seq=128, block_size=16, decode_mode="paged")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 300, n).astype(np.int32)
               for n in (40, 9, 60, 20)]
    got = {}
    for port in (False, True):
        if port:
            eng = ServingEngine(tcfg, tp, opts=RuntimeOptions(
                paged_kernel=True, kv_dtype="int8"), device="cpu",
                compile_cache=CompileCache(), **kw)
        else:
            eng = JEngine(jcfg, jp, opts=JOpts(paged_kernel=True,
                                               kv_dtype="int8"),
                          compile_cache=J_CC, **kw)
        req = Request if port else JRequest
        reqs = [req(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        got[port] = ([tuple(r.generated) for r in reqs],
                     eng.stats.prefill_calls, eng.stats.tokens_out)
    assert got[True] == got[False]
    assert all(len(s) == 12 for s in got[True][0])
