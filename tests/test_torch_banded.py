"""The port's ``banded`` attention held against the JAX package's.

``banded`` is what the JAX package picks for a sliding-window layer over
a prompt longer than twice the window.  Held here on the CPU:

* ``attention.banded_attention`` against JAX ``banded_attention`` over
  windows and query chunks (f32, sums in another order: atol 1e-5);
* the reduced ``gemma3-12b`` (all local layers, window 64) with the JAX
  weights brought across: prefill at bucket 256 (``banded``) and one
  decode step, f32 activations (atol 1e-4, as the other prefill tests);
* greedy streams and counters of the batched and paged engines against
  the JAX engine, with prompts that cross twice the window.

On the card ``banded`` runs the flash kernel with the causal and window
masks (``chip_smoke.py`` phase 5 holds the reduced gemma3 card == CPU).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import model as jm
from repro.models.attention import banded_attention as j_banded
from repro.models.runtime import RuntimeOptions as JOpts
from repro.serving import CompileCache as JCompileCache
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.models.configs import LOCAL
from repro_torch.models.attention import banded_attention
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import CompileCache, Request, ServingEngine
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

KW = dict(activation_dtype="float32", vocab_size=300)
J_CFG = j_get_config("gemma3-12b").reduced(d_model=64).with_updates(**KW)
T_CFG = get_config("gemma3-12b").reduced(d_model=64).with_updates(**KW)
J_PARAMS = jm.init_params(J_CFG, jax.random.PRNGKey(2))
T_PARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, J_PARAMS),
                             "cpu")
WINDOW = T_CFG.sliding_window


@pytest.mark.parametrize("s,window,q_chunk", [(64, 8, 16), (96, 16, 32),
                                              (128, 40, 64), (256, 64, 512),
                                              (200, 1, 40)])
def test_banded_attention_matches_reference(s, window, q_chunk):
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, 2, 16)).astype(np.float32)
            for _ in range(2))
    out_t = banded_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             window=window, q_chunk=q_chunk)
    out_j = j_banded(*(jnp.asarray(a) for a in (q, k, v)), window=window,
                     q_chunk=q_chunk)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)


def test_reduced_gemma3_prefill_and_decode_match_reference():
    """Bucket 256 > 2 x window: both packages pick ``banded``; logits and
    caches after the prefill and after one decode step agree."""
    bucket = 256
    assert T_CFG.block_pattern() == J_CFG.block_pattern() == (LOCAL, LOCAL)
    assert tt._select_impl(T_CFG, RuntimeOptions(), bucket, WINDOW) == \
        "banded"
    toks = np.random.default_rng(4).integers(0, 300, (2, bucket))
    toks = toks.astype(np.int32)
    jopts = JOpts(kv_cache_dtype="float32")
    topts = RuntimeOptions(kv_cache_dtype="float32")
    j_logits, j_cache = jm.prefill(J_PARAMS, J_CFG, jnp.asarray(toks),
                                   jm.init_cache(J_CFG, 2, 320, jopts), jopts)
    t_logits, t_cache = tm.prefill(
        T_PARAMS, T_CFG, torch.from_numpy(toks),
        tm.init_cache(T_CFG, 2, 320, topts, device="cpu"), topts)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4)
    nxt = np.asarray(j_logits)[:, -1, :300].argmax(-1).astype(np.int32)
    j_step, j_cache = jm.decode_step(J_PARAMS, J_CFG, j_cache,
                                     jnp.asarray(nxt), jopts)
    t_step, t_cache = tm.decode_step(T_PARAMS, T_CFG, t_cache,
                                     torch.from_numpy(nxt), topts)
    np.testing.assert_allclose(t_step.numpy(), np.asarray(j_step), atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache[name].numpy(),
                                   np.asarray(j_cache[name]), atol=1e-4)


J_CC = JCompileCache()


@pytest.mark.parametrize("mode", ["batched", "paged"])
def test_reduced_gemma3_engines_match_reference(mode):
    """Greedy streams of prompts of 20..200 tokens (buckets 32 and 256:
    ``full`` and ``banded``) and the engine counters equal the JAX
    engine's."""
    kw = dict(slots=2, max_seq=512, decode_mode=mode)
    if mode == "paged":
        kw.update(block_size=16)
    jopts = JOpts(paged_kernel=mode == "paged")
    topts = RuntimeOptions(paged_kernel=mode == "paged")
    lens = (200, 20, 150)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 300, n).astype(np.int32) for n in lens]
    streams = {}
    for port in (False, True):
        eng = (ServingEngine(T_CFG, T_PARAMS, opts=topts, device="cpu",
                             compile_cache=CompileCache(), **kw) if port else
               JEngine(J_CFG, J_PARAMS, opts=jopts, compile_cache=J_CC, **kw))
        req = Request if port else JRequest
        reqs = [req(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams[port] = ([tuple(r.generated) for r in reqs],
                         eng.stats.prefill_calls, eng.stats.tokens_out)
    assert streams[True] == streams[False]
    assert all(len(s) == 6 for s in streams[True][0])
