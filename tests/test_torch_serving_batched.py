"""The port's batched serving engine held against the JAX package's.

``decode_mode="batched"`` — one slot-stacked dense cache, one step per
tick — on the JAX suites' tiny ``mamba2-370m`` (SSM state and conv
tail), tiny ``paper-backbone`` (dense KV) and tiny ``zamba2-1.2b`` (the
hybrid: SSM state, conv tail and the shared attention block's K/V per
site), with the JAX weights brought across by the bridge.  On the f32-activation variants the
greedy and sampled streams are equal, and so are the engine counters.
Burst admission is one prefill call; a repeat of a wave builds no new
program; a bucket equal to ``max_seq`` and free slots whose position
runs past ``max_seq`` follow the JAX package's dense clamp.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as j_get_config
from repro.models.model import init_params
from repro.serving import CompileCache as JCompileCache
from repro.serving import Request as JRequest
from repro.serving import SamplingOpts as JSampling
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import (CompileCache, Request, SamplingOpts,
                                 ServingEngine)
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=300)
F32 = dict(activation_dtype="float32")


def _configs(name):
    if name in ("mamba2-370m", "zamba2-1.2b"):
        kw = dict(vocab_size=300, ssm_chunk=16, **F32)
        return (j_get_config(name).reduced(d_model=64).with_updates(**kw),
                get_config(name).reduced(d_model=64).with_updates(**kw))
    return (j_get_config(name).with_updates(**TINY, **F32),
            get_config(name).with_updates(**TINY, **F32))


MODELS = {}
for _name in ("mamba2-370m", "paper-backbone", "zamba2-1.2b"):
    _jcfg, _tcfg = _configs(_name)
    _jp = init_params(_jcfg, jax.random.PRNGKey(1))
    MODELS[_name] = (_jcfg, _jp, JCompileCache(), _tcfg, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, _jp), "cpu"))
NAMES = sorted(MODELS)

# (prompt len, budget, admit step, temperature): staggered admits, shared
# buckets, bursts of 2, a bucket == max_seq (40 -> 64), slot recycling
MIXES = [
    [(5, 4, 0, 0.0), (20, 4, 1, 0.8), (33, 3, 2, 1.4), (9, 2, 2, 0.0)],
    [(16, 3, 0, 1.4), (16, 3, 0, 1.4), (17, 3, 3, 0.8), (40, 5, 3, 0.0)],
]
COUNTERS = ("steps", "tokens_out", "prefills", "prefill_calls",
            "sampled_tokens")


def _prompt(length, rid, vocab=300):
    rng = np.random.default_rng(31 * length + rid)
    return rng.integers(0, vocab, size=length).astype(np.int32)


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


def _serve(name, mix, port, max_seq=64, rid_base=0, eng=None, **kw):
    jcfg, jp, jcc, tcfg, tp = MODELS[name]
    if eng is None:
        eng = (ServingEngine(tcfg, tp, slots=2, max_seq=max_seq,
                             compile_cache=CompileCache(), device="cpu",
                             **kw) if port else
               JEngine(jcfg, jp, slots=2, max_seq=max_seq,
                       compile_cache=jcc, **kw))
    req_t, samp_t = (Request, SamplingOpts) if port else (JRequest,
                                                          JSampling)
    reqs = [req_t(rid=rid_base + i, prompt=_prompt(n, rid_base + i),
                  max_new_tokens=b, sampling=samp_t(temperature=t, seed=5))
            for i, (n, b, _, t) in enumerate(mix)]
    return _drive(eng, reqs, mix), eng


@pytest.mark.parametrize("mix", MIXES, ids=range(len(MIXES)))
@pytest.mark.parametrize("name", NAMES)
def test_batched_engine_matches_reference_f32(name, mix):
    """Greedy and sampled streams, and the engine counters, equal the JAX
    batched engine's."""
    j_streams, j_eng = _serve(name, mix, port=False)
    t_streams, t_eng = _serve(name, mix, port=True)
    assert t_eng.decode_mode == "batched" and t_eng.block_pool is None
    assert t_streams == j_streams
    for counter in COUNTERS:
        assert getattr(t_eng.stats, counter) == \
            getattr(j_eng.stats, counter), counter


@pytest.mark.parametrize("name", NAMES)
def test_per_request_admission_matches_reference(name):
    mix = MIXES[1]
    j_streams, j_eng = _serve(name, mix, port=False,
                              prefill_mode="per_request")
    t_streams, t_eng = _serve(name, mix, port=True,
                              prefill_mode="per_request")
    assert t_streams == j_streams
    assert t_eng.stats.prefill_calls == j_eng.stats.prefill_calls == 4


@pytest.mark.parametrize("name", NAMES)
def test_burst_admission_is_one_prefill_call(name):
    """Four same-bucket prompts admit in ONE prefill call, with the
    streams of one call per request."""
    _, _, _, tcfg, tp = MODELS[name]
    streams, calls = {}, {}
    for mode in ("batched", "per_request"):
        eng = ServingEngine(tcfg, tp, slots=4, max_seq=64,
                            prefill_mode=mode, compile_cache=CompileCache(),
                            device="cpu")
        reqs = [Request(rid=i, prompt=_prompt(9, i), max_new_tokens=4)
                for i in range(4)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        calls[mode] = eng.stats.prefill_calls
        eng.drain()
        streams[mode] = [tuple(r.generated) for r in reqs]
        assert eng.stats.prefills == 4
    assert calls == {"batched": 1, "per_request": 4}
    assert streams["batched"] == streams["per_request"]


@pytest.mark.parametrize("name", NAMES)
def test_second_wave_builds_no_new_program(name):
    """A repeat of a wave (same lengths, new tokens) builds nothing, and
    a second engine on the same program cache builds nothing at all."""
    _, _, _, tcfg, tp = MODELS[name]
    cc = CompileCache()
    mix = MIXES[0]

    def engine():
        return ServingEngine(tcfg, tp, slots=2, max_seq=64,
                             compile_cache=cc, device="cpu")

    eng = engine()
    _serve(name, mix, port=True, eng=eng)
    warm = eng.stats.recompiles
    assert warm > 0
    _serve(name, mix, port=True, eng=eng, rid_base=100)
    assert eng.stats.recompiles == warm
    eng2 = engine()
    _serve(name, mix, port=True, eng=eng2, rid_base=200)
    assert eng2.stats.recompiles == 0


def test_bucket_at_max_seq_gives_the_dense_stream():
    """Fault R1 on the dense cache: a 40-token prompt buckets to max_seq
    64, so its first decode runs at pos == max_seq; the write and the
    attention row clamp to max_seq - 1 as in the JAX batched engine
    (bf16, the default activations, as the paged suite pins it)."""
    mix = [(40, 6, 0, 0.0)]
    jcfg, jp, jcc, tcfg, tp = MODELS["paper-backbone"]
    jcfg, tcfg = (c.with_updates(activation_dtype="bfloat16")
                  for c in (jcfg, tcfg))
    j_streams, _ = _serve("paper-backbone", mix, port=False,
                          eng=JEngine(jcfg, jp, slots=2, max_seq=64,
                                      compile_cache=jcc))
    t_streams, _ = _serve("paper-backbone", mix, port=True,
                          eng=ServingEngine(tcfg, tp, slots=2, max_seq=64,
                                            compile_cache=CompileCache(),
                                            device="cpu"))
    assert t_streams == j_streams
    assert [len(s) for s in t_streams] == [2]


@pytest.mark.parametrize("name", NAMES)
def test_free_slots_past_max_seq_do_not_raise(name):
    """Slot 0 serves a bucket-32 prompt at max_seq 32 and frees itself
    after one decode; slot 1 then decodes 20 more steps while the free
    slot's position runs past max_seq.  Nothing raises, and the streams
    equal the JAX engine's."""
    mix = [(20, 2, 0, 0.0), (5, 22, 0, 0.8)]
    j_streams, _ = _serve(name, mix, port=False, max_seq=32)
    t_streams, t_eng = _serve(name, mix, port=True, max_seq=32)
    assert t_streams == j_streams
    assert int(t_eng._cache["pos"].max()) > 32


@pytest.mark.parametrize("name", NAMES)
def test_sample_step_matches_reference(name):
    """The batch=1 sampling step (the per-slot path's step, of which the
    batched step is the slot-batched form): after a prefill, three
    sampled tokens and the advanced keys equal the JAX package's."""
    import jax.numpy as jnp
    from repro.models import model as jm
    from repro_torch.models import model as tm
    from repro_torch.serving.sampling import request_key
    jcfg, jp, _, tcfg, tp = MODELS[name]
    toks = _prompt(16, 3)[None]
    key = request_key(5, 3, 0)
    _, jc = jax.jit(lambda t: jm.prefill(jp, jcfg, t, jm.init_cache(
        jcfg, 1, 64)))(jnp.asarray(toks))
    j_step = jax.jit(lambda c, t: jm.sample_step(jp, jcfg, c, t))
    _, tc = tm.prefill(tp, tcfg, torch.from_numpy(toks),
                       tm.init_cache(tcfg, 1, 64, device="cpu"))
    jc["sample"] = {"key": jnp.asarray(key, jnp.uint32),
                    "temp": jnp.float32(0.8), "top_k": jnp.int32(0)}
    tc["sample"] = {"key": torch.from_numpy(key.astype(np.int64)),
                    "temp": torch.tensor(0.8),
                    "top_k": torch.tensor(0, dtype=torch.int32)}
    tok = int(toks[0, -1])
    for _ in range(3):
        jn, jc = j_step(jc, jnp.int32(tok))
        tn, tc = tm.sample_step(tp, tcfg, tc,
                                torch.tensor(tok, dtype=torch.int32))
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(tc["sample"]["key"].numpy(),
                                      np.asarray(jc["sample"]["key"]))
        tok = int(tn)
    assert int(tc["pos"]) == 19


def test_mode_and_option_validation():
    _, _, _, tcfg, tp = MODELS["paper-backbone"]
    eng = ServingEngine(tcfg, tp, device="cpu")
    assert eng.decode_mode == "batched" and eng.prefill_mode == "batched"
    with pytest.raises(ValueError):               # paged-pool options
        ServingEngine(tcfg, tp, device="cpu",
                      opts=RuntimeOptions(kv_dtype="int8"))
    with pytest.raises(ValueError):
        ServingEngine(tcfg, tp, device="cpu",
                      opts=RuntimeOptions(paged_kernel=True))
    with pytest.raises(ValueError):
        ServingEngine(tcfg, tp, device="cpu", prefill_mode="eager")
    eng = ServingEngine(tcfg, tp, device="cpu", decode_mode="per_slot")
    assert eng.prefill_mode == "per_request"      # per_slot: ported
    mcfg, mp = MODELS["mamba2-370m"][3:]
    with pytest.raises(ValueError):               # no KV for a pool
        ServingEngine(mcfg, mp, device="cpu", decode_mode="paged",
                      opts=RuntimeOptions(paged_kernel=True))
