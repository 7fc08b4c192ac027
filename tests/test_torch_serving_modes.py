"""The port's ``per_slot`` mode, ``swap_model``, admission back-off and
step hooks held against the JAX package's engine, and the in-place
decode steps that CUDA graphs replay.

Twins of ``tests/test_serving_swap.py`` (all six cases, in the batched
and per-slot modes), the per-slot cases of ``tests/test_serving_batched
.py`` and ``tests/test_serving_sampling.py``, and the injected-OOM
back-off of ``tests/test_chaos.py``: the same schedules through the JAX
engine and the port's on the CPU, f32-activation tiny ``paper-backbone``
with the JAX weights brought across by the bridge.  Token streams and
the engine counters are equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models.model import init_cache as j_init_cache
from repro.models.model import init_params
from repro.models.runtime import DEFAULT_OPTIONS as J_DEFAULT
from repro.serving import CompileCache as JCompileCache
from repro.serving import Request as JRequest
from repro.serving import SamplingOpts as JSampling
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import init_params as t_init_params
from repro_torch.models import model as tm
from repro_torch.models.configs import ModelConfig
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import (CompileCache, Request, SamplingOpts,
                                 ServingEngine)
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=300,
            activation_dtype="float32")
J_CFG = j_get_config("paper-backbone").with_updates(**TINY)
T_CFG = get_config("paper-backbone").with_updates(**TINY)
J_PARAMS = init_params(J_CFG, jax.random.PRNGKey(0))
T_PARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, J_PARAMS),
                             "cpu")
MAX_SEQ = 64
J_CC, T_CC = JCompileCache(), CompileCache()
COUNTERS = ("steps", "tokens_out", "prefills", "prefill_calls",
            "sampled_tokens", "requeues", "freezes", "thaws", "oom_events")


@pytest.fixture(params=["batched", "per_slot"])
def mode(request):
    return request.param


def _engine(port, mode="batched", slots=2, **kw):
    if port:
        return ServingEngine(T_CFG, T_PARAMS, slots=slots, max_seq=MAX_SEQ,
                             decode_mode=mode, compile_cache=T_CC,
                             device="cpu", **kw)
    return JEngine(J_CFG, J_PARAMS, slots=slots, max_seq=MAX_SEQ,
                   decode_mode=mode, compile_cache=J_CC, **kw)


def _req(port, **kw):
    if "sampling" in kw and not port:
        s = kw["sampling"]
        kw["sampling"] = JSampling(temperature=s.temperature, top_k=s.top_k,
                                   seed=s.seed)
    return (Request if port else JRequest)(**kw)


def _swap_same(eng, port):
    eng.swap_model(T_CFG if port else J_CFG, T_PARAMS if port else J_PARAMS,
                   eng.opts)


def _twin(scenario, mode):
    """Run ``scenario(port, mode) -> result`` on both engines; the results
    and every counter must be equal.  Returns the port's result."""
    j_res, j_eng = scenario(False, mode)
    t_res, t_eng = scenario(True, mode)
    assert t_res == j_res
    for name in COUNTERS:
        assert getattr(t_eng.stats, name) == getattr(j_eng.stats, name), name
    return t_res


# ------------------------------------------- twins of test_serving_swap --
def test_swap_midflight_respects_token_budget(mode):
    def scenario(port, mode):
        eng = _engine(port, mode)
        eng.submit(_req(port, rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                        max_new_tokens=3))
        eng.step()                   # prefill token + one decode token
        assert eng.stats.tokens_out == 2
        _swap_same(eng, port)        # re-queues the in-flight request
        assert len(eng._queue) == 1
        requeued = eng._queue[0]
        eng.drain()
        assert requeued.done and len(requeued.generated) == 3
        assert eng.stats.tokens_out == 3
        return tuple(requeued.generated), eng
    _twin(scenario, mode)


def test_swap_with_budget_already_spent_emits_nothing(mode):
    def scenario(port, mode):
        eng = _engine(port, mode)
        eng.submit(_req(port, rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                        max_new_tokens=2))
        eng.step()                   # prefill + decode = 2 == the budget
        _swap_same(eng, port)
        before = eng.stats.tokens_out
        eng.drain()
        assert eng.stats.tokens_out == before == 2
        return before, eng
    _twin(scenario, mode)


def test_zero_budget_request_never_prefills(mode):
    def scenario(port, mode):
        eng = _engine(port, mode)
        eng.submit(_req(port, rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                        max_new_tokens=0))
        eng.step()
        assert eng.stats.tokens_out == 0 and eng.stats.prefills == 0
        assert not any(eng._active) and not eng._queue
        return None, eng
    _twin(scenario, mode)


def test_prompt_longer_than_max_seq_is_truncated_not_crashed(mode):
    def scenario(port, mode):
        eng = _engine(port, mode)
        req = _req(port, rid=0, prompt=np.arange(1, 101, dtype=np.int32),
                   max_new_tokens=2)
        eng.submit(req)
        eng.drain()
        assert eng.stats.prefills == 1 and eng.stats.tokens_out >= 1
        return tuple(req.generated), eng
    _twin(scenario, mode)


def test_swap_preserves_first_token_stamp(mode):
    def scenario(port, mode):
        eng = _engine(port, mode)
        req = _req(port, rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                   max_new_tokens=6)
        eng.submit(req)
        eng.step()
        stamp = req.first_token_s
        assert stamp is not None
        _swap_same(eng, port)
        requeued = eng._queue[0]
        assert requeued.first_token_s == stamp
        eng.drain()
        assert requeued.done and requeued.first_token_s == stamp
        return tuple(requeued.generated), eng
    _twin(scenario, mode)


def test_step_timing_hook_fires(mode):
    """``on_step`` sees every step; ``step_time_ewma_s`` is the 0.8/0.2
    EWMA of the step times; an installed ``slo`` tracker gets one TTFT
    per request and each step's time per emitted token."""
    class Slo:
        def __init__(self):
            self.seen = []

        def observe(self, metric, value, n=1):
            self.seen.append((metric, n))

    def scenario(port, mode):
        eng = _engine(port, mode)
        seen = []
        eng.on_step = lambda dt, emitted, gen: seen.append((dt, emitted,
                                                            gen))
        eng.slo = Slo()
        assert eng.step_time_ewma_s is None
        eng.submit(_req(port, rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                        max_new_tokens=2))
        eng.drain()
        assert len(eng.step_times) == eng.stats.steps == len(seen)
        assert all(dt > 0 for dt, _, _ in seen)
        ewma = None
        for dt in eng.step_times:
            ewma = dt if ewma is None else 0.8 * ewma + 0.2 * dt
        assert eng.step_time_ewma_s == pytest.approx(ewma)
        assert eng.stats.tokens_per_step == eng.stats.tokens_out / \
            eng.stats.steps
        return ([e for _, e, _ in seen], eng.slo.seen), eng
    _twin(scenario, mode)


# ---------------------------------------- per_slot twins (batched, sampling)
def _mixed_requests(port, n=6, seed=0):
    rng = np.random.default_rng(seed)
    lengths = [3, 10, 17, 33, 40, 5, 12, 26][:n]
    return [_req(port, rid=i, prompt=rng.integers(0, 300, size=lengths[i])
                 .astype(np.int32), max_new_tokens=4 + i % 4)
            for i in range(n)]


def test_per_slot_decode_forces_per_request_admission():
    for port in (False, True):
        assert _engine(port, "per_slot").prefill_mode == "per_request"


def test_swap_model_mid_decode_matches_reference():
    """A mid-decode swap to the half-depth variant (η5): the per-slot and
    batched modes agree, and both equal the JAX engine's per-slot run."""
    from repro.elastic import ElasticSupernet, VariantSpec
    jv_cfg, jv_params = ElasticSupernet(J_CFG, J_PARAMS).variant(
        VariantSpec(depth_ratio=0.5))
    tv_cfg = ModelConfig(**{f.name: getattr(jv_cfg, f.name)
                            for f in dataclasses.fields(ModelConfig)})
    tv_params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jv_params), "cpu")
    results = {}
    for port, mode in ((False, "per_slot"), (True, "per_slot"),
                       (True, "batched")):
        eng = _engine(port, mode)
        reqs = _mixed_requests(port, 4, seed=5)
        for r in reqs:
            r.max_new_tokens = 6
            eng.submit(r)
        eng.step()
        eng.step()
        if port:
            eng.swap_model(tv_cfg, tv_params, eng.opts)
        else:
            eng.swap_model(jv_cfg, jv_params, eng.opts)
        eng.drain()
        assert eng.generation == 1
        results[(port, mode)] = ([tuple(r.generated[:6]) for r in reqs],
                                 eng.stats.prefill_calls, eng.stats.thaws)
    assert results[(True, "per_slot")] == results[(False, "per_slot")]
    assert results[(True, "batched")][0] == results[(True, "per_slot")][0]


SAMPLING_MIXES = [
    [(7, 6, 0, 0.8), (22, 5, 1, 0.0), (11, 4, 1, 1.4)],
    [(3, 2, 0, 0.0), (28, 6, 0, 1.4), (13, 5, 2, 0.8), (40, 4, 3, 0.0)],
]


@pytest.mark.parametrize("mix", SAMPLING_MIXES, ids=range(2))
def test_batched_and_per_slot_decode_agree(mix):
    """Per-request sampling mixes: the port's per-slot and batched
    engines give the JAX per-slot engine's streams and counters."""
    def run(port, mode):
        eng = _engine(port, mode)
        reqs = [_req(port, rid=i, prompt=np.random.default_rng(31 * n + i)
                     .integers(0, 300, n).astype(np.int32), max_new_tokens=b,
                     sampling=SamplingOpts(temperature=t, seed=5))
                for i, (n, b, _, t) in enumerate(mix)]
        step = 0
        while any(not r.done for r in reqs):
            for r, (_, _, at, _) in zip(reqs, mix):
                if at == step:
                    eng.submit(r)
            eng.step()
            step += 1
        return [tuple(r.generated) for r in reqs], eng
    per_slot = _twin(run, "per_slot")
    assert run(True, "batched")[0] == per_slot


@pytest.mark.parametrize("top_k", [0, 5])
def test_fixed_keys_reproduce_across_runs_and_modes(top_k):
    """The engine's default sampling (seed, temperature, top-k): equal
    streams across runs and modes, and equal to the JAX engine's."""
    opts = SamplingOpts(temperature=1.0, top_k=top_k, seed=77)
    mix = [(7, 6, 0), (22, 5, 1), (11, 4, 1)]

    def run(port, mode):
        samp = opts if port else JSampling(temperature=1.0, top_k=top_k,
                                           seed=77)
        eng = _engine(port, mode, sampling=samp)
        reqs = [_req(port, rid=i, prompt=np.random.default_rng(31 * n + i)
                     .integers(0, 300, n).astype(np.int32), max_new_tokens=b)
                for i, (n, b, _) in enumerate(mix)]
        step = 0
        while any(not r.done for r in reqs):
            for r, (_, _, at) in zip(reqs, mix):
                if at == step:
                    eng.submit(r)
            eng.step()
            step += 1
        return [tuple(r.generated) for r in reqs], eng
    first = _twin(run, "per_slot")
    assert run(True, "per_slot")[0] == first
    assert run(True, "batched")[0] == first


def test_temperature_zero_is_the_decode_ref_greedy_loop():
    """Greedy serving in both modes equals a manual loop over the
    per-slot programs — prefill, argmax, ``decode_ref``, argmax — which
    equals the JAX package's loop over its own ``decode_ref``."""
    mix = [(5, 4), (20, 6), (40, 3)]
    programs, _ = T_CC.entry_for(T_CFG, RuntimeOptions(), 2, MAX_SEQ, "")
    j_programs, _ = J_CC.entry_for(J_CFG, J_DEFAULT, 2, MAX_SEQ, "")
    reference, j_reference = [], []
    for i, (n, budget) in enumerate(mix):
        prompt = np.random.default_rng(31 * n + i).integers(
            0, 300, n).astype(np.int32)
        bucket = min(max(16, 1 << (n - 1).bit_length()), MAX_SEQ)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, bucket - n:] = prompt
        prefill_fn, _ = programs.prefill(bucket)
        logits, cache = prefill_fn(T_PARAMS, tm.init_cache(
            T_CFG, 1, MAX_SEQ, device="cpu"), torch.from_numpy(toks))
        stream = [int(torch.argmax(logits[0, -1, :300]))]
        j_prefill, _ = j_programs.prefill(bucket)
        j_logits, j_cache = j_prefill(J_PARAMS, j_init_cache(
            J_CFG, 1, MAX_SEQ), jnp.asarray(toks))
        j_stream = [int(jnp.argmax(j_logits[0, -1, :300]))]
        while len(stream) < budget:
            logits, cache = programs.decode_ref(
                T_PARAMS, cache, torch.tensor([stream[-1]], dtype=torch.int32))
            stream.append(int(torch.argmax(logits[0, :300])))
            j_logits, j_cache = j_programs.decode_ref(
                J_PARAMS, j_cache, jnp.asarray([j_stream[-1]], jnp.int32))
            j_stream.append(int(jnp.argmax(j_logits[0, :300])))
            if int(cache["pos"]) >= MAX_SEQ - 1:
                break
        reference.append(tuple(stream))
        j_reference.append(tuple(j_stream))
    assert reference == j_reference
    for mode in ("batched", "per_slot"):
        eng = _engine(True, mode)
        reqs = [Request(rid=i, prompt=np.random.default_rng(31 * n + i)
                        .integers(0, 300, n).astype(np.int32),
                        max_new_tokens=b) for i, (n, b) in enumerate(mix)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        assert [tuple(r.generated) for r in reqs] == reference, mode


# ------------------------------------------------ injected-OOM back-off --
@pytest.mark.parametrize("mode", ["batched", "per_slot", "paged"])
def test_oom_backoff_keeps_requests_and_heals(mode):
    """Twin of ``test_chaos.py::test_oom_injection_zero_token_loss_and_
    backoff``: injected OOMs keep the request queued (the streams equal
    an undisturbed run's and the JAX engine's), ``oom_events`` counts
    them, a successful admission heals the back-off, and consecutive
    OOMs double the hold-off up to ``oom_backoff_cap``."""
    def engine(port):
        return _engine(port, mode)

    def scenario(port, mode, oom=2):
        eng = engine(port)
        reqs = _mixed_requests(port, 4, seed=2)
        for r in reqs:
            eng.submit(r)
        eng.step()
        eng.inject_oom(oom)
        eng.drain()
        assert all(r.done for r in reqs)
        assert eng._oom_backoff == 0 and eng._oom_pending == 0
        return [tuple(r.generated) for r in reqs], eng

    streams = _twin(scenario, mode)
    assert streams == scenario(True, mode, oom=0)[0]
    for port in (False, True):
        eng = engine(port)
        for r in _mixed_requests(port, 4, seed=2):
            eng.submit(r)
        eng.inject_oom(6)
        holdoffs = []
        while eng._oom_pending:
            eng._admit()
            holdoffs.append(eng._admit_holdoff)
            eng._admit_holdoff = 0               # fast-forward the wait
        assert holdoffs == [1, 2, 4, 8, 8, 8]
        assert eng.stats.oom_events == 6 and len(eng._queue) == 4
        eng._admit()                             # admits, and heals
        assert eng._oom_backoff == 0 and len(eng._queue) < 4


# ------------------------------------- in-place steps (graph replays) --
def _leaves(tree, prefix=""):
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + name + ".")
        else:
            yield prefix + name, v


@pytest.mark.parametrize("name,step", [
    ("paper-backbone", "decode"), ("paper-backbone", "decode_greedy"),
    ("paper-backbone", "paged"), ("mamba2-370m", "decode"),
    ("mamba2-370m", "decode_greedy")])
def test_decode_steps_write_every_leaf_in_place(name, step):
    """A CUDA graph replays fixed addresses, so every decode step the
    engine replays must write each cache and pool leaf in place: after
    the step every leaf is the same tensor at the same ``data_ptr()``,
    ``pos`` has advanced, and the step's returned positions are the
    cache's own ``pos`` leaf."""
    if name == "mamba2-370m":
        cfg = get_config(name).reduced(d_model=64).with_updates(
            vocab_size=300, ssm_chunk=16, activation_dtype="float32")
        params = t_init_params(cfg, seed=3, device="cpu")
    else:
        cfg, params = T_CFG, T_PARAMS
    paged = step == "paged"
    eng = ServingEngine(
        cfg, params, slots=2, max_seq=MAX_SEQ, compile_cache=CompileCache(),
        device="cpu", decode_mode="paged" if paged else "batched",
        opts=RuntimeOptions(paged_kernel=True, kv_dtype="int8")
        if paged else RuntimeOptions())
    for i, n in enumerate((9, 20)):
        eng.submit(Request(rid=i, prompt=np.arange(n, dtype=np.int32) + i,
                           max_new_tokens=8,
                           sampling=SamplingOpts(temperature=0.7 * i,
                                                 seed=1)))
    eng.step()
    state = {"cache": eng._cache}
    if paged:
        state["pool"] = eng._pool
    before = {k: (v, v.data_ptr()) for tree in state.values()
              for k, v in _leaves(tree)}
    pos0 = eng._cache["pos"].clone()
    tokens = torch.tensor([3, 4], dtype=torch.int32)
    if paged:
        tables = torch.from_numpy(eng.block_pool.tables.copy())
        _, pos, _, _ = eng._paged_decode_fn()(eng.params, eng._cache,
                                               eng._pool, tokens, tables)
    else:
        _, pos, _ = getattr(eng._programs, step)(eng.params, eng._cache,
                                                 tokens)
    after = {k: v for tree in state.values() for k, v in _leaves(tree)}
    assert after.keys() == before.keys()
    for k, (leaf, ptr) in before.items():
        assert after[k] is leaf and leaf.data_ptr() == ptr, k
    assert pos is eng._cache["pos"]
    assert torch.equal(pos, pos0 + 1)
