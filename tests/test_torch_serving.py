"""The port's paged serving engine held against the JAX package's.

Same requests, same weights (bridged), same runtime options: the port's
``ServingEngine`` on the CPU against ``repro.serving.ServingEngine`` with
``decode_mode="paged"`` and ``paged_kernel=True``.  On the f32-activation
variant greedy and sampled streams are equal (the JAX package's
``jax.random`` draws are reproduced bit for bit by the port's threefry);
so are the engine counters.  Block tables stay runtime data:
``recompiles`` does not grow across occupancy churn.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as j_get_config
from repro.models.model import init_params
from repro.models.runtime import DEFAULT_OPTIONS
from repro.serving import CompileCache as JCompileCache
from repro.serving import Request as JRequest
from repro.serving import SamplingOpts as JSampling
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import (CompileCache, Request, SamplingOpts,
                                 ServingEngine)
from repro_torch.serving.paging import TRASH_BLOCK
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=300)
J_CFG = j_get_config("paper-backbone").with_updates(**TINY)
J_PARAMS = init_params(J_CFG, jax.random.PRNGKey(0))
T_PARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, J_PARAMS),
                             "cpu")
MAX_SEQ = 64
J_CC = JCompileCache()

# (prompt len, budget, admit step, temperature) — the JAX paging suite's
# shape of mix: staggered admits, shared buckets, a bucket == max_seq
MIXES = [
    [(5, 4, 0, 0.0), (20, 4, 1, 0.8), (33, 3, 2, 1.4), (9, 2, 2, 0.0)],
    [(16, 3, 0, 1.4), (16, 3, 0, 1.4), (17, 3, 3, 0.8)],
    [(12, 5, 0, 0.0), (30, 4, 1, 0.0), (40, 3, 1, 0.8)],
]


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


def _run_jax(mix, kv_dtype, cfg_kw, mode="paged", rid_base=0):
    cfg = J_CFG.with_updates(**cfg_kw)
    opts = (dataclasses.replace(DEFAULT_OPTIONS, paged_kernel=True,
                                kv_dtype=kv_dtype)
            if mode == "paged" else DEFAULT_OPTIONS)
    eng = JEngine(cfg, J_PARAMS, slots=2, max_seq=MAX_SEQ, opts=opts,
                  decode_mode=mode, compile_cache=J_CC)
    reqs = [JRequest(rid=rid_base + i, prompt=_prompt(n, rid_base + i),
                     max_new_tokens=b,
                     sampling=JSampling(temperature=t, seed=5))
            for i, (n, b, _, t) in enumerate(mix)]
    return _drive(eng, reqs, mix), eng


def _engine(kv_dtype, cfg_kw, cc=None, **kw):
    cfg = get_config("paper-backbone").with_updates(**TINY, **cfg_kw)
    if cc is None:
        cc = CompileCache()
    return ServingEngine(cfg, T_PARAMS, slots=2, max_seq=MAX_SEQ,
                         opts=RuntimeOptions(paged_kernel=True,
                                             kv_dtype=kv_dtype),
                         decode_mode="paged", compile_cache=cc,
                         device="cpu", **kw)


def _run_port(mix, kv_dtype, cfg_kw, eng=None, rid_base=0):
    eng = eng or _engine(kv_dtype, cfg_kw)
    reqs = [Request(rid=rid_base + i, prompt=_prompt(n, rid_base + i),
                    max_new_tokens=b, sampling=SamplingOpts(temperature=t,
                                                            seed=5))
            for i, (n, b, _, t) in enumerate(mix)]
    return _drive(eng, reqs, mix), eng


COUNTERS = ("steps", "tokens_out", "prefills", "prefill_calls",
            "sampled_tokens")


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("mix", MIXES, ids=range(len(MIXES)))
def test_port_engine_matches_reference_f32(mix, kv_dtype):
    """Greedy and sampled streams, and the engine counters, equal the JAX
    engine's on the f32-activation variant."""
    f32 = dict(activation_dtype="float32")
    j_streams, j_eng = _run_jax(mix, kv_dtype, f32)
    t_streams, t_eng = _run_port(mix, kv_dtype, f32)
    assert t_streams == j_streams
    for name in COUNTERS:
        assert getattr(t_eng.stats, name) == getattr(j_eng.stats, name), name
    assert (t_eng.block_pool.tables == TRASH_BLOCK).all()


def test_greedy_bucket_at_max_seq_pins_dense_stream():
    """Fault R1: a 40-token prompt buckets to max_seq = 64, so the first
    decode runs at pos == max_seq.  The JAX dense path clamps that write
    onto row max_seq - 1, giving (210, 257); its kernel path attends one
    extra key instead and gives (210, 162).  The port clamps on every
    path and reproduces the dense stream, in bf16 and int8 alike."""
    mix = [(40, 6, 0, 0.0)]
    dense, _ = _run_jax(mix, "auto", {}, mode="batched")
    assert dense == [(210, 257)]
    for kv_dtype in ("auto", "int8"):
        streams, _ = _run_port(mix, kv_dtype, {})
        assert streams == dense


def test_recompiles_stay_zero_across_occupancy():
    """A fragmented second wave builds nothing new, and a second engine
    on the same cache builds nothing at all."""
    cc = CompileCache()
    mix = MIXES[0]
    eng = _engine("int8", {}, cc)
    _run_port(mix, "int8", {}, eng=eng)
    warm = eng.stats.recompiles
    assert warm > 0
    _run_port(mix, "int8", {}, eng=eng, rid_base=100)
    assert eng.stats.recompiles == warm
    eng2 = _engine("int8", {}, cc)
    _run_port(mix, "int8", {}, eng=eng2, rid_base=200)
    assert eng2.stats.recompiles == 0


def test_shared_prompts_share_blocks_and_hit_prefix_cache():
    eng = _engine("int8", {})
    p = _prompt(32, 1)
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=4)
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.step()                                # one burst prefill
    assert eng.stats.prefill_calls == 1
    assert eng.block_pool.shared_blocks == 2  # 32 tokens = 2 blocks of 16
    eng.drain()
    late = Request(rid=7, prompt=p.copy(), max_new_tokens=3)
    eng.submit(late)
    eng.drain()
    assert eng.stats.prefill_calls == 1       # prefix hit: no prefill
    assert len(late.generated) == 3
    assert tuple(reqs[0].generated) == tuple(reqs[1].generated)


@pytest.mark.parametrize("mode", ["batched", "per_slot"])
def test_not_ported_modes_raise(mode):
    """Both modes that once refused a family serve now.  ``batched``
    takes the encoder-decoder (whisper-small, served as the JAX engine
    serves it: no frames, so zero cross K/V): it constructs with the
    slot cache's cross leaves and serves a request to its budget.
    ``per_slot`` constructs, admits per request and serves a request to
    its budget."""
    if mode == "batched":
        from repro_torch.models import init_params as t_init_params
        cfg = get_config("whisper-small").reduced(d_model=64)
        eng = ServingEngine(cfg, t_init_params(cfg, seed=0, device="cpu"),
                            slots=2, max_seq=64, decode_mode=mode,
                            device="cpu", compile_cache=CompileCache())
        assert tuple(eng._cache["cross_k"].shape) == (
            2, cfg.num_layers, 1, cfg.encoder_seq_len, cfg.num_kv_heads,
            cfg.resolved_head_dim)
        req = Request(rid=0, prompt=_prompt(9, 0), max_new_tokens=4)
        eng.submit(req)
        eng.drain()
        assert req.done and len(req.generated) == 4
        assert eng.stats.decode_calls == 3
        return
    cfg = get_config("paper-backbone").with_updates(**TINY)
    eng = ServingEngine(cfg, T_PARAMS, decode_mode=mode, device="cpu",
                        compile_cache=CompileCache())
    assert eng.prefill_mode == "per_request"
    req = Request(rid=0, prompt=_prompt(9, 0), max_new_tokens=4)
    eng.submit(req)
    eng.drain()
    assert req.done and len(req.generated) == 4
    assert eng.stats.decode_calls == 3


def test_option_validation():
    cfg = get_config("paper-backbone").with_updates(**TINY)
    with pytest.raises(ValueError):
        ServingEngine(cfg, T_PARAMS, decode_mode="dense", device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(cfg, T_PARAMS, device="cpu", decode_mode="paged",
                      opts=RuntimeOptions(paged_kernel=True, kv_dtype="int3"))
    with pytest.raises(ValueError):
        ServingEngine(cfg, T_PARAMS, device="cpu", block_size=12,
                      decode_mode="paged",
                      opts=RuntimeOptions(paged_kernel=True))
    # the gather-to-dense step (paged_kernel=False) serves
    eng = ServingEngine(cfg, T_PARAMS, device="cpu", decode_mode="paged",
                        opts=RuntimeOptions(kv_dtype="int8"),
                        compile_cache=CompileCache())
    req = Request(rid=0, prompt=_prompt(5, 0), max_new_tokens=3)
    eng.submit(req)
    eng.drain()
    assert req.done and len(req.generated) == 3
    assert (eng.block_pool.tables == TRASH_BLOCK).all()


def test_long_prompts_at_max_seq_2048_match_reference():
    """max_seq 2048: a 700-token prompt (bucket 1024, ``full``) and a
    1500-token prompt (bucket 2048 == max_seq, ``chunked``; it decodes
    once at the clamped row and stops, fault R1) beside a short one.
    Greedy streams and engine counters equal the JAX engine's (f32)."""
    mix = [(700, 5, 0, 0.0), (1500, 4, 0, 0.0), (30, 3, 1, 0.0)]
    cfg_kw = dict(activation_dtype="float32")
    opts = dataclasses.replace(DEFAULT_OPTIONS, paged_kernel=True,
                               kv_dtype="int8")
    j_eng = JEngine(J_CFG.with_updates(**cfg_kw), J_PARAMS, slots=2,
                    max_seq=2048, opts=opts, decode_mode="paged",
                    compile_cache=J_CC)
    t_eng = ServingEngine(
        get_config("paper-backbone").with_updates(**TINY, **cfg_kw),
        T_PARAMS, slots=2, max_seq=2048,
        opts=RuntimeOptions(paged_kernel=True, kv_dtype="int8"),
        decode_mode="paged", compile_cache=CompileCache(), device="cpu")
    streams = []
    for eng, req_t in ((j_eng, JRequest), (t_eng, Request)):
        reqs = [req_t(rid=i, prompt=_prompt(n, i), max_new_tokens=b)
                for i, (n, b, _, _) in enumerate(mix)]
        streams.append(_drive(eng, reqs, mix))
    assert streams[0] == streams[1]
    assert [len(s) for s in streams[1]] == [5, 2, 3]
    for name in COUNTERS:
        assert getattr(t_eng.stats, name) == getattr(j_eng.stats, name), name


# fault R2 of the JAX package: at block size 4 this mix is served in 3
# prefill calls by the paged engine and in 2 by the dense batched one,
# with equal streams.  The port keeps both counts.
R2_MIX = [(1, 1, 0, 0.0), (33, 1, 0, 0.0), (33, 1, 0, 0.0)]


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_r2_mix_prefill_calls_pinned_to_reference(kv_dtype):
    """The R2 mix through the port's paged and batched engines: streams
    equal the JAX engines', and so do the prefill-call counts (paged 3,
    dense 2)."""
    f32 = dict(activation_dtype="float32")
    cfg = J_CFG.with_updates(**f32)
    opts = dataclasses.replace(DEFAULT_OPTIONS, paged_kernel=True,
                               kv_dtype=kv_dtype)
    runs = {}
    for mode in ("paged", "batched"):
        kw = dict(block_size=4) if mode == "paged" else {}
        j_eng = JEngine(cfg, J_PARAMS, slots=2, max_seq=MAX_SEQ,
                        opts=opts if mode == "paged" else DEFAULT_OPTIONS,
                        decode_mode=mode, compile_cache=J_CC, **kw)
        j_reqs = [JRequest(rid=i, prompt=_prompt(n, i), max_new_tokens=b,
                           sampling=JSampling(temperature=t, seed=5))
                  for i, (n, b, _, t) in enumerate(R2_MIX)]
        t_eng = (_engine(kv_dtype, f32, block_size=4) if mode == "paged"
                 else ServingEngine(
                     get_config("paper-backbone").with_updates(**TINY, **f32),
                     T_PARAMS, slots=2, max_seq=MAX_SEQ,
                     compile_cache=CompileCache(), device="cpu"))
        assert t_eng.decode_mode == mode
        j_streams = _drive(j_eng, j_reqs, R2_MIX)
        t_streams, _ = _run_port(R2_MIX, kv_dtype, f32, eng=t_eng)
        assert t_streams == j_streams, mode
        runs[mode] = (t_streams, t_eng.stats.prefill_calls,
                      j_eng.stats.prefill_calls)
    assert runs["paged"][1:] == (3, 3)
    assert runs["batched"][1:] == (2, 2)
    assert runs["paged"][0] == runs["batched"][0]
