"""Freeze/thaw, preemption, ``swap_model`` and the gather-to-dense paged
step of the port's engine, held against the JAX package's engine.

Twins of the freeze/thaw and tight-pool cases of ``tests/test_paging.py``
and ``tests/test_paged_kernel.py``: the same mixes, engines and
schedules run through ``repro.serving.ServingEngine`` and the port's
``ServingEngine`` on the CPU, with the JAX weights brought across by the
bridge, on the f32-activation variant of the tiny ``paper-backbone``.
Token streams are equal, and so are ``prefill_calls``, ``freezes``,
``thaws`` and ``requeues``; each JAX test's own claim (exact
continuation, zero re-prefill, no token loss, tables released) is
asserted of the port's run too.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as j_get_config
from repro.models.model import init_params
from repro.models.runtime import DEFAULT_OPTIONS as J_DEFAULT
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
            head_dim=16, d_ff=128, vocab_size=300,
            activation_dtype="float32")
J_CFG = j_get_config("paper-backbone").with_updates(**TINY)
T_CFG = get_config("paper-backbone").with_updates(**TINY)
J_PARAMS = init_params(J_CFG, jax.random.PRNGKey(0))
T_PARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, J_PARAMS),
                             "cpu")
MAX_SEQ = 64
J_CC, T_CC = JCompileCache(), CompileCache()

# pool options by name: (paged_kernel, kv_dtype)
OPTS = {"gather": (False, "auto"), "kernel": (True, "auto"),
        "gather_int8": (False, "int8"), "kernel_int8": (True, "int8")}

# the paging suite's deterministic mixes: (prompt length, budget, admit
# step, temperature)
MIX_CORPUS = [
    [(1, 1, 0, 0.0)],
    [(40, 6, 0, 0.8)],
    [(5, 4, 0, 0.0), (20, 4, 1, 0.8), (33, 3, 2, 1.4), (9, 2, 2, 0.0)],
    [(16, 3, 0, 1.4), (16, 3, 0, 1.4), (17, 3, 3, 0.8)],
    [(7, 6, 1, 0.8), (22, 5, 2, 0.0), (11, 4, 3, 1.4), (3, 2, 0, 0.0),
     (28, 3, 1, 0.8), (13, 2, 2, 1.4)],
]
COUNTERS = ("steps", "tokens_out", "prefills", "prefill_calls",
            "sampled_tokens", "freezes", "thaws", "requeues")


def _prompt(length, rid):
    rng = np.random.default_rng(31 * length + rid)
    return rng.integers(0, 300, size=length).astype(np.int32)


def _engine(port, opts="gather", **kw):
    """A JAX (``port=False``) or port engine on the tiny config."""
    kw.setdefault("slots", 2)
    kernel, kv_dtype = OPTS[opts]
    if port:
        return ServingEngine(T_CFG, T_PARAMS, max_seq=MAX_SEQ,
                             opts=RuntimeOptions(paged_kernel=kernel,
                                                 kv_dtype=kv_dtype),
                             compile_cache=T_CC, device="cpu", **kw)
    return JEngine(J_CFG, J_PARAMS, max_seq=MAX_SEQ,
                   opts=J_DEFAULT.replace(paged_kernel=kernel,
                                          kv_dtype=kv_dtype),
                   compile_cache=J_CC, **kw)


def _requests(port, mix, rid_base=0):
    req_t, samp_t = (Request, SamplingOpts) if port else (JRequest,
                                                          JSampling)
    return [req_t(rid=rid_base + i, prompt=_prompt(n, rid_base + i),
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


def _run(port, mix, max_steps=200, **kw):
    eng = _engine(port, **kw)
    return _drive(eng, _requests(port, mix), mix, max_steps), eng


def _both(mix, **kw):
    """The mix through the JAX engine and the port's: streams equal,
    counters equal.  Returns the port's streams and engine."""
    j_streams, j_eng = _run(False, mix, **kw)
    t_streams, t_eng = _run(True, mix, **kw)
    assert t_streams == j_streams
    for name in COUNTERS:
        assert getattr(t_eng.stats, name) == getattr(j_eng.stats, name), name
    return t_streams, t_eng


def _freeze_after(eng, reqs, steps):
    for r in reqs:
        eng.submit(r)
    for _ in range(steps):
        eng.step()
    moved = eng.freeze_all("migrate") + eng.drain_waiting()
    assert not eng.has_work
    return moved


# ------------------------------------------- the gather-to-dense step --
@pytest.mark.parametrize("mix,block_size", [
    (MIX_CORPUS[0], 4), (MIX_CORPUS[1], 16), (MIX_CORPUS[2], 8),
    (MIX_CORPUS[3], 4), (MIX_CORPUS[4], 16)], ids=range(5))
def test_gather_step_matches_reference_and_dense(mix, block_size):
    """``paged_kernel=False`` (twin of ``test_paged_decode_matches_dense
    _batched``): the port's gather step gives the JAX gather step's
    streams and counters, which equal the port's dense batched engine's;
    the drained pool holds no block."""
    paged, eng = _both(mix, decode_mode="paged", block_size=block_size)
    dense, _ = _run(True, mix, decode_mode="batched")
    assert paged == dense
    assert (eng.block_pool.tables == TRASH_BLOCK).all()


@pytest.mark.parametrize("mix", MIX_CORPUS[2:], ids=range(2, 5))
def test_paged_matches_per_slot_reference(mix):
    """The paged gather engine and the ``per_slot`` reference loop give
    the same streams, in the port as in the JAX package."""
    paged, _ = _both(mix, decode_mode="paged", slots=3)
    ref, _ = _both(mix, decode_mode="per_slot", slots=3)
    assert paged == ref


# ------------------------------------------------------- freeze / thaw --
@pytest.mark.parametrize("opts", ["gather", "kernel_int8"])
def test_freeze_thaw_same_engine_is_exact(opts):
    """Freeze every request after 3 steps and thaw it on the same engine
    (twins of ``test_paging.py::test_freeze_thaw_same_engine_is_exact``
    and ``test_paged_kernel.py::test_int8_freeze_thaw_same_engine_is_
    exact``): the streams equal the uninterrupted run's and the JAX
    engine's, with the same freezes and thaws."""
    mix = [(9, 6, 0, 1.2), (25, 6, 0, 0.0)]
    baseline, _ = _run(True, mix, decode_mode="paged", opts=opts)
    runs = []
    for port in (False, True):
        eng = _engine(port, decode_mode="paged", opts=opts)
        reqs = _requests(port, mix)
        moved = _freeze_after(eng, reqs, steps=3)
        assert all(r.frozen is not None for r in moved if r.generated)
        for r in moved:
            assert eng.thaw(r)
        eng.drain()
        runs.append(([tuple(r.generated) for r in reqs], eng.stats.freezes,
                     eng.stats.thaws, eng.stats.prefill_calls))
    assert runs[1] == runs[0]
    assert runs[1][0] == baseline
    assert runs[1][1] >= 1 and runs[1][2] >= 1


@pytest.mark.parametrize("dst_kw", [
    dict(decode_mode="paged", block_size=4),
    dict(decode_mode="paged", block_size=16),
    dict(decode_mode="batched"),
    dict(decode_mode="per_slot"),
], ids=["paged4", "paged16", "batched", "per_slot"])
def test_freeze_thaw_migrates_across_geometries(dst_kw):
    """A paged bs=8 source's blobs thaw on paged engines of other block
    sizes and on dense engines with zero re-prefill and the uninterrupted
    streams, as in the JAX package."""
    mix = [(9, 6, 0, 1.2), (25, 6, 0, 0.8), (30, 5, 0, 0.0)]
    baseline, _ = _run(True, mix, decode_mode="paged", slots=3)
    runs = []
    for port in (False, True):
        src = _engine(port, decode_mode="paged", block_size=8, slots=3)
        reqs = _requests(port, mix)
        moved = _freeze_after(src, reqs, steps=3)
        dst = _engine(port, slots=3, **dst_kw)
        fallback = [r for r in moved if r.frozen is None]
        for r in moved:
            assert dst.thaw(r)
        dst.drain()
        assert dst.stats.prefill_calls <= len(fallback)
        runs.append(([tuple(r.generated) for r in reqs],
                     dst.stats.prefill_calls, dst.stats.thaws))
    assert runs[1] == runs[0]
    assert runs[1][0] == baseline


def test_incompatible_blob_falls_back_without_token_loss():
    """A fingerprint mismatch drops the blob and re-prefills prompt +
    generated: earned tokens kept, full budgets, no thaw — and the same
    streams and prefill calls as the JAX engine's fallback."""
    mix = [(9, 6, 0, 1.2), (25, 6, 0, 0.0)]
    runs = []
    for port in (False, True):
        src = _engine(port, decode_mode="paged", params_version="v1")
        reqs = _requests(port, mix)
        moved = _freeze_after(src, reqs, steps=3)
        kept = {r.rid: tuple(r.generated) for r in moved}
        dst = _engine(port, decode_mode="paged", params_version="v2")
        frozen = [r for r in moved if r.frozen is not None]
        assert frozen and all(not dst.can_thaw(r.frozen) for r in frozen)
        for r in moved:
            dst.thaw(r)
        assert all(r.frozen is None for r in moved)
        dst.drain()
        assert dst.stats.prefill_calls > 0 and dst.stats.thaws == 0
        for r, (_, budget, _, _) in zip(reqs, mix):
            assert tuple(r.generated)[:len(kept[r.rid])] == kept[r.rid]
            assert len(r.generated) == budget
        runs.append(([tuple(r.generated) for r in reqs],
                     dst.stats.prefill_calls))
    assert runs[1] == runs[0]


@pytest.mark.parametrize("dst_opts", ["gather", "kernel", "gather_int8"])
def test_cross_kv_dtype_migration_zero_reprefill(dst_opts):
    """An int8-pool kernel source migrates onto bf16 and int8, gather and
    kernel destinations with zero re-prefill and no token loss, and the
    continuations equal the JAX engine's."""
    mix = [(9, 6, 0, 0.0), (25, 6, 0, 0.0)]
    runs = []
    for port in (False, True):
        src = _engine(port, decode_mode="paged", opts="kernel_int8")
        reqs = _requests(port, mix)
        moved = _freeze_after(src, reqs, steps=3)
        earned = {r.rid: tuple(r.generated) for r in moved}
        assert any(r.frozen is not None for r in moved)
        dst = _engine(port, decode_mode="paged", opts=dst_opts)
        for r in moved:
            assert dst.thaw(r)
        dst.drain()
        assert dst.stats.prefill_calls == 0
        for r, (_, budget, _, _) in zip(reqs, mix):
            assert tuple(r.generated)[:len(earned[r.rid])] == earned[r.rid]
            assert len(r.generated) == budget
        runs.append([tuple(r.generated) for r in reqs])
    assert runs[1] == runs[0]


@pytest.mark.parametrize("decode_mode", ["batched", "paged"])
def test_swap_model_same_params_reprefills_nothing(decode_mode):
    """A same-binding ``swap_model`` freezes, rebuilds and thaws: zero
    extra prefill calls and the unswapped streams, as in JAX."""
    mix = [(9, 6, 0, 1.2), (25, 6, 0, 0.8), (14, 6, 0, 0.0)]
    baseline, _ = _run(True, mix, decode_mode=decode_mode, slots=3)
    runs = []
    for port in (False, True):
        eng = _engine(port, decode_mode=decode_mode, slots=3)
        reqs = _requests(port, mix)
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        calls = eng.stats.prefill_calls
        if port:
            eng.swap_model(T_CFG, T_PARAMS, eng.opts)
        else:
            eng.swap_model(J_CFG, J_PARAMS, eng.opts)
        eng.drain()
        assert eng.stats.prefill_calls == calls
        assert eng.generation == 1
        runs.append(([tuple(r.generated) for r in reqs],
                     eng.stats.requeues, eng.stats.thaws))
    assert runs[1] == runs[0]
    assert runs[1][0] == baseline
    assert runs[1][1] == runs[1][2] == 3


@pytest.mark.parametrize("opts", ["gather", "kernel_int8"])
def test_tight_pool_backpressure_and_preemption_stay_exact(opts):
    """A pool one block above the single-slot minimum forces admission
    backpressure and decode-tail preemption: the streams equal the dense
    run's and the JAX engine's, with the JAX engine's freezes, thaws,
    requeues and prefill calls; every table ends on the trash block."""
    mix = [(5, 30, 0, 0.7), (11, 30, 0, 0.0), (7, 25, 1, 1.4)]
    baseline, _ = _run(True, mix, decode_mode="batched", max_steps=600)
    streams, eng = _both(mix, decode_mode="paged", block_size=16,
                         pool_blocks=6, opts=opts, max_steps=600)
    if opts == "gather":
        assert streams == baseline
    assert eng.stats.freezes >= 1
    assert eng.stats.thaws == eng.stats.freezes
    assert (eng.block_pool.tables == TRASH_BLOCK).all()
