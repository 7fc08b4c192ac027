"""The port's adaptation loop (``repro_torch.core``) held against the JAX
package's ``repro.core``: twins of ``tests/test_core.py`` (all but
``test_collective_parse_handles_layouts``: the HLO parsers serve the
dry-run launcher, which is not ported), the profiler's estimates, the
monitor's traces, the loop's decisions along ``budget_sweep_trace`` and
``case_study_trace(24)`` and the ``Middleware`` quickstart flow on the
CPU.

The core is host-side arithmetic on configs: the same Python and numpy
operations in the same order, so estimates, Pareto fronts and decisions
must be equal (estimates within 1e-12 relative).  Where the JAX side
uses ``TPU_V5E``, the port is given a ``HardwareProfile`` built from the
same fields; the port itself carries only ``H100_SXM`` and the paper's
simulated ``MOBILE_CPU``.  Nothing here times anything: the calibration
twin compares estimates, never wall-clock ranks.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
import hypothesis.strategies as st
from hypothesis import given, settings

import jax
import jax.numpy as jnp

import repro.core as J
from repro.configs import get_config as j_get_config
from repro.elastic import ElasticSupernet as JSupernet
from repro.elastic import VariantSpec as JSpec
from repro.models import model as jm
from repro.models.configs import INPUT_SHAPES as J_SHAPES
from repro.models.configs import InputShape as JShape
import repro_torch.core as T
from repro_torch.configs import get_config
from repro_torch.core.actions import Action, default_action_space
from repro_torch.elastic import ElasticSupernet, VariantSpec
from repro_torch.models.configs import INPUT_SHAPES, InputShape
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

CFG = get_config("paper-backbone")
J_CFG = j_get_config("paper-backbone")
SHAPE = InputShape("t", 512, 8, "prefill")
J_SHAPE = JShape("t", 512, 8, "prefill")
# the JAX package's TPU figures, as a port profile (the port carries none)
TPU_FIELDS = T.HardwareProfile(**dataclasses.asdict(J.TPU_V5E))
APP = InputShape("app", 256, 4, "prefill")
J_APP = JShape("app", 256, 4, "prefill")


def _spec(s):
    return dataclasses.asdict(s)


def _action(a):
    return (_spec(a.variant), dataclasses.asdict(a.offload),
            dataclasses.asdict(a.engine))


def _assert_evals_equal(ts, js):
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        assert _action(t.action) == _action(j.action)
        np.testing.assert_allclose(
            [t.accuracy, t.energy_j, t.latency_s, t.memory_bytes],
            [j.accuracy, j.energy_j, j.latency_s, j.memory_bytes],
            rtol=1e-12)


# ------------------------------------------------- twins of test_core ----
def test_layer_costs_structure():
    costs = T.layer_costs(CFG, 2, 128)
    # attn + ffn per layer + lm head
    assert len(costs) == 2 * CFG.num_layers + 1
    assert all(c.macs > 0 and c.bytes > 0 for c in costs)


def test_eq2_latency_monotone_in_eps():
    """Higher cache-hit-rate must never increase latency (paper Eq. 2)."""
    costs = T.layer_costs(CFG, 2, 128)
    lats = [T.estimate_latency(costs, eps) for eps in (0.1, 0.5, 0.9)]
    assert lats[0] > lats[1] > lats[2]


def test_eq1_energy_monotone_in_eps():
    costs = T.layer_costs(CFG, 2, 128)
    es = [T.estimate_energy(costs, eps) for eps in (0.1, 0.5, 0.9)]
    assert es[0] > es[1] > es[2]


def test_profiler_ranks_model_sizes():
    """Bigger variants must rank strictly slower/hungrier."""
    sizes = [0.5, 0.75, 1.0]
    lats, ens = [], []
    for r in sizes:
        c = CFG.with_updates(d_ff=int(CFG.d_ff * r),
                             num_layers=max(1, int(CFG.num_layers * r)))
        costs = T.layer_costs(c, 2, 128)
        lats.append(T.estimate_latency(costs, 0.5))
        ens.append(T.estimate_energy(costs, 0.5))
    assert T.rank_consistency(lats, [1, 2, 3]) == 1.0
    assert T.rank_consistency(ens, [1, 2, 3]) == 1.0


def test_analytic_step_costs_scale_with_work():
    f_tr, b_tr = T.analytic_step_costs(CFG, INPUT_SHAPES["train_4k"], "full")
    f_fw, _ = T.analytic_step_costs(CFG, INPUT_SHAPES["train_4k"])
    f_pf, b_pf = T.analytic_step_costs(CFG, INPUT_SHAPES["prefill_32k"])
    f_dc, b_dc = T.analytic_step_costs(CFG, INPUT_SHAPES["decode_32k"])
    assert f_tr > f_fw          # remat adds recompute
    assert f_tr > f_dc and f_pf > f_dc
    assert b_dc > 0
    for name, remat in (("train_4k", "full"), ("train_4k", "dots"),
                        ("prefill_32k", "none"), ("decode_32k", "none")):
        assert T.analytic_step_costs(CFG, INPUT_SHAPES[name], remat) == \
            J.analytic_step_costs(J_CFG, J_SHAPES[name], remat)
        assert T.model_flops_estimate(CFG, INPUT_SHAPES[name]) == \
            J.model_flops_estimate(J_CFG, J_SHAPES[name])


def test_pareto_front_is_nondominated():
    ev = T.ActionEvaluator(CFG, SHAPE, TPU_FIELDS)
    ctx = T.ResourceContext()
    actions = default_action_space(
        (VariantSpec(), VariantSpec(depth_ratio=0.5),
         VariantSpec(width_ratio=0.5)), allow_offload=False)
    evals = [ev.evaluate(a, ctx) for a in actions]
    front = T.nondominated_front(evals)
    assert front
    for e in front:
        for f in evals:
            assert not (f.accuracy > e.accuracy and f.energy_j < e.energy_j)
    j_ev = J.ActionEvaluator(J_CFG, J_SHAPE)
    j_evals = [j_ev.evaluate(a, J.ResourceContext())
               for a in J.actions.default_action_space(
                   (JSpec(), JSpec(depth_ratio=0.5),
                    JSpec(width_ratio=0.5)), allow_offload=False)]
    _assert_evals_equal(evals, j_evals)
    _assert_evals_equal(front, J.nondominated_front(j_evals))


def test_select_online_respects_budgets():
    ev = T.ActionEvaluator(CFG, SHAPE, TPU_FIELDS)
    ctx = T.ResourceContext(battery_frac=0.5)
    actions = default_action_space(
        (VariantSpec(), VariantSpec(depth_ratio=0.5)), allow_offload=False)
    evals = [ev.evaluate(a, ctx) for a in actions]
    front = T.nondominated_front(evals)
    mem_cap = np.median([e.memory_bytes for e in front])
    choice = T.select_online(front, ctx, T.Budgets(memory_bytes=mem_cap))
    assert choice is not None
    assert choice.memory_bytes <= mem_cap


def test_mu_tradeoff_direction():
    """Low battery (μ→0) must pick lower-energy actions than high battery."""
    ev = T.ActionEvaluator(CFG, SHAPE)
    actions = default_action_space(
        (VariantSpec(), VariantSpec(depth_ratio=0.5, width_ratio=0.5)),
        allow_offload=False)
    front = T.nondominated_front(
        [ev.evaluate(a, T.ResourceContext()) for a in actions])
    rich = T.select_online(front, T.ResourceContext(battery_frac=0.95),
                           T.Budgets())
    poor = T.select_online(front, T.ResourceContext(battery_frac=0.05),
                           T.Budgets())
    assert poor.energy_j <= rich.energy_j


@settings(max_examples=20, deadline=None)
@given(st.floats(0.05, 0.95), st.floats(0.05, 0.95))
def test_ahp_weights_valid(bat, mem):
    w = T.context_ahp(T.ResourceContext(battery_frac=bat, mem_free_frac=mem))
    assert abs(float(w.sum()) - 1.0) < 1e-6
    assert all(float(x) >= 0 for x in w)
    np.testing.assert_array_equal(w, J.context_ahp(J.ResourceContext(
        battery_frac=bat, mem_free_frac=mem)))


def test_ahp_pairwise_eigenvector():
    m = np.array([[1.0, 3.0], [1 / 3.0, 1.0]])
    w = T.ahp_weights(m)
    assert w[0] > w[1]
    np.testing.assert_allclose(w[0] / w[1], 3.0, rtol=1e-6)


def test_loop_budget_sweep_shrinks_memory():
    """Paper Table II: tighter memory budgets -> smaller selected memory."""
    loops = [T.AdaptationLoop(cfg=CFG, shape=SHAPE, hw=TPU_FIELDS,
                              allow_offload=False, hysteresis=0.0),
             J.AdaptationLoop(cfg=J_CFG, shape=J_SHAPE, allow_offload=False,
                              hysteresis=0.0)]
    mems = []
    for loop, mod in zip(loops, (T, J)):
        loop.build_pareto(evolve=False)
        row = []
        for ctx in mod.budget_sweep_trace((1.0, 0.5, 0.25)):
            # scale hbm budget context: one chip
            ctx = dataclasses.replace(ctx, chips_available=1)
            row.append(loop.tick(ctx).eval.memory_bytes)
        mems.append(row)
    assert mems[0][-1] <= mems[0][0]
    assert mems[0] == mems[1]


def test_loop_hysteresis_holds():
    loop = T.AdaptationLoop(cfg=CFG, shape=SHAPE, allow_offload=False,
                            hysteresis=10.0)  # huge: never switch
    ctx0 = T.ResourceContext()
    d0 = loop.tick(ctx0)
    d1 = loop.tick(dataclasses.replace(ctx0, battery_frac=0.5))
    assert d1.action == d0.action
    assert "hold" in d1.reason


def test_case_study_trace_shape():
    tr = list(T.case_study_trace(10))
    assert len(tr) == 10
    assert tr[0].battery_frac > tr[-1].battery_frac
    assert any(c.mem_free_frac < 0.4 for c in tr)
    for make in (lambda m: m.case_study_trace(24, seed=3),
                 lambda m: m.budget_sweep_trace(),
                 lambda m: m.dvfs_spike_trace(9),
                 lambda m: m.constant_trace(m.ResourceContext(), 3),
                 lambda m: m.shaped_trace(m.case_study_trace(6),
                                          battery_scale=0.5, chips=4)):
        assert [dataclasses.asdict(c) for c in make(T)] == \
            [dataclasses.asdict(c) for c in make(J)]


# ------------------------------------------------------- the profiler ----
def test_h100_profile_states_the_card():
    hw = T.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes, hw.peak_w) == \
        (989e12, 3.35e12, 80e9, 700.0)
    assert 0 < hw.idle_w < hw.peak_w
    assert T.MOBILE_CPU == T.HardwareProfile(
        **dataclasses.asdict(J.MOBILE_CPU))
    assert not hasattr(T, "TPU_V5E")
    # the loop, evaluator and middleware default to the card
    assert T.AdaptationLoop.__dataclass_fields__["hw"].default is hw
    assert T.Middleware.__dataclass_fields__["hw"].default is hw
    assert T.ActionEvaluator(CFG, SHAPE).hw is hw


@pytest.mark.parametrize("name", ["paper-backbone", "mamba2-370m",
                                  "olmoe-1b-7b", "whisper-small",
                                  "gemma3-12b"])
@pytest.mark.parametrize("decode", [False, True])
def test_estimates_match_reference(name, decode):
    cfg, j_cfg = get_config(name), j_get_config(name)
    costs = T.layer_costs(cfg, 4, 1024, decode=decode, kv_bytes=1)
    j_costs = J.layer_costs(j_cfg, 4, 1024, decode=decode, kv_bytes=1)
    assert [dataclasses.astuple(c) for c in costs] == \
        [dataclasses.astuple(c) for c in j_costs]
    for hw, j_hw in ((TPU_FIELDS, J.TPU_V5E), (T.MOBILE_CPU, J.MOBILE_CPU)):
        for eps in (0.3, 0.7):
            assert T.estimate_latency(costs, eps, hw) == \
                J.estimate_latency(j_costs, eps, j_hw)
            assert T.estimate_latency(costs, eps, hw, 1e12) == \
                J.estimate_latency(j_costs, eps, j_hw, 1e12)
            assert T.estimate_energy(costs, eps, hw) == \
                J.estimate_energy(j_costs, eps, j_hw)


def test_roofline_and_rank_consistency_match_reference():
    for args in ((1e15, 3e12, 5e9, 1, 8e14), (4e16, 1e13, 2e11, 4, 0.0)):
        t = T.roofline_terms(*args, hw=TPU_FIELDS)
        j = J.roofline_terms(*args, hw=J.TPU_V5E)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.dominant, t.bound_s, t.useful_compute_ratio) == \
            (j.dominant, j.bound_s, j.useful_compute_ratio)
    rng = np.random.default_rng(0)
    for n in (1, 2, 7):
        est, act = rng.random(n).tolist(), rng.random(n).tolist()
        assert T.rank_consistency(est, act) == J.rank_consistency(est, act)


def test_calibrated_estimates_match_reference():
    """The twin of the profiler-calibration test, on estimates only: the
    variant ladder's Eq.(2) latencies under each profile equal the JAX
    package's, fall with the variant's size, and a telemetry
    ``Calibration`` maps them the same way in both packages."""
    ladder = [VariantSpec(), VariantSpec(width_ratio=0.75),
              VariantSpec(width_ratio=0.5, depth_ratio=0.75),
              VariantSpec(width_ratio=0.5, depth_ratio=0.5)]
    sn, j_sn = ElasticSupernet(CFG, {}), JSupernet(J_CFG, {})
    cal = T.Calibration(latency_scale=1.3, latency_bias_s=2e-3,
                        energy_scale=0.8, samples=5)
    j_cal = J.Calibration(**dataclasses.asdict(cal))
    for hw, j_hw in ((T.MOBILE_CPU, J.MOBILE_CPU), (TPU_FIELDS, J.TPU_V5E)):
        ests = []
        ev = T.ActionEvaluator(CFG, APP, hw, calibration=cal)
        j_ev = J.ActionEvaluator(J_CFG, J_APP, j_hw, calibration=j_cal)
        for spec in ladder:
            vcfg = ev._variant_cfg(spec)
            est = T.estimate_latency(T.layer_costs(vcfg, 2, 256), 0.5, hw)
            assert est == J.estimate_latency(J.layer_costs(
                j_ev._variant_cfg(JSpec(**_spec(spec))), 2, 256), 0.5, j_hw)
            ests.append(est)
            for raw in (True, False):
                t = ev.evaluate(Action(variant=spec), T.ResourceContext(),
                                calibrate=raw)
                j = j_ev.evaluate(J.Action(variant=JSpec(**_spec(spec))),
                                  J.ResourceContext(), calibrate=raw)
                _assert_evals_equal([t], [j])
        assert T.rank_consistency(ests, [4, 3, 2, 1]) == 1.0
        assert sn.cost(ladder[2]) == j_sn.cost(JSpec(**_spec(ladder[2])))


# ----------------------------------------------- the loop and middleware --
def _loop_pair(evolve):
    loops = []
    for mod, cfg, shape, sn, hw in (
            (T, CFG, APP, ElasticSupernet(CFG, {}), TPU_FIELDS),
            (J, J_CFG, J_APP, JSupernet(J_CFG, {}), J.TPU_V5E)):
        loop = mod.AdaptationLoop(cfg=cfg, shape=shape, supernet=sn, hw=hw,
                                  budgets=mod.Budgets(latency_s=0.05,
                                                      memory_bytes=2e9))
        loop.build_pareto(evolve=evolve)
        loops.append(loop)
    return loops


@pytest.mark.parametrize("trace", ["budget_sweep", "case_study"])
@pytest.mark.parametrize("evolve", [False, True])
def test_loop_decisions_match_reference(trace, evolve):
    loop, j_loop = _loop_pair(evolve)
    _assert_evals_equal(loop.front, j_loop.front)
    make = {"budget_sweep": lambda m: m.budget_sweep_trace(),
            "case_study": lambda m: m.case_study_trace(24)}[trace]
    ds = loop.run_trace(make(T))
    j_ds = j_loop.run_trace(make(J))
    assert len(ds) == len(j_ds) > 0
    for d, j in zip(ds, j_ds):
        assert (d.tick, d.reason, _action(d.action)) == \
            (j.tick, j.reason, _action(j.action))
        _assert_evals_equal([d.eval], [j.eval])


def test_middleware_quickstart_flow_on_cpu():
    """``examples/quickstart.py`` on the port, on the CPU: the same
    decisions as the JAX middleware (under the TPU-valued profile), the
    logits of each tick's variant equal to JAX's forward of the same
    variant, then TTA on a drifted context."""
    j_cfg = J_CFG.with_updates(activation_dtype="float32")
    cfg = CFG.with_updates(activation_dtype="float32")
    j_params = jm.init_params(j_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_params),
                               "cpu")
    kw = dict(shape=APP, hw=TPU_FIELDS,
              budgets=T.Budgets(latency_s=0.05, memory_bytes=2e9))
    mw = T.Middleware(cfg=cfg, params=params, **kw)
    j_mw = J.Middleware(cfg=j_cfg, params=j_params, shape=J_APP,
                        budgets=J.Budgets(latency_s=0.05, memory_bytes=2e9))
    assert len(mw.loop.front) == len(j_mw.loop.front) > 0
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (2, 64)).astype(np.int32)
    for ctx in (dict(battery_frac=0.95), dict(battery_frac=0.15),
                dict(battery_frac=0.5, mem_free_frac=0.2)):
        d = mw.adapt(T.ResourceContext(**ctx))
        j_d = j_mw.adapt(J.ResourceContext(**ctx))
        assert (d.reason, _action(d.action)) == (j_d.reason,
                                                 _action(j_d.action))
        logits = mw.infer(torch.from_numpy(tokens))
        assert logits.shape == (2, 64, cfg.padded_vocab)
        assert not logits.requires_grad
        j_logits = j_mw.infer(jnp.asarray(tokens))
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   atol=1e-4)
    assert "θp=" in mw.report()
    # drift: one TTA step on the live tokens updates the backbone's norms
    ln1 = mw.supernet.backbone_params["layers"]["ln1"]
    ent = mw.adapt_weights(torch.from_numpy(tokens), lr=5e-2)
    assert np.isfinite(ent)
    assert not torch.equal(mw.supernet.backbone_params["layers"]["ln1"], ln1)
    assert mw.supernet._cache == {}
    assert "logit_bias" in mw.supernet.backbone_params


def test_loop_hooks_match_reference():
    """The hooks the fleet drives: trace instants of the monitor and the
    loop, SLO pressure (cheapest variant, no hysteresis), a telemetry
    calibration (front rebuilt under it), offload targets and
    ``abandon_current`` — the same decisions and events as the JAX
    loop's."""
    from repro.obs import TraceRecorder as JRecorder
    from repro_torch.obs import TraceRecorder
    loop, j_loop = _loop_pair(False)
    rec, j_rec = TraceRecorder(), JRecorder()
    for lp, r in ((loop, rec), (j_loop, j_rec)):
        lp.recorder = lp.monitor.recorder = r
    cal = dict(latency_scale=2.0, latency_bias_s=1e-3, energy_scale=1.5,
               samples=3)
    for mod, lp in ((T, loop), (J, j_loop)):
        ctx = mod.ResourceContext(battery_frac=0.4)
        lp.tick(ctx)
        lp.set_pressure(1.0)
        lp.tick(ctx)
        lp.set_pressure(0.0)
        lp.set_calibration(mod.Calibration(**cal))
        assert lp.front == []
        lp.tick(dataclasses.replace(ctx, mem_free_frac=0.1))
        lp.set_offload_targets([mod.OffloadChoice(True, "edge_pair", 2)])
        lp.abandon_current()
        lp.tick(ctx)
    assert [(d.tick, d.reason, _action(d.action)) for d in loop.decisions] \
        == [(d.tick, d.reason, _action(d.action)) for d in j_loop.decisions]
    assert loop.decisions[1].reason == "slo_pressure"
    assert [(e.name, e.ph, e.pid, e.tid, e.args) for e in rec.events] == \
        [(e.name, e.ph, e.pid, e.tid, e.args) for e in j_rec.events]
    assert {e.name for e in rec.events} == {"monitor.context", "loop.decide"}
