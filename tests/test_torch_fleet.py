"""The port's fleet — registry, telemetry, controller, report — held
against the JAX package's.

Twins of ``tests/test_fleet.py`` and ``tests/test_fleet_async.py``.  The
same inputs (fleets from a seed, record sets, scenarios) go through
``repro.fleet`` and ``repro_torch.fleet``; their outputs are compared
field by field: exact for counts, ids, decisions and strings, ``rel
1e-12`` for floats.  The controller twins step simulated fleets in the
event and lockstep modes with placement and failure detection on, and
compare the records, every loop's decisions, the placement log, the
per-tier and per-channel calibrations, the metrics snapshot, the report
and the trace's ``(name, pid, sim_s)``.  The engine-backed twin (the
shared compile cache) serves the tiny ``paper-backbone`` with the JAX
weights carried over by the bridge.

This module also holds what the port's crowd twins share
(``test_torch_obs.py``, ``test_torch_faults.py``,
``test_torch_placement.py``): the package switch ``pkg``, the
comparison ``assert_same``, the engine clock ``FixedStepClock``, the
tiny config, one set of weights and one compile cache per package.
"""
import dataclasses
import importlib
import math
import random
from collections import deque
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import init_params as j_init_params
from repro.serving import CompileCache as JCompileCache
from repro_torch.configs import get_config
from repro_torch.serving import CompileCache
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

# the chaos/obs suites' tiny paper-backbone, in f32 so that the two
# packages' greedy streams are equal token for token
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=300,
            activation_dtype="float32")
J_TINY = j_get_config("paper-backbone").with_updates(**TINY)
T_TINY = get_config("paper-backbone").with_updates(**TINY)
J_PARAMS = j_init_params(J_TINY, jax.random.PRNGKey(0))
T_PARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, J_PARAMS),
                             "cpu")
J_CC, T_CC = JCompileCache(), CompileCache()

_MODULES = ("configs", "core.monitor", "core.optimizer", "core.profiler",
            "faults", "fleet", "fleet.placement", "models.configs", "obs",
            "offload", "serving")


def pkg(port: bool) -> SimpleNamespace:
    """One package's modules by short name (``p.fleet``, ``p.obs``, …),
    with its tiny config, weights, compile cache and engine device."""
    root = "repro_torch" if port else "repro"
    ns = SimpleNamespace(**{
        m.replace(".", "_"): importlib.import_module(f"{root}.{m}")
        for m in _MODULES})
    ns.port = port
    ns.tiny = T_TINY if port else J_TINY
    ns.params = T_PARAMS if port else J_PARAMS
    ns.cc = T_CC if port else J_CC
    ns.cfg = ns.configs.get_config("paper-backbone")
    ns.device_kw = {"device": "cpu"} if port else {}
    return ns


BOTH = (pkg(False), pkg(True))


class FixedStepClock:
    """A ``time`` stand-in whose ``perf_counter`` advances 1 ms a call:
    put in an engine module's place, it makes the engine's step times,
    and so the fleet's wake schedule, independent of the machine."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        self.now += 1e-3
        return self.now


def norm(x):
    """A plain, package-free form of ``x``: dataclasses become dicts
    tagged with their class name, sequences lists, numpy scalars
    Python numbers."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"<class>": type(x).__name__,
                **{f.name: norm(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {_key(k): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, deque)):
        return [norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return norm(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def _key(k):
    """A dict key in plain form (a dataclass key by its plain repr)."""
    return k if isinstance(k, (str, int, float, bool, type(None))) \
        else repr(norm(k))


def assert_same(a, b, path="$"):
    """``a`` and ``b`` (anything ``norm`` takes) are equal: floats within
    ``rel 1e-12``, everything else exactly."""
    a, b = norm(a), norm(b)
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            f"{path}: {a!r} vs {b!r}"
        assert (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=1e-12), f"{path}: {a!r} vs {b!r}"
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), \
            f"{path}: {list(a)} vs {list(b) if isinstance(b, dict) else b}"
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), \
            f"{path}: {len(a)} items vs {len(b) if isinstance(b, list) else b}"
        for i, (u, v) in enumerate(zip(a, b)):
            assert_same(u, v, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def controller_state(p, ctl, rec=None):
    """Everything a controller run decided and learned, in plain form."""
    f = p.fleet
    cals = {f"{tier}/{chan}": ctl.telemetry.calibration_for_tier(tier, chan)
            for tier in f.TIERS for chan in f.CHANNELS}
    state = {
        "records": ctl.records,
        "decisions": {did: ctl.loop_for(did).decisions
                      for did in ctl.tick_counts},
        "placement_log": ctl.placement_log,
        "tier_calibrations": cals,
        "device_calibrations": {did: ctl.calibration_of(did)
                                for did in ctl.tick_counts},
        "metrics": ctl.metrics.snapshot(),
        "tick_counts": ctl.tick_counts,
        "now_s": ctl.now_s,
        "report": f.fleet_report(ctl),
        "render": f.fleet_report(ctl).render(),
    }
    if rec is not None:
        state["trace"] = [(e.name, e.pid, e.sim_s) for e in rec.events]
    return state


# ------------------------------------------------------------ registry ----
def test_registry_and_fleets_match_reference():
    j, t = BOTH
    assert_same(j.fleet.PLATFORMS, t.fleet.PLATFORMS)
    assert_same(j.fleet.TIER_TICK_S, t.fleet.TIER_TICK_S)
    for n, seed, sites in [(15, 0, ("site0",)), (7, 3, ("a", "b")),
                           (30, 11, ("home", "dc", "edge"))]:
        fj = j.fleet.build_fleet(n, seed=seed, sites=sites)
        ft = t.fleet.build_fleet(n, seed=seed, sites=sites)
        assert_same(fj, ft)
        assert_same([d.tick_envelope for d in fj],
                    [d.tick_envelope for d in ft])
        assert [d.compile_domain for d in fj] == \
            [d.compile_domain for d in ft]
        for dj, dt in zip(fj[:6], ft[:6]):
            assert_same(list(j.fleet.device_trace(dj, 24)),
                        list(t.fleet.device_trace(dt, 24)))


def _records(p, n, seed=0, tier="light", channel="simulated",
             devices=("a", "b")):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        pr = float(rng.uniform(0.1, 1.0))
        recs.append(p.fleet.MeasurementRecord(
            device_id=devices[i % len(devices)], tier=tier, tick=i,
            predicted_latency_s=pr,
            observed_latency_s=1.5 * pr + 0.02 * rng.standard_normal(),
            predicted_energy_j=pr, observed_energy_j=1.3 * pr,
            channel=channel, timestamp_s=float(rng.uniform(0, 50))))
    return recs


@pytest.mark.parametrize("perm_seed", [0, 7, 23])
def test_telemetry_calibrations_match_reference_under_permutation(perm_seed):
    """Any arrival order of one record set gives the JAX store's fits,
    per tier, channel and device, and its accuracy estimates."""
    out = []
    for p in BOTH:
        f = p.fleet
        recs = (_records(p, 40, seed=1) + _records(
            p, 30, seed=2, channel=f.ENGINE, devices=("e",))
            + _records(p, 20, seed=3, tier="heavy", devices=("h0", "h1")))
        random.Random(perm_seed).shuffle(recs)
        store = f.TelemetryStore()
        for r in recs:
            store.record(r)
        for i in range(18):
            store.record_accuracy(f.AccuracyRecord(
                device_id="a", tier="light", tick=i, variant=f"v{i % 3}",
                predicted_accuracy=0.76,
                observed_accuracy=0.7 - 0.01 * (i % 4),
                drift=0.1 * (i % 5), timestamp_s=float((i * 7) % 18)))
        out.append({
            "tiers": {f"{tier}/{chan}": store.calibration_for_tier(tier, chan)
                      for tier in f.TIERS for chan in f.CHANNELS},
            "devices": {d: store.calibration_for_device(d)
                        for d in ("a", "b", "e", "h0", "h1")},
            "channels": {d: store.device_channel(d) for d in ("a", "e")},
            "mape": store.mape(tier="light",
                               calibration=store.calibration_for_tier(
                                   "light")),
            "accuracy": store.measured_accuracy_for_tier("light"),
            "accuracy_mae": store.accuracy_mae(tier="light"),
        })
    assert_same(*out)


# ---------------------------------------------------------- controller ----
def _fleet_run(p, step_mode, n, ticks):
    rec = p.obs.TraceRecorder()
    ctl = p.fleet.FleetController(
        p.fleet.build_fleet(n, seed=0, sites=("home", "dc")), p.cfg,
        p.models_configs.InputShape("fleet_t", 256, 4, "prefill"),
        trace_ticks=ticks, warmup_ticks=4, placement=True, recorder=rec,
        step_mode=step_mode, seed=3)
    ctl.run(ticks)
    return controller_state(p, ctl, rec)


@pytest.mark.parametrize("step_mode,n,ticks",
                         [("event", 6, 16), ("lockstep", 6, 16)])
def test_simulated_controller_matches_reference(step_mode, n, ticks):
    """Placement and failure detection on (event mode: the detector's
    sweeps ride the heap): the same records, decisions, placements,
    calibrations, metrics, report and trace."""
    j, t = (_fleet_run(p, step_mode, n, ticks) for p in BOTH)
    assert j["records"], "the fleet did not run"
    assert_same(j, t)


def test_drifty_fleet_accuracy_feedback_matches_reference():
    """``test_placement.py``'s drift regression: the crowd's accuracy
    channel reaches every evaluator's ``measured`` dict in both."""
    out = []
    for p in BOTH:
        drifty = p.core_monitor.ResourceContext(data_drift=0.6,
                                                battery_frac=0.9)
        fleet = p.fleet.build_fleet(6, seed=0)
        ctl = p.fleet.FleetController(
            fleet, p.cfg, p.models_configs.InputShape("fleet_t", 256, 4,
                                                      "prefill"),
            trace_ticks=16, warmup_ticks=4, recalibrate_every=2,
            trace_factory=lambda spec, n: p.core_monitor.constant_trace(
                drifty, n))
        ctl.run(16)
        out.append({**controller_state(p, ctl), "measured": {
            d.device_id: ctl.loop_for(d.device_id).evaluator.measured
            for d in fleet}})
    assert all(out[0]["measured"].values()), "no accuracy feedback"
    assert_same(*out)


def test_engine_ewma_feeds_next_wake_like_reference():
    """``test_fleet_async.py``'s duck-typed engine: an engine-backed
    member's wake period grows by its steps times the step EWMA, on the
    same schedule in both packages."""
    class _Eng:
        has_work = True
        step_time_ewma_s = 0.5

        def __init__(self):
            self.step_times = []

        def step(self):
            self.step_times.append(0.5)

    out = []
    for p in BOTH:
        fleet = [p.fleet.make_device("pixel_6_cpu", 0),
                 p.fleet.make_device("jetson_agx_orin", 0)]
        ctl = p.fleet.FleetController(
            fleet, p.cfg, p.models_configs.InputShape("fleet_a", 256, 4,
                                                      "prefill"),
            trace_ticks=100)
        ctl.attach_engine(fleet[0].device_id, _Eng(), steps_per_tick=2)
        ctl.run_for(12.0)
        out.append(controller_state(p, ctl))
    assert out[1]["tick_counts"]["pixel_6_cpu#0"] < 12
    assert_same(*out)


# ------------------------------------------- fleet-level compile cache ----
def test_same_platform_engines_share_programs_like_reference():
    """``test_fleet.py``'s shared-compile-cache case: the second engine
    of one platform binds nothing new, another platform binds its own;
    streams and ``recompiles`` as in JAX."""
    out = []
    for p in BOTH:
        fleet = [p.fleet.make_device("pixel_6_cpu", 0),
                 p.fleet.make_device("pixel_6_cpu", 1),
                 p.fleet.make_device("raspberry_pi4", 0)]
        ctl = p.fleet.FleetController(
            fleet, p.cfg, p.models_configs.InputShape("fleet_t", 256, 4,
                                                      "prefill"),
            trace_ticks=8, compile_cache=p.serving.CompileCache())
        runs = []
        for did in ("pixel_6_cpu#0", "pixel_6_cpu#1", "raspberry_pi4#0"):
            eng = ctl.build_engine(did, p.params, cfg=p.tiny, slots=2,
                                   max_seq=64, **p.device_kw)
            rng = np.random.default_rng(0)
            reqs = [p.serving.Request(rid=i, prompt=rng.integers(
                0, 300, size=8).astype(np.int32), max_new_tokens=4)
                for i in range(3)]
            for r in reqs:
                eng.submit(r)
            eng.drain()
            runs.append((eng.stats.recompiles > 0, eng.stats.tokens_out,
                         [tuple(r.generated) for r in reqs]))
        out.append(runs)
    assert [r[0] for r in out[1]] == [True, False, True]
    assert_same(*out)


def test_build_engine_checks_the_params_device():
    """``build_engine`` runs on the card unless asked for the CPU, and
    refuses params that live elsewhere than the engine."""
    t = BOTH[1]
    ctl = t.fleet.FleetController(
        [t.fleet.make_device("pixel_6_cpu", 0)], t.cfg,
        t.models_configs.InputShape("fleet_t", 256, 4, "prefill"),
        trace_ticks=4)
    with pytest.raises(ValueError, match="params live on"):
        ctl.build_engine("pixel_6_cpu#0", T_PARAMS, cfg=T_TINY)
    eng = ctl.build_engine("pixel_6_cpu#0", T_PARAMS, cfg=T_TINY,
                           device="cpu")
    assert eng.device.type == "cpu" and ctl.engine_of("pixel_6_cpu#0") \
        is eng
