"""The port's fault plane — detector, injector, recovery, report — held
against the JAX package's.

Twins of ``tests/test_chaos.py``.  The pure pieces (``random_schedule``
at the suite's ``CHAOS_SEEDS`` 7 and 23, the detector's state machine,
``execute_chain``, ``plan_migration``, ``summarize_faults``) take the
same inputs in both packages and must give the same outputs.  The chaos
runs step the suite's fleet (a loaded phone, two same-site helpers, a
WAN server) under those schedules with placement and detection on, and
compare records, decisions, placements, calibrations, metrics, the trace
and the fault summary.  The engine-backed twins serve the tiny
``paper-backbone`` (f32, the JAX weights through the bridge) on the CPU:
the injected crash that migrates in-flight requests, the eviction with no
peer, the injected OOM and ``requeue_active`` give the JAX streams,
thaws, prefills, migrations and fault summaries.  Both engines' step
clocks are pinned to a fixed-step counter there, so no wall-clock time
decides the wake order the twins compare.
"""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_fleet import (BOTH, FixedStepClock, assert_same,
                              controller_state)

CHAOS_SEEDS = (7, 23)

_ct_spec = importlib.util.spec_from_file_location(
    "check_trace",
    Path(__file__).resolve().parents[1] / "tools" / "check_trace.py")
check_trace = importlib.util.module_from_spec(_ct_spec)
_ct_spec.loader.exec_module(check_trace)


def _fleet(p):
    """The chaos suite's fleet: loaded phone, two same-site helpers, a
    WAN server."""
    mk = p.fleet.make_device
    return [mk("pixel_6_cpu", 0, site="home"),
            mk("jetson_agx_orin", 0, site="home"),
            mk("jetson_agx_orin", 1, site="home"),
            mk("edge_server_a100", 0, site="dc")]


def _controller(p, fleet, *, recorder, detector_config=None, seed=0):
    monitor = p.core_monitor
    loaded = monitor.ResourceContext(cpu_temp_derate=0.45,
                                     competing_procs=4)
    phone = fleet[0].device_id

    def tf(spec, n):
        return monitor.constant_trace(
            loaded if spec.device_id == phone
            else monitor.ResourceContext(), n)

    ctl = p.fleet.FleetController(
        list(fleet), p.cfg,
        p.models_configs.InputShape("chaos_t", 256, 4, "prefill"),
        trace_ticks=4000, trace_factory=tf, placement=True,
        allow_offload=False, detector_config=detector_config,
        warmup_ticks=4, recalibrate_every=2, seed=seed, recorder=recorder)
    ctl.set_sla(phone, 0.5)
    return ctl


@pytest.fixture
def pinned_clocks(monkeypatch):
    """Both engines' step clocks on a fixed-step counter."""
    for p in BOTH:
        monkeypatch.setattr(p.serving.engine, "time", FixedStepClock())


# ------------------------------------------------------------ pure parts ----
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_random_schedule_matches_reference(seed):
    out = [(p.faults.random_schedule(_fleet(p), 24.0, seed=seed,
                                     n_faults=6),
            p.faults.random_schedule(
                [p.fleet.make_device("pixel_6_cpu", 0, site="a"),
                 p.fleet.make_device("jetson_agx_orin", 0, site="b")],
                20.0, seed=seed, kinds=p.faults.FAULT_KINDS, n_faults=8,
                protect=["pixel_6_cpu#0"]),
            p.faults.schedule_to_json(p.faults.random_schedule(
                _fleet(p), 24.0, seed=seed)))
           for p in BOTH]
    assert_same(*out)


def test_detector_state_machine_matches_reference():
    """The suite's flap-and-quarantine walk plus a seeded beat/sweep
    sequence over three devices: the same transitions, states, flaps and
    quarantines."""
    out = []
    for p in BOTH:
        f = p.faults
        det = f.HeartbeatDetector(f.DetectorConfig(
            suspect_after=2.0, dead_after=4.0, quarantine_periods=4.0,
            flap_backoff_cap=4.0))
        log = []
        for i, did in enumerate(("a", "b", "c")):
            det.track(did, period_s=0.5 + 0.25 * i, now_s=0.0)
        rng = np.random.default_rng(5)
        now = 0.0
        for step in range(120):
            now += float(rng.uniform(0.05, 0.6))
            for did in ("a", "b", "c"):
                # "b" goes silent for a stretch, "c" flaps
                silent = (did == "b" and 30 <= step < 60) or (
                    did == "c" and (step // 12) % 2 == 1)
                if not silent and rng.random() < 0.8:
                    log.append(("beat", det.beat(did, now)))
            log.append(("sweep", det.sweep(now)))
            log.append({did: (det.state(did), det.flaps(did),
                              det.quarantined_until(did),
                              det.quarantined(did, now))
                        for did in ("a", "b", "c")})
        det.untrack("b")
        log.append((det.tracked(), det.sweep(now + 100.0),
                    det.beat("b", now + 100.0)))
        out.append(log)
    edges = [e.state for row in out[0]
             if isinstance(row, tuple) and row[0] == "sweep" for e in row[1]]
    assert {"suspect", "dead"} <= set(edges)
    assert_same(*out)


def test_execute_chain_and_plan_migration_match_reference():
    out = []
    for p in BOTH:
        f = p.faults
        pol = f.RetryPolicy(max_retries=2, base_backoff_s=0.1,
                            backoff_factor=2.0, max_backoff_s=0.15,
                            timeout_scale=3.0, min_timeout_s=0.05)
        calls = {"n": 0}

        def flaky(h):
            calls["n"] += 1
            return calls["n"] > 2

        chains = [f.execute_chain(("a", "b", "c"), 0.1, lambda h: True, pol),
                  f.execute_chain(("a", "b", "c"), 0.1,
                                  lambda h: h != "c", pol),
                  f.execute_chain(("a", "b"), 0.1, flaky, pol),
                  f.execute_chain(("a", "b", "c", "d"), 0.02,
                                  lambda h: h in ("b", "d"), f.RetryPolicy())]
        reqs = [SimpleNamespace(rid=i, frozen=None if i % 3 == 0 else i,
                                generated=list(range(i)))
                for i in range(7)]
        plan = f.plan_migration(reqs, lambda blob: blob % 2 == 1)
        out.append((chains, [pol.backoff_s(k) for k in range(4)],
                    pol.timeout_s(0.001), pol.worst_case_s(0.1),
                    plan, plan.total))
    assert_same(*out)


# ----------------------------------------------------------- chaos runs ----
def _chaos_run(p, seed):
    rec = p.obs.TraceRecorder()
    fleet = _fleet(p)
    ctl = _controller(p, fleet, recorder=rec, seed=seed,
                      detector_config=p.faults.DetectorConfig(
                          suspect_after=2.5, dead_after=5.0))
    schedule = p.faults.random_schedule(fleet, 24.0, seed=seed,
                                        n_faults=4,
                                        protect=[fleet[0].device_id])
    inj = p.faults.FaultInjector(ctl, schedule).arm()
    ctl.run_for(24.0)
    return rec, {**controller_state(p, ctl, rec),
                 "applied": inj.applied, "skipped": inj.skipped,
                 "faults": p.faults.summarize_faults(rec.events)}


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_run_matches_reference(seed, tmp_path):
    """``test_chaos.py``'s randomized schedule at a fixed seed: the same
    run, and the port's trace validates under ``tools/check_trace.py``."""
    (_, j), (rec, t) = (_chaos_run(p, seed) for p in BOTH)
    assert j["applied"] or j["skipped"]
    assert_same(j, t)
    path = tmp_path / "chaos.json"
    BOTH[1].obs.write_trace(rec, str(path))
    assert check_trace.check(path, require_layers=("fleet",
                                                   "placement")) == 0


# ------------------------------------------------------- engine twins ----
def _streams(reqs):
    return {r.rid: tuple(r.generated) for r in reqs}


def _engine(p, **kw):
    kw.setdefault("slots", 2)
    return p.serving.ServingEngine(p.tiny, p.params, max_seq=64,
                                   compile_cache=p.cc, **p.device_kw, **kw)


def _submit_mix(p, eng, budget=6):
    reqs = []
    for i in range(4):
        rng = np.random.default_rng(31 * i + 5)
        r = p.serving.Request(
            rid=i, prompt=rng.integers(0, 300, size=5 + i).astype(np.int32),
            max_new_tokens=budget)
        reqs.append(r)
        eng.submit(r)
    return reqs


def _baseline(p, budget=6):
    eng = _engine(p)
    reqs = _submit_mix(p, eng, budget)
    eng.drain()
    return _streams(reqs)


def _crash_migration(p, tmp_path):
    want = _baseline(p, budget=30)
    fleet = _fleet(p)
    src_id, dst_id = fleet[1].device_id, fleet[2].device_id
    rec = p.obs.TraceRecorder()
    ctl = _controller(p, fleet, recorder=rec,
                      detector_config=p.faults.DetectorConfig(
                          suspect_after=2.5, dead_after=5.0))
    src = ctl.build_engine(src_id, p.params, cfg=p.tiny, slots=2,
                           max_seq=64, decode_mode="paged",
                           steps_per_tick=1, **p.device_kw)
    dst = ctl.build_engine(dst_id, p.params, cfg=p.tiny, slots=2,
                           max_seq=64, steps_per_tick=4, **p.device_kw)
    reqs = _submit_mix(p, src, budget=30)
    src.step()
    src.step()
    p.faults.FaultInjector(ctl, [p.faults.FaultSpec(
        p.faults.CRASH, src_id, at_s=ctl.now_s + 0.5)]).arm()
    ctl.run_for(20.0)
    dst.drain()
    path = tmp_path / f"migration_{p.port}.json"
    p.obs.write_trace(rec, str(path))
    attrs = p.obs.attribute_requests(rec)
    [mig] = [e.args for e in rec.events if e.name == "fleet.migrate"]
    return {"streams": _streams(reqs), "unfaulted": want,
            "evicts": [e.args for e in rec.events
                       if e.name == "fleet.evict"],
            "migrations": ctl.migrations, "migrate": mig,
            "dst": (dst.stats.thaws, dst.stats.prefills,
                    dst.stats.prefill_calls),
            "src": (src.stats.freezes, src.stats.prefills),
            "faults": p.faults.summarize_faults(rec.events),
            "offload_link": {rid: a.components_ns["offload_link"] > 0
                             for rid, a in attrs.items()},
            "trace_ok": check_trace.check(
                path, require_layers=p.obs.LAYERS),
            "state": controller_state(p, ctl, rec)}


def test_injected_crash_migrates_in_flight_requests_like_reference(
        pinned_clocks, tmp_path):
    """CRASH on the paged helper: the detector evicts it, its two decoding
    requests freeze and thaw on the dense peer, the two waiting ones move;
    streams equal the unfaulted run's and the JAX run's, zero re-prefill."""
    j, t = (_crash_migration(p, tmp_path) for p in BOTH)
    assert t["streams"] == t["unfaulted"] == j["streams"]
    assert t["migrations"] == 4 and t["dst"][:2] == (2, 2)
    assert t["faults"]["migrated_reprefills"] == 0
    assert t["trace_ok"] == 0
    assert_same(j, t)


def test_eviction_without_peer_requeues_locally_like_reference(
        pinned_clocks):
    out = []
    for p in BOTH:
        fleet = _fleet(p)
        src_id = fleet[3].device_id
        rec = p.obs.TraceRecorder()
        ctl = _controller(p, fleet, recorder=rec)
        src = ctl.build_engine(src_id, p.params, cfg=p.tiny, slots=2,
                               max_seq=64, decode_mode="paged",
                               steps_per_tick=1, **p.device_kw)
        reqs = _submit_mix(p, src, budget=6)
        src.step()
        ctl.drop_device(src_id)
        src.drain()
        out.append({"streams": _streams(reqs), "want": _baseline(p),
                    "migrations": ctl.migrations,
                    "stats": (src.stats.requeues, src.stats.thaws,
                              src.stats.prefills, src.stats.tokens_out),
                    "faults": p.faults.summarize_faults(rec.events)})
    assert out[1]["migrations"] == 0
    assert out[1]["streams"] == out[1]["want"]
    assert_same(*out)


def test_oom_injection_and_requeue_like_reference():
    """Injected OOMs back admission off exponentially and lose no token;
    ``requeue_active`` resumes every stream where it stopped."""
    out = []
    for p in BOTH:
        want = _baseline(p)
        eng = _engine(p)
        reqs = _submit_mix(p, eng)
        eng.step()
        eng.inject_oom(2)
        eng.drain()
        oom = (_streams(reqs), eng.stats.oom_events, eng._oom_backoff,
               eng._oom_pending)
        eng2 = _engine(p)
        _submit_mix(p, eng2)
        eng2.inject_oom(3)
        holdoffs = []
        while eng2._oom_pending:
            eng2._admit()
            holdoffs.append(eng2._admit_holdoff)
            eng2._admit_holdoff = 0
        eng3 = _engine(p)
        reqs3 = _submit_mix(p, eng3)
        eng3.step()
        n = eng3.requeue_active(reason="failover")
        final = {r.rid: r for r in reqs3}
        final.update({r.rid: r for r in eng3._queue})
        eng3.drain()
        out.append({"want": want, "oom": oom, "holdoffs": holdoffs,
                    "requeued": (n, eng3.stats.requeues,
                                 eng3.stats.tokens_out),
                    "requeue_streams": {rid: tuple(r.generated)
                                        for rid, r in final.items()}})
    t = out[1]
    assert t["oom"][0] == t["want"] and t["oom"][1:] == (2, 0, 0)
    assert t["holdoffs"] == [1, 2, 4]
    assert t["requeue_streams"] == t["want"]
    assert_same(*out)
