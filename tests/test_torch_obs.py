"""The port's observability layer — query, export, flight, SLO, analysis —
held against the JAX package's, and the port's twins of the engine- and
fleet-backed cases of ``tests/test_obs.py`` and ``tests/test_attribution.py``.

* One recorded event list (a traced fleet run with an engine-backed
  member and a mid-run ``drop_device``) goes through both packages'
  ``query``, ``export.chrome_trace``, ``analysis`` and
  ``faults.summarize_faults``, and through a ``FlightRecorder`` of each:
  equal outputs, the Chrome trace's JSON equal byte for byte.
* ``SLOTracker``: one seeded stream of observations and clock readings,
  the same burn, pressure, windows, metrics and trace instants.
* The fleet run itself, with both engines' step clocks pinned to a
  fixed-step counter: the same records, calibrations and trace.
* ``test_attribution.py``'s decode-mode case on the port's engine: its
  invariant, and the JAX engine's event sequence.
* The twin of ``test_slo_spike_pages_and_downshifts_within_two_wakes``
  (R5): the port's engine clock is pinned, so no wall-clock time decides
  the wake order after the page that the test asserts.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from test_torch_fleet import (BOTH, FixedStepClock, assert_same,
                              controller_state)

_ct_spec = importlib.util.spec_from_file_location(
    "check_trace",
    Path(__file__).resolve().parents[1] / "tools" / "check_trace.py")
check_trace = importlib.util.module_from_spec(_ct_spec)
_ct_spec.loader.exec_module(check_trace)


def _prompt(length, rid):
    rng = np.random.default_rng(101 * length + rid)
    return rng.integers(0, 300, size=length).astype(np.int32)


def _shape(p):
    return p.models_configs.InputShape("obs_t", 128, 2, "decode")


def _fleet_run(p):
    """``test_obs.py``'s traced fleet: five devices, placement on, the
    light member engine-backed, one member dropped mid-run."""
    fleet = p.fleet.build_fleet(5, seed=0)
    rec = p.obs.TraceRecorder()
    ctl = p.fleet.FleetController(fleet, p.cfg, _shape(p), trace_ticks=400,
                                  warmup_ticks=2, placement=True,
                                  recorder=rec)
    dev = next(d for d in fleet if d.tier == "light")
    eng = ctl.build_engine(dev.device_id, p.params, cfg=p.tiny, slots=2,
                           max_seq=64, steps_per_tick=2, **p.device_kw)
    reqs = [p.serving.Request(rid=i, prompt=_prompt(6 + i, i),
                              max_new_tokens=8) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    ctl.run_for(4.0)
    ctl.drop_device(next(d.device_id for d in fleet
                         if d.device_id != dev.device_id))
    ctl.run_for(4.0)
    eng.drain()
    return rec, ctl, reqs


@pytest.fixture(scope="module")
def fleet_runs():
    """The traced fleet run in both packages, engine clocks pinned."""
    mp = pytest.MonkeyPatch()
    for p in BOTH:
        mp.setattr(p.serving.engine, "time", FixedStepClock())
    try:
        yield [(p, *_fleet_run(p)) for p in BOTH]
    finally:
        mp.undo()


def test_fleet_run_matches_reference(fleet_runs, tmp_path):
    """All four layers on one simulated timebase, in both packages alike;
    the port's trace validates under ``tools/check_trace.py``."""
    (jp, jrec, jctl, jreqs), (tp, trec, tctl, treqs) = fleet_runs
    assert {e.cat for e in trec.events} == set(tp.obs.LAYERS)
    assert all(e.sim_s is not None for e in trec.events)
    assert [tuple(r.generated) for r in treqs] == \
        [tuple(r.generated) for r in jreqs]
    assert_same(controller_state(jp, jctl, jrec),
                controller_state(tp, tctl, trec))
    path = tmp_path / "fleet_trace.json"
    tp.obs.write_trace(trec, str(path))
    assert check_trace.check(path, require_layers=tp.obs.LAYERS) == 0
    assert len(tctl.placer.audits) == len(
        tp.obs.instants(trec, name="placement.decide"))


def _as_recorder(p, events, dropped=0):
    """A package's recorder holding (copies of) the given events."""
    rec = p.obs.TraceRecorder()
    rec.events = [p.obs.Event(**dataclasses.asdict(e)) for e in events]
    rec.dropped = dropped
    return rec


def _obs_outputs(p, rec):
    o = p.obs
    span_rows = o.spans(rec)
    return {
        "instants": o.instants(rec, name="placement.decide"),
        "events": list(o.events(rec, cat="engine", ph="B")),
        "by_arg": list(o.events(rec, name="req.first_token", rid=1)),
        "spans": span_rows,
        "durations": [(s.wall_dur_s, s.sim_dur_s) for s in span_rows],
        "wakes": o.spans(rec, name="fleet.wake"),
        "pairs": o.pair_spans(rec.events[5:], dropped=5),
        "ttft": o.request_ttft_s(rec),
        "tokens": o.request_token_counts(rec),
        "tpot": o.request_tpot_s(rec),
        "chrome": {clock: json.dumps(o.chrome_trace(rec, clock=clock),
                                     sort_keys=True, default=str)
                   for clock in ("auto", "sim", "wall")},
        "attrs": o.attribute_requests(rec),
        "attr_dicts": {rid: a.to_dict()
                       for rid, a in o.attribute_requests(rec).items()},
        "fleet": o.attribute_fleet(rec, tiers={
            "snapdragon_8g3_cpu#0": "light"}).to_dict(),
        "faults": p.faults.summarize_faults(rec.events),
    }


def test_query_export_analysis_on_one_event_list(fleet_runs):
    """The port's fleet trace through both packages' pure functions."""
    events = fleet_runs[1][1].events
    out = [_obs_outputs(p, _as_recorder(p, events)) for p in BOTH]
    assert out[1]["attrs"] and out[1]["spans"]
    for a in out[1]["attrs"].values():
        assert sum(a.components_ns.values()) == a.end_to_end_ns
    assert_same(*out)


def _flight_dumps(p, events, tmp_path):
    now = {"sim": 0.0}
    fr = p.obs.FlightRecorder(sim_clock=lambda: now["sim"], capacity=256,
                              window_s=1.5, post_roll_s=0.25,
                              triggers=("fleet.drop_device",
                                        "placement.decide"), max_dumps=4)
    for e in events:
        now["sim"] = e.sim_s
        fr._emit(e.name, e.cat, e.ph, e.pid, e.tid, e.wall_s, e.args)
    snap = fr.snapshot("manual")
    paths = fr.write_dumps(str(tmp_path / f"flight_{p.port}"))
    for path in paths:
        assert check_trace.check(Path(path)) == 0
    return {"dumps": json.dumps(fr.dumps, sort_keys=True, default=str),
            "snapshot": snap["events"], "dropped": fr.dropped,
            "files": [Path(x).name for x in paths],
            "ring": list(fr.events)}


def test_flight_dumps_match_reference(fleet_runs, tmp_path):
    events = fleet_runs[1][1].events
    j, t = (_flight_dumps(p, events, tmp_path) for p in BOTH)
    assert t["dropped"] > 0 and len(t["files"]) >= 2
    assert_same(j, t)


def test_slo_tracker_burn_and_pressure_match_reference():
    """A seeded stream: a healthy stretch, a spike that pages, recovery
    that releases."""
    out = []
    for p in BOTH:
        now = {"t": 0.0}
        rec = p.obs.TraceRecorder(sim_clock=lambda: now["t"])
        slo = p.obs.SLOTracker(
            p.obs.SLOClass(name="interactive", ttft_p95_s=0.5,
                           tpot_p95_s=0.05),
            window_s=1.0, min_count=3, clock=lambda: now["t"],
            recorder=rec)
        rng = np.random.default_rng(11)
        pressures = []
        for i in range(240):
            now["t"] += float(rng.uniform(0.02, 0.2))
            spike = 80 <= i < 120
            slo.observe("ttft", float(rng.exponential(
                1.2 if spike else 0.1)))
            slo.observe("tpot", float(rng.exponential(
                0.08 if spike else 0.01)), n=int(rng.integers(1, 5)))
            pressures.append(slo.update())
        out.append({"pressures": pressures, "state": slo.state(),
                    "metrics": slo.metrics.snapshot(),
                    "events": [(e.name, e.sim_s, e.args)
                               for e in rec.events]})
    t = out[1]
    assert max(t["pressures"]) > 1.0 and t["pressures"][-1] == 0.0
    assert_same(*out)


# ------------------------------------------------ engine attribution ----
@pytest.mark.parametrize("mode", ["batched", "paged"])
def test_attribution_decode_mode_like_reference(mode):
    """``test_attribution.py``'s decode-mode case on the port's engine:
    components sum to end-to-end exactly and the JAX engine records the
    same event sequence (wall times aside)."""
    out = []
    for p in BOTH:
        rec = p.obs.TraceRecorder()
        eng = p.serving.ServingEngine(
            p.tiny, p.params, slots=2, max_seq=64, decode_mode=mode,
            compile_cache=p.cc, recorder=rec, pid="dev0", **p.device_kw)
        mix = [(8, 4), (20, 3), (5, 6), (12, 2)]
        reqs = [p.serving.Request(rid=i, prompt=_prompt(n, i),
                                  max_new_tokens=b)
                for i, (n, b) in enumerate(mix)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        attrs = p.obs.attribute_requests(rec)
        out.append({"events": [(e.name, e.cat, e.ph, e.pid, e.tid, e.args)
                               for e in rec.events],
                    "streams": [tuple(r.generated) for r in reqs],
                    "attrs": attrs})
    attrs = out[1]["attrs"]
    assert sorted(attrs) == [0, 1, 2, 3]
    for a in attrs.values():
        assert sum(a.components_ns.values()) == a.end_to_end_ns
        assert a.complete and a.end_to_end_ns > 0
        assert a.components_ns["migration"] == 0
        assert a.components_ns["offload_link"] == 0
    assert_same(out[0]["events"], out[1]["events"])
    assert out[0]["streams"] == out[1]["streams"]


# --------------------------------------------------------- SLO feedback ----
def _slo_fleet(p, slo, clock, *, backlog_s=None, n_req=4, budget=6):
    """``test_obs.py``'s placement-free fleet with one engine-backed light
    device; with ``backlog_s`` the requests claim to have arrived that
    far in the past on the engine's (pinned) clock."""
    fleet = p.fleet.build_fleet(5, seed=0)
    rec = p.obs.TraceRecorder()
    ctl = p.fleet.FleetController(fleet, p.cfg, _shape(p), trace_ticks=400,
                                  warmup_ticks=2, recorder=rec,
                                  compile_cache=p.serving.CompileCache(),
                                  slo=slo)
    dev = next(d for d in fleet if d.tier == "light")
    eng = ctl.build_engine(dev.device_id, p.params, cfg=p.tiny, slots=2,
                           max_seq=64, steps_per_tick=2, **p.device_kw)
    reqs = [p.serving.Request(rid=i, prompt=_prompt(6 + i, i),
                              max_new_tokens=budget) for i in range(n_req)]
    if backlog_s is not None:
        now = clock.perf_counter()
        for r in reqs:
            r.arrived_s = now - backlog_s
    for r in reqs:
        eng.submit(r)
    ctl.run_for(4.0)
    eng.drain()
    return eng, ctl, rec, dev.device_id


def test_slo_spike_pages_and_downshifts_within_two_wakes(monkeypatch):
    """R5's twin: a 10 s backlog against a 1 s TTFT target pages once,
    and every device's first decision after the page is the
    latency-first downshift.  The engine's step clock is a fixed-step
    counter, so the wake order after the page is the same on any
    machine under any load."""
    t = BOTH[1]
    clock = FixedStepClock()
    monkeypatch.setattr(t.serving.engine, "time", clock)
    slo = t.obs.SLOTracker(t.obs.SLOClass(name="interactive",
                                          ttft_p95_s=1.0),
                           window_s=30.0, min_count=2)
    eng, ctl, rec, pid = _slo_fleet(t, slo, clock, backlog_s=10.0)
    assert eng.slo is slo
    pages = t.obs.instants(rec, name="slo.page")
    assert len(pages) == 1 and pages[0].args["burn"] > 1.0
    assert slo.pressure > 1.0
    assert ctl.metrics.counter("fleet.slo_pressure_events").value == 1
    after = {}
    for e in t.obs.instants(rec, name="loop.decide"):
        if e.sim_s > pages[0].sim_s:
            after.setdefault(e.pid, e)
    assert after, "no fleet wakes after the page"
    for pid_, first in after.items():
        assert first.args["reason"] == "slo_pressure", pid_
        assert first.args["pressure"] > 1.0
    loop = ctl.loop_for(pid)
    healthy = [d for d in loop.decisions if d.reason != "slo_pressure"]
    pressed = [d for d in loop.decisions if d.reason == "slo_pressure"]
    assert healthy and pressed
    nominal = t.core_monitor.ResourceContext()

    def raw_latency(d):
        return loop.evaluator.evaluate(d.action, nominal,
                                       calibrate=False).latency_s

    assert raw_latency(pressed[-1]) <= raw_latency(healthy[-1])
    assert t.faults.summarize_faults(rec.events)["slo_pages"] == 1


def test_slo_healthy_run_bit_identical_to_untracked(monkeypatch):
    """A tracker that never pages changes no decision and no stream."""
    t = BOTH[1]
    monkeypatch.setattr(t.serving.engine, "time", FixedStepClock())
    base_eng, base_ctl, _, _ = _slo_fleet(t, None, None)
    monkeypatch.setattr(t.serving.engine, "time", FixedStepClock())
    slo = t.obs.SLOTracker(t.obs.SLOClass(ttft_p95_s=1e3, tpot_p95_s=1e3))
    eng, ctl, rec, _ = _slo_fleet(t, slo, None)
    assert_same(controller_state(t, base_ctl), controller_state(t, ctl))
    assert slo.pressure == 0.0
    assert not t.obs.instants(rec, name="slo.page")
    ttft = sum(w["counts"]["ttft"] for w in slo.history)
    assert ttft + (slo._live.counts["ttft"] if slo._live else 0) >= 2
    json.dumps(slo.state())
