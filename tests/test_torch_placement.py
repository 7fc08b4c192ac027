"""The port's fleet placement — topology, live profiles, ``FleetPlacer``
and the controller's re-placement events — held against the JAX
package's.

Twins of ``tests/test_placement.py``: each of its scenarios runs through
``repro.fleet.placement`` and ``repro_torch.fleet.placement`` with the
same fleet, contexts and load nudges, and every decision (hosts, cuts,
latency, migration cost, reason), audit, member state and resolved
profile must agree: exact for ids, reasons and counts, ``rel 1e-12`` for
floats.  The placer searches through the port's ``offload``
(``build_model_graph``, ``pre_partition``, ``place_dp``).
"""
import pytest

from test_torch_fleet import BOTH, assert_same, controller_state


def _loaded(p):
    return p.core_monitor.ResourceContext(
        cpu_temp_derate=0.45, competing_procs=4, battery_frac=0.8,
        mem_free_frac=0.7)


def _trio(p):
    """Loaded phone + idle same-site jetson + idle cross-site server."""
    mk = p.fleet.make_device
    return (mk("pixel_6_cpu", 0, site="home"),
            mk("jetson_agx_orin", 0, site="home"),
            mk("edge_server_a100", 0, site="dc"))


def _placer(p, *specs, **kw):
    placer = p.fleet.FleetPlacer(p.cfg, **kw)
    for s in specs:
        placer.register(s)
    return placer


def _placer_state(placer):
    return {"decisions": placer.decisions, "audits": placer.audits,
            "tenants": {did: m.tenant_load()
                        for did, m in placer.members.items()}}


# --------------------------------------------------- topology, profiles ----
def test_topology_and_profiles_match_reference():
    out = []
    for p in BOTH:
        pl = p.fleet_placement
        a, b, c = _trio(p)
        fat = pl.LinkSpec(bandwidth_bytes_s=1e9, rtt_s=1e-3, kind="fiber")
        topo = pl.SiteTopology(overrides={("dc", "home"): fat})
        link = pl.LinkSpec(bandwidth_bytes_s=1e8, rtt_s=0.02)
        cal = p.core_profiler.Calibration(latency_scale=2.0, samples=16)
        ctx = p.core_monitor.ResourceContext
        profiles = [pl.synthesize_profile(pl.MemberState(spec=s, **kw))
                    for s in (a, b, c) for kw in (
                        {}, {"calibration": cal},
                        {"ctx": ctx(cpu_temp_derate=0.5)},
                        {"ctx": ctx(mem_free_frac=0.5)},
                        {"own_load": 0.4})]
        out.append((topo.link_between(a, c), topo.link_between(a, b),
                    pl.SiteTopology().link_between(a, c),
                    [link.effective_bw(n) for n in (1e3, 1e6, 1e9)],
                    link.transfer_s(1e8), profiles,
                    p.fleet.build_fleet(6, seed=0, sites=("a", "b"))))
    assert_same(*out)


# ------------------------------------------------------------ the placer ----
def _scenario_accept(p):
    phone, jetson, far = _trio(p)
    placer = _placer(p, phone, jetson, far)
    placer.update_member(phone.device_id, ctx=_loaded(p))
    first = placer.place(phone.device_id)
    again = placer.place(phone.device_id)
    static = p.offload.place_dp(placer.pp, p.offload.DEVICE_POOLS[
        "edge_pair"])
    return {"first": first, "again": again,
            "local": placer.local_decision(phone.device_id),
            "static": static,
            "candidates": placer.candidate_helpers(phone.device_id),
            **_placer_state(placer)}


def _scenario_multi_tenant(p):
    phone, jetson, _ = _trio(p)
    p2 = p.fleet.make_device("pixel_6_cpu", 1, site="home")
    p3 = p.fleet.make_device("pixel_6_cpu", 2, site="home")
    placer = _placer(p, phone, jetson, p2, p3)
    for s in (phone, p2, p3):
        placer.update_member(s.device_id, ctx=_loaded(p))
    decs = [placer.place(s.device_id) for s in (phone, p2, p3)]
    return {"decs": decs, **_placer_state(placer)}


def _scenario_helper_disappears(p):
    phone, jetson, far = _trio(p)
    placer = _placer(p, phone, jetson, far)
    placer.update_member(phone.device_id, ctx=_loaded(p))
    dec = placer.place(phone.device_id)
    affected = placer.remove_member(jetson.device_id)
    return {"dec": dec, "affected": affected,
            "current": placer.current(phone.device_id),
            "resolved": placer.resolve_profiles(dec.hosts),
            "next": placer.place(phone.device_id),
            **_placer_state(placer)}


def _scenario_departed_requester(p):
    phone, jetson, far = _trio(p)
    placer = _placer(p, phone, jetson, far)
    placer.update_member(phone.device_id, ctx=_loaded(p))
    dec = placer.place(phone.device_id)
    placer.remove_member(phone.device_id)
    return {"dec": dec, **_placer_state(placer)}


def _scenario_infeasible(p):
    phone, jetson, far = _trio(p)
    placer = _placer(p, phone, jetson, far)
    starving = p.core_monitor.ResourceContext(mem_free_frac=1e-9)
    for s in (phone, jetson, far):
        placer.update_member(s.device_id, ctx=starving)
    return {"dec": placer.place(phone.device_id), **_placer_state(placer)}


def _scenario_hysteresis(p, big_shift):
    mk = p.fleet.make_device
    phone = mk("pixel_6_cpu", 0, site="home")
    j0, j1 = (mk("jetson_agx_orin", i, site="home") for i in (0, 1))
    placer = _placer(p, phone, j0, j1, hysteresis=0.15)
    placer.update_member(phone.device_id, ctx=_loaded(p))
    first = placer.place(phone.device_id)
    chosen = first.hosts[1]
    other = j1.device_id if chosen == j0.device_id else j0.device_id
    decs = [first]
    if big_shift:
        placer.update_member(chosen, own_load=0.9)
        decs.append(placer.place(phone.device_id))
    else:
        for i in range(6):
            placer.update_member(chosen, own_load=0.04 if i % 2 == 0
                                 else 0.0)
            placer.update_member(other, own_load=0.0 if i % 2 == 0
                                 else 0.04)
            decs.append(placer.place(phone.device_id, now_s=float(i)))
    return {"decs": decs, **_placer_state(placer)}


SCENARIOS = {
    "beats_local_and_static": _scenario_accept,
    "multi_tenant": _scenario_multi_tenant,
    "helper_disappears": _scenario_helper_disappears,
    "departed_requester": _scenario_departed_requester,
    "memory_infeasible": _scenario_infeasible,
    "hysteresis_holds": lambda p: _scenario_hysteresis(p, False),
    "large_shift_replaces": lambda p: _scenario_hysteresis(p, True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_placer_decisions_match_reference(name):
    j, t = (SCENARIOS[name](p) for p in BOTH)
    assert_same(j, t)
    # the JAX test's own claims, of the port
    if name == "beats_local_and_static":
        assert t["first"].hosts == ("pixel_6_cpu#0", "jetson_agx_orin#0")
        assert t["first"].latency_s < min(0.5 * t["local"].latency_s,
                                          t["static"].latency_s)
    elif name == "hysteresis_holds":
        assert {d.hosts for d in t["decs"]} == {t["decs"][0].hosts}
    elif name == "large_shift_replaces":
        assert t["decs"][1].hosts != t["decs"][0].hosts


# ------------------------------------------ controller re-placement events --
def _placed_run(p, step_mode):
    mk = p.fleet.make_device
    phone = mk("pixel_6_cpu", 0, site="home")
    j0, j1 = (mk("jetson_agx_orin", i, site="home") for i in (0, 1))
    monitor = p.core_monitor
    loaded = _loaded(p)

    def tf(spec, n):
        return monitor.constant_trace(
            loaded if spec.device_id == phone.device_id
            else monitor.ResourceContext(), n)

    rec = p.obs.TraceRecorder()
    ctl = p.fleet.FleetController(
        [phone, j0, j1], p.cfg,
        p.models_configs.InputShape("fleet_t", 256, 4, "prefill"),
        trace_ticks=400 if step_mode == "event" else 16, trace_factory=tf,
        placement=True, allow_offload=False, warmup_ticks=4,
        recalibrate_every=2, recorder=rec, step_mode=step_mode)
    ctl.set_sla(phone.device_id, 0.5)
    if step_mode == "event":
        ctl.run_for(8.0)
        chosen = ctl.placement_of(phone.device_id).hosts[1]
        ctl.inject_load(chosen, 0.9)       # the helper's owner starts a game
        ctl.run_for(4.0)
        ctl.drop_device(j1.device_id if chosen == j0.device_id
                        else j0.device_id)
        ctl.run_for(2.0)
    else:
        ctl.run(8)
        ctl.drop_device(j1.device_id)
        ctl.run(4)
    return {**controller_state(p, ctl, rec),
            "audits": ctl.placer.audits,
            "placement": ctl.placement_of(phone.device_id)}


@pytest.mark.parametrize("step_mode", ["event", "lockstep"])
def test_controller_replacement_matches_reference(step_mode):
    """A loaded phone offloads, its helper's owner loads it, a helper
    drops out: the same placements, at the same fleet-clock events."""
    j, t = (_placed_run(p, step_mode) for p in BOTH)
    assert t["placement_log"], "nothing was placed"
    assert_same(j, t)
