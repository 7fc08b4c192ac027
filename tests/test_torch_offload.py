"""The port's graph IR and offloading (``repro_torch.offload``) held
against the JAX package's ``repro.offload``.

* ``build_model_graph`` node by node, and ``pre_partition`` unit by unit,
  for all 13 configs at full width (pure Python, so cheap).
* Twins of the 10 tests of ``tests/test_offload.py``: each asserts what
  the JAX test asserts, on the port, and that the port's partitions,
  placements (every placer on every pool) and converted graphs equal the
  JAX package's; ``execute``'s outputs are compared exactly.
* The twin of ``tests/test_offload_execution.py``: the port's
  ``paper-backbone`` (JAX weights brought across by the bridge) run as
  two ``apply_stack`` stages cut where the port's placer cuts, with a
  copy between them,
  against the JAX package's ``forward`` (within the JAX test's 2 %).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax

import repro.offload as J
from repro.configs import _REGISTRY as J_REGISTRY
from repro.configs import get_config as j_get_config
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
import repro_torch.offload as T
from repro_torch.configs import get_config
from repro_torch.models import apply_stack
from repro_torch.models import layers as tl
from repro_torch.models.runtime import DEFAULT_OPTIONS
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

CFG = get_config("paper-backbone")
G = T.build_model_graph(CFG, batch=1, seq=128)
PP = T.pre_partition(G)
J_G = J.build_model_graph(j_get_config("paper-backbone"), batch=1, seq=128)
J_PP = J.pre_partition(J_G)


def _node(n):
    attrs = {k: (np.asarray(v).tolist() if k == "value" else v)
             for k, v in n.attrs.items()}
    return (n.name, n.kind, n.inputs, n.output, n.flops, n.param_bytes,
            n.out_bytes, attrs, n.layer, n.sublayer, n.constant)


def _graph(g):
    return ([_node(n) for n in g.nodes], g.inputs, g.outputs, g.tensors)


def _units(pp):
    return {lvl: [dataclasses.astuple(u) for u in pp.units(lvl)]
            for lvl in range(4)}


def _placement(p):
    return (p.cuts, p.assignment, p.latency_s, p.transfer_s,
            p.per_device_mem, p.level)


@pytest.mark.parametrize("name", sorted(J_REGISTRY))
def test_model_graph_and_partition_match_jax_at_full_width(name):
    g = T.build_model_graph(get_config(name), batch=8, seq=2048)
    jg = J.build_model_graph(j_get_config(name), batch=8, seq=2048)
    assert _graph(g) == _graph(jg)
    assert g.total_flops() == jg.total_flops()
    assert g.total_param_bytes() == jg.total_param_bytes()
    pp, jpp = T.pre_partition(g), J.pre_partition(jg)
    assert _units(pp) == _units(jpp)
    assert pp.incidence == jpp.incidence
    assert T.independent_flows(g) == J.independent_flows(jg)


@pytest.mark.parametrize("pool", sorted(J.DEVICE_POOLS))
@pytest.mark.parametrize("name,batch,seq", [("paper-backbone", 1, 128),
                                            ("mamba2-370m", 8, 2048),
                                            ("mixtral-8x7b", 1, 512)])
def test_every_placer_matches_jax(pool, name, batch, seq):
    pp = T.pre_partition(T.build_model_graph(get_config(name), batch, seq))
    jpp = J.pre_partition(J.build_model_graph(j_get_config(name), batch,
                                              seq))
    devs, jdevs = T.DEVICE_POOLS[pool], J.DEVICE_POOLS[pool]
    assert [dataclasses.astuple(d) for d in devs] == \
        [dataclasses.astuple(d) for d in jdevs]
    for level in (2, 3):
        for placer in ("place_dp", "place_cas", "place_dads", "local_only"):
            try:
                got = getattr(T, placer)(pp, devs, level=level)
            except ValueError as e:               # infeasible: both raise
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    getattr(J, placer)(jpp, jdevs, level=level)
                continue
            want = getattr(J, placer)(jpp, jdevs, level=level)
            assert _placement(got) == _placement(want), (placer, level)
            assert got.describe(pp.units(level), devs) == \
                want.describe(jpp.units(level), jdevs)


# ------------------------------------------ twins of tests/test_offload ----
def test_prepartition_covers_graph():
    for level in range(4):
        units = PP.units(level)
        covered = [n for u in units for n in u.node_names]
        assert sorted(covered) == sorted(n.output for n in G.nodes), level
        assert len(covered) == len(set(covered))
    assert _units(PP) == _units(J_PP)


def test_prepartition_hierarchy_coarsens():
    sizes = [len(PP.units(l)) for l in range(4)]
    assert sizes[0] > sizes[1] > sizes[2] >= sizes[3]
    assert sizes == [len(J_PP.units(l)) for l in range(4)]


def test_prepartition_flops_conserved():
    total = G.total_flops()
    for level in range(4):
        assert abs(sum(u.flops for u in PP.units(level)) - total) < 1e-6
    assert total == J_G.total_flops()


def test_dp_beats_heuristics():
    devs = T.DEVICE_POOLS["edge_pair"]
    dp = T.place_dp(PP, devs)
    cas = T.place_cas(PP, devs)
    loc = T.local_only(PP, devs)
    assert dp.latency_s <= cas.latency_s + 1e-9
    assert dp.latency_s <= loc.latency_s + 1e-9
    jdevs = J.DEVICE_POOLS["edge_pair"]
    assert _placement(dp) == _placement(J.place_dp(J_PP, jdevs))
    assert _placement(cas) == _placement(J.place_cas(J_PP, jdevs))
    assert _placement(loc) == _placement(J.local_only(J_PP, jdevs))


def test_dp_optimal_vs_bruteforce():
    """On a small chain with 2 devices, DP must equal exhaustive search."""
    devs = T.DEVICE_POOLS["edge_pair"]
    units = PP.units(3)
    n = len(units)
    dp = T.place_dp(PP, devs, level=3)
    best = float("inf")
    for cut in range(-1, n - 1):
        lat = 0.0
        mem0 = sum(u.param_bytes + u.peak_act_bytes for u in units[:cut + 1])
        mem1 = sum(u.param_bytes + u.peak_act_bytes for u in units[cut + 1:])
        if cut >= 0:
            if mem0 > devs[0].mem_bytes or mem1 > devs[1].mem_bytes:
                continue
            lat += sum(devs[0].compute_seconds(u) for u in units[:cut + 1])
            lat += units[cut].boundary_bytes / devs[0].link_bw
            lat += sum(devs[1].compute_seconds(u) for u in units[cut + 1:])
        else:
            if sum(u.param_bytes + u.peak_act_bytes for u in units) \
                    > devs[0].mem_bytes:
                continue
            lat = sum(devs[0].compute_seconds(u) for u in units)
        best = min(best, lat)
    assert dp.latency_s <= best + 1e-9
    assert _placement(dp) == _placement(
        J.place_dp(J_PP, J.DEVICE_POOLS["edge_pair"], level=3))


def test_placement_respects_memory():
    spec = [("small0", 50e9, G.total_param_bytes() * 0.6, 10e9, 1e9),
            ("small1", 50e9, G.total_param_bytes() * 0.6, 10e9, 0)]
    tight = tuple(T.DeviceProfile(*s) for s in spec)
    pl = T.place_dp(PP, tight)
    for m, d in zip(pl.per_device_mem, tight):
        assert m <= d.mem_bytes + 1e-6
    assert _placement(pl) == _placement(J.place_dp(
        J_PP, tuple(J.DeviceProfile(*s) for s in spec)))


def test_placement_infeasible_raises():
    tiny = (T.DeviceProfile("t0", 1e9, 1024, 1e9, 1e9),
            T.DeviceProfile("t1", 1e9, 1024, 1e9, 0))
    with pytest.raises(ValueError, match="no feasible placement"):
        T.place_dp(PP, tiny)


def test_independent_flows_topological():
    flows = T.independent_flows(G)
    node_of = G.node_map()
    seen = set(G.inputs)
    for level in flows:
        for t in level:
            assert all(i in seen for i in node_of[t].inputs)
        seen.update(level)
    assert flows == J.independent_flows(J_G)


def _rand_graph(mod, seed: int):
    """The JAX suite's random transform graph, built from ``mod``'s
    classes (``repro.offload`` or ``repro_torch.offload``)."""
    rng = np.random.default_rng(seed)
    nodes = [mod.OpNode("w0", "const", (), "w0", attrs={
                 "value": rng.standard_normal((8, 8)).astype(np.float32)}),
             mod.OpNode("w1", "const", (), "w1", attrs={
                 "value": rng.standard_normal((8, 8)).astype(np.float32)})]
    prev = "x"
    for i in range(int(rng.integers(2, 6))):
        kind = rng.choice(["matmul", "act", "add"])
        if kind == "matmul":
            nodes.append(mod.OpNode(f"n{i}", "matmul",
                                    (prev, rng.choice(["w0", "w1"])), f"n{i}"))
        elif kind == "act":
            nodes.append(mod.OpNode(f"n{i}", "act", (prev,), f"n{i}", attrs={
                "fn": str(rng.choice(["relu", "gelu", "silu"]))}))
        else:
            nodes.append(mod.OpNode(f"n{i}", "add", (prev, "w0_row"),
                                    f"n{i}"))
            if "w0_row" not in [n.output for n in nodes]:
                nodes.insert(2, mod.OpNode("w0_row", "const", (), "w0_row",
                                           attrs={"value": rng.standard_normal(
                                               (8,)).astype(np.float32)}))
        prev = f"n{i}"
    return mod.Graph(nodes=nodes, inputs=("x",), outputs=(prev,))


@pytest.mark.parametrize("seed", range(12))
def test_convert_preserves_semantics(seed):
    g = _rand_graph(T, seed)
    x = np.random.default_rng(seed).standard_normal((4, 8)).astype(np.float32)
    ref = T.execute(g, {"x": x})[g.outputs[0]]
    g2 = T.convert(_rand_graph(T, seed))
    out = T.execute(g2, {"x": x})[g2.outputs[0]]
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    assert len(g2.nodes) <= len(g.nodes)
    jg2 = J.convert(_rand_graph(J, seed))
    assert _graph(g2) == _graph(jg2)
    np.testing.assert_array_equal(out, J.execute(jg2, {"x": x})[
        jg2.outputs[0]])
    np.testing.assert_array_equal(ref, J.execute(_rand_graph(J, seed), {
        "x": x})[g.outputs[0]])


def _dup_graph(mod):
    nodes = [
        mod.OpNode("w", "const", (), "w",
                   attrs={"value": np.eye(4, dtype=np.float32)}),
        mod.OpNode("w_dup", "const", (), "w_dup",
                   attrs={"value": np.eye(4, dtype=np.float32)}),
        mod.OpNode("m1", "matmul", ("x", "w"), "m1"),
        mod.OpNode("m2", "matmul", ("x", "w_dup"), "m2"),
        mod.OpNode("c1", "matmul", ("w", "w_dup"), "c1"),
        mod.OpNode("cr", "reduce", ("c1",), "cr",
                   attrs={"fn": "mean", "axis": 0}),
        mod.OpNode("s", "add", ("m1", "m2"), "s"),
        mod.OpNode("o", "add", ("s", "cr"), "o"),
    ]
    return mod.Graph(nodes=nodes, inputs=("x",), outputs=("o",))


def test_convert_removes_duplicates_and_constants():
    g = _dup_graph(T)
    g2 = T.convert(g)
    kinds = [n.kind for n in g2.nodes]
    assert kinds.count("matmul") + kinds.count("fused") <= 2
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    np.testing.assert_allclose(T.execute(g2, {"x": x})["o"],
                               T.execute(g, {"x": x})["o"], atol=1e-5)
    jg = _dup_graph(J)
    assert _graph(T.eliminate_duplicates(g)) == \
        _graph(J.eliminate_duplicates(jg))
    assert T.classify_constants(g) == J.classify_constants(jg)
    assert _graph(T.fold_constants(g)) == _graph(J.fold_constants(jg))
    assert _graph(T.eliminate_dead(g)) == _graph(J.eliminate_dead(jg))
    assert _graph(T.fuse_linear_chains(g)) == \
        _graph(J.fuse_linear_chains(jg))
    assert _graph(g2) == _graph(J.convert(jg))
    np.testing.assert_array_equal(T.execute(g2, {"x": x})["o"],
                                  J.execute(J.convert(jg), {"x": x})["o"])


def test_execute_takes_cpu_tensors():
    g = _rand_graph(T, 3)
    x = np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)
    out = T.execute(g, {"x": torch.from_numpy(x)})
    np.testing.assert_array_equal(out[g.outputs[0]],
                                  T.execute(g, {"x": x})[g.outputs[0]])


# ------------------------------- twin of tests/test_offload_execution ----
def test_offloaded_stages_execute_equivalently():
    """The placer's cut, applied to the port's model: layers before the
    cut run as one stage through ``apply_stack`` on their slice of the
    stacked weights, their output is copied (the offload transfer), and
    the rest runs as a second stage.  The logits must agree with the
    JAX ``forward`` within the JAX test's 2 %, and the cut with the JAX
    placer's."""
    kw = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
              head_dim=16, d_ff=128, vocab_size=256)
    jcfg = j_get_config("paper-backbone").with_updates(**kw)
    cfg = get_config("paper-backbone").with_updates(**kw)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(
        np.int32)
    ref, _ = j_forward(jparams, jcfg, jax.numpy.asarray(tokens))
    ref = np.asarray(ref, np.float32)

    def cut_layer(mod, c):
        g = mod.build_model_graph(c, 1, 16)
        pp = mod.pre_partition(g)
        devs = (mod.DeviceProfile("d0", 50e9, 1e12, 10e9, 1e9),
                mod.DeviceProfile("d1", 50e9, 1e12, 10e9, 0))
        assign = mod.place_dp(pp, devs, level=2).assignment
        units = pp.units(2)
        node_of = g.node_map()
        cut = 0
        for i in range(len(units) - 1):
            if assign[i] != assign[i + 1]:
                cut = max(node_of[n].layer for n in units[i].node_names) + 1
                break
        return max(1, min(cut, c.num_layers - 1))

    cut = cut_layer(T, cfg)
    assert cut == cut_layer(J, jcfg)
    params = tl.cast_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"), torch.bfloat16)
    x = tl.embed_lookup(params["embed"], torch.from_numpy(tokens)).to(
        torch.bfloat16)
    for lo, hi in ((0, cut), (cut, cfg.num_layers)):
        x = x.clone()                           # the offload transfer
        stage = tl.tree_map(lambda a: a[lo:hi], params["layers"])
        x, _ = apply_stack(stage, x, cfg, DEFAULT_OPTIONS)
    x = tl.rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = tl.mask_padded_logits_raw(tl.unembed(params["embed"], x),
                                    cfg.vocab_size).float().numpy()
    assert out.shape == ref.shape
    rel = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 0.02, rel
