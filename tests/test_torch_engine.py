"""The port's model-adaptive engine (``repro_torch.engine``) held against
the JAX package's ``repro.engine``.

* The activation codec (``act_compress``): codes, packed int4 bytes and
  scales are **bit-equal** to the JAX codec's for f32 and bf16 inputs,
  leading dimensions and a ragged last axis (n = 50280, the mamba2-370m
  vocabulary), and dequantized values are bit-equal too.  Both compute
  ``amax / 127 + 1e-12`` and ``round(x / scale)`` with an IEEE f32
  division, which is what the JAX codec does when it runs op by op.
  (Under ``jax.jit`` XLA divides by the constant as a product with its
  reciprocal, so the JAX package's jitted entry points and its Pallas
  kernels in interpret mode can be one ulp away on a scale and one level
  away on a tie; ``tests/test_torch_kernels.py`` holds the port to the
  JAX suite's own floor there.)  ``compression_error`` agrees within
  1e-5 relative: the two frameworks sum the squares in another order.
* Twins of the 12 tests of ``tests/test_engine.py``: each asserts what
  the JAX test asserts, on the port, and that the port's result equals
  the JAX package's on the same input.
* The swap model, ``EngineConfig.to_runtime_options`` and the port's
  departures: ``HOST_LINK_BW`` is the H100 SXM's data-sheet host link
  (64e9 B/s, not the JAX package's 32e9), and a real move of a tensor
  that is not on a card raises instead of keeping it in place.  The real
  moves themselves are tested on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

hypothesis = pytest.importorskip("hypothesis")
import hypothesis.strategies as st
from hypothesis import given, settings

import repro.engine as J
from repro.configs import get_config as j_get_config
from repro.offload import Graph as JGraph
from repro.offload import OpNode as JOpNode
from repro.offload import build_model_graph as j_build_model_graph
import repro_torch.engine as T
from repro_torch.configs import get_config
from repro_torch.engine import swap as tswap
from repro_torch.offload import Graph, OpNode, build_model_graph

torch.set_num_threads(2)

CFG = get_config("paper-backbone")
J_CFG = j_get_config("paper-backbone")
G = build_model_graph(CFG, 1, 128)
J_G = j_build_model_graph(J_CFG, 1, 128)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same f32 numbers as a JAX array and a torch tensor of
    ``dtype`` (bf16 rounding is the same round-to-nearest-even in both)."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(TDT[dtype]))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


# ------------------------------------------------------------ the codec ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 50280), (3, 1, 200), (5, 100),
                                   (2, 2, 2, 384)])
def test_codec_bit_equal_to_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 4.0)).astype(
        np.float32)
    x[0, ..., :128] = 0.0                       # an all-zero block
    xj, xt = _pair(x, dtype)
    n = shape[-1]
    nb = -(-n // 128)
    qj, sj = J.quantize_int8(xj)
    qt, s8 = T.quantize_int8(xt)
    assert qt.shape == shape and s8.shape == shape[:-1] + (nb,)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s8.numpy(), np.asarray(sj))
    pj, s4j = J.quantize_int4(xj)
    pt, s4 = T.quantize_int4(xt)
    assert pt.shape == shape[:-1] + (nb * 64,) and pt.dtype == torch.uint8
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(s4.numpy(), np.asarray(s4j))
    if n % 128:                                 # the padded bytes: 0x88
        assert (pt[..., (n + 1) // 2:] == 0x88).all()
    for od in ("float32", "bfloat16"):
        np.testing.assert_array_equal(
            _np(T.dequantize_int8(qt, s8, TDT[od])),
            _np(J.dequantize_int8(qj, sj, od)))
        np.testing.assert_array_equal(
            _np(T.dequantize_int4(pt, s4, n, TDT[od])),
            _np(J.dequantize_int4(pj, s4j, n, od)))
    for bits in (8, 4):
        a, b = T.compression_error(xt, bits), J.compression_error(xj, bits)
        assert abs(a - b) <= 1e-5 * b


def test_codec_defaults_and_compressed_bytes_match_jax():
    from repro.engine.act_compress import BLOCK as J_BLOCK
    from repro_torch.engine.act_compress import BLOCK as T_BLOCK
    assert T_BLOCK == J_BLOCK
    x = np.ones((2, 256), np.float32)
    q, s = T.quantize_int8(torch.from_numpy(x))
    assert T.dequantize_int8(q, s).dtype == torch.bfloat16
    for shape in [(4, 256), (8, 50280), (48, 8, 32, 64, 128), (3,)]:
        for bits in (8, 4):
            assert T.compressed_bytes(shape, bits) == \
                J.compressed_bytes(shape, bits)


def test_codec_leading_dims_are_rows():
    """(..., n) is quantized row by row: the same as its (M, n) view."""
    x = torch.randn(3, 4, 300, generator=torch.Generator().manual_seed(0))
    q, s = T.quantize_int8(x)
    q2, s2 = T.quantize_int8(x.reshape(12, 300))
    assert torch.equal(q.reshape(12, 300), q2)
    assert torch.equal(s.reshape(12, 3), s2)
    p, s4 = T.quantize_int4(x[:, 1])            # a non-contiguous view
    p2, s42 = T.quantize_int4(x[:, 1].contiguous())
    assert torch.equal(p, p2) and torch.equal(s4, s42)


# ------------------------------------------- twins of tests/test_engine ----
def _to_port(g) -> Graph:
    """A JAX-package graph rebuilt from the port's classes."""
    return Graph(nodes=[OpNode(**vars(n)) for n in g.nodes],
                 inputs=g.inputs, outputs=g.outputs, tensors=dict(g.tensors))


def test_memory_plan_valid_and_bounded():
    plan = T.plan_memory(G)
    plan.validate()
    assert plan.peak_bytes <= plan.naive_bytes
    assert plan.peak_bytes >= T.peak_live_bytes(G) - 1
    jplan = J.plan_memory(J_G)
    assert (plan.offsets, plan.peak_bytes, plan.naive_bytes) == \
        (jplan.offsets, jplan.peak_bytes, jplan.naive_bytes)
    assert [dataclasses.astuple(l) for l in plan.lifetimes] == \
        [dataclasses.astuple(l) for l in jplan.lifetimes]


@st.composite
def chain_graphs(draw):
    n = draw(st.integers(3, 20))
    nodes = []
    names = ["x"]
    for i in range(n):
        k = draw(st.integers(1, min(2, len(names))))
        ins = tuple(draw(st.sampled_from(names)) for _ in range(k))
        size = draw(st.integers(1, 10_000))
        nodes.append(JOpNode(f"n{i}", "add", ins, f"n{i}", out_bytes=size))
        names.append(f"n{i}")
    return JGraph(nodes=nodes, inputs=("x",), outputs=(names[-1],))


@settings(max_examples=40, deadline=None)
@given(chain_graphs())
def test_memory_plan_property(jg):
    g = _to_port(jg)
    plan = T.plan_memory(g, alignment=1)
    plan.validate()
    assert plan.peak_bytes <= T.greedy_no_reuse(g)
    assert plan.peak_bytes >= T.peak_live_bytes(g)
    jplan = J.plan_memory(jg, alignment=1)
    assert (plan.offsets, plan.peak_bytes) == (jplan.offsets,
                                               jplan.peak_bytes)
    assert T.greedy_no_reuse(g) == J.greedy_no_reuse(jg)
    assert T.peak_live_bytes(g) == J.peak_live_bytes(jg)


def test_remat_ladder_monotone():
    assert T.POLICY_LADDER == J.POLICY_LADDER
    bases = [keep for _, keep, _ in T.POLICY_LADDER]
    assert bases == sorted(bases, reverse=True)
    overheads = [o for _, _, o in T.POLICY_LADDER]
    assert overheads == sorted(overheads)


def test_choose_policy_progressive():
    full = T.activation_bytes(CFG, 8, 512)
    assert full == J.activation_bytes(J_CFG, 8, 512)
    for frac, want in ((2, "none"), (0.5, "dots"), (0.01, "full")):
        d = T.choose_policy(CFG, 8, 512, budget_bytes=full * frac)
        assert d.policy == want
        assert dataclasses.astuple(d) == dataclasses.astuple(
            J.choose_policy(J_CFG, 8, 512, budget_bytes=full * frac))


def test_sub_batch_split_fits_budget():
    budget = T.activation_bytes(CFG, 1, 512) * 0.08 * 2.5
    n = T.sub_batch_split(CFG, 8, 512, budget, policy="full")
    assert n == J.sub_batch_split(J_CFG, 8, 512, budget, policy="full")
    per = T.activation_bytes(CFG, 8 // n, 512) * 0.08
    assert per <= budget


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000), st.floats(0.1, 100.0))
def test_int8_roundtrip_bound(seed, scale):
    x = (np.random.default_rng(seed).standard_normal((4, 256))
         * scale).astype(np.float32)
    xt = torch.from_numpy(x)
    q, s = T.quantize_int8(xt)
    y = T.dequantize_int8(q, s, torch.float32)
    blockmax = xt.reshape(4, 2, 128).abs().amax(-1, keepdim=True)
    bound = (blockmax / 127.0).repeat_interleave(128, -1).reshape(4, 256) \
        * 0.51 + 1e-9
    assert bool(((y - xt).abs() <= bound).all())
    qj, sj = J.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_int4_worse_than_int8():
    x = np.random.default_rng(3).standard_normal((8, 384)).astype(np.float32)
    xt = torch.from_numpy(x)
    e4, e8 = T.compression_error(xt, 4), T.compression_error(xt, 8)
    assert e4 > e8 and e8 < 0.02
    assert abs(e8 - J.compression_error(jnp.asarray(x), 8)) <= 1e-5 * e8
    assert abs(e4 - J.compression_error(jnp.asarray(x), 4)) <= 1e-5 * e4


def test_int4_pack_roundtrip():
    x = np.random.default_rng(4).standard_normal((2, 256)).astype(np.float32)
    xt = torch.from_numpy(x)
    packed, s = T.quantize_int4(xt)
    assert packed.shape == (2, 128)
    y = T.dequantize_int4(packed, s, 256, torch.float32)
    assert float((y - xt).abs().max()) < float(xt.abs().max()) * 0.2
    pj, sj = J.quantize_int4(jnp.asarray(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(J.dequantize_int4(pj, sj, 256, jnp.float32)))


def _report_tuples(reports):
    return [dataclasses.astuple(r) for r in reports]


def test_fusion_preserves_flops_and_reduces_ops():
    g2, reports = T.fuse_graph(G)
    assert abs(g2.total_flops() - G.total_flops()) < 1e-6
    assert len(g2.nodes) < len(G.nodes)
    assert sum(r.bytes_saved for r in reports) > 0
    jg2, jreports = J.fuse_graph(J_G)
    assert _report_tuples(reports) == _report_tuples(jreports)
    assert [(n.name, n.kind, n.inputs, n.output) for n in g2.nodes] == \
        [(n.name, n.kind, n.inputs, n.output) for n in jg2.nodes]
    assert T.fusion_memory_saving(G) == J.fusion_memory_saving(J_G)
    assert T.STRATEGIES == J.STRATEGIES


def test_parallel_plan_bounds():
    plans = {k: T.plan_parallelism(G, streams=k) for k in (1, 2, 4)}
    assert 1.0 <= plans[2].speedup <= 2.0 + 1e-9
    assert plans[2].speedup <= plans[4].speedup + 1e-9
    assert abs(plans[1].speedup - 1.0) < 1e-6
    for k, p in plans.items():
        assert dataclasses.astuple(p) == dataclasses.astuple(
            J.plan_parallelism(J_G, streams=k))
    assert dataclasses.astuple(T.plan_parallelism(
        G, streams=2, core_speed_ratio=0.5)) == dataclasses.astuple(
        J.plan_parallelism(J_G, streams=2, core_speed_ratio=0.5))


def test_backprop_reorder_savings():
    full, reordered = T.backprop_reorder_savings(24, 10_000_000)
    assert full == 24 * reordered
    assert (full, reordered) == J.backprop_reorder_savings(24, 10_000_000)


def test_swap_plan_meets_budget():
    per_layer = [100] * 10
    swapped, resident = T.swap_plan(per_layer, budget_bytes=450)
    assert resident <= 450
    assert swapped == list(range(6))
    rng = np.random.default_rng(0)
    for _ in range(20):
        layers = [int(b) for b in rng.integers(1, 1000, rng.integers(1, 30))]
        budget = float(rng.uniform(0, sum(layers)))
        assert T.swap_plan(layers, budget) == J.swap_plan(layers, budget)


# ------------------------------------------------------ swap, schedule ----
def test_swapper_records_match_jax():
    """Without real moves the port's Swapper keeps the JAX Swapper's
    books; the transfer model agrees at an explicit link rate."""
    shapes = [((4, 256), np.float32), ((3, 5), np.int8), ((7,), np.uint8)]
    ts, js = T.Swapper(), J.Swapper()
    for i, (shape, dt) in enumerate(shapes):
        x = np.ones(shape, dt)
        out = ts.offload(f"t{i}", torch.from_numpy(x))
        assert out.data_ptr() == ts.resident_host[f"t{i}"].data_ptr()
        js.offload(f"t{i}", jnp.asarray(x))
    for i in (1, 0):
        assert ts.fetch(f"t{i}").shape == shapes[i][0]
        js.fetch(f"t{i}")
    assert [dataclasses.astuple(r) for r in ts.records] == \
        [dataclasses.astuple(r) for r in js.records]
    assert list(ts.resident_host) == list(js.resident_host) == ["t2"]
    assert ts.total_bytes() == js.total_bytes()
    for bw in (32e9, 64e9, 1e6):
        assert ts.transfer_seconds(link_bw=bw) == js.transfer_seconds(
            link_bw=bw)
        for nbytes, compute in ((10**9, 0.01), (10**6, 1.0), (0, 0.0)):
            assert T.swap_overlap_latency(nbytes, compute, link_bw=bw) == \
                J.swap_overlap_latency(nbytes, compute, link_bw=bw)


def test_host_link_default_is_the_h100_data_sheet():
    """The JAX default (32e9, a TPU host-DMA figure) is not the port's."""
    assert tswap.HOST_LINK_BW == 64e9
    sw = T.Swapper()
    sw.offload("x", torch.zeros(1000, dtype=torch.uint8))
    assert sw.transfer_seconds() == 1000 / 64e9


def test_swapper_move_of_a_host_tensor_raises():
    """A real move needs a tensor on a card; the port raises where the
    JAX package would keep the tensor in place."""
    sw = T.Swapper(use_memory_kinds=True)
    with pytest.raises(ValueError, match="not on a CUDA card"):
        sw.offload("x", torch.zeros(4))
    with pytest.raises(KeyError):
        sw.fetch("never_offloaded")


@pytest.mark.parametrize("kw", [{}, dict(kv_cache_dtype="int8"),
                                dict(kv_cache_dtype="float32",
                                     remat_policy="full", use_pallas=True,
                                     attn_impl="chunked", q_chunk=128,
                                     k_chunk=256, decode_window=64)])
def test_engine_config_to_runtime_options_matches_jax(kw):
    t = T.EngineConfig(**kw)
    j = J.EngineConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.to_runtime_options()) == \
        dataclasses.asdict(j.to_runtime_options())
    if kw.get("kv_cache_dtype") == "int8":      # the JAX mapping, kept
        assert t.to_runtime_options().kv_cache_dtype == "bfloat16"


def test_exported_names_match_jax():
    assert sorted(T.__all__) == sorted(J.__all__)
    for name in T.__all__:
        assert hasattr(T, name)
