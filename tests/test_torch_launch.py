"""The port's drivers (``repro_torch.launch``), the profiler's HLO
parsers and the baselines against the JAX package, on the CPU.

* Twins of ``test_distribution.py``: the spec rules for every arch (the
  port's tuples equal ``tuple(PartitionSpec)``, on the meta-device
  parameter tree, whose shapes and dtypes equal ``eval_shape`` of the JAX
  init), serve mode dropping FSDP, ``input_specs``, long-decode options,
  cache and batch specs on both production meshes' axis sizes.
* The ``test_reduced_step_compiles_on_8way_mesh`` cases (qwen train,
  olmoe decode, mamba2 prefill, zamba2 decode) run as one step on
  bridged weights, equal to the jitted JAX step; ``make_train_step``
  against the JAX train step for 3 steps on reduced paper-backbone and
  the reduced hybrid; ``train_loop``'s loss falling; the serve loop.
  f32 activations and weights: the same sums in another order, so atol
  1e-4 on logits and caches, 1e-5 relative on the loss and 1e-4 on the
  gradient norm.  Parameters after AdamW: each step moves an element by
  about ``lr * warmup_cosine(step)`` whatever its gradient's size, so an
  element whose gradient is at rounding level can land ``2 * lr * scale``
  apart: atol is twice the sum of the steps' ``lr * scale``.
* The HLO parsers on the reference test's literal HLO, and
  ``scan_trip_count`` for every arch; the planner's analytic flops and
  bytes for every arch x shape; ``adadeep_select`` / ``ofa_select`` over
  budgets and contexts (the port's evaluator given the JAX package's TPU
  figures, as in ``test_torch_core.py``).
"""
import dataclasses
import json
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import baselines as J_BASE
from repro.configs import get_config as j_get_config
from repro.core import monitor as j_monitor
from repro.core import optimizer as j_optimizer
from repro.core import profiler as J_PROF
from repro.launch import sharding as j_sharding
from repro.launch import steps as j_steps
from repro.models import model as jm
from repro.models.configs import INPUT_SHAPES as J_SHAPES
from repro.models.configs import InputShape as JInputShape
from repro.optim import adamw as j_adamw
from repro_torch import baselines as T_BASE
from repro_torch.checkpoint import flatten_with_keys
from repro_torch.configs import get_config, list_archs
from repro_torch.core import monitor, optimizer
from repro_torch.core import profiler as T_PROF
from repro_torch.data import SyntheticLM, DataConfig, make_batch_fn, \
    place_batch
from repro_torch.elastic.operators import VariantSpec
from repro_torch.launch import (batch_axes, batch_specs, cache_spec_struct,
                                cache_specs, input_specs, make_debug_mesh,
                                make_production_mesh, make_step,
                                make_train_step, opt_state_specs,
                                options_for, param_specs, params_spec_struct,
                                to_shardings)
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.train import train_loop
from repro_torch.models import init_params
from repro_torch.models.configs import INPUT_SHAPES, InputShape
from repro_torch.models.model import init_cache
from repro_torch.optim import adamw
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

F32 = dict(activation_dtype="float32", param_dtype="float32")
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
LR = adamw.AdamWConfig().lr


def _flat_specs(tree):
    """{key: spec tuple} of a JAX spec tree."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(s)
            for kp, s in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))}


def _spec_leaves(tree, prefix=""):
    """{key: spec} of the port's spec tree (dicts of tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


# ------------------------------------------------------ specs and meshes ---
def test_param_specs_match_reference_for_every_arch():
    """Every leaf's spec equals the JAX rule's, on a meta-device tree
    whose shapes and dtypes equal the JAX package's ``eval_shape``."""
    for arch in list_archs():
        cfg, jcfg = get_config(arch), j_get_config(arch)
        tree, jtree = params_spec_struct(cfg), j_steps.params_spec_struct(
            jcfg)
        leaves = dict(flatten_with_keys(tree))
        jleaves = {k: v for k, v in (
            ("/".join(str(getattr(k, "key", k)) for k in kp), leaf)
            for kp, leaf in jax.tree_util.tree_leaves_with_path(jtree))}
        assert sorted(leaves) == sorted(jleaves), arch
        for k, t in leaves.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == jleaves[k].shape, (arch, k)
            assert _dtype_name(t) == str(jleaves[k].dtype), (arch, k)
        for mode in ("train", "serve"):
            specs = _spec_leaves(param_specs(cfg, tree, mode=mode))
            jspecs = _flat_specs(j_sharding.param_specs(jcfg, jtree,
                                                        mode=mode))
            assert specs == jspecs, (arch, mode)
        # sharded dims are divisible by 16, as the reference asserts
        for k, spec in _spec_leaves(param_specs(cfg, tree)).items():
            for dim, ax in zip(leaves[k].shape, spec):
                if ax is not None:
                    assert dim % (16 ** (len(ax) if isinstance(ax, tuple)
                                         else 1)) == 0, (arch, k, spec)


def test_serve_mode_drops_fsdp():
    cfg = get_config("yi-34b")
    tree = params_spec_struct(cfg)
    train = _spec_leaves(param_specs(cfg, tree, mode="train")).values()
    serve = _spec_leaves(param_specs(cfg, tree, mode="serve")).values()
    assert any("data" in s for s in train)
    assert not any("data" in s for s in serve)
    assert any("model" in s for s in serve)


def test_input_specs_and_options_match_reference():
    for arch in list_archs():
        cfg, jcfg = get_config(arch), j_get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            jshape = J_SHAPES[name]
            opts = options_for(cfg, shape)
            assert dataclasses.asdict(opts) == dataclasses.asdict(
                j_steps.options_for(jcfg, jshape)), (arch, name)
            sp, jsp = input_specs(cfg, shape), j_steps.input_specs(jcfg,
                                                                    jshape)
            assert sorted(sp) == sorted(jsp)
            for k in sp:
                assert sp[k].device.type == "meta"
                assert tuple(sp[k].shape) == jsp[k].shape, (arch, name, k)
                assert _dtype_name(sp[k]) == str(jsp[k].dtype)
            key = "token" if shape.is_decode else "tokens"
            assert sp[key].shape[0] == shape.global_batch


def test_options_for_long_decode_is_subquadratic():
    cfg = get_config("yi-34b")
    opts = options_for(cfg, INPUT_SHAPES["long_500k"])
    assert opts.decode_window > 0
    assert options_for(cfg, INPUT_SHAPES["decode_32k"]).decode_window == 0
    assert options_for(cfg, INPUT_SHAPES["train_4k"],
                       {"remat": "none"}).remat == "none"


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cache_batch_and_opt_specs_match_reference(multi_pod):
    """On the production meshes' axis sizes (no devices: the rules read
    only the sizes), for every arch and shape."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    mesh = Mesh(axes, sizes, ())
    jmesh = types.SimpleNamespace(axis_names=axes,
                                  shape=dict(zip(axes, sizes)))
    assert batch_axes(mesh) == j_sharding.batch_axes(jmesh)
    for arch in ("qwen1.5-32b", "whisper-small", "zamba2-1.2b",
                 "olmoe-1b-7b", "mamba2-370m"):
        cfg, jcfg = get_config(arch), j_get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            jshape = J_SHAPES[name]
            b = batch_specs(cfg, mesh, shape, decode=shape.is_decode)
            jb = j_sharding.batch_specs(jcfg, jmesh, jshape,
                                        decode=jshape.is_decode)
            assert b == {k: tuple(v) for k, v in jb.items()}
            if shape.kind == "train":
                continue
            opts = options_for(cfg, shape)
            cs = cache_spec_struct(cfg, shape, opts)
            jcs = j_steps.cache_spec_struct(jcfg, jshape,
                                            j_steps.options_for(jcfg,
                                                                jshape))
            assert {k: tuple(v.shape) for k, v in cs.items()} == \
                {k: v.shape for k, v in jcs.items()}
            for kv_shard in ("heads", "seq"):
                c = cache_specs(cfg, cs, mesh, shape, kv_shard=kv_shard)
                jc = j_sharding.cache_specs(jcfg, jcs, jmesh, jshape,
                                            kv_shard=kv_shard)
                assert c == {k: tuple(v) for k, v in jc.items()}, \
                    (arch, name, kv_shard)
    cfg = get_config("paper-backbone").reduced()
    pspecs = param_specs(cfg, params_spec_struct(cfg))
    o = opt_state_specs(cfg, None, pspecs)
    assert isinstance(o, adamw.AdamWState) and o.step == () and \
        o.m is pspecs and o.v is pspecs


def test_one_device_meshes():
    mesh = make_debug_mesh(1, 1, device="cpu")
    assert mesh.size == 1 and mesh.shape == {"data": 1, "model": 1}
    assert batch_axes(mesh) == ("data",)
    assert batch_axes(Mesh(("pod", "data", "model"), (2, 1, 1), ())) == \
        ("pod", "data")
    with pytest.raises(RuntimeError):
        make_debug_mesh(2, 1, device="cpu")
    with pytest.raises(RuntimeError):
        make_production_mesh(device="cpu")
    cfg = get_config("paper-backbone").reduced()
    sh = to_shardings(param_specs(cfg, params_spec_struct(cfg)), mesh)
    assert set(_spec_leaves(sh).values()) == {torch.device("cpu")}


# ---------------------------------------------------- steps against JAX ---
def _reduced(arch):
    return tuple(get(arch).reduced(num_layers=2, d_model=256).with_updates(
        vocab_size=1024, **F32) for get in (j_get_config, get_config))


def _bridge(jcfg):
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _assert_cache_close(tc, jc):
    assert sorted(tc) == sorted(jc)
    for k in tc:
        np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k], np.float32),
                                   **LOGITS_TOL, err_msg=k)


@pytest.mark.parametrize("arch,kind", [
    ("qwen1.5-32b", "train"), ("olmoe-1b-7b", "decode"),
    ("mamba2-370m", "prefill"), ("zamba2-1.2b", "decode"),
])
def test_reduced_step_matches_reference(arch, kind):
    """The four configs the reference compiles on its 2 x 4 mesh, each
    run as one step of the port's ``make_step`` on bridged weights,
    equal to the jitted JAX step (a decode step follows a prefill of 32
    tokens)."""
    jcfg, cfg = _reduced(arch)
    shape, jshape = InputShape("mini", 64, 8, kind), JInputShape(
        "mini", 64, 8, kind)
    # f32 caches, so a cache leaf is not rounded to bf16 in two places
    f32_cache = {"kv_cache_dtype": "float32"}
    opts = options_for(cfg, shape, f32_cache)
    jopts = j_steps.options_for(jcfg, jshape, f32_cache)
    jp, tp = _bridge(jcfg)
    batch = make_batch_fn(cfg, shape)(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = place_batch(batch, "cpu")
    if kind == "train":
        jout = jax.jit(j_steps.make_step(jcfg, jshape, jopts))(
            jp, j_adamw.init(jp), jbatch)
        tout = make_step(cfg, shape, opts)(tp, adamw.init(tp), tbatch)
        np.testing.assert_allclose(float(tout[2]["loss"]),
                                   float(jout[2]["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tout[2]["grad_norm"]),
                                   float(jout[2]["grad_norm"]), rtol=1e-4)
        assert int(tout[1].step) == int(jout[1].step) == 1
        return
    cache = init_cache(cfg, 8, 64, opts, device="cpu")
    jcache = jm.init_cache(jcfg, 8, 64, jopts)
    if kind == "decode":
        pshape = InputShape("mini", 32, 8, "prefill")
        jpshape = JInputShape("mini", 32, 8, "prefill")
        _, cache = make_step(cfg, pshape, opts)(
            tp, cache, {"tokens": tbatch["tokens"][:, :32]})
        _, jcache = jax.jit(j_steps.make_step(jcfg, jpshape, jopts))(
            jp, jcache, {"tokens": jbatch["tokens"][:, :32]})
        tbatch = {"token": tbatch["tokens"][:, 32]}
        jbatch = {"token": jbatch["tokens"][:, 32]}
    logits, cache = make_step(cfg, shape, opts)(tp, cache, tbatch)
    jlogits, jcache = jax.jit(j_steps.make_step(jcfg, jshape, jopts))(
        jp, jcache, jbatch)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits, np.float32),
                               **LOGITS_TOL)
    _assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ["paper-backbone", "zamba2-1.2b"])
def test_train_step_matches_reference_for_three_steps(arch):
    """Loss, gradient norm and every parameter after each of 3 AdamW
    steps (the hybrid at 5 layers and period 2: two shared sites and a
    leftover layer)."""
    if arch == "paper-backbone":
        kw = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128)
        jcfg, cfg = (get(arch).with_updates(vocab_size=512, **kw, **F32)
                     for get in (j_get_config, get_config))
    else:
        jcfg, cfg = (get(arch).reduced(num_layers=5).with_updates(
            shared_attn_period=2, ssm_chunk=16, vocab_size=512, **F32)
            for get in (j_get_config, get_config))
    shape, jshape = InputShape("t", 32, 2, "train"), JInputShape(
        "t", 32, 2, "train")
    jp, tp = _bridge(jcfg)
    jstate, tstate = j_adamw.init(jp), adamw.init(tp)
    jstep = jax.jit(j_steps.make_train_step(
        jcfg, j_steps.options_for(jcfg, jshape)))
    tstep = make_train_step(cfg, options_for(cfg, shape))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2))
    moved = 0.0
    for i in range(3):
        b = data.batch(i)
        jp, jstate, jmet = jstep(jp, jstate,
                                 {k: jnp.asarray(v) for k, v in b.items()})
        tp, tstate, tmet = tstep(tp, tstate, place_batch(b, "cpu"))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        moved += LR * i / 100            # warmup_cosine(i), i < 100
        jflat = {"/".join(str(getattr(k, "key", k)) for k in kp):
                 np.asarray(v) for kp, v in
                 jax.tree_util.tree_leaves_with_path(jp)}
        tflat = dict(flatten_with_keys(tp))
        assert sorted(jflat) == sorted(tflat)
        for k, v in jflat.items():
            np.testing.assert_allclose(_np(tflat[k]), v, rtol=0,
                                       atol=2 * moved + 1e-7, err_msg=k)
    assert int(tstate.step) == int(jstate.step) == 3


def test_train_step_gives_every_leaf_a_gradient():
    """A leaf the loss does not reach gets a zero gradient, as under
    ``jax.grad``: whisper trained without encoder frames moves its
    encoder by weight decay alone."""
    cfg = get_config("whisper-small").reduced().with_updates(**F32)
    params = init_params(cfg, seed=0, device="cpu")
    shape = InputShape("t", 16, 2, "train")
    batch = place_batch({k: v for k, v in make_batch_fn(cfg, shape)(0)
                         .items() if k in ("tokens", "labels")}, "cpu")
    step = make_train_step(cfg, options_for(cfg, shape))
    p1, state, met = step(params, adamw.init(params), batch)
    p2, _, _ = step(p1, state, batch)
    assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0
    decay = 1 - LR * 0.01 * adamw.AdamWConfig().weight_decay
    before = dict(flatten_with_keys(p1["encoder"]))
    for k, v in flatten_with_keys(p2["encoder"]):
        torch.testing.assert_close(v, before[k] * decay, rtol=1e-6, atol=0,
                                   msg=k)
    assert not torch.equal(p2["embed"], p1["embed"])


def test_train_loop_loss_falls():
    cfg = get_config("paper-backbone").reduced()
    with tempfile.TemporaryDirectory() as td:
        out = train_loop(cfg, InputShape("t", 64, 8, "train"), 40,
                         log_every=10, checkpoint_dir=td, device="cpu")
        assert (Path(td) / "step_000040" / "manifest.json").exists()
        manifest = json.loads((Path(td) / "step_000040" / "manifest.json")
                              .read_text())
    assert manifest["step"] == 40 and manifest["metadata"] == {
        "arch": cfg.name}
    steps = [i for i, _ in out["losses"]]
    assert steps == [0, 10, 20, 30, 39]
    assert out["losses"][-1][1] < out["losses"][0][1] - 0.5


def test_serve_loop_on_cpu():
    """The reference's serving driver loop on a tiny paper-backbone:
    every request gets its 12 tokens through the variant swaps."""
    cfg = get_config("paper-backbone").with_updates(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256)
    params = init_params(cfg, seed=0, device="cpu")
    out = serve_loop(cfg, params, requests=6, slots=2, max_seq=128,
                     adapt_every=4, device="cpu")
    eng = out["engine"]
    assert eng.stats.tokens_out == 6 * 12
    assert all(len(r.generated) == 12 for r in out["requests"])
    assert not eng.has_work
    assert len(out["middleware"].loop.decisions) >= 1


# ----------------------------------------------------- HLO parsers etc. ---
HLO = """
ENTRY %main (p: bf16[8,128]) -> bf16[8,128] {
  %ag = bf16[64,5120]{1,0} all-gather(%p), replica_groups={}
  %ar = f32[16,4096,5120]{2,1,0} all-reduce(%x), to_apply=%add
  %ags = (bf16[2,4]{1,0}, bf16[2,4]{1,0}) all-gather-start(%p)
  %agd = bf16[2,4]{1,0} all-gather-done(%ags)
}
"""

SCAN_HLO = """
%body.1 (p: f32[4]) -> f32[4] {
  %rs = f32[4,256]{1,0} reduce-scatter(%p), to_apply=%add
  %cp = s8[128]{0} collective-permute(%p)
}
ENTRY %main (p: bf16[8,128]) -> bf16[8,128] {
  %w = f32[4] while(%p), condition=%cond.1, body=%body.1
  %a2a = u32[2,2]{1,0} all-to-all(%p)
  %ar = pred[8] all-reduce-start(%p)
  %ard = pred[8] all-reduce-done(%ar)
}
"""


def test_collective_parse_handles_layouts():
    out = T_PROF.collective_bytes_from_hlo(HLO)
    assert out["all-gather"] == 64 * 5120 * 2 + 2 * (2 * 4 * 2)
    assert out["all-reduce"] == 16 * 4096 * 5120 * 4
    assert out == J_PROF.collective_bytes_from_hlo(HLO)


def test_scan_corrected_and_trip_counts_match_reference():
    for trips in (1, 6, 48):
        got = T_PROF.collective_bytes_scan_corrected(SCAN_HLO, trips)
        assert got == J_PROF.collective_bytes_scan_corrected(SCAN_HLO,
                                                             trips)
        assert got["reduce-scatter"] == 4 * 256 * 4 * trips
        assert got["all-to-all"] == 16 and got["all-reduce"] == 8
    for arch in list_archs() + ["mixtral-8x7b", "phi3-mini"]:
        assert T_PROF.scan_trip_count(get_config(arch)) == \
            J_PROF.scan_trip_count(j_get_config(arch)), arch


def test_planner_matches_reference_analytics():
    """The one-card planner's analytic flops and bytes, trip counts and
    model flops equal the JAX package's for every arch x shape; its
    roofline is on the H100's figures; nothing XLA-only is claimed."""
    with tempfile.TemporaryDirectory() as td:
        for arch in list_archs():
            jcfg = j_get_config(arch)
            for name in INPUT_SHAPES:
                rec = run_one(arch, name, Path(td), verbose=False)
                assert rec["status"] == "ok", rec.get("error")
                jshape = J_SHAPES[name]
                jopts = j_steps.options_for(jcfg, jshape)
                flops, nbytes = J_PROF.analytic_step_costs(
                    jcfg, jshape, remat=jopts.remat,
                    kv_bytes=1 if jopts.kv_cache_dtype == "fp8" else 2,
                    decode_window=jopts.decode_window)
                assert rec["analytic"] == {
                    "flops": flops, "bytes": nbytes,
                    "scan_trips": J_PROF.scan_trip_count(jcfg)}, (arch, name)
                assert rec["roofline"]["model_flops"] == \
                    J_PROF.model_flops_estimate(jcfg, jshape)
                assert rec["roofline"]["compute_s"] == pytest.approx(
                    flops / T_PROF.H100_SXM.peak_flops)
                assert rec["collective_total"] == 0.0
                assert set(rec["left_out"]) == {
                    "lower_s", "compile_s", "memory_analysis",
                    "cost_analysis", "hlo_lines"}
                assert not set(rec["left_out"]) & set(rec)
        assert len(list(Path(td).glob("*.json"))) == 4 * len(list_archs())


# ------------------------------------------------------------ baselines ---
TPU_FIELDS = T_PROF.HardwareProfile(**dataclasses.asdict(J_PROF.TPU_V5E))
CONTEXTS = (dict(), dict(battery_frac=0.2, mem_free_frac=0.3),
            dict(cpu_temp_derate=0.5, competing_procs=2, data_drift=0.4))


def _specs_equal(t, j):
    return dataclasses.asdict(t) == dataclasses.asdict(j)


def test_baselines_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in T_BASE.HANDCRAFTED.items()} \
        == {k: dataclasses.asdict(v) for k, v in J_BASE.HANDCRAFTED.items()}
    cfg, jcfg = get_config("paper-backbone"), j_get_config("paper-backbone")
    shape = InputShape("app", 256, 4, "prefill")
    jshape = JInputShape("app", 256, 4, "prefill")
    ev = optimizer.ActionEvaluator(cfg, shape, TPU_FIELDS)
    jev = j_optimizer.ActionEvaluator(jcfg, jshape)
    full = ev.evaluate(T_BASE.Action(variant=T_BASE.FULL_SPEC),
                       monitor.ResourceContext()).latency_s
    cands = [VariantSpec(width_ratio=w, depth_ratio=d)
             for w in (1.0, 0.75, 0.5) for d in (1.0, 0.75, 0.5)]
    jcands = [J_BASE.VariantSpec(width_ratio=w, depth_ratio=d)
              for w in (1.0, 0.75, 0.5) for d in (1.0, 0.75, 0.5)]
    chosen = set()
    for frac in (1.5, 0.9, 0.6, 0.3, 0.05):
        budget = full * frac
        for ctx in CONTEXTS:
            t = T_BASE.adadeep_select(cfg, shape, budget, ev,
                                      monitor.ResourceContext(**ctx))
            j = J_BASE.adadeep_select(jcfg, jshape, budget, jev,
                                      j_monitor.ResourceContext(**ctx))
            assert _specs_equal(t, j), (frac, ctx)
            chosen.add(t)
        t = T_BASE.ofa_select(cfg, shape, budget, cands, ev)
        j = J_BASE.ofa_select(jcfg, jshape, budget, jcands, jev)
        assert _specs_equal(t, j), frac
        chosen.add(t)
    assert len(chosen) >= 3          # the budgets select different variants
