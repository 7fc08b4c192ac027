"""The trainer's memory behaviour against the JAX package, on the CPU: the
recomputation ladder ``RuntimeOptions.remat`` in
``transformer.apply_stack`` and the donated AdamW step.

* Six structures, f32, the port's weights brought across to JAX by the
  bridge (``params_to_numpy``): the
  tiny paper-backbone (a period of one layer), the reduced zamba2 hybrid
  at 5 layers and period 2 (two periods each closed by the shared block,
  one leftover layer), the reduced gemma3-12b at 7 layers (one period of
  5 local and 1 global layers, window 16, one leftover), the reduced
  mamba2-370m, the reduced olmoe-1b-7b (the experts' batched products)
  and the reduced whisper-small (an encoder stack, and decoder layers
  attending over its output ``cross_src``).  Under ``dots`` and
  ``full`` the loss and every gradient equal the port's ``none`` bit for
  bit: recomputation replays the same operations.  olmoe runs under
  ``torch.use_deterministic_algorithms``: the backward of its token
  gather ``xf[sel_idx]`` (``moe.moe_apply``) is
  ``aten::_index_put_impl_`` with ``accumulate=True``, which on the CPU
  sums repeated rows in thread order, so two backwards under ``none``
  already part in the last bit; the deterministic mode sorts the
  indices.
* The same gradients against ``jax.value_and_grad`` of ``lm_loss(
  forward(...))`` under the same ``remat``: f32 in both packages, the
  same sums in another order, so the loss within rtol 1e-5 and each
  gradient within 1e-4 of its leaf's largest (as
  ``test_torch_moe.py``).
* The plain versions of K6 (``ssd_scan_ref``), K2 (``attention._attend``
  and ``cross_attention``) and K3 (``fused_ffn_ref``, inside the
  ``repro_torch::fused_ffn`` operator) are counted: a backward adds the
  calls made inside the recomputation regions, K3's excepted under
  ``dots``, whose policy keeps the operator's output; ``torch.no_grad``
  adds none.  The bytes the forward leaves alive for the backward fall
  none > dots > full.
* AdamW: ``apply_`` equals ``apply`` bit for bit over three steps on a
  tree with a stacked leaf (in chunks of 8 elements, so a chunk is a
  part of a row or several rows), a bf16 leaf and an integer leaf, and
  returns the tensors it was given; ``apply`` leaves its inputs alone;
  ``train_loop`` (donated) under ``full`` repeats ``none``'s losses and
  parameters bit for bit; TTA under the θ_s action ``remat_policy=
  "full"`` equals its default.
"""
import importlib

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import transformer as jt
from repro.models.runtime import RuntimeOptions as JOpts
from repro_torch.checkpoint import flatten_with_keys
from repro_torch.configs import get_config
from repro_torch.elastic.tta import tta_step
from repro_torch.engine.schedule import EngineConfig
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.launch.train import train_loop
from repro_torch.models import attention as t_attn
from repro_torch.models import init_params
from repro_torch.models import transformer as tt
from repro_torch.models.configs import InputShape
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.optim import adamw
from repro_torch.weights import params_to_numpy

k3 = importlib.import_module("repro_torch.kernels.fused_ffn")
k6 = importlib.import_module("repro_torch.kernels.ssd_scan")

torch.set_num_threads(2)

F32 = dict(activation_dtype="float32", vocab_size=256)
POLICIES = ("dots", "full")
MOE_OPTS = dict(moe_capacity_factor=2.0)


def _tiny(get, arch):
    cfg = get(arch)
    if arch == "paper-backbone":
        return cfg.with_updates(num_layers=2, d_model=64, num_heads=4,
                                num_kv_heads=2, head_dim=16, d_ff=128, **F32)
    if arch == "zamba2-1.2b":
        return cfg.reduced(num_layers=5).with_updates(
            shared_attn_period=2, ssm_chunk=16, **F32)
    if arch == "gemma3-12b":
        return cfg.reduced(num_layers=7).with_updates(sliding_window=16,
                                                      **F32)
    return cfg.reduced().with_updates(**F32)


# arch: (forward calls of K6, K2, K3; the part of them inside the
# recomputation regions), 2 x 32 tokens
CASES = {
    "paper-backbone": ((0, 2, 2), (0, 2, 2)),   # 2 periods of 1 layer
    "zamba2-1.2b": ((5, 2, 2), (4, 2, 2)),      # 2 x (2 Mamba + shared), 1
    "gemma3-12b": ((0, 7, 7), (0, 6, 6)),       # 5 local + 1 global, 1
    "mamba2-370m": ((2, 0, 0), (2, 0, 0)),
    "olmoe-1b-7b": ((0, 2, 0), (0, 2, 0)),      # no dense FFN
    "whisper-small": ((0, 6, 0), (0, 6, 0)),    # 2 encoder, 2 x (self +
}                                               # cross); non-gated FFN

_MODELS = {}


def _model(arch):
    """(JAX config, port config, bridged weights, the port's weights,
    tokens, labels, encoder frames or None)."""
    if arch not in _MODELS:
        jcfg, cfg = _tiny(j_get_config, arch), _tiny(get_config, arch)
        tp = init_params(cfg, seed=0, device="cpu")
        jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tp))
        rng = np.random.default_rng(7)
        toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
        frames = (rng.standard_normal((2, cfg.encoder_seq_len, cfg.d_model))
                  .astype(np.float32) if cfg.is_encoder_decoder else None)
        _MODELS[arch] = (jcfg, cfg, jp, tp, toks, np.roll(toks, -1, 1),
                         frames)
    return _MODELS[arch]


def _batch(toks, labels, frames):
    b = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if frames is not None:
        b["encoder_frames"] = torch.from_numpy(frames)
    return b


class _Deterministic:
    """``torch.use_deterministic_algorithms`` for the MoE structure (see
    the module docstring), restored on exit."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(self.on or self.was)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.was)


def _grads(arch, remat):
    jcfg, cfg, jp, tp, toks, labels, frames = _model(arch)
    opts = RuntimeOptions(remat=remat, **MOE_OPTS)
    with _Deterministic(cfg.arch_type == "moe"):
        return loss_and_grads(tp, cfg, opts, _batch(toks, labels, frames))


@pytest.fixture
def counted(monkeypatch):
    """Calls of the plain K6, K2 and K3 versions."""
    n = {"K6": 0, "K2": 0, "K3": 0}

    def counting(key, fn):
        def wrapper(*a, **kw):
            n[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(k6, "ssd_scan_ref", counting("K6", k6.ssd_scan_ref))
    monkeypatch.setattr(t_attn, "_attend", counting("K2", t_attn._attend))
    monkeypatch.setattr(t_attn, "cross_attention",
                        counting("K2", t_attn.cross_attention))
    monkeypatch.setattr(k3, "fused_ffn_ref", counting("K3",
                                                      k3.fused_ffn_ref))
    return n


def _bits_equal(a, b):
    fa, fb = dict(flatten_with_keys(a)), dict(flatten_with_keys(b))
    assert sorted(fa) == sorted(fb)
    return [k for k in fa if not (fa[k].dtype == fb[k].dtype
                                  and torch.equal(fa[k], fb[k]))]


# --------------------------------------------------------- the ladder ---
@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("arch", list(CASES))
def test_recomputed_gradients_equal_none_and_reference(arch, remat):
    """Bit for bit against the port's ``none``; against JAX under the
    same ``remat`` within the module's f32 tolerance."""
    loss, grads = _grads(arch, remat)
    loss0, grads0 = _grads(arch, "none")
    assert torch.equal(loss, loss0)
    assert _bits_equal(grads, grads0) == []

    jcfg, cfg, jp, _, toks, labels, frames = _model(arch)
    jo = JOpts(remat=remat, **MOE_OPTS)

    def j_loss(p):
        logits, aux = jt.forward(
            p, jcfg, jnp.asarray(toks), jo,
            encoder_frames=None if frames is None else jnp.asarray(frames))
        return jt.lm_loss(logits, jnp.asarray(labels)) \
            + jcfg.router_aux_weight * aux

    lj, gj = jax.jit(jax.value_and_grad(j_loss))(jp)
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-5)
    gj = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
          for kp, v in jax.tree_util.tree_leaves_with_path(gj)}
    gt = dict(flatten_with_keys(grads))
    assert sorted(gj) == sorted(gt)
    for name, g in gj.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(gt[name].numpy(), g,
                                   atol=1e-4 * scale + 1e-12, err_msg=name)


@pytest.mark.parametrize("arch", list(CASES))
def test_backward_recomputes_the_regions(arch, counted):
    """Per backward: ``none`` calls nothing again, ``full`` every kernel
    call of a region, ``dots`` those of K6 and K2 only; under
    ``torch.no_grad`` no policy adds a call."""
    fwd, region = CASES[arch]
    jcfg, cfg, jp, tp, toks, labels, frames = _model(arch)
    batch = _batch(toks, labels, frames)
    again = {"none": (0, 0, 0), "dots": region[:2] + (0,), "full": region}
    for remat, extra in again.items():
        opts = RuntimeOptions(remat=remat, **MOE_OPTS)
        for k in counted:
            counted[k] = 0
        with _Deterministic(cfg.arch_type == "moe"):
            loss_and_grads(tp, cfg, opts, batch)
        assert tuple(counted.values()) == tuple(
            a + b for a, b in zip(fwd, extra)), remat
        for k in counted:
            counted[k] = 0
        with torch.no_grad():
            tt.forward(tp, cfg, batch["tokens"], opts,
                       encoder_frames=batch.get("encoder_frames"))
        assert tuple(counted.values()) == fwd, remat


def _kept_bytes(fn, exclude):
    """Run ``fn`` and return (its result, the bytes of the storages that
    its operations created and that are still alive after it returns:
    what autograd and a checkpoint's selective cache keep for the
    backward, and the result).  Storages of ``exclude``'s tensors (the
    weights and inputs) are not counted."""
    seen = {}
    skip = {t.untyped_storage().data_ptr() for t in exclude}

    class Track(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in pytree_leaves(out):
                if isinstance(t, torch.Tensor):
                    st = t.untyped_storage()
                    if st.nbytes() and st.data_ptr() not in skip:
                        seen[st.data_ptr()] = (StorageWeakRef(st),
                                               st.nbytes())
            return out

    with Track():
        out = fn()
    return out, sum(n for ref, n in seen.values() if not ref.expired())


@pytest.mark.parametrize("arch", list(CASES))
def test_kept_bytes_fall_down_the_ladder(arch):
    jcfg, cfg, jp, tp, toks, labels, frames = _model(arch)
    batch = _batch(toks, labels, frames)
    kept = {}
    for remat in ("none", "dots", "full"):
        opts = RuntimeOptions(remat=remat, **MOE_OPTS)
        p = tree_map(lambda t: t.detach().requires_grad_(
            t.is_floating_point()), tp)
        leaves = [t for t in tree_leaves(p) if t.requires_grad]

        def fwd():
            logits, aux = tt.forward(p, cfg, batch["tokens"], opts,
                                     encoder_frames=batch.get(
                                         "encoder_frames"))
            return tt.lm_loss(logits, batch["labels"]) \
                + cfg.router_aux_weight * aux

        loss, kept[remat] = _kept_bytes(
            fwd, list(tree_leaves(tp)) + list(batch.values()))
        torch.autograd.grad(loss, leaves, allow_unused=True)
    assert kept["none"] > kept["dots"] > kept["full"], kept


def test_tta_under_full_recomputation_equals_default():
    """θ_s's ``remat_policy="full"`` reaches TTA's backward and changes
    no bit of the step."""
    _, cfg, _, tp, toks, _, _ = _model("paper-backbone")
    tokens = torch.from_numpy(toks)
    outs = {}
    for policy in ("none", "full"):
        opts = EngineConfig(remat_policy=policy).to_runtime_options()
        outs[policy] = tta_step(tp, cfg, tokens, opts=opts)
    assert torch.equal(outs["full"][1], outs["none"][1])
    assert _bits_equal(outs["full"][0], outs["none"][0]) == []


# ---------------------------------------------------------- donation ---
def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn(3, 4, 5, generator=g),
                       "ln": torch.randn(3, 5, generator=g)},
            "embed": torch.randn(7, 3, generator=g).to(torch.bfloat16),
            "ids": torch.arange(6, dtype=torch.int32),
            "scale": torch.randn((), generator=g)}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_clone(t) for t in tree)) \
            if isinstance(tree, adamw.AdamWState) else \
            tuple(_clone(t) for t in tree)
    return tree.clone()


def _ptrs(params, state):
    return [t.data_ptr() for t in tree_leaves(
        {"p": params, "m": state.m, "v": state.v, "step": state.step})]


@pytest.mark.parametrize("chunk", [8, adamw.CHUNK])
def test_apply_in_place_equals_apply(monkeypatch, chunk):
    monkeypatch.setattr(adamw, "CHUNK", chunk)
    params = _tree(0)
    state = adamw.init(params)
    donated, dstate = _clone(params), _clone(state)
    ptrs = _ptrs(donated, dstate)
    for i in range(3):
        grads = _tree(10 + i)
        params, state = adamw.apply(grads, params, state, lr_scale=0.5)
        out, ostate = adamw.apply_(grads, donated, dstate, lr_scale=0.5)
        assert out is donated and ostate.m is dstate.m
        assert _ptrs(out, ostate) == ptrs
        for a, b in ((out, params), (ostate.m, state.m),
                     (ostate.v, state.v)):
            assert _bits_equal(a, b) == []
        assert int(ostate.step) == int(state.step) == i + 1
    assert not torch.equal(params["layers"]["w"], _tree(0)["layers"]["w"])
    assert torch.equal(params["ids"], _tree(0)["ids"])


def test_apply_leaves_its_inputs_unmodified():
    params, grads = _tree(0), _tree(1)
    _, state = adamw.apply(_tree(2), params, adamw.init(params))
    before = _clone((params, grads, state))
    adamw.apply(grads, params, state)
    for a, b in zip(before, (params, grads, state)):
        if isinstance(a, adamw.AdamWState):
            assert torch.equal(a.step, b.step)
            a, b = {"m": a.m, "v": a.v}, {"m": b.m, "v": b.v}
        assert _bits_equal(a, b) == []


def test_donated_train_step_equals_pure_step():
    """``make_train_step(donate=True)`` returns the tensors it was given,
    holding the values of the pure step, bit for bit."""
    _, cfg, _, tp, toks, labels, _ = _model("paper-backbone")
    batch = _batch(toks, labels, None)
    opts = RuntimeOptions(remat="full")
    p0, s0 = _clone(tp), adamw.init(tp)
    p1, s1, m1 = make_train_step(cfg, opts)(p0, s0, batch)
    pd, sd = _clone(tp), adamw.init(tp)
    ptrs = [t.data_ptr() for t in tree_leaves(pd)]
    p2, s2, m2 = make_train_step(cfg, opts, donate=True)(pd, sd, batch)
    assert p2 is pd and [t.data_ptr() for t in tree_leaves(p2)] == ptrs
    assert _bits_equal(p2, p1) == [] and _bits_equal(s2.m, s1.m) == []
    assert _bits_equal(s2.v, s1.v) == [] and int(s2.step) == 1
    assert _bits_equal(p0, tp) == []
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])


def test_train_loop_full_recomputation_repeats_none():
    cfg = get_config("paper-backbone").with_updates(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256)
    shape = InputShape("t", 32, 2, "train")
    outs = {r: train_loop(cfg, shape, 3, log_every=1, remat=r,
                          device="cpu") for r in ("none", "full")}
    assert outs["full"]["losses"] == outs["none"]["losses"]
    assert len(outs["none"]["losses"]) == 3
    assert _bits_equal(outs["full"]["params"], outs["none"]["params"]) == []
