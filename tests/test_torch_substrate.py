"""The port's substrate against the JAX package, on the CPU: the data
pipeline (``repro_torch.data``) and checkpointing
(``repro_torch.checkpoint``).

* Twins of ``test_substrate.py``'s data and checkpoint tests; every batch
  is byte-equal to the reference's for the same seed and index
  (``SyntheticLM``, ``make_batch_fn`` with the whisper and internvl2
  stubs): the same numpy calls, so no tolerance.
* Checkpoints cross between the packages bit for bit: a JAX-written tree
  (f32, int32, bf16) restores in the port; a port-written f32 / int32
  tree restores in the JAX package; port-written bf16 ``.npy`` files are
  byte-equal to JAX-written ones; an ``AdamWState`` flattens to the
  reference's keys; a restore works without ``msgpack``.
* R9 pinned: the JAX package's own restore of a bf16 leaf raises
  ``ValueError`` (numpy loads the file as raw ``V2`` and finds no cast).
"""
import filecmp
import importlib
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as j_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_batch_fn as j_make_batch_fn
from repro.models import init_params as j_init_params
from repro.models.configs import InputShape as JInputShape
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import (flatten_with_keys, latest_checkpoint,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import (DataConfig, SyntheticLM, make_batch_fn,
                              place_batch)
from repro_torch.launch.steps import params_spec_struct
from repro_torch.models import init_params
from repro_torch.models.configs import InputShape
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import adamw
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)

ckpt_io = importlib.import_module("repro_torch.checkpoint.io")


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------- data -----
def test_data_deterministic_and_seekable():
    d = SyntheticLM(DataConfig(vocab_size=128, seq_len=32, batch_size=4))
    b1 = d.batch(7)
    b2 = d.batch(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 32)
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    j = JSyntheticLM(JDataConfig(vocab_size=128, seq_len=32, batch_size=4))
    for i in (0, 7):
        _assert_batches_equal(d.batch(i), j.batch(i))


def test_data_induction_structure():
    d = SyntheticLM(DataConfig(vocab_size=128, seq_len=64, batch_size=4,
                               copy_period=16))
    b = d.batch(0)
    full = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
    for off in range(16, 64, 16):
        np.testing.assert_array_equal(full[:, off], full[:, off - 16])
    _assert_batches_equal(b, JSyntheticLM(JDataConfig(
        vocab_size=128, seq_len=64, batch_size=4, copy_period=16)).batch(0))


def test_data_drift_changes_distribution():
    base = SyntheticLM(DataConfig(vocab_size=512, seq_len=64, batch_size=32))
    drift = SyntheticLM(DataConfig(vocab_size=512, seq_len=64, batch_size=32,
                                   drift=0.9))
    h1 = np.bincount(base.batch(0)["tokens"].ravel(), minlength=512)
    h2 = np.bincount(drift.batch(0)["tokens"].ravel(), minlength=512)
    tv = 0.5 * np.abs(h1 / h1.sum() - h2 / h2.sum()).sum()
    assert tv > 0.1
    _assert_batches_equal(drift.batch(3), JSyntheticLM(JDataConfig(
        vocab_size=512, seq_len=64, batch_size=32, drift=0.9)).batch(3))


def test_make_batch_fn_modality_stubs():
    shape, jshape = (InputShape("t", 32, 2, "train"),
                     JInputShape("t", 32, 2, "train"))
    for arch, key in (("whisper-small", "encoder_frames"),
                      ("internvl2-26b", "vision_embeds")):
        cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
        for seed, index in ((0, 0), (3, 5)):
            b = make_batch_fn(cfg, shape, seed=seed, drift=0.2)(index)
            _assert_batches_equal(b, j_make_batch_fn(
                jcfg, jshape, seed=seed, drift=0.2)(index))
        assert key in b
    assert b["vision_embeds"].shape == (2, cfg.num_vision_tokens,
                                        cfg.vision_embed_dim)


def test_place_batch_copies_to_the_device():
    b = SyntheticLM(DataConfig(vocab_size=64, seq_len=8, batch_size=2)
                    ).batch(0)
    t = place_batch(b, "cpu")
    for k in b:
        assert t[k].dtype == torch.int32 and t[k].device.type == "cpu"
        np.testing.assert_array_equal(t[k].numpy(), b[k])


# ------------------------------------------------------------ checkpoint ---
CFG = "paper-backbone"


def test_checkpoint_roundtrip():
    cfg = get_config(CFG).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(f"{td}/step_000010", params, step=10,
                        metadata={"arch": cfg.name})
        restored, step = restore_checkpoint(f"{td}/step_000010",
                                            params_spec_struct(cfg),
                                            device="cpu")
        assert step == 10
        for a, b in zip(tree_leaves(params), tree_leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert latest_checkpoint(td).name == "step_000010"
    assert latest_checkpoint(Path(td) / "gone") is None


def test_checkpoint_shape_mismatch_raises():
    cfg = get_config(CFG).reduced()
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(f"{td}/c", init_params(cfg, seed=0, device="cpu"))
        wrong = params_spec_struct(cfg.with_updates(d_ff=cfg.d_ff * 2))
        with pytest.raises(ValueError):
            restore_checkpoint(f"{td}/c", wrong, device="cpu")


def _mixed_tree(seed):
    """bf16, f32 and int32 leaves in a dict with a list, as numpy."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "w": rng.standard_normal((2, 5)).astype(np.float32),
            "b": [rng.integers(-9, 9, 3).astype(np.int32),
                  rng.standard_normal(2).astype(np.float32)]}


def _jax_tree(tree, bf16=("w",)):
    return {k: (jnp.asarray(v, jnp.bfloat16) if k in bf16 else
                jax.tree_util.tree_map(jnp.asarray, v))
            for k, v in tree.items()}


def _torch_tree(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                             "cpu")


def test_jax_checkpoint_restores_in_port_bit_for_bit():
    """f32, int32 and bf16 leaves written by the JAX package restore in
    the port with their exact bits (bf16 reinterpreted, not cast)."""
    jtree = _jax_tree(_mixed_tree(0))
    want = _torch_tree(jtree)
    with tempfile.TemporaryDirectory() as td:
        j_save(f"{td}/c", jtree, step=4, metadata={"arch": "x"})
        like = jax.tree_util.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            want)
        got, step = restore_checkpoint(f"{td}/c", like, device="cpu")
    assert step == 4
    assert got["w"].dtype == torch.bfloat16
    for k in ("a", "w"):
        assert torch.equal(got[k].view(torch.int16) if k == "w" else got[k],
                           want[k].view(torch.int16) if k == "w"
                           else want[k])
    assert torch.equal(got["b"][0], want["b"][0])
    assert torch.equal(got["b"][1], want["b"][1])
    # a full JAX parameter tree (bf16 weights) restores as the bridge has it
    cfg, jcfg = get_config(CFG).reduced(), j_get_config(CFG).reduced()
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    with tempfile.TemporaryDirectory() as td:
        j_save(f"{td}/p", jp)
        got, _ = restore_checkpoint(f"{td}/p", params_spec_struct(cfg),
                                    device="cpu")
    want, got = (dict(flatten_with_keys(t)) for t in (_torch_tree(jp), got))
    assert sorted(want) == sorted(got)
    for k, a in want.items():
        assert a.dtype == got[k].dtype and torch.equal(a, got[k]), k


def test_port_checkpoint_restores_in_jax():
    """An f32 / int32 tree written by the port restores in the JAX
    package with equal values; bf16 files are byte-equal to the JAX
    package's."""
    tree = _mixed_tree(1)
    ttree = _torch_tree(_jax_tree(tree, bf16=()))
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(f"{td}/t", ttree, step=2)
        like = jax.eval_shape(lambda: _jax_tree(tree, bf16=()))
        got, step = j_restore(f"{td}/t", like)
    assert step == 2
    for a, b in zip(jax.tree_util.tree_leaves(_jax_tree(tree, bf16=())),
                    jax.tree_util.tree_leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jtree = _jax_tree(tree, bf16=("a", "w"))
    with tempfile.TemporaryDirectory() as td:
        j_save(f"{td}/j", jtree)
        save_checkpoint(f"{td}/t", _torch_tree(jtree))
        for fn in sorted(Path(f"{td}/j").glob("*.npy")):
            assert filecmp.cmp(fn, Path(f"{td}/t") / fn.name,
                               shallow=False), fn.name


def test_r9_jax_restore_of_bf16_leaf_raises():
    """R9 (reference): the JAX package saves a bf16 leaf it cannot load
    back; pinned, not imitated (the port reads the same bytes)."""
    jtree = {"a": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4),
             "b": [jnp.arange(3, dtype=jnp.int32)]}
    with tempfile.TemporaryDirectory() as td:
        j_save(f"{td}/c", jtree)
        with pytest.raises(ValueError):
            j_restore(f"{td}/c", jax.eval_shape(lambda: jtree))
        got, _ = restore_checkpoint(f"{td}/c", {
            "a": torch.empty(3, 4, dtype=torch.bfloat16, device="meta"),
            "b": [torch.empty(3, dtype=torch.int32, device="meta")]},
            device="cpu")
    assert torch.equal(got["a"], torch.arange(12, dtype=torch.bfloat16)
                       .reshape(3, 4))


def test_adamw_state_keys_match_reference():
    cfg, jcfg = get_config(CFG).reduced(), j_get_config(CFG).reduced()
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    jstate = j_adamw.init(jp)
    state = adamw.init(_torch_tree(jp))
    with tempfile.TemporaryDirectory() as td:
        j_save(f"{td}/j", jstate, step=1)
        save_checkpoint(f"{td}/t", state, step=1)
        files = [sorted(p.name for p in Path(f"{td}/{w}").glob("*.npy"))
                 for w in "jt"]
        assert files[0] == files[1]
        assert ".step.npy" in files[1] and ".m__embed.npy" in files[1]
        got, _ = restore_checkpoint(f"{td}/j", jax.tree_util.tree_map(
            lambda t: t.to("meta"), state), device="cpu")
    assert isinstance(got, adamw.AdamWState)
    assert int(got.step) == 0 and got.m["embed"].dtype == torch.float32


def test_restore_without_msgpack(monkeypatch):
    """With ``msgpack`` missing the port writes and reads only
    ``manifest.json``, and reads a JAX-written checkpoint through it."""
    jtree = _jax_tree(_mixed_tree(2))
    want = _torch_tree(jtree)
    like = jax.tree_util.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), want)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    try:
        mod = importlib.reload(ckpt_io)
        assert not mod._HAVE_MSGPACK
        with tempfile.TemporaryDirectory() as td:
            j_save(f"{td}/j", jtree, step=3)
            mod.save_checkpoint(f"{td}/t", want, step=3)
            assert not (Path(td) / "t" / "manifest.msgpack").exists()
            for path in ("j", "t"):
                got, step = mod.restore_checkpoint(f"{td}/{path}", like,
                                                   device="cpu")
                assert step == 3
                got, want_flat = (dict(flatten_with_keys(t))
                                  for t in (got, want))
                assert sorted(got) == sorted(want_flat)
                for k, a in got.items():
                    b = want_flat[k]
                    assert a.dtype == b.dtype
                    assert torch.equal(a.view(torch.int16)
                                       if a.dtype == torch.bfloat16 else a,
                                       b.view(torch.int16)
                                       if b.dtype == torch.bfloat16 else b)
    finally:
        monkeypatch.undo()
        importlib.reload(ckpt_io)
    assert ckpt_io._HAVE_MSGPACK
