"""The SSD scan's gradient (K6 under autograd), on the CPU.

* ``ssd_scan_backward`` against ``torch.autograd.grad`` through the plain
  ``ssd_scan_ref``, with x, b and c as views of one conv row (the
  model's ``_heads`` layout), in f32 and f64, with and without an
  initial state, a ragged length and a multi-chunk one.  Both sides
  differentiate the same f32 graph of the plain version, so the
  gradients are equal up to f32 rounding of reordered sums (atol 1e-5
  on gradients of magnitude ~1).
* ``_SsdScan`` — the autograd route that the card's launch takes — with
  its launch replaced by the plain forward (the kernel cannot run here):
  a gradient reaches the base of each view, and inside a Mamba2 block
  every weight of the block gets the same gradient as through the plain
  path.  The card's own twin is ``test_torch_cuda.py::
  test_ssd_scan_grads_on_card``.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models import ssm
from repro_torch.models.transformer import init_params
from repro_torch.models.layers import layer_slice

torch.set_num_threads(2)

# the module (``repro_torch.kernels.ssd_scan`` names the wrapper function)
k6 = importlib.import_module("repro_torch.kernels.ssd_scan")

GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


def _views(seed, dtype, *, bsz=2, s=40, h=4, g=2, p=8, n=16):
    """x (B,S,H,P), b, c (B,S,G,N) as views of one (B,S,H*P+2*G*N) row,
    dt (B,S,H) > 0, a (H,) < 0, all leaves requiring grad."""
    rng = np.random.default_rng(seed)
    width = h * p + 2 * g * n
    row = torch.from_numpy(rng.standard_normal((bsz, s, width))).to(
        dtype).requires_grad_()
    dt = torch.from_numpy(rng.uniform(0.05, 0.5, (bsz, s, h))).float() \
        .requires_grad_()
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, h)).float().requires_grad_()
    x = row[..., :h * p].reshape(bsz, s, h, p)
    b = row[..., h * p:h * p + g * n].reshape(bsz, s, g, n)
    c = row[..., h * p + g * n:].reshape(bsz, s, g, n)
    dy = torch.from_numpy(rng.standard_normal((bsz, s, h, p))).to(dtype)
    dstate = torch.from_numpy(rng.standard_normal((bsz, h, p, n))).float()
    init = torch.from_numpy(rng.standard_normal((bsz, h, p, n))).float() \
        .requires_grad_()
    return row, x, dt, a, b, c, dy, dstate, init


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("s,chunk", [(40, 16), (16, 16)])
def test_backward_matches_autograd_of_plain(dtype, with_init, s, chunk):
    row, x, dt, a, b, c, dy, dstate, init = _views(3, dtype, s=s)
    init = init if with_init else None
    y, st = ssd_scan_ref(x.float(), dt, a, b, c, chunk=chunk,
                         initial_state=init)
    ins = [x, dt, a, b, c] + ([init] if with_init else [])
    want = torch.autograd.grad([y.to(dtype), st], ins, [dy, dstate])
    got = k6.ssd_scan_backward(x, dt, a, b, c, dy, dstate, chunk=chunk,
                               initial_state=init)
    assert (got[5] is None) == (not with_init)
    for name, w, g_, t in zip("x dt a b c init".split(), want, got, ins):
        assert g_.dtype == t.dtype and g_.shape == t.shape, name
        torch.testing.assert_close(g_, w, **GRAD_TOL, msg=name)


def _plain_launch(x, dt, a, b, c, initial_state, chunk, out_dtype):
    y, st = ssd_scan_ref(x.float(), dt, a, b, c, chunk=chunk,
                         initial_state=initial_state)
    return y.to(out_dtype), st


@pytest.mark.parametrize("with_init", [False, True])
def test_autograd_route_reaches_the_views_base(monkeypatch, with_init):
    monkeypatch.setattr(k6, "_launch", _plain_launch)
    row, x, dt, a, b, c, dy, dstate, init = _views(5, torch.float32)
    init = init if with_init else None
    y, st = k6._SsdScan.apply(x, dt, a, b, c, init, 16, torch.float32)
    assert y.grad_fn is not None and st.grad_fn is not None
    ((y * dy).sum() + (st * dstate).sum()).backward()
    got = [t.grad.clone() for t in (row, dt, a)] + (
        [init.grad.clone()] if with_init else [])
    for t in (row, dt, a) + ((init,) if with_init else ()):
        t.grad = None
    y, st = ssd_scan_ref(x.float(), dt, a, b, c, chunk=16,
                         initial_state=init)
    ((y * dy).sum() + (st * dstate).sum()).backward()
    want = [row.grad, dt.grad, a.grad] + ([init.grad] if with_init else [])
    for name, g_, w in zip(("row", "dt", "a", "init"), got, want):
        torch.testing.assert_close(g_, w, **GRAD_TOL, msg=name)
    # every column of the row (x, b and c) got its gradient
    assert bool((got[0].abs().sum(dim=(0, 1)) > 0).all())


def test_mamba_block_weights_get_their_gradient(monkeypatch):
    """A Mamba2 block of the reduced mamba2-370m through the autograd
    route: in_proj, conv_w, conv_b, dt_bias, a_log (and every other
    weight) get the plain path's gradient."""
    cfg = get_config("mamba2-370m").reduced(d_model=64).with_updates(
        ssm_chunk=16, activation_dtype="float32", param_dtype="float32")
    layer = layer_slice(init_params(cfg, seed=0, device="cpu")["layers"],
                        0)["mamba"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))

    def grads():
        p = {k: v.detach().requires_grad_() for k, v in layer.items()}
        y, st, _ = ssm.mamba_forward_states(p, x, cfg)
        (y.square().sum() + st.sum()).backward()
        return {k: v.grad for k, v in p.items()}

    plain = grads()

    def routed(x, dt, a, b, c, *, chunk, initial_state=None):
        return k6._SsdScan.apply(x, dt, a, b, c, initial_state, chunk,
                                 x.dtype)

    monkeypatch.setattr(k6, "_launch", _plain_launch)
    monkeypatch.setattr(ssm.kernel_ops, "ssd_scan", routed)
    got = grads()
    assert set(got) == set(plain)
    for k in plain:
        assert got[k] is not None and bool(got[k].abs().sum() > 0), k
        torch.testing.assert_close(got[k], plain[k], **GRAD_TOL, msg=k)
