"""K2's hd 16/32 route, its arithmetic emulated on the CPU and held to the
JAX package's flash attention oracle.

The kernel (``flash_attn_nw_kernel`` in ``csrc/flash_attn.cu``) runs only
on the card; what it rounds, and where, is reproduced here in plain
PyTorch: f32 scores of bf16 q and k over 64-key tiles in order, each
row's running max over its valid columns (causal, window, ``kv_len``),
weights ``exp2(s * scale * log2 e - m * scale * log2 e)`` in f32, P rounded
to bf16, and O and the row sums both taken from P (bf16) times ``[V | 1]``
with f32 sums (the sums come out of the same product as O: 8 columns of
ones beside V); O rescaled on a new max, divided once by the sums and
rounded to bf16.  The emulation must stay within the card tests'
bf16 tolerance (``tests/test_torch_cuda.py`` ``TOL``) of the JAX oracle
``repro.kernels.ref.flash_attn_ref`` and of Pallas interpret mode, and
give exactly 0 for a row with no valid key.  Inputs are drawn from seeds
with numpy, at paper-backbone's widths (8 heads of 32) and at hd 16 with
grouped KV heads.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attn import flash_attention as pallas_flash
from repro_torch.kernels import flash_attn

BF16_TOL = dict(atol=2e-2, rtol=1e-2)
LOG2E = 1.4426950408889634


def emulate_narrow(q, k, v, *, causal=True, window=0, kv_len=None):
    """The route's arithmetic: q (B, H, S, hd), k and v (B, K, S_k, hd),
    bf16; returns bf16 (B, H, S, hd).  Tiles no row sees add exp2(-huge)
    = 0 and leave each max, so all rows walk all tiles here."""
    b, h, s, hd = q.shape
    sk = k.shape[2]
    bk = flash_attn.NW_BLOCK_K
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    v1 = torch.cat([vf, torch.ones(*vf.shape[:3], 8)], dim=-1)
    sl2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    rows = torch.arange(s)[:, None]
    lim = sk if kv_len is None else min(sk, kv_len)
    m = torch.full((b, h, s, 1), -1e30)
    acc = torch.zeros(b, h, s, hd + 8)
    for c0 in range(0, sk, bk):
        cols = torch.arange(c0, min(c0 + bk, sk))[None, :]
        valid = cols < lim
        if causal:
            valid = valid & (cols <= rows)
        if window:
            valid = valid & (cols > rows - window)
        sc = q.float() @ kf[:, :, c0:c0 + bk].transpose(-1, -2)
        sc = torch.where(valid, sc, torch.tensor(-1e30))
        mn = torch.maximum(m, sc.amax(-1, keepdim=True))
        sh = torch.where(mn == -1e30, torch.tensor(0.0), -mn * sl2)
        corr = torch.where(mn == m, torch.tensor(1.0),
                           torch.exp2(m * sl2 + sh))
        p = torch.exp2(sc * sl2 + sh).to(torch.bfloat16).float()
        acc = acc * corr + p @ v1[:, :, c0:c0 + bk]
        m = mn
    o, l = acc[..., :hd], acc[..., hd:hd + 1]
    return (o / l.clamp(min=1e-30)).to(torch.bfloat16)


def _case(seed, b, h, kvh, s, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, n, s, hd))
                             .astype(np.float32)).to(torch.bfloat16)
            for n in (h, kvh, kvh)]


CASES = [
    # (B, H, K, S, hd, mask)
    (2, 8, 8, 200, 32, dict(causal=True)),
    (1, 8, 8, 130, 32, dict(causal=True, window=64)),
    (2, 8, 8, 97, 32, dict(causal=True, kv_len=37)),
    (1, 8, 8, 65, 32, dict(causal=True, kv_len=0)),
    (1, 8, 8, 320, 32, dict(causal=True, window=40, kv_len=100)),
    (2, 8, 8, 150, 32, dict(causal=False)),
    (2, 8, 2, 129, 16, dict(causal=True)),
    (1, 8, 1, 77, 16, dict(causal=True, window=1)),
]


@pytest.mark.parametrize("case", CASES, ids=[
    f"B{c[0]}-H{c[1]}-K{c[2]}-S{c[3]}-hd{c[4]}-"
    + "-".join(f"{k}{v}" for k, v in c[5].items()) for c in CASES])
def test_route_arithmetic_matches_jax_oracle(case):
    b, h, kvh, s, hd, mask = case
    q, k, v = _case(s + hd + kvh, b, h, kvh, s, hd)
    emu = emulate_narrow(q, k, v, **mask)
    g = h // kvh
    f32 = lambda t: jnp.asarray(t.float().numpy())              # noqa: E731
    ref = np.asarray(jref.flash_attn_ref(
        f32(q), f32(k.repeat_interleave(g, 1)),
        f32(v.repeat_interleave(g, 1)), **mask))
    np.testing.assert_allclose(emu.float().numpy(), ref, **BF16_TOL)
    if mask.get("kv_len") == 0:
        assert bool((emu == 0).all())


def test_route_arithmetic_matches_pallas_interpret():
    """paper-backbone's layer at 128 tokens through the Pallas kernel in
    interpret mode (its own 64-row and 64-key blocks), bf16 in and out."""
    q, k, v = _case(7, 1, 8, 8, 128, 32)
    emu = emulate_narrow(q, k, v, causal=True)
    bf = lambda t: jnp.asarray(t.float().numpy()).astype(  # noqa: E731
        jnp.bfloat16).reshape(8, 128, 32)
    out = pallas_flash(bf(q), bf(k), bf(v), causal=True, block_q=64,
                       block_k=64, interpret=True)
    ref = np.asarray(out.astype(jnp.float32)).reshape(1, 8, 128, 32)
    np.testing.assert_allclose(emu.float().numpy(), ref, **BF16_TOL)
