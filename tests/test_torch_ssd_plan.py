"""K6's bf16 route (``wgmma``) on the CPU: its plan and its arithmetic.

* ``ssd_plan`` as a pure function of shapes: the route by dtype, the
  items (one chunk of one batch element and head) and tickets at the
  served shapes, shared memory within one block's 232,448 bytes for all
  six (P, N) at every chunk of 16-256 rows, the flags (one a (batch,
  head)) after the ticket counter, the refusals.
* ``ssd_tma_numbers``: the numbers the C entry encodes its tensor maps
  from, for the model's views of mamba2-370m's 2304-wide and
  zamba2-1.2b's 4224-wide conv rows and for ``ops.ssd``'s layout, and
  what TMA cannot read.
* An emulation of the route, written here in plain PyTorch with the
  kernel's order and rounding points: items taken in chunk order, the
  state chained from item to item through one (P, N) buffer a (batch,
  head), the scores' decay factored at the key tile's last row off the
  diagonal 64-row tiles, every f32 operand (the state weights times x, the
  carried state, the decayed scores) split into bf16 high and low parts
  against exact bf16 b, c and x, f32 sums, y rounded once.  It is held
  against the JAX package (``jax.jit`` of ``repro.models.ssm.
  ssd_scan_ref``, and the Pallas kernel in interpret mode at one small
  shape) at f32 (atol 1e-3, rtol 1e-4, the card tests' f32 tolerance)
  and, with y in bf16, at the card tests' bf16 tolerance (atol 2e-2,
  rtol 1e-2).  The kernel itself is held against the plain version on
  the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import ssm as jssm
from repro_torch.kernels.ssd_scan import (HEAD_DIMS, MAX_CHUNK, STATE_DIMS,
                                          WG_MAX_CHUNK, WG_THREADS,
                                          ssd_plan, ssd_tma_numbers, wg_smem)

torch.set_num_threads(2)

H100_SMEM = 232_448
F32_TOL = dict(atol=1e-3, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=1e-2)
JAX_REF = jax.jit(jssm.ssd_scan_ref, static_argnames=("chunk",))

# (label, batch, seq, heads, groups, head_dim, state_dim, items): the
# served calls, chunk 256
SERVED = [("mamba2-370m burst", 8, 2048, 32, 1, 64, 128, 2048),
          ("mamba2-370m one prompt", 1, 2048, 32, 1, 64, 128, 256),
          ("zamba2-1.2b prefill", 8, 1024, 64, 1, 64, 64, 2048),
          ("zamba2-1.2b ragged prefill", 8, 1000, 64, 1, 64, 64, 2048),
          ("zamba2-1.2b train step", 4, 1024, 64, 1, 64, 64, 1024)]


# ----------------------------------------------------------- the plan --
def test_route_by_dtype():
    assert ssd_plan(torch.bfloat16, 1, 64, 4, 64, 64, 64).route == "wgmma"
    assert ssd_plan(torch.float32, 1, 64, 4, 64, 64, 64).route == \
        "cuda_cores"
    with pytest.raises(ValueError):
        ssd_plan(torch.float16, 1, 64, 4, 64, 64, 64)


@pytest.mark.parametrize("case", SERVED, ids=lambda c: c[0])
def test_served_plans(case):
    """An item a (chunk, batch element, head), chunk-major tickets, one
    flag a (batch, head) after the ticket counter, no f32 workspace."""
    _, b, s, h, g, p, n, items = case
    plan = ssd_plan(torch.bfloat16, b, s, h, p, n, 256)
    assert plan.route == "wgmma" and plan.chunk == 256
    assert plan.chunks == -(-s // 256) and plan.q_tiles == 4
    assert plan.items == items == b * plan.chunks * h
    assert plan.flags == b * h and plan.counters == 1 + b * h
    assert plan.cs_floats == 0 and plan.state_floats == 0
    assert plan.threads == WG_THREADS == 384
    assert plan.smem == wg_smem(n) <= H100_SMEM


def test_plan_of_ops_ssd_layout():
    """``ops.ssd``'s layout (B = 1, H = G = BH) plans like any other: an
    item a head and chunk."""
    assert ssd_plan(torch.bfloat16, 1, 512, 48, 32, 128, 128).items == 4 * 48


@pytest.mark.parametrize("p", HEAD_DIMS)
@pytest.mark.parametrize("n", STATE_DIMS)
def test_shared_memory_fits_at_every_chunk(p, n):
    """The block's shared memory holds a whole chunk's B and X, the split
    state and two C tiles a consumer group: within one block's 232,448
    bytes for all six (P, N) at chunks 16..256, the same at every chunk
    (the kernel lays it out for 256 rows)."""
    sizes = set()
    for chunk in (16, 17, 64, 100, 128, 200, 255, 256):
        plan = ssd_plan(torch.bfloat16, 2, 4096, 4, p, n, chunk)
        assert plan.q_tiles == -(-chunk // 64)
        sizes.add(plan.smem)
    assert len(sizes) == 1 and sizes.pop() <= H100_SMEM
    # mamba2's burst, the largest: B 64 KB, X 32 KB, the split state 32
    # KB, four C tiles 64 KB
    assert wg_smem(128) == 206_088


def test_chunk_limits():
    """The wgmma route takes chunks of up to 256 rows, the CUDA-core route
    of up to 1024; what either cannot take raises."""
    assert WG_MAX_CHUNK == 256 and MAX_CHUNK == 1024
    with pytest.raises(ValueError):
        ssd_plan(torch.bfloat16, 1, 4096, 4, 64, 64, 257)
    assert ssd_plan(torch.bfloat16, 1, 200, 4, 64, 64, 1024).chunk == 200
    assert ssd_plan(torch.float32, 1, 4096, 4, 64, 64, 1024).chunk == 1024
    for bad in ((torch.bfloat16, 1, 64, 4, 48, 64, 64),     # P 48
                (torch.bfloat16, 1, 64, 4, 64, 16, 64),     # N 16
                (torch.bfloat16, 1, 0, 4, 64, 64, 64),      # empty
                (torch.bfloat16, 1, 64, 4, 64, 64, 0)):     # chunk 0
        with pytest.raises(ValueError):
            ssd_plan(*bad)


def _item(t, batch, heads, groups=1):
    """Item t of the kernel's ticket order (``wg::item_of``): chunk-major,
    then batch element, then head; and the head's group."""
    k, r = divmod(t, batch * heads)
    b, h = divmod(r, heads)
    return b, k, h, h // (heads // groups)


@pytest.mark.parametrize("case", SERVED, ids=lambda c: c[0])
def test_tickets_wait_only_on_smaller_tickets(case):
    """Every item is taken once; the item it waits on (the same heads, the
    chunk before) holds a smaller ticket, which a running block already
    took, so the chain cannot deadlock."""
    _, b, s, h, g, p, n, items = case
    plan = ssd_plan(torch.bfloat16, b, s, h, p, n, 256)
    seen = {}
    for t in range(plan.items):
        seen[_item(t, b, h, g)[:3]] = t
    assert len(seen) == plan.items
    for (bi, k, h0), t in seen.items():
        if k > 0:
            assert seen[(bi, k - 1, h0)] < t


# ------------------------------------------------------ the tensor maps --
def _conv_views(b, s, h, g, p, n, dtype=torch.bfloat16):
    width = h * p + 2 * g * n
    conv = torch.zeros(b, s, width, dtype=dtype)
    x = conv[..., :h * p].reshape(b, s, h, p)
    bm = conv[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = conv[..., h * p + g * n:].reshape(b, s, g, n)
    return conv, x, bm, cm


@pytest.mark.parametrize("h,p,n,width", [(32, 64, 128, 2304),
                                         (64, 64, 64, 4224)])
def test_tma_numbers_of_the_model_views(h, p, n, width):
    """mamba2-370m's and zamba2-1.2b's x, b and c read in place from their
    conv rows: dims (columns, S, heads or groups, B), byte strides (row,
    head or group, batch), boxes of 64 columns x 64 rows.  b and c's
    single group is never stepped along: its stride is the row span."""
    bsz, s = 8, 1024
    conv, x, bm, cm = _conv_views(bsz, s, h, 1, p, n)
    assert conv.shape[-1] == width
    nums = ssd_tma_numbers(x, bm, cm)
    row, batch = 2 * width, 2 * width * s
    assert nums[:9] == [p, s, h, bsz, row, 2 * p, batch, 64, 64]
    assert nums[9:18] == [n, s, 1, bsz, row, row * s, batch, 64, 64]
    assert nums[18:] == [n, s, 1, bsz, row, row * s, batch, 64, 64]


def test_tma_numbers_of_ops_ssd_layout():
    """``ops.ssd`` passes the Pallas layout (BH, S, P) as the view B = 1,
    H = G = BH of its transposes: x's row stride is P and its head
    stride S P; the batch dim, of extent 1, is never stepped along."""
    bh, s, p, n = 6, 512, 32, 128
    kx = torch.zeros(bh, s, p, dtype=torch.bfloat16)
    kb = torch.zeros(bh, s, n, dtype=torch.bfloat16)
    x, bm = kx.transpose(0, 1)[None], kb.transpose(0, 1)[None]
    assert x.stride()[1:] == (p, s * p, 1)
    nums = ssd_tma_numbers(x, bm, bm)
    assert nums[:9] == [p, s, bh, 1, 2 * p, 2 * s * p, 2 * s * p * bh, 64,
                        64]
    assert nums[9:18] == [n, s, bh, 1, 2 * n, 2 * s * n, 2 * s * n * bh,
                          64, 64]


def test_tma_refuses_what_it_cannot_read():
    """A base off 16 bytes, a row stride not a multiple of 16 bytes, a
    last dim that is not dense: ValueError, before any launch."""
    _, x, bm, cm = _conv_views(2, 64, 4, 1, 64, 64)
    flat = torch.zeros(2 * 64 * 384 + 8, dtype=torch.bfloat16)
    off = flat[1:1 + 2 * 64 * 384].view(2, 64, 6, 64)     # 2 bytes off
    with pytest.raises(ValueError):
        ssd_tma_numbers(off[:, :, :4], bm, cm)
    odd = torch.zeros(2, 64, 388, dtype=torch.bfloat16)   # 776-byte rows
    with pytest.raises(ValueError):
        ssd_tma_numbers(odd[..., :256].unflatten(-1, (4, 64)), bm, cm)
    every_other = torch.zeros(2, 64, 1, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError):                       # strided columns
        ssd_tma_numbers(x, bm, every_other)


# ------------------------------------------------- the route, emulated --
LOG2E = 1.4426950408889634


def _split(v):
    """v (f32) as bf16 high and low parts, each back in f32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def emulate_wgmma_route(x, dt, a, b, c, *, chunk, initial_state=None,
                        out_dtype=torch.float32):
    """The wgmma route's arithmetic in plain PyTorch, in its order: x, b,
    c hold bf16 values (in f32 tensors); the items in ticket order; for
    each item its heads' cumulative decays, the chunk's own state X'^T B
    with X' = exp(cs_last - cs_s) dt_s x_s split, the chain through one
    state buffer, then each 64-row query tile: the carried state's term
    (C_i state_in^T with the state split, times exp2 of cs in log2
    units), the scores C_i B_j^T, W' = scores
    o exp2(cs2_l - cs2_s) dt_s (masked before exp; off the diagonal
    64-row tiles exp2(cs2_l - cs2_e) (exp2(cs2_e - cs2_s) dt_s), e the
    key tile's last row) split, W' X_j; y rounded once."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    plan = ssd_plan(torch.bfloat16, bsz, s, h, p, n, chunk)
    chunk = plan.chunk
    y = torch.zeros(bsz, s, h, p)
    state = torch.zeros(bsz, h, p, n)
    for t in range(plan.items):
        bi, k, hh, gi = _item(t, bsz, h, g)
        c0 = k * chunk
        rows = min(chunk, s - c0)
        cb, bb = c[bi, c0:c0 + rows, gi], b[bi, c0:c0 + rows, gi]
        scores = cb @ bb.T                     # (rows, rows), f32 sums
        dth = dt[bi, c0:c0 + rows, hh]
        cs = torch.cumsum(dth * a[hh], 0)
        ws = torch.exp(cs[-1] - cs) * dth
        xh = x[bi, c0:c0 + rows, hh]
        xhi, xlo = _split(xh * ws[:, None])
        s_local = xhi.T @ bb + xlo.T @ bb
        if k > 0:
            s_in = state[bi, hh].clone()
        elif initial_state is not None:
            s_in = initial_state[bi, hh].float()
        else:
            s_in = torch.zeros(p, n)
        state[bi, hh] = torch.exp(cs[-1]) * s_in + s_local
        cs2 = cs * LOG2E
        shi, slo = _split(s_in)
        yh = torch.exp2(cs2)[:, None] * (cb @ shi.T + cb @ slo.T)
        lidx = torch.arange(rows)
        valid = lidx[:, None] >= lidx[None, :]
        expo = torch.where(valid, cs2[:, None] - cs2[None, :],
                           torch.zeros(()))
        w = torch.where(valid, scores * torch.exp2(expo) * dth[None, :],
                        torch.zeros(()))
        # off the diagonal 64-row tiles the decay is factored at the
        # key tile's last row e: exp2(cs_l - cs_e) (exp2(cs_e - cs_s)
        # dt_s)
        ce = cs2[torch.clamp(lidx | 63, max=rows - 1)]
        off = (lidx[:, None] // 64) > (lidx[None, :] // 64)
        cols = torch.exp2(ce - cs2) * dth
        w = torch.where(off, scores * torch.exp2(
            torch.where(off, cs2[:, None] - ce[None, :],
                        torch.zeros(()))) * cols[None, :], w)
        whi, wlo = _split(w)
        y[bi, c0:c0 + rows, hh] = yh + whi @ xh + wlo @ xh
    return y.to(out_dtype), state


def _inputs(seed, bsz, s, h, g, p, n):
    """bf16-valued x, b, c (as f32), dt after softplus, a < 0: what the
    kernel reads, as the card tests draw them."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float()

    x = bf(rng.standard_normal((bsz, s, h, p)))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((bsz, s, h)).astype(
            np.float32)) - 1.0)
    a = -torch.exp(torch.from_numpy(rng.standard_normal(h).astype(
        np.float32)) * 0.5)
    b = bf(rng.standard_normal((bsz, s, g, n)) * n ** -0.25)
    c = bf(rng.standard_normal((bsz, s, g, n)) * n ** -0.25)
    return x, dt, a, b, c


def _jax(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


@pytest.mark.parametrize("s,g,init", [(200, 1, False), (300, 2, True),
                                      (64, 1, True)])
def test_emulated_route_matches_jax_model_ref(s, g, init):
    """The model layout, a ragged S, two chunks of 128 rows (two 64-row
    query tiles each), grouped b/c, with and without an initial state:
    f32 y within the f32 tolerance of the JAX oracle, bf16 y within the
    bf16 one, the final state within the f32 one."""
    bsz, h, p, n, chunk = 2, 4, 32, 32, 128
    x, dt, a, b, c = _inputs(s + g, bsz, s, h, g, p, n)
    st0 = (torch.from_numpy(np.random.default_rng(3).standard_normal(
        (bsz, h, p, n)).astype(np.float32)) if init else None)
    jy, jst = JAX_REF(*_jax(x, dt, a, b, c), chunk=chunk,
                      initial_state=None if st0 is None else
                      jnp.asarray(st0.numpy()))
    jy, jst = torch.from_numpy(np.array(jy)), torch.from_numpy(
        np.array(jst))
    y, st = emulate_wgmma_route(x, dt, a, b, c, chunk=chunk,
                                initial_state=st0)
    torch.testing.assert_close(y, jy, **F32_TOL)
    torch.testing.assert_close(st, jst, **F32_TOL)
    yb, _ = emulate_wgmma_route(x, dt, a, b, c, chunk=chunk,
                                initial_state=st0, out_dtype=torch.bfloat16)
    torch.testing.assert_close(yb.float(), jy, **BF16_TOL)


def test_emulated_route_matches_pallas_interpret():
    """``ops.ssd``'s layout (one head a group) against
    the Pallas kernel in interpret mode, the JAX package's own kernel
    run as its suite runs it on the CPU."""
    bh, s, p, n, chunk = 3, 256, 32, 64, 128
    x, dt, a, b, c = _inputs(7, 1, s, bh, bh, p, n)
    kx, kdt = x[0].transpose(0, 1), dt[0].transpose(0, 1)
    kb, kc = b[0].transpose(0, 1), c[0].transpose(0, 1)
    py, pst = pallas_ssd_scan(*_jax(kx.contiguous(), kdt.contiguous(), a,
                                    kb.contiguous(), kc.contiguous()),
                              chunk=chunk, interpret=True)
    py = torch.from_numpy(np.array(py)).transpose(0, 1)[None]
    pst = torch.from_numpy(np.array(pst))[None]
    y, st = emulate_wgmma_route(x, dt, a, b, c, chunk=chunk)
    torch.testing.assert_close(y, py, **F32_TOL)
    torch.testing.assert_close(st, pst, **F32_TOL)
    yb, _ = emulate_wgmma_route(x, dt, a, b, c, chunk=chunk,
                                out_dtype=torch.bfloat16)
    torch.testing.assert_close(yb.float(), py, **BF16_TOL)


def test_split_operands_leave_two_to_the_minus_17():
    """The split that keeps the route's f32 operands: hi + lo leaves at
    most ~2^-17 of the value (the reason the card's f32-y tolerance
    holds with bf16 products)."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100000).astype(np.float32)) * 7.0
    hi, lo = _split(v)
    rel = ((hi + lo - v).abs() / v.abs().clamp_min(1e-30)).max()
    assert float(rel) <= 2.0 ** -16
    assert math.isfinite(float(rel))
