"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each ``*_ref`` function computes what its kernel computes, in plain
tensor ops.  The wrappers in :mod:`repro_torch.kernels.ops` take it for
tensors on the CPU; on the card it is what a kernel is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


# ---------------------------------------------------------- act_quant ------
QBLOCK = 128


def _pad_cols(x: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad the last axis to a multiple of ``block`` (the JAX codec's
    ``_pad_to_block``)."""
    pad = (-x.shape[-1]) % block
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``amax / qmax + 1e-12`` in f32 with an IEEE division on every
    device: on the card, PyTorch divides by a Python number as a product
    with its reciprocal, which can land one ulp away."""
    return amax / amax.new_full((), qmax) + 1e-12


def act_quant_ref(x: torch.Tensor, block: int = QBLOCK):
    """Blockwise symmetric int8 quantization along the last dim.

    x: (M, n) f32/bf16 -> (codes int8 (M, n), scales f32 (M, ceil(n /
    block))): ``scale = amax/127 + 1e-12``, ``code = clip(round(x /
    scale), -127, 127)`` with round half to even.  A short last block is
    zero-padded, which changes no absmax."""
    m, n = x.shape
    xb = _pad_cols(x.float(), block).reshape(m, -1, block)
    scale = _scale(xb.abs().amax(dim=-1, keepdim=True), 127.0)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(m, -1)[:, :n], scale[..., 0]


def act_dequant_ref(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16,
                    block: int = QBLOCK) -> torch.Tensor:
    """codes int8 (M, n), scales f32 (M, ceil(n / block)) -> (M, n) in
    ``dtype``: code * scale in f32, rounded once."""
    m, n = q.shape
    qb = _pad_cols(q, block).reshape(m, -1, block).float()
    return (qb * scale[..., None]).reshape(m, -1)[:, :n].to(dtype)


def act_quant4_ref(x: torch.Tensor, block: int = QBLOCK):
    """Blockwise symmetric int4 quantization, two codes packed per byte.

    The code range is the symmetric [-7, 7] (the -8 point is unused, so
    negation round-trips inside the code space and the scale is amax/7 on
    both sides); codes are stored biased by +8 into [1, 15] and packed
    little-nibble-first: byte j holds column 2j in its low nibble and
    column 2j+1 in its high nibble.  The zero-padded row is packed, so a
    short last block's padded bytes are 0x88.

    x: (M, n) -> (packed uint8 (M, ceil(n / block) * block / 2), scales
    f32 (M, ceil(n / block)))."""
    m, _ = x.shape
    xb = _pad_cols(x.float(), block).reshape(m, -1, block)
    scale = _scale(xb.abs().amax(dim=-1, keepdim=True), 7.0)
    q = torch.clamp(torch.round(xb / scale), -7, 7) + 8.0
    q = q.reshape(m, -1).to(torch.uint8)
    lo, hi = q[:, 0::2], q[:, 1::2]
    return lo | (hi << 4), scale[..., 0]


def act_dequant4_ref(packed: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16,
                     n: Optional[int] = None,
                     block: int = QBLOCK) -> torch.Tensor:
    """Inverse of :func:`act_quant4_ref`: unpack the nibbles (low nibble =
    even column), un-bias to [-7, 7] and rescale per block.  packed:
    (M, W) uint8; scale: (M, 2W / block) -> (M, n) in ``dtype``, n = 2W
    unless given."""
    m, half = packed.shape
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    q = torch.stack([lo, hi], dim=-1).reshape(m, -1, block).float()
    x = (q * scale[..., None]).reshape(m, 2 * half)
    return x[:, :2 * half if n is None else n].to(dtype)


def paged_decode_attn_ref(q: torch.Tensor, k_blocks: torch.Tensor,
                          v_blocks: torch.Tensor, tables: torch.Tensor,
                          pos: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, *,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          window: int = 0) -> torch.Tensor:
    """Single-query GQA attention over a paged KV pool.

    q: (slots, H, hd); k/v_blocks: (num_blocks, bs, kvh, hd) — ONE layer's
    pool slice (any block stride); tables: (slots, mb) int32 block ids;
    pos: (slots,) — the number of tokens already in the pool (pool columns
    < pos are valid); k_new/v_new: (slots, kvh, hd) — the current token's
    KV, folded in as an always-valid extra key (it has NOT been scattered
    into the pool yet).  Optional k/v_scale: (num_blocks, bs) f32 per-row
    int8 scales.  ``window`` keeps pool columns > pos - window (the new
    token is position ``pos``, so with window w the valid set is
    (pos-w, pos]).  Returns (slots, H, hd) in q.dtype."""
    slots, h, hd = q.shape
    _, bs, kvh, _ = k_blocks.shape
    mb = tables.shape[1]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    idx = tables.long()
    kf = k_blocks[idx].float().reshape(slots, mb * bs, kvh, hd)
    vf = v_blocks[idx].float().reshape(slots, mb * bs, kvh, hd)
    if k_scale is not None:
        kf = kf * k_scale[idx].reshape(slots, mb * bs, 1, 1)
        vf = vf * v_scale[idx].reshape(slots, mb * bs, 1, 1)
    cols = torch.arange(mb * bs, device=q.device)
    p = pos.long()[:, None]
    valid = cols[None, :] < p
    if window:
        valid &= cols[None, :] > p - window
    kf = torch.cat([kf, k_new.float()[:, None]], dim=1)
    vf = torch.cat([vf, v_new.float()[:, None]], dim=1)
    valid = torch.cat([valid, torch.ones((slots, 1), dtype=torch.bool,
                                         device=q.device)], dim=1)
    qg = q.float().reshape(slots, kvh, g, hd) * scale
    s = torch.einsum("bkgh,bskh->bkgs", qg, kf)
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    p_attn = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p_attn, vf)
    return out.reshape(slots, h, hd).to(q.dtype)


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": torch.nn.functional.silu,
            "gelu": lambda t: torch.nn.functional.gelu(
                t, approximate="tanh")}[name]


def fused_ffn_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, activation: str = "silu"
                  ) -> torch.Tensor:
    """Gated FFN ``(act(x @ w_gate) * (x @ w_up)) @ w_down``.

    x: (M, D); w_gate/w_up: (D, F); w_down: (F, D).  Computed in f32 (f64
    for f64 inputs) and rounded once to x's dtype; ``activation`` is silu
    or tanh-gelu."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    h = _act(activation)(xf @ w_gate.to(acc)) * (xf @ w_up.to(acc))
    return (h @ w_down.to(acc)).to(x.dtype)


def flash_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention with the flash kernel's masks.

    q: (B, H, Sq, hd); k, v: (B, H, Sk, hd), KV heads already broadcast
    to the query heads.  Keys are masked by ``causal`` (col <= row),
    ``window`` (col > row - window) and ``kv_len`` (col < kv_len); the
    first two only when Sq == Sk.  A query row with no valid key
    outputs exactly zero.  f32 inside (f64 for f64 inputs), out in q's
    dtype."""
    s, hd = q.shape[-2:]
    sk = k.shape[-2]
    if sk != s and (causal or window):
        raise ValueError(f"causal or window masks need as many keys as "
                         f"queries, got {sk} keys for {s} queries")
    scale = 1.0 / math.sqrt(hd)
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window:
        mask &= cols > rows - window
    if kv_len is not None:
        mask &= cols < kv_len
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1) * mask.any(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc))
    return out.to(q.dtype)


# ------------------------------------------------------------- ssd_scan ----
def segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{k=j+1..i}
    x[..., k], and -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return ss.masked_fill(~mask, float("-inf"))


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                 initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD (Mamba2's state-space duality), the plain version.

    x: (B, S, H, P) input (pre-discretization); dt: (B, S, H) positive
    step sizes (softplus applied by the caller); a: (H,) negative decay
    rates; b, c: (B, S, G, N) input/output projections, G groups
    broadcast to H.  A ragged S is padded to a whole chunk with dt = 0
    rows (decay exp(0) = 1 and zero input leave the carried state as it
    is, so the final state is exact).  Returns (y (B, S, H, P) in x's
    dtype, final state (B, H, P, N) f32).  The einsums materialise
    (B, S/chunk, H, chunk, chunk) f32 decays: a test oracle, not a
    serving path."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    chunk = min(chunk, s)
    if s % chunk:
        pad = chunk - s % chunk
        y, final = ssd_scan_ref(
            torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)),
            torch.nn.functional.pad(dt, (0, 0, 0, pad)), a,
            torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad)),
            torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad)),
            chunk=chunk, initial_state=initial_state)
        return y[:, :s], final
    nc = s // chunk
    rep = h // g

    xd = (x * dt[..., None]).float()                     # discretized input
    bh = b.repeat_interleave(rep, dim=2).float()         # (B, S, H, N)
    ch = c.repeat_interleave(rep, dim=2).float()
    xb = xd.reshape(bsz, nc, chunk, h, p)
    bb = bh.reshape(bsz, nc, chunk, h, n)
    cb = ch.reshape(bsz, nc, chunk, h, n)
    da = (dt.float() * a.float()).reshape(bsz, nc, chunk, h)
    da = da.movedim(-1, -2)                              # (B, nc, H, L)
    da_cs = torch.cumsum(da, dim=-1)

    # intra-chunk (diagonal blocks)
    decay = torch.exp(segsum(da))                        # (B, nc, H, L, L)
    y_diag = torch.einsum("bclhn,bcshn,bchls,bcshp->bclhp", cb, bb, decay,
                          xb)
    # chunk-final states
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)    # (B, nc, H, L)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", bb, decay_states, xb)
    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(da_cs[..., -1])              # (B, nc, H)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)               # (B, nc, H, P, N)
    # contribution of the carried state
    state_decay = torch.exp(da_cs)                       # (B, nc, H, L)
    y_off = torch.einsum("bclhn,bchpn,bchl->bclhp", cb, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), state


def ssd_scan_kernel_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, chunk: int):
    """Per-(batch·head) SSD in the kernel's layout: x (BH, S, P), dt
    (BH, S), a (BH,), b, c (BH, S, N).  Each row is its own sequence and
    head — the view B = 1, H = G = BH of :func:`ssd_scan_ref`.  Returns
    (y (BH, S, P) in x's dtype, final state (BH, P, N) f32)."""
    y, st = ssd_scan_ref(x.transpose(0, 1)[None], dt.transpose(0, 1)[None],
                         a, b.transpose(0, 1)[None], c.transpose(0, 1)[None],
                         chunk=chunk)
    return y[0].transpose(0, 1), st[0]
