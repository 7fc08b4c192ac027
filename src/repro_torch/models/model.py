"""Model API of the serving path: prefill, the dense and paged decode
steps, and burst admission (``forward`` and ``lm_loss``, the
full-sequence entry points, are re-exported from ``transformer``).

Ported from the JAX package for every family: dense and MoE attention
stacks, the SSM stack, the hybrid (Mamba blocks with one shared
attention block, whose K/V every site caches apart; an MoE decode step
runs the reference's dense dispatch, :func:`moe.moe_apply_decode`), the
encoder-decoder (the encoder runs once in ``prefill``, which caches
every decoder layer's cross K/V; each decode step attends over them)
and the VLM stub (projected patch embeddings in the first prompt
positions).  Caches are
dicts of tensors in the JAX package's layouts.  Where the JAX package
returns a new cache, pool or slot cache (and the serving engine donates
the old buffers), these functions update the tensors they are given in
place and return the same dicts: the pool, the dense KV and the SSM
state are the largest objects on the card and are never copied by a
step.  Every leaf a decode step writes, ``pos`` included, is written in
place, so the serving engine can capture a step as a CUDA graph and
replay it over the same buffers.  The layer walk is a Python loop where the JAX package scans, and the slot
axis of the batched steps is a batch dimension where the JAX package
``vmap``s a batch=1 step.

Sampling keys are ``int64`` tensors holding the two uint32 words of a
threefry key (see :mod:`repro_torch.models.prng`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import attention as attn_mod
from . import moe as moe_mod
from . import prng
from . import ssm as ssm_mod
from ..kernels import ops as kernel_ops
from ..kernels.act_quant import kv_dequant_rows, kv_quant_rows
from .configs import LOCAL, ModelConfig
from .layers import (Params, apply_rotary, cast_params, dtype_of,
                     embed_lookup, layer_slice, mask_padded_logits_raw,
                     matmul_w, ffn_apply, rms_norm, rotary_embedding,
                     unembed)
from .runtime import DEFAULT_OPTIONS, RuntimeOptions
from .transformer import (_pattern_period, _select_impl, _shared_site,
                          cross_block, embed_inputs, encode,
                          ffn_or_moe_block, forward, lm_loss)

Cache = Dict[str, Any]

__all__ = ["forward", "lm_loss", "init_cache", "prefill", "decode_step", "Cache",
           "init_slot_cache", "write_cache_slot", "admit_slot",
           "sample_logits", "sample_step", "sample_batched_step",
           "greedy_batched_step", "batched_prefill_admit",
           "init_paged_pool", "init_paged_slot_cache",
           "paged_sample_batched_step", "paged_kernel_sample_batched_step",
           "paged_prefill_admit", "paged_thaw_write", "paged_copy_block"]


def _n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.arch_type in ("ssm", "hybrid"):
        return 0
    return cfg.num_layers


def _n_shared_sites(cfg: ModelConfig) -> int:
    """Sites of a hybrid's shared attention block: one after each full
    period of Mamba blocks (zamba2: 38 // 6 = 6)."""
    if cfg.arch_type != "hybrid":
        return 0
    return cfg.num_layers // (cfg.shared_attn_period or cfg.num_layers)


def _cross_shape(cfg: ModelConfig, batch: int) -> Tuple[int, ...]:
    """An encoder-decoder's cross K/V leaf: ``(layers, batch, S_enc,
    kv_heads, head_dim)``."""
    return (cfg.num_layers, batch, cfg.encoder_seq_len, cfg.num_kv_heads,
            cfg.resolved_head_dim)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               opts: RuntimeOptions = DEFAULT_OPTIONS,
               device: str = "cuda") -> Cache:
    """A zeroed decode cache: ``pos``, attention ``k``/``v`` of shape
    ``(layers, batch, max_seq, kv_heads, head_dim)`` in
    ``kv_cache_dtype`` for attention stacks; for the SSM stack the f32
    ``ssm`` state ``(layers, batch, H, P, N)`` and the ``conv`` tail
    ``(layers, batch, W-1, conv_dim)`` in ``kv_cache_dtype``; a hybrid
    has both, plus the shared attention block's ``shared_k``/``shared_v``
    of shape ``(sites, batch, max_seq, kv_heads, head_dim)``; an
    encoder-decoder adds ``cross_k``/``cross_v`` of shape ``(layers,
    batch, encoder_seq_len, kv_heads, head_dim)``, zero until a prefill
    is given encoder frames."""
    kv_dt = dtype_of(opts.kv_cache_dtype)
    cache: Cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    n_attn = _n_attn_layers(cfg)
    if n_attn:
        shape = (n_attn, batch, max_seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=kv_dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=kv_dt, device=device)
    if cfg.arch_type in ("ssm", "hybrid"):
        st, cv = ssm_mod.mamba_state_shapes(cfg, batch)
        cache["ssm"] = torch.zeros((cfg.num_layers,) + st,
                                   dtype=torch.float32, device=device)
        cache["conv"] = torch.zeros((cfg.num_layers,) + cv, dtype=kv_dt,
                                    device=device)
    sites = _n_shared_sites(cfg)
    if sites:
        shape = (sites, batch, max_seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache["shared_k"] = torch.zeros(shape, dtype=kv_dt, device=device)
        cache["shared_v"] = torch.zeros(shape, dtype=kv_dt, device=device)
    if cfg.is_encoder_decoder:
        shape = _cross_shape(cfg, batch)
        cache["cross_k"] = torch.zeros(shape, dtype=kv_dt, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=kv_dt, device=device)
    return cache


# ====================================================== slot-stacked cache ==
# The serving engine holds ONE cache for all of its decode slots: every
# leaf of a batch=1 cache gains a leading ``(slots,)`` axis, ``pos``
# included (each slot sits at its own position).  The batched steps view
# that cache as one batch of ``slots`` sequences.

def init_slot_cache(cfg: ModelConfig, slots: int, max_seq: int,
                    opts: RuntimeOptions = DEFAULT_OPTIONS,
                    device: str = "cuda") -> Cache:
    """A zeroed slot-stacked cache: ``init_cache(cfg, 1, ...)`` leaves with
    a leading ``(slots,)`` axis, plus a ``"sample"`` dict holding each
    slot's sampling state (threefry key, temperature, top-k).  The zero
    init is greedy (temperature 0)."""
    one = init_cache(cfg, 1, max_seq, opts, device)
    stacked = {k: torch.zeros((slots,) + tuple(a.shape), dtype=a.dtype,
                              device=device) for k, a in one.items()}
    stacked["sample"] = _sample_state(slots, device)
    return stacked


def _sample_state(slots: int, device) -> Cache:
    return {"key": torch.zeros((slots, 2), dtype=torch.int64, device=device),
            "temp": torch.zeros((slots,), dtype=torch.float32, device=device),
            "top_k": torch.zeros((slots,), dtype=torch.int32, device=device)}


def _put(arr: torch.Tensor, slot, val) -> None:
    """``arr[slot] = val`` in place; ``slot`` may be an int or a
    one-element tensor already on the device (no host sync)."""
    idx = torch.as_tensor(slot, device=arr.device).reshape(1).long()
    val = torch.as_tensor(val, device=arr.device).to(arr.dtype)
    arr.index_copy_(0, idx, val.reshape((1,) + tuple(arr.shape[1:])))


def write_cache_slot(stacked: Cache, cache: Cache, slot) -> Cache:
    """Write a batch=1 cache (e.g. a fresh prefill) into slot ``slot`` of
    a slot-stacked cache, in place, leaf by leaf (every leaf of
    ``cache`` must have its slot's shape)."""
    for name, leaf in cache.items():
        _put(stacked[name], slot, leaf)
    return stacked


def admit_slot(stacked: Cache, cache: Cache, slot, key: torch.Tensor,
               temp, top_k) -> Cache:
    """Write a batch=1 *model* cache plus its slot sampling state
    (``key (2,)``, ``temp ()``, ``top_k ()``) into slot ``slot`` of a
    slot-stacked serving cache, in place."""
    write_cache_slot(stacked, cache, slot)
    s = stacked["sample"]
    _put(s["key"], slot, key)
    _put(s["temp"], slot, temp)
    _put(s["top_k"], slot, top_k)
    return stacked


def _slot_view(stacked: Cache) -> Cache:
    """The slot-stacked cache seen as one model cache of batch ``slots``:
    each ``(slots, layers, 1, ...)`` leaf as a ``(layers, slots, ...)``
    view (writes land in the stacked tensors), ``pos`` per slot."""
    view = {"pos": stacked["pos"]}
    for name, leaf in stacked.items():
        if name not in ("pos", "sample"):
            view[name] = leaf[:, :, 0].transpose(0, 1)
    return view


# ================================================================ sampling ==
def sample_logits(logits: torch.Tensor, key: torch.Tensor,
                  temp: torch.Tensor, top_k: torch.Tensor, vocab: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw the next token from (vocab-padded) logits rows.

    Batched over leading axes: logits (..., V), key (..., 2), temp and
    top_k (...).  ``temp == 0`` reduces exactly to the greedy argmax;
    ``top_k == 0`` samples the full vocabulary, ``top_k == 1`` keeps only
    the argmax.  The key is split on every call, sampled or not, so a
    stream depends only on the initial key and the emission index.
    Returns ``(token, advanced key)``."""
    lg = logits[..., :vocab]
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    keys = prng.split(key)
    key, sub = keys[..., 0, :], keys[..., 1, :]
    scaled = lg.float() / torch.clamp(temp.float(), min=1e-6)[..., None]
    # top-k by stable descending rank (ties keep the lowest index, like
    # argmax) so top_k==1 is exactly greedy even on tied logits;
    # top_k<=0 keeps the whole vocabulary
    order = torch.argsort(-scaled, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(vocab, device=lg.device).expand_as(order))
    kk = torch.clamp(top_k, 1, vocab)[..., None]
    drop = (top_k > 0)[..., None] & (ranks >= kk)
    masked = scaled.masked_fill(drop, torch.finfo(torch.float32).min)
    sampled = prng.categorical(sub, masked).to(torch.int32)
    return torch.where(temp > 0, sampled, greedy), key


# ================================================================ prefill ==
def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Cache, opts: RuntimeOptions = DEFAULT_OPTIONS, *,
            encoder_frames: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Process a prompt, filling the cache.  Returns (logits, cache).

    One walk over the stacked layers computes the activations and
    captures each layer's cache entries: rotated K and V (padded to the
    cache's ``max_seq``) for attention stacks, the final SSM state and
    the conv tail for the SSM stack, and for a hybrid also the shared
    attention block's rotated K and V at each of its sites.  Left-padding
    tokens run through the conv and the scan like any other token, as in
    the JAX package.

    An encoder-decoder given ``encoder_frames`` (B, S_enc, D) runs the
    encoder first; each decoder layer then attends over its output and
    the cache's ``cross_k``/``cross_v`` take every layer's cross K/V
    (as the JAX package, only the layers of whole pattern periods: a
    leftover layer writes none).  Without frames (as the serving engine
    calls it) no cross block runs and the cross leaves stay as they are.
    A VLM's ``vision_embeds`` replace the first prompt positions
    (:func:`transformer.embed_inputs`)."""
    act_dt = dtype_of(cfg.activation_dtype)
    params = cast_params(params, act_dt)
    x = embed_inputs(params, cfg, tokens, vision_embeds)
    s = x.shape[1]
    kv_dt = dtype_of(opts.kv_cache_dtype)
    kinds, _ = _pattern_period(cfg)
    new_cache = dict(cache)
    if cfg.arch_type in ("ssm", "hybrid"):
        shared = params.get("shared_attn")
        sts, cvs, sks, svs = [], [], [], []
        for j in range(cfg.num_layers):
            layer = layer_slice(params["layers"], j)
            y, st, cv = ssm_mod.mamba_forward_states(
                layer["mamba"], rms_norm(x, layer["ln"], cfg.norm_eps), cfg)
            x = x + y.to(x.dtype)
            sts.append(st)
            cvs.append(cv.to(kv_dt))
            if shared is not None and _shared_site(cfg, j) >= 0:
                x, kk, vv, _ = _attn_prefill_kv(shared, x, cfg, opts)
                sks.append(kk.to(kv_dt))
                svs.append(vv.to(kv_dt))
        new_cache["ssm"] = torch.stack(sts)
        new_cache["conv"] = torch.stack(cvs)
        if sks:
            pad = (0, 0, 0, 0, 0, cache["shared_k"].shape[2] - s)
            new_cache["shared_k"] = F.pad(torch.stack(sks), pad)
            new_cache["shared_v"] = F.pad(torch.stack(svs), pad)
    else:
        cross_src = None
        if cfg.is_encoder_decoder and encoder_frames is not None:
            cross_src = encode(params, cfg, encoder_frames, opts)
        n_full = cfg.num_layers // len(kinds) * len(kinds)
        max_seq = cache["k"].shape[2]
        ks, vs, cks, cvs = [], [], [], []
        for j in range(cfg.num_layers):
            layer = layer_slice(params["layers"], j)
            w = cfg.sliding_window if kinds[j % len(kinds)] == LOCAL else 0
            x, kk, vv, ckv = _attn_prefill_kv(layer, x, cfg, opts, window=w,
                                              cross_src=cross_src)
            ks.append(kk.to(kv_dt))
            vs.append(vv.to(kv_dt))
            if ckv is not None and j < n_full:
                cks.append(ckv[0].to(kv_dt))
                cvs.append(ckv[1].to(kv_dt))
        pad = (0, 0, 0, 0, 0, max_seq - s)
        new_cache["k"] = F.pad(torch.stack(ks), pad)
        new_cache["v"] = F.pad(torch.stack(vs), pad)
        if cks:
            new_cache["cross_k"] = torch.stack(cks)
            new_cache["cross_v"] = torch.stack(cvs)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = mask_padded_logits_raw(unembed(params["embed"], x),
                                    cfg.vocab_size)
    new_cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return logits, new_cache


def _attn_prefill_kv(layer, x, cfg, opts, window: int = 0, cross_src=None):
    """Run a transformer block, returning (x, K, V, cross K/V) of its
    attention: the self-attention's K (rotated, as the cache stores it)
    and V, and with ``cross_src`` the cross block's ``(K, V)`` (else
    ``None``)."""
    y, k_rot, v = attn_mod.self_attention(
        layer["attn"], rms_norm(x, layer["ln1"], cfg.norm_eps),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=True, window=window,
        impl=_select_impl(cfg, opts, x.shape[1], window),
        q_chunk=opts.q_chunk, k_chunk=opts.k_chunk)
    x = x + y.to(x.dtype)
    cross_kv = None
    if cross_src is not None and "cross" in layer:
        x, ck, cv = cross_block(layer, x, cross_src, cfg)
        cross_kv = (ck, cv)
    x, _ = ffn_or_moe_block(layer, x, cfg, opts)
    return x, k_rot, v, cross_kv


# =========================================================== decode blocks ==
def _apply_rot1(x: torch.Tensor, sin, cos) -> torch.Tensor:
    """x: (B, H, hd) one-token rotary."""
    return apply_rotary(x[:, None], sin, cos)[:, 0]


def _decode_qkv(layer: Params, x: torch.Tensor, sin, cos, cfg: ModelConfig):
    """The one-token attention projections: q (B, H, hd) and k, v
    (B, kvh, hd), q and k rotated by each row's ``sin``/``cos``."""
    b, _ = x.shape
    hd = cfg.resolved_head_dim
    h = rms_norm(x, layer["ln1"], cfg.norm_eps)
    a = layer["attn"]
    q = matmul_w(h, a["wq"]).reshape(b, cfg.num_heads, hd)
    k = matmul_w(h, a["wk"]).reshape(b, cfg.num_kv_heads, hd)
    v = matmul_w(h, a["wv"]).reshape(b, cfg.num_kv_heads, hd)
    if "bq" in a:
        q = q + a["bq"].reshape(cfg.num_heads, hd)
        k = k + a["bk"].reshape(cfg.num_kv_heads, hd)
        v = v + a["bv"].reshape(cfg.num_kv_heads, hd)
    return _apply_rot1(q, sin, cos), _apply_rot1(k, sin, cos), v


def _cross_decode(layer: Params, x: torch.Tensor, cross_kv,
                  cfg: ModelConfig) -> torch.Tensor:
    """One-token cross-attention block over a layer's cached cross K/V
    (B, S_enc, kvh, hd): every encoder frame is attended, through the
    plain :func:`attention.decode_attention` at position ``S_enc - 1``,
    as the JAX package computes it (outside any kernel), the cache read
    in the activation dtype."""
    b, _ = x.shape
    c = layer["cross"]
    hq = rms_norm(x, layer["ln_cross"], cfg.norm_eps)
    qc = matmul_w(hq, c["wq"]).reshape(b, cfg.num_heads,
                                       cfg.resolved_head_dim)
    ck, cv = cross_kv
    last = torch.full((), ck.shape[1] - 1, dtype=torch.int64,
                      device=x.device)
    out = attn_mod.decode_attention(qc, ck.to(x.dtype), cv.to(x.dtype),
                                    last, window=0)
    return x + matmul_w(out.reshape(b, -1), c["wo"]).to(x.dtype)


def _decode_out(layer: Params, x: torch.Tensor, out: torch.Tensor,
                cfg: ModelConfig, cross_kv=None) -> torch.Tensor:
    """Output projection of the attention ``out`` (B, H, hd), the
    cross-attention block when ``cross_kv`` is given, then the FFN block
    (an MoE block by dense dispatch)."""
    b, _ = x.shape
    x = x + matmul_w(out.reshape(b, -1), layer["attn"]["wo"]).to(x.dtype)
    if cross_kv is not None and "cross" in layer:
        x = _cross_decode(layer, x, cross_kv, cfg)
    h2 = rms_norm(x, layer["ln2"], cfg.norm_eps)
    if cfg.arch_type == "moe":
        y = moe_mod.moe_apply_decode(layer["moe"], h2, cfg)
    else:
        y = ffn_apply(layer["ffn"], h2, gated=cfg.gated_ffn,
                      activation=cfg.activation)
    return x + y.to(x.dtype)


def _attn_decode(layer: Params, x: torch.Tensor, k_cache, v_cache, pos,
                 sin, cos, cfg: ModelConfig, opts: RuntimeOptions, *,
                 window: int, cross_kv=None) -> torch.Tensor:
    """One-token attention block over a dense cache.  x: (B, D);
    ``k_cache``/``v_cache``: one layer's (B, max_seq, kvh, hd), written
    in place at each row's ``pos`` (B,); ``cross_kv``: an
    encoder-decoder layer's cached cross K/V."""
    q, k, v = _decode_qkv(layer, x, sin, cos, cfg)
    attn_mod.update_kv_cache(k_cache, v_cache, k, v, pos)
    out = attn_mod.decode_attention(q, k_cache, v_cache, pos,
                                    window=window or opts.decode_window)
    return _decode_out(layer, x, out, cfg, cross_kv)


def _mamba_decode(layer: Params, x: torch.Tensor, ssm_state, conv_state,
                  cfg: ModelConfig):
    """One Mamba block step; ``ssm_state`` and ``conv_state`` (one layer
    of the cache) are updated in place."""
    h = rms_norm(x, layer["ln"], cfg.norm_eps)
    y, _, _ = ssm_mod.mamba_step(layer["mamba"], h, ssm_state, conv_state,
                                 cfg)
    return x + y.to(x.dtype)


# ================================================================= decode ==
def decode_step(params: Params, cfg: ModelConfig, cache: Cache,
                token: torch.Tensor, opts: RuntimeOptions = DEFAULT_OPTIONS
                ) -> Tuple[torch.Tensor, Cache]:
    """Logits for ONE new token per sequence.

    token: (B,) int32; the cache's leaves are ``(layers, B, ...)`` and
    ``pos`` is a scalar or one position per row.  The KV rows and the
    SSM/conv state are written in place.  Returns ``(logits (B,
    padded vocab), cache)`` with ``pos`` advanced by one, in place.

    The KV write row and the attention length (a hybrid's shared K/V
    rows too) are clamped to ``max_seq - 1``, as the JAX package's
    ``dynamic_update_slice`` clamps them: a prompt whose bucket equals
    ``max_seq`` decodes once at ``pos == max_seq`` and its new token
    replaces the last cached key, and free slots of the engine, whose
    ``pos`` keeps rising, stay in range.  An encoder-decoder's layers
    attend over the cache's ``cross_k``/``cross_v`` (zero when the
    prefill had no frames, and then each cross block adds exactly 0)."""
    act_dt = dtype_of(cfg.activation_dtype)
    params = cast_params(params, act_dt)
    x = embed_lookup(params["embed"], token).to(act_dt)      # (B, D)
    pos = cache["pos"]
    if cfg.arch_type in ("ssm", "hybrid"):
        shared = params.get("shared_attn")
        if shared is not None:
            # one rotary phase and one clamped row for every site
            rows = pos.expand(x.shape[0]) if pos.dim() == 0 else pos
            sin, cos = rotary_embedding(rows[:, None], cfg.resolved_head_dim,
                                        cfg.rope_theta)
            att_pos = torch.clamp(rows, max=cache["shared_k"].shape[2] - 1)
        for j in range(cfg.num_layers):
            layer = layer_slice(params["layers"], j)
            x = _mamba_decode(layer, x, cache["ssm"][j], cache["conv"][j],
                              cfg)
            site = _shared_site(cfg, j)
            if shared is not None and site >= 0:
                x = _attn_decode(shared, x, cache["shared_k"][site],
                                 cache["shared_v"][site], att_pos, sin, cos,
                                 cfg, opts, window=0)
    else:
        rows = pos.expand(x.shape[0]) if pos.dim() == 0 else pos
        sin, cos = rotary_embedding(rows[:, None], cfg.resolved_head_dim,
                                    cfg.rope_theta)
        att_pos = torch.clamp(rows, max=cache["k"].shape[2] - 1)
        kinds, _ = _pattern_period(cfg)
        for j in range(cfg.num_layers):
            layer = layer_slice(params["layers"], j)
            w = cfg.sliding_window if kinds[j % len(kinds)] == LOCAL else 0
            ckv = ((cache["cross_k"][j], cache["cross_v"][j])
                   if cfg.is_encoder_decoder else None)
            x = _attn_decode(layer, x, cache["k"][j], cache["v"][j],
                             att_pos, sin, cos, cfg, opts, window=w,
                             cross_kv=ckv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = mask_padded_logits_raw(unembed(params["embed"], x),
                                    cfg.vocab_size)
    pos.add_(1)
    return logits, cache


def sample_step(params: Params, cfg: ModelConfig, cache: Cache,
                token: torch.Tensor, opts: RuntimeOptions = DEFAULT_OPTIONS
                ) -> Tuple[torch.Tensor, Cache]:
    """One sampling decode step for a single sequence: ``token`` is a
    ``()`` int32 scalar; ``cache`` a batch=1 cache carrying a
    ``"sample"`` dict ``{key (2,), temp (), top_k ()}``.  Returns
    ``(next token, cache)`` with the key advanced."""
    logits, cache = decode_step(params, cfg, cache, token[None], opts)
    s = cache["sample"]
    nxt, key = sample_logits(logits[0], s["key"], s["temp"], s["top_k"],
                             cfg.vocab_size)
    s["key"] = key
    return nxt, cache


def sample_batched_step(params: Params, cfg: ModelConfig, cache: Cache,
                        tokens: torch.Tensor,
                        opts: RuntimeOptions = DEFAULT_OPTIONS):
    """One sampling decode step over a slot-stacked cache: the batch=1
    step of every slot at once, the slot axis as the batch (the JAX
    package ``vmap``s :func:`sample_step`).  Per-slot temperature, top-k
    and key come from ``cache["sample"]``; a slot at temperature 0 takes
    exactly the argmax.  Free slots are decoded too and their outputs
    ignored.  The cache is updated in place.  Returns ``(next tokens
    (slots,), positions (slots,), cache)``."""
    logits, _ = decode_step(params, cfg, _slot_view(cache), tokens, opts)
    s = cache["sample"]
    nxt, keys = sample_logits(logits, s["key"], s["temp"], s["top_k"],
                              cfg.vocab_size)
    s["key"].copy_(keys)
    return nxt, cache["pos"], cache


def greedy_batched_step(params: Params, cfg: ModelConfig, cache: Cache,
                        tokens: torch.Tensor,
                        opts: RuntimeOptions = DEFAULT_OPTIONS):
    """One greedy decode step over a slot-stacked cache: the argmax of
    every slot, with no sampling work (keys are left as they are).
    Returns ``(next tokens (slots,), positions (slots,), cache)``."""
    logits, _ = decode_step(params, cfg, _slot_view(cache), tokens, opts)
    nxt = torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
    return nxt, cache["pos"], cache


# ===================================================== batched admission ====
def batched_prefill_admit(params: Params, cfg: ModelConfig, stacked: Cache,
                          tokens: torch.Tensor, slot_ids: torch.Tensor,
                          keys: torch.Tensor, temps: torch.Tensor,
                          top_ks: torch.Tensor, opts: RuntimeOptions,
                          max_seq: int):
    """Prefill ``k`` left-padded same-bucket prompts in ONE call and write
    each row's cache, sampling state and first sampled token into its
    decode slot of the slot-stacked cache (in place).

    ``tokens`` is ``(k, bucket)`` int32; ``slot_ids``/``keys``/``temps``/
    ``top_ks`` are per row.  Rows are written in order, so a burst padded
    up to a k-bucket by *prepended* rows aimed at the first real row's
    slot is overwritten by that row.  The scratch cache is sized to the
    bucket; each row's KV is zero-padded to ``max_seq`` when it is
    written.  Returns ``((k,) first tokens, stacked cache)``."""
    k, bucket = tokens.shape
    cache = init_cache(cfg, k, min(bucket, max_seq), opts,
                       device=tokens.device)
    logits, cache = prefill(params, cfg, tokens, cache, opts)
    first, new_keys = sample_logits(logits[:, -1], keys, temps, top_ks,
                                    cfg.vocab_size)
    for i in range(k):
        admit_slot(stacked, _burst_row(cache, i, stacked), slot_ids[i],
                   new_keys[i], temps[i], top_ks[i])
    return first, stacked


def _burst_row(cache: Cache, i: int, stacked: Cache) -> Cache:
    """Row ``i`` of a burst prefill's cache as one slot's batch=1 cache:
    batch lives at axis 1 of every leaf but the scalar ``pos``, and each
    leaf is zero-padded to the slot's shape in ``stacked`` (a bucket-long
    KV to ``max_seq``)."""
    row = {}
    for name, a in cache.items():
        if a.dim() == 0:
            row[name] = a
            continue
        r = a[:, i:i + 1]
        want = stacked[name].shape[1:]
        pad = []
        for have, full in zip(reversed(r.shape), reversed(want)):
            pad += [0, full - have]
        row[name] = F.pad(r, pad) if any(pad) else r
    return row


# ============================================================ paged cache ==
# Block-paged KV: self-attention K/V live in a pool of fixed-size blocks
# shared by every slot; each slot's host-side block table — a
# (slots, max_seq // block_size) int32 array of pool indices — rides into
# the step as runtime data.  The paged step reads KV through the tables
# with the paged decode kernel.

def init_paged_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
                    opts: RuntimeOptions = DEFAULT_OPTIONS,
                    device: str = "cuda") -> Cache:
    """The device block pool: ``{"k","v"}`` of shape ``(num_blocks,
    n_attn_layers, block_size, num_kv_heads, head_dim)``.  Block 0 is the
    trash block.  ``opts.kv_dtype == "int8"`` stores the blocks int8 and
    adds ``{"k_scale","v_scale"}`` of shape ``(num_blocks, n_attn,
    block_size)`` — one f32 scale per KV row."""
    n_attn = _n_attn_layers(cfg)
    if not n_attn:
        raise ValueError("paged decode requires an attention stack "
                         f"(arch_type={cfg.arch_type!r} has no KV cache)")
    if opts.kv_dtype not in ("auto", "int8"):
        raise ValueError(f"kv_dtype={opts.kv_dtype!r} (want 'auto' or 'int8')")
    store_int8 = opts.kv_dtype == "int8"
    kv_dt = torch.int8 if store_int8 else dtype_of(opts.kv_cache_dtype)
    shape = (num_blocks, n_attn, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    pool = {"k": torch.zeros(shape, dtype=kv_dt, device=device),
            "v": torch.zeros(shape, dtype=kv_dt, device=device)}
    if store_int8:
        sshape = (num_blocks, n_attn, block_size)
        pool["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
        pool["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
    return pool


def init_paged_slot_cache(cfg: ModelConfig, slots: int, max_seq: int,
                          opts: RuntimeOptions = DEFAULT_OPTIONS,
                          device: str = "cuda") -> Cache:
    """A slot-stacked serving cache *without* the dense ``k``/``v`` leaves
    (those live in the block pool): ``pos``, the ``"sample"`` dict and,
    for an encoder-decoder, the per-slot ``cross_k``/``cross_v`` of shape
    ``(slots, layers, 1, encoder_seq_len, kv_heads, head_dim)``."""
    cache = {"pos": torch.zeros((slots,), dtype=torch.int32, device=device),
             "sample": _sample_state(slots, device)}
    if cfg.is_encoder_decoder:
        shape = (slots,) + _cross_shape(cfg, 1)
        kv_dt = dtype_of(opts.kv_cache_dtype)
        cache["cross_k"] = torch.zeros(shape, dtype=kv_dt, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=kv_dt, device=device)
    return cache


def _scatter_kv_rows(pool: Cache, rk: torch.Tensor, rv: torch.Tensor,
                     blks: torch.Tensor, offs: torch.Tensor) -> Cache:
    """Write one KV row per slot into its tail block, in place.
    ``rk``/``rv``: ``(slots, n_attn, kvh, hd)``; ``blks``/``offs``:
    ``(slots,)``.  Quantizes the rows first when the pool stores int8."""
    blks, offs = blks.long(), offs.long()
    if "k_scale" in pool:
        rk, sk = kv_quant_rows(rk)
        rv, sv = kv_quant_rows(rv)
        pool["k_scale"][blks, :, offs] = sk
        pool["v_scale"][blks, :, offs] = sv
    pool["k"][blks, :, offs] = rk.to(pool["k"].dtype)
    pool["v"][blks, :, offs] = rv.to(pool["v"].dtype)
    return pool


def paged_sample_batched_step(params: Params, cfg: ModelConfig,
                              slot_cache: Cache, pool: Cache,
                              tokens: torch.Tensor, tables: torch.Tensor,
                              opts: RuntimeOptions = DEFAULT_OPTIONS):
    """One sampling decode step over paged KV, gathering to dense first.

    ``tables`` is ``(slots, max_seq // block_size)`` int32.  Every slot's
    blocks are gathered into a dense ``(n_attn, slots, max_seq, kvh, hd)``
    view in ``kv_cache_dtype`` (int8 pools dequantize per row while
    gathering), the dense step — :func:`decode_step` and
    :func:`sample_logits` — runs over it, and the row it wrote is sliced
    back out and scattered into each slot's tail block (int8 pools
    re-quantize it).  The JAX package ``vmap``s the same per-slot gather
    and ``sample_step``; here the slot axis is the batch.  The write row
    is clamped to ``max_seq - 1`` as the dense step clamps it, so masked
    slots (whose tables point at the trash block) stay in range.
    ``slot_cache`` and ``pool`` are updated in place.  Returns
    ``(next_tokens, positions, slot_cache, pool)``."""
    _, n_attn, bs, kvh, hd = pool["k"].shape
    slots, mb = tables.shape
    kv_dt = dtype_of(opts.kv_cache_dtype)
    idx = tables.long()

    def dense_view(name):
        g = pool[name][idx]                 # (slots, mb, n_attn, bs, kvh, hd)
        if name + "_scale" in pool:
            g = kv_dequant_rows(g, pool[name + "_scale"][idx], kv_dt)
        return g.to(kv_dt).permute(2, 0, 1, 3, 4, 5).reshape(
            n_attn, slots, mb * bs, kvh, hd)

    pos = slot_cache["pos"]
    att_pos = torch.clamp(pos, max=mb * bs - 1).long()
    dense = _slot_view(slot_cache)
    dense["k"], dense["v"] = dense_view("k"), dense_view("v")
    logits, _ = decode_step(params, cfg, dense, tokens, opts)
    s = slot_cache["sample"]
    nxt, new_keys = sample_logits(logits, s["key"], s["temp"], s["top_k"],
                                  cfg.vocab_size)
    s["key"].copy_(new_keys)
    rows = torch.arange(slots, device=pos.device)
    rk = dense["k"][:, rows, att_pos].transpose(0, 1)   # (slots, n_attn, ..)
    rv = dense["v"][:, rows, att_pos].transpose(0, 1)
    blks = tables.gather(1, (att_pos // bs)[:, None])[:, 0]
    _scatter_kv_rows(pool, rk, rv, blks, att_pos % bs)
    return nxt, pos, slot_cache, pool


def _attn_decode_paged(layer: Params, x: torch.Tensor, kb, vb, ks, vs,
                       tables, pos, sin, cos, cfg: ModelConfig,
                       opts: RuntimeOptions, *, window: int, cross_kv=None):
    """One-token attention block reading KV straight off the block table.

    x is ``(slots, D)``, ``kb``/``vb`` are ONE layer's pool blocks
    ``(num_blocks, bs, kvh, hd)`` viewed in place (``ks``/``vs`` the
    matching int8 scales or ``None``), ``pos`` is per-slot.  Attention
    runs through :func:`kernel_ops.paged_attention`; the new token's KV
    is *returned* — ``(slots, kvh, hd)`` each — for one batched scatter
    at the end of the step.  ``cross_kv``: an encoder-decoder layer's
    per-slot cross K/V ``(slots, S_enc, kvh, hd)``."""
    q, k, v = _decode_qkv(layer, x, sin, cos, cfg)
    w = window or opts.decode_window
    out = kernel_ops.paged_attention(q, kb, vb, tables, pos, k,
                                     v.contiguous(), ks, vs, window=w)
    return _decode_out(layer, x, out, cfg, cross_kv), k, v


def paged_kernel_sample_batched_step(params: Params, cfg: ModelConfig,
                                     slot_cache: Cache, pool: Cache,
                                     tokens: torch.Tensor,
                                     tables: torch.Tensor,
                                     opts: RuntimeOptions = DEFAULT_OPTIONS):
    """One sampling decode step over paged KV, attention through the
    block tables.

    Slot-batched: q/k/v projections, FFN and sampling run at batch =
    slots with per-slot rotary phases; every layer's attention reads its
    pool blocks in place through :func:`kernel_ops.paged_attention`.  One
    batched scatter then writes each slot's new KV row into its tail
    block.  ``slot_cache`` and ``pool`` are updated in place.  Returns
    ``(next_tokens, positions, slot_cache, pool)``.

    The write row and the attention length are clamped to ``max_seq - 1``
    (``max_seq = mb * block_size``): a prompt whose bucket equals
    ``max_seq`` decodes once at ``pos == max_seq``, and the JAX package's
    dense path clamps that write onto the last row, so the new token
    replaces the last cached key.  Masked slots, whose ``pos`` keeps
    growing, stay in range the same way."""
    act_dt = dtype_of(cfg.activation_dtype)
    params = cast_params(params, act_dt)
    x = embed_lookup(params["embed"], tokens).to(act_dt)  # (slots, D)
    pos = slot_cache["pos"]                                # (slots,)
    pk, pv = pool["k"], pool["v"]
    _, n_attn, bs, _, hd = pk.shape
    max_seq = tables.shape[1] * bs
    att_pos = torch.clamp(pos, max=max_seq - 1)
    sin, cos = rotary_embedding(pos[:, None], hd, cfg.rope_theta)
    tables = tables.to(torch.int32)
    kinds, _ = _pattern_period(cfg)
    scales = "k_scale" in pool
    rows_k, rows_v = [], []
    for j in range(cfg.num_layers):
        layer = layer_slice(params["layers"], j)
        w = cfg.sliding_window if kinds[j % len(kinds)] == LOCAL else 0
        # an encoder-decoder's cross K/V ride in the slot cache,
        # (slots, layers, 1, S_enc, kvh, hd), read layer by layer
        ckv = ((slot_cache["cross_k"][:, j, 0],
                slot_cache["cross_v"][:, j, 0])
               if cfg.is_encoder_decoder else None)
        x, k1, v1 = _attn_decode_paged(
            layer, x, pk[:, j], pv[:, j],
            pool["k_scale"][:, j] if scales else None,
            pool["v_scale"][:, j] if scales else None,
            tables, att_pos, sin, cos, cfg, opts, window=w, cross_kv=ckv)
        rows_k.append(k1)
        rows_v.append(v1)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = mask_padded_logits_raw(unembed(params["embed"], x),
                                    cfg.vocab_size)
    s = slot_cache["sample"]
    nxt, new_keys = sample_logits(logits, s["key"], s["temp"], s["top_k"],
                                  cfg.vocab_size)
    s["key"].copy_(new_keys)
    pos.add_(1)

    blks = tables.gather(1, (att_pos // bs).long()[:, None])[:, 0]
    _scatter_kv_rows(pool, torch.stack(rows_k, 1), torch.stack(rows_v, 1),
                     blks, att_pos % bs)
    return nxt, slot_cache["pos"], slot_cache, pool


def paged_prefill_admit(params: Params, cfg: ModelConfig, slot_cache: Cache,
                        pool: Cache, tokens: torch.Tensor,
                        slot_ids: torch.Tensor, keys: torch.Tensor,
                        temps: torch.Tensor, top_ks: torch.Tensor,
                        dest_blocks: torch.Tensor, opts: RuntimeOptions):
    """Burst admission into the paged cache: prefill ``(k, bucket)``
    left-padded prompts in ONE call, write each row's KV into its
    destination pool blocks and its other leaves (``pos``, an
    encoder-decoder's cross K/V) + sampling state into its slot (both in
    place).  ``dest_blocks`` is ``(k, bucket // block_size)``
    int32 — padding rows target the trash block.  Rows are written in
    order, so a padding row aimed at a real row's slot is overwritten by
    it.  Returns ``((k,) first tokens, (k, vocab) last-position logits,
    slot cache, pool)``."""
    k, bucket = tokens.shape
    _, n_attn, bs, kvh, hd = pool["k"].shape
    nblk = bucket // bs
    cache = init_cache(cfg, k, bucket, opts, device=tokens.device)
    logits, cache = prefill(params, cfg, tokens, cache, opts)
    last = logits[:, -1]
    first, new_keys = sample_logits(last, keys, temps, top_ks,
                                    cfg.vocab_size)

    def blockify(a):                     # (n_attn, k, bucket, kvh, hd)
        a = a.transpose(0, 1).reshape(k, n_attn, nblk, bs, kvh, hd)
        return a.transpose(1, 2).reshape(k * nblk, n_attn, bs, kvh, hd)

    flat = dest_blocks.reshape(-1).long()
    bk, bv = blockify(cache["k"]), blockify(cache["v"])
    if "k_scale" in pool:                # quantize at append time
        bk, sk = kv_quant_rows(bk)
        bv, sv = kv_quant_rows(bv)
        pool["k_scale"][flat] = sk
        pool["v_scale"][flat] = sv
    pool["k"][flat] = bk.to(pool["k"].dtype)
    pool["v"][flat] = bv.to(pool["v"].dtype)
    rows = {name: a for name, a in cache.items() if name not in ("k", "v")}
    for i in range(k):
        admit_slot(slot_cache, _burst_row(rows, i, slot_cache), slot_ids[i],
                   new_keys[i], temps[i], top_ks[i])
    return first, last, slot_cache, pool


def paged_thaw_write(pool: Cache, rows_k: torch.Tensor, rows_v: torch.Tensor,
                     ids: torch.Tensor) -> Cache:
    """Scatter a thawed request's densified KV back into pool blocks, in
    place.  ``rows_k``/``rows_v``: ``(nblk, n_attn, block_size, kvh,
    hd)``; ``ids``: ``(nblk,)`` freshly allocated (private) block ids,
    trailing ones aimed at the trash block.  Blobs hold KV in
    ``kv_cache_dtype``, so an int8 pool re-quantizes on thaw."""
    ids = ids.long()
    if "k_scale" in pool:
        rows_k, sk = kv_quant_rows(rows_k)
        rows_v, sv = kv_quant_rows(rows_v)
        pool["k_scale"][ids] = sk
        pool["v_scale"][ids] = sv
    pool["k"][ids] = rows_k.to(pool["k"].dtype)
    pool["v"][ids] = rows_v.to(pool["v"].dtype)
    return pool


def paged_copy_block(pool: Cache, src, dst) -> Cache:
    """Copy-on-write: duplicate block ``src`` into ``dst`` in place (both
    may be tensors).  Generic over the pool's leaves, so int8 scale
    planes ride along with their blocks."""
    for arr in pool.values():
        arr[dst] = arr[src]
    return pool
