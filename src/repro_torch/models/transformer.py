"""Model stacks: parameter layout and the per-layer blocks.

Layer stacks keep the JAX package's *stacked* parameter layout (every
per-layer leaf has a leading layer axis), and the layer walk is a Python
loop where the JAX package scans.  Every family of the JAX package: the
dense attention family (``ATTN`` / ``LOCAL`` blocks, dense FFN), the MoE
family (the same attention blocks with a routed expert FFN, :mod:`.moe`),
the attention-free SSM stack (``MAMBA`` blocks), the hybrid (a Mamba
stack with ONE shared attention block run after every full period of
``shared_attn_period`` Mamba blocks, Zamba2), the encoder-decoder
(Whisper: a non-causal encoder stack over stub audio frames, and decoder
blocks with a cross-attention block over the encoder's output) and the
VLM stub (InternVL2: a projection of stub patch embeddings into the
first positions), with the full-sequence ``forward`` (train / prefill,
no cache) that the elastic variants, TTA and the middleware run.  On the
card every prefill block runs the flash attention kernel and the fused
FFN kernel (through ``attention._attend`` and ``layers.ffn_apply``; an
MoE block only for its shared expert; a non-gated FFN as plain
products), a cross-attention block the flash attention kernel with the
encoder's length as its key length, and every Mamba block the SSD scan
kernel (through ``ssm.mamba_forward``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels.fused_ffn import fused_ffn_op  # noqa: F401  (K3's op)
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .configs import ATTN, LOCAL, MAMBA, ModelConfig
from .layers import (Params, cast_params, dtype_of, embed_lookup,
                     ffn_apply, layer_slice, mask_padded_logits_raw,
                     matmul_w, rms_norm, tree_leaves, unembed)
from .runtime import DEFAULT_OPTIONS, RuntimeOptions


# ----------------------------------------------------------------- init ----
def init_params(cfg: ModelConfig, seed: int = 0,
                device: str = "cuda") -> Params:
    """Random weights in the JAX package's layout, drawn from ``seed``
    with a CPU ``torch.Generator`` (the JAX draws cannot be reproduced;
    tests bring the JAX weights across with :mod:`repro_torch.weights`).
    An encoder-decoder adds the ``encoder`` stack (attention layers
    without cross-attention) and ``encoder_norm``, and its decoder layers
    a ``cross`` block; a VLM adds ``vision_proj``."""
    gen = torch.Generator().manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)

    def normal(shape, std, dt=dtype):
        return torch.randn(shape, generator=gen).mul_(std).to(dt)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype)

    return _to_device(param_tree(cfg, normal, zeros), device)


def param_tree(cfg: ModelConfig, normal, zeros) -> Params:
    """The parameter tree of ``cfg``, each weight from ``normal(shape,
    std[, dtype])`` and each zero-initialised leaf from ``zeros(shape)``
    in the order :func:`init_params` draws them (a ``normal`` that
    returns meta tensors gives the tree's shapes and dtypes without
    drawing a weight)."""
    n, d = cfg.num_layers, cfg.d_model
    shared = None
    if cfg.arch_type in ("ssm", "hybrid"):
        layers = {"ln": zeros((n, d)),
                  "mamba": _mamba_init(cfg, n, normal, zeros)}
        if cfg.arch_type == "hybrid":
            # ONE attention layer, shared by every site of the stack
            shared = layer_slice(_attn_init(cfg, 1, normal, zeros), 0)
    else:
        layers = _attn_init(cfg, n, normal, zeros,
                            cross=cfg.is_encoder_decoder)
    # the embedding is drawn after the layers
    params = {"embed": normal((cfg.padded_vocab, d), 0.02),
              "final_norm": zeros((d,)), "layers": layers}
    if shared is not None:
        params["shared_attn"] = shared
    if cfg.is_encoder_decoder:
        params["encoder"] = _attn_init(cfg, cfg.encoder_layers, normal,
                                       zeros)
        params["encoder_norm"] = zeros((d,))
    if cfg.vision_embed_dim:
        params["vision_proj"] = {
            "w": normal((cfg.vision_embed_dim, d),
                        1.0 / math.sqrt(cfg.vision_embed_dim)),
            "b": zeros((d,))}
    return params


def _proj_init(cfg: ModelConfig, n: int, normal) -> Params:
    """``n`` stacked attention projections (no biases)."""
    d = cfg.d_model
    return {
        "wq": normal((n, d, cfg.q_dim), 1.0 / math.sqrt(d)),
        "wk": normal((n, d, cfg.kv_dim), 1.0 / math.sqrt(d)),
        "wv": normal((n, d, cfg.kv_dim), 1.0 / math.sqrt(d)),
        "wo": normal((n, cfg.q_dim, d), 1.0 / math.sqrt(cfg.q_dim)),
    }


def _attn_init(cfg: ModelConfig, n: int, normal, zeros,
               cross: bool = False) -> Params:
    """``n`` stacked attention layers: norms, projections and the FFN
    (dense, or the MoE block); with ``cross``, a cross-attention block
    too (``ln_cross`` and ``cross`` projections without biases)."""
    d = cfg.d_model
    attn = _proj_init(cfg, n, normal)
    if cfg.qkv_bias:
        attn.update(bq=zeros((n, cfg.q_dim)), bk=zeros((n, cfg.kv_dim)),
                    bv=zeros((n, cfg.kv_dim)))
    layers = {"ln1": zeros((n, d)), "attn": attn, "ln2": zeros((n, d))}
    if cfg.arch_type == "moe":
        layers["moe"] = _moe_init(cfg, n, normal)
    else:
        layers["ffn"] = _ffn_init(cfg, n, normal)
    if cross:
        layers["ln_cross"] = zeros((n, d))
        layers["cross"] = _proj_init(cfg, n, normal)
    return layers


def _ffn_init(cfg: ModelConfig, n: int, normal) -> Params:
    """A stacked dense FFN's weights."""
    d, f = cfg.d_model, cfg.d_ff
    ffn = {"w_up": normal((n, d, f), 1.0 / math.sqrt(d)),
           "w_down": normal((n, f, d), 1.0 / math.sqrt(f))}
    if cfg.gated_ffn:
        ffn["w_gate"] = normal((n, d, f), 1.0 / math.sqrt(d))
    return ffn


def _moe_init(cfg: ModelConfig, n: int, normal) -> Params:
    """The stacked MoE block parameters of ``moe.moe_init`` in the JAX
    package: an f32 router ``(n, D, E)``, expert weights ``(n, E, D,
    F)`` / ``(n, E, F, D)`` and, for a shared expert, a dense FFN."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": normal((n, d, e), 1.0 / math.sqrt(d), torch.float32),
         "w_gate": normal((n, e, d, f), 1.0 / math.sqrt(d)),
         "w_up": normal((n, e, d, f), 1.0 / math.sqrt(d)),
         "w_down": normal((n, e, f, d), 1.0 / math.sqrt(f))}
    if cfg.moe_shared_expert:
        p["shared"] = _ffn_init(cfg, n, normal)
    return p


def _mamba_init(cfg: ModelConfig, n: int, normal, zeros) -> Params:
    """The stacked Mamba2 block parameters of ``ssm.mamba_init`` in the
    JAX package: same shapes, scales and dtypes (``a_log``, ``d_skip``
    and ``dt_bias`` f32)."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    nh, st, gr = cfg.ssm_num_heads, cfg.ssm_state_dim, cfg.ssm_ngroups
    conv_dim, w = cfg.ssm_conv_dim, cfg.ssm_conv_width
    in_dim = 2 * di + 2 * gr * st + nh
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32))
    return {
        "in_proj": normal((n, d, in_dim), 1.0 / math.sqrt(d)),
        "conv_w": normal((n, conv_dim, w), 1.0 / math.sqrt(w)),
        "conv_b": zeros((n, conv_dim)),
        "a_log": a_log.expand(n, nh).clone(),
        "d_skip": torch.ones((n, nh), dtype=torch.float32),
        "dt_bias": torch.zeros((n, nh), dtype=torch.float32),
        "out_proj": normal((n, di, d), 1.0 / math.sqrt(di)),
        "norm_scale": zeros((n, di)),
    }


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ----------------------------------------------------------- block apply ---
def _select_impl(cfg: ModelConfig, opts: RuntimeOptions, s: int,
                 window: int) -> str:
    impl = opts.attn_impl
    if impl != "auto":
        return impl
    if window and s > 2 * window and s % min(opts.q_chunk, s) == 0:
        return "banded"
    if s > 1024 and s % min(opts.q_chunk, s) == 0 \
            and s % min(opts.k_chunk, s) == 0:
        return "chunked"
    return "full"


def attn_block(layer: Params, x: torch.Tensor, cfg: ModelConfig,
               opts: RuntimeOptions, *, window: int,
               causal: bool = True) -> torch.Tensor:
    s = x.shape[1]
    h = attn_mod.attention_block(
        layer["attn"], rms_norm(x, layer["ln1"], cfg.norm_eps),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=causal, window=window,
        impl=_select_impl(cfg, opts, s, window),
        q_chunk=opts.q_chunk, k_chunk=opts.k_chunk)
    return x + h.to(x.dtype)


def ffn_or_moe_block(layer: Params, x: torch.Tensor, cfg: ModelConfig,
                     opts: RuntimeOptions
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, layer["ln2"], cfg.norm_eps)
    if cfg.arch_type == "moe":
        y, aux = moe_mod.moe_apply(layer["moe"], h, cfg,
                                   capacity_factor=opts.moe_capacity_factor)
    else:
        y = ffn_apply(layer["ffn"], h, gated=cfg.gated_ffn,
                      activation=cfg.activation)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y.to(x.dtype), aux


def cross_block(layer: Params, x: torch.Tensor, cross_src: torch.Tensor,
                cfg: ModelConfig):
    """The decoder's cross-attention block: queries from ``x`` (after
    ``ln_cross``), keys and values from the encoder output ``cross_src``
    (B, S_enc, D), no rotary, non-causal.  Returns ``(x, k, v)`` with the
    block's residual added and the cross K/V (B, S_enc, K, hd) that a
    prefill caches."""
    b, s, _ = x.shape
    se, hd = cross_src.shape[1], cfg.resolved_head_dim
    c = layer["cross"]
    q = matmul_w(rms_norm(x, layer["ln_cross"], cfg.norm_eps), c["wq"])
    k = matmul_w(cross_src, c["wk"]).reshape(b, se, cfg.num_kv_heads, hd)
    v = matmul_w(cross_src, c["wv"]).reshape(b, se, cfg.num_kv_heads, hd)
    out = attn_mod.cross_attention(q.reshape(b, s, cfg.num_heads, hd), k, v)
    x = x + matmul_w(out.reshape(b, s, cfg.num_heads * hd),
                     c["wo"]).to(x.dtype)
    return x, k, v


def transformer_block(layer: Params, x: torch.Tensor, cfg: ModelConfig,
                      opts: RuntimeOptions, *, window: int,
                      causal: bool = True,
                      cross_src: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = attn_block(layer, x, cfg, opts, window=window, causal=causal)
    if cross_src is not None and "cross" in layer:
        x, _, _ = cross_block(layer, x, cross_src, cfg)
    return ffn_or_moe_block(layer, x, cfg, opts)


def mamba_block(layer: Params, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    return x + ssm_mod.mamba_forward(
        layer["mamba"], rms_norm(x, layer["ln"], cfg.norm_eps),
        cfg).to(x.dtype)


def _pattern_period(cfg: ModelConfig) -> Tuple[Tuple[str, ...], bool]:
    """Return (kinds of one period over *stacked* layers,
    shared_attn_after)."""
    if cfg.arch_type == "ssm":
        return (MAMBA,), False
    if cfg.arch_type == "hybrid":
        p = cfg.shared_attn_period or cfg.num_layers
        return tuple([MAMBA] * p), True
    if cfg.local_global_ratio:
        r = cfg.local_global_ratio
        return tuple([LOCAL] * r + [ATTN]), False
    return (ATTN,), False


def _shared_site(cfg: ModelConfig, j: int) -> int:
    """The site of a hybrid's shared attention block that runs after
    layer ``j``, or -1.  A site closes each full period of Mamba blocks,
    so the leftover layers of a partial period have none (zamba2: after
    layers 5, 11, ..., 35, none after 36 and 37)."""
    kinds, shared_after = _pattern_period(cfg)
    period = len(kinds)
    return j // period if shared_after and (j + 1) % period == 0 else -1


# -------------------------------------------------------------- the stack --
# the products the ``dots`` policy keeps, as the JAX policy
# ``dots_with_no_batch_dims_saveable`` keeps the dots without batch
# dimensions: the projections (``x @ W`` reaches autograd as ``aten.mm``)
# and the fused FFN's output; the batched products (attention on the CPU,
# the MoE experts' ``bmm``), the flash attention and SSD scan launches,
# norms, rotary and elementwise work are recomputed
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.repro_torch.fused_ffn.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, opts: RuntimeOptions, *args):
    """``fn(*args)`` as a recomputation region, as the JAX
    ``_remat_wrap`` reads ``opts.remat``: ``"dots"`` keeps
    ``_DOTS_SAVED``'s outputs and recomputes the rest in the backward,
    any other value all of it (``nothing_saveable``)."""
    kw = {}
    if opts.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def _records_grad(*trees) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for tree in trees for t in tree_leaves(tree))


def apply_stack(stack: Params, x: torch.Tensor, cfg: ModelConfig,
                opts: RuntimeOptions, *, shared: Optional[Params] = None,
                causal: bool = True,
                cross_src: Optional[torch.Tensor] = None,
                num_layers: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a stacked layer dict over x.  Returns (x, aux_loss_sum).

    ``num_layers`` < full depth realizes the elastic depth-scaling
    operator η5: only the first n layers' stacked weights are used.  The
    layers run as a Python loop over ``layer_slice`` (the JAX package's
    ``scan_layers`` has no counterpart: there is no trace to keep small),
    one pattern period at a time (a period's kinds, then the leftover
    layers of a partial period).

    ``opts.remat`` is the JAX package's: when autograd records, each full
    period (with a hybrid's shared block after it) is one recomputation
    region, ``"dots"`` keeping the projections' and the fused FFN's
    outputs and ``"full"`` only the region's inputs; the leftover layers
    run outside any region.  Under ``torch.no_grad`` (inference, prefill,
    decode) every policy runs the same plain walk.

    A hybrid stack runs the ``shared`` attention layer after each FULL
    period of the first n layers; the leftover layers of a partial
    period run without it (zamba2: 38 = 6 x 6 + 2, so 6 sites).  With
    ``cross_src`` (an encoder-decoder's encoder output) each layer that
    has a ``cross`` block attends over it after its self-attention."""
    kinds, shared_after = _pattern_period(cfg)
    period = len(kinds)
    total = _stack_depth(stack)
    n = total if num_layers is None else min(num_layers, total)
    n_full = (n // period) * period

    def one_layer(j, x, aux, cross_src):
        layer = layer_slice(stack, j)
        kind = kinds[j % period]
        if kind == MAMBA:
            return mamba_block(layer, x, cfg), aux
        window = cfg.sliding_window if kind == LOCAL else 0
        x, a = transformer_block(layer, x, cfg, opts, window=window,
                                 causal=causal, cross_src=cross_src)
        return x, aux + a

    def period_body(i, x, aux, cross_src):
        for j in range(i * period, (i + 1) * period):
            x, aux = one_layer(j, x, aux, cross_src)
        if shared_after and shared is not None:
            x, a = transformer_block(shared, x, cfg, opts, window=0,
                                     causal=causal)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = opts.remat != "none" and _records_grad(stack, shared, x,
                                                   cross_src)
    for i in range(n_full // period):
        body = functools.partial(period_body, i)
        if remat:
            x, aux = _remat(body, opts, x, aux, cross_src)
        else:
            x, aux = body(x, aux, cross_src)
    for j in range(n_full, n):
        x, aux = one_layer(j, x, aux, cross_src)
    return x, aux


def _stack_depth(stack: Params) -> int:
    leaf = stack
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


# ------------------------------------------------------------- forward -----
def embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The token embeddings in the activation dtype (``params`` already
    cast to it).  A VLM's stub patch embeddings ``vision_embeds`` (B,
    n_vis, vision_embed_dim), projected by ``vision_proj``, replace the
    first n_vis positions; the token ids there are placeholders."""
    act_dt = dtype_of(cfg.activation_dtype)
    x = embed_lookup(params["embed"], tokens).to(act_dt)
    if cfg.vision_embed_dim and vision_embeds is not None:
        vp = params["vision_proj"]
        v = (vision_embeds.to(act_dt) @ vp["w"] + vp["b"]).to(act_dt)
        x = torch.cat([v, x[:, v.shape[1]:]], dim=1)
    return x


def encode(params: Params, cfg: ModelConfig, encoder_frames: torch.Tensor,
           opts: RuntimeOptions) -> torch.Tensor:
    """An encoder-decoder's encoder over stub audio frames (B, S_enc, D):
    the ``encoder`` stack, non-causal with ``full`` attention (on the
    card the flash attention kernel at S_enc), then ``encoder_norm``.
    The result is every decoder layer's ``cross_src``."""
    enc = encoder_frames.to(dtype_of(cfg.activation_dtype))
    enc, _ = apply_stack(params["encoder"], enc, cfg,
                         opts.replace(attn_impl="full"), causal=False)
    return rms_norm(enc, params["encoder_norm"], cfg.norm_eps)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            opts: RuntimeOptions = DEFAULT_OPTIONS, *,
            encoder_frames: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            num_layers: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (train / prefill).  Returns (logits, aux_loss).

    tokens: (B, S) integer ids on the params' device;
    ``encoder_frames``: (B, S_enc, D) stub audio embeddings (enc-dec);
    ``vision_embeds``: (B, n_vis, vision_embed_dim) stub patch embeddings
    (VLM).  Weights are cast to the activation dtype (``cast_params``);
    an optional ``logit_bias`` (TTA's output prior) is added to the
    logits, and the vocab padding is masked.  Differentiable: on the card
    the flash attention and fused FFN launches carry their analytic
    gradients, and the SSD scan's launch the gradient of its plain
    version."""
    act_dt = dtype_of(cfg.activation_dtype)
    params = cast_params(params, act_dt)
    x = embed_inputs(params, cfg, tokens, vision_embeds)
    cross_src = None
    if cfg.is_encoder_decoder and encoder_frames is not None:
        cross_src = encode(params, cfg, encoder_frames, opts)
    x, aux = apply_stack(params["layers"], x, cfg, opts,
                         shared=params.get("shared_attn"),
                         cross_src=cross_src, num_layers=num_layers)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x)
    if "logit_bias" in params:
        # TTA prior recalibration (paper §III-A2): a label-free-adaptable
        # output bias absorbing live unigram drift
        logits = logits + params["logit_bias"].to(logits.dtype)
    return mask_padded_logits(logits, cfg), aux


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy.  logits: (B,S,V); labels: (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def mask_padded_logits(logits: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """Vocab rows beyond cfg.vocab_size are sharding padding — mask them."""
    return mask_padded_logits_raw(logits, cfg.vocab_size)
