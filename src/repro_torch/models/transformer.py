"""Decoder stacks: parameter layout and the per-layer blocks.

Layer stacks keep the JAX package's *stacked* parameter layout (every
per-layer leaf has a leading layer axis), and the layer walk is a Python
loop where the JAX package scans.  Ported so far: the dense attention
family (``ATTN`` / ``LOCAL`` blocks, dense FFN), the MoE family (the
same attention blocks with a routed expert FFN, :mod:`.moe`) and the
attention-free SSM stack (``MAMBA`` blocks), with the full-sequence
``forward`` (train / prefill, no cache) that the elastic variants, TTA
and the middleware run.  On the card every prefill block runs the flash
attention kernel and the fused FFN kernel (through ``attention._attend``
and ``layers.ffn_apply``; an MoE block only for its shared expert), and
every Mamba block the SSD scan kernel (through ``ssm.mamba_forward``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .configs import ATTN, LOCAL, MAMBA, ModelConfig
from .layers import (Params, cast_params, dtype_of, embed_lookup,
                     ffn_apply, layer_slice, mask_padded_logits_raw,
                     rms_norm, unembed)
from .runtime import DEFAULT_OPTIONS, RuntimeOptions


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "moe", "ssm") \
            or cfg.is_encoder_decoder or cfg.vision_embed_dim:
        raise NotImplementedError(
            f"{cfg.name}: only dense and MoE attention stacks and the SSM "
            f"stack are ported so far (arch_type={cfg.arch_type!r})")


# ----------------------------------------------------------------- init ----
def init_params(cfg: ModelConfig, seed: int = 0,
                device: str = "cuda") -> Params:
    """Random weights in the JAX package's layout, drawn from ``seed``
    with a CPU ``torch.Generator`` (the JAX draws cannot be reproduced;
    tests bring the JAX weights across with :mod:`repro_torch.weights`)."""
    _check_dense(cfg)
    gen = torch.Generator().manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    n, d = cfg.num_layers, cfg.d_model

    def normal(shape, std, dt=dtype):
        return torch.randn(shape, generator=gen).mul_(std).to(dt)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype)

    if cfg.arch_type == "ssm":
        layers = {"ln": zeros((n, d)), "mamba": _mamba_init(cfg, n, normal,
                                                            zeros)}
        return _to_device({"embed": normal((cfg.padded_vocab, d), 0.02),
                           "final_norm": zeros((d,)), "layers": layers},
                          device)
    attn = {
        "wq": normal((n, d, cfg.q_dim), 1.0 / math.sqrt(d)),
        "wk": normal((n, d, cfg.kv_dim), 1.0 / math.sqrt(d)),
        "wv": normal((n, d, cfg.kv_dim), 1.0 / math.sqrt(d)),
        "wo": normal((n, cfg.q_dim, d), 1.0 / math.sqrt(cfg.q_dim)),
    }
    if cfg.qkv_bias:
        attn.update(bq=zeros((n, cfg.q_dim)), bk=zeros((n, cfg.kv_dim)),
                    bv=zeros((n, cfg.kv_dim)))
    layers = {"ln1": zeros((n, d)), "attn": attn, "ln2": zeros((n, d))}
    if cfg.arch_type == "moe":
        layers["moe"] = _moe_init(cfg, n, normal)
    else:
        layers["ffn"] = _ffn_init(cfg, n, normal)
    params = {
        "embed": normal((cfg.padded_vocab, d), 0.02),
        "final_norm": zeros((d,)),
        "layers": layers,
    }
    return _to_device(params, device)


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


def transformer_block(layer: Params, x: torch.Tensor, cfg: ModelConfig,
                      opts: RuntimeOptions, *, window: int,
                      causal: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = attn_block(layer, x, cfg, opts, window=window, causal=causal)
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


# -------------------------------------------------------------- the stack --
def apply_stack(stack: Params, x: torch.Tensor, cfg: ModelConfig,
                opts: RuntimeOptions, *, causal: bool = True,
                num_layers: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a stacked layer dict over x.  Returns (x, aux_loss_sum).

    ``num_layers`` < full depth realizes the elastic depth-scaling
    operator η5: only the first n layers' stacked weights are used.  The
    layers run as a Python loop over ``layer_slice``, in pattern order
    (a period's kinds, then the leftover layers of a partial period);
    the JAX package's ``scan_layers`` and ``remat`` options have no
    counterpart here (no trace to keep small, and autograd keeps what a
    backward needs)."""
    _check_dense(cfg)
    kinds, _ = _pattern_period(cfg)
    total = _stack_depth(stack)
    n = total if num_layers is None else min(num_layers, total)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(n):
        layer = layer_slice(stack, j)
        kind = kinds[j % len(kinds)]
        if kind == MAMBA:
            x = mamba_block(layer, x, cfg)
            continue
        window = cfg.sliding_window if kind == LOCAL else 0
        x, a = transformer_block(layer, x, cfg, opts, window=window,
                                 causal=causal)
        aux = aux + a
    return x, aux


def _stack_depth(stack: Params) -> int:
    leaf = stack
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


# ------------------------------------------------------------- forward -----
def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            opts: RuntimeOptions = DEFAULT_OPTIONS, *,
            num_layers: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (train / prefill).  Returns (logits, aux_loss).

    tokens: (B, S) integer ids on the params' device.  Weights are cast
    to the activation dtype (``cast_params``); an optional
    ``logit_bias`` (TTA's output prior) is added to the logits, and the
    vocab padding is masked.  Differentiable: on the card the flash
    attention and fused FFN launches carry their analytic gradients."""
    _check_dense(cfg)
    act_dt = dtype_of(cfg.activation_dtype)
    params = cast_params(params, act_dt)
    x = embed_lookup(params["embed"], tokens).to(act_dt)
    x, aux = apply_stack(params["layers"], x, cfg, opts,
                         num_layers=num_layers)
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
