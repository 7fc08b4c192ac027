"""Dense decoder stacks: parameter layout and the per-layer blocks.

Layer stacks keep the JAX package's *stacked* parameter layout (every
per-layer leaf has a leading layer axis), and the layer walk is a Python
loop where the JAX package scans.  Only the dense attention family
(``ATTN`` / ``LOCAL`` blocks, dense FFN) is ported so far.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import attention as attn_mod
from .configs import ATTN, LOCAL, MAMBA, ModelConfig
from .layers import Params, dtype_of, ffn_apply, rms_norm
from .runtime import RuntimeOptions


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.is_encoder_decoder \
            or cfg.vision_embed_dim:
        raise NotImplementedError(
            f"{cfg.name}: only dense attention stacks are ported so far "
            f"(arch_type={cfg.arch_type!r})")


# ----------------------------------------------------------------- init ----
def init_params(cfg: ModelConfig, seed: int = 0,
                device: str = "cuda") -> Params:
    """Random weights in the JAX package's layout, drawn from ``seed``
    with a CPU ``torch.Generator`` (the JAX draws cannot be reproduced;
    tests bring the JAX weights across with :mod:`repro_torch.weights`)."""
    _check_dense(cfg)
    gen = torch.Generator().manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    n, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff

    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype)

    attn = {
        "wq": normal((n, d, cfg.q_dim), 1.0 / math.sqrt(d)),
        "wk": normal((n, d, cfg.kv_dim), 1.0 / math.sqrt(d)),
        "wv": normal((n, d, cfg.kv_dim), 1.0 / math.sqrt(d)),
        "wo": normal((n, cfg.q_dim, d), 1.0 / math.sqrt(cfg.q_dim)),
    }
    if cfg.qkv_bias:
        attn.update(bq=zeros((n, cfg.q_dim)), bk=zeros((n, cfg.kv_dim)),
                    bv=zeros((n, cfg.kv_dim)))
    ffn = {"w_up": normal((n, d, f), 1.0 / math.sqrt(d)),
           "w_down": normal((n, f, d), 1.0 / math.sqrt(f))}
    if cfg.gated_ffn:
        ffn["w_gate"] = normal((n, d, f), 1.0 / math.sqrt(d))
    params = {
        "embed": normal((cfg.padded_vocab, d), 0.02),
        "final_norm": zeros((d,)),
        "layers": {"ln1": zeros((n, d)), "attn": attn,
                   "ln2": zeros((n, d)), "ffn": ffn},
    }
    return _to_device(params, device)


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
        impl=_select_impl(cfg, opts, s, window))
    return x + h.to(x.dtype)


def ffn_or_moe_block(layer: Params, x: torch.Tensor, cfg: ModelConfig,
                     opts: RuntimeOptions
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.arch_type == "moe":
        raise NotImplementedError("MoE blocks are not ported yet")
    h = rms_norm(x, layer["ln2"], cfg.norm_eps)
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
