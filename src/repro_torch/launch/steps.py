"""Train / prefill / serve steps and meta-device input specs.

The JAX package's four step functions, run eagerly (there is no trace to
lower here), and its ``ShapeDtypeStruct`` stand-ins as tensors on the
``meta`` device: shapes and dtypes with no storage, so
:func:`params_spec_struct` sizes even internvl2-26b's 19.3 B parameters
without drawing one.  ``train.py``, ``serve.py`` and the one-card
planner ``dryrun.py`` use them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.configs import InputShape, ModelConfig
from repro_torch.models.layers import Params, dtype_of, tree_leaves, tree_map
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      lm_loss, prefill)
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.models.transformer import param_tree
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine


def options_for(cfg: ModelConfig, shape: InputShape,
                overrides: Optional[Dict[str, Any]] = None) -> RuntimeOptions:
    """Engine defaults per workload (the middleware's θ_s baseline): a
    train step recomputes each pattern period in its backward
    (``remat="full"``, ``transformer.apply_stack``)."""
    kw: Dict[str, Any] = {}
    if shape.kind == "train":
        kw.update(remat="full", attn_impl="auto", q_chunk=512, k_chunk=1024)
    elif shape.kind == "prefill":
        kw.update(remat="none", attn_impl="auto", q_chunk=512, k_chunk=1024)
    else:  # decode
        kw.update(remat="none")
        if shape.seq_len > 100_000:
            # long_500k: sub-quadratic decode — engine-selected sliding
            # window (SSM/hybrid are O(1) anyway; their shared/local
            # attention blocks adopt the same window)
            kw.update(decode_window=8192)
    kw.update(overrides or {})
    return RuntimeOptions(**kw)


# ------------------------------------------------------------ input specs --
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape,
                opts: Optional[RuntimeOptions] = None) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of ``shape``'s step."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.kind == "train":
        specs["tokens"] = _meta((b, s), torch.int32)
        specs["labels"] = _meta((b, s), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = _meta((b, s), torch.int32)
    else:
        specs["token"] = _meta((b,), torch.int32)
    if cfg.is_encoder_decoder and shape.kind != "decode":
        specs["encoder_frames"] = _meta(
            (b, cfg.encoder_seq_len, cfg.d_model), torch.bfloat16)
    if cfg.vision_embed_dim and shape.kind != "decode":
        specs["vision_embeds"] = _meta(
            (b, cfg.num_vision_tokens, cfg.vision_embed_dim), torch.bfloat16)
    return specs


def cache_spec_struct(cfg: ModelConfig, shape: InputShape,
                      opts: RuntimeOptions) -> Dict[str, Any]:
    return init_cache(cfg, shape.global_batch, shape.seq_len, opts,
                      device="meta")


def params_spec_struct(cfg: ModelConfig) -> Params:
    """The parameter tree of ``cfg`` on the meta device: no weight is
    drawn."""
    dtype = dtype_of(cfg.param_dtype)

    def normal(shape, std, dt=dtype):
        return _meta(shape, dt)

    def zeros(shape):
        return _meta(shape, dtype)

    # the few leaves drawn as constants (a_log, d_skip) move to meta too
    return tree_map(lambda t: t.to("meta"), param_tree(cfg, normal, zeros))


# ------------------------------------------------------------- the steps ---
def loss_and_grads(params: Params, cfg: ModelConfig, opts: RuntimeOptions,
                   batch: Dict[str, torch.Tensor]):
    """``(loss, grads)`` of one train batch: the loss through ``forward``
    and ``lm_loss`` plus ``router_aux_weight`` times the aux loss,
    gradients by autograd (on the card through the kernels' backwards,
    and each recomputation region's forward again under ``opts.remat``).
    A floating leaf that the loss does not reach gets a zero gradient, as
    under ``jax.grad``."""
    p = tree_map(lambda t: t.detach().requires_grad_(
        t.is_floating_point()), params)
    logits, aux = forward(
        p, cfg, batch["tokens"], opts,
        encoder_frames=batch.get("encoder_frames"),
        vision_embeds=batch.get("vision_embeds"))
    loss = lm_loss(logits, batch["labels"]) + cfg.router_aux_weight * aux
    del logits, aux
    leaves = [t for t in tree_leaves(p) if t.requires_grad]
    flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(t):
        g = next(flat) if t.requires_grad else None
        return torch.zeros_like(t) if g is None else g

    return loss.detach(), tree_map(grad_of, p)


def make_train_step(cfg: ModelConfig, opts: RuntimeOptions,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    donate: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: :func:`loss_and_grads`, then one AdamW step
    at ``warmup_cosine(step)``.  With ``donate`` the step writes the new
    parameters and moments over the ones it is given and returns those
    tensors (``adamw.apply_``), as ``jax.jit(..., donate_argnums=(0, 1))``
    lets XLA do; without it the inputs are not modified."""
    update = adamw.apply_ if donate else adamw.apply

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, opts, batch)
        with torch.no_grad():
            lr = warmup_cosine(opt_state.step)
            metrics = {"loss": loss, "grad_norm": adamw.global_norm(grads)}
            new_params, new_state = update(grads, params, opt_state,
                                           opt_cfg, lr_scale=lr)
        return new_params, new_state, metrics
    return train_step


def make_prefill_step(cfg: ModelConfig, opts: RuntimeOptions) -> Callable:
    @torch.no_grad()
    def prefill_step(params, cache, batch):
        logits, cache = prefill(
            params, cfg, batch["tokens"], cache, opts,
            encoder_frames=batch.get("encoder_frames"),
            vision_embeds=batch.get("vision_embeds"))
        return logits, cache
    return prefill_step


def make_serve_step(cfg: ModelConfig, opts: RuntimeOptions) -> Callable:
    @torch.no_grad()
    def serve_step(params, cache, batch):
        logits, cache = decode_step(params, cfg, cache, batch["token"], opts)
        return logits, cache
    return serve_step


def make_step(cfg: ModelConfig, shape: InputShape,
              opts: Optional[RuntimeOptions] = None) -> Callable:
    opts = opts or options_for(cfg, shape)
    if shape.kind == "train":
        return make_train_step(cfg, opts)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, opts)
    return make_serve_step(cfg, opts)
