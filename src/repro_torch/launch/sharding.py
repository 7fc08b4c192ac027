"""Logical-axis sharding rules (MaxText-style) for every parameter, cache
and batch tensor, as plain tuples of mesh-axis names.

The rules are the JAX package's, kept so a plan names the same layout:
weight matmul dims shard on the FUSED projection axes (q_dim, kv_dim,
d_ff, packed mamba in_proj), weights additionally FSDP over "data", and
the "pod" axis is pure data parallelism.  A spec is a tuple with one
entry per dimension, ``None`` for a replicated one (the JAX package's
``PartitionSpec``); ``()`` replicates the whole tensor.

One card leaves out what the specs are for: there is no multi-device
execution, so :func:`to_shardings` maps every spec to the mesh's one
device, and a tree is placed by moving it there.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.models.configs import InputShape, ModelConfig
from repro_torch.optim.adamw import AdamWState

from .mesh import Mesh, batch_axes

Params = Any
Spec = Tuple

FSDP = "data"
TP = "model"


def _spec(*entries) -> Spec:
    """A spec as ``PartitionSpec`` normalises one: a one-axis tuple
    entry is that axis's name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _right_align(spec: Tuple, ndim: int) -> Spec:
    """Pad a trailing-dims spec with leading Nones (stacked-layer dims)."""
    return (None,) * (ndim - len(spec)) + tuple(spec)


_REPLICATED = ("ln", "ln1", "ln2", "ln_cross", "final_norm", "encoder_norm",
               "norm_scale", "a_log", "d_skip", "dt_bias", "norms")


def leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
              cfg: ModelConfig, mode: str = "train") -> Spec:
    name = path[-1]
    nd = len(shape)
    in_moe = "moe" in path
    if name in _REPLICATED or nd == 0:
        return ()
    if name == "embed":
        return (TP, FSDP)
    if name in ("wq", "wk", "wv"):
        return _right_align((FSDP, TP), nd)
    if name == "wo":
        return _right_align((TP, FSDP), nd)
    if name in ("bq", "bk", "bv"):
        return _right_align((TP,), nd)
    if name in ("w_gate", "w_up"):
        if in_moe and nd >= 3 and shape[-3] == cfg.num_experts:
            if cfg.num_experts % 16 == 0:
                return _right_align((TP, None, None), nd)  # expert parallel
            return _right_align((None, None, TP), nd)      # E<16: TP on d_ff
        return _right_align((FSDP, TP), nd)
    if name == "w_down":
        if in_moe and nd >= 3 and shape[-3] == cfg.num_experts:
            if cfg.num_experts % 16 == 0:
                return _right_align((TP, None, None), nd)
            return _right_align((None, TP, None), nd)
        return _right_align((TP, FSDP), nd)
    if name == "router":
        return _right_align((FSDP, None), nd)
    if name == "in_proj":
        return _right_align((FSDP, TP), nd)
    if name == "out_proj":
        return _right_align((TP, FSDP), nd)
    if name == "conv_w":
        return _right_align((TP, None), nd)
    if name == "conv_b":
        return _right_align((TP,), nd)
    if name == "w" and "vision_proj" in path:
        return (FSDP, None)
    return ()  # safe default: replicate


def param_specs(cfg: ModelConfig, params_shape: Params,
                mode: str = "train") -> Params:
    """A spec tree matching a (meta-device) parameter tree; ``mode=
    "serve"`` replicates weights over the FSDP axis."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        s = leaf_spec(path, tuple(tree.shape), cfg)
        if mode == "serve":
            s = tuple(None if ax == FSDP else ax for ax in s)
        return s
    return walk(params_shape, ())


def opt_state_specs(cfg: ModelConfig, opt_shape, pspecs) -> AdamWState:
    """AdamW m/v mirror the parameter specs; step is replicated."""
    return AdamWState(step=(), m=pspecs, v=pspecs)


# ------------------------------------------------------------- caches ------
def _tp_axis_for(dim: int, mesh: Mesh) -> Optional[str]:
    size = mesh.shape.get(TP, 1)
    return TP if dim % size == 0 else None


def cache_specs(cfg: ModelConfig, cache_shape: Dict[str, Any], mesh: Mesh,
                shape: InputShape, kv_shard: str = "heads") -> Dict[str, Spec]:
    """KV/SSM cache specs.

    decode_32k: batch -> (pod,)data, kv heads -> model when divisible,
                else head_dim -> model.
    long_500k (batch=1): cache *sequence* -> (pod+)data (context
                parallelism), heads as above."""
    b_axes = batch_axes(mesh)
    specs: Dict[str, Spec] = {}
    total = 1
    for a in b_axes:
        total *= mesh.shape[a]
    batch_shardable = (shape.global_batch % total == 0
                       and shape.global_batch >= total)
    seq_parallel = not batch_shardable
    for key, leaf in cache_shape.items():
        if key == "pos":
            specs[key] = ()
        elif key in ("k", "v", "shared_k", "shared_v", "cross_k", "cross_v"):
            # (L, B, S, K, hd)
            kdim, hdim = leaf.shape[3], leaf.shape[4]
            kv_ax = _tp_axis_for(kdim, mesh)
            hd_ax = _tp_axis_for(hdim, mesh) if kv_ax is None else None
            if kv_shard == "seq" and key not in ("cross_k", "cross_v") \
                    and not seq_parallel:
                # split-KV (flash-decoding style): the cache SEQ dim
                # shards over "model"
                specs[key] = _spec(None, b_axes, TP, None, None)
                continue
            if seq_parallel and key not in ("cross_k", "cross_v"):
                specs[key] = _spec(None, None, b_axes, kv_ax, hd_ax)
            elif seq_parallel:
                # cross-attn cache: fixed encoder length, unshardable batch
                specs[key] = (None, None, None, kv_ax, hd_ax)
            else:
                specs[key] = _spec(None, b_axes, None, kv_ax, hd_ax)
        elif key == "ssm":
            # (L, B, H, P, N)
            h_ax = _tp_axis_for(leaf.shape[2], mesh)
            specs[key] = _spec(None, None if seq_parallel else b_axes, h_ax,
                               None, None)
        elif key == "conv":
            # (L, B, W-1, C)
            c_ax = _tp_axis_for(leaf.shape[3], mesh)
            specs[key] = _spec(None, None if seq_parallel else b_axes, None,
                               c_ax)
        else:
            specs[key] = ()
    return specs


# -------------------------------------------------------------- batches ----
def batch_specs(cfg: ModelConfig, mesh: Mesh, shape: InputShape,
                decode: bool = False) -> Dict[str, Spec]:
    b_axes = batch_axes(mesh)
    total = 1
    for a in b_axes:
        total *= mesh.shape[a]
    b_spec = b_axes if shape.global_batch % total == 0 and \
        shape.global_batch >= total else None
    out: Dict[str, Spec] = {}
    if decode:
        out["token"] = _spec(b_spec)
    else:
        out["tokens"] = _spec(b_spec, None)
        out["labels"] = _spec(b_spec, None)
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = _spec(b_spec, None, None)
    if cfg.vision_embed_dim:
        out["vision_embeds"] = _spec(b_spec, None, None)
    return out


def to_shardings(tree_specs, mesh: Mesh):
    """Each spec of ``tree_specs`` (dicts, lists, NamedTuples of spec
    tuples) as the device that holds its tensor: on one card, the mesh's
    one device."""
    if len(mesh.devices) != 1:
        raise ValueError(f"the port runs on one device; the mesh has "
                         f"{len(mesh.devices)}")
    dev = mesh.devices[0]

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, AdamWState):
            return AdamWState(*(walk(v) for v in t))
        return dev
    return walk(tree_specs)
