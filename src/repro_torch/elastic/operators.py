"""The paper's six compression-operator families (η1…η6), adapted from
mobile CNNs to transformer supernets.

Every operator is a *retraining-free* transformation
``(cfg, params) -> (variant_cfg, variant_params)`` whose variant weights are
derived from (recycled out of) the backbone weights — slicing, SVD
factorization, head merging, ghost-feature mapping.  This is the paper's
"weight recycling across diverse variants": switching variants at runtime
never touches an optimizer.

  η1  low-rank factorization   (SVD of FFN projections)
  η2  channel merging          (Fire/squeeze analogue: KV-head mean-merge)
  η3  composite scaling        (EfficientNet-style compound width/depth)
  η4  ghost features           (compute half the FFN hidden, map the rest)
  η5  depth scaling            (layer slicing + early exits)
  η6  channel scaling          (importance-ordered FFN + Q-head slicing)

The operators run on the device of the backbone's tensors, in f32 where
they compute (importances, SVD, ghost scales) and in each leaf's dtype
where they only select or average.  Every leaf they return is
contiguous, so the fused FFN and flash attention kernels take the
variant's weights as they are.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..models.configs import ModelConfig
from ..models.layers import Params, tree_map

OPERATOR_NAMES = ("eta1", "eta2", "eta3", "eta4", "eta5", "eta6")


@dataclass(frozen=True)
class VariantSpec:
    """A point in the elastic action space θ_p."""
    rank_ratio: float = 1.0       # η1: SVD rank fraction of FFN projections
    kv_merge: int = 1             # η2: merge factor for KV heads
    compound: float = 0.0         # η3: EfficientNet-style φ (0 = off)
    ghost: bool = False           # η4: ghost-FFN on/off
    depth_ratio: float = 1.0      # η5: fraction of layers kept
    width_ratio: float = 1.0      # η6: fraction of FFN hidden kept
    head_ratio: float = 1.0       # η6: fraction of Q heads kept
    window: int = 0               # window override (0 = arch default)

    def operators(self) -> Tuple[str, ...]:
        ops = []
        if self.rank_ratio < 1.0:
            ops.append("eta1")
        if self.kv_merge > 1:
            ops.append("eta2")
        if self.compound > 0:
            ops.append("eta3")
        if self.ghost:
            ops.append("eta4")
        if self.depth_ratio < 1.0:
            ops.append("eta5")
        if self.width_ratio < 1.0 or self.head_ratio < 1.0:
            ops.append("eta6")
        return tuple(ops)

    def replace(self, **kw) -> "VariantSpec":
        return dataclasses.replace(self, **kw)


FULL_SPEC = VariantSpec()

# named combinations used throughout the paper's tables (η1+η6 etc.)
NAMED_COMBOS: Dict[str, VariantSpec] = {
    "eta1+eta6": VariantSpec(rank_ratio=0.5, width_ratio=0.5),
    "eta2+eta6": VariantSpec(kv_merge=2, width_ratio=0.5),
    "eta1+eta5": VariantSpec(rank_ratio=0.5, depth_ratio=0.75),
    "eta2+eta5": VariantSpec(kv_merge=2, depth_ratio=0.75),
    "eta4+eta6": VariantSpec(ghost=True, width_ratio=0.75),
    "eta3": VariantSpec(compound=1.0),
}


def _round8(x: float) -> int:
    return max(8, int(round(x / 8)) * 8)


# --------------------------------------------------------------- η helpers --
def _svd_factor(w: torch.Tensor, rank: int) -> Dict[str, torch.Tensor]:
    """Rank-``rank`` factors ``u (d_in, r)``, ``v (r, d_out)`` of ``w``
    from its f32 SVD (singular values folded into ``u``)."""
    u, s, vt = torch.linalg.svd(w.float(), full_matrices=False)
    rank = min(rank, s.shape[0])
    return {"u": (u[:, :rank] * s[:rank]).to(w.dtype).contiguous(),
            "v": vt[:rank].to(w.dtype).contiguous()}


def _ffn_channel_importance(layer_ffn: Dict[str, torch.Tensor]
                            ) -> torch.Tensor:
    """Per-hidden-channel importance = ||w_up col|| * ||w_down row||
    (times ||w_gate col|| for a gated FFN), in f32."""
    imp = (torch.linalg.vector_norm(layer_ffn["w_up"].float(), dim=0)
           * torch.linalg.vector_norm(layer_ffn["w_down"].float(), dim=1))
    if "w_gate" in layer_ffn:
        imp = imp * torch.linalg.vector_norm(layer_ffn["w_gate"].float(),
                                             dim=0)
    return imp


def _head_importance(wo: torch.Tensor, num_heads: int,
                     head_dim: int) -> torch.Tensor:
    return torch.linalg.vector_norm(wo.float().reshape(num_heads, -1), dim=1)


def _descending(imp: torch.Tensor) -> torch.Tensor:
    """Indices of ``imp`` from the largest to the smallest (last axis)."""
    return torch.argsort(-imp, dim=-1, stable=True)


def _dense_ffn_leaves(ffn: Params, li: int) -> Dict[str, torch.Tensor]:
    return {k: v[li] for k, v in ffn.items() if not isinstance(v, dict)}


# ------------------------------------------------------------ the operators --
def apply_eta1_lowrank(cfg: ModelConfig, layers: Params, ratio: float
                       ) -> Params:
    """SVD-factorize stacked FFN up/gate/down projections to rank r."""
    out = dict(layers)
    ffn = dict(layers["ffn"])
    d, f = cfg.d_model, cfg.d_ff
    rank = _round8(ratio * (d * f) / (d + f))  # FLOP-equalized rank
    for name in ("w_gate", "w_up", "w_down"):
        if name not in ffn or isinstance(ffn[name], dict):
            continue
        facs = [_svd_factor(w, rank) for w in ffn[name]]
        ffn[name] = {"u": torch.stack([fa["u"] for fa in facs]),
                     "v": torch.stack([fa["v"] for fa in facs])}
    out["ffn"] = ffn
    return out


def apply_eta2_kv_merge(cfg: ModelConfig, layers: Params, merge: int
                        ) -> Tuple[ModelConfig, Params]:
    """Mean-merge groups of KV heads (GQA-ification, retraining-free)."""
    if cfg.num_kv_heads % merge:
        raise ValueError(f"kv={cfg.num_kv_heads} not divisible by {merge}")
    new_kv = cfg.num_kv_heads // merge
    hd = cfg.resolved_head_dim
    out = dict(layers)
    attn = dict(layers["attn"])
    for name in ("wk", "wv"):
        w = attn[name]                           # (L, d, kv*hd)
        l, d, _ = w.shape
        attn[name] = w.reshape(l, d, new_kv, merge, hd).mean(dim=3).reshape(
            l, d, new_kv * hd)
    for name in ("bk", "bv"):
        if name in attn:
            b = attn[name].reshape(-1, new_kv, merge, hd)
            attn[name] = b.mean(dim=2).reshape(-1, new_kv * hd)
    out["attn"] = attn
    return cfg.with_updates(num_kv_heads=new_kv), out


def apply_eta4_ghost(cfg: ModelConfig, layers: Params
                     ) -> Tuple[ModelConfig, Params]:
    """GhostNet-style FFN: keep the important half of hidden channels,
    generate the dropped half as scaled copies of their nearest kept
    channel (cosine similarity of w_up columns)."""
    out = dict(layers)
    ffn = dict(layers["ffn"])
    keep_n = cfg.d_ff // 2
    w_up = ffn["w_up"].float()                            # (L, d, f)
    l = w_up.shape[0]
    imp = torch.stack([_ffn_channel_importance(_dense_ffn_leaves(ffn, li))
                       for li in range(l)])               # (L, f)
    order = _descending(imp)
    keep, drop = order[:, :keep_n], order[:, keep_n:]
    src_idx, scales = [], []
    new = {k: [] for k in ffn}
    for li in range(l):
        cols = w_up[li][:, keep[li]]                      # (d, keep)
        cols_n = cols / (torch.linalg.vector_norm(cols, dim=0, keepdim=True)
                         + 1e-9)
        dcols = w_up[li][:, drop[li]]
        sim = cols_n.T @ dcols                            # (keep, drop)
        nearest = torch.argmax(sim.abs(), dim=0)
        # least-squares scale: <kept, dropped> / <kept, kept>
        kn = cols[:, nearest]
        src_idx.append(nearest)
        scales.append((kn * dcols).sum(0) / ((kn * kn).sum(0) + 1e-9))
        for name in ("w_gate", "w_up"):
            if name in ffn:
                new[name].append(ffn[name][li][:, keep[li]])
        new["w_down"].append(ffn["w_down"][li][order[li], :])
    ffn2 = {name: torch.stack(new[name]) for name in ("w_gate", "w_up")
            if name in ffn}
    ffn2["w_down"] = torch.stack(new["w_down"])
    ffn2["ghost_src"] = torch.stack(src_idx).to(torch.int32)
    ffn2["ghost_scale"] = torch.stack(scales)
    out["ffn"] = ffn2
    return cfg, out


def apply_eta5_depth(cfg: ModelConfig, params: Params, ratio: float
                     ) -> Tuple[ModelConfig, Params]:
    """Keep the first round(ratio*L) layers (stacked-weight slicing)."""
    n = max(1, int(round(cfg.num_layers * ratio)))
    out = dict(params)
    out["layers"] = tree_map(lambda a: a[:n], params["layers"])
    return cfg.with_updates(num_layers=n), out


def apply_eta6_channels(cfg: ModelConfig, layers: Params, width_ratio: float,
                        head_ratio: float) -> Tuple[ModelConfig, Params]:
    """Importance-ordered FFN-hidden and Q-head slicing."""
    out = dict(layers)
    new_cfg = cfg
    if width_ratio < 1.0 and "ffn" in layers and cfg.d_ff:
        ffn = dict(layers["ffn"])
        f2 = _round8(cfg.d_ff * width_ratio)
        l = ffn["w_up"].shape[0]
        idx = [_descending(_ffn_channel_importance(
            _dense_ffn_leaves(ffn, li)))[:f2] for li in range(l)]
        for name in ("w_gate", "w_up"):
            if name in ffn:
                ffn[name] = torch.stack([ffn[name][li][:, idx[li]]
                                         for li in range(l)])
        ffn["w_down"] = torch.stack([ffn["w_down"][li][idx[li], :]
                                     for li in range(l)])
        out["ffn"] = ffn
        new_cfg = new_cfg.with_updates(d_ff=f2)
    if head_ratio < 1.0 and cfg.num_heads:
        hd = cfg.resolved_head_dim
        g = cfg.num_heads // cfg.num_kv_heads
        # prune whole GQA groups to keep grouping valid
        new_kvh = max(1, int(round(cfg.num_kv_heads * head_ratio)))
        new_h = new_kvh * g
        attn = dict(out.get("attn", layers["attn"]))
        wo = attn["wo"]                                   # (L, H*hd, d)
        l = wo.shape[0]
        kv_imp = torch.stack([
            _head_importance(wo[li], cfg.num_heads, hd)
            .reshape(cfg.num_kv_heads, g).sum(1) for li in range(l)])
        kv_keep = _descending(kv_imp)[:, :new_kvh]        # (L, new_kvh)

        def take_heads(w, heads_per_kv):
            # w: (L, d, n_kv*heads_per_kv*hd) -> keep kv groups
            d = w.shape[1]
            w = w.reshape(l, d, cfg.num_kv_heads, heads_per_kv * hd)
            return torch.stack([w[li][:, kv_keep[li]] for li in range(l)]
                               ).reshape(l, d, new_kvh * heads_per_kv * hd)
        attn["wq"] = take_heads(attn["wq"], g)
        attn["wk"] = take_heads(attn["wk"], 1)
        attn["wv"] = take_heads(attn["wv"], 1)
        wo = wo.reshape(l, cfg.num_kv_heads, g * hd, -1)
        attn["wo"] = torch.stack([wo[li][kv_keep[li]] for li in range(l)]
                                 ).reshape(l, new_h * hd, -1)
        for name, per in (("bq", g), ("bk", 1), ("bv", 1)):
            if name in attn:
                bias = attn[name].reshape(l, cfg.num_kv_heads, per * hd)
                attn[name] = torch.stack([bias[li][kv_keep[li]]
                                          for li in range(l)]).reshape(l, -1)
        out["attn"] = attn
        new_cfg = new_cfg.with_updates(num_heads=new_h, num_kv_heads=new_kvh)
    return new_cfg, out


# ------------------------------------------------------------- entry point --
@torch.no_grad()
def derive_variant(cfg: ModelConfig, params: Params, spec: VariantSpec
                   ) -> Tuple[ModelConfig, Params]:
    """Materialize an elastic variant (cfg', params') from the backbone.

    Operators inapplicable to a family (e.g. FFN ops on an attention-free
    SSM) are skipped.  Leaves the operators do not touch are the
    backbone's own tensors (no copy)."""
    if spec.compound > 0:
        # η3 compound scaling: α^φ depth, β^φ width (α=0.8, β=0.8)
        spec = spec.replace(
            depth_ratio=min(spec.depth_ratio, 0.8 ** spec.compound),
            width_ratio=min(spec.width_ratio, 0.8 ** spec.compound),
            compound=0.0)
    new_cfg, new_params = cfg, dict(params)
    if spec.depth_ratio < 1.0:
        new_cfg, new_params = apply_eta5_depth(new_cfg, new_params,
                                               spec.depth_ratio)
    has_ffn = new_cfg.d_ff > 0 and new_cfg.arch_type not in ("ssm", "moe")
    has_attn = new_cfg.num_heads > 0 and new_cfg.arch_type not in ("ssm",)
    layers = new_params["layers"]
    if (spec.width_ratio < 1.0 and has_ffn) \
            or (spec.head_ratio < 1.0 and has_attn):
        wr = spec.width_ratio if has_ffn else 1.0
        hr = spec.head_ratio if has_attn and new_cfg.arch_type == "dense" \
            else 1.0
        new_cfg, layers = apply_eta6_channels(new_cfg, layers, wr, hr)
    if spec.kv_merge > 1 and has_attn and new_cfg.arch_type == "dense":
        new_cfg, layers = apply_eta2_kv_merge(new_cfg, layers, spec.kv_merge)
    if spec.ghost and has_ffn:
        new_cfg, layers = apply_eta4_ghost(new_cfg, layers)
    if spec.rank_ratio < 1.0 and has_ffn and "ghost_src" not in layers.get(
            "ffn", {}):
        layers = apply_eta1_lowrank(new_cfg, layers, spec.rank_ratio)
    new_params["layers"] = layers
    if spec.window:
        new_cfg = new_cfg.with_updates(sliding_window=spec.window)
    return new_cfg, new_params


def variant_cost(cfg: ModelConfig, spec: VariantSpec, seq_len: int = 2048
                 ) -> Dict[str, float]:
    """Analytic cost of a variant (no materialization) — used by the
    middleware optimizer to napkin-math candidates before deriving them."""
    c = cfg
    if spec.compound > 0:
        spec = spec.replace(depth_ratio=0.8 ** spec.compound,
                            width_ratio=0.8 ** spec.compound, compound=0.0)
    if spec.depth_ratio < 1.0:
        c = c.with_updates(num_layers=max(1, int(round(c.num_layers
                                                       * spec.depth_ratio))))
    if spec.width_ratio < 1.0 and c.d_ff:
        c = c.with_updates(d_ff=_round8(c.d_ff * spec.width_ratio))
    if spec.head_ratio < 1.0 and c.num_heads and c.arch_type == "dense":
        g = c.num_heads // c.num_kv_heads
        nk = max(1, int(round(c.num_kv_heads * spec.head_ratio)))
        c = c.with_updates(num_kv_heads=nk, num_heads=nk * g)
    if spec.kv_merge > 1 and c.num_kv_heads and c.arch_type == "dense":
        c = c.with_updates(num_kv_heads=max(1, c.num_kv_heads // spec.kv_merge))
    flops = c.flops_per_token(seq_len)
    if spec.rank_ratio < 1.0 and c.d_ff:
        d, f = c.d_model, c.d_ff
        rank = _round8(spec.rank_ratio * (d * f) / (d + f))
        mats = 3 if c.gated_ffn else 2
        dense_ffn = 2.0 * mats * d * f
        lr_ffn = 2.0 * mats * rank * (d + f)
        flops = flops - c.num_layers * (dense_ffn - lr_ffn)
    if spec.ghost and c.d_ff:
        mats = 2 if c.gated_ffn else 1  # up(+gate) halved, down unchanged
        flops = flops - c.num_layers * mats * c.d_model * c.d_ff  # 2*(f/2)
    return {
        "flops_per_token": float(flops),
        "params": float(c.param_count()
                        * (spec.rank_ratio if spec.rank_ratio < 1 else 1.0)),
        "kv_bytes_per_token": float(c.kv_cache_bytes(1, 1)),
    }
