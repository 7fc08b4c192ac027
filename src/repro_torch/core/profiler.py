"""Runtime performance profiler (paper §III-D1, Eq. 1 / Eq. 2) and the
roofline terms.

Two estimation modes, exactly as the paper splits them:

offline  — unit costs are measured/fixed per platform: σ1:σ2:σ3:σSM =
           1:6:200:2 (energy of MAC : cache : DRAM : shared-mem access) and
           the λ latency analogues.  On the GPU the "cache" is on-chip
           reuse (shared memory, registers, L2) and ε becomes the fraction
           of operand bytes served from it.

online   — per-layer C_l (MACs) and M_l (bytes) come from the *current*
           elastic variant's architecture; ε and arithmetic intensity δ
           are the engine configuration's (``ActionEvaluator``).

The same module computes the three roofline terms (compute / memory /
collective), and keeps the JAX package's parsers of XLA's HLO text
(collective bytes of a compiled program, with the layer scan's
while-body trip count): pure regex and config arithmetic, which read a
program that a JAX dry-run printed.  The port's one-card planner
(``launch/dryrun.py``) compiles no XLA program, so its collective term
is 0.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.configs import LOCAL, MAMBA, InputShape, ModelConfig


# ------------------------------------------------------- hardware profiles --
@dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link
    hbm_bytes: float           # per chip
    idle_w: float = 80.0
    peak_w: float = 250.0
    # paper Eq.(1) unit-cost ratios (MAC : cache : DRAM : shared)
    sigma: Tuple[float, float, float, float] = (1.0, 6.0, 200.0, 2.0)
    # Eq.(2) latency unit ratios
    lam: Tuple[float, float, float] = (1.0, 6.0, 200.0)


# One NVIDIA H100 SXM (80 GB HBM3).
H100_SXM = HardwareProfile(
    name="h100_sxm",
    peak_flops=989e12,     # bf16 tensor cores, dense: H100 SXM data sheet
    hbm_bw=3.35e12,        # HBM3: H100 SXM data sheet
    ici_bw=450e9,          # NVLink 4, 900 GB/s both ways together: data sheet
    hbm_bytes=80e9,        # HBM3 capacity: H100 SXM data sheet
    # power.draw of the idle card, as chip_smoke.py phase 1 reads it
    # (nvidia-smi on an "NVIDIA H100 80GB HBM3" with a 700 W limit)
    idle_w=72.45,
    peak_w=700.0)          # power.limit that nvidia-smi reports on the card

# The paper's simulated mobile device (its figures are the simulation's,
# not a measurement).
MOBILE_CPU = HardwareProfile(
    name="mobile_cpu", peak_flops=12e9, hbm_bw=4e9, ici_bw=12.5e6,
    hbm_bytes=2e9, idle_w=1.0, peak_w=5.0,
    sigma=(1.0, 6.0, 200.0, 0.0), lam=(1.0, 6.0, 200.0))


# ------------------------------------------------- measurement calibration --
@dataclass(frozen=True)
class Calibration:
    """Back-end→front-end feedback: an affine correction mapping the
    analytical Eq.(1)/(2) estimates onto *observed* step measurements.

    Produced by :class:`repro_torch.fleet.telemetry.TelemetryStore` from
    runtime measurements and installed into the profiler/optimizer (the
    loop the paper centers on: "feeding back runtime performance from the
    back-end level to the front-end level optimization decision")."""
    latency_scale: float = 1.0
    latency_bias_s: float = 0.0
    energy_scale: float = 1.0
    samples: int = 0

    def latency(self, pred_s: float) -> float:
        return max(self.latency_scale * pred_s + self.latency_bias_s, 1e-12)

    def energy(self, pred_j: float) -> float:
        return max(self.energy_scale * pred_j, 0.0)


# ---------------------------------------------------- per-layer cost model --
@dataclass
class LayerCost:
    name: str
    macs: float           # C_l
    bytes: float          # M_l (params + activations touched)


def layer_costs(cfg: ModelConfig, batch: int, seq: int, decode: bool = False,
                dtype_bytes: int = 2, kv_bytes: int = 2) -> List[LayerCost]:
    """C_l and M_l per layer for the current (possibly elastic) config.

    The paper notes the unit set differs per family: transformer units are
    the QKV/O projections + FFN; Mamba units are in/out projections + SSD."""
    t = batch * (1 if decode else seq)
    hd = cfg.resolved_head_dim
    out: List[LayerCost] = []
    for li, kind in enumerate(cfg.block_pattern()):
        if kind == MAMBA:
            di = cfg.ssm_d_inner
            in_dim = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state_dim \
                + cfg.ssm_num_heads
            macs = t * (cfg.d_model * in_dim + di * cfg.d_model
                        + 6 * cfg.ssm_num_heads * cfg.ssm_head_dim
                        * cfg.ssm_state_dim)
            mbytes = (cfg.d_model * in_dim + di * cfg.d_model) * dtype_bytes \
                + 2 * t * cfg.d_model * dtype_bytes
            out.append(LayerCost(f"l{li}.mamba", macs, mbytes))
            continue
        window = cfg.sliding_window if kind == LOCAL else 0
        ctx = min(seq, window) if window else seq
        attn_ctx = ctx if (window or decode) else seq / 2
        macs = t * (cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
                    + cfg.q_dim * cfg.d_model
                    + 2 * cfg.num_heads * hd * attn_ctx)
        mbytes = (cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
                  + cfg.q_dim * cfg.d_model) * dtype_bytes \
            + 2 * t * cfg.d_model * dtype_bytes
        if decode:
            mbytes += batch * seq * 2 * cfg.kv_dim * kv_bytes  # KV read
        out.append(LayerCost(f"l{li}.attn", macs, mbytes))
        if cfg.arch_type == "moe":
            active = cfg.experts_per_token + (1 if cfg.moe_shared_expert else 0)
            mats = 3 if cfg.gated_ffn else 2
            macs = t * (mats * active * cfg.d_model * cfg.d_ff
                        + cfg.d_model * cfg.num_experts)
            # decode touches only routed experts' weights; prefill touches all
            touched = active if decode else cfg.num_experts
            mbytes = mats * touched * cfg.d_model * cfg.d_ff * dtype_bytes
        else:
            mats = 3 if cfg.gated_ffn else 2
            macs = t * mats * cfg.d_model * cfg.d_ff
            mbytes = mats * cfg.d_model * cfg.d_ff * dtype_bytes \
                + 2 * t * cfg.d_ff * dtype_bytes
        out.append(LayerCost(f"l{li}.ffn", macs, mbytes))
    if cfg.is_encoder_decoder:
        # decoder cross-attention (per decoder layer) + the encoder stack
        se = cfg.encoder_seq_len
        for li in range(cfg.num_layers):
            macs = t * (cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
                        + cfg.q_dim * cfg.d_model
                        + 2 * cfg.num_heads * hd * se)
            mbytes = (cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
                      + cfg.q_dim * cfg.d_model) * dtype_bytes                 + 2 * t * cfg.d_model * dtype_bytes
            out.append(LayerCost(f"l{li}.cross", macs, mbytes))
        te = batch * se
        mats = 3 if cfg.gated_ffn else 2
        # the encoder runs once per REQUEST, not per decode step
        for li in range(0 if decode else cfg.encoder_layers):
            macs = te * (cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
                         + cfg.q_dim * cfg.d_model
                         + 2 * cfg.num_heads * hd * se
                         + mats * cfg.d_model * cfg.d_ff)
            mbytes = ((cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
                       + cfg.q_dim * cfg.d_model
                       + mats * cfg.d_model * cfg.d_ff) * dtype_bytes
                      + 2 * te * cfg.d_model * dtype_bytes)
            out.append(LayerCost(f"enc{li}", macs, mbytes))
    out.append(LayerCost("lm_head", t * cfg.d_model * cfg.vocab_size,
                         cfg.d_model * cfg.vocab_size * dtype_bytes))
    return out


# --------------------------------------------------------------- Eq 1 & 2 --
def estimate_energy(costs: List[LayerCost], eps: float,
                    hw: HardwareProfile = H100_SXM) -> float:
    """Paper Eq. (1): E = Σ σ1·C_l + ε·σ2·M_l + (1-ε)·σ3·M_l + σSM·M_l.

    Returned in joules: the σ ratios are anchored so that one MAC at peak
    utilization costs peak_w / peak_flops joules.  Telemetry-learned
    ``Calibration`` corrections are applied one level up, in
    ``ActionEvaluator.evaluate`` — a single application point."""
    s1, s2, s3, ssm = hw.sigma
    unit = hw.peak_w / hw.peak_flops      # J per MAC-equivalent
    e = 0.0
    for lc in costs:
        e += s1 * lc.macs + eps * s2 * lc.bytes + (1 - eps) * s3 * lc.bytes \
            + ssm * lc.bytes
    return e * unit


def estimate_latency(costs: List[LayerCost], eps: float,
                     hw: HardwareProfile = H100_SXM,
                     effective_flops: Optional[float] = None) -> float:
    """Paper Eq. (2): T = Σ λ1·δ_l·C_l + ε·λ2·M_l + (1-ε)·λ3·M_l.

    δ_l (arithmetic intensity C_l/M_l) modulates how efficiently compute
    hides memory traffic; we realize λ1·δ_l·C_l as compute time at an
    efficiency that saturates with δ (roofline knee)."""
    flops = effective_flops or hw.peak_flops
    lam1, lam2, lam3 = hw.lam
    t = 0.0
    knee = hw.peak_flops / hw.hbm_bw      # FLOPs per byte at the ridge
    for lc in costs:
        delta = lc.macs / max(lc.bytes, 1.0)
        eff = min(1.0, delta / knee)      # below the knee: bandwidth-bound
        t += lam1 * (2 * lc.macs) / (flops * max(eff, 1e-3))
        # memory term: a hit costs λ2/λ3 of the full-miss (DRAM/HBM) time
        mem_t_miss = lc.bytes / hw.hbm_bw
        t += (eps * lam2 / lam3 + (1 - eps)) * mem_t_miss
    return t


def rank_consistency(est: List[float], actual: List[float]) -> float:
    """Spearman rank correlation — the paper's stated profiler goal is
    consistent *ranking*, not absolute accuracy."""
    e = np.argsort(np.argsort(est)).astype(float)
    a = np.argsort(np.argsort(actual)).astype(float)
    if len(e) < 2:
        return 1.0
    n = len(e)
    return float(1 - 6 * np.sum((e - a) ** 2) / (n * (n ** 2 - 1)))


# ------------------------------------------------------------- roofline ----
@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_compute_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)


def roofline_terms(hlo_flops: float, hlo_bytes: float,
                   collective_bytes: float, chips: int,
                   model_flops: float = 0.0,
                   hw: HardwareProfile = H100_SXM) -> RooflineTerms:
    """The three §Roofline terms, in seconds (whole-step, chips aggregate).

    The inputs are whole-job totals (the field names keep the JAX
    package's ``hlo_`` prefix), divided over the ``chips``."""
    return RooflineTerms(
        compute_s=hlo_flops / (chips * hw.peak_flops),
        memory_s=hlo_bytes / (chips * hw.hbm_bw),
        collective_s=collective_bytes / (chips * hw.ici_bw),
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes, model_flops=model_flops,
        chips=chips)


def analytic_step_costs(cfg: ModelConfig, shape: InputShape,
                        remat: str = "none", kv_bytes: int = 2,
                        decode_window: int = 0) -> Tuple[float, float]:
    """(flops, hbm_bytes) for one whole step from the per-layer model.

    Training flops = fwd(2C) + bwd(4C) + remat recompute; bytes = weight
    traffic per pass + activation/KV traffic from the per-layer model."""
    decode = shape.kind == "decode"
    eff_seq = shape.seq_len
    if decode and decode_window:
        eff_seq = min(shape.seq_len, decode_window)   # windowed KV reads
    costs = layer_costs(cfg, shape.global_batch, eff_seq, decode=decode,
                        kv_bytes=kv_bytes)
    fwd_flops = sum(2.0 * c.macs for c in costs)
    fwd_bytes = sum(c.bytes for c in costs)
    if shape.kind == "train":
        overhead = {"none": 0.0, "dots": 0.18, "full": 0.33}.get(remat, 0.0)
        flops = fwd_flops * 3.0 * (1.0 + overhead)
        nbytes = fwd_bytes * (3.0 + (1.0 if remat != "none" else 0.0))
    else:
        flops = fwd_flops
        nbytes = fwd_bytes
    return flops, nbytes


def model_flops_estimate(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS: 6·N·D for training (fwd+bwd), 2·N_active·D for
    inference, D = tokens processed this step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: one token per seq


# ------------------------------------------------------ XLA HLO parsers ----
_SHAPE_RE = re.compile(r"(bf16|f32|f16|s32|u32|s8|u8|pred|f64|s64|u64)"
                       r"\[([0-9,]*)\]")
_DTYPE_BYTES = {"bf16": 2, "f16": 2, "f32": 4, "f64": 8, "s32": 4, "u32": 4,
                "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8}
# result shape(s) appear between '=' and the op name; layouts {2,1,0} and
# tuple shapes are tolerated.  -start/-done async pairs: count -start only.
_COLL_LINE = re.compile(
    r"=\s*(?P<shapes>[^=]*?)\s*"
    r"(?P<kind>all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?P<suffix>-start|-done)?\(")


def _line_collective_bytes(line: str):
    m = _COLL_LINE.search(line)
    if not m or m.group("suffix") == "-done":
        return None
    kind = m.group("kind")
    nbytes = 0.0
    for dt, dims in _SHAPE_RE.findall(m.group("shapes")):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        nbytes += n * _DTYPE_BYTES.get(dt, 2)
    return kind, nbytes


def collective_bytes_from_hlo(hlo_text: str) -> Dict[str, float]:
    """Parse lowered/compiled HLO text, summing result bytes of every
    collective op.  Returns per-kind byte totals (one shard's program)."""
    totals: Dict[str, float] = {}
    for line in hlo_text.splitlines():
        r = _line_collective_bytes(line.strip())
        if r is None:
            continue
        kind, nbytes = r
        totals[kind] = totals.get(kind, 0.0) + nbytes
    return totals


def collective_bytes_scan_corrected(hlo_text: str, trip_count: int
                                    ) -> Dict[str, float]:
    """Collective bytes with while-body correction.

    XLA's printed HLO lists each while-body computation once; collectives
    inside computations referenced as ``body=%name`` execute ``trip_count``
    times (the layer scan), so their bytes are multiplied accordingly.
    Returns per-kind totals for ONE shard's program."""
    body_names = set(re.findall(r"body=%([\w.\-]+)", hlo_text))
    totals: Dict[str, float] = {}
    cur_name = ""
    header = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{\s*$")
    for line in hlo_text.splitlines():
        stripped = line.strip()
        m = header.match(stripped)
        if m and "{" in line:
            cur_name = m.group(1)
        mult = trip_count if cur_name in body_names else 1
        r = _line_collective_bytes(stripped)
        if r is None:
            continue
        kind, nbytes = r
        totals[kind] = totals.get(kind, 0.0) + nbytes * mult
    return totals


def scan_trip_count(cfg: ModelConfig) -> int:
    """Layer-scan trip count (periods) for while-body cost correction."""
    if cfg.arch_type == "hybrid":
        period = cfg.shared_attn_period or cfg.num_layers
    elif cfg.local_global_ratio:
        period = cfg.local_global_ratio + 1
    else:
        period = 1
    return max(1, cfg.num_layers // period)
