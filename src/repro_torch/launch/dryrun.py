"""One-card planner: what every (architecture × input shape) step needs
on one H100, computed without running it.

The JAX package's dry-run lowers and compiles each step against a
512-device TPU mesh and reads XLA's memory and cost analyses.  One card
has no mesh to shard over and the port compiles no XLA program, so this
planner records, per (arch × shape), from meta-device structs and the
profiler's analytic model alone:

* parameter, optimizer-state (train), gradient (train), cache (prefill /
  decode) and input bytes (:func:`memory_bytes`), and whether they fit
  the card's 80 GB (activations are not counted; the train step's AdamW
  update is donated, so new parameters and moments take no room beside
  the old);
* ``analytic_step_costs`` (scan-trip-exact flops and bytes),
  ``model_flops_estimate`` and the roofline terms on ``H100_SXM``;
* ``scan_trips`` and a collective total of 0 (one device).

``lower_s``, ``compile_s``, ``memory_analysis``, ``cost_analysis`` and
``hlo_lines`` exist only for a compiled XLA program and are left out;
each record lists them under ``left_out``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --out experiments/dryrun_h100
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import get_config, list_archs
from repro_torch.core.profiler import (H100_SXM, analytic_step_costs,
                                       model_flops_estimate, roofline_terms,
                                       scan_trip_count)
from repro_torch.models.configs import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.layers import tree_leaves
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.optim import adamw

from .steps import (cache_spec_struct, input_specs, options_for,
                    params_spec_struct)

LEFT_OUT = {"lower_s": "no XLA program is lowered",
            "compile_s": "no XLA program is compiled",
            "memory_analysis": "XLA's analysis of a compiled program",
            "cost_analysis": "XLA's analysis of a compiled program",
            "hlo_lines": "no HLO text"}


def _nbytes(tree) -> int:
    if isinstance(tree, tuple):          # AdamWState
        return sum(_nbytes(t) for t in tree)
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def memory_bytes(cfg: ModelConfig, shape: InputShape,
                 opts: RuntimeOptions) -> dict:
    """The bytes a step of ``shape`` keeps resident, activations aside:
    parameters and inputs, and gradients and AdamW state (a train step,
    whose update is donated) or the cache; ``"total"`` sums them."""
    pstruct = params_spec_struct(cfg)
    mem = {"params": _nbytes(pstruct),
           "inputs": _nbytes(input_specs(cfg, shape, opts))}
    if shape.kind == "train":
        mem["grads"] = mem["params"]
        mem["opt_state"] = _nbytes(adamw.init(pstruct))
    else:
        mem["cache"] = _nbytes(cache_spec_struct(cfg, shape, opts))
    mem["total"] = sum(mem.values())
    return mem


def run_one(arch: str, shape_name: str, out_dir: Path,
            verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    opts = options_for(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": "1", "chips": 1,
           "device": H100_SXM.name, "kind": shape.kind, "status": "ok",
           "left_out": LEFT_OUT}
    t0 = time.time()
    try:
        mem = memory_bytes(cfg, shape, opts)
        rec["memory_bytes"] = mem
        rec["fits"] = mem["total"] <= H100_SXM.hbm_bytes
        trips = scan_trip_count(cfg)
        rec["collective_bytes"] = {}
        rec["collective_total"] = 0.0
        kv_b = 1 if opts.kv_cache_dtype == "fp8" else 2
        a_flops, a_bytes = analytic_step_costs(
            cfg, shape, remat=opts.remat, kv_bytes=kv_b,
            decode_window=opts.decode_window)
        mflops = model_flops_estimate(cfg, shape)
        rt = roofline_terms(hlo_flops=a_flops, hlo_bytes=a_bytes,
                            collective_bytes=0.0, chips=1,
                            model_flops=mflops, hw=H100_SXM)
        rec["analytic"] = {"flops": a_flops, "bytes": a_bytes,
                           "scan_trips": trips}
        rec["roofline"] = {
            "compute_s": rt.compute_s, "memory_s": rt.memory_s,
            "collective_s": rt.collective_s, "dominant": rt.dominant,
            "model_flops": mflops,
            "useful_compute_ratio": rt.useful_compute_ratio,
        }
    except Exception as e:  # one record per case, the run goes on
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 2)

    out_dir.mkdir(parents=True, exist_ok=True)
    fn = out_dir / f"{arch.replace('.', '_')}__{shape_name}__1.json"
    fn.write_text(json.dumps(rec, indent=2, default=str))
    if verbose:
        r = rec.get("roofline", {})
        m = rec.get("memory_bytes", {})
        print(f"[{rec['status']}] {arch} × {shape_name} × 1 card  "
              f"resident={m.get('total', 0) / 1e9:.1f}GB "
              f"fits={rec.get('fits')} dominant={r.get('dominant')} "
              f"terms=({r.get('compute_s', 0):.3e},"
              f"{r.get('memory_s', 0):.3e})s", flush=True)
        if rec["status"] == "FAIL":
            print(rec["error"], flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="experiments/dryrun_h100")
    args = ap.parse_args()

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    out = Path(args.out)
    failures = 0
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, out)
            failures += rec["status"] != "ok"
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
