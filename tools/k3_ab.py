#!/usr/bin/env python3
"""K3 (the fused gated FFN, bf16) at the served shapes for one checkout.

Run from the repo root on a machine with one H100::

    python3 tools/k3_ab.py [--root DIR] [--shapes decode|prefill]

``DIR`` (default: this checkout) is the checkout whose ``src/`` is
imported and whose kernels are built, so two commits are compared by
running the script once with each root in one call (A, B, B, A): the
route that the root's ``ffn_plan`` picks is the one timed.  The shape
sets:

* ``decode`` (the default): M 8 at the dense families' FFNs,
  zamba2-1.2b's shared FFN, and D 7168 at F 16896, where ``F / 64``
  blocks make one full wave of two an SM;
* ``prefill``: the prefill bursts of the dense families and
  internvl2-26b, zamba2-1.2b's train step and burst, 32 and 64 rows at
  yi-34b's and internvl2-26b's widths (a decode step of 32 slots), and
  paper-backbone's D 256 at M 1024 and 16384; then internvl2-26b's
  8 x 512 VLM prefill at full width (48 layers, 256 patch embeddings,
  bf16 weights drawn on the card from a seed): ``event_ms`` over 3
  calls after one (as ``chip_smoke.py`` phase 12a times it) and
  ``device_ms`` (null where the profiler lost events).

It prints one JSON line: the card's name and power limit, and for each
shape the route, ``event_ms`` (CUDA events over back-to-back calls),
``device_ms`` (the profiler's kernel time a call, the largest of three
windows whose kernel counts are whole multiples of the window's calls,
else null), the unfused cuBLAS chain ``(act(x Wg) * (x Wu)) Wd``'s two
times, the bound (the larger of 6 M D F operations at 989 TFLOP/s and
the bytes of x, the three weights and y once at 3.35 TB/s) and what
bounds it, ``share`` (bound over device time), ``per_chain`` (device
time over the chain's) and ``us_per_weight_mb`` (device time over the
weight MB); the event times stand in where a device time is null.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ab_timing import card, device_ms, event_ms

# (label, M, D, F, activation)
DECODE = tuple((label, 8, d, f, act) for label, d, f, act in (
    ("yi-34b", 7168, 20480, "silu"),
    ("qwen1.5-32b", 5120, 27392, "silu"),
    ("internvl2-26b", 6144, 16384, "silu"),
    ("gemma-7b", 3072, 24576, "gelu"),
    ("gemma3-12b", 3840, 15360, "gelu"),
    ("phi3-mini", 3072, 8192, "silu"),
    ("zamba2-1.2b", 2048, 8192, "gelu"),
    ("one wave", 7168, 16896, "silu")))
PREFILL = (("gemma3-12b", 16384, 3840, 15360, "gelu"),
           ("yi-34b", 4096, 7168, 20480, "silu"),
           ("internvl2-26b", 4096, 6144, 16384, "silu"),
           ("qwen1.5-32b", 1024, 5120, 27392, "silu"),
           ("gemma-7b", 4096, 3072, 24576, "gelu"),
           ("phi3-mini", 4096, 3072, 8192, "silu"),
           ("zamba2-1.2b train", 4096, 2048, 8192, "gelu"),
           ("zamba2-1.2b", 8192, 2048, 8192, "gelu"),
           ("internvl2-26b M 2048", 2048, 6144, 16384, "silu"),
           ("yi-34b M 32", 32, 7168, 20480, "silu"),
           ("yi-34b M 64", 64, 7168, 20480, "silu"),
           ("internvl2-26b M 32", 32, 6144, 16384, "silu"),
           ("internvl2-26b M 64", 64, 6144, 16384, "silu"),
           ("paper-backbone M 1024", 1024, 256, 1024, "silu"),
           ("paper-backbone M 16384", 16384, 256, 1024, "silu"))
SHAPES = {"decode": DECODE, "prefill": PREFILL}
# calls a profiler window
WINDOW = {"decode": 50, "prefill": 20}
FLOPS_PER_S, BYTES_PER_S = 989e12, 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="decode")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.fused_ffn import ffn_plan, fused_ffn

    smi = card()
    card = torch.Generator(device="cuda").manual_seed(3030)

    def normal(shape, std):
        return torch.randn(shape, generator=card, device="cuda").mul_(
            std).to(torch.bfloat16)

    rows = {}
    for label, m, d, f, act in SHAPES[args.shapes]:
        x = normal((m, d), 1.0)
        wg, wu = normal((d, f), d ** -0.5), normal((d, f), d ** -0.5)
        wd = normal((f, d), f ** -0.5)
        fa = (F.silu if act == "silu"
              else (lambda t: F.gelu(t, approximate="tanh")))
        flops = 6 * m * d * f
        iters = max(5, min(100, int(2e12 / flops)))
        window = min(iters, WINDOW[args.shapes])

        def kernel():
            return fused_ffn(x, wg, wu, wd, act)

        def chain():
            return (fa(x @ wg) * (x @ wu)) @ wd

        weight_bytes = 3 * d * f * 2
        bytes_ms = 1e3 * (weight_bytes + 4 * m * d) / BYTES_PER_S
        ops_ms = 1e3 * flops / FLOPS_PER_S
        row = dict(m=m, d=d, f=f, activation=act,
                   route=ffn_plan(torch.bfloat16, m, d, f).route,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   event_ms=event_ms(kernel, iters),
                   device_ms=device_ms(kernel, window, "fused_ffn"),
                   chain_event_ms=event_ms(chain, iters),
                   chain_device_ms=device_ms(chain, window))
        kernel_ms = row["device_ms"] or row["event_ms"]
        chain_ms = row["chain_device_ms"] or row["chain_event_ms"]
        row["share"] = row["bound_ms"] / kernel_ms
        row["per_chain"] = kernel_ms / chain_ms
        row["us_per_weight_mb"] = 1e3 * kernel_ms / (weight_bytes / 1e6)
        rows[label] = row
        del x, wg, wu, wd
        torch.cuda.empty_cache()
    result = {"root": str(args.root), "card": smi, "shapes": rows}
    if args.shapes == "prefill":
        result["internvl2-26b prefill 8 x 512"] = vlm_prefill(
            torch, event_ms, device_ms)
    print(json.dumps(result))
    return 0


def vlm_prefill(torch, event_ms, device_ms):
    """internvl2-26b's 8 x 512 prefill at full width, as ``chip_smoke.py``
    phase 12a runs it: 256 stub patch embeddings, then text."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_cache, prefill
    from repro_torch.models.transformer import param_tree
    cfg = get_config("internvl2-26b")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(shape, std, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=dt).mul_(std)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device="cuda")

    params = param_tree(cfg, normal, zeros)
    b, s = 8, 512
    rng = np.random.default_rng(120)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32)).cuda()
    vis = torch.from_numpy((rng.standard_normal(
        (b, cfg.num_vision_tokens, cfg.vision_embed_dim)) * 0.1).astype(
            np.float32)).cuda()

    def run():
        return prefill(params, cfg, tokens, init_cache(cfg, b, s + 64),
                       vision_embeds=vis)

    with torch.no_grad():
        logits, _ = run()
        if not bool(torch.isfinite(
                logits[..., :cfg.vocab_size].float()).all()):
            raise AssertionError("internvl2-26b prefill: logits not finite")
        del logits
        out = {"layers": cfg.num_layers, "event_ms": event_ms(run, 3, 1),
               "device_ms": device_ms(run, 3, tries=3)}
    del params
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
