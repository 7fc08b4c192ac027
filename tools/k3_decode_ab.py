#!/usr/bin/env python3
"""K3 at the served decode shapes (M 8, bf16) for one checkout.

Run from the repo root on a machine with one H100::

    python3 tools/k3_decode_ab.py [--root DIR]

``DIR`` (default: this checkout) is the checkout whose ``src/`` is
imported and whose kernels are built, so two commits are compared by
running the script once with each root in one call (A, B, B, A): the
route that the root's ``ffn_plan`` picks is the one timed.  It prints one
JSON line: the card's name and power limit, and for each shape (the
dense families' FFNs, zamba2-1.2b's shared FFN, and D 7168 at F 16896,
where ``F / 64`` blocks make one full wave of two an SM) the route,
``event_ms`` (CUDA events over 100 back-to-back calls),
``device_ms`` (the profiler's kernel time a call, the largest of three
windows of 50 calls whose kernel counts are whole multiples of 50, else
null), the unfused cuBLAS chain ``(act(x Wg) * (x Wu)) Wd``'s two times
beside it, the byte bound (the three weights and x read once, y written
once, at 3.35 TB/s) and ``us_per_weight_mb``, the kernel's device time
(its event time where the profiler lost events) over the weight MB.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = (("yi-34b", 7168, 20480, "silu"),
          ("qwen1.5-32b", 5120, 27392, "silu"),
          ("internvl2-26b", 6144, 16384, "silu"),
          ("gemma-7b", 3072, 24576, "gelu"),
          ("gemma3-12b", 3840, 15360, "gelu"),
          ("phi3-mini", 3072, 8192, "silu"),
          ("zamba2-1.2b", 2048, 8192, "gelu"),
          ("one wave", 7168, 16896, "silu"))
M = 8
BYTES_PER_S = 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.fused_ffn import ffn_plan, fused_ffn

    def event_ms(fn, iters=100):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def device_ms(fn, part="", iters=50, tries=6):
        best, whole = None, 0
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            hits = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and part in e.key and e.count]
            if hits and all(e.count % iters == 0 for e in hits):
                ms = sum(e.self_device_time_total for e in hits) / 1e3 / iters
                best = ms if best is None else max(best, ms)
                whole += 1
                if whole == 3:
                    break
        return best

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gen = torch.Generator().manual_seed(2929)
    rows = {}
    for label, d, f, act in SHAPES:
        x = torch.randn(M, d, generator=gen).to(torch.bfloat16).cuda()
        wg, wu = ((torch.randn(d, f, generator=gen) * d ** -0.5)
                  .to(torch.bfloat16).cuda() for _ in range(2))
        wd = (torch.randn(f, d, generator=gen) * f ** -0.5).to(
            torch.bfloat16).cuda()
        fa = (F.silu if act == "silu"
              else (lambda t: F.gelu(t, approximate="tanh")))

        def kernel():
            return fused_ffn(x, wg, wu, wd, act)

        def chain():
            return (fa(x @ wg) * (x @ wu)) @ wd

        weight_bytes = 3 * d * f * 2
        row = dict(d=d, f=f, activation=act,
                   route=ffn_plan(torch.bfloat16, M, d, f).route,
                   event_ms=event_ms(kernel),
                   device_ms=device_ms(kernel, "fused_ffn"),
                   chain_event_ms=event_ms(chain),
                   chain_device_ms=device_ms(chain),
                   bound_ms=1e3 * (weight_bytes + 4 * M * d) / BYTES_PER_S)
        kernel_ms = row["device_ms"] or row["event_ms"]
        row["us_per_weight_mb"] = 1e3 * kernel_ms / (weight_bytes / 1e6)
        rows[label] = row
        del x, wg, wu, wd
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(args.root), "card": smi, "m": M,
                      "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
