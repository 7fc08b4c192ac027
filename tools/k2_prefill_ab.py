#!/usr/bin/env python3
"""K2's host cost a launch, and the prefills it shows in, for one checkout.

Run from the repo root on a machine with one H100::

    python3 tools/k2_prefill_ab.py [--root DIR]

``DIR`` (default: this checkout) is the checkout whose ``src/`` is
imported and whose kernels are built, so two commits are compared by
running the script once with each root in one call (A, B, B, A).  It
prints one JSON line:

* ``k2``: ``flash_attention`` alone, bf16, at the two served shapes
  whose launches are small (qwen1.5-32b's 8 x 128 prefill, 40 heads of
  128; whisper-small's cross-attention, 8 x 16 queries over 1500 keys,
  12 heads of 64): ``event_ms``, CUDA events over 200 back-to-back calls,
  and ``issue_us``, the host's time to issue one call (200 calls with no
  sync between them, then one sync, over 200);
* ``whisper-small`` (full width) and ``qwen1.5-32b`` (full width, depth
  cut to 8 layers): ``init_cache`` + ``prefill`` of 8 prompts (16 tokens
  with 8 x 1500 stub frames; 128 tokens), bf16 weights drawn on the card
  from a seed; ``wall_ms``, the host's time from a synchronized start to
  a synchronized end, median and min of 100 calls after 3 warm-up calls;
  ``issue_ms``, the same calls' host time from that start until
  ``prefill`` returns (its median); ``event_ms`` over 10 back-to-back
  calls.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from ab_timing import card, event_ms as _event_ms, issue_us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.models.model import init_cache, prefill
    from repro_torch.models.transformer import param_tree

    def wall_ms(fn, iters=100, warmup=3):
        for _ in range(warmup):
            fn()
        times, issued = [], []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            issued.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times), min(times), statistics.median(issued)

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"root": str(root), "card": card(), "k2": {}}

    def event_ms(fn, iters):
        return _event_ms(fn, iters, warmup=1)

    def qkv(b, sq, sk, h, hd):
        # the model's (B, S, H, hd) tensors as (B, H, S, hd) views
        return [torch.randn(b, n, h, hd, generator=gen, device="cuda",
                            dtype=torch.bfloat16).transpose(1, 2)
                for n in (sq, sk, sk)]

    for label, (b, sq, sk, h, hd, causal) in {
            "qwen1.5-32b 8 x 128": (8, 128, 128, 40, 128, True),
            "whisper-small cross 8 x 16 over 1500": (8, 16, 1500, 12, 64,
                                                     False)}.items():
        q, k, v = qkv(b, sq, sk, h, hd)

        def call():
            return flash_attention(q, k, v, causal=causal)

        result["k2"][label] = {"event_ms": event_ms(call, 200),
                               "issue_us": issue_us(call)}

    rng = np.random.default_rng(7)
    for name, layers, s in (("whisper-small", None, 16),
                            ("qwen1.5-32b", 8, 128)):
        cfg = get_config(name)
        if layers is not None:
            cfg = cfg.with_updates(num_layers=layers)

        def normal(shape, std, dt=torch.bfloat16):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=dt).mul_(std)

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.bfloat16, device="cuda")

        params = param_tree(cfg, normal, zeros)
        params = _to(params, "cuda")
        b = 8
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                  .astype(np.int32)).cuda()
        kw = {}
        if cfg.encoder_layers:
            kw["encoder_frames"] = torch.from_numpy((rng.standard_normal(
                (b, cfg.encoder_seq_len, cfg.d_model)) * 0.1).astype(
                    np.float32)).cuda()

        def run():
            return prefill(params, cfg, tokens, init_cache(cfg, b, s + 16),
                           **kw)

        with torch.no_grad():
            before = flash_attention.launches
            logits, _ = run()
            launches = flash_attention.launches - before
            if not bool(torch.isfinite(logits.float()).all()):
                raise AssertionError(f"{name}: logits not finite")
            med, low, issued = wall_ms(run)
            result[name] = {"layers": cfg.num_layers, "prompts": f"{b} x {s}",
                            "k2_launches": launches, "wall_ms": med,
                            "wall_min_ms": low, "issue_ms": issued,
                            "event_ms": event_ms(run, 10)}
        del params, logits
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
