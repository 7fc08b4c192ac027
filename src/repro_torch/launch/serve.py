"""Adaptive serving driver: batched requests through the ServingEngine
with the CrowdHMTware loop swapping variants as the context trace
evolves, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 --slots 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import Budgets, Middleware, case_study_trace
from repro_torch.models.configs import InputShape, ModelConfig
from repro_torch.models.layers import Params
from repro_torch.models.transformer import init_params
from repro_torch.serving import Request, ServingEngine


def serve_loop(cfg: ModelConfig, params: Params, *, requests: int = 16,
               slots: int = 4, max_seq: int = 256, adapt_every: int = 8,
               decode_mode: str = "batched", device: str = "cuda") -> dict:
    """Serve ``requests`` random prompts (8..47 tokens from
    ``default_rng(0)``, 12 new tokens each) from ``params`` on
    ``device``; every ``adapt_every`` engine steps the middleware adapts
    to the next context of ``case_study_trace`` and, when the variant or
    its options change, the engine swaps to it mid-wave.  Returns
    ``{"engine", "middleware", "requests", "seconds"}``."""
    shape = InputShape("serve", max_seq, slots, "decode")
    mw = Middleware(cfg=cfg, params=params, shape=shape,
                    budgets=Budgets(latency_s=1.0, memory_bytes=8e9),
                    allow_offload=False)
    engine = ServingEngine(cfg, params, slots=slots, max_seq=max_seq,
                           decode_mode=decode_mode, device=device)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(8, 48)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=12))
        engine.submit(reqs[-1])

    trace = list(case_study_trace(max(requests // adapt_every, 2)))
    ti = 0
    t0 = time.time()
    step = 0
    while engine.has_work:
        engine.step()
        step += 1
        if step % adapt_every == 0 and ti < len(trace):
            d = mw.adapt(trace[ti])
            ti += 1
            vcfg, vparams, vopts = mw.current_runtime()
            if vcfg != engine.cfg or vopts != engine.opts:
                print(f"[adapt] {d.reason}: {d.action.describe()[:80]}",
                      flush=True)
                engine.swap_model(vcfg, vparams, vopts)
    return {"engine": engine, "middleware": mw, "requests": reqs,
            "seconds": time.time() - t0}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-backbone")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--adapt-every", type=int, default=8)
    ap.add_argument("--decode-mode", default="batched",
                    choices=["batched", "per_slot"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    params = init_params(cfg, 0, args.device)
    out = serve_loop(cfg, params, requests=args.requests, slots=args.slots,
                     max_seq=args.max_seq, adapt_every=args.adapt_every,
                     decode_mode=args.decode_mode, device=args.device)
    engine, mw = out["engine"], out["middleware"]
    s = engine.stats
    print(f"served {args.requests} requests in {out['seconds']:.1f}s — "
          f"{s.steps} steps, {s.tokens_out} tokens "
          f"({s.tokens_per_step:.2f} tok/step), {s.prefills} prefills, "
          f"{s.recompiles} recompiles, {engine.generation} variant swaps")
    print(mw.report())


if __name__ == "__main__":
    main()
