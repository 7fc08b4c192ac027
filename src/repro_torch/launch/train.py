"""End-to-end training driver, on the card unless the caller passes
``device="cpu"``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-backbone \\
      --steps 200 --batch 8 --seq 256 --d-model 512 --layers 12
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM, place_batch
from repro_torch.models.configs import InputShape, ModelConfig
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw

from .steps import make_train_step, options_for


def train_loop(cfg: ModelConfig, shape: InputShape, steps: int,
               seed: int = 0, log_every: int = 10,
               remat: str = "none",
               checkpoint_dir: Optional[str] = None,
               callback=None, device: str = "cuda") -> dict:
    """``steps`` train steps of ``cfg`` from the weights of ``seed`` on
    the synthetic stream of ``seed``; the loss and gradient norm are read
    back to the host every ``log_every`` steps and at the last.  With
    ``checkpoint_dir`` the final parameters are saved under
    ``step_{steps:06d}``.  ``remat`` ("none", "dots" or "full") is the
    backward's recomputation policy (``transformer.apply_stack``).  The
    parameters and AdamW state are donated to each step, which updates
    them in place.  Returns ``{"losses": [(step, loss)], "params",
    "seconds"}``."""
    opts = options_for(cfg, shape, {"remat": remat})
    params = init_params(cfg, seed, device)
    opt_state = adamw.init(params)
    step_fn = make_train_step(cfg, opts, donate=True)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=shape.seq_len,
                                  batch_size=shape.global_batch, seed=seed))
    losses = []
    t0 = time.time()
    for i in range(steps):
        batch = place_batch(data.batch(i), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            losses.append((i, loss))
            print(f"step {i:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{(time.time() - t0) / (i + 1):.2f}s/step", flush=True)
        if callback is not None:
            params, opt_state = callback(i, params, opt_state, metrics)
    if checkpoint_dir:
        save_checkpoint(f"{checkpoint_dir}/step_{steps:06d}", params,
                        step=steps, metadata={"arch": cfg.name})
    return {"losses": losses, "params": params,
            "seconds": time.time() - t0}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-backbone")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    kw = {}
    if args.layers:
        kw["num_layers"] = args.layers
    if args.d_model:
        kw["d_model"] = args.d_model
        kw["head_dim"] = 0
    if kw:
        cfg = cfg.with_updates(**kw)
    shape = InputShape("cli", args.seq, args.batch, "train")
    n = cfg.param_count()
    print(f"training {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps @ batch={args.batch} seq={args.seq} on "
          f"{args.device}")
    out = train_loop(cfg, shape, args.steps, remat=args.remat,
                     checkpoint_dir=args.checkpoint_dir or None,
                     device=args.device)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"loss {first:.3f} -> {last:.3f} in {out['seconds']:.0f}s")


if __name__ == "__main__":
    main()
