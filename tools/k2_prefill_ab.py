#!/usr/bin/env python3
"""K2 (flash attention for prefill, bf16) for one checkout: its host cost
at served shapes, or its device time at paper-backbone's shapes.

Run from the repo root on a machine with one H100::

    python3 tools/k2_prefill_ab.py [--root DIR] [--shapes served|paper]
    python3 tools/k2_prefill_ab.py --shapes paper --variants [--root DIR]
    python3 tools/k2_prefill_ab.py --combine FILE

``DIR`` (default: this checkout) is the checkout whose ``src/`` is
imported and whose kernels are built, so two commits are compared by
running the script once with each root in one call (parent, this, this,
parent), the output of each appended to ``FILE``; ``--combine FILE`` then
prints, for each shape, every process's figures, the spread between the
processes of each root (max / min - 1) and the first root's median over
the second's.  Each process prints one JSON line.

``--shapes served`` (the default):

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

``--shapes paper``: ``flash_attention`` at paper-backbone's K2 calls (8
heads of 32, MHA, causal, no ``kv_len``; ``PAPER``): the burst prefills
at the short buckets, the long wave's 8 x 1024 and 8 x 2048, an
adaptation ``infer``'s 4 x 256, the train step's 8 x 256.  Each shape:
the route and plan the root picks, ``device_ms`` (the profiler's kernel
time a call, ``ab_timing.device_ms``), ``event_ms`` (CUDA events over 200
back-to-back calls), ``issue_us``, ``sdpa_device_ms`` (one
``scaled_dot_product_attention`` call on the same inputs), the bound
(``chip_smoke.bound``: 4 hd flops a valid pair at the bf16 peak against
q, k, v and out once) and the ex2 floor (one ex2 a valid pair at 16 a
clock an SM at the card's top SM clock).

``--variants`` (with ``--shapes paper``) times the hd 16/32 kernel's
``VARIANTS`` at the paper shapes in this process: each applies its text
patches to copies of the root's ``csrc/flash_attn.cu`` and
``kernels/flash_attn.py`` (whose plan the C entry checks), builds one
library a variant under ``<root>/build/k2_variants/``, loads the patched
wrapper as a module of its own, and holds one output to the plain
version before timing (``max_abs_err``).  ``VARIANTS``: keys a tile,
ring stages and blocks an SM, and the row sums as FADDs a weight instead
of columns of ones beside V.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from ab_timing import card, device_ms, event_ms as _event_ms, issue_us, spread

TOOLS = Path(__file__).resolve().parent
# paper-backbone's K2 calls: (label, batch, tokens); 8 heads of 32, causal
PAPER = (("8 x 16", 8, 16), ("8 x 128", 8, 128), ("8 x 256", 8, 256),
         ("4 x 256", 4, 256), ("8 x 1024", 8, 1024), ("8 x 2048", 8, 2048))


def geometry(bk, stages, blocks):
    """Text patches giving the hd 16/32 kernel ``bk`` keys a tile,
    ``stages`` ring slots and ``blocks`` blocks an SM (the consumer
    warpgroup's registers follow: setmaxnreg's split of 65536 / (256
    blocks), down to a multiple of 8): {file: [(old, new)]}."""
    regs = (256 * (65536 // (256 * blocks) & ~7) - 128 * 24) // 128 & ~7
    regs = min(regs, 240)
    return {"cu": [("static constexpr int kBK = 64;",
                    f"static constexpr int kBK = {bk};"),
                   ("static constexpr int kStages = 3;",
                    f"static constexpr int kStages = {stages};"),
                   ("static constexpr int kMinBlocks = 3;",
                    f"static constexpr int kMinBlocks = {blocks};"),
                   ("static constexpr int kConsumerRegs = 136;",
                    f"static constexpr int kConsumerRegs = {regs};")],
            "py": [("NW_BLOCK_K, NW_STAGES, NW_CONSUMER_REGS = 64, 3, 136",
                    f"NW_BLOCK_K, NW_STAGES, NW_CONSUMER_REGS = {bk}, "
                    f"{stages}, {regs}")]}


# the row sums as FADDs a weight, summed across the quad at the end, in
# place of the ones beside V (P V at n = hd, no ones tile)
ROWSUM_FADD = {
    "cu": [("static constexpr int kOnesBytes = kTileBytes;",
            "static constexpr int kOnesBytes = 0;"),
           ("static constexpr int kN = HD + 8;",
            "static constexpr int kN = HD;"),
           ("(uint32_t)(ones - (kv_s + C::kTileBytes))", "16"),
           ("dv + d - (d << 16);", "dv + d;"),
           ("float m0 = kNegInf, m1 = kNegInf;",
            "float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;"),
           ("          nw_exp<kBK>(sc, sh0, sh1, sl2);\n",
            "          nw_exp<kBK>(sc, sh0, sh1, sl2);\n"
            "          float ps[4] = {0.f, 0.f, 0.f, 0.f};\n"
            "#pragma unroll\n"
            "          for (int q = 0; q < kBK / 8; ++q) {\n"
            "            ps[q & 1] += sc[4 * q] + sc[4 * q + 1];\n"
            "            ps[2 + (q & 1)] += sc[4 * q + 2] + sc[4 * q + 3];\n"
            "          }\n"
            "          l0 = fmaf(l0, corr.x, ps[0] + ps[1]);\n"
            "          l1 = fmaf(l1, corr.y, ps[2] + ps[3]);\n"),
           ("      const float inv0 = 1.f / fmaxf(o[HD / 2], 1e-30f);\n"
            "      const float inv1 = 1.f / fmaxf(o[HD / 2 + 2], 1e-30f);\n",
            "      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);\n"
            "      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);\n"
            "      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);\n"
            "      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);\n"
            "      const float inv0 = 1.f / fmaxf(l0, 1e-30f);\n"
            "      const float inv1 = 1.f / fmaxf(l1, 1e-30f);\n")],
    "py": [("NW_STAGES * 2 * tile + tile", "NW_STAGES * 2 * tile")]}

# the hd 16/32 kernel's variants, by name: their patches ({} the plan)
VARIANTS = {"plan": {},
            "rowsum FADD": ROWSUM_FADD,
            "stages 2": geometry(64, 2, 3),
            "stages 4": geometry(64, 4, 3),
            "4 blocks an SM": geometry(64, 3, 4),
            "keys 128, 2 blocks an SM, 4 stages": geometry(128, 4, 2)}


def paper_shapes(torch, fa, gen, clock_hz):
    """``flash_attention`` at ``PAPER``: {label: figures}."""
    import torch.nn.functional as F
    import chip_smoke
    out = {}
    for label, b, s in PAPER:
        q, k, v = (torch.randn(b, s, 8, 32, generator=gen, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2)
                   for _ in range(3))

        def call():
            return fa.flash_attention(q, k, v)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        plan = fa.flash_plan(q.dtype, 32, s, s, 8, 8)
        pairs = chip_smoke.flash_pairs(s, True, 0, None) * b * 8
        bound_ms, bound_by = chip_smoke.bound(
            4 * q.numel() * 2, 4 * 32 * pairs, chip_smoke.H100_BF16_FLOPS)
        out[label] = dict(
            route=plan.route, plan=list(plan[1:7]),
            device_ms=device_ms(call, 50, part="flash_attn", tries=12),
            event_ms=_event_ms(call, 200, warmup=3), issue_us=issue_us(call),
            sdpa_device_ms=device_ms(sdpa, 50, tries=12), bound_ms=bound_ms,
            bound_by=bound_by, ex2_floor_ms=1e3 * pairs / (16 * 132
                                                            * clock_hz))
        del q, k, v
    return out


def nw_ptxas(log):
    """ptxas's lines on the hd 16/32 kernels (registers, spills, and any
    C75xx warning that it serialized their products)."""
    lines = log.splitlines()
    keep = [ln.strip() for ln in lines if "C75" in ln]
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and "flash_attn_nw_kernel" in ln:
            keep += [x.strip() for x in lines[i + 1:i + 3]]
    return keep


def patched(text, pairs, what):
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit(f"--variants: {what} lacks {old!r}")
        text = text.replace(old, new)
    return text


def variants(torch, fa, build, gen, clock_hz, root):
    """The paper shapes on each of ``VARIANTS``: {name: figures}."""
    from repro_torch.kernels.ref import flash_attn_ref
    kernels = root / "src/repro_torch/kernels"
    cu, py = ((kernels / f).read_text() for f in ("csrc/flash_attn.cu",
                                                   "flash_attn.py"))
    out_dir = root / "build/k2_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    for name, patches in VARIANTS.items():
        if not patches:
            continue
        stem = name.replace(" ", "_").replace(",", "")
        src = out_dir / f"{stem}.cu"
        src.write_text(patched(cu, patches.get("cu", ()), "flash_attn.cu"))
        lib = out_dir / f"lib{stem}.so"
        builds[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I",
             str(kernels / "csrc"), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    plan_lib = build.load("flash_attn")
    out = {}
    for name, patches in VARIANTS.items():
        if patches:
            lib, proc = builds[name]
            log, _ = proc.communicate()
            if proc.returncode:
                out[name] = {"build_failed": log[-600:]}
                continue
            # the patched wrapper, a module of its own in fa's package
            spec = importlib.util.spec_from_loader(
                f"{fa.__package__}._k2_variant", loader=None)
            mod = importlib.util.module_from_spec(spec)
            mod.__package__ = fa.__package__
            exec(compile(patched(py, patches.get("py", ()), "flash_attn.py"),
                         fa.__file__, "exec"), mod.__dict__)
            build._LOADED["flash_attn"] = ctypes.CDLL(str(lib))
        else:
            mod = fa
            build._LOADED["flash_attn"] = plan_lib
            log = build.library_path(kernels / "csrc/flash_attn.cu") \
                .with_suffix(".log").read_text()
        q, k, v = (torch.randn(2, 8, 1000, 32, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        err = float((mod.flash_attention(q, k, v).float()
                     - flash_attn_ref(q, k, v).float()).abs().max())
        out[name] = dict(plan=list(mod.flash_plan(torch.bfloat16, 32, 2048,
                                                   2048, 8, 8)[1:7]),
                         max_abs_err=err, ptxas_warnings=nw_ptxas(log),
                         shapes=paper_shapes(torch, mod, gen, clock_hz))
        del q, k, v
    build._LOADED["flash_attn"] = plan_lib
    return out


def combine(path):
    """Each shape's figures over the processes in ``path`` (one JSON
    line a process), grouped by root in the order they ran, the spread
    of each root's device times, and the first root's median device
    time (and ``issue_us``) over the second's."""
    runs = [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.startswith("{")]
    roots = list(dict.fromkeys(r["root"] for r in runs))
    table = {}
    for label in runs[0]["paper"]:
        row = {}
        for root in roots:
            got = [r["paper"][label] for r in runs if r["root"] == root]
            row[root] = {key: [g[key] for g in got] for key in
                         ("route", "device_ms", "event_ms", "issue_us",
                          "sdpa_device_ms")}
            row[root]["spread"] = spread(row[root]["device_ms"])
        if len(roots) == 2:
            for key in ("device_ms", "issue_us"):
                med = [statistics.median(v for v in row[r][key] if v)
                       for r in roots]
                row[f"{key}_first_over_second"] = med[0] / med[1]
        for key in ("bound_ms", "bound_by", "ex2_floor_ms"):
            row[key] = runs[0]["paper"][label][key]
        table[label] = row
    return dict(card=runs[0]["card"], roots=roots, shapes=table)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--root", default=str(TOOLS.parent))
    ap.add_argument("--shapes", choices=("served", "paper"),
                    default="served")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--combine", default=None)
    args = ap.parse_args()
    if args.combine:
        print(json.dumps(combine(args.combine)))
        return 0
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(TOOLS.parent))         # chip_smoke's helpers
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.models.model import init_cache, prefill
    from repro_torch.models.transformer import param_tree

    # the root's kernels, built before this process's first CUDA work:
    # each A/B process that built them after it lost most of its
    # profiler windows (PERF.md §7)
    _build.build_all()
    if args.shapes == "paper":
        import chip_smoke
        gen = torch.Generator(device="cuda").manual_seed(0)
        clock = chip_smoke.max_sm_clock_hz()
        result = {"root": str(root), "card": card(),
                  "sm_clock_hz": clock}
        if args.variants:
            result["variants"] = variants(torch, fa, _build, gen, clock,
                                          root)
        else:
            result["paper"] = paper_shapes(torch, fa, gen, clock)
        print(json.dumps(result))
        return 0

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
