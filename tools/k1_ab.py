#!/usr/bin/env python3
"""K1 (paged decode attention, bf16 q) at the served shapes for one checkout.

Run from the repo root on a machine with one H100::

    python3 tools/k1_ab.py [--root DIR] [--variants] [--shapes A,B,...]
    python3 tools/k1_ab.py --combine FILE

``DIR`` (default: this checkout) is the checkout whose ``src/`` is
imported and whose kernels are built, so two commits are compared by
running the script once with each root in one call (parent, this, this,
parent), the output of each appended to ``FILE``; ``--combine FILE`` then
prints, for each shape, every process's device time, the spread between
the processes of each root (max / min - 1) and the parent's time over
this tree's.  The inputs are the same for every root: made from fixed
seeds, 8 slots, an int8 pool of 4 interleaved layers (the kernel reads
layer 2 in place), block 16, bf16 q, positions drawn from each shape's
range (``SERVED``).

Each shape's line: the route the root's plan picks, ``device_ms`` (the
profiler's kernel time a call, ``ab_timing.device_ms``), ``graph_ms``
(CUDA events around replays of a CUDA graph of 20 calls, as the engine
replays its decode step), ``event_ms``
(CUDA events over back-to-back calls, host issue included), ``issue_us``
(the host's time to issue one call), ``sdpa_ms`` (the device time of one
``scaled_dot_product_attention`` call over the K/V gathered dense
beforehand, ``chip_smoke.sdpa_yardstick``), ``plain_ms`` (the plain
version, CUDA events) and the bound (``chip_smoke.paged_bound_ms``:
the valid rows' bytes once at 3.35 TB/s).

``--variants`` traces where the root's kernel spends its time at the
shapes given (default yi-34b): it rebuilds ``csrc/paged_decode_attn.cu``
of the root with text patches, one library a variant, and times each in
turn in this process: ``full``; ``loads`` (the loads alone: every score
and product skipped); ``products`` (no load: the products on whatever
shared memory holds); ``no_tail`` (the blocks arrive, and the last one
returns without merging); and on the ``wgmma`` route also ``no_mma``
(no product issued), ``no_convert`` (neither K nor V converted: the
products read whatever the registers and shared memory hold) and
``empty`` (no split finds a valid column: the launch, the arrivals and
the merge alone).  The patches know both the CUDA-core kernel (the
route of f32 q, and of bf16 q before the ``wgmma`` route) and the
``wgmma`` route.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

from ab_timing import card, device_ms, event_ms, graph_ms, issue_us, spread

TOOLS = Path(__file__).resolve().parent
# (label, heads, kv heads, hd, mb, lowest position, highest, window)
SERVED = (("paper-backbone", 8, 8, 32, 32, 16, 288, 0),
          ("paper-backbone full 2048", 8, 8, 32, 128, 2048, 2048, 0),
          ("olmoe-1b-7b", 16, 16, 128, 64, 8, 314, 0),
          ("whisper-small", 12, 12, 64, 32, 16, 288, 0),
          ("internvl2-26b", 48, 8, 128, 64, 16, 288, 0),
          ("gemma3-12b", 16, 8, 256, 128, 1024, 2048, 0),
          ("gemma3-12b local", 16, 8, 256, 128, 1024, 2048, 1024),
          ("phi3-mini", 32, 32, 96, 64, 512, 1024, 0),
          ("gemma-7b", 16, 16, 256, 64, 512, 1024, 0),
          ("yi-34b", 56, 8, 128, 64, 512, 1024, 0),
          ("qwen1.5-32b", 40, 40, 128, 64, 512, 1024, 0))
WINDOW = 50                     # calls a profiler window

# text patches of csrc/paged_decode_attn.cu, by variant: (old, new) pairs
# for the CUDA-core kernel and for the wgmma route; a pair whose
# text the source lacks is skipped, and a variant none of whose pairs
# applies is not built
PATCHES = {
    "loads": [
        ("    for (int g = 0; g < group; ++g) {\n      // score of row r",
         "    for (int g = 0; g < 0; ++g) {\n      // score of row r"),
        ("    mbar_wait(&full[s], (n / a.stages) & 1);\n",
         "    mbar_wait(&full[s], (n / a.stages) & 1);\n"
         "    __syncwarp();\n"
         "    if (lane == 0) mbar_arrive(&empty[s]);\n"
         "    if (n >= 0) continue;\n")],
    "products": [
        ("  auto issue = [&](int n) {\n",
         "  auto issue = [&](int n) {\n    if (n >= 0) return;\n"),
        ("      mbar_expect_tx(&full[s], (pc_last - pc_first + 1) * "
         "box_bytes);\n",
         "      mbar_arrive(&full[s]);\n      if (n >= 0) continue;\n")],
    "no_mma": [
        ("          wgmma_k_rs<N>(sacc[part * kCBP + j], af[4 * j + u],",
         "          if (u < 0) wgmma_k_rs<N>(sacc[part * kCBP + j], "
         "af[4 * j + u],"),
        ("        wgmma_mn<N>(o[cb], dv +",
         "        if (cb < 0) wgmma_mn<N>(o[cb], dv +")],
    "no_convert": [
        ("        k_frags<KT>(af + 4 * j,",
         "        if (j < 0) k_frags<KT>(af + 4 * j,"),
        ("ok[u] ? Raw<KT>::to_bf16(rv[u]) : make_uint4(0u, 0u, 0u, 0u);",
         "make_uint4(row, ch, 0u, 0u);")],
    "empty": [
        ("  int t_first = 0, n_tiles = 0;\n  if (c_begin < c_end) {",
         "  int t_first = 0, n_tiles = 0;\n  if (c_begin < c_end && c_begin < 0) {")],
    "no_tail": [
        ("  if (!last) return;\n  __threadfence();\n",
         "  if (tid == 0 && last) a.counters[sk] = 0;\n  return;\n"),
        ("  if (!*flag) return;\n  __threadfence();\n",
         "  if (tid == 0 && *flag) a.counters[sk] = 0;\n  return;\n")],
}


def make_case(torch, shape, seed):
    """One served problem on the card, the same for every root."""
    from repro_torch.kernels.act_quant import kv_quant_rows
    label, h, kvh, hd, mb, lo, hi, window = shape
    gen = torch.Generator().manual_seed(seed)
    slots, bs, layers, layer = 8, 16, 4, 2
    nb = slots * mb + 1
    k, ks = kv_quant_rows(torch.randn(nb, layers, bs, kvh, hd, generator=gen))
    v, vs = kv_quant_rows(torch.randn(nb, layers, bs, kvh, hd, generator=gen))
    bf = torch.bfloat16
    args = (torch.randn(slots, h, hd, generator=gen).to(bf).cuda(),
            k.cuda()[:, layer], v.cuda()[:, layer],
            torch.randint(0, nb, (slots, mb), generator=gen,
                          dtype=torch.int32).cuda(),
            torch.randint(lo, hi + 1, (slots,), generator=gen,
                          dtype=torch.int32).cuda(),
            torch.randn(slots, kvh, hd, generator=gen).to(bf).cuda(),
            torch.randn(slots, kvh, hd, generator=gen).to(bf).cuda())
    sc = dict(k_scale=ks.cuda()[:, layer], v_scale=vs.cuda()[:, layer])
    return args, sc, window


def route_of(plan_fn, torch, args):
    q, kb, _, tables = args[:4]
    slots, h, hd = q.shape
    _, bs, kvh, _ = kb.shape
    try:
        plan = plan_fn(slots, h, kvh, hd, bs, tables.shape[1], kb.dtype,
                       q.dtype)
    except TypeError:           # a plan that takes no q dtype (older)
        plan = plan_fn(slots, h, kvh, hd, bs, tables.shape[1], kb.dtype)
    return dict(route=getattr(plan, "route", "cuda_cores"),
                splits=plan.splits,
                split_cols=getattr(plan, "split_cols", 128))


def served(torch, shapes):
    import chip_smoke as cs
    from repro_torch.kernels.paged_decode_attn import (decode_plan,
                                                       paged_decode_attention)
    from repro_torch.kernels.ref import paged_decode_attn_ref
    rows = {}
    for i, shape in enumerate(shapes):
        args, sc, window = make_case(torch, shape, 3100 + i)

        def k1():
            return paged_decode_attention(*args, window=window, **sc)

        out = k1()
        ref = paged_decode_attn_ref(*args, window=window, **sc)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        bound, bound_by = cs.paged_bound_ms(args, sc, window)
        _, sdpa_dev = cs.sdpa_yardstick(torch, args, sc, window)
        row = dict(route_of(decode_plan, torch, args), max_abs_err=err,
                   device_ms=device_ms(k1, WINDOW, "paged_decode",
                                       tries=10),
                   graph_ms=graph_ms(k1), event_ms=event_ms(k1, 200),
                   issue_us=issue_us(k1),
                   sdpa_ms=sdpa_dev,
                   plain_ms=event_ms(lambda: paged_decode_attn_ref(
                       *args, window=window, **sc), 10, warmup=1),
                   bound_ms=bound, bound_by=bound_by)
        row["share"] = (bound / row["device_ms"] if row["device_ms"]
                        else None)
        rows[shape[0]] = row
        del args, sc, out, ref
        torch.cuda.empty_cache()
    return rows


def variants(torch, root, shapes):
    """The root's kernel rebuilt with each variant's patches, timed."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_decode_attn import paged_decode_attention
    src = root / "src" / "repro_torch" / "kernels" / "csrc"
    text = (src / "paged_decode_attn.cu").read_text()
    out_dir = root / "build" / "k1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    for name in ("full", *PATCHES):
        patched = text
        for old, new in PATCHES.get(name, ()):
            patched = patched.replace(old, new)
        if name != "full" and patched == text:
            continue
        cu = out_dir / f"{name}.cu"
        cu.write_text(patched)
        lib = out_dir / f"lib{name}.so"
        builds[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    cases = [make_case(torch, s, 3200 + i) for i, s in enumerate(shapes)]
    rows = {}
    for name, lib in libs.items():
        _build._LOADED["paged_decode_attn"] = lib
        rows[name] = {}
        for shape, (args, sc, window) in zip(shapes, cases):
            def k1():
                return paged_decode_attention(*args, window=window, **sc)
            rows[name][shape[0]] = device_ms(k1, WINDOW, "paged_decode")
    _build._LOADED.pop("paged_decode_attn", None)
    return rows


def combine(path):
    """Each shape's device and graph-replay times over the processes in
    ``path`` (one JSON line a process), grouped by root in the order they
    ran; the spread of each root's; the first root's median device time
    over the second's."""
    runs = [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.startswith("{")]
    roots = list(dict.fromkeys(r["root"] for r in runs))
    table = {}
    for label in runs[0]["shapes"]:
        row = {}
        for root in roots:
            vals = [r["shapes"][label]["device_ms"] for r in runs
                    if r["root"] == root and label in r["shapes"]]
            graph = [r["shapes"][label]["graph_ms"] for r in runs
                     if r["root"] == root and label in r["shapes"]]
            row[root] = dict(device_ms=vals, spread=spread(vals),
                             graph_ms=graph, graph_spread=spread(graph))
        if len(roots) == 2:
            med = [statistics.median(v for v in row[r]["device_ms"] if v)
                   for r in roots]
            row["first_over_second"] = med[0] / med[1]
        table[label] = row
    return dict(card=runs[0]["card"], roots=roots, shapes=table)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(TOOLS.parent))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated labels of SERVED (default: all; "
                         "yi-34b with --variants)")
    ap.add_argument("--combine", default=None)
    args = ap.parse_args()
    if args.combine:
        print(json.dumps(combine(args.combine)))
        return 0
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(TOOLS.parent))         # chip_smoke's helpers
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    # the root's package, imported before chip_smoke (which puts its own
    # checkout's src first on the path)
    import repro_torch.kernels.paged_decode_attn  # noqa: F401
    import repro_torch.kernels.ref  # noqa: F401
    import repro_torch.kernels.act_quant  # noqa: F401
    names = (args.shapes.split(",") if args.shapes
             else ["yi-34b"] if args.variants else [s[0] for s in SERVED])
    shapes = [s for s in SERVED if s[0] in names]
    if len(shapes) != len(names):
        raise SystemExit(f"unknown shapes in {names}")
    import repro_torch
    result = {"root": str(root), "card": card(),
              "package": str(Path(repro_torch.__file__).parent)}
    if args.variants:
        result["variants"] = variants(torch, root, shapes)
    else:
        result["shapes"] = served(torch, shapes)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
