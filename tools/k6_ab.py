#!/usr/bin/env python3
"""K6 (the SSD scan, bf16) at the served shapes for one checkout.

Run from the repo root on a machine with one H100::

    python3 tools/k6_ab.py [--root DIR] [--variants] [--phases]
                           [--prefill] [--shapes A,B,...]
    python3 tools/k6_ab.py --combine FILE

``DIR`` (default: this checkout) is the checkout whose ``src/`` is
imported and whose kernels are built, so two commits are compared by
running the script once with each root in one call (parent, this, this,
parent), the output of each appended to ``FILE``; ``--combine FILE`` then
prints, for each shape, every process's device time, the spread between
the processes of each root (max / min - 1) and the first root's median
time over the second's.  The inputs are the same for every root: made
from fixed seeds by ``chip_smoke.ssd_case`` (x, b and c as views of one
conv row, as the model reads them), chunk 256, bf16.

Each shape's line: the route the root's plan picks, ``device_ms`` (the
profiler's kernel time a call, ``ab_timing.device_ms``), ``event_ms``
(CUDA events over back-to-back calls), ``plain_ms`` (the plain version,
CUDA events), the bound (``chip_smoke.ssd_work`` and ``bound``: each
input read once and each output written once at 3.35 TB/s, or the
causal products at 989 TFLOP/s, the larger) and ``max_abs_err`` against
the plain version.

``--prefill`` adds one ``model.prefill`` of full-width mamba2-370m over
8 x 2048 tokens: the profiler's device time a call, all kernels and the
``ssd_scan`` kernels alone.

``--phases`` (the ``wgmma`` route) rebuilds the root's kernel with
``globaltimer`` stamps at its phase boundaries, kept in a ``__device__``
array, and prints, for each shape and consumer warpgroup, the mean
microseconds an item spends: ``rows`` (waiting for the item's per-row
values), ``own_state`` (its chunk's own state), ``chain_wait`` (the
wait for the state entering the chunk), ``publish`` (reading it,
publishing the next, splitting it into shared memory), ``tile_a`` and
``tile_b`` (the group's two query tiles); and the whole span.

``--variants`` traces where the root's kernel spends its time at the
mamba2 burst and zamba2's 8 x 1024: it rebuilds ``csrc/ssd_scan.cu`` of
the root with text patches, one library a variant, and times each in
turn in this process.  On the two-launch ``mma.sync`` route (before the
``wgmma`` route): ``loads`` (every product skipped: the copies, the
cumulative sums, the carry and the stores alone), ``no_ws_read`` (the
chunk scan reads no chunk state: a constant in its place), ``no_carry``
(the last block of a head arrives and returns without carrying the
states), ``no_lo`` (the low parts' products skipped) and ``state_only``
(the chunk-state launch alone).  On the ``wgmma`` route: ``loads`` (no
product), ``no_lo``, ``no_chain`` (no wait on the state entering a
chunk: the publish reads whatever the buffer holds), ``no_state_term``
(no product with the state entering the chunk) and ``no_diag`` (no
scores and no product of the chunk's own rows).  A variant's output is
wrong by design; only its time is read.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

from ab_timing import card, device_ms, event_ms, spread

TOOLS = Path(__file__).resolve().parent
# (label, batch, seq, heads, groups, head_dim, state_dim)
SERVED = (("mamba2 burst 8x2048", 8, 2048, 32, 1, 64, 128),
          ("mamba2 one prompt 1x2048", 1, 2048, 32, 1, 64, 128),
          ("zamba2 prefill 8x1024", 8, 1024, 64, 1, 64, 64),
          ("zamba2 ragged 8x1000", 8, 1000, 64, 1, 64, 64),
          ("zamba2 train 4x1024", 4, 1024, 64, 1, 64, 64))
VARIANT_SHAPES = ("mamba2 burst 8x2048", "zamba2 prefill 8x1024")
WINDOW = 20                     # calls a profiler window

# text patches of csrc/ssd_scan.cu, by variant: (old, new) pairs for the
# mma.sync route and for the wgmma route; a pair whose text the source
# lacks is skipped, and a variant none of whose pairs applies is not
# built
PATCHES = {
    "loads": [
        # mma.sync: the chunk state's products, the scan's key tiles and
        # the carried state's term
        ("    const int ksteps = (min(kT, rows - k0) + 15) / 16;\n",
         "    const int ksteps = 0 * ((min(kT, rows - k0) + 15) / 16);\n"),
        ("    const int k0 = kj * kT;\n\n    // ---- S = C_i B_j^T",
         "    const int k0 = kj * kT;\n    if (k0 >= 0) continue;\n\n"
         "    // ---- S = C_i B_j^T"),
        ("    for (int kk = 0; kk < kKN; ++kk) {\n      uint32_t af[4];\n"
         "      ldmatrix_x4(af, c_frag + 16 * kk);\n#pragma unroll\n"
         "      for (int n = 0; n < kND; n += 2) {",
         "    for (int kk = 0; kk < 0 * kKN; ++kk) {\n      uint32_t af[4];\n"
         "      ldmatrix_x4(af, c_frag + 16 * kk);\n#pragma unroll\n"
         "      for (int n = 0; n < kND; n += 2) {"),
        # wgmma: every product
        ("#define SSD_PRODUCTS 1", "#define SSD_PRODUCTS 0")],
    "no_ws_read": [
        ("        v[j] = __ldg(sg + tid + (it0 + j) * kThreads);",
         "        v[j] = make_float4(1.f, 0.f, 0.f, 0.f);")],
    "no_carry": [
        ("  if (!last) return;\n  __threadfence();\n  constexpr int PN4",
         "  if (tid == 0 && last) a.counters[bh] = 0;\n  return;\n"
         "  constexpr int PN4")],
    "no_lo": [
        ("        mma_bf16(acc[j], al, bf[0], bf[1]);\n"
         "        mma_bf16(acc[j + 1], al, bf[2], bf[3]);\n", ""),
        ("        ldmatrix_x4(bf, sl_s + off);\n"
         "        mma_bf16(y[n], af, bf[0], bf[1]);\n"
         "        mma_bf16(y[n + 1], af, bf[2], bf[3]);\n", ""),
        ("        mma_bf16(y[n], pl[kk], bf[0], bf[1]);\n"
         "        mma_bf16(y[n + 1], pl[kk], bf[2], bf[3]);\n", ""),
        ("#define SSD_LO_PARTS 1", "#define SSD_LO_PARTS 0")],
    "state_only": [
        ("  if (err != cudaSuccess) return err;\n  if constexpr (kTc) {\n"
         "    return launch(tc::ssd_scan_chunk_y",
         "  if (err != cudaSuccess || kTc) return err;\n"
         "  if constexpr (kTc) {\n    return launch(tc::ssd_scan_chunk_y")],
    "no_chain": [("#define SSD_CHAIN_WAIT 1", "#define SSD_CHAIN_WAIT 0")],
    "no_state_term": [("#define SSD_STATE_TERM 1",
                       "#define SSD_STATE_TERM 0")],
    "no_diag": [("#define SSD_DIAG 1", "#define SSD_DIAG 0")],
}


def make_case(torch, shape, seed, dtype="bfloat16"):
    """One served problem on the card, the same for every root."""
    import chip_smoke as cs
    _, b, s, h, g, p, n = shape
    gen = torch.Generator().manual_seed(seed)
    return cs.ssd_case(torch, gen, b, s, h, g, p, n, dtype)


def route_of(torch, shape):
    from repro_torch.kernels.ssd_scan import ssd_plan
    _, b, s, h, g, p, n = shape
    plan = ssd_plan(torch.bfloat16, b, s, h, p, n, 256)
    return dict(route=plan.route, items=getattr(plan, "items", None))


def served(torch, shapes):
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ref import ssd_scan_ref
    rows = {}
    for i, shape in enumerate(shapes):
        args = make_case(torch, shape, 6100 + i)

        def k6():
            return ssd_scan(*args, chunk=256)

        y, st = k6()
        yr, sr = ssd_scan_ref(*args, chunk=256)
        torch.cuda.synchronize()
        err = float((y.float() - yr.float()).abs().max())
        st_err = float((st - sr).abs().max())
        _, b, s, h, g, p, n = shape
        nbytes, flops = cs.ssd_work(b, s, h, g, p, n, 256, 2, 2)
        bound, bound_by = cs.bound(nbytes, flops, cs.H100_BF16_FLOPS)
        row = dict(route_of(torch, shape), max_abs_err=err,
                   state_max_abs_err=st_err,
                   device_ms=device_ms(k6, WINDOW, "ssd_scan", tries=10),
                   event_ms=event_ms(k6, 50),
                   plain_ms=event_ms(lambda: ssd_scan_ref(*args, chunk=256),
                                     3, warmup=1),
                   bound_ms=bound, bound_by=bound_by)
        row["share"] = (bound / row["device_ms"] if row["device_ms"]
                        else None)
        rows[shape[0]] = row
        del args, y, st, yr, sr
        torch.cuda.empty_cache()
    return rows


def prefill(torch):
    """One prefill of full-width mamba2-370m over 8 x 2048 tokens: the
    device time a call, all kernels and K6's."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params, prefill as pf
    cfg = get_config("mamba2-370m")
    params = init_params(cfg, seed=0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (8, 2048)).astype(np.int32)).cuda()

    def call():
        return pf(params, cfg, tokens, init_cache(cfg, 8, 2048,
                                                  device="cuda"))

    call()
    torch.cuda.synchronize()
    return dict(device_ms=device_ms(call, 3, "", tries=6),
                ssd_scan_ms=device_ms(call, 3, "ssd_scan", tries=6),
                event_ms=event_ms(call, 3, warmup=1))


# (old, new) text patches that put the phase stamps into the wgmma
# route, stamp k of consumer warpgroup w at g_stamp[ticket][10 w + k]
STAMPS = [
    ("namespace wg {\n",
     "namespace wg {\n__device__ long long g_stamp[4096][20];\n"
     "#define STAMP(k) do { if ((ct & 127) == 0) { long long v; asm "
     "volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v)); "
     "g_stamp[ticket][cw * 10 + (k)] = v; } } while (0)\n"),
    ("\n    if (ticket < 0) break;\n    const Item it",
     "\n    if (ticket < 0) break;\n    STAMP(0);\n    const Item it"),
    ("    mbar_wait(&cs_full[u], (n >> 1) & 1);\n",
     "    mbar_wait(&cs_full[u], (n >> 1) & 1);\n    STAMP(1);\n"),
    ("    // (c) the chain", "    STAMP(2);\n    // (c) the chain"),
    ("#endif\n    named_bar_sync(1, 256);\n    // the last chunk",
     "#endif\n    named_bar_sync(1, 256);\n    STAMP(3);\n"
     "    // the last chunk"),
    ("    // (d) y, a 64-row", "    STAMP(4);\n    // (d) y, a 64-row"),
    ("      if (i < 0) break;\n", "      if (i < 0) break;\n"
     "      STAMP(5 + slot);\n"),
    ("    // the item's per-row values are free",
     "    STAMP(7);\n    // the item's per-row values are free"),
]
PHASES = ("rows", "own_state", "chain_wait", "publish", None, "tile_a",
          "tile_b")


def phases(torch, root, shapes):
    """Each phase's mean microseconds an item, by consumer warpgroup."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ssd_plan, ssd_scan
    src = root / "src" / "repro_torch" / "kernels" / "csrc"
    text = (src / "ssd_scan.cu").read_text()
    for old, new in STAMPS:
        if text.count(old) != 1:
            raise SystemExit(f"--phases: the source lacks {old!r}")
        text = text.replace(old, new)
    text += ('\nextern "C" int ssd_stamps(void* host) { return (int)'
             'cudaMemcpyFromSymbol(host, wg::g_stamp, sizeof(long long) '
             '* 4096 * 20); }\n')
    out = root / "build" / "k6_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "phases.cu").write_text(text)
    log = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                          str(src), "-o", str(out / "libphases.so"),
                          str(out / "phases.cu")], capture_output=True,
                         text=True)
    if log.returncode:
        raise RuntimeError(f"--phases build failed:\n{log.stdout}"
                           f"{log.stderr}")
    lib = ctypes.CDLL(str(out / "libphases.so"))
    lib.ssd_stamps.argtypes = [ctypes.c_void_p]
    _build._LOADED["ssd_scan"] = lib
    rows = {}
    for i, shape in enumerate(shapes):
        _, b, s, h, g, p, n = shape
        items = ssd_plan(torch.bfloat16, b, s, h, p, n, 256).items
        if items > 4096:
            continue
        args = make_case(torch, shape, 6300 + i)
        for _ in range(3):
            ssd_scan(*args, chunk=256)
        torch.cuda.synchronize()
        buf = np.zeros((4096, 20), dtype=np.int64)
        lib.ssd_stamps(buf.ctypes.data)
        d = buf[:items].astype(np.float64) / 1e3
        row = {"span_us": float(d[:, [7, 17]].max() - d[:, [0, 10]].min())}
        for w in (0, 1):
            o = 10 * w
            row[f"group{w}"] = {
                name: float(np.mean(d[:, o + k + 1] - d[:, o + k]))
                for k, name in enumerate(PHASES) if name}
        rows[shape[0]] = row
    _build._LOADED.pop("ssd_scan", None)
    return rows


def variants(torch, root, shapes):
    """The root's kernel rebuilt with each variant's patches, timed."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ssd_scan
    src = root / "src" / "repro_torch" / "kernels" / "csrc"
    text = (src / "ssd_scan.cu").read_text()
    out_dir = root / "build" / "k6_variants"
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
    cases = [make_case(torch, s, 6200 + i) for i, s in enumerate(shapes)]
    rows = {}
    for name, lib in libs.items():
        _build._LOADED["ssd_scan"] = lib
        rows[name] = {}
        for shape, args in zip(shapes, cases):
            def k6():
                return ssd_scan(*args, chunk=256)
            rows[name][shape[0]] = device_ms(k6, WINDOW, "ssd_scan")
    _build._LOADED.pop("ssd_scan", None)
    return rows


def combine(path):
    """Each shape's device times over the processes in ``path`` (one JSON
    line a process), grouped by root in the order they ran; the spread of
    each root's; the first root's median device time over the second's;
    the prefill's device times where the processes measured it."""
    runs = [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.startswith("{")]
    runs = [r for r in runs if "shapes" in r]
    roots = list(dict.fromkeys(r["root"] for r in runs))
    table = {}
    for label in runs[0]["shapes"]:
        row = {}
        for root in roots:
            vals = [r["shapes"][label]["device_ms"] for r in runs
                    if r["root"] == root and label in r["shapes"]]
            row[root] = dict(device_ms=vals, spread=spread(vals))
        if len(roots) == 2:
            med = [statistics.median(v for v in row[r]["device_ms"] if v)
                   for r in roots]
            row["first_over_second"] = med[0] / med[1]
        table[label] = row
    pre = {root: [r["prefill"] for r in runs
                  if r["root"] == root and "prefill" in r] for root in roots}
    return dict(card=runs[0]["card"], roots=roots, shapes=table,
                prefill=pre)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(TOOLS.parent))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated labels of SERVED (default: all; "
                         "the mamba2 burst and zamba2's 8 x 1024 with "
                         "--variants)")
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
    import repro_torch.kernels.ssd_scan  # noqa: F401
    import repro_torch.kernels.ref  # noqa: F401
    import repro_torch.models  # noqa: F401
    names = (args.shapes.split(",") if args.shapes
             else list(VARIANT_SHAPES) if args.variants
             else [s[0] for s in SERVED])
    shapes = [s for s in SERVED if s[0] in names]
    if len(shapes) != len(names):
        raise SystemExit(f"unknown shapes in {names}")
    import repro_torch
    result = {"root": str(root), "card": card(),
              "package": str(Path(repro_torch.__file__).parent)}
    if args.phases:
        result["phases"] = phases(torch, root, shapes)
    elif args.variants:
        result["variants"] = variants(torch, root, shapes)
    else:
        result["shapes"] = served(torch, shapes)
    if args.prefill:
        result["prefill"] = prefill(torch)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
