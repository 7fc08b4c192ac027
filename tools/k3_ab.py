#!/usr/bin/env python3
"""K3 (the fused gated FFN, bf16) at the served shapes for one checkout.

Run from the repo root on a machine with one H100::

    python3 tools/k3_ab.py [--root DIR] [--shapes decode|prefill|small]
                           [--step]
    python3 tools/k3_ab.py --combine FILE

``DIR`` (default: this checkout) is the checkout whose ``src/`` is
imported and whose kernels are built, so two commits are compared by
running the script once with each root in one call (A, B, B, A), the
output of each appended to ``FILE``: the route that the root's
``ffn_plan`` picks is the one timed.  ``--combine FILE`` then prints, for
each shape, every process's device time, the spread between the
processes of each root (max / min - 1) and the first root's median over
the second's, and each process's ``--step`` figures.  The shape sets:

* ``decode`` (the default): M 8 at the dense families' FFNs,
  zamba2-1.2b's shared FFN, and D 7168 at F 16896, where ``F / 64``
  blocks make one full wave of two an SM;
* ``small``: the small_m route's shapes: paper-backbone's FFN (D 256, F
  1024) at M 1, 8, 16, 32 and 64 under silu and at M 8 under gelu, M 8
  and 64 at D 512 (F 2048), M 16 and 32 at D 1024 (F 4096), and
  whisper-small's decode step (M 8, D 768, F 3072, gelu);
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

``--geometries`` (with ``--shapes small``, on a root whose plan has
``small_plan``) also times each small_m shape at other launch
geometries, ``(column groups, F ranges)`` pairs (``GEOMETRIES``), by the
profiler's device time: ``geometries`` maps ``"G,C"`` to ms.

``--phases`` rebuilds the root's ``csrc/fused_ffn.cu`` with
``globaltimer`` stamps at the small_m kernel's phases (a ``__device__``
array read back with ``cudaMemcpyFromSymbol``) and prints, at
paper-backbone's M 8 and M 64, when each phase ends in microseconds from
the first block's entry (min, mean, max over the blocks, median over 30
calls): the barriers initialised, x landed, the first chunk landed, G/U
done, H written, the share done, the stores issued, the cluster barrier
passed, the sum written; and when the producer issued x and its last
load.

``--step`` adds paper-backbone's paged int8 decode step (8 busy slots,
max_seq 512, replayed as a CUDA graph, weights from seed 0):
``chip_smoke.step_split``'s host ms a step, device ms, and its K3, K1
and rest.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import statistics
import sys
from pathlib import Path

from ab_timing import card, device_ms, event_ms, spread

TOOLS = Path(__file__).resolve().parent

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
SMALL = tuple((f"paper-backbone M {m}", m, 256, 1024, "silu")
              for m in (1, 8, 16, 32, 64)) + (
    ("paper-backbone M 8 gelu", 8, 256, 1024, "gelu"),
    ("D 512 M 8", 8, 512, 2048, "silu"),
    ("D 512 M 64", 64, 512, 2048, "silu"),
    ("D 1024 M 16", 16, 1024, 4096, "silu"),
    ("D 1024 M 32", 32, 1024, 4096, "silu"),
    ("whisper-small M 8", 8, 768, 3072, "gelu"))
SHAPES = {"decode": DECODE, "prefill": PREFILL, "small": SMALL}
# (column groups, F ranges) of small_m timed by --geometries, by (D, F)
GEOMETRIES = {(256, 1024): ((1, 1), (2, 1), (4, 1)),
              (512, 2048): ((2, 2), (3, 2), (4, 1)),
              (1024, 4096): ((1, 4), (3, 2)),
              (768, 3072): ((2, 3), (1, 3))}
# calls a profiler window
WINDOW = {"decode": 50, "prefill": 20, "small": 50}
FLOPS_PER_S, BYTES_PER_S = 989e12, 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="decode")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--geometries", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--combine", default=None)
    args = ap.parse_args()
    if args.combine:
        print(json.dumps(combine(args.combine)))
        return 0
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.fused_ffn import ffn_plan, fused_ffn

    smi = card()
    gen = torch.Generator(device="cuda").manual_seed(3030)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device="cuda").mul_(
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
        if args.geometries and row["route"] == "small_m":
            row["geometries"] = geometries(kernel, m, d, f, WINDOW["small"])
        rows[label] = row
        del x, wg, wu, wd
        torch.cuda.empty_cache()
    result = {"root": str(args.root), "card": smi, "shapes": rows}
    if args.shapes == "prefill":
        result["internvl2-26b prefill 8 x 512"] = vlm_prefill(
            torch, event_ms, device_ms)
    if args.step:
        result["step"] = paged_step(torch, smi)
    if args.phases:
        result["phases"] = phases(torch, Path(args.root).resolve())
    print(json.dumps(result))
    return 0


# text patches of csrc/fused_ffn.cu for --phases: a stamp k of block b is
# g_stamp[b][k], the globaltimer when its thread 0 (stamps 0-9) or its
# producer thread (10, 11) passed the point
STAMPS = (
    ("struct SmallArgs {",
     "__device__ unsigned long long g_stamp[256 * 16];\n"
     "__device__ __forceinline__ void stamp(int k) {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  g_stamp[blockIdx.x * 16 + k] = t;\n}\n"
     "struct SmallArgs {"),
    ("  const int tid = threadIdx.x;\n  if (tid == 128) {\n    tma_prefetch",
     "  const int tid = threadIdx.x;\n  if (tid == 0) stamp(0);\n"
     "  if (tid == 128) {\n    tma_prefetch"),
    ("    mbar_init(x_full, 1);\n    fence_mbar_init();\n  }\n"
     "  __syncthreads();\n",
     "    mbar_init(x_full, 1);\n    fence_mbar_init();\n  }\n"
     "  __syncthreads();\n  if (tid == 0) stamp(1);\n"),
    ("        tma_load_2d(x_s + c * MP * 128, &tm_x, x_full, c * sm::kKC, "
     "0);\n",
     "        tma_load_2d(x_s + c * MP * 128, &tm_x, x_full, c * sm::kKC, "
     "0);\n      stamp(10);\n"),
    ("    __syncwarp();\n  } else {",
     "    if (tid == 128) stamp(11);\n    __syncwarp();\n  } else {"),
    ("    mbar_wait(x_full, 0);\n",
     "    mbar_wait(x_full, 0);\n    if (tid == 0) stamp(2);\n"),
    ("        mbar_wait(&full[s], (i / S) & 1);\n"
     "        const unsigned char* sp = smem + s * sm::kSlot;\n"
     "        const uint64_t dg",
     "        mbar_wait(&full[s], (i / S) & 1);\n"
     "        if (tid == 0 && i == 0) stamp(3);\n"
     "        const unsigned char* sp = smem + s * sm::kSlot;\n"
     "        const uint64_t dg"),
    ("      named_bar_sync(1, 128);      // the last unit's products are done",
     "      if (tid == 0 && u == u0) stamp(4);\n"
     "      named_bar_sync(1, 128);      "
     "// the last unit's products are done"),
    ("      const uint64_t dh = wgmma_desc(h_s, 16, 1024);",
     "      if (tid == 0 && u == u0) stamp(5);\n"
     "      const uint64_t dh = wgmma_desc(h_s, 16, 1024);"),
    ("  cluster_wait();\n  if (tid < 128) {",
     "  if (tid == 0) stamp(6);\n  cluster_wait();\n  if (tid < 128) {"),
    ("  cluster_arrive();\n  cluster_wait();\n  const bool whole",
     "  if (tid == 0) stamp(7);\n  cluster_arrive();\n  cluster_wait();\n"
     "  if (tid == 0) stamp(8);\n  const bool whole"),
    ("  if (whole) return;",
     "  if (tid == 0) stamp(9);\n  if (whole) return;"))
PHASES = ("entry", "barriers", "x", "chunk 0", "G, U", "H", "share",
          "stores", "cluster barrier", "sum", "producer x", "producer last")


def phases(torch, root):
    """The small_m kernel's phase ends at paper-backbone's M 8 and 64
    (default plan), µs from the first block's entry."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_ffn import ffn_plan, fused_ffn
    src = root / "src" / "repro_torch" / "kernels" / "csrc"
    text = (src / "fused_ffn.cu").read_text()
    for old, new in STAMPS:
        if text.count(old) != 1:
            raise SystemExit(f"--phases: the source lacks {old!r}")
        text = text.replace(old, new)
    text += ('\nextern "C" int ffn_stamps(void* host) { return (int)'
             'cudaMemcpyFromSymbol(host, g_stamp, sizeof(long long) * 256 '
             '* 16); }\n')
    out = root / "build" / "k3_phases"
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
    lib.ffn_stamps.argtypes = [ctypes.c_void_p]
    _build._LOADED["fused_ffn"] = lib
    gen = torch.Generator(device="cuda").manual_seed(3131)
    rows = {}
    for m in (8, 64):
        x, wg, wu, wd = (torch.randn(r, c, generator=gen, device="cuda")
                         .mul_(std).to(torch.bfloat16)
                         for r, c, std in ((m, 256, 1.0), (256, 1024, 1 / 16),
                                           (256, 1024, 1 / 16),
                                           (1024, 256, 1 / 32)))
        blocks = ffn_plan(torch.bfloat16, m, 256, 1024).grid[0]
        for _ in range(10):
            fused_ffn(x, wg, wu, wd)
        runs = []
        for _ in range(30):
            fused_ffn(x, wg, wu, wd)
            torch.cuda.synchronize()
            buf = np.zeros((256, 16), dtype=np.int64)
            lib.ffn_stamps(buf.ctypes.data)
            st = buf[:blocks, :12].astype(np.float64)
            runs.append((st - st[:, 0].min()) / 1e3)
        d = np.median(np.stack(runs), axis=0)
        rows[f"paper-backbone M {m}"] = {
            name: [float(d[:, k].min()), float(d[:, k].mean()),
                   float(d[:, k].max())] for k, name in enumerate(PHASES)}
    _build._LOADED.pop("fused_ffn", None)
    return rows


def geometries(kernel, m, d, f, window):
    """``kernel``'s device ms at each small_m geometry of ``GEOMETRIES``:
    the wrapper's plan swapped for ``small_plan`` at that geometry (its
    cached launch numbers cleared before and after)."""
    import importlib
    ffn = importlib.import_module("repro_torch.kernels.fused_ffn")
    plan, out = ffn.ffn_plan, {}
    try:
        for g, c in GEOMETRIES.get((d, f), ()):
            ffn._ENTRY_SHAPES.clear()
            ffn.ffn_plan = (lambda g_, c_: lambda dt, m_, d_, f_:
                            ffn.small_plan(m_, d_, f_, groups=g_,
                                           fsplits=c_))(g, c)
            kernel()
            out[f"{g},{c}"] = device_ms(kernel, window, "fused_ffn")
    finally:
        ffn.ffn_plan = plan
        ffn._ENTRY_SHAPES.clear()
    return out


def paged_step(torch, smi):
    """paper-backbone's paged int8 graph step through
    ``chip_smoke.step_split`` (imported after the root's package, so the
    root's engine runs it)."""
    sys.path.insert(1, str(TOOLS.parent))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.serving import CompileCache, ServingEngine
    cfg = get_config("paper-backbone")
    params = init_params(cfg, seed=0, device="cuda")
    eng = ServingEngine(cfg, params, slots=8, max_seq=512, block_size=16,
                        opts=RuntimeOptions(paged_kernel=True,
                                            kv_dtype="int8"),
                        decode_mode="paged", compile_cache=CompileCache(),
                        device="cuda")
    return chip_smoke.step_split(torch, eng,
                                 "paper-backbone paged int8 graph step", smi)


def combine(path):
    """Each shape's device times over the processes in ``path`` (one JSON
    line a process), grouped by root in the order they ran; the spread of
    each root's; the first root's median device time over the second's;
    each process's step figures where it measured them."""
    runs = [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.startswith("{")]
    roots = list(dict.fromkeys(r["root"] for r in runs))
    table = {}
    for label in runs[0]["shapes"]:
        row = {}
        for root in roots:
            vals = [r["shapes"][label]["device_ms"] for r in runs
                    if r["root"] == root and label in r["shapes"]]
            row[root] = dict(device_ms=vals, spread=spread(vals),
                             route=next(r["shapes"][label]["route"]
                                        for r in runs if r["root"] == root),
                             geometries=[r["shapes"][label]["geometries"]
                                         for r in runs if r["root"] == root
                                         and "geometries"
                                         in r["shapes"][label]])
        last = runs[-1]["shapes"][label]
        row.update(chain_device_ms=last["chain_device_ms"],
                   bound_ms=last["bound_ms"])
        if len(roots) == 2:
            med = [statistics.median(v for v in row[r]["device_ms"] if v)
                   for r in roots]
            row["first_over_second"] = med[0] / med[1]
        table[label] = row
    steps = {root: [r["step"] for r in runs
                    if r["root"] == root and "step" in r] for root in roots}
    return dict(card=runs[0]["card"], roots=roots, shapes=table,
                step=steps)


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
