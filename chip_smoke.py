#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device — a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.  Builds every CUDA kernel of the port from ``src/`` with
   ``nvcc`` into ``build/``.
2. kernels — each kernel against its plain PyTorch version on the card
   at the main path's shapes (tolerances below), then timed beside its
   plain version, its byte/operation bound and one library call.
3. serving — ``ServingEngine`` serves full-width ``paper-backbone``
   (paged pool, ``paged_kernel=True``, ``kv_dtype="int8"``) from random
   weights made from a seed: two waves of 16 requests.  Asserts budgets,
   kernel launches == decode steps x layers, and no new program on the
   second wave.
4. card against CPU — an f32-activation variant serves 4 greedy requests
   on the card and through the port's plain versions on the CPU; the
   token streams must be equal.

The line before the last is a JSON object listing every kernel with its
launches on the main path and its times; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores
# kernel vs plain version: both accumulate in f32 and differ only in the
# order of the softmax sums (online vs one pass); bf16 outputs may then
# round one bf16 ulp apart (2**-8 relative)
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1
def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke runs only on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(smi)
    # f32 matmuls in full f32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for path in libs.values():
        log_path = path.with_suffix(".log")
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log("  ptxas: " + line.strip())
    return smi


# ---------------------------------------------------------------- phase 2
def make_case(torch, gen, *, slots, heads, kvh, hd, bs, mb, pool_dtype,
              q_dtype, pos_kind, layers=2, layer=1):
    """One paged-decode problem on the card.  The pool interleaves
    ``layers`` layers like the serving pool does, and the kernel reads
    layer ``layer`` in place through its block stride."""
    from repro_torch.kernels.act_quant import kv_quant_rows
    nb = slots * mb + 1
    shape = (nb, layers, bs, kvh, hd)
    k = torch.randn(shape, generator=gen)
    v = torch.randn(shape, generator=gen)
    scales = {}
    if pool_dtype == "int8":
        k, ks = kv_quant_rows(k)
        v, vs = kv_quant_rows(v)
        scales = dict(k_scale=ks.cuda()[:, layer], v_scale=vs.cuda()[:, layer])
    else:
        dt = getattr(torch, pool_dtype)
        k, v = k.to(dt), v.to(dt)
    qd = getattr(torch, q_dtype)
    if pos_kind == "zero":
        pos = torch.zeros(slots, dtype=torch.int32)
    elif pos_kind == "full_tail":
        pos = torch.full((slots,), mb * bs, dtype=torch.int32)
    elif pos_kind == "ragged":
        pos = torch.randint(0, mb * bs + 1, (slots,), generator=gen,
                            dtype=torch.int32)
        pos[0], pos[-1] = 0, mb * bs
    else:                              # the serving run's decode positions
        pos = torch.randint(16, 289, (slots,), generator=gen,
                            dtype=torch.int32)
    args = (torch.randn(slots, heads, hd, generator=gen).to(qd).cuda(),
            k.cuda()[:, layer], v.cuda()[:, layer],
            torch.randint(0, nb, (slots, mb), generator=gen,
                          dtype=torch.int32).cuda(),
            pos.cuda(),
            torch.randn(slots, kvh, hd, generator=gen).to(qd).cuda(),
            torch.randn(slots, kvh, hd, generator=gen).to(qd).cuda())
    return args, scales


def cuda_ms(torch, fn, iters=200, warmup=10):
    for _ in range(warmup):
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


def paged_bound_ms(args, scales):
    """Least time for one call on the H100: each input byte the call needs
    read once (only the pool rows that hold a valid column), the output
    written once; the f32 work of the two products over those rows.
    Returns ``(ms, "bytes" or "operations")``."""
    q, kb, vb, tables, pos, kn, vn = args
    slots, heads, hd = q.shape
    _, bs, kvh, _ = kb.shape
    rows = [min(int(p), tables.shape[1] * bs) for p in pos.cpu()]
    row_bytes = 2 * kvh * hd * kb.element_size() + (8 if scales else 0)
    nbytes = (sum(rows) * row_bytes
              + 2 * q.numel() * q.element_size()
              + 2 * kn.numel() * kn.element_size()
              + tables.numel() * 4 + pos.numel() * 4)
    flops = sum(4 * heads * hd * (r + 1) for r in rows)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_yardstick(torch, args, scales):
    """One library call computing the same attention: SDPA over the
    slot's KV gathered dense beforehand (dequantized, new token appended,
    invalid columns masked).  Only the SDPA call is timed; the port never
    calls it."""
    import torch.nn.functional as F
    q, kb, vb, tables, pos, kn, vn = args
    slots, heads, hd = q.shape
    _, bs, kvh, _ = kb.shape
    mb = tables.shape[1]
    idx = tables.long()
    kf = kb[idx].float().reshape(slots, mb * bs, kvh, hd)
    vf = vb[idx].float().reshape(slots, mb * bs, kvh, hd)
    if scales:
        kf = kf * scales["k_scale"][idx].reshape(slots, mb * bs, 1, 1)
        vf = vf * scales["v_scale"][idx].reshape(slots, mb * bs, 1, 1)
    kf = torch.cat([kf, kn.float()[:, None]], 1).to(q.dtype)
    vf = torch.cat([vf, vn.float()[:, None]], 1).to(q.dtype)
    group = heads // kvh
    kd = kf.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    vd = vf.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    cols = torch.arange(mb * bs + 1, device=q.device)
    valid = (cols[None] < pos[:, None]) | (cols[None] == mb * bs)
    mask = valid[:, None, None, :]
    q4 = q[:, :, None, :]
    return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask))


def phase_kernels(torch):
    from repro_torch.kernels.paged_decode_attn import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attn_ref
    gen = torch.Generator().manual_seed(1234)
    max_err = 0.0
    n_cases = 0
    base = dict(slots=8, hd=32, bs=16, mb=32)      # max_seq 512
    for heads, kvh in ((8, 8), (8, 2)):
        for pool_dtype in ("int8", "bfloat16"):
            for q_dtype in ("bfloat16", "float32"):
                for pos_kind in ("zero", "ragged", "full_tail"):
                    for window in (0, 5):
                        args, sc = make_case(
                            torch, gen, heads=heads, kvh=kvh,
                            pool_dtype=pool_dtype, q_dtype=q_dtype,
                            pos_kind=pos_kind, **base)
                        out = paged_decode_attention(*args, window=window,
                                                     **sc)
                        ref = paged_decode_attn_ref(*args, window=window,
                                                    **sc)
                        torch.cuda.synchronize()
                        diff = (out.float() - ref.float()).abs()
                        err = float(diff.max())
                        tol = TOL[q_dtype]
                        bad = diff > (tol["atol"]
                                      + tol["rtol"] * ref.float().abs())
                        if bool(bad.any()):
                            raise AssertionError(
                                f"paged_decode_attention disagrees with its "
                                f"plain version: H={heads} kvh={kvh} "
                                f"pool={pool_dtype} q={q_dtype} "
                                f"pos={pos_kind} window={window} "
                                f"max_abs_err={err}")
                        if pos_kind == "zero":
                            expect = args[6].repeat_interleave(heads // kvh,
                                                               dim=1)
                            if not torch.equal(out, expect.to(out.dtype)):
                                raise AssertionError(
                                    "pos == 0 must give out == v_new")
                        max_err = max(max_err, err)
                        n_cases += 1
    log(f"paged_decode_attention == plain version on {n_cases} cases, "
        f"max_abs_err {max_err:.3g}")

    # timing at the serving run's shapes: 8 slots, 8 kv heads, int8 pool
    # interleaving 8 layers, bf16 activations, decode positions 16..288
    args, sc = make_case(torch, gen, heads=8, kvh=8, pool_dtype="int8",
                         q_dtype="bfloat16", pos_kind="serving", layers=8,
                         layer=3, **base)
    ms = cuda_ms(torch, lambda: paged_decode_attention(*args, **sc))
    plain_ms = cuda_ms(torch, lambda: paged_decode_attn_ref(*args, **sc))
    library_ms = sdpa_yardstick(torch, args, sc)
    bound_ms, bound_by = paged_bound_ms(args, sc)
    log(f"paged_decode_attention: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
            "replaces": "src/repro/kernels/paged_decode_attn.py:175",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------- phase 3
def _prompts(n_req, seed, vocab):
    """``n_req`` prompts of 8..200 tokens.  The lengths are fixed, so every
    wave hits the same prompt buckets; ``seed`` draws the tokens."""
    import numpy as np
    lens = [8, 200] + list(np.random.default_rng(0).integers(
        8, 201, n_req - 4)) + [100, 100]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    # the last two share their first 64 tokens: same bucket, same leading
    # blocks, so the pool deduplicates them
    prompts[-1][:64] = prompts[-2][:64]
    return prompts


def serve_wave(torch, eng, prompts, rid_base, new_tokens):
    from repro_torch.serving import Request, SamplingOpts
    reqs = [Request(rid=rid_base + i, prompt=p, max_new_tokens=new_tokens,
                    sampling=SamplingOpts(temperature=0.8 if i % 2 else 0.0,
                                          seed=7))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps0, tokens0 = eng.stats.steps, eng.stats.tokens_out
    for r in reqs:
        eng.submit(r)
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if not r.done or len(r.generated) != new_tokens:
            raise AssertionError(f"request {r.rid} ended with "
                                 f"{len(r.generated)} of {new_tokens} tokens")
        if not all(0 <= t < eng.cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.rid} emitted an id out of "
                                 "the vocabulary")
    steps = eng.stats.steps - steps0
    step_ms = 1e3 * sum(list(eng.step_times)[-steps:]) / steps
    return (eng.stats.tokens_out - tokens0) / wall, step_ms, reqs


def phase_serving(torch, name):
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_decode_attn import paged_decode_attention
    from repro_torch.models import init_params
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.serving import CompileCache, ServingEngine
    cfg = get_config("paper-backbone")
    params = init_params(cfg, seed=0, device="cuda")
    opts = RuntimeOptions(paged_kernel=True, kv_dtype="int8")
    eng = ServingEngine(cfg, params, slots=8, max_seq=512, block_size=16,
                        opts=opts, compile_cache=CompileCache(),
                        device="cuda")
    paged_decode_attention.launches = 0
    tps1, ms1, _ = serve_wave(torch, eng, _prompts(16, 1, cfg.vocab_size),
                              0, 32)
    warm = eng.stats.recompiles
    tps2, ms2, _ = serve_wave(torch, eng, _prompts(16, 2, cfg.vocab_size),
                              100, 32)
    launches = paged_decode_attention.launches
    if eng.stats.recompiles != warm:
        raise AssertionError(f"second wave built {eng.stats.recompiles - warm}"
                             " new programs")
    expect = eng.stats.decode_calls * cfg.num_layers
    if launches != expect:
        raise AssertionError(f"paged_decode_attention launched {launches} "
                             f"times, expected {expect} (decode steps "
                             f"{eng.stats.decode_calls} x {cfg.num_layers} "
                             "layers)")
    log(f"serving paper-backbone paged int8 on {name}: wave 1 {tps1:.1f} "
        f"tok/s, {ms1:.3f} ms/decode step; wave 2 {tps2:.1f} tok/s, "
        f"{ms2:.3f} ms/decode step; decode steps {eng.stats.decode_calls}, "
        f"kernel launches {launches}, prefill calls "
        f"{eng.stats.prefill_calls}, recompiles {eng.stats.recompiles}")
    profile_decode_steps(torch, eng, ms2)
    return launches


def profile_decode_steps(torch, eng, step_ms, steps=8):
    """Where a steady decode step's time goes: ``torch.profiler`` over
    ``steps`` steps with 8 busy slots gives the device time per step by
    kernel; against the unprofiled step time ``step_ms`` it gives the
    device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request
    prompts = _prompts(8, 3, eng.cfg.vocab_size)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=1000 + i, prompt=p, max_new_tokens=64))
    eng.step()                                  # admission + first decode
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.drain()

    def device_us(e):
        return e.self_device_time_total

    # device-side entries only (kernels, memcpy, memset): the CPU ops that
    # launched them report the same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    log(f"decode step profile ({steps} steps, 8 busy slots): device busy "
        f"{busy_ms:.3f} ms/step over {launches:.0f} device ops/step; "
        f"idle share {1 - busy_ms / step_ms:.3f} of a {step_ms:.3f} ms step")
    for e in sorted(kernels, key=device_us, reverse=True)[:6]:
        log(f"  {device_us(e) / 1e3 / steps:.4f} ms/step  "
            f"{e.count // steps:4d}x  {e.key[:70]}")


# ---------------------------------------------------------------- phase 4
def phase_card_vs_cpu(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.serving import (CompileCache, Request, SamplingOpts,
                                     ServingEngine)
    cfg = get_config("paper-backbone").with_updates(
        activation_dtype="float32")
    opts = RuntimeOptions(paged_kernel=True, kv_dtype="int8")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (8, 37, 120, 200)]
    streams = {}
    for device in ("cuda", "cpu"):
        params = init_params(cfg, seed=0, device=device)
        eng = ServingEngine(cfg, params, slots=4, max_seq=512,
                            block_size=16, opts=opts,
                            compile_cache=CompileCache(), device=device)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=32,
                        sampling=SamplingOpts(temperature=0.0))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams[device] = [tuple(r.generated) for r in reqs]
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError(f"card and CPU greedy streams differ:\n"
                             f"cuda {streams['cuda']}\ncpu  {streams['cpu']}")
    log(f"card == CPU greedy streams on {len(prompts)} requests x 32 tokens")


def main() -> int:
    import torch
    smi = phase_device(torch)
    name = torch.cuda.get_device_name(0)
    kernel = phase_kernels(torch)
    kernel["launches"] = phase_serving(torch, smi)
    phase_card_vs_cpu(torch)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
