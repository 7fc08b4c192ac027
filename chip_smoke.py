#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device — a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.  Builds every CUDA kernel of the port from ``src/`` with
   ``nvcc`` (one process per source, all at once) into ``build/``.
2. kernels — each kernel against its plain PyTorch version on the card
   (tolerances below): K1 paged decode attention at max_seq 512 and 2048
   tables, K2 flash attention (bf16 on the tensor cores, f32 on the CUDA
   cores) over its masks, dtypes, head dims 16..256, head groupings and
   lengths up to 2048, K3 fused gated FFN (bf16 small-M and tile routes,
   f32) over both activations, dtypes, ragged and large M, ragged F and
   widths up to 1024, each repeating bit for bit, K6 SSD scan
   over ragged and multi-chunk lengths, groups, head/state widths,
   dtypes and both layouts, K4/K5 activation quantization (int8 and
   packed int4, quant and dequant) over M 1..16384, n 128..50280 (ragged),
   f32/bf16 in and out and leading dimensions through ``act_compress``,
   bit-equal.  Each is then timed at its path's shapes beside its plain
   version, its byte/operation bound and one library call where there is
   one (for K4/K5, which no one call computes, a device-to-device copy of
   the same input bytes as the bandwidth reference).
3. serving — ``ServingEngine`` serves from random weights made from a
   seed: full-width ``paper-backbone`` paged (``paged_kernel=True``,
   ``kv_dtype="int8"``) in two waves of 16 short requests at max_seq
   512, then a long wave of 16 requests at max_seq 2048 (prompt buckets
   1024 and 2048, served twice); full-width ``mamba2-370m`` in the
   batched mode, two waves of 16 requests of 8-2000 tokens at max_seq
   4096; and one short batched wave of ``paper-backbone``.  Asserts
   budgets, the launches of each kernel against each path's decode
   steps and prefill calls, and no new program when a wave repeats;
   prints TTFT per bucket, the decode-step time and device profiles of
   a decode step and of a long prefill call (with K1's, K2's and K3's
   device time in each).
4. engine — the model-adaptive engine's entry points on the card at full
   width: one ``model.prefill`` of 8 x 2048 tokens each of
   ``mamba2-370m`` (K6) and ``paper-backbone`` (dense bf16 KV, K2/K3);
   their SSM state, last logits and K/V rows go through
   ``act_compress`` at 8 and 4 bits (K4/K5), held bit-equal to the plain
   versions, with the codec's error bounds and byte counts asserted; the
   int8 SSM state swaps out to pinned host memory and back bit-exactly,
   twice through one Swapper (the second round reuses the pinned buffers
   of the first; measured GB/s beside the swap model's); the host-side
   planners (graph, fusion, memory plan, parallelism, partition,
   placement on every pool, remat policy and sub-batches under the
   card's free memory) run on both configs.  Launches of every kernel
   are counted.
5. card against CPU — f32-activation variants serve greedy requests on
   the card and through the port's plain versions on the CPU: 5 of
   ``paper-backbone`` paged (one at bucket 1024), 4 of the reduced
   ``gemma3-12b`` paged (window 64; three prompts select ``banded``) and
   4 of ``mamba2-370m`` batched with f32 caches; the token streams must
   be equal.

The line before the last is a JSON object listing every kernel with its
launches on its main path and its times (K4 and K5 as their four entry
points: act_quant, act_dequant, act_quant4, act_dequant4); the last
line is ``{"ok": true, "device": {...}}``.
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
H100_BF16_FLOPS = 989e12       # bf16 tensor cores, dense
# kernel vs plain version: both accumulate in f32 and differ only in the
# order of the sums (online vs one-pass softmax; the FFN's sums over D
# and F); bf16 outputs may then round one bf16 ulp apart (2**-8
# relative).  The FFN's f32 sums run over up to D + F = 5120 terms of
# magnitude ~1, so its f32 tolerance is a little wider.
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}
FFN_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
           "bfloat16": dict(atol=2e-2, rtol=1e-2)}
# the SSD scan's y reaches |y| ~ 20 after f32 sums of up to 256 x 128
# terms taken in another order than the plain einsums: atol 1e-3 (~5e-5
# of the largest output); its final state (|state| ~ 3) atol 1e-4
SSD_TOL = {"float32": dict(atol=1e-3, rtol=1e-4),
           "bfloat16": dict(atol=2e-2, rtol=1e-2)}
STATE_TOL = dict(atol=1e-4, rtol=1e-4)


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
    elif pos_kind == "long":           # the long wave's decode positions
        pos = torch.randint(600, 1057, (slots,), generator=gen,
                            dtype=torch.int32)
    else:                              # the short waves' decode positions
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


def device_ms(torch, fn, iters=50, part="", tries=3):
    """Device time of one call of ``fn`` in ms: the profiler's device time
    over ``iters`` calls of the kernels whose name holds ``part`` (all of
    them by default), divided by ``iters``.  Unlike a CUDA-event loop it
    leaves out the host's time to issue each call.  A profile that
    recorded no such kernel is taken again, up to ``tries`` times; then
    the time is ``None`` (not measured), never 0."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and part in e.key)
        if us > 0:
            return us / 1e3 / iters
    return None


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
    return bound(nbytes, flops, H100_F32_FLOPS)


def bound(nbytes, flops, peak_flops):
    """Least time on the H100 in ms: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type.
    Returns ``(ms, "bytes" or "operations")``."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / peak_flops
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


def check_close(name, out, ref, tol, what):
    """Raise unless ``out`` agrees with ``ref`` elementwise within
    ``tol``; returns the max abs error."""
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    bad = diff > (tol["atol"] + tol["rtol"] * ref.float().abs())
    if bool(bad.any()):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{what} max_abs_err={err}")
    return err


def phase_paged(torch):
    from repro_torch.kernels.paged_decode_attn import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attn_ref
    gen = torch.Generator().manual_seed(1234)
    max_err = 0.0
    n_cases = 0
    # tables of max_seq 512 (mb 32) over the full grid; of max_seq 2048
    # (mb 128) over pools, groupings and lengths
    grids = [(32, ("int8", "bfloat16"), ("bfloat16", "float32"),
              ("zero", "ragged", "full_tail"), (0, 5)),
             (128, ("int8", "bfloat16"), ("bfloat16",),
              ("ragged", "full_tail"), (0,))]
    for mb, pools, q_dtypes, pos_kinds, windows in grids:
        for heads, kvh in ((8, 8), (8, 2)):
            for pool_dtype in pools:
                for q_dtype in q_dtypes:
                    for pos_kind in pos_kinds:
                        for window in windows:
                            args, sc = make_case(
                                torch, gen, slots=8, hd=32, bs=16, mb=mb,
                                heads=heads, kvh=kvh, pool_dtype=pool_dtype,
                                q_dtype=q_dtype, pos_kind=pos_kind)
                            out = paged_decode_attention(
                                *args, window=window, **sc)
                            ref = paged_decode_attn_ref(
                                *args, window=window, **sc)
                            torch.cuda.synchronize()
                            err = check_close(
                                "paged_decode_attention", out, ref,
                                TOL[q_dtype],
                                f"mb={mb} H={heads} kvh={kvh} "
                                f"pool={pool_dtype} q={q_dtype} "
                                f"pos={pos_kind} window={window}")
                            if pos_kind == "zero":
                                expect = args[6].repeat_interleave(
                                    heads // kvh, dim=1)
                                if not torch.equal(out, expect.to(out.dtype)):
                                    raise AssertionError(
                                        "pos == 0 must give out == v_new")
                            max_err = max(max_err, err)
                            n_cases += 1
    log(f"paged_decode_attention == plain version on {n_cases} cases "
        f"(mb 32 and 128), max_abs_err {max_err:.3g}")

    # timing at the short waves' shapes: 8 slots, 8 kv heads, int8 pool
    # interleaving 8 layers, bf16 activations, decode positions 16..288
    args, sc = make_case(torch, gen, heads=8, kvh=8, pool_dtype="int8",
                         q_dtype="bfloat16", pos_kind="serving", layers=8,
                         layer=3, slots=8, hd=32, bs=16, mb=32)
    ms = cuda_ms(torch, lambda: paged_decode_attention(*args, **sc))
    plain_ms = cuda_ms(torch, lambda: paged_decode_attn_ref(*args, **sc))
    library_ms = sdpa_yardstick(torch, args, sc)
    bound_ms, bound_by = paged_bound_ms(args, sc)
    log(f"paged_decode_attention (8 slots, mb 32): kernel_ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
        f"bound_ms {bound_ms:.5f} ({bound_by})")
    # the long wave's tables (mb 128), slots holding 600..1056 tokens
    args2, sc2 = make_case(torch, gen, heads=8, kvh=8, pool_dtype="int8",
                           q_dtype="bfloat16", pos_kind="long", layers=8,
                           layer=3, slots=8, hd=32, bs=16, mb=128)
    ms2 = cuda_ms(torch, lambda: paged_decode_attention(*args2, **sc2))
    b2, _ = paged_bound_ms(args2, sc2)
    log(f"paged_decode_attention (8 slots, mb 128, 600..1056 tokens): "
        f"kernel_ms {ms2:.4f} bound_ms {b2:.5f}")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
            "replaces": "src/repro/kernels/paged_decode_attn.py:175",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": "8 slots x 8 kv heads x hd 32, int8 pool, mb 32, "
                     "positions 16..288"}


def flash_case(torch, gen, b, h, kvh, s, hd, dtype):
    """q (B,S,H,hd), k/v (B,S,K,hd) on the card as the model holds them
    after rotary, passed as (B,H,S,hd) / (B,K,S,hd) views."""
    dt = getattr(torch, dtype)
    q = torch.randn(b, s, h, hd, generator=gen).to(dt).cuda()
    k = torch.randn(b, s, kvh, hd, generator=gen).to(dt).cuda()
    v = torch.randn(b, s, kvh, hd, generator=gen).to(dt).cuda()
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def flash_plain(q, k, v, **mask):
    from repro_torch.kernels.ref import flash_attn_ref
    g = q.shape[1] // k.shape[1]
    return flash_attn_ref(q, k.repeat_interleave(g, 1),
                          v.repeat_interleave(g, 1), **mask)


def flash_pairs(s, causal, window, kv_len):
    """Valid (row, col) pairs of one head: the work the data needs."""
    import numpy as np
    rows = np.arange(s)[:, None]
    cols = np.arange(s)[None, :]
    valid = np.broadcast_to(cols < (s if kv_len is None else kv_len),
                            (s, s)).copy()
    if causal:
        valid &= cols <= rows
    if window:
        valid &= cols > rows - window
    return int(valid.sum())


def max_sm_clock_hz():
    """The card's top SM clock as ``nvidia-smi`` reports it, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def phase_flash(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import attention_route, flash_attention
    gen = torch.Generator().manual_seed(4321)
    max_err = 0.0
    n_cases = 0
    for s in (16, 1024, 2048):
        b = 2 if s == 16 else 1
        masks = [dict(causal=True), dict(causal=True, window=1),
                 dict(causal=True, window=64),
                 dict(causal=True, window=s + 7),
                 dict(causal=True, kv_len=0),
                 dict(causal=True, kv_len=s * 2 // 3 + 5),
                 dict(causal=False)]
        for mask in masks:
            for dtype in ("bfloat16", "float32"):
                for hd in (16, 32, 64, 128, 256):
                    for h, kvh in ((8, 8), (8, 2)):
                        q, k, v = flash_case(torch, gen, b, h, kvh, s, hd,
                                             dtype)
                        out = flash_attention(q, k, v, **mask)
                        ref = flash_plain(q, k, v, **mask)
                        torch.cuda.synchronize()
                        what = (f"S={s} hd={hd} H={h} kvh={kvh} {dtype} "
                                f"({attention_route(q.dtype)}) {mask}")
                        err = check_close("flash_attention", out, ref,
                                          TOL[dtype], what)
                        if mask.get("kv_len") == 0 \
                                and not bool((out == 0).all()):
                            raise AssertionError("kv_len 0 must give 0")
                        if not torch.equal(out, flash_attention(q, k, v,
                                                                **mask)):
                            raise AssertionError("flash_attention does not "
                                                 "repeat: " + what)
                        max_err = max(max_err, err)
                        n_cases += 1
    log(f"flash_attention == plain version on {n_cases} cases (bf16 on the "
        f"tensor cores, f32 on the CUDA cores, hd 16..256), each repeating "
        f"bit for bit, max_abs_err {max_err:.3g}")

    # timing at the long wave's prefill bursts: 8 prompts x 8 heads x hd
    # 32, bf16, causal (the engine passes no kv_len)
    clock = max_sm_clock_hz()
    timed = {}
    for b, s in ((8, 2048), (8, 1024)):
        q, k, v = flash_case(torch, gen, b, 8, 8, s, 32, "bfloat16")
        ms = cuda_ms(torch, lambda: flash_attention(q, k, v), iters=50)
        plain_ms = cuda_ms(torch, lambda: flash_plain(q, k, v), iters=5,
                           warmup=2)
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=50)
        dev_ms = device_ms(torch, lambda: flash_attention(q, k, v),
                           part="flash_attn")
        library_dev_ms = device_ms(torch, lambda: (
            F.scaled_dot_product_attention(q, k, v, is_causal=True)))
        nbytes = 4 * q.numel() * q.element_size()
        pairs = flash_pairs(s, True, 0, None) * b * 8
        bound_ms, bound_by = bound(nbytes, 4 * 32 * pairs, H100_BF16_FLOPS)
        # one ex2 per valid pair at 16 a clock per SM on 132 SMs
        exp_ms = 1e3 * pairs / (16 * 132 * clock)
        timed[s] = (ms, plain_ms, library_ms, bound_ms, bound_by, exp_ms,
                    dev_ms, library_dev_ms)
        log(f"flash_attention ({b} x {s} tokens, 8 heads, hd 32, bf16, "
            f"causal): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} bound_ms {bound_ms:.5f} "
            f"({bound_by}); device time kernel {fmt(dev_ms)}, SDPA "
            f"{fmt(library_dev_ms)}; exponential floor {exp_ms:.5f} ms "
            f"({pairs} pairs at {clock / 1e9:.3f} GHz)")
    (ms, plain_ms, library_ms, bound_ms, bound_by, exp_ms, dev_ms,
     library_dev_ms) = timed[2048]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:96",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "exp_floor_ms": exp_ms, "device_ms": dev_ms,
            "library_device_ms": library_dev_ms,
            "ms_8x1024": timed[1024][0], "library_ms_8x1024": timed[1024][2],
            "device_ms_8x1024": timed[1024][6],
            "library_device_ms_8x1024": timed[1024][7],
            "shape": "8 x 2048 tokens, 8 heads, hd 32, bf16, causal "
                     "(tensor cores)"}


def ffn_case(torch, gen, m, d, f, dtype):
    dt = getattr(torch, dtype)
    return (torch.randn(m, d, generator=gen).to(dt).cuda(),
            (torch.randn(d, f, generator=gen) * d ** -0.5).to(dt).cuda(),
            (torch.randn(d, f, generator=gen) * d ** -0.5).to(dt).cuda(),
            (torch.randn(f, d, generator=gen) * f ** -0.5).to(dt).cuda())


def phase_ffn(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.fused_ffn import ffn_plan, fused_ffn
    from repro_torch.kernels.ref import fused_ffn_ref
    gen = torch.Generator().manual_seed(2468)
    max_err = 0.0
    n_cases = 0
    cases = [(m, d, f, dtype) for d, f in ((256, 1024), (1024, 4096))
             for m in (8, 100, 8192) for dtype in ("bfloat16", "float32")]
    # the bf16 routes at their edges: ragged M and F, D over several
    # output tiles, x resident or streamed, small M at D 1024
    cases += [(m, d, f, "bfloat16") for m, d, f in (
        (1, 256, 1024), (64, 256, 1000), (65, 256, 1024), (8195, 256, 1024),
        (127, 264, 200), (300, 512, 1032), (16, 1024, 4096))]
    routes = {}
    for m, d, f, dtype in cases:
        for act in ("silu", "gelu"):
            args = ffn_case(torch, gen, m, d, f, dtype)
            out = fused_ffn(*args, act)
            ref = fused_ffn_ref(*args, act)
            torch.cuda.synchronize()
            route = ffn_plan(args[0].dtype, m, d, f).route
            err = check_close("fused_ffn", out, ref, FFN_TOL[dtype],
                              f"M={m} D={d} F={f} {dtype} {act} ({route})")
            if not torch.equal(out, fused_ffn(*args, act)):
                raise AssertionError(f"fused_ffn does not repeat: M={m} "
                                     f"D={d} F={f} {dtype} ({route})")
            routes[route] = routes.get(route, 0) + 1
            max_err = max(max_err, err)
            n_cases += 1
    log(f"fused_ffn == plain version on {n_cases} cases (by route "
        f"{routes}), each repeating bit for bit, max_abs_err {max_err:.3g}")

    # timing at paper-backbone's widths (D 256, F 1024, bf16, silu): a
    # decode step (M 8) and a prefill burst of 8 x 2048 tokens
    timed = {}
    for m in (8, 8 * 2048):
        x, wg, wu, wd = ffn_case(torch, gen, m, 256, 1024, "bfloat16")
        iters = 200 if m == 8 else 50
        ms = cuda_ms(torch, lambda: fused_ffn(x, wg, wu, wd), iters=iters)
        plain_ms = cuda_ms(torch, lambda: fused_ffn_ref(x, wg, wu, wd),
                           iters=iters)
        chain_ms = cuda_ms(torch, lambda: (F.silu(x @ wg) * (x @ wu)) @ wd,
                           iters=iters)
        dev_ms = device_ms(torch, lambda: fused_ffn(x, wg, wu, wd),
                           part="fused_ffn")
        chain_dev_ms = device_ms(
            torch, lambda: (F.silu(x @ wg) * (x @ wu)) @ wd)
        nbytes = (2 * x.numel() + wg.numel() + wu.numel()
                  + wd.numel()) * x.element_size()
        bound_ms, bound_by = bound(nbytes, 6 * m * 256 * 1024,
                                   H100_BF16_FLOPS)
        timed[m] = (ms, plain_ms, bound_ms, bound_by, chain_ms, dev_ms,
                    chain_dev_ms)
        log(f"fused_ffn (M {m}, D 256, F 1024, bf16, "
            f"{ffn_plan(x.dtype, m, 256, 1024).route}): kernel_ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}); "
            f"unfused bf16 cuBLAS chain {chain_ms:.4f} ms; device time "
            f"kernel {fmt(dev_ms)}, chain {fmt(chain_dev_ms)}")
    # gelu (the gemma configs') on the tile route, beside silu above
    x, wg, wu, wd = ffn_case(torch, gen, 8 * 2048, 256, 1024, "bfloat16")
    gelu_ms = cuda_ms(torch, lambda: fused_ffn(x, wg, wu, wd, "gelu"),
                      iters=50)
    gelu_dev_ms = device_ms(torch, lambda: fused_ffn(x, wg, wu, wd, "gelu"),
                            part="fused_ffn")
    log(f"fused_ffn (M {8 * 2048}, D 256, F 1024, bf16, gelu): kernel_ms "
        f"{gelu_ms:.4f}; device time {fmt(gelu_dev_ms)}")
    ms, plain_ms, bound_ms, bound_by, chain_ms, dev_ms, chain_dev_ms = \
        timed[8]
    big = timed[8 * 2048]
    return {"name": "fused_ffn", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_ffn.cu",
            "replaces": "src/repro/kernels/fused_ffn.py:54",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "chain_ms": chain_ms,
            "device_ms": dev_ms, "chain_device_ms": chain_dev_ms,
            "ms_m16384": big[0], "plain_ms_m16384": big[1],
            "bound_ms_m16384": big[2], "bound_by_m16384": big[3],
            "chain_ms_m16384": big[4], "device_ms_m16384": big[5],
            "chain_device_ms_m16384": big[6],
            "ms_m16384_gelu": gelu_ms, "device_ms_m16384_gelu": gelu_dev_ms,
            "shape": "M 8 (a decode step; small-M route), D 256, F 1024, "
                     "bf16, silu; *_m16384: M 8 x 2048 (tile route)"}


def ssd_case(torch, gen, b, s, h, g, p, n, dtype):
    """x (B,S,H,P) and b, c (B,S,G,N) as views of one (B,S,conv_dim)
    buffer, like the model's views of its conv output; dt (B,S,H) f32
    after softplus; a (H,) < 0."""
    dt_ = getattr(torch, dtype)
    conv = torch.randn(b, s, h * p + 2 * g * n, generator=gen)
    conv[..., h * p:] *= n ** -0.25
    conv = conv.to(dt_).cuda()
    x = conv[..., :h * p].reshape(b, s, h, p)
    bm = conv[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = conv[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen) - 1.0).cuda()
    a = -torch.exp(torch.randn(h, generator=gen) * 0.5).cuda()
    return x, dt, a, bm, cm


def ssd_work(b, s, h, g, p, n, chunk, x_bytes, y_bytes):
    """(bytes, operations) one SSD scan needs: each input read once and
    each output written once; the products over the causal pairs of
    each chunk (scores over N, weights times x over P) plus the carried
    state's term and the state update (2 P N a row each)."""
    nbytes = (b * s * h * p * (x_bytes + y_bytes) + b * s * h * 4 + h * 4
              + 2 * b * s * g * n * x_bytes + b * h * p * n * 4)
    flops = 0
    for c0 in range(0, s, chunk):
        rows = min(chunk, s - c0)
        flops += rows * (rows + 1) // 2 * 2 * (n + p) + rows * 4 * p * n
    return nbytes, flops * b * h


def phase_ssd(torch):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_scan_kernel_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.ssm import ssd_scan_ref
    gen = torch.Generator().manual_seed(8642)
    max_err = 0.0
    n_cases = 0
    for s in (16, 200, 256, 1000, 2048):
        for p, n in ((64, 128), (32, 32)):
            for dtype in ("bfloat16", "float32"):
                for g in (1, 4):
                    # the model's layout, against ssm.ssd_scan_ref
                    x, dt, a, bm, cm = ssd_case(torch, gen, 2, s, 8, g, p, n,
                                                dtype)
                    y, st = ssd_scan(x, dt, a, bm, cm, chunk=256)
                    yr, str_ = ssd_scan_ref(x, dt, a, bm, cm, chunk=256)
                    torch.cuda.synchronize()
                    what = f"S={s} P={p} N={n} G={g} {dtype}"
                    err = check_close("ssd_scan", y, yr, SSD_TOL[dtype],
                                      "y " + what)
                    check_close("ssd_scan", st, str_, STATE_TOL,
                                "state " + what)
                    y2, st2 = ssd_scan(x, dt, a, bm, cm, chunk=256)
                    if not (torch.equal(y, y2) and torch.equal(st, st2)):
                        raise AssertionError("ssd_scan does not repeat")
                    max_err = max(max_err, err)
                    n_cases += 1
                # the Pallas layout through ops.ssd (f32 y), against
                # ref.ssd_scan_kernel_ref: 8 rows, each its own head
                x, dt, a, bm, cm = ssd_case(torch, gen, 1, s, 8, 8, p, n,
                                            dtype)
                kx, kdt = x[0].transpose(0, 1), dt[0].transpose(0, 1)
                kb, kc = bm[0].transpose(0, 1), cm[0].transpose(0, 1)
                y, st = ops.ssd(kx, kdt, a, kb, kc, chunk=128)
                yr, str_ = ssd_scan_kernel_ref(kx.float(), kdt, a, kb, kc,
                                               128)
                torch.cuda.synchronize()
                what = f"ops.ssd S={s} P={p} N={n} {dtype}"
                err = check_close("ssd_scan", y, yr, SSD_TOL["float32"],
                                  "y " + what)
                check_close("ssd_scan", st, str_, STATE_TOL, "state " + what)
                max_err = max(max_err, err)
                n_cases += 1
    log(f"ssd_scan == plain version on {n_cases} cases, max_abs_err "
        f"{max_err:.3g}")

    # the mamba2 prefill burst, the main path's shape: 8 prompts x 2048
    # tokens, 32 heads of 64, state 128, one group, chunk 256, x/b/c as
    # views of a 2304-wide conv row; checked in f32 and in bf16, then
    # timed in bf16 in and out
    b, s, h, g, p, n = 8, 2048, 32, 1, 64, 128
    for dtype in ("float32", "bfloat16"):
        x, dt, a, bm, cm = ssd_case(torch, gen, b, s, h, g, p, n, dtype)
        y, st = ssd_scan(x, dt, a, bm, cm, chunk=256)
        yr, str_ = ssd_scan_ref(x, dt, a, bm, cm, chunk=256)
        torch.cuda.synchronize()
        what = f"burst {b} x {s} H={h} G={g} {dtype}"
        err = check_close("ssd_scan", y, yr, SSD_TOL[dtype], "y " + what)
        check_close("ssd_scan", st, str_, STATE_TOL, "state " + what)
        max_err = max(max_err, err)
        n_cases += 1
        del y, st, yr, str_
    log(f"ssd_scan == plain version at the burst shape in f32 and bf16; "
        f"{n_cases} cases in all, max_abs_err {max_err:.3g}")
    ms = cuda_ms(torch, lambda: ssd_scan(x, dt, a, bm, cm, chunk=256),
                 iters=10, warmup=2)
    plain_ms = cuda_ms(torch, lambda: ssd_scan_ref(x, dt, a, bm, cm,
                                                   chunk=256),
                       iters=3, warmup=1)
    nbytes, flops = ssd_work(b, s, h, g, p, n, 256, 2, 2)
    bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOPS)
    log(f"ssd_scan ({b} x {s} tokens, H {h}, P {p}, N {n}, bf16, chunk "
        f"256): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
        f"{bound_ms:.5f} ({bound_by}; {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB); no library call computes it")
    one_ms = cuda_ms(torch, lambda: ssd_scan(x[:1], dt[:1], a, bm[:1],
                                             cm[:1], chunk=256),
                     iters=10, warmup=2)
    log(f"ssd_scan (1 x {s} tokens, 32 blocks): kernel_ms {one_ms:.4f}")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:82",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": "8 x 2048 tokens, H 32, P 64, N 128, bf16, chunk 256"}


# K4/K5: the SSM state of mamba2-370m after an (8, 2048) prefill, as rows
# of its state dimension, is the timed shape (the engine phase compresses
# it): 48 layers x 8 x 32 heads x 64 rows of 128 f32
ACT_ROWS, ACT_N = 48 * 8 * 32 * 64, 128
ACT_REPLACES = {"act_quant": "src/repro/kernels/act_quant.py:47",
                "act_dequant": "src/repro/kernels/act_quant.py:70",
                "act_quant4": "src/repro/kernels/act_quant.py:113",
                "act_dequant4": "src/repro/kernels/act_quant.py:154"}


def codec_bit_equal(torch, x, what):
    """K4 and K5 on ``x`` (M, n) against their plain versions on the
    card: codes, packed bytes and scales, and the dequantized values in
    bf16 and f32, all bit-equal.  Raises on the first difference."""
    from repro_torch.kernels import (act_dequant, act_dequant4, act_quant,
                                     act_quant4)
    from repro_torch.kernels import ref
    n = x.shape[1]
    for quant, dequant, pq, pdq, kw in (
            (act_quant, act_dequant, ref.act_quant_ref,
             ref.act_dequant_ref, {}),
            (act_quant4, act_dequant4, ref.act_quant4_ref,
             ref.act_dequant4_ref, {"n": n})):
        q, s = quant(x)
        qr, sr = pq(x)
        if not (torch.equal(q, qr) and torch.equal(s, sr)):
            raise AssertionError(f"{quant.__name__} differs from its plain "
                                 f"version: {what}")
        if quant is act_quant4 and n % 128 and not bool(
                (q[:, (n + 1) // 2:] == 0x88).all()):
            raise AssertionError(f"act_quant4 padding bytes are not 0x88: "
                                 f"{what}")
        for od in (torch.bfloat16, torch.float32):
            if not torch.equal(dequant(q, s, od, **kw),
                               pdq(qr, sr, od, **kw)):
                raise AssertionError(f"{dequant.__name__} -> {od} differs "
                                     f"from its plain version: {what}")
        del q, s, qr, sr


def phase_act_quant(torch):
    from repro_torch.engine import act_compress
    from repro_torch.kernels import (act_dequant, act_dequant4, act_quant,
                                     act_quant4)
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(97531)
    n_cases = 0
    for m in (1, 7, 256, 16384):
        for n in (128, 256, 2048, 50280):
            for dtype in ("float32", "bfloat16"):
                x = torch.randn(m, n, generator=gen, device="cuda") * 3
                x[0, :128] = 0.0                  # an all-zero block
                codec_bit_equal(torch, x.to(getattr(torch, dtype)),
                                f"M={m} n={n} {dtype}")
                n_cases += 1
                del x
    # leading dimensions and a ragged last axis through act_compress:
    # the card's codec equals the CPU's plain one bit for bit
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(3, 5, 50280, generator=gen, device="cuda")
             * 3).to(dtype)
        xc = x.cpu()
        pairs = [(act_compress.quantize_int8(x),
                  act_compress.quantize_int8(xc)),
                 (act_compress.quantize_int4(x),
                  act_compress.quantize_int4(xc))]
        for (q, s), (qc, sc) in pairs:
            if not (torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)):
                raise AssertionError(f"act_compress on the card differs "
                                     f"from the CPU ({dtype})")
        (q, s), (qc, sc) = pairs[0]
        (p, s4), (pc, s4c) = pairs[1]
        for od in (torch.bfloat16, torch.float32):
            if not (torch.equal(act_compress.dequantize_int8(q, s, od).cpu(),
                                act_compress.dequantize_int8(qc, sc, od))
                    and torch.equal(
                        act_compress.dequantize_int4(p, s4, 50280, od).cpu(),
                        act_compress.dequantize_int4(pc, s4c, 50280, od))):
                raise AssertionError(f"act_compress dequant on the card "
                                     f"differs from the CPU ({dtype}->{od})")
        n_cases += 1
    torch.cuda.synchronize()
    log(f"act_quant/act_dequant/act_quant4/act_dequant4 == plain version "
        f"bit for bit on {n_cases} cases (M 1..16384, n 128..50280, f32/bf16 "
        f"in, bf16/f32 out, act_compress (3, 5, 50280) card == CPU)")

    # timing at the path's shape: the mamba2 SSM state as rows of 128 f32
    x = torch.randn(ACT_ROWS, ACT_N, generator=gen, device="cuda")
    q, s = act_quant(x)
    p, s4 = act_quant4(x)
    nb = ACT_N // 128
    calls = {
        "act_quant": (lambda: act_quant(x),
                      lambda: ref.act_quant_ref(x),
                      x.numel() * 4, ACT_ROWS * (ACT_N + 4 * nb), 5),
        "act_quant4": (lambda: act_quant4(x),
                       lambda: ref.act_quant4_ref(x),
                       x.numel() * 4, ACT_ROWS * (ACT_N // 2 + 4 * nb), 6),
        "act_dequant": (lambda: act_dequant(q, s),
                        lambda: ref.act_dequant_ref(q, s),
                        q.numel() + s.numel() * 4, x.numel() * 2, 1),
        "act_dequant4": (lambda: act_dequant4(p, s4),
                         lambda: ref.act_dequant4_ref(p, s4),
                         p.numel() + s4.numel() * 4, x.numel() * 2, 3),
    }
    qr, sr = ref.act_quant_ref(x)
    pr, s4r = ref.act_quant4_ref(x)
    errs = {"act_quant": max(float((q.int() - qr.int()).abs().max()),
                             float((s - sr).abs().max())),
            "act_quant4": max(float((p.int() - pr.int()).abs().max()),
                              float((s4 - s4r).abs().max())),
            "act_dequant": float((act_dequant(q, s).float()
                                  - ref.act_dequant_ref(q, s).float()
                                  ).abs().max()),
            "act_dequant4": float((act_dequant4(p, s4).float()
                                   - ref.act_dequant4_ref(p, s4).float()
                                   ).abs().max())}
    del qr, sr, pr, s4r
    rows = {}
    for name, (fn, plain, in_bytes, out_bytes, ops) in calls.items():
        ms = cuda_ms(torch, fn, iters=50, warmup=5)
        plain_ms = cuda_ms(torch, plain, iters=5, warmup=2)
        src = torch.empty(in_bytes, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        copy_ms = cuda_ms(torch, lambda: dst.copy_(src), iters=50, warmup=5)
        del src, dst
        bound_ms, bound_by = bound(in_bytes + out_bytes, ops * x.numel(),
                                   H100_F32_FLOPS)
        log(f"{name} ({ACT_ROWS} x {ACT_N}, f32 in / bf16 out, "
            f"{(in_bytes + out_bytes) / 1e6:.1f} MB): kernel_ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}) "
            f"copy_ms {copy_ms:.4f} (a device copy of the "
            f"{in_bytes / 1e6:.1f} MB input: the bandwidth reference; no "
            f"one library call computes it)")
        rows[name] = {"name": name, "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/act_quant.cu",
                      "replaces": ACT_REPLACES[name], "launches": None,
                      "max_abs_err": errs[name], "ms": ms,
                      "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None, "copy_ms": copy_ms,
                      "shape": f"{ACT_ROWS} x {ACT_N} f32 (the mamba2-370m "
                               f"SSM state), dequant to bf16"}
    return [rows[k] for k in ACT_REPLACES]


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


def _long_prompts(seed, vocab):
    """16 prompts for the long wave: eight of 600..1000 tokens (bucket
    1024) and eight of 1100..2000 (bucket 2048), interleaved.  The
    lengths are fixed, so a repeat hits the same buckets; ``seed`` draws
    the tokens.  Two bucket-1024 prompts of one length share their first
    256 tokens, so the pool deduplicates their leading blocks."""
    import numpy as np
    lrng = np.random.default_rng(0)
    short = [900, 900] + list(lrng.integers(600, 1001, 6))
    long_ = list(lrng.integers(1100, 2001, 8))
    lens = [n for pair in zip(short, long_) for n in pair]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    prompts[2][:256] = prompts[0][:256]
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
        # a prompt whose bucket is max_seq decodes once and stops (R1)
        budget = (2 if eng._bucket(len(r.prompt)) == eng.max_seq
                  else new_tokens)
        if not r.done or len(r.generated) != budget:
            raise AssertionError(f"request {r.rid} ended with "
                                 f"{len(r.generated)} of {budget} tokens")
        if not all(0 <= t < eng.cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.rid} emitted an id out of "
                                 "the vocabulary")
    steps = eng.stats.steps - steps0
    step_ms = 1e3 * sum(list(eng.step_times)[-steps:]) / steps
    return (eng.stats.tokens_out - tokens0) / wall, step_ms, reqs


def _kernel_fns():
    from repro_torch.kernels import (act_dequant, act_dequant4, act_quant,
                                     act_quant4, flash_attention, fused_ffn,
                                     paged_decode_attention, ssd_scan)
    return {"paged_decode_attention": paged_decode_attention,
            "flash_attention": flash_attention, "fused_ffn": fused_ffn,
            "ssd_scan": ssd_scan, "act_quant": act_quant,
            "act_dequant": act_dequant, "act_quant4": act_quant4,
            "act_dequant4": act_dequant4}


def zero_counts():
    for fn in _kernel_fns().values():
        fn.launches = 0


def check_counts(engines, what):
    """Read the launch counts of one path's run and hold them to the
    counters of the engines that served it: the paged step runs K1 and
    K3 per layer, the dense batched step K3; a dense prefill call runs
    K2 and K3 per layer, an SSM prefill call K6.  Every kernel of the
    path must have launched, and no other.  Returns ``{kernel name:
    launches}``."""
    eng = engines[0]
    layers = eng.cfg.num_layers
    decode = sum(e.stats.decode_calls for e in engines)
    prefill = sum(e.stats.prefill_calls for e in engines)
    counts = {name: fn.launches for name, fn in _kernel_fns().items()}
    expect = dict.fromkeys(counts, 0)
    if eng.cfg.arch_type == "ssm":
        expect["ssd_scan"] = prefill * layers
    else:
        expect["flash_attention"] = prefill * layers
        expect["fused_ffn"] = (prefill + decode) * layers
        if eng.decode_mode == "paged":
            expect["paged_decode_attention"] = decode * layers
    if counts != expect:
        raise AssertionError(f"{what}: launches {counts}, expected {expect} "
                             f"({decode} decode steps, {prefill} prefill "
                             f"calls, {layers} layers)")
    if not decode or not prefill:
        raise AssertionError(f"{what}: the path did not run")
    log(f"{what}: {decode} decode steps, {prefill} prefill calls -> "
        f"launches {counts}")
    return {name: n for name, n in counts.items() if n}


def ttft_by_bucket(eng, reqs):
    """Mean and max time to first token (arrival -> first token on the
    host) by prompt bucket, in ms."""
    by = {}
    for r in reqs:
        by.setdefault(eng._bucket(len(r.prompt)), []).append(
            1e3 * (r.first_token_s - r.arrived_s))
    return {b: (sum(v) / len(v), max(v), len(v)) for b, v in sorted(
        by.items())}


def phase_serving(torch, name):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.serving import CompileCache, ServingEngine
    cfg = get_config("paper-backbone")
    params = init_params(cfg, seed=0, device="cuda")
    opts = RuntimeOptions(paged_kernel=True, kv_dtype="int8")
    totals = {}

    # --- path 1: two waves of short prompts at max_seq 512
    eng = ServingEngine(cfg, params, slots=8, max_seq=512, block_size=16,
                        opts=opts, decode_mode="paged",
                        compile_cache=CompileCache(), device="cuda")
    zero_counts()
    tps1, ms1, _ = serve_wave(torch, eng, _prompts(16, 1, cfg.vocab_size),
                              0, 32)
    warm = eng.stats.recompiles
    tps2, ms2, _ = serve_wave(torch, eng, _prompts(16, 2, cfg.vocab_size),
                              100, 32)
    counts = check_counts([eng], "short waves (max_seq 512)")
    if eng.stats.recompiles != warm:
        raise AssertionError(f"second wave built {eng.stats.recompiles - warm}"
                             " new programs")
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n
    log(f"serving paper-backbone paged int8 on {name}: wave 1 {tps1:.1f} "
        f"tok/s, {ms1:.3f} ms/decode step; wave 2 {tps2:.1f} tok/s, "
        f"{ms2:.3f} ms/decode step; decode steps {eng.stats.decode_calls}, "
        f"prefill calls {eng.stats.prefill_calls}, recompiles "
        f"{eng.stats.recompiles}")
    profile_decode_steps(torch, eng, ms2)

    # --- path 2: the long wave at max_seq 2048, then its repeat on a
    # second engine that shares the program cache.  (On one engine the
    # repeat meets a prefix cache full of the first wave's long prompts,
    # which shrinks its bursts into (bucket, k) programs not built yet.)
    cache = CompileCache()
    engines = []
    zero_counts()
    for wave in range(2):
        eng = ServingEngine(cfg, params, slots=8, max_seq=2048,
                            block_size=16, opts=opts, decode_mode="paged",
                            compile_cache=cache, device="cuda")
        engines.append(eng)
        tps, ms, reqs = serve_wave(
            torch, eng, _long_prompts(10 + wave, cfg.vocab_size),
            1000 + 100 * wave, 32)
        ttft = ttft_by_bucket(eng, reqs)
        log(f"long wave {wave + 1} (max_seq 2048, pool {eng.pool_blocks} "
            f"blocks): {tps:.1f} tok/s, {ms:.3f} ms/decode step, "
            f"{eng.stats.decode_calls} decode steps, "
            f"{eng.stats.prefill_calls} prefill calls, recompiles "
            f"{eng.stats.recompiles}; TTFT by bucket " + "; ".join(
                f"{b}: mean {mean:.1f} ms, max {mx:.1f} ms over {n}"
                for b, (mean, mx, n) in ttft.items()))
    if engines[1].stats.recompiles:
        raise AssertionError(f"the repeat of the long wave built "
                             f"{engines[1].stats.recompiles} new programs")
    counts = check_counts(engines, "long wave x 2 (max_seq 2048)")
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n
    profile_long_prefill(torch, lambda: ServingEngine(
        cfg, params, slots=8, max_seq=2048, block_size=16, opts=opts,
        decode_mode="paged", compile_cache=cache, device="cuda"))
    return totals


def _mamba_prompts(seed, vocab):
    """16 prompts of 8..2000 tokens, two in each bucket from 16 to 2048,
    interleaved short and long.  The lengths are fixed, so a repeat hits
    the same buckets and bursts; ``seed`` draws the tokens."""
    import numpy as np
    lens = [8, 2000, 30, 900, 60, 400, 100, 200,
            12, 1800, 25, 1000, 50, 500, 120, 250]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def phase_batched(torch, name):
    """The batched decode mode: full-width mamba2-370m (two waves, K6 on
    every prefill), then a short wave of full-width paper-backbone
    (dense KV, K2 and K3).  Returns the K6 launches of the mamba path."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import CompileCache, ServingEngine
    cfg = get_config("mamba2-370m")
    params = init_params(cfg, seed=0, device="cuda")
    cache = CompileCache()

    def engine():
        return ServingEngine(cfg, params, slots=8, max_seq=4096,
                             decode_mode="batched", compile_cache=cache,
                             device="cuda")

    eng = engine()
    zero_counts()
    tps1, ms1, reqs1 = serve_wave(torch, eng,
                                  _mamba_prompts(1, cfg.vocab_size), 0, 32)
    warm = eng.stats.recompiles
    tps2, ms2, reqs2 = serve_wave(torch, eng,
                                  _mamba_prompts(2, cfg.vocab_size), 100, 32)
    counts = check_counts([eng], "mamba2-370m batched, two waves")
    if eng.stats.recompiles != warm:
        raise AssertionError(f"the second mamba2 wave built "
                             f"{eng.stats.recompiles - warm} new programs")
    log(f"serving mamba2-370m batched on {name}: wave 1 {tps1:.1f} tok/s, "
        f"{ms1:.3f} ms/decode step; wave 2 {tps2:.1f} tok/s, {ms2:.3f} "
        f"ms/decode step; decode steps {eng.stats.decode_calls}, prefill "
        f"calls {eng.stats.prefill_calls}, programs built {warm}")
    for wave, (e, reqs) in enumerate(((eng, reqs1), (eng, reqs2))):
        log(f"  mamba2 wave {wave + 1} TTFT by bucket: " + "; ".join(
            f"{b}: mean {mean:.1f} ms, max {mx:.1f} ms over {n}"
            for b, (mean, mx, n) in ttft_by_bucket(e, reqs).items()))
    profile_decode_steps(torch, eng, ms2)
    profile_long_prefill(torch, engine)

    # --- paper-backbone, dense KV in the batched mode: one short wave
    pcfg = get_config("paper-backbone")
    peng = ServingEngine(pcfg, init_params(pcfg, seed=0, device="cuda"),
                         slots=8, max_seq=512, decode_mode="batched",
                         compile_cache=CompileCache(), device="cuda")
    zero_counts()
    tps, ms, _ = serve_wave(torch, peng, _prompts(16, 4, pcfg.vocab_size),
                            3000, 32)
    check_counts([peng], "paper-backbone batched (dense KV), one wave")
    log(f"serving paper-backbone batched on {name}: {tps:.1f} tok/s, "
        f"{ms:.3f} ms/decode step")
    return counts


# the port's kernels by a part of their CUDA function names
PROFILED_KERNELS = {"K1": "paged_decode_kernel", "K2": "flash_attn",
                    "K3": "fused_ffn", "K6": "ssd_scan_kernel"}


def device_profile(torch, fn, reps, wall_ms, what):
    """``torch.profiler`` over ``reps`` calls of ``fn``: device time per
    call by kernel, each of the port's kernels (K1, K2, K3, K6) summed
    over its routes and, against the unprofiled wall time ``wall_ms`` of
    one call, the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def device_us(e):
        return e.self_device_time_total

    # device-side entries only (kernels, memcpy, memset): the CPU ops that
    # launched them report the same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / reps
    ops = sum(e.count for e in kernels) / reps
    log(f"{what}: device busy {busy_ms:.3f} ms over {ops:.0f} device ops; "
        f"idle share {1 - busy_ms / wall_ms:.3f} of {wall_ms:.3f} ms")
    for e in sorted(kernels, key=device_us, reverse=True)[:8]:
        log(f"  {device_us(e) / 1e3 / reps:.4f} ms  {e.count / reps:5.0f}x  "
            f"{e.key[:70]}")
    ours = {}
    for k, part in PROFILED_KERNELS.items():
        hits = [e for e in kernels if part in e.key]
        if hits:
            ours[k] = (sum(device_us(e) for e in hits) / 1e3 / reps,
                       sum(e.count for e in hits) / reps)
    log("  port kernels: " + "; ".join(
        f"{k} {ms_:.4f} ms over {n:.0f} launches"
        for k, (ms_, n) in ours.items())
        + (f"; K2 + K3 {sum(ours.get(k, (0, 0))[0] for k in ('K2', 'K3')):.4f}"
           f" ms" if "K2" in ours else ""))


def profile_decode_steps(torch, eng, step_ms, steps=8):
    """Where a steady decode step's time goes, with 8 busy slots, against
    the unprofiled step time ``step_ms``."""
    from repro_torch.serving import Request
    prompts = _prompts(8, 3, eng.cfg.vocab_size)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=1000 + i, prompt=p, max_new_tokens=64))
    eng.step()                                  # admission + first decode
    eng.step()
    device_profile(torch, eng.step, steps, step_ms,
                   f"decode step profile ({steps} steps, 8 busy slots), "
                   "per step")
    eng.drain()


def profile_long_prefill(torch, make_engine):
    """Where a long prefill's time goes: the first step of a fresh
    engine that admits 8 prompts of bucket 2048 in one burst (one
    prefill call, then one decode step).  One engine is timed on the
    host clock, a second one profiled."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(5)
    walls = []
    for run in range(2):
        eng = make_engine()
        for i in range(8):
            eng.submit(Request(rid=2000 + i, prompt=rng.integers(
                0, eng.cfg.vocab_size, 1500).astype(np.int32),
                max_new_tokens=2))
        if run == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        else:
            device_profile(torch, eng.step, 1, walls[0],
                           "long prefill profile (one step: a prefill call "
                           "of 8 x 2048 tokens, then one decode step)")
        if eng.stats.prefill_calls != 1:
            raise AssertionError("8 bucket-2048 prompts took "
                                 f"{eng.stats.prefill_calls} prefill calls")
        eng.drain()


# ---------------------------------------------------------------- phase 4
PINNED_BYTES = 256 << 20


def pinned_rates(torch, nbytes=PINNED_BYTES):
    """Device->host and host->device copy rates through pinned host
    memory, in GB/s (CUDA events around 10 copies of ``nbytes``)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    d2h = cuda_ms(torch, lambda: host.copy_(dev, non_blocking=True), iters=10,
                  warmup=2)
    h2d = cuda_ms(torch, lambda: dev.copy_(host, non_blocking=True), iters=10,
                  warmup=2)
    return nbytes / d2h / 1e6, nbytes / h2d / 1e6


def compress_checked(torch, name, t):
    """One tensor of the path through ``act_compress`` at 8 and 4 bits:
    codes and scales bit-equal to the plain versions, the JAX suite's
    error bounds, and the bytes held against ``compressed_bytes``.
    Returns the int8 codes and scales."""
    from repro_torch.engine import (compressed_bytes, compression_error,
                                    dequantize_int4, dequantize_int8,
                                    quantize_int4, quantize_int8)
    from repro_torch.kernels import ref
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{name}: the model produced non-finite values")
    n = t.shape[-1]
    nb = -(-n // 128)
    rows = t.numel() // n
    q8, s8 = quantize_int8(t)
    d8 = dequantize_int8(q8, s8, torch.float32)
    p4, s4 = quantize_int4(t)
    d4 = dequantize_int4(p4, s4, n, torch.float32)
    flat = t.reshape(rows, n)
    qr, sr = ref.act_quant_ref(flat)
    pr, s4r = ref.act_quant4_ref(flat)
    if not (torch.equal(q8.reshape(rows, n), qr)
            and torch.equal(s8.reshape(rows, nb), sr)
            and torch.equal(p4.reshape(rows, nb * 64), pr)
            and torch.equal(s4.reshape(rows, nb), s4r)
            and torch.equal(d8.reshape(rows, n),
                            ref.act_dequant_ref(qr, sr, torch.float32))
            and torch.equal(d4.reshape(rows, n), ref.act_dequant4_ref(
                pr, s4r, torch.float32, n))):
        raise AssertionError(f"{name}: the codec on the card differs from "
                             "its plain version")
    del qr, sr, pr, s4r, d8, d4
    e8, e4 = compression_error(t, 8), compression_error(t, 4)
    if not (e8 < 0.02 and e4 > e8):
        raise AssertionError(f"{name}: compression errors int8 {e8}, int4 "
                             f"{e4} (want int8 < 0.02 and int4 > int8)")
    held8 = q8.numel() * q8.element_size() + s8.numel() * 4
    held4 = p4.numel() + s4.numel() * 4
    model8, model4 = (compressed_bytes(tuple(t.shape), 8),
                      compressed_bytes(tuple(t.shape), 4))
    if n % 128 == 0:
        if (held8, held4) != (model8, model4):
            raise AssertionError(f"{name}: bytes held {held8}/{held4}, "
                                 f"compressed_bytes {model8}/{model4}")
        note = "= compressed_bytes"
    else:
        if (held8, held4) != (rows * (n + 4 * nb), rows * (nb * 64 + 4 * nb)):
            raise AssertionError(f"{name}: bytes held {held8}/{held4}")
        note = (f"!= compressed_bytes {model8} / {model4}: the padded last "
                f"block of each row keeps its scale (and its int4 nibbles), "
                f"while compressed_bytes counts n_elems * bits / 8 + "
                f"(n_elems // 128) * 4")
    log(f"  {name} {tuple(t.shape)} {str(t.dtype)[6:]} "
        f"({t.numel() * t.element_size() / 1e6:.1f} MB): error int8 {e8:.5f}, "
        f"int4 {e4:.5f}; held int8 {held8} B, int4 {held4} B {note}")
    return q8, s8


def phase_engine(torch, smi):
    """The engine's entry points on the card at full width: compress the
    tensors of two real prefills, swap the int8 SSM state through pinned
    host memory, run the host-side planners; count every kernel's
    launches on this path.  Returns ``{kernel name: launches}``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.engine import (Swapper, choose_policy, fuse_graph,
                                    fusion_memory_saving, greedy_no_reuse,
                                    plan_memory, plan_parallelism,
                                    sub_batch_split)
    from repro_torch.engine.swap import HOST_LINK_BW
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.offload import (DEVICE_POOLS, build_model_graph,
                                     place_dp, pre_partition)
    rng = np.random.default_rng(11)
    zero_counts()
    tensors, layers = {}, {}
    for name in ("mamba2-370m", "paper-backbone"):
        cfg = get_config(name)
        layers[name] = cfg.num_layers
        params = init_params(cfg, seed=0, device="cuda")
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (8, 2048)).astype(np.int32)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, tokens,
                                init_cache(cfg, 8, 2048, device="cuda"))
        torch.cuda.synchronize()
        log(f"{name}: prefill of 8 x 2048 tokens in "
            f"{time.perf_counter() - t0:.3f} s")
        if name == "mamba2-370m":
            tensors["mamba2 SSM state"] = cache["ssm"]
            tensors["mamba2 last logits"] = logits[:, -1, :cfg.vocab_size]
        else:
            kvw = cfg.num_kv_heads * cfg.resolved_head_dim
            tensors["paper-backbone K rows"] = cache["k"].reshape(-1, kvw)
            tensors["paper-backbone V rows"] = cache["v"].reshape(-1, kvw)
        del params, logits, cache

    # (a) compress the real tensors at 8 and 4 bits
    log("engine (a): act_compress on the prefills' tensors")
    coded = {name: compress_checked(torch, name, t)
             for name, t in tensors.items()}

    # (b) the int8 SSM state out to pinned host memory and back, twice
    # through one Swapper: the second round reuses the first's buffers
    q8, s8 = coded["mamba2 SSM state"]
    nbytes = q8.numel() + s8.numel() * 4
    sw = Swapper(use_memory_kinds=True)
    for rnd in (1, 2):
        allocs = sw.pinned_allocations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hq, hs = sw.offload("ssm.q", q8), sw.offload("ssm.s", s8)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if not (hq.is_pinned() and hs.is_pinned()):
            raise AssertionError("the offloaded state is not in pinned "
                                 "host memory")
        del hq, hs
        bq, bs = sw.fetch("ssm.q"), sw.fetch("ssm.s")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not (bq.device == q8.device and bs.device == s8.device
                and torch.equal(bq, q8) and torch.equal(bs, s8)):
            raise AssertionError("the swapped SSM state came back changed "
                                 "or elsewhere")
        del bq, bs
        new_pinned = sw.pinned_allocations - allocs
        if rnd == 2 and new_pinned:
            raise AssertionError(f"the second swap round page-locked "
                                 f"{new_pinned} new buffers")
        log(f"engine (b) swap round {rnd}: {nbytes / 1e6:.1f} MB int8 SSM "
            f"state out {nbytes / (t1 - t0) / 1e9:.2f} GB/s "
            f"({1e3 * (t1 - t0):.3f} ms), in "
            f"{nbytes / (t2 - t1) / 1e9:.2f} GB/s ({1e3 * (t2 - t1):.3f} ms) "
            f"on the host clock, {new_pinned} pinned buffers page-locked "
            f"this round, bit-exact; the swap model charges "
            f"{2 * nbytes / HOST_LINK_BW:.5f} s for both at HOST_LINK_BW "
            f"{HOST_LINK_BW / 1e9:.0f} GB/s (data sheet) against "
            f"{t2 - t0:.5f} s measured, on {smi}")
    sw.release()
    d2h, h2d = pinned_rates(torch)
    log(f"pinned copy rates on {smi}: device->host {d2h:.2f} GB/s, "
        f"host->device {h2d:.2f} GB/s ({PINNED_BYTES >> 20} MiB, CUDA "
        f"events)")
    del tensors, coded, q8, s8

    # (c) the host-side planners on the same two configurations
    free, _ = torch.cuda.mem_get_info()
    for name in ("mamba2-370m", "paper-backbone"):
        cfg = get_config(name)
        g = build_model_graph(cfg, 8, 2048)
        fused, reports = fuse_graph(g)
        plan = plan_memory(g)
        par = plan_parallelism(g, streams=2)
        pp = pre_partition(g)
        places = {pool: place_dp(pp, devs)
                  for pool, devs in DEVICE_POOLS.items()}
        remat = choose_policy(cfg, 8, 2048, free)
        saved = sum(r.bytes_saved for r in reports)
        cuts = {k: (v.cuts, v.latency_s) for k, v in places.items()}
        log(f"engine (c) {name} (8 x 2048): graph {len(g.nodes)} ops -> "
            f"fused {len(fused.nodes)}, saved {saved} B (each strategy "
            f"alone: {fusion_memory_saving(g)}); memory plan peak "
            f"{plan.peak_bytes} B vs no reuse {greedy_no_reuse(g)} B; "
            f"parallelism x{par.speedup:.4f} on 2 streams; partition units "
            f"{[len(pp.units(lv)) for lv in range(4)]}; place_dp (cuts, "
            f"latency s) {cuts}; remat {remat.policy} ({remat.act_bytes} B) "
            f"and {sub_batch_split(cfg, 8, 2048, free)} sub-batch(es) under "
            f"{free} B free")

    # (d) the launches of this path
    counts = {name: fn.launches for name, fn in _kernel_fns().items()}
    tensors_n = 4
    expect = dict.fromkeys(counts, 0)
    expect.update(ssd_scan=layers["mamba2-370m"],
                  flash_attention=layers["paper-backbone"],
                  fused_ffn=layers["paper-backbone"],
                  act_quant=2 * tensors_n, act_dequant=2 * tensors_n,
                  act_quant4=2 * tensors_n, act_dequant4=2 * tensors_n)
    if counts != expect:
        raise AssertionError(f"engine phase: launches {counts}, expected "
                             f"{expect}")
    log(f"engine phase: launches {counts} (one prefill each: K6 once a "
        f"mamba2 layer, K2 and K3 once a paper-backbone layer; each of "
        f"{tensors_n} tensors through each codec entry twice: once "
        f"directly, once in compression_error)")
    return {k: counts[k] for k in ACT_REPLACES}


# ---------------------------------------------------------------- phase 5
def top2_margin(torch, params, cfg, tokens):
    """Top-2 logit margin of the next token after ``tokens``, by the
    port's dense prefill on the CPU (for a report when streams differ)."""
    from repro_torch.models.model import init_cache, prefill
    t = torch.as_tensor(tokens, dtype=torch.int32)[None]
    logits, _ = prefill(params, cfg, t,
                        init_cache(cfg, 1, t.shape[1], device="cpu"))
    top = torch.topk(logits[0, -1, :cfg.vocab_size].float(), 2).values
    return float(top[0] - top[1])


def card_vs_cpu(torch, cfg, lens, new_tokens, seed, what, **engine_kw):
    """Greedy streams of ``cfg`` (f32 activations) from the same seeded
    weights on the card and on the CPU must be equal; on a mismatch the
    CPU's top-2 logit margin at the first differing token is printed."""
    import numpy as np
    from repro_torch.models import init_params
    from repro_torch.serving import (CompileCache, Request, SamplingOpts,
                                     ServingEngine)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    streams = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=device)
        eng = ServingEngine(cfg, params, slots=4,
                            compile_cache=CompileCache(), device=device,
                            **engine_kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens,
                        sampling=SamplingOpts(temperature=0.0))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams[device] = [tuple(r.generated) for r in reqs]
        log(f"{what} on {device}: {time.perf_counter() - t0:.1f} s")
    if streams["cuda"] != streams["cpu"]:
        for p, a, b in zip(prompts, streams["cuda"], streams["cpu"]):
            if a != b:
                i = next(j for j in range(len(a)) if a[j] != b[j])
                margin = top2_margin(torch, params, cfg,
                                     np.concatenate([p, b[:i]]))
                log(f"prompt of {len(p)} tokens: streams differ at step "
                    f"{i} (card {a[i]}, CPU {b[i]}); CPU top-2 logit "
                    f"margin there {margin:.3g}")
        raise AssertionError(f"{what}: card and CPU greedy streams differ:\n"
                             f"cuda {streams['cuda']}\ncpu  {streams['cpu']}")
    log(f"{what}: card == CPU greedy streams on {len(prompts)} requests x "
        f"{new_tokens} tokens (prompts {min(lens)}..{max(lens)})")


def phase_card_vs_cpu(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.runtime import RuntimeOptions
    card_vs_cpu(torch, get_config("paper-backbone").with_updates(
        activation_dtype="float32"), (8, 37, 120, 200, 700), 32, 3,
        "paper-backbone paged int8 (buckets 16..1024)", max_seq=2048,
        block_size=16, decode_mode="paged",
        opts=RuntimeOptions(paged_kernel=True, kv_dtype="int8"))
    # window 64 over prompts of 150..300 tokens: buckets 256 and 512 pick
    # ``banded``, which the card runs through K2 (f32 route) with the
    # causal and window masks, and the paged decode through K1's window
    card_vs_cpu(torch, get_config("gemma3-12b").reduced().with_updates(
        activation_dtype="float32"), (20, 150, 200, 300), 16, 5,
        "gemma3-12b reduced paged int8 (window 64, banded prefill)",
        max_seq=1024, block_size=16, decode_mode="paged",
        opts=RuntimeOptions(paged_kernel=True, kv_dtype="int8"))
    # the caches in f32 too: a bf16 conv cache rounds every layer's conv
    # tail at every step, so the f32 summation-order differences of card
    # and CPU (~1e-6) flip bf16 ulps that compound into other tokens
    # after some steps
    card_vs_cpu(torch, get_config("mamba2-370m").with_updates(
        activation_dtype="float32"), (8, 50, 120, 200), 16, 4,
        "mamba2-370m batched, f32 caches (buckets 16..256)", max_seq=512,
        decode_mode="batched",
        opts=RuntimeOptions(kv_cache_dtype="float32"))


def main() -> int:
    import torch
    smi = phase_device(torch)
    name = torch.cuda.get_device_name(0)
    kernels = [phase_paged(torch), phase_flash(torch), phase_ffn(torch),
               phase_ssd(torch)] + phase_act_quant(torch)
    launches = phase_serving(torch, smi)
    launches.update(phase_batched(torch, smi))
    launches.update(phase_engine(torch, smi))
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase_card_vs_cpu(torch)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
