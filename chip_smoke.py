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
   tables, K2 flash attention over its masks, dtypes, head dims, head
   groupings and lengths up to 2048, K3 fused gated FFN over both
   activations, dtypes, ragged and large M and two widths.  Each is then
   timed at the serving path's shapes beside its plain version, its
   byte/operation bound and one library call.
3. serving — ``ServingEngine`` serves full-width ``paper-backbone``
   (paged pool, ``paged_kernel=True``, ``kv_dtype="int8"``) from random
   weights made from a seed: two waves of 16 short requests at max_seq
   512, then a long wave of 16 requests at max_seq 2048 (prompt buckets
   1024 and 2048, served twice).  Asserts budgets, the launches of each
   kernel against the engine's decode steps and prefill calls, and no
   new program when a wave repeats; prints TTFT per bucket, the
   decode-step time and a profile of a decode step.
4. card against CPU — an f32-activation variant serves 5 greedy requests
   (one at bucket 1024) on the card and through the port's plain
   versions on the CPU; the token streams must be equal.

The line before the last is a JSON object listing every kernel with its
launches on the serving path and its times; the last line is
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


def phase_flash(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import flash_attention
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
                for hd in (32, 64, 128):
                    for h, kvh in ((8, 8), (8, 2)):
                        q, k, v = flash_case(torch, gen, b, h, kvh, s, hd,
                                             dtype)
                        out = flash_attention(q, k, v, **mask)
                        ref = flash_plain(q, k, v, **mask)
                        torch.cuda.synchronize()
                        err = check_close(
                            "flash_attention", out, ref, TOL[dtype],
                            f"S={s} hd={hd} H={h} kvh={kvh} {dtype} "
                            f"{mask}")
                        if mask.get("kv_len") == 0 \
                                and not bool((out == 0).all()):
                            raise AssertionError("kv_len 0 must give 0")
                        max_err = max(max_err, err)
                        n_cases += 1
    log(f"flash_attention == plain version on {n_cases} cases, "
        f"max_abs_err {max_err:.3g}")

    # timing at the long wave's prefill bursts: 8 prompts x 8 heads x hd
    # 32, bf16, causal (the engine passes no kv_len)
    timed = {}
    for b, s in ((8, 2048), (8, 1024)):
        q, k, v = flash_case(torch, gen, b, 8, 8, s, 32, "bfloat16")
        ms = cuda_ms(torch, lambda: flash_attention(q, k, v), iters=20)
        plain_ms = cuda_ms(torch, lambda: flash_plain(q, k, v), iters=5,
                           warmup=2)
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=20)
        nbytes = 4 * q.numel() * q.element_size()
        flops = 4 * 32 * flash_pairs(s, True, 0, None) * b * 8
        bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOPS)
        timed[s] = (ms, plain_ms, library_ms, bound_ms, bound_by)
        log(f"flash_attention ({b} x {s} tokens, 8 heads, hd 32, bf16, "
            f"causal): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} bound_ms {bound_ms:.5f} "
            f"({bound_by})")
    ms, plain_ms, library_ms, bound_ms, bound_by = timed[2048]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:96",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": "8 x 2048 tokens, 8 heads, hd 32, bf16, causal"}


def ffn_case(torch, gen, m, d, f, dtype):
    dt = getattr(torch, dtype)
    return (torch.randn(m, d, generator=gen).to(dt).cuda(),
            (torch.randn(d, f, generator=gen) * d ** -0.5).to(dt).cuda(),
            (torch.randn(d, f, generator=gen) * d ** -0.5).to(dt).cuda(),
            (torch.randn(f, d, generator=gen) * f ** -0.5).to(dt).cuda())


def phase_ffn(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.fused_ffn import fused_ffn
    from repro_torch.kernels.ref import fused_ffn_ref
    gen = torch.Generator().manual_seed(2468)
    max_err = 0.0
    n_cases = 0
    for d, f in ((256, 1024), (1024, 4096)):
        for m in (8, 100, 8192):
            for dtype in ("bfloat16", "float32"):
                for act in ("silu", "gelu"):
                    args = ffn_case(torch, gen, m, d, f, dtype)
                    out = fused_ffn(*args, act)
                    ref = fused_ffn_ref(*args, act)
                    torch.cuda.synchronize()
                    err = check_close("fused_ffn", out, ref, FFN_TOL[dtype],
                                      f"M={m} D={d} F={f} {dtype} {act}")
                    if not torch.equal(out, fused_ffn(*args, act)):
                        raise AssertionError("fused_ffn does not repeat")
                    max_err = max(max_err, err)
                    n_cases += 1
    log(f"fused_ffn == plain version on {n_cases} cases, max_abs_err "
        f"{max_err:.3g}")

    # timing at paper-backbone's widths (D 256, F 1024, bf16, silu): a
    # decode step (M 8) and a prefill burst of 8 x 2048 tokens
    timed = {}
    for m in (8, 8 * 2048):
        x, wg, wu, wd = ffn_case(torch, gen, m, 256, 1024, "bfloat16")
        iters = 200 if m == 8 else 20
        ms = cuda_ms(torch, lambda: fused_ffn(x, wg, wu, wd), iters=iters)
        plain_ms = cuda_ms(torch, lambda: fused_ffn_ref(x, wg, wu, wd),
                           iters=iters)
        chain_ms = cuda_ms(torch, lambda: (F.silu(x @ wg) * (x @ wu)) @ wd,
                           iters=iters)
        nbytes = (2 * x.numel() + wg.numel() + wu.numel()
                  + wd.numel()) * x.element_size()
        bound_ms, bound_by = bound(nbytes, 6 * m * 256 * 1024,
                                   H100_BF16_FLOPS)
        timed[m] = (ms, plain_ms, bound_ms, bound_by)
        log(f"fused_ffn (M {m}, D 256, F 1024, bf16): kernel_ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}); "
            f"unfused bf16 cuBLAS chain {chain_ms:.4f} ms")
    ms, plain_ms, bound_ms, bound_by = timed[8]
    return {"name": "fused_ffn", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_ffn.cu",
            "replaces": "src/repro/kernels/fused_ffn.py:54",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": "M 8 (a decode step), D 256, F 1024, bf16, silu"}


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


def zero_counts():
    from repro_torch.kernels import (flash_attention, fused_ffn,
                                     paged_decode_attention)
    for fn in (paged_decode_attention, flash_attention, fused_ffn):
        fn.launches = 0


def check_counts(engines, what):
    """Read the launch counts of one path's run and hold them to the
    counters of the engines that served it.  Returns ``{kernel name:
    launches}``."""
    from repro_torch.kernels import (flash_attention, fused_ffn,
                                     paged_decode_attention)
    layers = engines[0].cfg.num_layers
    decode = sum(e.stats.decode_calls for e in engines)
    prefill = sum(e.stats.prefill_calls for e in engines)
    counts = {"paged_decode_attention": paged_decode_attention.launches,
              "flash_attention": flash_attention.launches,
              "fused_ffn": fused_ffn.launches}
    expect = {"paged_decode_attention": decode * layers,
              "flash_attention": prefill * layers,
              "fused_ffn": (prefill + decode) * layers}
    if counts != expect:
        raise AssertionError(f"{what}: launches {counts}, expected {expect} "
                             f"({decode} decode steps, {prefill} prefill "
                             f"calls, {layers} layers)")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{what}: {name} never launched")
    log(f"{what}: {decode} decode steps, {prefill} prefill calls -> "
        f"launches {counts}")
    return counts


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
                        opts=opts, compile_cache=CompileCache(),
                        device="cuda")
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
                            block_size=16, opts=opts, compile_cache=cache,
                            device="cuda")
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
        compile_cache=cache, device="cuda"))
    return totals


def device_profile(torch, fn, reps, wall_ms, what):
    """``torch.profiler`` over ``reps`` calls of ``fn``: device time per
    call by kernel and, against the unprofiled wall time ``wall_ms`` of
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
    for e in sorted(kernels, key=device_us, reverse=True)[:6]:
        log(f"  {device_us(e) / 1e3 / reps:.4f} ms  {e.count / reps:5.0f}x  "
            f"{e.key[:70]}")


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
def top2_margin(torch, params, cfg, tokens):
    """Top-2 logit margin of the next token after ``tokens``, by the
    port's dense prefill on the CPU (for a report when streams differ)."""
    from repro_torch.models.model import init_cache, prefill
    t = torch.as_tensor(tokens, dtype=torch.int32)[None]
    logits, _ = prefill(params, cfg, t,
                        init_cache(cfg, 1, t.shape[1], device="cpu"))
    top = torch.topk(logits[0, -1, :cfg.vocab_size].float(), 2).values
    return float(top[0] - top[1])


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
               for n in (8, 37, 120, 200, 700)]
    streams = {}
    for device in ("cuda", "cpu"):
        params = init_params(cfg, seed=0, device=device)
        eng = ServingEngine(cfg, params, slots=4, max_seq=2048,
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
        for p, a, b in zip(prompts, streams["cuda"], streams["cpu"]):
            if a != b:
                i = next(j for j in range(len(a)) if a[j] != b[j])
                margin = top2_margin(torch, params, cfg,
                                     np.concatenate([p, b[:i]]))
                log(f"prompt of {len(p)} tokens: streams differ at step "
                    f"{i} (card {a[i]}, CPU {b[i]}); CPU top-2 logit "
                    f"margin there {margin:.3g}")
        raise AssertionError(f"card and CPU greedy streams differ:\n"
                             f"cuda {streams['cuda']}\ncpu  {streams['cpu']}")
    log(f"card == CPU greedy streams on {len(prompts)} requests x 32 tokens "
        "(prompts 8..700, buckets 16..1024)")


def main() -> int:
    import torch
    smi = phase_device(torch)
    name = torch.cuda.get_device_name(0)
    kernels = [phase_paged(torch), phase_flash(torch), phase_ffn(torch)]
    launches = phase_serving(torch, smi)
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
