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
   tables and at its table split's edges (positions on and beside a
   128-column split boundary, windows crossing one, full tables, mb 1),
   each repeating bit for bit, K2 flash attention (bf16 on the tensor
   cores, f32 on the CUDA cores) over its masks, dtypes, head dims
   16..256, head groupings and lengths up to 2048, K3 fused gated FFN
   (bf16 small-M and tile routes, f32) over both activations, dtypes,
   ragged and large M, ragged F and widths up to 1024, each repeating
   bit for bit, K6 SSD scan over ragged and multi-chunk lengths, groups,
   head/state widths, dtypes and both layouts, and its chunk split's
   edges (S 255, 256, 257, 4096, with and without an initial state),
   each repeating bit for bit, K4/K5 activation quantization (int8 and
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
   steps and prefill calls (a step replayed as a CUDA graph counts the
   launches captured in it; the paged waves' totals are those of the
   eager steps, K1 1504, K2 192, K3 1696, and mamba2's K6 768), and no
   new program when a wave repeats; prints TTFT per bucket, the
   decode-step time and device profiles of a decode step and of a long
   prefill call (with K1's, K2's and K3's device time in each), and the
   graph-replayed paged int8 and mamba2 decode steps beside the same
   steps run eagerly on clones of the same state (host clock, device
   time, idle share; the tokens must be equal).  Then the engine's other
   paths at full width: a wave of 16 requests of 100-250 tokens x 128 new
   tokens through a roomy pool and through a pool of 97 blocks
   (preemption: at least one freeze, as many thaws, budgets met, tables
   released, exact launches), ``swap_model`` in the middle of a wave to
   the same binding (no re-prefill, every requeued request thawed) and
   to other weights (every requeued request re-prefilled), and short
   waves through ``per_slot`` and the gather-to-dense paged step (int8
   and bf16 pools).
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
   ``gemma3-12b`` paged (window 64; three prompts select ``banded``), 4
   of ``mamba2-370m`` batched with f32 caches, 6 of ``paper-backbone``
   paged int8 in a roomy pool and in a pool of 65 blocks that preempts
   (the streams may not drift), 4 through ``per_slot`` and 4 through
   the gather step, and 6 with ``swap_model`` after 4 steps (to the same
   and to other weights); the token streams and the engines' prefill
   calls, freezes, thaws and requeues must be equal.
6. adaptation loop — ``Middleware`` on full-width ``paper-backbone``
   (bf16 weights from seed 0, shape ("app", 256, 4, "prefill"), budgets
   50 ms / 2 GB) adapts over the quickstart's three contexts,
   ``budget_sweep_trace()`` and ``case_study_trace(24)``, inferring a
   (4, 256) batch at each tick: each ``infer`` must launch K2 once per
   layer of the tick's variant and K3 once per layer when its FFN is
   dense and gated (else never); host ms per ``infer`` beside its device
   profile and idle share.  Two TTA steps (``adapt_weights``, sharpened
   embedding): the entropy falls and only norm scales and ``logit_bias``
   change.  In f32, card == CPU for every variant of the action space
   (logits), for the TTA gradients of every leaf (the K2/K3 backwards)
   and for the early-exit depths (exits at layers 2, 4, 6); the
   ``H100_SXM`` estimates are ranked against the card's forward times.
   Phase 1 reads the idle card's power draw, which ``H100_SXM.idle_w``
   takes.
7. crowd — the fleet (``repro_torch.fleet``, ``faults``, ``obs``) with
   engine-backed members on the card, full-width ``paper-backbone``.
   K1, K2 and K3 first against their plain versions at this phase's
   shapes.  7a, in f32: the chaos suite's fleet (a loaded phone, two
   same-site helpers, a WAN server; placement and failure detection
   on); helper 1 serves 8 requests of 100-250 tokens x 64 new tokens
   through a paged engine (4 slots, f32 pool, block 16) and crashes
   after two steps; the detector evicts it and its in-flight requests
   freeze and thaw on helper 2's batched engine, its waiting ones move.
   Asserts one eviction, migrations = frozen + waiting, thaws = frozen,
   no re-prefill, every budget, the greedy streams equal to an unfaulted
   batched engine on the card and to the port's plain path on the CPU
   (the CPU's top-2 logit margins along the streams are logged), and a
   trace that passes ``tools/check_trace.py``.  7b, in bf16: a
   five-device crowd (``build_fleet(5)``, placement, a flight recorder,
   an SLO tracker) whose light member serves through a paged int8 engine
   and a heavy member through a batched one, 16 requests each, for 16 s
   of fleet time: wakes per device, engine steps per wake, the ENGINE-
   and SIMULATED-channel tier calibrations, the report's MAPE, each
   engine's median host-clock step, a wake's host time split into engine
   steps, prefill and the loop (from the trace), the attribution's
   dominant layer per device and the flight recorder's dumps.  Both fleet
   runs hold K1, K2 and K3 exactly to the engines' decode steps and
   prefill calls.

8. experts — the MoE family (``repro_torch.models.moe``).  8.0: K1 at
   olmoe-1b-7b's decode shape (8 slots, 16 heads of 128, int8 pool,
   block 16, mb 64; ragged positions and full tails) and at group 4, K2
   at its prefill shape (bf16, hd 128, causal, 8 x 1024) and the reduced
   configs' f32 shapes of 8b, K3 at llama4's shared expert, each against
   its plain version and repeating bit for bit; K1 and K2 at hd 128
   timed beside their bounds and SDPA.  8a, bf16: full-width olmoe-1b-7b
   (6.8 B parameters, 64 experts top-8; weights from seed 0, the init
   timed) served paged int8 (8 slots, max_seq 1024, block 16) in two
   waves of 16 requests of 8-250 tokens x 64 new tokens: budgets, K1 16
   per decode step and K2 16 per prefill call exactly, no K3 (no dense
   FFN), no new program on the second wave, TTFT per bucket; the MoE
   prefill block, the dense-dispatch decode block and a whole decode step
   each repeat bit for bit (the combine has no atomics); the
   graph-replayed step beside the eager step on clones (tokens equal,
   host clock, device time, idle share), the eager step's device time
   split into the expert products, K1 and the rest, beside the step's
   byte bound (every weight read once).  8b, f32, card == CPU greedy
   streams and prefill calls: reduced olmoe (16 experts top-8, drops at
   capacity factor 1.0) paged int8, reduced llama4-scout (top-1, shared
   expert through K3) paged over an f32 pool, reduced mixtral-8x7b
   (d_model 2048: top-2 of 4, GQA 16/8) batched; exact K1/K2/K3 launches
   and the CPU's smallest top-2 margins along each stream.

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
    # the idle card (no context yet, nothing running): what feeds
    # H100_SXM.idle_w in repro_torch/core/profiler.py
    idle = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.draw,clocks.sm,temperature.gpu",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    idle_w = float(idle.split(",")[0])
    log(f"idle card: power.draw {idle_w} W, clocks.sm and temperature "
        f"{idle.split(',')[1:]}")
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
    return smi, idle_w


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
    invalid columns masked).  Only the SDPA call is timed, by CUDA events
    and by the profiler's device time; the port never calls it."""
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

    def call():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)

    return cuda_ms(torch, call), device_ms(torch, call)


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
                            out = k1_repeated(torch, args, sc, window)
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
    # the table split's edges (128 pool columns a split): positions on
    # and beside a boundary, windows crossing one, tables full to their
    # last row (mb 128), and one-block tables (mb 1)
    for pool_dtype in ("int8", "bfloat16"):
        for heads, kvh in ((8, 8), (8, 2)):
            for mb, pos, window in K1_EDGES:
                args, sc = make_case(
                    torch, gen, slots=8, hd=32, bs=16, mb=mb, heads=heads,
                    kvh=kvh, pool_dtype=pool_dtype, q_dtype="bfloat16",
                    pos_kind="zero")
                args[4].copy_(torch.tensor(pos, dtype=torch.int32))
                out = k1_repeated(torch, args, sc, window)
                ref = paged_decode_attn_ref(*args, window=window, **sc)
                torch.cuda.synchronize()
                err = check_close(
                    "paged_decode_attention", out, ref, TOL["bfloat16"],
                    f"edge mb={mb} pos={pos} window={window} H={heads} "
                    f"kvh={kvh} pool={pool_dtype}")
                max_err = max(max_err, err)
                n_cases += 1
    log(f"paged_decode_attention == plain version on {n_cases} cases "
        f"(mb 1, 32 and 128, split edges), each repeating bit for bit; "
        f"max_abs_err {max_err:.3g}")

    def timed(args, sc, what):
        """CUDA-event and device time of K1 beside its plain version, its
        bound and SDPA."""
        ms = cuda_ms(torch, lambda: paged_decode_attention(*args, **sc))
        dev = device_ms(torch, lambda: paged_decode_attention(*args, **sc),
                        part="paged_decode")
        plain = cuda_ms(torch, lambda: paged_decode_attn_ref(*args, **sc))
        lib_ms, lib_dev = sdpa_yardstick(torch, args, sc)
        bound_ms, bound_by = paged_bound_ms(args, sc)
        log(f"paged_decode_attention ({what}): kernel_ms {ms:.4f} device "
            f"{fmt(dev)}; plain_ms {plain:.4f}; SDPA {lib_ms:.4f} ms, "
            f"device {fmt(lib_dev)}; bound_ms {bound_ms:.5f} ({bound_by})")
        return ms, dev, plain, lib_ms, bound_ms, bound_by

    # timing at the short waves' shapes: 8 slots, 8 kv heads, int8 pool
    # interleaving 8 layers, bf16 activations, decode positions 16..288
    args, sc = make_case(torch, gen, heads=8, kvh=8, pool_dtype="int8",
                         q_dtype="bfloat16", pos_kind="serving", layers=8,
                         layer=3, slots=8, hd=32, bs=16, mb=32)
    ms, dev, plain_ms, library_ms, bound_ms, bound_by = timed(
        args, sc, "8 slots, mb 32, positions 16..288")
    # the long wave's tables (mb 128), slots holding 600..1056 tokens,
    # then full 2048-token tables
    args2, sc2 = make_case(torch, gen, heads=8, kvh=8, pool_dtype="int8",
                           q_dtype="bfloat16", pos_kind="long", layers=8,
                           layer=3, slots=8, hd=32, bs=16, mb=128)
    timed(args2, sc2, "8 slots, mb 128, 600..1056 tokens")
    args2[4].fill_(2048)
    ms_full, dev_full, plain_full, lib_full, bound_full, _ = timed(
        args2, sc2, "8 slots, mb 128, full 2048-token tables")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
            "replaces": "src/repro/kernels/paged_decode_attn.py:175",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": dev, "ms_2048": ms_full,
            "device_ms_2048": dev_full, "plain_ms_2048": plain_full,
            "library_ms_2048": lib_full, "bound_ms_2048": bound_full,
            "shape": "8 slots x 8 kv heads x hd 32, int8 pool, mb 32, "
                     "positions 16..288; *_2048: mb 128, pos 2048"}


# (mb, positions of the 8 slots, window): K1's split edges
K1_EDGES = [
    (128, [128, 256, 127, 129, 384, 1, 2047, 2048], 0),
    (128, [140, 130, 260, 2048, 300, 129, 1000, 16], 20),
    (128, [2048] * 8, 0),
    (128, [2048] * 8, 300),
    (1, [0, 1, 2, 5, 8, 15, 16, 16], 0),
    (1, [0, 1, 2, 5, 8, 15, 16, 16], 4),
]


def k1_repeated(torch, args, sc, window):
    """K1 twice on the same inputs: the two outputs must be bit for bit
    equal (the splits merge in a fixed order, no atomics on values)."""
    from repro_torch.kernels.paged_decode_attn import paged_decode_attention
    out = paged_decode_attention(*args, window=window, **sc)
    again = paged_decode_attention(*args, window=window, **sc)
    if not torch.equal(out, again):
        raise AssertionError("paged_decode_attention does not repeat")
    return out


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
    # the chunk split's edges (chunk 256): S one short of a chunk, a
    # chunk, one past it, 16 chunks; without and with an initial state,
    # which the state pass carries
    edge_err = {}
    for dtype in ("bfloat16", "float32"):
        for s in (255, 256, 257, 4096):
            x, dt, a, bm, cm = ssd_case(torch, gen, 2, s, 8, 1, 64, 128,
                                        dtype)
            init = torch.randn(2, 8, 64, 128, generator=gen).cuda()
            for initial in (None, init):
                y, st = ssd_scan(x, dt, a, bm, cm, chunk=256,
                                 initial_state=initial)
                y2, st2 = ssd_scan(x, dt, a, bm, cm, chunk=256,
                                   initial_state=initial)
                yr, str_ = ssd_scan_ref(x, dt, a, bm, cm, chunk=256,
                                        initial_state=initial)
                torch.cuda.synchronize()
                if not (torch.equal(y, y2) and torch.equal(st, st2)):
                    raise AssertionError("ssd_scan does not repeat")
                what = (f"edge S={s} {dtype} initial_state="
                        f"{initial is not None}")
                err = check_close("ssd_scan", y, yr, SSD_TOL[dtype],
                                  "y " + what)
                check_close("ssd_scan", st, str_, STATE_TOL,
                            "state " + what)
                edge_err[dtype] = max(edge_err.get(dtype, 0.0), err)
                max_err = max(max_err, err)
                n_cases += 1
    log(f"ssd_scan == plain version on {n_cases} cases (with the chunk "
        f"split's edges), max_abs_err {max_err:.3g}; edges by dtype "
        + ", ".join(f"{k} {v:.3g}" for k, v in edge_err.items()))

    # the mamba2 prefill burst, the main path's shape: 8 prompts x 2048
    # tokens, 32 heads of 64, state 128, one group, chunk 256, x/b/c as
    # views of a 2304-wide conv row; checked in f32 and in bf16, each
    # repeating bit for bit, then timed in both
    b, s, h, g, p, n = 8, 2048, 32, 1, 64, 128
    burst = {}
    for dtype in ("float32", "bfloat16"):
        x, dt, a, bm, cm = ssd_case(torch, gen, b, s, h, g, p, n, dtype)
        burst[dtype] = (x, dt, a, bm, cm)
        y, st = ssd_scan(x, dt, a, bm, cm, chunk=256)
        yr, str_ = ssd_scan_ref(x, dt, a, bm, cm, chunk=256)
        torch.cuda.synchronize()
        what = f"burst {b} x {s} H={h} G={g} {dtype}"
        err = check_close("ssd_scan", y, yr, SSD_TOL[dtype], "y " + what)
        check_close("ssd_scan", st, str_, STATE_TOL, "state " + what)
        y2, st2 = ssd_scan(x, dt, a, bm, cm, chunk=256)
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            raise AssertionError("ssd_scan does not repeat at the burst")
        log(f"ssd_scan {what}: max_abs_err {err:.3g}")
        max_err = max(max_err, err)
        n_cases += 1
        del y, st, yr, str_, y2, st2
    log(f"ssd_scan == plain version at the burst shape in f32 and bf16; "
        f"{n_cases} cases in all, max_abs_err {max_err:.3g}")
    times = {}
    for dtype, args in burst.items():
        for rows in (b, 1):
            part = [t[:rows] if t.dim() > 1 else t for t in args]

            def call():
                return ssd_scan(*part, chunk=256)

            times[dtype, rows] = (cuda_ms(torch, call, iters=10, warmup=2),
                                  device_ms(torch, call, iters=10,
                                            part="ssd_scan"))
            log(f"ssd_scan ({rows} x {s} tokens, H {h}, P {p}, N {n}, "
                f"{dtype}, chunk 256): kernel_ms "
                f"{times[dtype, rows][0]:.4f} device "
                f"{fmt(times[dtype, rows][1])}")
    x, dt, a, bm, cm = burst["bfloat16"]
    # K6's three launches, by device time
    parts = {part: device_ms(torch, lambda: ssd_scan(x, dt, a, bm, cm,
                                                     chunk=256),
                             iters=10, part=part)
             for part in ("chunk_state", "chunk_y")}
    log("ssd_scan bf16 burst by launch (device): " + ", ".join(
        f"{k} {fmt(v)}" for k, v in parts.items()))
    plain_ms = cuda_ms(torch, lambda: ssd_scan_ref(x, dt, a, bm, cm,
                                                   chunk=256),
                       iters=3, warmup=1)
    nbytes, flops = ssd_work(b, s, h, g, p, n, 256, 2, 2)
    bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOPS)
    ms = times["bfloat16", b][0]
    log(f"ssd_scan ({b} x {s} tokens, H {h}, P {p}, N {n}, bf16, chunk "
        f"256): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
        f"{bound_ms:.5f} ({bound_by}; {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB); no library call computes it")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:82",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "device_ms": times["bfloat16", b][1],
            "f32_ms": times["float32", b][0],
            "f32_device_ms": times["float32", b][1],
            "one_prompt_ms": times["bfloat16", 1][0],
            "one_prompt_device_ms": times["bfloat16", 1][1],
            "shape": "8 x 2048 tokens, H 32, P 64, N 128, bf16, chunk 256; "
                     "one_prompt_*: 1 x 2048"}


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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps0, tokens0 = eng.stats.steps, eng.stats.tokens_out
    reqs = submit_all(eng, prompts, rid_base, new_tokens)
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_budgets(eng, reqs, new_tokens)
    steps = eng.stats.steps - steps0
    step_ms = 1e3 * sum(list(eng.step_times)[-steps:]) / steps
    return (eng.stats.tokens_out - tokens0) / wall, step_ms, reqs


def _kernel_fns():
    from repro_torch.kernels import COUNTED_KERNELS
    return {fn.__name__: fn for fn in COUNTED_KERNELS}


def zero_counts():
    for fn in _kernel_fns().values():
        fn.launches = 0


def check_counts(engines, what):
    """Read the launch counts of one path's run and hold them to the
    counters of the engines that served it: the paged block-table step
    runs K1 and K3 per layer, the dense batched, per-slot and gather
    steps K3; a dense prefill call runs K2 and K3 per layer, an SSM
    prefill call K6.  A step replayed as a CUDA graph counts the launches
    captured in its graph.  Every kernel of the path must have launched,
    and no other; engines of other modes add their own.  Returns
    ``{kernel name: launches}``."""
    layers = engines[0].cfg.num_layers
    decode = sum(e.stats.decode_calls for e in engines)
    prefill = sum(e.stats.prefill_calls for e in engines)
    counts = {name: fn.launches for name, fn in _kernel_fns().items()}
    expect = dict.fromkeys(counts, 0)
    for e in engines:
        n = e.cfg.num_layers
        d, p = e.stats.decode_calls, e.stats.prefill_calls
        if e.cfg.arch_type == "ssm":
            expect["ssd_scan"] += p * n
        else:
            expect["flash_attention"] += p * n
            # an MoE block runs K3 only for a shared expert
            if e.cfg.arch_type != "moe" or e.cfg.moe_shared_expert:
                expect["fused_ffn"] += (p + d) * n
            if e.decode_mode == "paged" and e.opts.paged_kernel:
                expect["paged_decode_attention"] += d * n
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
        f"{eng.stats.recompiles}, graph captures {captures(eng)}")
    if captures(eng) != 1:
        raise AssertionError("the paged step was not captured once")
    profile_decode_steps(torch, eng, ms2)
    graph_vs_eager(torch, ServingEngine(
        cfg, params, slots=8, max_seq=512, block_size=16, opts=opts,
        decode_mode="paged", compile_cache=eng.compile_cache,
        device="cuda"), "paper-backbone paged int8 step", name)

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
    # the same workloads as before the decode steps were graph-replayed,
    # so the same totals: each replay counts its captured launches
    if totals != PAGED_TOTALS:
        raise AssertionError(f"paged path launches {totals}, expected "
                             f"{PAGED_TOTALS}")
    return totals


# the paged waves' launches (short and long waves), unchanged since the
# steps were eager: K1 = decode steps x 8, K2 = prefill calls x 8, K3 =
# both x 8
PAGED_TOTALS = {"paged_decode_attention": 1504, "flash_attention": 192,
                "fused_ffn": 1696}


def captures(eng):
    """Decode steps this engine captured as CUDA graphs."""
    return eng.metrics.counter("engine.graph_captures").value


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def fill_slots(eng, new_tokens):
    """Fill every slot of a fresh engine with a greedy request, then take
    three steps (admission and warm-up, capture, replay)."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(21)
    for i in range(eng.slots):
        eng.submit(Request(rid=5000 + i, prompt=rng.integers(
            0, eng.cfg.vocab_size, 24 + 16 * i).astype(np.int32),
            max_new_tokens=new_tokens))
    for _ in range(3):
        eng.step()


def eager_on_clones(torch, eng):
    """The engine's next decode step, run eagerly by its step function
    on clones of the engine's state (the next step's tables grown
    already).  Returns the step (each call ends in a device->host copy of
    the tokens and positions, which it returns, and feeds its tokens to
    the next call) and the cloned state."""
    paged = eng.decode_mode == "paged"
    if paged:
        eng._ensure_tail_blocks()
        fn = eng._paged_decode_fn()
        state = {"cache": clone_tree(eng._cache),
                 "pool": clone_tree(eng._pool)}
        tables = torch.from_numpy(eng.block_pool.tables.copy()).to(
            eng.device)
    else:
        fn = eng._programs.decode_greedy
        state = {"cache": clone_tree(eng._cache)}
    tokens = torch.tensor([r.generated[-1] for r in eng._active],
                          dtype=torch.int32, device=eng.device)

    def eager_step():
        out = (fn(eng.params, state["cache"], state["pool"], tokens, tables)
               if paged else fn(eng.params, state["cache"], tokens))
        host = torch.stack([out[0].to(torch.int32),
                            out[1].to(torch.int32)]).cpu()
        tokens.copy_(out[0].to(torch.int32))
        return host

    return eager_step, state


def graph_vs_eager(torch, eng, what, smi, steps=16):
    """The steady decode step replayed as a CUDA graph beside the same
    step run eagerly.  ``eng`` is a fresh engine: its slots fill with
    greedy requests, then one step of the model's step function on
    clones of the engine's state must give the graph-replayed step's
    tokens.  Then ``steps`` engine steps (graph replays) and ``steps``
    eager steps on the clones (each ending in the same device->host copy
    of the tokens) are timed on the host clock, and each is profiled for
    its device time and idle share; one graph replay is also timed alone
    by CUDA events.  The engine is not used afterwards (the lone replays
    advance its state past its bookkeeping).  Returns the graph-replayed
    and eager host ms a step and their device ms."""
    fill_slots(eng, 4 * steps + 16)
    eager_step, _ = eager_on_clones(torch, eng)
    first = eager_step()[0].tolist()
    eng.step()
    replayed = [r.generated[-1] for r in eng._active]
    if first != replayed:
        raise AssertionError(f"{what}: the graph-replayed step gave "
                             f"{replayed}, the eager step {first}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    graph_ms = 1e3 * (time.perf_counter() - t0) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        eager_step()
    eager_ms = 1e3 * (time.perf_counter() - t0) / steps
    g_busy, g_ops = device_profile(torch, eng.step, steps, graph_ms,
                                   f"{what}, replayed as a CUDA graph, "
                                   "per step")
    e_busy, e_ops = device_profile(torch, eager_step, steps, eager_ms,
                                   f"{what}, eager on clones, per step")
    graph = next(iter(eng._graphs.values()))._graph
    replay_ms = cuda_ms(torch, graph.replay, iters=50, warmup=5)
    log(f"{what} on {smi}, 8 busy slots: graph-replayed {graph_ms:.3f} "
        f"ms/step on the host clock (device {g_busy:.3f} ms, idle share "
        f"{1 - g_busy / graph_ms:.3f}; one replay alone {replay_ms:.3f} ms "
        f"by CUDA events) against eager {eager_ms:.3f} ms/step (device "
        f"{e_busy:.3f} ms over {e_ops:.0f} device ops, idle share "
        f"{1 - e_busy / eager_ms:.3f}); graph captures {captures(eng)}; the "
        f"replayed step's tokens equal the eager step's")
    return graph_ms, eager_ms, g_busy, e_busy



def _tight_prompts(seed, vocab, n=16, lo=100, hi=250):
    """``n`` prompts of ``lo``..``hi`` tokens (fixed lengths, buckets 128
    and 256); ``seed`` draws the tokens."""
    import numpy as np
    lens = np.random.default_rng(0).integers(lo, hi + 1, n)
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n_)).astype(np.int32) for n_ in lens]


def phase_modes(torch, name):
    """The engine's other paths at full width on the card: a wave through
    a pool too small for its 8 slots (preemption: freeze and thaw), a
    ``swap_model`` in the middle of a wave (same binding, then other
    weights), and short waves through the ``per_slot`` mode and the
    gather-to-dense paged step (int8 and bf16 pools).  Returns
    ``{kernel name: launches}`` over these paths."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.serving import CompileCache, ServingEngine
    from repro_torch.serving.paging import TRASH_BLOCK
    cfg = get_config("paper-backbone")
    params = init_params(cfg, seed=0, device="cuda")
    opts = RuntimeOptions(paged_kernel=True, kv_dtype="int8")
    totals = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    # --- preemption: 16 requests of 100..250 tokens, 128 new tokens each,
    # 8 slots needing up to 24 blocks apiece, first in a roomy pool, then
    # in 3 x 32 + 1 = 97 blocks
    cache = CompileCache()
    streams = {}
    for label, pool in (("roomy", None), ("tight", 3 * 32 + 1)):
        eng = ServingEngine(cfg, params, slots=8, max_seq=512, block_size=16,
                            opts=opts, decode_mode="paged", pool_blocks=pool,
                            compile_cache=cache, device="cuda")
        zero_counts()
        tps, ms, reqs = serve_wave(torch, eng,
                                   _tight_prompts(6, cfg.vocab_size),
                                   6000, 128)
        counts = check_counts([eng], f"preemption wave, {label} pool "
                              f"({eng.pool_blocks} blocks)")
        st = eng.stats
        if label == "tight":
            add(counts)
            if st.freezes < 1 or st.thaws != st.freezes:
                raise AssertionError(f"tight pool: {st.freezes} freezes, "
                                     f"{st.thaws} thaws")
        if not (eng.block_pool.tables == TRASH_BLOCK).all():
            raise AssertionError(f"{label} pool: tables not released")
        streams[label] = [tuple(r.generated) for r in reqs]
        ttft = ttft_by_bucket(eng, reqs)
        log(f"preemption wave, {label} pool ({eng.pool_blocks} blocks) on "
            f"{name}: {tps:.1f} tok/s, {ms:.3f} ms/decode step, "
            f"{st.decode_calls} decode steps, {st.prefill_calls} prefill "
            f"calls, freezes {st.freezes}, thaws {st.thaws}, requeues "
            f"{st.requeues}, graph captures {captures(eng)}; TTFT by bucket "
            + "; ".join(f"{b}: mean {mean:.1f} ms, max {mx:.1f} ms over {n}"
                        for b, (mean, mx, n) in ttft.items()))
    same = sum(a == b for a, b in zip(streams["roomy"], streams["tight"]))
    log(f"preemption wave: {same} of 16 streams (greedy and sampled, bf16) "
        "equal the roomy pool's")

    # --- swap_model in the middle of a wave
    prompts = _prompts(16, 8, cfg.vocab_size)
    for label in ("same binding", "other weights"):
        eng = ServingEngine(cfg, params, slots=8, max_seq=512, block_size=16,
                            opts=opts, decode_mode="paged",
                            compile_cache=cache, device="cuda")
        zero_counts()
        reqs = submit_all(eng, prompts, 7000, 32)
        for _ in range(6):
            eng.step()
        active = sum(r is not None for r in eng._active)
        calls = eng.stats.prefill_calls
        if label == "same binding":
            eng.swap_model(cfg, params, opts)
        else:
            eng.swap_model(cfg, init_params(cfg, seed=1, device="cuda"),
                           opts, params_version=1)
        eng.drain()
        counts = check_counts([eng], f"swap_model mid-wave ({label})")
        add(counts)
        st = eng.stats
        check_budgets(eng, reqs, 32)
        if label == "same binding" and not (
                st.requeues == st.thaws == active and st.prefills == 16):
            raise AssertionError(f"same-binding swap: {active} requeued, "
                                 f"{st.thaws} thaws, {st.prefills} prefills")
        if label == "other weights" and not (
                st.requeues == active and st.thaws == 0
                and st.prefills == 16 + active):
            raise AssertionError(f"swap to other weights: {active} "
                                 f"requeued, {st.thaws} thaws, "
                                 f"{st.prefills} prefills")
        log(f"swap_model mid-wave ({label}) on {name}: {active} requeued, "
            f"thaws {st.thaws}, prefills {st.prefills}, prefill calls "
            f"{calls} before the swap and {st.prefill_calls} in all, "
            f"generation {eng.generation}, graph captures {captures(eng)}")

    # --- the per-slot mode and the gather-to-dense paged step
    for label, kw in (
            ("per_slot", dict(decode_mode="per_slot")),
            ("gather step, int8 pool", dict(
                decode_mode="paged", block_size=16,
                opts=RuntimeOptions(kv_dtype="int8"))),
            ("gather step, bf16 pool", dict(
                decode_mode="paged", block_size=16,
                opts=RuntimeOptions()))):
        eng = ServingEngine(cfg, params, slots=8, max_seq=512,
                            compile_cache=CompileCache(), device="cuda",
                            **kw)
        zero_counts()
        tps, ms, _ = serve_wave(torch, eng, _prompts(8, 9, cfg.vocab_size),
                                8000, 16)
        add(check_counts([eng], f"{label}, one wave"))
        if captures(eng):
            raise AssertionError(f"{label}: an eager path captured a graph")
        log(f"serving paper-backbone {label} on {name}: {tps:.1f} tok/s, "
            f"{ms:.3f} ms/decode step, {eng.stats.decode_calls} decode "
            "calls")
    return totals


def submit_all(eng, prompts, rid_base, new_tokens):
    from repro_torch.serving import Request, SamplingOpts
    reqs = [Request(rid=rid_base + i, prompt=p, max_new_tokens=new_tokens,
                    sampling=SamplingOpts(temperature=0.8 if i % 2 else 0.0,
                                          seed=7))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs


def check_budgets(eng, reqs, new_tokens):
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
        f"calls {eng.stats.prefill_calls}, programs built {warm}, graph "
        f"captures {captures(eng)}")
    if counts != {"ssd_scan": 768} or not 1 <= captures(eng) <= 2:
        raise AssertionError(f"mamba2 waves: launches {counts} (expected "
                             f"K6 768), {captures(eng)} graph captures "
                             "(expected at most decode and decode_greedy)")
    for wave, (e, reqs) in enumerate(((eng, reqs1), (eng, reqs2))):
        log(f"  mamba2 wave {wave + 1} TTFT by bucket: " + "; ".join(
            f"{b}: mean {mean:.1f} ms, max {mx:.1f} ms over {n}"
            for b, (mean, mx, n) in ttft_by_bucket(e, reqs).items()))
    profile_decode_steps(torch, eng, ms2)
    graph_vs_eager(torch, engine(), "mamba2-370m batched step", name)
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
PROFILED_KERNELS = {"K1": "paged_decode", "K2": "flash_attn",
                    "K3": "fused_ffn", "K6": "ssd_scan"}


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
    return busy_ms, ops


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
    """Where a long prefill's time goes: a step of a fresh engine that
    admits 8 prompts of bucket 2048 in one burst (one prefill call, then
    one decode step, replayed).  A short request first captures the
    engine's decode graph, whose capture is logged on its own.  One
    engine is timed on the host clock, a second one profiled."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(5)
    walls = []
    for run in range(2):
        eng = make_engine()
        eng.submit(Request(rid=1999, prompt=rng.integers(
            0, eng.cfg.vocab_size, 8).astype(np.int32), max_new_tokens=4))
        eng.drain()
        if eng.decode_mode == "paged":
            # its cached prefix would hold a block the burst needs
            eng._prefix.clear(eng._blocks)
        if run == 0:
            capture_s = eng.metrics.gauge("engine.graph_capture_s").value
            log(f"{eng.cfg.name}: first decode step of a fresh engine "
                f"(eager warm-up and graph capture) {1e3 * capture_s:.1f} "
                "ms on the host clock")
        calls = eng.stats.prefill_calls
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
        if eng.stats.prefill_calls - calls != 1:
            raise AssertionError("8 bucket-2048 prompts took "
                                 f"{eng.stats.prefill_calls - calls} "
                                 "prefill calls")
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


def greedy_prompts(seed, vocab, lens):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def serve_greedy(torch, cfg, prompts, new_tokens, device, swap=None,
                 slots=4, **engine_kw):
    """Serve greedy requests on ``device`` from the weights of seed 0.
    With ``swap``, the engine swaps its model after 4 steps: to the same
    weights (``"same"``) or to weights of another seed (``"other"``).
    Returns the streams, the engine and its weights."""
    from repro_torch.models import init_params
    from repro_torch.serving import CompileCache, ServingEngine
    params = init_params(cfg, seed=0, device=device)
    eng = ServingEngine(cfg, params, slots=slots,
                        compile_cache=CompileCache(), device=device,
                        **engine_kw)
    reqs = greedy_requests(prompts, new_tokens)
    for r in reqs:
        eng.submit(r)
    if swap is not None:
        for _ in range(4):
            eng.step()
        if swap == "same":
            eng.swap_model(cfg, params, eng.opts)
        else:
            eng.swap_model(cfg, init_params(cfg, seed=1, device=device),
                           eng.opts, params_version=1)
    eng.drain()
    return [tuple(r.generated) for r in reqs], eng, params


def card_vs_cpu(torch, cfg, lens, new_tokens, seed, what, swap=None,
                slots=4, keep=None, **engine_kw):
    """Greedy streams of ``cfg`` (f32 activations) from the same seeded
    weights on the card and on the CPU must be equal, and so must the
    engines' prefill calls, freezes, thaws and requeues; on a stream
    mismatch the CPU's top-2 logit margin at the first differing token is
    printed.  ``swap`` as in :func:`serve_greedy`.  The card's engine is
    appended to ``keep`` when one is given.  Returns the card's streams
    and counters."""
    import numpy as np
    prompts = greedy_prompts(seed, cfg.vocab_size, lens)
    streams, stats = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        streams[device], eng, params = serve_greedy(
            torch, cfg, prompts, new_tokens, device, swap, slots,
            **engine_kw)
        if device == "cuda" and keep is not None:
            keep.append(eng)
        st = eng.stats
        stats[device] = dict(prefill_calls=st.prefill_calls,
                             freezes=st.freezes, thaws=st.thaws,
                             requeues=st.requeues)
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
    if stats["cuda"] != stats["cpu"]:
        raise AssertionError(f"{what}: card counters {stats['cuda']}, CPU "
                             f"{stats['cpu']}")
    log(f"{what}: card == CPU greedy streams on {len(prompts)} requests x "
        f"{new_tokens} tokens (prompts {min(lens)}..{max(lens)}), counters "
        f"{stats['cuda']}")
    return streams["cuda"], stats["cuda"]


def phase_card_vs_cpu(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.runtime import RuntimeOptions
    pb32 = get_config("paper-backbone").with_updates(
        activation_dtype="float32")
    int8 = RuntimeOptions(paged_kernel=True, kv_dtype="int8")
    card_vs_cpu(torch, pb32, (8, 37, 120, 200, 700), 32, 3,
                "paper-backbone paged int8 (buckets 16..1024)", max_seq=2048,
                block_size=16, decode_mode="paged", opts=int8)
    # window 64 over prompts of 150..300 tokens: buckets 256 and 512 pick
    # ``banded``, which the card runs through K2 (f32 route) with the
    # causal and window masks, and the paged decode through K1's window
    card_vs_cpu(torch, get_config("gemma3-12b").reduced().with_updates(
        activation_dtype="float32"), (20, 150, 200, 300), 16, 5,
        "gemma3-12b reduced paged int8 (window 64, banded prefill)",
        max_seq=1024, block_size=16, decode_mode="paged", opts=int8)
    # the caches in f32 too: a bf16 conv cache rounds every layer's conv
    # tail at every step, so the f32 summation-order differences of card
    # and CPU (~1e-6) flip bf16 ulps that compound into other tokens
    # after some steps
    card_vs_cpu(torch, get_config("mamba2-370m").with_updates(
        activation_dtype="float32"), (8, 50, 120, 200), 16, 4,
        "mamba2-370m batched, f32 caches (buckets 16..256)", max_seq=512,
        decode_mode="batched",
        opts=RuntimeOptions(kv_cache_dtype="float32"))
    # preemption: 4 slots of prompts 100..250 tokens in 2 x 32 + 1 blocks;
    # the streams must not drift from a roomy pool's
    tight = dict(max_seq=512, block_size=16, decode_mode="paged", opts=int8)
    lens = (130, 250, 180, 240, 110, 200)
    roomy, _ = card_vs_cpu(torch, pb32, lens, 48, 6,
                           "paper-backbone paged int8, roomy pool", **tight)
    preempted, st = card_vs_cpu(torch, pb32, lens, 48, 6,
                                "paper-backbone paged int8, pool of 65 "
                                "blocks (preemption)", pool_blocks=65,
                                **tight)
    if st["freezes"] < 1 or st["thaws"] != st["freezes"]:
        raise AssertionError(f"the tight pool did not preempt: {st}")
    if preempted != roomy:
        raise AssertionError("preemption changed the paged int8 streams")
    log("preemption: the tight pool's streams equal the roomy pool's")
    # the eager paths: per-slot and the gather-to-dense step (dense views
    # in f32), and swap_model in the middle of a wave
    f32 = RuntimeOptions(kv_cache_dtype="float32")
    lens = (8, 37, 120, 200)
    card_vs_cpu(torch, pb32, lens, 24, 7, "paper-backbone per_slot",
                max_seq=512, decode_mode="per_slot", opts=f32)
    card_vs_cpu(torch, pb32, lens, 24, 7,
                "paper-backbone paged int8, gather step", max_seq=512,
                block_size=16, decode_mode="paged",
                opts=f32.replace(kv_dtype="int8"))
    lens = (8, 37, 120, 200, 60, 90)
    for swap in ("same", "other"):
        _, st = card_vs_cpu(torch, pb32, lens, 24, 8,
                            f"paper-backbone paged int8, swap_model to "
                            f"the {swap} weights after 4 steps",
                            swap=swap, **tight)
        if st["requeues"] != 4 or st["thaws"] != (4 if swap == "same"
                                                  else 0):
            raise AssertionError(f"swap ({swap}): {st}")


# ---------------------------------------------------------------- phase 6
# f32-activation logits, card against the port's plain path on the CPU:
# the f32 tolerance of the port's model twins (both in f32, the same sums
# in another order; logits of magnitude ~1)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 logits of an infer, card against the port's plain path on the CPU
# with the same bf16 weights: each rounds every layer's activations to
# bf16 in its own order.  Phase 6 logs how far the CPU's bf16 logits
# (|logit| <= ~1.6) lie from the f32 result on the same bf16 weights
# (a few hundredths); two bf16 runs lie within about twice that of each
# other, and atol 0.1 leaves room above it
INFER_BF16_TOL = dict(atol=1e-1, rtol=2e-2)
# f32 gradients of the TTA objective, card against CPU, leaf by leaf: the
# same sums in another order (~1e-6 relative), so within 1e-3 of each
# leaf's largest gradient
GRAD_REL_TOL = 1e-3
# the quickstart's three contexts
QUICKSTART_CONTEXTS = (("plugged-in", dict(battery_frac=0.95)),
                       ("battery-low", dict(battery_frac=0.15)),
                       ("mem-pressure", dict(battery_frac=0.5,
                                             mem_free_frac=0.2)))


def to_cpu(tree, dtype=None):
    """A CPU copy of a parameter tree; floating leaves cast to ``dtype``
    when it is given."""
    if isinstance(tree, dict):
        return {k: to_cpu(v, dtype) for k, v in tree.items()}
    if not hasattr(tree, "cpu"):
        return tree
    if dtype is not None and tree.is_floating_point():
        return tree.cpu().to(dtype)
    return tree.cpu()


def dense_gated(vcfg, vparams):
    """Whether a variant's FFN runs through K3: dense, gated, not
    factored (η1) and not ghost (η4)."""
    ffn = vparams["layers"]["ffn"]
    return vcfg.gated_ffn and "ghost_src" not in ffn and not any(
        isinstance(ffn[k], dict) for k in ("w_gate", "w_up", "w_down"))


def spec_name(spec):
    import dataclasses
    from repro_torch.elastic import FULL_SPEC
    return ",".join(f"{k}={v}" for k, v in dataclasses.asdict(spec).items()
                    if v != getattr(FULL_SPEC, k)) or "full"


def expected_launches(vcfg, vparams):
    """The launches of one forward of a variant: K2 once per layer, K3
    once per layer when its FFN is dense and gated, no other kernel."""
    expect = dict.fromkeys(_kernel_fns(), 0)
    expect["flash_attention"] = vcfg.num_layers
    if dense_gated(vcfg, vparams):
        expect["fused_ffn"] = vcfg.num_layers
    return expect


def drive_middleware(torch, mw, tokens, contexts):
    """The main path: one ``adapt`` and one ``infer`` per context.  Each
    ``infer`` must launch exactly ``expected_launches`` of the tick's
    variant.  Returns ``{spec: [host ms of each infer]}``, the order of
    the variants visited, ``{spec: (logits, variant cfg, variant params,
    options)}`` of each variant's first infer, and the launches expected
    over all ticks."""
    fns = _kernel_fns()
    times, order, first = {}, [], {}
    total = dict.fromkeys(fns, 0)
    for name, ctx in contexts:
        d = mw.adapt(ctx)
        vcfg, vparams, opts = mw.current_runtime()  # derives on first use
        before = {k: fn.launches for k, fn in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = mw.infer(tokens)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        delta = {k: fn.launches - before[k] for k, fn in fns.items()}
        expect = expected_launches(vcfg, vparams)
        if delta != expect:
            raise AssertionError(f"infer at {name} "
                                 f"({spec_name(d.action.variant)}): "
                                 f"launches {delta}, expected {expect}")
        if logits.shape != (*tokens.shape, vcfg.padded_vocab) or not bool(
                torch.isfinite(logits[..., :vcfg.vocab_size]).all()):
            raise AssertionError(f"infer at {name}: logits {logits.shape} "
                                 "not finite or of the wrong shape")
        spec = d.action.variant
        if spec not in times:
            order.append(spec)
            first[spec] = (logits, vcfg, vparams, opts)
        times.setdefault(spec, []).append(ms)
        total = {k: n + expect[k] for k, n in total.items()}
        log(f"  [{name:12s}] {d.reason:18s} {d.action.describe()}: infer "
            f"{ms:.3f} ms, K2 {delta['flash_attention']}, K3 "
            f"{delta['fused_ffn']}")
    return times, order, first, total


def pick_threshold(torch, outs):
    """A threshold in the widest gap of the exits' confidences (middle
    half), so no token sits on it; returns (threshold, half the gap)."""
    conf = torch.cat([torch.softmax(o.float(), -1).amax(-1).flatten()
                      for o in outs[:-1]]).sort().values
    gaps = conf[1:] - conf[:-1]
    lo, hi = len(gaps) // 4, 3 * len(gaps) // 4
    i = lo + int(gaps[lo:hi].argmax())
    return float(conf[i] + conf[i + 1]) / 2, float(gaps[i]) / 2


def phase_adapt(torch, smi, idle_w):
    """The cross-level adaptation loop on the card at full width:
    ``Middleware`` on paper-backbone (bf16 weights from seed 0) adapts
    over the quickstart's contexts, ``budget_sweep_trace()`` and
    ``case_study_trace(24)``, inferring a (4, 256) batch at each tick,
    then takes two TTA steps; every variant of the action space is held
    card == CPU in f32, so are the TTA gradients and the early-exit
    depths; the H100 profile's estimates are ranked against the card.
    Returns ``{kernel name: launches}`` of the loop and TTA."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import (H100_SXM, Budgets, Middleware,
                                  ResourceContext, budget_sweep_trace,
                                  case_study_trace, estimate_latency,
                                  layer_costs, rank_consistency)
    from repro_torch.elastic import (NORM_KEYS, ElasticSupernet,
                                     attach_exits, early_exit_predict,
                                     forward_with_exits, tta_grads)
    from repro_torch.elastic.tta import _paths
    from repro_torch.models import forward, init_params
    from repro_torch.models.configs import InputShape
    from repro_torch.models.layers import cast_params
    t_phase = time.perf_counter()
    cfg = get_config("paper-backbone")
    shape = InputShape("app", 256, 4, "prefill")
    budgets = Budgets(latency_s=0.05, memory_bytes=2e9)
    params = cast_params(init_params(cfg, seed=0, device="cuda"),
                         torch.bfloat16)
    rng = np.random.default_rng(19)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 256)).astype(np.int32)).cuda()
    contexts = ([(n, ResourceContext(**kw)) for n, kw in QUICKSTART_CONTEXTS]
                + [(f"budget {c.mem_free_frac}", c)
                   for c in budget_sweep_trace()]
                + [(f"case {i}", c)
                   for i, c in enumerate(case_study_trace(24))])

    # (a) the main path: the loop's ticks and two TTA steps
    mw = Middleware(cfg=cfg, params=params, shape=shape, budgets=budgets)
    log(f"adaptation loop: paper-backbone bf16 on the card, hw "
        f"{mw.hw.name}, offline Pareto front of {len(mw.loop.front)} "
        f"configurations, {len(contexts)} ticks")
    sharp = dict(params, embed=params["embed"] * 8.0)
    mw_tta = Middleware(cfg=cfg, params=sharp, shape=shape, budgets=budgets)
    # a TTA step runs the full backbone's forward under autograd: its
    # launches are one forward's (the backward launches nothing)
    tta_expect = expected_launches(cfg, sharp)
    zero_counts()
    times, visited, first, expect = drive_middleware(torch, mw, tokens,
                                                     contexts)
    ents, tta_ms = [], []
    for step in range(2):
        before = {k: fn.launches for k, fn in _kernel_fns().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ents.append(mw_tta.adapt_weights(tokens, lr=5e-2))
        torch.cuda.synchronize()
        tta_ms.append(1e3 * (time.perf_counter() - t0))
        delta = {k: fn.launches - before[k]
                 for k, fn in _kernel_fns().items()}
        if delta != tta_expect:
            raise AssertionError(f"TTA step {step}: launches {delta}, "
                                 f"expected {tta_expect}")
        expect = {k: n + tta_expect[k] for k, n in expect.items()}
    counts = {name: fn.launches for name, fn in _kernel_fns().items()}
    n_infer = len(contexts)
    if counts != expect:
        raise AssertionError(f"adaptation loop: launches {counts}, "
                             f"expected {expect}")
    if not ents[1] < ents[0]:
        raise AssertionError(f"TTA: the entropy did not fall: {ents}")
    old = dict(_paths(sharp))
    changed = [p for p, a in _paths(mw_tta.supernet.backbone_params)
               if p not in old or not torch.equal(a, old[p])]
    bad = [p for p in changed if not any(n in NORM_KEYS for n in p)]
    if bad or ("logit_bias",) not in changed:
        raise AssertionError(f"TTA changed {changed}")
    log(f"adaptation loop: {n_infer} ticks, variants visited "
        f"{[spec_name(s) for s in visited]}; launches {counts} (K2 once a "
        f"layer of each tick's variant, K3 once a layer where its FFN is "
        f"dense and gated, both once a layer per TTA step; all exact)")
    log(f"TTA on the card: entropy {ents[0]:.5f} -> {ents[1]:.5f}; steps "
        f"{tta_ms[0]:.2f} / {tta_ms[1]:.2f} ms (host clock); changed "
        f"{sorted('/'.join(p) for p in changed)}")

    # where an infer's time goes, per variant visited
    for spec in visited:
        vcfg, vparams = mw.supernet.variant(spec)
        wall = sorted(times[spec])[len(times[spec]) // 2]
        log(f"infer of {spec_name(spec)} ({vcfg.num_layers} layers, d_ff "
            f"{vcfg.d_ff}): host {wall:.3f} ms (median of "
            f"{len(times[spec])} ticks)")
        device_profile(torch, lambda: forward(vparams, vcfg, tokens)[0], 10,
                       wall, f"  infer profile ({spec_name(spec)})")

    # each variant's first bf16 infer against the port's plain path on the
    # CPU with the same bf16 weights
    for spec in visited:
        logits, vcfg, vparams, opts = first[spec]
        with torch.no_grad():
            cpu = forward(to_cpu(vparams), vcfg, tokens.cpu(), opts)[0]
            f32 = forward(to_cpu(vparams, torch.float32),
                          vcfg.with_updates(activation_dtype="float32"),
                          tokens.cpu(), opts)[0]
        v = vcfg.vocab_size
        err = check_close("bf16 infer", logits[..., :v].cpu(), cpu[..., :v],
                          INFER_BF16_TOL, f"{spec_name(spec)} card vs CPU")
        log(f"bf16 infer of {spec_name(spec)} card == CPU plain path: "
            f"max_abs_err {err:.4g} (atol {INFER_BF16_TOL['atol']}, rtol "
            f"{INFER_BF16_TOL['rtol']}); the CPU's bf16 logits lie within "
            f"{float((cpu[..., :v].float() - f32[..., :v]).abs().max()):.4g}"
            f" of f32 on the same weights (|logit| <= "
            f"{float(f32[..., :v].abs().max()):.4g})")

    # K2 and K3 alone at the shapes an infer gives them (bf16, 4 x 256
    # tokens, 8 heads of 32 as (B,H,S,hd) views, causal; M 1024, D 256,
    # F 1024, silu), each held against its plain version on the same
    # inputs and repeating bit for bit, then timed beside its bound, its
    # plain version and one library call (SDPA; for K3, which no one call
    # computes, the unfused cuBLAS chain)
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, fused_ffn
    from repro_torch.kernels.ref import fused_ffn_ref
    gen = torch.Generator().manual_seed(6)
    q, k, v = flash_case(torch, gen, 4, 8, 8, 256, 32, "bfloat16")
    x, wg, wu, wd = ffn_case(torch, gen, 1024, 256, 1024, "bfloat16")
    for name, fn, plain, library, part, nbytes, flops, tol in (
            ("K2", lambda: flash_attention(q, k, v),
             lambda: flash_plain(q, k, v),
             lambda: F.scaled_dot_product_attention(q, k, v,
                                                    is_causal=True),
             "flash_attn", 4 * q.numel() * 2,
             4 * 32 * flash_pairs(256, True, 0, None) * 4 * 8,
             TOL["bfloat16"]),
            ("K3", lambda: fused_ffn(x, wg, wu, wd),
             lambda: fused_ffn_ref(x, wg, wu, wd),
             lambda: (F.silu(x @ wg) * (x @ wu)) @ wd,
             "fused_ffn", 2 * (2 * x.numel() + 3 * wg.numel()),
             6 * 1024 * 256 * 1024, FFN_TOL["bfloat16"])):
        out = fn()
        err = check_close(part, out, plain(), tol,
                          f"{name} at the infer's shape")
        if not torch.equal(out, fn()):
            raise AssertionError(f"{name} does not repeat at the infer's "
                                 "shape")
        ms, dev = cuda_ms(torch, fn, iters=100), device_ms(torch, fn,
                                                          part=part)
        plain_ms = cuda_ms(torch, plain, iters=20)
        lib_ms, lib_dev = cuda_ms(torch, library, iters=100), device_ms(
            torch, library)
        b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
        log(f"{name} at the infer's shape: == plain version, max_abs_err "
            f"{err:.3g} (atol {tol['atol']}, rtol {tol['rtol']}), repeats "
            f"bit for bit; {ms:.4f} ms (CUDA events), "
            f"device {fmt(dev)}, bound {b_ms:.5f} ms ({b_by}), plain "
            f"{plain_ms:.4f} ms, {'SDPA' if name == 'K2' else 'chain'} "
            f"{lib_ms:.4f} ms (device {fmt(lib_dev)})")

    # (b) every variant of the action space: card == CPU in f32
    cfg32 = cfg.with_updates(activation_dtype="float32")
    params32 = init_params(cfg, seed=0, device="cuda")
    tok2 = tokens[:2]
    sn32 = ElasticSupernet(cfg32, params32, max_cached=32)
    space = sn32.action_space()
    max_err = 0.0
    for spec in space:
        vcfg, vparams = sn32.variant(spec)
        card = forward(vparams, vcfg, tok2)[0]
        cpu = forward(to_cpu(vparams), vcfg, tok2.cpu())[0]
        max_err = max(max_err, check_close(
            "variant forward", card.cpu(), cpu, LOGITS_TOL,
            f"{spec_name(spec)} card vs CPU"))
    log(f"every variant card == CPU in f32: {len(space)} specs "
        f"{[spec_name(s) for s in space]}, max_abs_err {max_err:.3g} "
        f"(atol {LOGITS_TOL['atol']}, rtol {LOGITS_TOL['rtol']})")

    # (c) TTA gradients card == CPU in f32 (the K2/K3 backwards)
    sharp32 = dict(params32, embed=params32["embed"] * 8.0)
    _, g_card, _ = tta_grads(sharp32, cfg32, tok2)
    _, g_cpu, _ = tta_grads(to_cpu(sharp32), cfg32, tok2.cpu())
    worst = 0.0
    for path, g in g_cpu.items():
        scale = float(g.abs().max())
        err = float((g_card[path].cpu() - g).abs().max())
        if err > GRAD_REL_TOL * scale + 1e-12:
            raise AssertionError(f"TTA gradient of {'/'.join(path)}: card "
                                 f"vs CPU max err {err} of max {scale}")
        worst = max(worst, err / max(scale, 1e-30))
    log(f"TTA gradients card == CPU in f32 on {len(g_cpu)} leaves (norm "
        f"scales, logit_bias and every weight): worst error {worst:.3g} of "
        f"the leaf's largest gradient (tolerance {GRAD_REL_TOL})")

    # (d) early exit at layers 2, 4 and 6: the same depths, f32
    p_ex = attach_exits(cfg32, sharp32, positions=(2, 4, 6))
    p_ex_cpu = to_cpu(p_ex)
    thr, margin = pick_threshold(torch, forward_with_exits(
        p_ex_cpu, cfg32, tok2.cpu()))
    _, depth = early_exit_predict(p_ex, cfg32, tok2, threshold=thr)
    _, depth_cpu = early_exit_predict(p_ex_cpu, cfg32, tok2.cpu(),
                                      threshold=thr)
    if not torch.equal(depth.cpu(), depth_cpu):
        raise AssertionError("early exit: depths differ card vs CPU")
    hist = torch.bincount(depth_cpu.flatten().long(), minlength=4).tolist()
    if sum(1 for n in hist if n) < 2:
        raise AssertionError(f"early exit: no split at {thr}: {hist}")
    log(f"early exit (exits at 2, 4, 6; threshold {thr:.5f}, {margin:.2g} "
        f"from the nearest confidence): depths card == CPU, tokens per "
        f"exit {hist}")

    # (e) the H100 profile's estimates against the card's forward times
    sn = ElasticSupernet(cfg, params, max_cached=32)
    est, meas = [], []
    for spec in space:
        vcfg, vparams = sn.variant(spec)
        est.append(estimate_latency(layer_costs(vcfg, 4, 256), 0.70,
                                    H100_SXM))
        with torch.no_grad():
            meas.append(cuda_ms(torch, lambda: forward(vparams, vcfg,
                                                       tokens), 10, 3))
    rho = rank_consistency(est, meas)
    log(f"profiler vs card: rank_consistency {rho:.4f} of H100_SXM "
        f"estimates (eps 0.70) against CUDA-event forward times over "
        f"{len(space)} variants")
    for spec, e, m in zip(space, est, meas):
        log(f"  {spec_name(spec):40s} est {1e3 * e:.4f} ms, card "
            f"{m:.4f} ms")
    log(f"H100_SXM.idle_w {H100_SXM.idle_w} W; idle power.draw read in "
        f"phase 1: {idle_w} W ({smi})")
    log(f"adaptation phase: {time.perf_counter() - t_phase:.1f} s")
    return {k: n for k, n in counts.items() if n}



# ---------------------------------------------------------------- phase 7
def check_crowd_counts(engines, what):
    """``check_counts`` over a fleet run's engines (K1 from the paged
    block-table engines' decode steps, K2/K3 from every engine's), where
    K1, K2 and K3 must each have launched."""
    counts = check_counts(engines, what)
    ran = ("paged_decode_attention", "flash_attention", "fused_ffn")
    if not all(counts.get(k) for k in ran):
        raise AssertionError(f"{what}: K1, K2 or K3 did not run: {counts}")
    steps = {e.pid: (e.decode_mode, e.stats.decode_calls,
                     e.stats.prefill_calls) for e in engines}
    log(f"{what}: (mode, decode steps, prefill calls) by member {steps}")
    return counts


def check_trace_file(path, layers):
    """``tools/check_trace.py`` (a tool of the repo that imports nothing
    of either package) over an exported trace."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_trace", ROOT / "tools" / "check_trace.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    if tool.check(Path(path), require_layers=layers) != 0:
        raise AssertionError(f"{path} fails tools/check_trace.py")


def crowd_kernels_alone(torch):
    """K1, K2 and K3 against their plain versions at the shapes phase 7
    gives them, before its counted runs: f32 (7a: 4 slots of 512-token
    tables over an f32 pool, a prefill burst of 4 x 256, the FFN at M 4
    and 1024) and bf16 (7b: 8 slots over an int8 pool, a burst of 8 x 256,
    the FFN at M 8 and 2048)."""
    from repro_torch.kernels import flash_attention, fused_ffn
    from repro_torch.kernels.ref import fused_ffn_ref, paged_decode_attn_ref
    gen = torch.Generator().manual_seed(77)
    worst = {}
    for dtype, slots, pool, burst in (("float32", 4, "float32", 4),
                                      ("bfloat16", 8, "int8", 8)):
        args, sc = make_case(torch, gen, slots=slots, heads=8, kvh=8, hd=32,
                             bs=16, mb=32, pool_dtype=pool, q_dtype=dtype,
                             pos_kind="short")
        errs = [check_close("paged_decode_attention", k1_repeated(
            torch, args, sc, 0), paged_decode_attn_ref(*args, **sc),
            TOL[dtype], f"phase 7, {slots} slots, {pool} pool")]
        q, k, v = flash_case(torch, gen, burst, 8, 8, 256, 32, dtype)
        errs.append(check_close("flash_attention", flash_attention(q, k, v),
                                flash_plain(q, k, v), TOL[dtype],
                                f"phase 7, {burst} x 256"))
        for m in (slots, burst * 256):
            x, wg, wu, wd = ffn_case(torch, gen, m, 256, 1024, dtype)
            errs.append(check_close("fused_ffn", fused_ffn(x, wg, wu, wd),
                                    fused_ffn_ref(x, wg, wu, wd),
                                    FFN_TOL[dtype], f"phase 7, M {m}"))
        worst[dtype] = max(errs)
    log("phase 7 shapes: K1, K2, K3 == plain versions, max_abs_err "
        + ", ".join(f"{d} {e:.3g}" for d, e in worst.items()))


def crowd_prompts(n, seed, vocab, lo, hi):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).astype(
        np.int32) for _ in range(n)]


def greedy_requests(prompts, new_tokens, rid_base=0):
    from repro_torch.serving import Request, SamplingOpts
    return [Request(rid=rid_base + i, prompt=p, max_new_tokens=new_tokens,
                    sampling=SamplingOpts(temperature=0.0))
            for i, p in enumerate(prompts)]


def stream_margins(torch, params, cfg, prompts, streams, opts=None):
    """The smallest top-2 logit margin along each greedy stream, from one
    dense prefill of prompt + stream on the CPU: a near-tie would show
    here before it flips a token."""
    import numpy as np
    from repro_torch.models.model import init_cache, prefill
    from repro_torch.models.runtime import DEFAULT_OPTIONS
    opts = opts or DEFAULT_OPTIONS
    out = []
    for p, s in zip(prompts, streams):
        toks = np.concatenate([p, np.asarray(s[:-1], np.int32)])
        t = torch.as_tensor(toks, dtype=torch.int32)[None]
        logits, _ = prefill(params, cfg, t,
                            init_cache(cfg, 1, t.shape[1], opts,
                                       device="cpu"), opts)
        top = torch.topk(logits[0, len(p) - 1:, :cfg.vocab_size].float(),
                         2).values
        out.append(float((top[:, 0] - top[:, 1]).min()))
    return out


def phase_crowd(torch, smi):
    """The crowd on the card: 7a, a crash on an engine-backed helper whose
    in-flight requests migrate to a peer (f32, streams exact against an
    unfaulted card run and the CPU); 7b, a five-device crowd with two
    engine-backed members (bf16), its telemetry, calibrations, report,
    attribution and flight recorder.  Returns ``{kernel name:
    launches}`` over both fleet runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.monitor import ResourceContext, constant_trace
    from repro_torch.faults import (CRASH, DetectorConfig, FaultInjector,
                                    FaultSpec, summarize_faults)
    from repro_torch.models import init_params
    from repro_torch.models.configs import InputShape
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.obs import LAYERS, TraceRecorder, write_trace
    from repro_torch.fleet import FleetController, make_device
    from repro_torch.serving import CompileCache, ServingEngine
    t_phase = time.perf_counter()
    crowd_kernels_alone(torch)
    traces = ROOT / "build" / "traces"
    traces.mkdir(parents=True, exist_ok=True)
    cfg = get_config("paper-backbone")
    totals = {}

    # --- 7a: migration under a crash, f32 ------------------------------
    cfg32 = cfg.with_updates(activation_dtype="float32")
    params32 = init_params(cfg32, seed=0, device="cuda")
    f32 = RuntimeOptions(kv_cache_dtype="float32")
    prompts = crowd_prompts(8, 70, cfg.vocab_size, 100, 250)
    new_tokens = 64
    # the chaos suite's fleet: a loaded phone, two same-site helpers, a
    # WAN server
    fleet = [make_device("pixel_6_cpu", 0, site="home"),
             make_device("jetson_agx_orin", 0, site="home"),
             make_device("jetson_agx_orin", 1, site="home"),
             make_device("edge_server_a100", 0, site="dc")]
    phone, src_id, dst_id = (d.device_id for d in fleet[:3])
    loaded = ResourceContext(cpu_temp_derate=0.45, competing_procs=4)

    def trace_factory(spec, n):
        return constant_trace(loaded if spec.device_id == phone
                              else ResourceContext(), n)

    rec = TraceRecorder()
    ctl = FleetController(fleet, cfg, InputShape("chaos_t", 256, 4,
                                                 "prefill"),
                          trace_ticks=4000, trace_factory=trace_factory,
                          placement=True, allow_offload=False,
                          detector_config=DetectorConfig(
                              suspect_after=2.5, dead_after=5.0),
                          warmup_ticks=4, recalibrate_every=2,
                          recorder=rec)
    ctl.set_sla(phone, 0.5)
    zero_counts()
    t0 = time.perf_counter()
    src = ctl.build_engine(src_id, params32, cfg=cfg32, slots=4,
                           max_seq=512, decode_mode="paged", block_size=16,
                           opts=f32.replace(paged_kernel=True),
                           steps_per_tick=1, device="cuda")
    dst = ctl.build_engine(dst_id, params32, cfg=cfg32, slots=4,
                           max_seq=512, opts=f32, steps_per_tick=4,
                           device="cuda")
    reqs = greedy_requests(prompts, new_tokens)
    for r in reqs:
        src.submit(r)
    src.step()
    src.step()
    waiting = len(src._queue)
    FaultInjector(ctl, [FaultSpec(CRASH, src_id,
                                  at_s=ctl.now_s + 0.5)]).arm()
    ctl.run_for(20.0)
    dst.drain()
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    totals.update(check_crowd_counts([src, dst], "7a fleet run (crash, "
                               "migration)"))
    evicts = [e for e in rec.events if e.name == "fleet.evict"
              and e.args["device"] == src_id]
    frozen = src.stats.freezes
    summ = summarize_faults(rec.events)
    check_budgets(dst, reqs, new_tokens)
    if len(evicts) != 1:
        raise AssertionError(f"7a: {len(evicts)} evictions of {src_id}")
    if ctl.migrations != frozen + waiting or not frozen:
        raise AssertionError(f"7a: {ctl.migrations} migrations, {frozen} "
                             f"frozen + {waiting} waiting")
    if dst.stats.thaws != frozen:
        raise AssertionError(f"7a: {dst.stats.thaws} thaws of {frozen} "
                             "frozen")
    if summ["migrated_reprefills"] != 0:
        raise AssertionError(f"7a: re-prefills {summ}")
    path = traces / "crowd_migration.json"
    write_trace(rec, str(path))
    check_trace_file(path, LAYERS)
    streams = [tuple(r.generated) for r in reqs]
    # the same requests, unfaulted: a batched engine on the card, and the
    # port's plain path on the CPU
    want = {}
    params_cpu = init_params(cfg32, seed=0, device="cpu")
    for device, p in (("cuda", params32), ("cpu", params_cpu)):
        eng = ServingEngine(cfg32, p, slots=4, max_seq=512, opts=f32,
                            compile_cache=CompileCache(), device=device)
        base = greedy_requests(prompts, new_tokens)
        for r in base:
            eng.submit(r)
        eng.drain()
        want[device] = [tuple(r.generated) for r in base]
    margins = stream_margins(torch, params_cpu, cfg32, prompts,
                             want["cpu"])
    log(f"7a: CPU top-2 logit margins along the 8 streams: min "
        f"{min(margins):.4g}, per stream "
        + ", ".join(f"{m:.3g}" for m in margins))
    for label, other in (("unfaulted card run", want["cuda"]),
                         ("CPU plain path", want["cpu"])):
        if streams != other:
            diff = [i for i, (a, b) in enumerate(zip(streams, other))
                    if a != b]
            raise AssertionError(f"7a: migrated streams differ from the "
                                 f"{label} on requests {diff}")
    [mig] = [e.args for e in rec.events if e.name == "fleet.migrate"]
    log(f"7a on {smi}: {src_id} crashed at fleet time "
        f"{evicts[0].sim_s:.2f} s (evicted), {frozen} frozen + {waiting} "
        f"waiting = {ctl.migrations} migrations to {dst_id} "
        f"(zero-reprefill {sorted(mig['zero_reprefill'])}, fallback "
        f"{mig['fallback']}, {mig['recovered_tokens']} tokens carried), "
        f"thaws {dst.stats.thaws}, prefills {dst.stats.prefills}, "
        f"re-prefills {summ['migrated_reprefills']}; 8 x {new_tokens} "
        f"greedy tokens == the unfaulted card run == the CPU; "
        f"{wall_a:.2f} s host, {ctl.wakes} wakes; trace "
        f"{len(rec.events)} events, passes tools/check_trace.py")

    # --- 7b: a crowd run, bf16 -----------------------------------------
    from repro_torch.fleet import (CHANNELS, ENGINE, SIMULATED, TIERS,
                                   build_fleet, fleet_report)
    from repro_torch.obs import (FlightRecorder, SLOClass, SLOTracker,
                                 attribute_fleet, spans)
    params = init_params(cfg, seed=0, device="cuda")
    fleet = build_fleet(5, seed=0)
    tiers = {d.device_id: d.tier for d in fleet}
    light = next(d.device_id for d in fleet if d.tier == "light")
    heavy = next(d.device_id for d in fleet if d.tier == "heavy")
    flight = FlightRecorder(capacity=1 << 18)
    slo = SLOTracker(SLOClass(name="interactive", ttft_p95_s=1.0,
                              tpot_p95_s=0.05), window_s=2.0)
    ctl = FleetController(fleet, cfg, InputShape("crowd", 128, 2, "decode"),
                          trace_ticks=80, warmup_ticks=4, placement=True,
                          recorder=flight, slo=slo)
    zero_counts()
    t0 = time.perf_counter()
    engines = {
        light: ctl.build_engine(light, params, cfg=cfg, slots=8,
                                max_seq=512, decode_mode="paged",
                                block_size=16, steps_per_tick=3,
                                opts=RuntimeOptions(paged_kernel=True,
                                                    kv_dtype="int8"),
                                device="cuda"),
        heavy: ctl.build_engine(heavy, params, cfg=cfg, slots=8,
                                max_seq=512, steps_per_tick=3,
                                device="cuda")}
    served = {}
    for i, (did, eng) in enumerate(engines.items()):
        served[did] = greedy_requests(
            crowd_prompts(16, 80 + i, cfg.vocab_size, 8, 250), 48,
            rid_base=100 * i)
        for r in served[did]:
            eng.submit(r)
    for eng in engines.values():
        eng.step()                      # warm: the first step captures
    for did in engines:
        ctl.set_sla(did, 5e-3)          # 5 ms a step, externally given
    ctl.run_for(16.0)
    wall_b = time.perf_counter() - t0
    wakes = dict(ctl.tick_counts)
    steps = {did: eng.stats.steps for did, eng in engines.items()}
    for eng in engines.values():
        eng.drain()
    torch.cuda.synchronize()
    totals_b = check_crowd_counts(list(engines.values()), "7b crowd run")
    for k, n in totals_b.items():
        totals[k] = totals.get(k, 0) + n
    for did, eng in engines.items():
        check_budgets(eng, served[did], 48)
    log(f"7b on {smi}: {wall_b:.2f} s host for {ctl.now_s:.1f} s of fleet "
        f"time, {ctl.wakes} wakes")
    for did in sorted(wakes, key=lambda d: -wakes[d]):
        extra = ""
        if did in engines:
            extra = (f", {steps[did]} engine steps in the run = "
                     f"{steps[did] / max(wakes[did], 1):.2f} a wake")
        log(f"  {did:24s} {tiers[did]:6s} {wakes[did]:3d} wakes{extra}")
    log("7b tier calibrations (latency_scale, latency_bias_s, samples):")
    for tier in TIERS:
        for chan in CHANNELS:
            c = ctl.telemetry.calibration_for_tier(tier, chan)
            if c.samples:
                log(f"  {tier:6s} {chan:9s} x{c.latency_scale:.6g} "
                    f"{c.latency_bias_s:+.6g} s  energy "
                    f"x{c.energy_scale:.6g}  ({c.samples} samples)")
    if not any(ctl.telemetry.calibration_for_tier(tiers[d], ENGINE).samples
               for d in engines):
        raise AssertionError("7b: no ENGINE-channel calibration")
    if not ctl.telemetry.calibration_for_tier("medium", SIMULATED).samples:
        raise AssertionError("7b: no SIMULATED calibration")
    log("7b report:\n" + fleet_report(ctl).render())
    for did, eng in engines.items():
        st = sorted(eng.step_times)
        log(f"  engine {did} ({eng.decode_mode}): median host-clock step "
            f"{1e3 * st[len(st) // 2]:.3f} ms over {len(st)} steps, ewma "
            f"{1e3 * eng.step_time_ewma_s:.3f} ms, graph captures "
            f"{captures(eng)}")
    # where a wake's host time goes, from the trace
    for did in engines:
        ws = spans(flight, name="fleet.wake", pid=did)
        inner = {name: spans(flight, name=name, pid=did)
                 for name in ("engine.step", "engine.prefill")}
        wake_ms = 1e3 * sum(s.wall_dur_s for s in ws)
        parts = {name: 1e3 * sum(s.wall_dur_s for s in v
                                 if any(w.wall_begin_s <= s.wall_begin_s
                                        <= w.wall_end_s for w in ws))
                 for name, v in inner.items()}
        n = max(len(ws), 1)
        loop_ms = wake_ms - sum(parts.values())
        log(f"  {did}: {len(ws)} wakes, host ms a wake {wake_ms / n:.3f} = "
            f"engine steps {parts['engine.step'] / n:.3f} + prefill "
            f"{parts['engine.prefill'] / n:.3f} + loop decision, "
            f"telemetry and placement {loop_ms / n:.3f}")
    fa = attribute_fleet(flight, tiers=tiers)
    for pid, a in fa.per_device.items():
        log(f"  attribution {pid}: {a.requests} requests, dominant layer "
            f"{a.dominant_layer} ({a.dominant}), tail {a.tail_dominant_layer} "
            f"({a.tail_dominant})")
    dumps = flight.flush()
    pages = [e for e in flight.events if e.name == "slo.page"]
    log(f"7b SLO: {len(pages)} pages, pressure {slo.pressure:.3g}, "
        f"{len(dumps)} flight dumps")
    paths = flight.write_dumps(str(traces / "crowd_flight"))
    for d, path in zip(dumps, paths):
        check_trace_file(path, ())
        log(f"  dump {d['anomaly']} on {d['pid']} at {d['ts_s']:.2f} s: "
            f"{d['events']} events, passes tools/check_trace.py")
    if pages and not dumps:
        raise AssertionError("7b: the SLO paged and the flight recorder "
                             "dumped nothing")
    log(f"crowd phase: {time.perf_counter() - t_phase:.1f} s")
    return totals

# ---------------------------------------------------------------- phase 8
# (slots, heads, kv heads, pool, q dtype, mb): K1 at olmoe-1b-7b's decode
# shape (16 heads of 128, group 1) and at group 4, bf16; the f32 shapes of
# 8b (the reduced olmoe and llama4: 2 heads of 128, int8 and f32 pools)
K1_EXPERT_CASES = [(8, 16, 16, "int8", "bfloat16", 64),
                   (8, 16, 16, "bfloat16", "bfloat16", 64),
                   (8, 16, 4, "int8", "bfloat16", 64),
                   (8, 16, 4, "bfloat16", "bfloat16", 64),
                   (4, 2, 2, "int8", "float32", 32),
                   (4, 2, 2, "float32", "float32", 32)]
# (batch, S, heads, kv heads, dtype): K2 at olmoe's prefill (bucket
# 1024), the reduced olmoe/llama4 burst and reduced mixtral's (GQA 16/8)
K2_EXPERT_CASES = [(8, 1024, 16, 16, "bfloat16"), (4, 256, 2, 2, "float32"),
                   (4, 256, 16, 8, "float32")]


def experts_kernels_alone(torch):
    """8.0: K1, K2 and K3 against their plain versions at the shapes
    phase 8 gives them, each repeating bit for bit; then K1 and K2 at
    hd 128 timed beside their bounds and SDPA.  Returns the timing
    fields for the kernels line, by kernel name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, fused_ffn
    from repro_torch.kernels.paged_decode_attn import paged_decode_attention
    from repro_torch.kernels.ref import fused_ffn_ref, paged_decode_attn_ref
    gen = torch.Generator().manual_seed(88)
    worst = {}
    n_cases = 0
    for slots, heads, kvh, pool, q_dtype, mb in K1_EXPERT_CASES:
        for pos_kind in ("ragged", "full_tail"):
            args, sc = make_case(torch, gen, slots=slots, heads=heads,
                                 kvh=kvh, hd=128, bs=16, mb=mb,
                                 pool_dtype=pool, q_dtype=q_dtype,
                                 pos_kind=pos_kind)
            err = check_close(
                "paged_decode_attention", k1_repeated(torch, args, sc, 0),
                paged_decode_attn_ref(*args, **sc), TOL[q_dtype],
                f"hd 128, H={heads} kvh={kvh} pool={pool} q={q_dtype} "
                f"mb={mb} pos={pos_kind}")
            worst["K1"] = max(worst.get("K1", 0.0), err)
            n_cases += 1
    for b, s_len, h, kvh, dtype in K2_EXPERT_CASES:
        q, k, v = flash_case(torch, gen, b, h, kvh, s_len, 128, dtype)
        out = flash_attention(q, k, v)
        err = check_close("flash_attention", out, flash_plain(q, k, v),
                          TOL[dtype], f"{b} x {s_len}, H={h} kvh={kvh}, "
                          f"hd 128, {dtype}")
        if not torch.equal(out, flash_attention(q, k, v)):
            raise AssertionError(f"flash_attention does not repeat at "
                                 f"{b} x {s_len}, hd 128")
        worst["K2"] = max(worst.get("K2", 0.0), err)
        n_cases += 1
    # llama4's shared expert (reduced: D 256, F 384) at a decode step of
    # 4 slots and a prefill burst of 4 x 256, f32
    for m in (4, 1024):
        x, wg, wu, wd = ffn_case(torch, gen, m, 256, 384, "float32")
        out = fused_ffn(x, wg, wu, wd)
        err = check_close("fused_ffn", out, fused_ffn_ref(x, wg, wu, wd),
                          FFN_TOL["float32"], f"phase 8, M {m}, F 384")
        if not torch.equal(out, fused_ffn(x, wg, wu, wd)):
            raise AssertionError(f"fused_ffn does not repeat at M {m}")
        worst["K3"] = max(worst.get("K3", 0.0), err)
        n_cases += 1
    log(f"phase 8 shapes: K1 (hd 128, groups 1 and 4), K2 (hd 128) and K3 "
        f"== plain versions on {n_cases} cases, each repeating bit for "
        "bit; max_abs_err " + ", ".join(f"{k} {e:.3g}"
                                        for k, e in worst.items()))

    # K1 at olmoe's serving shape: 8 slots x 16 heads of 128 over an int8
    # pool of 16 layers, positions of the waves' decode steps (8..314)
    args, sc = make_case(torch, gen, slots=8, heads=16, kvh=16, hd=128,
                         bs=16, mb=64, pool_dtype="int8",
                         q_dtype="bfloat16", pos_kind="zero", layers=16,
                         layer=5)
    args[4].copy_(torch.randint(8, 315, (8,), generator=gen,
                                dtype=torch.int32))
    k1 = dict(
        ms=cuda_ms(torch, lambda: paged_decode_attention(*args, **sc)),
        device_ms=device_ms(torch, lambda: paged_decode_attention(
            *args, **sc), part="paged_decode"),
        plain_ms=cuda_ms(torch, lambda: paged_decode_attn_ref(*args, **sc)))
    k1["library_ms"], k1["library_device_ms"] = sdpa_yardstick(torch, args,
                                                               sc)
    k1["bound_ms"], k1["bound_by"] = paged_bound_ms(args, sc)
    # K2 at olmoe's prefill bucket 1024: 8 prompts x 16 heads of 128
    q, k, v = flash_case(torch, gen, 8, 16, 16, 1024, 128, "bfloat16")
    pairs = flash_pairs(1024, True, 0, None) * 8 * 16
    k2 = dict(
        ms=cuda_ms(torch, lambda: flash_attention(q, k, v), iters=50),
        device_ms=device_ms(torch, lambda: flash_attention(q, k, v),
                            part="flash_attn"),
        plain_ms=cuda_ms(torch, lambda: flash_plain(q, k, v), iters=5,
                         warmup=2),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=50),
        library_device_ms=device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)))
    k2["bound_ms"], k2["bound_by"] = bound(4 * q.numel() * q.element_size(),
                                           4 * 128 * pairs, H100_BF16_FLOPS)
    for name, t, shape in (
            ("paged_decode_attention", k1, "8 slots x 16 heads of 128, "
             "group 1, int8 pool, mb 64, positions 8..314"),
            ("flash_attention", k2, "8 x 1024 tokens, 16 heads of 128, "
             "bf16, causal")):
        log(f"{name} at olmoe-1b-7b's shape ({shape}): kernel_ms "
            f"{t['ms']:.4f} device {fmt(t['device_ms'])}; plain_ms "
            f"{t['plain_ms']:.4f}; SDPA {t['library_ms']:.4f} ms, device "
            f"{fmt(t['library_device_ms'])}; bound_ms {t['bound_ms']:.5f} "
            f"({t['bound_by']})")
    return {"paged_decode_attention": {f"{k}_hd128": v for k, v in
                                       k1.items()},
            "flash_attention": {f"{k}_hd128": v for k, v in k2.items()}}


def moe_repeats(torch, eng, params, cfg):
    """The MoE blocks and a whole decode step repeat bit for bit on the
    card: ``moe_apply`` over a prefill burst of 8 x 256 tokens and the
    dense-dispatch ``moe_apply_decode`` over 8 slots, each with layer 0's
    weights, and the paged step run eagerly on two clones of one engine
    state (tokens and every pool and cache leaf equal).  Returns the
    eager step on the first clone."""
    from repro_torch.models import moe
    from repro_torch.models.layers import layer_slice, tree_leaves
    gen = torch.Generator().manual_seed(8)
    layer = layer_slice(params["layers"], 0)["moe"]
    x = (torch.randn(8, 256, cfg.d_model, generator=gen) * 0.5).to(
        torch.bfloat16).cuda()
    for what, fn in (
            ("moe_apply (8 x 256 tokens)",
             lambda: moe.moe_apply(layer, x, cfg)[0]),
            ("moe_apply_decode (8 tokens)",
             lambda: moe.moe_apply_decode(layer, x[:, 0], cfg))):
        if not torch.equal(fn(), fn()):
            raise AssertionError(f"{what} does not repeat bit for bit")
    fill_slots(eng, 32)
    step_a, state_a = eager_on_clones(torch, eng)
    step_b, state_b = eager_on_clones(torch, eng)
    toks_a, toks_b = step_a(), step_b()
    same = torch.equal(toks_a, toks_b) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(state_a),
                                          tree_leaves(state_b)))
    if not same:
        raise AssertionError("the olmoe decode step does not repeat bit for "
                             "bit on two clones of one state")
    log("the MoE prefill block, the dense-dispatch decode block and a whole "
        "olmoe decode step (tokens, pool, slot cache) repeat bit for bit")
    return step_a


def expert_split(torch, step, cfg, reps=8):
    """Device time of an eager decode step split into the expert products
    (the ``matmul``s over stacked expert weights: (T, D) x (E, D, F) and
    (T, E*F) x (E*F, D)), K1 and the rest, from one profile with shapes
    recorded.  Returns ``(busy, experts, K1)`` in ms a step."""
    from torch.profiler import ProfilerActivity, profile
    e, f = cfg.num_experts, cfg.d_ff
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()

    def expert_product(ev):
        shapes = ev.input_shapes or []
        return ev.name == "aten::matmul" and len(shapes) >= 2 and (
            (len(shapes[1]) == 3 and shapes[1][0] == e)
            or (shapes[0] and shapes[0][-1] == e * f))

    experts = sum(ev.device_time_total for ev in prof.events()
                  if expert_product(ev)) / 1e3 / reps
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ev.self_device_time_total for ev in kernels) / 1e3 / reps
    k1 = sum(ev.self_device_time_total for ev in kernels
             if "paged_decode" in ev.key) / 1e3 / reps
    if experts <= 0 or k1 <= 0:
        raise RuntimeError(f"the profile split found experts {experts} ms, "
                           f"K1 {k1} ms")
    return busy, experts, k1


def step_bytes(params, eng):
    """Bytes a decode step must read at least: every weight once (dense
    dispatch reads every expert; the tied unembedding reads the whole
    table) and each active slot's KV rows with their int8 scales."""
    from repro_torch.models.layers import tree_leaves
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    pool = eng._pool
    _, n_attn, _, kvh, hd = pool["k"].shape
    row = 2 * n_attn * (kvh * hd * pool["k"].element_size()
                        + (4 if "k_scale" in pool else 0))
    rows = sum(min(int(p), eng.max_seq) for p, r in zip(
        eng._cache["pos"].tolist(), eng._active) if r is not None)
    return weights, rows * row


def moe_counts(engines, what, kw, cfg):
    """``check_counts`` over an MoE run, which must launch K2, K1 when
    paged and K3 only for a shared expert."""
    counts = check_counts(engines, what)
    want = {"flash_attention"}
    if kw["decode_mode"] == "paged":
        want.add("paged_decode_attention")
    if cfg.moe_shared_expert:
        want.add("fused_ffn")
    if set(counts) != want:
        raise AssertionError(f"{what}: kernels {sorted(counts)}, expected "
                             f"{sorted(want)}")
    return counts


def moe_drops_card_vs_cpu(torch, cfgs):
    """The capacity-drop path of ``moe_apply`` card == CPU on inputs with
    no exact ties (a prefill burst of 4 x 256 random f32 rows, layer 0's
    weights of seed 0, capacity factor 1.0): each expert keeps the same
    set of tokens, the outputs agree within the f32 tolerance of phase
    6's logits (the same sums in another order), the aux loss within
    1e-6.  The order of an expert's kept tokens may differ where two of
    their gates lie within rounding of each other; it does not enter the
    output, and the number of such experts is logged."""
    from repro_torch.models import init_params, moe
    from repro_torch.models.layers import layer_slice, tree_map
    gen = torch.Generator().manual_seed(81)
    for cfg in cfgs:
        layer = layer_slice(init_params(cfg, seed=0, device="cpu")["layers"],
                            0)["moe"]
        x = torch.randn(4, 256, cfg.d_model, generator=gen) * 0.5
        xf = x.reshape(-1, cfg.d_model)
        cap = moe._capacity(xf.shape[0], cfg, 1.0)
        out = {}
        for dev in ("cuda", "cpu"):
            lw = tree_map(lambda t: t.to(dev), layer)
            _, gates, _ = moe._route(lw["router"], xf.to(dev),
                                     cfg.experts_per_token)
            sel, valid = moe._select(gates, cap)
            y, aux = moe.moe_apply(lw, x.to(dev), cfg)
            out[dev] = (sel.cpu(), valid.cpu(), y.cpu(), float(aux),
                        int((gates > 0).sum()) - int(valid.sum()))
        (sg, vg, yg, ag, dropped), (sc, vc, yc, ac, _) = out["cuda"], \
            out["cpu"]

        def kept(sel, valid):
            return [sorted(row[ok].tolist()) for row, ok in zip(sel, valid)]

        if kept(sg, vg) != kept(sc, vc):
            raise AssertionError(f"{cfg.name}: moe_apply keeps other tokens "
                                 "on the card than on the CPU")
        reordered = int((sg != sc).any(-1).sum())
        err = check_close("moe_apply", yg, yc, LOGITS_TOL,
                          f"{cfg.name}, capacity factor 1.0")
        if abs(ag - ac) > 1e-6:
            raise AssertionError(f"{cfg.name}: aux {ag} on the card, {ac} "
                                 "on the CPU")
        log(f"{cfg.name}: moe_apply at capacity factor 1.0 (4 x 256 tokens, "
            f"cap {cap}, {dropped} token choices dropped) card == CPU: the "
            f"same kept tokens in every expert ({reordered} of "
            f"{cfg.num_experts} lists in another order), max_abs_err "
            f"{err:.3g}")


def drops_measured(torch, cfg, lens, seed, what, kw):
    """The same requests at capacity factor 1.0, where the prefill drops
    tokens, card and CPU, measured: a padding token is the same token at
    each padded position, so the padded positions' gates tie up to
    rounding, and where such ties meet an expert's capacity the card and
    the CPU may keep different ones.  Holds the prefill calls and the
    launches; logs how many streams stay equal and where the others
    part.  Returns the card's launches."""
    prompts = greedy_prompts(seed, cfg.vocab_size, lens)
    opts = kw["opts"].replace(moe_capacity_factor=1.0)
    out = {}
    for dev in ("cuda", "cpu"):
        zero_counts()
        streams, eng, _ = serve_greedy(torch, cfg, prompts, 24, dev,
                                       **{**kw, "opts": opts})
        out[dev] = (streams, eng.stats.prefill_calls)
        if dev == "cuda":
            counts = moe_counts([eng], f"{what}, capacity factor 1.0", kw,
                                cfg)
    (sg, pg), (sc, pc) = out["cuda"], out["cpu"]
    if pg != pc:
        raise AssertionError(f"{what}, capacity factor 1.0: {pg} prefill "
                             f"calls on the card, {pc} on the CPU")
    parts = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(sg, sc)]
    log(f"  {what}, capacity factor 1.0 (drops; measured, not held): "
        f"{parts.count(None)} of {len(parts)} streams equal card and CPU; "
        "first differing step per stream "
        + ", ".join("-" if p is None else str(p) for p in parts))
    return counts


def phase_experts(torch, smi):
    """The MoE family on the card: 8.0 the kernels at its shapes; 8a
    full-width olmoe-1b-7b served paged int8 in bf16; 8b card == CPU on
    three reduced MoE configs in f32.  Returns ``({kernel name:
    launches}, {kernel name: timing fields})``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.layers import cast_params, tree_leaves
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.serving import CompileCache, ServingEngine
    t_phase = time.perf_counter()
    extra = experts_kernels_alone(torch)
    totals = {}

    # --- 8a: full-width olmoe-1b-7b, bf16, paged int8 ------------------
    cfg = get_config("olmoe-1b-7b")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # drawn in f32 (the config's param dtype), cast once on the card to
    # the bf16 the engines serve (the router stays f32), so that every
    # engine below shares one 13.6 GB copy
    params = cast_params(init_params(cfg, seed=0, device="cuda"),
                         torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"olmoe-1b-7b: {n_params / 1e9:.3f} B parameters drawn from seed 0 "
        f"on the host, moved to the card and cast to bf16 in {init_s:.1f} "
        "s")
    opts = RuntimeOptions(paged_kernel=True, kv_dtype="int8")
    cache = CompileCache()

    def engine():
        return ServingEngine(cfg, params, slots=8, max_seq=1024,
                             block_size=16, opts=opts, decode_mode="paged",
                             compile_cache=cache, device="cuda")

    eng = engine()
    zero_counts()
    waves = []
    for wave in range(2):
        tps, ms, reqs = serve_wave(
            torch, eng, _tight_prompts(30 + wave, cfg.vocab_size, lo=8,
                                       hi=250), 9000 + 100 * wave, 64)
        if wave == 0:
            warm = eng.stats.recompiles
        waves.append((tps, ms, reqs))
    counts = check_counts([eng], "olmoe-1b-7b paged int8, two waves")
    if "fused_ffn" in counts:
        raise AssertionError("olmoe has no dense FFN, yet K3 launched")
    if eng.stats.recompiles != warm:
        raise AssertionError(f"the second olmoe wave built "
                             f"{eng.stats.recompiles - warm} new programs")
    if captures(eng) != 1:
        raise AssertionError("the olmoe paged step was not captured once")
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n
    for wave, (tps, ms, reqs) in enumerate(waves):
        log(f"olmoe-1b-7b paged int8 on {smi}, wave {wave + 1}: {tps:.1f} "
            f"tok/s, {ms:.3f} ms/decode step; TTFT by bucket " + "; ".join(
                f"{b}: mean {mean:.1f} ms, max {mx:.1f} ms over {n}"
                for b, (mean, mx, n) in ttft_by_bucket(eng, reqs).items()))
    log(f"  decode steps {eng.stats.decode_calls}, prefill calls "
        f"{eng.stats.prefill_calls}, programs built {warm}, graph captures "
        f"{captures(eng)}")
    busy_eng = engine()
    step = moe_repeats(torch, busy_eng, params, cfg)
    weights, kv = step_bytes(params, busy_eng)
    graph_ms, eager_ms, g_busy, e_busy = graph_vs_eager(
        torch, engine(), "olmoe-1b-7b paged int8 step", smi)
    busy, experts, k1 = expert_split(torch, step, cfg)
    bound_ms = 1e3 * (weights + kv) / H100_BYTES_PER_S
    log(f"olmoe-1b-7b decode step on {smi}: eager device {busy:.3f} ms = "
        f"expert products {experts:.3f} + K1 {k1:.4f} + the rest "
        f"{busy - experts - k1:.3f}; graph-replayed {graph_ms:.3f} ms host "
        f"(device {g_busy:.3f} ms, idle share {1 - g_busy / graph_ms:.3f}); "
        f"byte bound {bound_ms:.3f} ms ({weights / 1e9:.2f} GB of weights, "
        f"{kv / 1e6:.1f} MB of KV at 8 busy slots, at "
        f"{H100_BYTES_PER_S / 1e12:.2f} TB/s): graph step at "
        f"{bound_ms / graph_ms:.3f} of the bound")
    del params, eng, busy_eng, step
    torch.cuda.empty_cache()

    # --- 8b: card == CPU, f32, three reduced MoE configs ----------------
    f32 = dict(activation_dtype="float32")
    runs = [
        (get_config("olmoe-1b-7b").reduced(max_experts=16).with_updates(**f32),
         "reduced olmoe-1b-7b (16 experts top-8) paged int8",
         dict(max_seq=512, block_size=16, decode_mode="paged",
              opts=RuntimeOptions(paged_kernel=True, kv_dtype="int8"))),
        (get_config("llama4-scout-17b-a16e").reduced().with_updates(**f32),
         "reduced llama4-scout (top-1, shared expert) paged, f32 pool",
         dict(max_seq=512, block_size=16, decode_mode="paged",
              opts=RuntimeOptions(paged_kernel=True,
                                  kv_cache_dtype="float32"))),
        (get_config("mixtral-8x7b").reduced(d_model=2048).with_updates(**f32),
         "reduced mixtral-8x7b (d 2048, top-2 of 4, GQA 16/8) batched",
         dict(max_seq=512, decode_mode="batched",
              opts=RuntimeOptions(kv_cache_dtype="float32")))]
    moe_drops_card_vs_cpu(torch, [rcfg for rcfg, _, _ in runs])
    lens = (8, 37, 120, 200, 60, 250)
    for seed, (rcfg, what, kw) in enumerate(runs, start=40):
        no_drop = float(rcfg.num_experts / rcfg.experts_per_token)
        # exact at a capacity that drops nothing; llama4's top-1 gates are
        # all exactly 1.0, so its drops at factor 1.0 are exact too
        factors = [no_drop] + ([1.0] if rcfg.experts_per_token == 1 else [])
        for cf in factors:
            keep = []
            zero_counts()
            label = f"{what}, capacity factor {cf:g}"
            got, _ = card_vs_cpu(
                torch, rcfg, lens, 24, seed, label, keep=keep,
                **{**kw, "opts": kw["opts"].replace(moe_capacity_factor=cf)})
            streams = streams if cf != no_drop else got
            for k, n in moe_counts(keep, label, kw, rcfg).items():
                totals[k] = totals.get(k, 0) + n
        # no drops in the margin prefill: its logits are then the decode
        # steps' (dense dispatch drops nothing)
        margins = stream_margins(
            torch, init_params(rcfg, seed=0, device="cpu"), rcfg,
            greedy_prompts(seed, rcfg.vocab_size, lens), streams,
            RuntimeOptions(moe_capacity_factor=no_drop))
        log(f"  {what}: CPU top-2 logit margins along the streams: min "
            f"{min(margins):.4g}, per stream "
            + ", ".join(f"{m:.3g}" for m in margins))
        if rcfg.experts_per_token > 1:
            for k, n in drops_measured(torch, rcfg, lens, seed, what,
                                       kw).items():
                totals[k] = totals.get(k, 0) + n
    log(f"experts phase: {time.perf_counter() - t_phase:.1f} s")
    return totals, extra


def main() -> int:
    import torch
    smi, idle_w = phase_device(torch)
    name = torch.cuda.get_device_name(0)
    kernels = [phase_paged(torch), phase_flash(torch), phase_ffn(torch),
               phase_ssd(torch)] + phase_act_quant(torch)
    launches = phase_serving(torch, smi)
    for k, n in phase_modes(torch, smi).items():
        launches[k] = launches.get(k, 0) + n
    launches.update(phase_batched(torch, smi))
    launches.update(phase_engine(torch, smi))
    phase_card_vs_cpu(torch)
    for k, n in phase_adapt(torch, smi, idle_w).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in phase_crowd(torch, smi).items():
        launches[k] = launches.get(k, 0) + n
    counts, extra = phase_experts(torch, smi)
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k.update(extra.get(k["name"], {}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
