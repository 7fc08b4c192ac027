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
   128-column split boundary, windows crossing one, full tables, mb 1)
   and at the dense families' shapes (hd 96, hd 256 at groups 1 and 2
   with and without a window of 1024, group 7), each repeating bit for
   bit, K2 flash attention (bf16 on the tensor cores, f32 on the CUDA
   cores) over its masks, dtypes, head dims 16..256 (96 among them, also
   at a ragged S of 1000), head groupings and lengths up to 2048, K3
   fused gated FFN
   (bf16 small_m for a few rows at D <= 576 — one launch of clusters
   whose F split is summed through distributed shared memory —, stream
   for M <= 24 above,
   two_pass for the rest; f32) over both activations, dtypes, ragged and
   large M, ragged F and widths up to 7168 (stream at MP 8, 16 and 24, a
   D that is no multiple of 64; two_pass at M 25..300 over D 1544 and
   2048 with ragged F, with a last wave cut into K parts, and at M 4096,
   D 6144), each repeating bit for bit, then K3 at every served decode
   shape (M 8: the dense families', internvl2-26b's and zamba2-1.2b's
   FFNs) held to its plain version, repeating, and timed beside the
   unfused cuBLAS chain and its byte bound (the prefill shapes are timed
   in 9.0, 11.0, 12.0 and 13.0), K6 SSD scan over ragged and multi-chunk lengths, groups,
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
   time, idle share; the tokens must be equal), and paper-backbone's
   graph step's host ms and device split into K3, K1 and the rest.  Then
   the engine's other
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
   and for the early-exit depths (exits at layers 2, 4, 6).  P6: the
   reference calibration test's ladder of 4 variants (full, width 0.75,
   width 0.5 at depth 0.75 and at 0.5; tokens 2 x 256) is ranked by its
   ``H100_SXM`` estimates against each forward's device time (the
   profiler's kernel sum, taken only from profiles that recorded every
   flash attention launch), beside the reference's bar of 0.79.
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
   (6.8 B parameters, 64 experts top-8; bf16 weights drawn on the card
   from seed 0, the init timed) served paged int8 (8 slots, max_seq
   1024, block 16) in two waves of 16 requests of 8-250 tokens x 64 new
   tokens: budgets, K1 16
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
9. hybrid — the zamba2 family (a Mamba2 stack with ONE shared attention
   block after every full period of Mamba blocks).  9.0: K6 at
   zamba2-1.2b's prefill (bf16, 8 x 1024 and a ragged 8 x 1000, 64 heads,
   P 64, N 64, chunk 256, x/b/c as views of a 4224-wide conv row), K2 at
   its shared block's prefill (bf16, causal, 8 x 1024, 32 heads of 64)
   and K3 at its FFN (gelu, D 2048, F 8192, bf16, M 8 on the route the
   plan picks, and M 8 x 1024), each against its plain version and
   repeating bit for bit, timed beside its bound, its plain version and
   SDPA (K2) or the unfused cuBLAS chain (K3).  9a, bf16: full-width
   zamba2-1.2b (1.1 B parameters, nothing cut; weights from seed 0, the
   init timed) served batched (8 slots, max_seq 2048) in two waves of 16
   requests of 8-1000 tokens x 64 new tokens: budgets, K6 38 per prefill
   call, K2 6 per prefill call and K3 6 per prefill call and decode step
   exactly (replays included), no K1/K4/K5, no new program on the second
   wave, TTFT per bucket; a whole decode step repeats bit for bit on two
   clones of one state; the graph-replayed step beside the eager step on
   clones (tokens equal, host clock, device time, idle share), the eager
   step's device time split into K3, K2, the Mamba blocks' products and
   the rest, beside the step's byte bound.  9b, f32 activations and
   caches: the reduced hybrid at 5 layers and period 2 (2 sites and a
   leftover layer) card == CPU greedy streams and counters in
   ``batched``, ``per_slot`` and ``batched`` with ``swap_model`` after 4
   steps to the same and to other weights, with exact launches, and the
   full-depth, full-width zamba2-1.2b in f32 on a short wave (3 requests
   of 8-100 tokens x 8 new tokens: K6, K2 and K3 on their f32 routes at
   its widths); then the reduced hybrid's requests with the bf16 conv
   and shared K/V caches the JAX package keeps, measured and not held
   (ROADMAP P4): the first step where card and CPU part, per stream,
   with the CPU's top-2 margin.
10. encoder-decoder — whisper-small.  10.0: K2 at its encoder (8 x 1500
   frames, non-causal) and cross-attention (queries over the 1500 keys)
   and K1 at its paged decode, each against its plain version and
   repeating bit for bit, timed beside SDPA.  10a: the transcription
   path at full width (prefill of 8 x 16 tokens with 8 x 1500 stub
   frames, 64 greedy decode steps; K2 36 a prefill call), the decode
   step's device split and byte bound.  10b: served paged int8 by the
   engine (no frames, as the JAX engine serves it), freeze/thaw, a
   repeat bit for bit, graph == eager.  10c: card == CPU in f32 on
   reduced whisper, full-width whisper-small and reduced internvl2.
11. trainer — the port's drivers (``repro_torch.launch``, ``data``,
   ``checkpoint``, ``baselines``).  11.0: K6 under autograd (its launch
   in a ``torch.autograd.Function`` whose backward is the plain scan's
   gradient) against autograd through the plain scan at the trainer's
   shape (4 x 1024, H 64, P 64, N 64, x/b/c views of a 4224-wide row)
   and mamba2-370m's (H 32, P 64, N 128), f32 and bf16; K6, K2 and K3
   forward and their backwards timed at the trainer's bf16 shapes.  11a:
   full-width zamba2-1.2b (1.105 B parameters, nothing cut) trained by
   ``train_loop`` for 6 steps of 4 x 1024 tokens (bf16 activations, f32
   weights and AdamW): finite losses, positive grad norms, K6 38, K2 6
   and K3 6 a step exactly, a non-zero gradient on every floating leaf
   (each Mamba layer's ``a_log`` and ``dt_bias`` reach the loss only
   through K6's backward), the checkpoint restored bit for bit; the
   step's host time, its device split (forward kernels and the rest,
   backward, optimizer), peak memory, checkpoint bytes and times.  11b:
   full-width paper-backbone trained with ``train.py``'s defaults (100
   steps, batch 8, seq 256; the loss falls), checkpointed, restored into
   a fresh tree, served through ``serve.py``'s loop (16 requests, 4
   slots, the middleware swapping variants every 8 steps; 12 tokens a
   request, K2/K3 held to each binding's prefill calls and steps), and a
   greedy wave from the restored weights equal to the trained weights'.
   11c: card == CPU in f32 over two ``make_train_step`` calls (loss,
   grad norm, every gradient leaf, the parameters) on the reduced hybrid
   and the reduced mamba2-370m.  11d: the baselines' chosen variants
   (``HANDCRAFTED``, ``adadeep_select``, ``ofa_select``) through
   ``Middleware.infer`` with exact K2/K3, card == CPU in f32.  11e: the
   one-card planner over every arch x shape, without JAX.
12. VLM — internvl2-26b at full width (19.3 B parameters, nothing cut).
   12.0: K1 at its paged decode (48 heads of 128 over 8: group 6; int8
   pool, mb 64), K2 at its prefill (8 x 512, 48/8 heads of 128, causal)
   and K3 at its FFN (silu, D 6144, F 16384: M 8 on stream, M 2048 and
   4096 on two_pass), each against its plain version and repeating bit
   for bit, timed beside its bound, plain version and SDPA or the
   unfused cuBLAS chain.  The weights are drawn in bf16 straight on the
   card (``param_tree`` with a CUDA generator seeded 0).  12a: the VLM
   path at model level (``prefill`` of 8 x 512 positions whose first 256
   are stub patch embeddings of width 3200, all positions' logits, then
   64 greedy decode steps): K2 and K3 48 a prefill call, K3 48 a step,
   the run repeating bit for bit; the prefill's device ms, the decode
   step's device split (K3, attention, weight products, the rest) beside
   its byte bound.  12b: served paged int8 by the engine (text only, as
   the JAX engine serves it; 8 slots, max_seq 1024, two waves of 12
   requests of 8-500 tokens x 64 new tokens): budgets, K1/K2/K3 48 a
   step or call, no new program on wave 2, one capture, a step repeating
   bit for bit, graph == eager on clones.  12c: card == CPU in f32 at
   every published width, depth 2 (1.37 B parameters drawn once on the
   host): prefill with patch embeddings and 16 greedy decode steps.
13. dense families — gemma3-12b, phi3-mini, gemma-7b, yi-34b and
   qwen1.5-32b at full width, nothing cut.  13.0: K1 at each one's paged
   decode (int8 pool; hd 256 at groups 2 and 1, gemma3's local layers
   under its window of 1024; hd 96 at group 1; hd 128 at group 7 and 1),
   K2 at its prefill burst (hd 256 windowed and causal at 8 x 2048, hd
   96, hd 128 at group 7 and MHA 40) and K3 at its FFN (five (D, F) pairs
   at M 8 on stream and at the prefill burst on two_pass), each against
   its plain version and repeating bit for bit, timed beside its bound,
   its plain version and SDPA or the unfused cuBLAS chain.  13a..13e:
   each config's bf16 weights drawn on the card (its parameter count
   asserted) and served paged int8 (8 slots; max_seq 2048 for gemma3-12b
   with prompts of 8..1800 tokens, 1024 for phi3-mini, gemma-7b and
   yi-34b with prompts of 8..500, and for qwen1.5-32b the largest that
   the card's free memory holds beside its 68.8 GB of weights, prompts
   of 8..120), two waves of 12 requests x 32 new tokens: budgets,
   K1/K2/K3 ``num_layers`` a step or call,
   no new program on wave 2, one capture, a step repeating bit for bit,
   graph == eager on clones; the eager step's device split (K3, K1,
   weight products, the rest) beside its byte bound, the graph step's
   host and device ms and idle share, TTFT by bucket and tok/s, peak
   memory.  13f: card == CPU in f32 at every published width, gemma3-12b
   at depth 6 (its first global layer, layer 5, in) and the others at
   depth 2: prefill of 2 prompts of 64 tokens and 8 greedy decode steps.

14. remat — the trainer's memory behaviour: the recomputation ladder
   ``RuntimeOptions.remat`` (none / dots / full: each pattern period a
   checkpoint region, ``dots`` keeping the projections' and K3's
   outputs) and the donated AdamW update.  14a: full-width zamba2-1.2b
   (f32 weights drawn on the card, bf16 activations) at 4 x 1024 tokens,
   one train step's gradients under each rung, equal bit for bit, with
   exact launches (K6 / K2 / K3: 38 / 6 / 6, dots 74 / 12 / 6, full
   74 / 12 / 12), each rung's peak and activation part (the peak less
   what was resident before the forward, ordered none > dots > full)
   beside ``engine.remat.activation_bytes`` times the ladder's keep; then
   one donated ``make_train_step`` call a rung (exact launches, equal loss
   and gradient norm).  14b: full-width phi3-mini (3.723 B parameters,
   nothing cut) with f32 weights drawn on the card: one step's gradients
   at 1 x 256 and 1 x 512 tokens under each rung (equal bit for bit at
   512, K2 / K3 32 / 32, 64 / 32, 64 / 64), each rung's reckoned need at
   4 x 1024; then ``train_loop`` for 6 donated steps at 4 x 1024 under
   ``full`` (finite losses, positive gradient norms, 64 K2 and 64 K3 a
   step), host ms a step, a further step's device split by CUDA events,
   and the peak beside ``dryrun.memory_bytes``.  14c: 11c's reduced
   configs in f32, gradients under ``full`` on the card == ``none`` on
   the CPU.  Phase 11 runs ``remat="none"`` throughout.

Before the last two lines, ``{"phase_seconds": {...}}`` gives each
phase's seconds.  ``python3 chip_smoke.py --stamp`` also begins each
log line with the seconds since the start, to find where a phase's
time goes (the card's name line is then stamped too).  The line before
the last is a JSON object listing every kernel with its launches on its
main path and its times (K4 and K5 as their four entry points:
act_quant, act_dequant, act_quant4, act_dequant4); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
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


STAMP_T0 = None                # the start, under --stamp


def log(msg: str) -> None:
    if STAMP_T0 is not None:
        msg = f"[{time.perf_counter() - STAMP_T0:7.1f} s] {msg}"
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
              q_dtype, pos_kind, layers=2, layer=1, card_gen=None):
    """One paged-decode problem on the card.  The pool interleaves
    ``layers`` layers like the serving pool does, and the kernel reads
    layer ``layer`` in place through its block stride.  With
    ``card_gen`` (a CUDA generator) the pool is drawn and quantized on
    the card, which is quicker at the large pools."""
    from repro_torch.kernels.act_quant import kv_quant_rows
    nb = slots * mb + 1
    shape = (nb, layers, bs, kvh, hd)
    if card_gen is None:
        k = torch.randn(shape, generator=gen)
        v = torch.randn(shape, generator=gen)
    else:
        k = torch.randn(shape, generator=card_gen, device="cuda")
        v = torch.randn(shape, generator=card_gen, device="cuda")
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


def device_ms(torch, fn, iters=50, part="", tries=6):
    """Device time of one call of ``fn`` in ms: the profiler's device time
    of the kernels whose name holds ``part`` (all of them by default) over
    ``iters`` calls in a profiler window of its own, divided by
    ``iters``.  Unlike a CUDA-event loop it leaves out the host's time to
    issue each call.  A window may lose kernel events at random (on the
    H100, from one event to all of them; PERF.md §6), and a window
    that lost some can only read low.  So a window counts only when each
    kernel's count is a whole multiple of ``iters``, at least three
    windows are taken while any counts (up to ``tries``), and the largest
    time is kept; with no window that counts the time is ``None`` (not
    measured), never 0."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = None
    for i in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and part in e.key and e.count]
        if hits and all(e.count % iters == 0 for e in hits):
            ms = sum(e.self_device_time_total for e in hits) / 1e3 / iters
            best = ms if best is None else max(best, ms)
        if best is not None and i >= 2:
            break
    return best


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def paged_bound_ms(args, scales, window=0):
    """Least time for one call on the H100: each input byte the call needs
    read once (only the pool rows that hold a valid column, inside the
    window when one is set), the output written once; the f32 work of
    the two products over those rows.  Returns ``(ms, "bytes" or
    "operations")``."""
    q, kb, vb, tables, pos, kn, vn = args
    slots, heads, hd = q.shape
    _, bs, kvh, _ = kb.shape
    rows = [min(int(p), tables.shape[1] * bs)
            - (max(0, int(p) - window + 1) if window else 0)
            for p in pos.cpu()]
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


def sdpa_yardstick(torch, args, scales, window=0):
    """One library call computing the same attention: SDPA over the
    slot's KV gathered dense beforehand (dequantized, new token appended,
    invalid columns, and those before a window, masked).  Only the SDPA
    call is timed, by CUDA events
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
    valid = cols[None] < pos[:, None]
    if window:
        valid &= cols[None] > pos[:, None] - window
    valid |= cols[None] == mb * bs
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
    from repro_torch.kernels.paged_decode_attn import decode_plan
    from repro_torch.kernels.ref import paged_decode_attn_ref
    gen = torch.Generator().manual_seed(1234)
    max_err = 0.0
    n_cases = 0
    routes = {}
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
                            routes[f"{q_dtype} q, {pool_dtype} pool"] = \
                                decode_plan(8, heads, kvh, 32, 16, mb,
                                            args[1].dtype, args[0].dtype
                                            ).route
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
    # the dense families' decode shapes at mb 128: hd 96 (phi3-mini), hd
    # 256 at group 1 (gemma-7b) and 2 (gemma3-12b) with and without its
    # window of 1024, group 7 (yi-34b); positions whose window starts on
    # and beside a split boundary
    card_gen = torch.Generator(device="cuda").manual_seed(1235)
    for heads, kvh, hd, windows, pools in DENSE_K1_SHAPES:
        for pool_dtype in pools:
            args, sc = make_case(
                torch, gen, slots=8, hd=hd, bs=16, mb=128, heads=heads,
                kvh=kvh, pool_dtype=pool_dtype, q_dtype="bfloat16",
                pos_kind="zero", card_gen=card_gen)
            args[4].copy_(torch.tensor(DENSE_POS, dtype=torch.int32))
            for window in windows:
                out = k1_repeated(torch, args, sc, window)
                ref = paged_decode_attn_ref(*args, window=window, **sc)
                torch.cuda.synchronize()
                max_err = max(max_err, check_close(
                    "paged_decode_attention", out, ref, TOL["bfloat16"],
                    f"dense family H={heads} kvh={kvh} hd={hd} "
                    f"window={window} pool={pool_dtype}"))
                n_cases += 1
            del args, sc, out, ref
    log(f"paged_decode_attention == plain version on {n_cases} cases "
        f"(mb 1, 32 and 128, split edges, hd 32/64/96/128/256, groups 1, "
        f"2, 4, 6 and 7), each repeating bit for bit; max_abs_err "
        f"{max_err:.3g}; routes {routes}")
    served = k1_served_times(torch, gen, card_gen)
    pb, full = served["paper-backbone"], served["paper-backbone full 2048"]
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
            "replaces": "src/repro/kernels/paged_decode_attn.py:175",
            "launches": None, "max_abs_err": max_err, "ms": pb["ms"],
            "plain_ms": pb["plain_ms"], "bound_ms": pb["bound_ms"],
            "bound_by": pb["bound_by"], "library_ms": pb["library_ms"],
            "device_ms": pb["device_ms"], "ms_2048": full["ms"],
            "device_ms_2048": full["device_ms"],
            "plain_ms_2048": full["plain_ms"],
            "library_ms_2048": full["library_ms"],
            "bound_ms_2048": full["bound_ms"],
            "routes": routes, "served": served,
            "shape": "8 slots x 8 kv heads x hd 32, int8 pool, mb 32, "
                     "positions 16..288; *_2048: mb 128, pos 2048; "
                     "served: K1_SERVED"}


# K1 at the served decode shapes, 8 slots, an int8 pool, bf16 q: (label,
# heads, kv heads, hd, mb, lowest position, highest, window), as
# tools/k1_ab.py times them
K1_SERVED = (("paper-backbone", 8, 8, 32, 32, 16, 288, 0),
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


def k1_served_times(torch, gen, card_gen):
    """K1 at ``K1_SERVED``: each shape held to its plain version
    (repeating bit for bit), then ``k1_times`` (CUDA events, device time,
    the plain version, SDPA, the bound) and the route and splits of its
    plan.  Returns ``{label: fields}``."""
    from repro_torch.kernels.paged_decode_attn import decode_plan
    from repro_torch.kernels.ref import paged_decode_attn_ref
    table = {}
    for label, h, kvh, hd, mb, lo, hi, window in K1_SERVED:
        args, sc = make_case(torch, gen, slots=8, heads=h, kvh=kvh, hd=hd,
                             bs=16, mb=mb, pool_dtype="int8",
                             q_dtype="bfloat16", pos_kind="zero",
                             card_gen=card_gen)
        args[4].copy_(torch.randint(lo, hi + 1, (8,), generator=gen,
                                    dtype=torch.int32))
        err = check_close("paged_decode_attention",
                          k1_repeated(torch, args, sc, window),
                          paged_decode_attn_ref(*args, window=window, **sc),
                          TOL["bfloat16"], f"served {label}")
        plan = decode_plan(8, h, kvh, hd, 16, mb, torch.int8,
                           torch.bfloat16)
        t = dict(k1_times(torch, args, sc, window), max_abs_err=err,
                 route=plan.route, splits=plan.splits)
        table[label] = t
        log(f"paged_decode_attention served {label} ({h}/{kvh} heads of "
            f"{hd}, mb {mb}, positions {lo}..{hi}"
            + (f", window {window}" if window else "") + f"): route "
            f"{plan.route} x {plan.splits} splits, device "
            f"{fmt(t['device_ms'])}, events {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.5f} ({t['bound_by']}), SDPA device "
            f"{fmt(t['library_device_ms'])}, plain {t['plain_ms']:.4f} ms")
        del args, sc
    return table


# (mb, positions of the 8 slots, window): K1's split edges
K1_EDGES = [
    (128, [128, 256, 127, 129, 384, 1, 2047, 2048], 0),
    (128, [140, 130, 260, 2048, 300, 129, 1000, 16], 20),
    (128, [2048] * 8, 0),
    (128, [2048] * 8, 300),
    (1, [0, 1, 2, 5, 8, 15, 16, 16], 0),
    (1, [0, 1, 2, 5, 8, 15, 16, 16], 4),
]


# (heads, kv heads, hd, windows, pools): the dense families' decode
# shapes held in phase 2
DENSE_K1_SHAPES = [
    (32, 32, 96, (0,), ("int8", "bfloat16")),       # phi3-mini
    (16, 16, 256, (0, 1024), ("int8",)),            # gemma-7b
    (16, 8, 256, (0, 1024), ("int8",)),             # gemma3-12b
    (56, 8, 128, (0,), ("int8", "bfloat16")),       # yi-34b: group 7
    (48, 8, 128, (0,), ("int8",)),                  # internvl2-26b: 6
    (16, 16, 128, (0,), ("int8",)),                 # olmoe-1b-7b
    (12, 12, 64, (0,), ("int8",)),                  # whisper-small
    (40, 40, 128, (0,), ("int8",)),                 # qwen1.5-32b
]
# 8 decode positions at mb 128: under a window of 1024 the window's first
# column falls on split boundary 128 (pos 1151), one before (1150) and
# after (1152) it, and on 256 (1279); 129 crosses a boundary uncut
DENSE_POS = [1, 129, 1023, 1150, 1151, 1152, 1279, 2048]


def k1_repeated(torch, args, sc, window):
    """K1 twice on the same inputs: the two outputs must be bit for bit
    equal (the splits merge in a fixed order, no atomics on values)."""
    from repro_torch.kernels.paged_decode_attn import paged_decode_attention
    out = paged_decode_attention(*args, window=window, **sc)
    again = paged_decode_attention(*args, window=window, **sc)
    if not torch.equal(out, again):
        raise AssertionError("paged_decode_attention does not repeat")
    return out


def flash_case(torch, gen, b, h, kvh, s, hd, dtype, sk=None):
    """q (B,S,H,hd), k/v (B,S_k,K,hd) on the card as the model holds them
    after rotary, passed as (B,H,S,hd) / (B,K,S_k,hd) views; S_k = S
    unless ``sk`` is given (a decoder's cross-attention)."""
    dt = getattr(torch, dtype)
    sk = s if sk is None else sk
    q = torch.randn(b, s, h, hd, generator=gen).to(dt).cuda()
    k = torch.randn(b, sk, kvh, hd, generator=gen).to(dt).cuda()
    v = torch.randn(b, sk, kvh, hd, generator=gen).to(dt).cuda()
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def flash_plain(q, k, v, **mask):
    from repro_torch.kernels.ref import flash_attn_ref
    g = q.shape[1] // k.shape[1]
    return flash_attn_ref(q, k.repeat_interleave(g, 1),
                          v.repeat_interleave(g, 1), **mask)


def flash_pairs(s, causal, window, kv_len, sk=None):
    """Valid (row, col) pairs of one head: the work the data needs."""
    import numpy as np
    sk = s if sk is None else sk
    rows = np.arange(s)[:, None]
    cols = np.arange(sk)[None, :]
    valid = np.broadcast_to(cols < (sk if kv_len is None else kv_len),
                            (s, sk)).copy()
    if causal:
        valid &= cols <= rows
    if window:
        valid &= cols > rows - window
    return int(valid.sum())


def flash_checked(torch, q, k, v, mask, what):
    """One K2 call held to its plain version within ``TOL``: exactly one
    launch on the route its plan names, 0 where ``kv_len`` is 0, and a
    repeat equal bit for bit.  Returns ``(max_abs_err, route)``."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_plan
    plan = flash_plan(q.dtype, q.shape[3], q.shape[2], k.shape[2],
                      q.shape[1], k.shape[1])
    what = f"{what} ({plan.route})"
    before = flash_attention.launches
    out = flash_attention(q, k, v, **mask)
    if flash_attention.launches != before + 1:
        raise AssertionError(f"flash_attention launched "
                             f"{flash_attention.launches - before} times: "
                             f"{what}")
    ref = flash_plain(q, k, v, **mask)
    torch.cuda.synchronize()
    err = check_close("flash_attention", out, ref,
                      TOL[str(q.dtype).split(".")[-1]], what)
    if mask.get("kv_len") == 0 and not bool((out == 0).all()):
        raise AssertionError("kv_len 0 must give 0: " + what)
    if not torch.equal(out, flash_attention(q, k, v, **mask)):
        raise AssertionError("flash_attention does not repeat: " + what)
    return err, plan.route


def max_sm_clock_hz():
    """The card's top SM clock as ``nvidia-smi`` reports it, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


FLASH_HDS = (16, 32, 64, 96, 128, 256)
# K2 at the served prefill shapes of hd >= 64: (label, B, S, S_k, H, K,
# hd, mask), the configs' prompt buckets as phases 8.0-13.0 run them
K2_SERVED = (
    ("gemma3-12b", 8, 2048, 2048, 16, 8, 256, dict(causal=True)),
    ("gemma3-12b window", 8, 2048, 2048, 16, 8, 256,
     dict(causal=True, window=1024)),
    ("olmoe-1b-7b", 8, 1024, 1024, 16, 16, 128, dict(causal=True)),
    ("internvl2-26b", 8, 512, 512, 48, 8, 128, dict(causal=True)),
    ("yi-34b", 8, 512, 512, 56, 8, 128, dict(causal=True)),
    ("qwen1.5-32b", 8, 128, 128, 40, 40, 128, dict(causal=True)),
    ("phi3-mini", 8, 512, 512, 32, 32, 96, dict(causal=True)),
    ("gemma-7b", 8, 512, 512, 16, 16, 256, dict(causal=True)),
    ("zamba2-1.2b", 8, 1024, 1024, 32, 32, 64, dict(causal=True)),
    ("whisper-small encoder", 8, 1500, 1500, 12, 12, 64,
     dict(causal=False)),
    ("whisper-small cross 448", 8, 448, 1500, 12, 12, 64,
     dict(causal=False)),
    ("whisper-small cross 16", 8, 16, 1500, 12, 12, 64,
     dict(causal=False)),
)


def flash_served_times(torch, gen):
    """K2 at ``K2_SERVED``: each shape held to its plain version (route,
    one launch, a repeat bit for bit), then timed by CUDA events and by
    the profiler's device time beside SDPA (``enable_gqa`` where the
    installed torch has it, else K/V repeated to H before the timed
    region; the window's rows by a boolean mask) and the bound
    (operations of the valid pairs, bytes of q, k, v and out once).
    Returns ``{label: fields}``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    table = {}
    for label, b, s, sk, h, kvh, hd, mask in K2_SERVED:
        q, k, v = flash_case(torch, gen, b, h, kvh, s, hd, "bfloat16", sk)
        err, route = flash_checked(torch, q, k, v, mask, label)
        sdpa_kw = {}
        if mask.get("window"):
            rows = torch.arange(s, device=q.device)
            sdpa_kw["attn_mask"] = (rows[None] <= rows[:, None]) \
                & (rows[None] > rows[:, None] - mask["window"])
        else:
            sdpa_kw["is_causal"] = mask["causal"]
        if h == kvh:
            kd, vd, how = k, v, "MHA"
        elif gqa:
            kd, vd, how = k, v, "enable_gqa"
            sdpa_kw["enable_gqa"] = True
        else:
            kd, vd = (t.repeat_interleave(h // kvh, 1) for t in (k, v))
            how = "K/V repeated"

        def run():
            return fa.flash_attention(q, k, v, **mask)

        def sdpa():
            return F.scaled_dot_product_attention(q, kd, vd, **sdpa_kw)

        pairs = flash_pairs(s, mask["causal"], mask.get("window", 0), None,
                            sk) * b * h
        t = dict(route=route, max_abs_err=err,
                 ms=cuda_ms(torch, run, iters=50),
                 device_ms=device_ms(torch, run, part="flash_attn"))
        t["library_ms"] = cuda_ms(torch, sdpa, iters=50)
        t["library_device_ms"] = device_ms(torch, sdpa)
        t["bound_ms"], t["bound_by"] = bound(
            (2 * q.numel() + 2 * k.numel()) * 2, 4 * hd * pairs,
            H100_BF16_FLOPS)
        sizes = f"{b} x {s}" + (f" over {sk} keys" if sk != s else "")
        log(f"K2 {label} ({sizes}, {h}/{kvh} heads of {hd}, {mask}): "
            f"{route} {t['ms']:.4f} ms, device {fmt(t['device_ms'])}"
            f"; SDPA ({how}) {t['library_ms']:.4f} ms, device "
            f"{fmt(t['library_device_ms'])}; bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}); max_abs_err {err:.3g}")
        table[label] = t
        del q, k, v, kd, vd
    return table


def phase_flash(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import (attention_route,
                                                flash_attention)
    gen = torch.Generator().manual_seed(4321)
    max_err = 0.0
    n_cases = 0
    routes = {}
    # hd 96 (phi3-mini) also at a ragged S of 1000
    for s, hds in ((16, FLASH_HDS), (1024, FLASH_HDS), (2048, FLASH_HDS),
                   (1000, (96,))):
        b = 2 if s == 16 else 1
        masks = [dict(causal=True), dict(causal=True, window=1),
                 dict(causal=True, window=64),
                 dict(causal=True, window=s + 7),
                 dict(causal=True, kv_len=0),
                 dict(causal=True, kv_len=s * 2 // 3 + 5),
                 # a window past kv_len: a tile's second 64 rows see
                 # no key tile that its first 64 see
                 dict(causal=True, window=64, kv_len=100),
                 dict(causal=True, window=300, kv_len=500),
                 dict(causal=False)]
        for mask in masks:
            for dtype in ("bfloat16", "float32"):
                for hd in hds:
                    for h, kvh in ((8, 8), (8, 2)):
                        q, k, v = flash_case(torch, gen, b, h, kvh, s, hd,
                                             dtype)
                        what = (f"S={s} hd={hd} H={h} kvh={kvh} {dtype} "
                                f"({attention_route(q.dtype)}) {mask}")
                        err, route = flash_checked(torch, q, k, v, mask,
                                                   what)
                        # the route each dtype and hd ran on: one each
                        if routes.setdefault(f"{dtype} hd {hd}",
                                             route) != route:
                            raise AssertionError(f"two routes at {what}")
                        max_err = max(max_err, err)
                        n_cases += 1
    # the wgmma route at groups 6 and 7 (internvl2-26b, yi-34b) over a
    # ragged S, and at cross-attention lengths: 16 and 448 queries over
    # 1500 keys (whisper-small), with and without kv_len
    for hd in (64, 96, 128, 256):
        for h, kvh in ((48, 8), (56, 8)):
            q, k, v = flash_case(torch, gen, 1, h, kvh, 1000, hd,
                                 "bfloat16")
            for mask in (dict(causal=True), dict(causal=True, window=300),
                         dict(causal=True, kv_len=601),
                         dict(causal=True, window=300, kv_len=500),
                         dict(causal=False, kv_len=0)):
                err, _ = flash_checked(torch, q, k, v, mask,
                                       f"S=1000 hd={hd} H={h} kvh={kvh} "
                                       f"{mask}")
                max_err = max(max_err, err)
                n_cases += 1
        for sq in (16, 448):
            q, k, v = flash_case(torch, gen, 2, 8, 2, sq, hd, "bfloat16",
                                 1500)
            for mask in (dict(causal=False), dict(causal=False, kv_len=999),
                         dict(causal=False, kv_len=0)):
                err, _ = flash_checked(torch, q, k, v, mask,
                                       f"{sq} queries over 1500 keys "
                                       f"hd={hd} {mask}")
                max_err = max(max_err, err)
                n_cases += 1
    log(f"flash_attention == plain version on {n_cases} cases (routes "
        f"{routes}; hd {FLASH_HDS}, S 16, 1000, 1024, 2048, groups 1, 4, 6 "
        f"and 7, 16 and 448 queries over 1500 keys), each one launch "
        f"repeating bit for bit, max_abs_err {max_err:.3g}")
    served = flash_served_times(torch, gen)

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
                     "(tensor cores)",
            "routes": routes,
            "served": served}


def ffn_case(torch, gen, m, d, f, dtype):
    """x (m, d), Wg and Wu (d, f), Wd (f, d) in ``dtype``, drawn on the
    card from a CUDA generator that the host generator ``gen`` seeds: a
    host draw of a 34 B model's three FFN weights takes seconds."""
    dt = getattr(torch, dtype)
    card = torch.Generator(device="cuda").manual_seed(int(torch.randint(
        0, 2 ** 62, (1,), generator=gen)))

    def normal(rows, cols, std=1.0):
        return torch.randn(rows, cols, generator=card,
                           device="cuda").mul_(std).to(dt)

    return (normal(m, d), normal(d, f, d ** -0.5), normal(d, f, d ** -0.5),
            normal(f, d, f ** -0.5))


# K3 at the served decode shapes (M 8, bf16): (label, D, F, activation),
# the dense families' FFNs and zamba2-1.2b's shared one
K3_SERVED = (("yi-34b", 7168, 20480, "silu"),
             ("qwen1.5-32b", 5120, 27392, "silu"),
             ("internvl2-26b", 6144, 16384, "silu"),
             ("gemma-7b", 3072, 24576, "gelu"),
             ("gemma3-12b", 3840, 15360, "gelu"),
             ("phi3-mini", 3072, 8192, "silu"),
             ("zamba2-1.2b", 2048, 8192, "gelu"))


def ffn_served_times(torch, gen):
    """K3 at ``K3_SERVED``: each shape held to its plain version (one
    launch, a repeat bit for bit), then timed by ``k3_times`` (CUDA events
    and the profiler's device time beside the plain version, the unfused
    cuBLAS chain and the byte bound).  Three profiler windows at most a
    time: this early in a run the profiler often loses events (PERF.md
    §6), and 12.0, 13.0 and 9.0 time the same shapes again later.
    Returns ``{label: fields}``, each with the route that ran."""
    from repro_torch.kernels.fused_ffn import fused_ffn
    from repro_torch.kernels.ref import fused_ffn_ref
    table = {}
    for label, d, f, act in K3_SERVED:
        x, wg, wu, wd = ffn_case(torch, gen, 8, d, f, "bfloat16")
        before = fused_ffn.launches
        out = fused_ffn(x, wg, wu, wd, act)
        if fused_ffn.launches != before + 1:
            raise AssertionError(f"fused_ffn counted "
                                 f"{fused_ffn.launches - before} launches "
                                 f"for one call at {label}")
        err = check_close("fused_ffn", out, fused_ffn_ref(x, wg, wu, wd, act),
                          FFN_TOL["bfloat16"], f"{label} M 8, D {d}, F {f}")
        if not torch.equal(out, fused_ffn(x, wg, wu, wd, act)):
            raise AssertionError(f"fused_ffn does not repeat at {label}")
        t = dict(k3_times(torch, x, wg, wu, wd, act, tries=3),
                 max_abs_err=err)
        mb = 3 * d * f * 2 / 1e6
        log(f"K3 {label} (M 8, D {d}, F {f}, {act}): {t['route']} "
            f"{t['ms']:.4f} ms, device {fmt(t['device_ms'])}; chain "
            f"{t['chain_ms']:.4f} ms, device {fmt(t['chain_device_ms'])}; "
            f"plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}); "
            f"{1e3 * (t['device_ms'] or t['ms']) / mb:.4f} us a weight MB; "
            f"max_abs_err {err:.3g}")
        table[label] = t
        del x, wg, wu, wd, out
    return table


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
    # output tiles, small M at D 1024; above D 512 stream up to M 24 (MP
    # 8, 16 and 24; a ragged output tile and D chunk at D 1544; ragged
    # units and F chunks; tiles split between blocks in both passes) and
    # two_pass beyond: rows past M in the last 128-row tile (M 25, 65,
    # 129, 300), boxes partly or wholly past D (1544) and F (1000, 1032),
    # a last wave cut into K parts (pass 2 at M 129, F 8192; both passes
    # at M 300, D 1544, F 4104) and internvl2-26b's prefill (M 4096)
    cases += [(m, d, f, "bfloat16") for m, d, f in (
        (1, 256, 1024), (64, 256, 1000), (65, 256, 1024), (8195, 256, 1024),
        (127, 264, 200), (300, 512, 1032), (16, 1024, 4096),
        (1, 2048, 1000), (24, 2048, 1032), (25, 2048, 1032),
        (65, 2048, 200), (130, 1544, 1032), (17, 1544, 1032),
        (9, 2056, 1000), (8, 7168, 1032), (24, 5120, 1000), (2, 3072, 200))]
    cases += [(m, d, f, "bfloat16") for m in (25, 65, 129, 300)
              for d in (2048, 1544) for f in (1000, 1032)]
    cases += [(129, 2048, 8192, "bfloat16"), (300, 1544, 4104, "bfloat16"),
              (4096, 6144, 16384, "bfloat16")]
    routes = {}
    for m, d, f, dtype in cases:
        for act in ("silu", "gelu"):
            args = ffn_case(torch, gen, m, d, f, dtype)
            out = fused_ffn(*args, act)
            route = fused_ffn.last_route
            ref = fused_ffn_ref(*args, act)
            torch.cuda.synchronize()
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
    # two_pass where a last column tile stores fewer boxes than it holds
    # (D mod 256 = 8 in pass 2, F mod 128 = 8 in pass 1), several tiles a
    # block: the staging boxes' reuse waits on the right store, so many
    # calls repeat the first bit for bit
    for m, d, f in ((2048, 1544, 4104), (4096, 2056, 1032)):
        args = ffn_case(torch, gen, m, d, f, "bfloat16")
        out = fused_ffn(*args, "silu")
        if fused_ffn.last_route != "two_pass":
            raise AssertionError(f"fused_ffn M={m} D={d} F={f}: route "
                                 f"{fused_ffn.last_route}, not two_pass")
        check_close("fused_ffn", out, fused_ffn_ref(*args, "silu"),
                    FFN_TOL["bfloat16"], f"M={m} D={d} F={f} bfloat16 silu")
        for _ in range(30):
            if not torch.equal(out, fused_ffn(*args, "silu")):
                raise AssertionError(f"fused_ffn does not repeat: M={m} "
                                     f"D={d} F={f} (two_pass)")
    log("fused_ffn two_pass at a ragged last column tile (M 2048, D 1544, "
        "F 4104; M 4096, D 2056, F 1032): 30 repeats bit for bit")
    served = ffn_served_times(torch, gen)

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
    # gelu (the gemma configs') on the two_pass route, beside silu above
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
            "routes": routes, "served": served,
            "designs": {"small_m": "clusters of up to 16 blocks splitting "
                                   "F, TMA ring, wgmma, F-split sum "
                                   "through distributed shared memory",
                        "stream": "two persistent wgmma launches, TMA "
                                  "weight streaming",
                        "two_pass": "two persistent wgmma launches, TMA "
                                    "ring, TMA stores",
                        "cuda_cores": "f32 on the CUDA cores"},
            "shape": "M 8 (a decode step; small-M route), D 256, F 1024, "
                     "bf16, silu; *_m16384: M 8 x 2048 (two_pass); "
                     "routes: the routes the sweep ran, by cases; served: "
                     "M 8 at the served FFNs"}


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
    from repro_torch.kernels.ssd_scan import ssd_plan, ssd_scan
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
    # K6's launches by device time: bf16 one (the wgmma route), f32 two
    # (chunk state, chunk scan on the CUDA cores)
    parts = {(dtype, part): device_ms(
        torch, lambda: ssd_scan(*burst[dtype], chunk=256), iters=10,
        part=part)
        for dtype, part in (("bfloat16", "ssd_scan_wg"),
                            ("float32", "chunk_state"),
                            ("float32", "chunk_y"))}
    log("ssd_scan burst by launch (device): " + ", ".join(
        f"{dtype} {part} {fmt(v)}" for (dtype, part), v in parts.items()))
    routes = {dtype: ssd_plan(getattr(torch, dtype), b, s, h, p, n,
                              256).route for dtype in burst}
    x, dt, a, bm, cm = burst["bfloat16"]
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
            "routes": routes,
            "shape": "8 x 2048 tokens, H 32, P 64, N 128, bf16, chunk 256; "
                     "one_prompt_*: 1 x 2048; routes: by dtype"}


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
    prefill call K6; a hybrid runs K6 per layer of a prefill call and
    its shared block's K2 (prefill) and K3 (prefill and step) per site.
    A step replayed as a CUDA graph counts the launches captured in its
    graph.  Every kernel of the path must have launched, and no other;
    engines of other modes add their own.  Returns ``{kernel name:
    launches}``."""
    layers = engines[0].cfg.num_layers
    decode = sum(e.stats.decode_calls for e in engines)
    prefill = sum(e.stats.prefill_calls for e in engines)
    counts = {name: fn.launches for name, fn in _kernel_fns().items()}
    expect = dict.fromkeys(counts, 0)
    for e in engines:
        n = e.cfg.num_layers
        d, p = e.stats.decode_calls, e.stats.prefill_calls
        if e.cfg.arch_type in ("ssm", "hybrid"):
            expect["ssd_scan"] += p * n
            # a hybrid's shared attention block: K2 at each site of a
            # prefill call, K3 at each site of a prefill call and a step
            sites = (n // (e.cfg.shared_attn_period or n)
                     if e.cfg.arch_type == "hybrid" else 0)
            expect["flash_attention"] += p * sites
            expect["fused_ffn"] += (p + d) * sites
        else:
            expect["flash_attention"] += p * n
            # an MoE block runs K3 only for a shared expert, and a
            # non-gated FFN (whisper's) is plain products
            if e.cfg.gated_ffn and (e.cfg.arch_type != "moe"
                                    or e.cfg.moe_shared_expert):
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
    step_split(torch, ServingEngine(
        cfg, params, slots=8, max_seq=512, block_size=16, opts=opts,
        decode_mode="paged", compile_cache=eng.compile_cache,
        device="cuda"), "paper-backbone paged int8 graph step", name)

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
    its device time and idle share (over at most ``PROFILE_STEPS``
    steps); one graph replay is also timed alone by CUDA events.  The
    engine is not used afterwards (the lone replays advance its state
    past its bookkeeping).  Returns the graph-replayed
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
    reps = min(steps, PROFILE_STEPS)
    g_busy, g_ops = device_profile(torch, eng.step, reps, graph_ms,
                                   f"{what}, replayed as a CUDA graph, "
                                   "per step")
    e_busy, e_ops = device_profile(torch, eager_step, reps, eager_ms,
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



def step_split(torch, eng, what, smi, steps=16):
    """The graph-replayed decode step of ``eng`` (a fresh engine, its 8
    slots filled with greedy requests): host ms a step over ``steps``
    replays, and the device time a step from one profile of
    ``PROFILE_STEPS`` replays, split into K3 (``fused_ffn`` kernels), K1
    (``paged_decode``) and the rest.  Returns the five figures."""
    from torch.profiler import ProfilerActivity, profile
    fill_slots(eng, 4 * steps + 16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def ms(part):
        return sum(e.self_device_time_total for e in kernels
                   if part in e.key) / 1e3 / PROFILE_STEPS

    busy, k3, k1 = (ms(""), ms(PROFILED_KERNELS["K3"]),
                    ms(PROFILED_KERNELS["K1"]))
    if min(busy, k3, k1) <= 0:
        raise RuntimeError(f"{what}: the split found device {busy}, K3 {k3}, "
                           f"K1 {k1} ms")
    log(f"{what} on {smi}, 8 busy slots: {host_ms:.3f} ms/step on the host "
        f"clock; device {busy:.4f} ms = K3 {k3:.4f} + K1 {k1:.4f} + the "
        f"rest {busy - k3 - k1:.4f}")
    return dict(host_ms=host_ms, device_ms=busy, k3_ms=k3, k1_ms=k1,
                rest_ms=busy - k3 - k1)


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


# calls a whole-step profile covers: its cost on the host grows with the
# events it keeps, and the device time a step varies little from step to
# step (graph_vs_eager's profiles and the *_split helpers)
PROFILE_STEPS = 4
SPLIT_REPS = 3
# the port's kernels by a part of their CUDA function names
PROFILED_KERNELS = {"K1": "paged_decode", "K2": "flash_attn",
                    "K3": "fused_ffn", "K6": "ssd_scan"}


def device_profile(torch, fn, reps, wall_ms, what):
    """``torch.profiler`` over ``reps`` calls of ``fn``: device time per
    call by kernel, each of the port's kernels (K1, K2, K3, K6) summed
    over its routes and, against the unprofiled wall time ``wall_ms`` of
    one call, the device's idle share.  Only device activity is recorded:
    the profiler's cost on the host grows with every event it keeps, and
    the host ops would add nothing read here."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
                                  case_study_trace)
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

    # (e) P6: the reference's ladder (test_profiler_calibration.py: full,
    # w 0.75, (w 0.5, d 0.75), (w 0.5, d 0.5), tokens (2, 256)), ranked
    # by its H100_SXM estimates against the card's device time
    rank_ladder(torch, cfg, params, tokens[:2])
    log(f"H100_SXM.idle_w {H100_SXM.idle_w} W; idle power.draw read in "
        f"phase 1: {idle_w} W ({smi})")
    log(f"adaptation phase: {time.perf_counter() - t_phase:.1f} s")
    return {k: n for k, n in counts.items() if n}



P6_BAR = 0.79        # test_profiler_calibration.py's bar, not lowered
P6_LADDER = (dict(), dict(width_ratio=0.75),
             dict(width_ratio=0.5, depth_ratio=0.75),
             dict(width_ratio=0.5, depth_ratio=0.5))


def whole_profile_ms(torch, fn, k2_per_call, iters=20, tries=3):
    """Device ms of one call of ``fn``: the profiler's kernel time over
    ``iters`` calls, taken only from a profile that recorded every one
    of the call's ``k2_per_call`` flash attention launches (the profiler
    drops events late in a long run).  ``None`` when no profile of
    ``tries`` was whole."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        k2 = sum(e.count for e in kernels if "flash_attn" in e.key)
        if k2 == k2_per_call * iters:
            return sum(e.self_device_time_total for e in kernels) \
                / 1e3 / iters
    return None


def rank_ladder(torch, cfg, params, tokens):
    """P6 on the card: the 4 variants of the reference's calibration
    ladder, ranked by their ``H100_SXM`` estimates (eps 0.5, as the
    reference estimates with ``MOBILE_CPU``) against each ``forward``'s
    device time (the profiler's kernel sum, checked whole), beside the
    ranking against CUDA-event times (host included).  Logs both
    ``rank_consistency`` values beside the reference's bar; returns the
    device-time one (``None`` when a device time was not measured)."""
    from repro_torch.core import (H100_SXM, estimate_latency, layer_costs,
                                  rank_consistency)
    from repro_torch.elastic import VariantSpec, derive_variant
    from repro_torch.models import forward
    b, s = tokens.shape
    est, dev, events = [], [], []
    for kw in P6_LADDER:
        vcfg, vparams = derive_variant(cfg, params, VariantSpec(**kw))
        est.append(estimate_latency(layer_costs(vcfg, b, s), 0.5, H100_SXM))
        with torch.no_grad():
            def call():
                return forward(vparams, vcfg, tokens)
            dev.append(whole_profile_ms(torch, call, vcfg.num_layers))
            events.append(cuda_ms(torch, call, 20, 3))
        if dev[-1] is not None and dev[-1] > events[-1]:
            raise AssertionError(f"P6 {kw}: device time {dev[-1]} ms above "
                                 f"the CUDA-event time {events[-1]} ms")
        log(f"  P6 ladder {kw or 'full'}: est {1e3 * est[-1]:.5f} ms, "
            f"device {fmt(dev[-1])}, CUDA events {events[-1]:.4f} ms")
    rho_ev = rank_consistency(est, events)
    rho = None if None in dev else rank_consistency(est, dev)
    verdict = ("not measured" if rho is None else
               "met" if rho >= P6_BAR else "missed")
    log(f"P6: rank_consistency of H100_SXM estimates on the reference's "
        f"ladder at tokens {b} x {s}: "
        f"{'not measured' if rho is None else f'{rho:.4f}'} against "
        f"device time (bar {P6_BAR}: {verdict}), {rho_ev:.4f} against "
        f"CUDA-event time")
    return rho


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


def expert_split(torch, step, cfg, reps=SPLIT_REPS):
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
    from repro_torch.models.layers import tree_leaves
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
    # drawn in the bf16 the engines serve straight on the card (the router
    # in f32, as cast_params leaves it), so that every engine below shares
    # one 13.6 GB copy; the host's f32 draw took ~50 s
    params = card_params(torch, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"olmoe-1b-7b: {n_params / 1e9:.3f} B parameters drawn in bf16 on "
        f"the card from seed 0 in {init_s:.1f} s")
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


# ---------------------------------------------------------------- phase 9
def hybrid_kernels_alone(torch):
    """9.0: K6, K2 and K3 at the shapes zamba2-1.2b gives them, each
    against its plain version and repeating bit for bit, then timed
    beside its bound, its plain version and, for K2 and K3, a library
    yardstick.  Returns the timing fields for the kernels line, by kernel
    name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, fused_ffn
    from repro_torch.kernels.fused_ffn import ffn_plan
    from repro_torch.kernels.ref import fused_ffn_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.ssm import ssd_scan_ref
    gen = torch.Generator().manual_seed(99)
    out = {}
    # K6: a prefill burst of 8 prompts, 64 heads of 64, state 64, one
    # group, chunk 256; x, b and c are views of a 4224-wide conv row
    # (b at column 4096, c at 4160: 16-byte aligned), bucket 1024 and a
    # ragged 1000
    b, h, g, p, n = 8, 64, 1, 64, 64
    err = 0.0
    for s in (1024, 1000):
        x, dt, a, bm, cm = ssd_case(torch, gen, b, s, h, g, p, n,
                                    "bfloat16")
        y, st = ssd_scan(x, dt, a, bm, cm, chunk=256)
        yr, sr = ssd_scan_ref(x, dt, a, bm, cm, chunk=256)
        what = f"zamba2 {b} x {s}, H {h}, P {p}, N {n}, bf16"
        err = max(err, check_close("ssd_scan", y, yr, SSD_TOL["bfloat16"],
                                   "y " + what))
        check_close("ssd_scan", st, sr, STATE_TOL, "state " + what)
        y2, st2 = ssd_scan(x, dt, a, bm, cm, chunk=256)
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            raise AssertionError(f"ssd_scan does not repeat at {what}")
        del y, st, yr, sr, y2, st2

    def k6():
        return ssd_scan(x, dt, a, bm, cm, chunk=256)

    x, dt, a, bm, cm = ssd_case(torch, gen, b, 1024, h, g, p, n, "bfloat16")
    nbytes, flops = ssd_work(b, 1024, h, g, p, n, 256, 2, 2)
    k6t = dict(ms=cuda_ms(torch, k6, iters=20, warmup=3),
               device_ms=device_ms(torch, k6, iters=10, part="ssd_scan"),
               plain_ms=cuda_ms(torch, lambda: ssd_scan_ref(
                   x, dt, a, bm, cm, chunk=256), iters=3, warmup=1),
               library_ms=None, max_abs_err=err)
    k6t["bound_ms"], k6t["bound_by"] = bound(nbytes, flops, H100_BF16_FLOPS)
    out["ssd_scan"] = k6t
    del x, dt, a, bm, cm

    # K2: the shared block at prefill, 8 x 1024 tokens, 32 heads of 64
    # (MHA), causal, bf16
    q, k, v = flash_case(torch, gen, 8, 32, 32, 1024, 64, "bfloat16")
    o = flash_attention(q, k, v)
    err = check_close("flash_attention", o, flash_plain(q, k, v),
                      TOL["bfloat16"], "zamba2 8 x 1024, 32 heads of 64")
    if not torch.equal(o, flash_attention(q, k, v)):
        raise AssertionError("flash_attention does not repeat at 8 x 1024, "
                             "32 heads of 64")
    pairs = flash_pairs(1024, True, 0, None) * 8 * 32
    k2t = dict(
        ms=cuda_ms(torch, lambda: flash_attention(q, k, v), iters=50),
        device_ms=device_ms(torch, lambda: flash_attention(q, k, v),
                            part="flash_attn"),
        plain_ms=cuda_ms(torch, lambda: flash_plain(q, k, v), iters=5,
                         warmup=2),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=50),
        library_device_ms=device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)),
        max_abs_err=err)
    k2t["bound_ms"], k2t["bound_by"] = bound(4 * q.numel() * q.element_size(),
                                             4 * 64 * pairs, H100_BF16_FLOPS)
    out["flash_attention"] = k2t
    del q, k, v, o

    # K3: the shared block's gated gelu FFN, D 2048, F 8192, bf16, at a
    # decode step (M 8) and a prefill burst (M 8 x 1024)
    for m in (8, 8 * 1024):
        x, wg, wu, wd = ffn_case(torch, gen, m, 2048, 8192, "bfloat16")
        route = ffn_plan(x.dtype, m, 2048, 8192).route
        o = fused_ffn(x, wg, wu, wd, "gelu")
        err = check_close("fused_ffn", o, fused_ffn_ref(x, wg, wu, wd,
                                                        "gelu"),
                          FFN_TOL["bfloat16"],
                          f"zamba2 M {m}, D 2048, F 8192, gelu ({route})")
        if not torch.equal(o, fused_ffn(x, wg, wu, wd, "gelu")):
            raise AssertionError(f"fused_ffn does not repeat at M {m}, "
                                 "D 2048")

        def chain():
            return (F.gelu(x @ wg, approximate="tanh") * (x @ wu)) @ wd

        iters = 200 if m == 8 else 20
        t = dict(
            route=route,
            ms=cuda_ms(torch, lambda: fused_ffn(x, wg, wu, wd, "gelu"),
                       iters=iters),
            device_ms=device_ms(torch, lambda: fused_ffn(x, wg, wu, wd,
                                                         "gelu"),
                                part="fused_ffn"),
            plain_ms=cuda_ms(torch, lambda: fused_ffn_ref(x, wg, wu, wd,
                                                          "gelu"),
                             iters=10, warmup=2),
            chain_ms=cuda_ms(torch, chain, iters=iters),
            chain_device_ms=device_ms(torch, chain),
            library_ms=None, max_abs_err=err)
        t["bound_ms"], t["bound_by"] = bound(
            (2 * x.numel() + wg.numel() + wu.numel() + wd.numel())
            * x.element_size(), 6 * m * 2048 * 8192, H100_BF16_FLOPS)
        out["fused_ffn" if m == 8 else "fused_ffn_m8192"] = t
        del x, wg, wu, wd, o
    for name, t in out.items():
        log(f"{name} at zamba2-1.2b's shape"
            + (f" (route {t['route']})" if "route" in t else "")
            + f": kernel_ms {t['ms']:.4f} device {fmt(t['device_ms'])}; "
            f"plain_ms {t['plain_ms']:.4f}; "
            + (f"SDPA {t['library_ms']:.4f} ms, device "
               f"{fmt(t['library_device_ms'])}; " if t["library_ms"]
               else "")
            + (f"unfused cuBLAS chain {t['chain_ms']:.4f} ms, device "
               f"{fmt(t['chain_device_ms'])}; " if "chain_ms" in t else "")
            + f"bound_ms {t['bound_ms']:.5f} ({t['bound_by']}); "
            f"max_abs_err {t['max_abs_err']:.3g}")
    log("phase 9 shapes: K6 (8 x 1024 and 8 x 1000, H 64, P 64, N 64), K2 "
        "(8 x 1024, 32 heads of 64) and K3 (gelu, D 2048, F 8192, M 8 and "
        "8192) == plain versions, each repeating bit for bit")
    extra = {name: {f"{key}_zamba2": val for key, val in t.items()}
             for name, t in out.items()}
    extra["fused_ffn"].update({f"{key}_zamba2_m8192": val for key, val
                               in out["fused_ffn_m8192"].items()})
    del extra["fused_ffn_m8192"]
    return extra


ZAMBA_LENS = (8, 1000, 30, 900, 60, 400, 100, 200,
              12, 800, 25, 600, 50, 500, 120, 250)


def _zamba_prompts(seed, vocab):
    """16 prompts of 8..1000 tokens, two in each bucket from 16 to 1024
    (four at 1024), interleaved short and long; ``seed`` draws the
    tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in ZAMBA_LENS]


def hybrid_split(torch, step, cfg, reps=SPLIT_REPS):
    """Device time of an eager hybrid decode step split into K3 (the
    shared block's FFN at its sites), K2 (none: decode attention is
    plain), the Mamba blocks' products (the in_proj and out_proj
    ``matmul``s, found by their weight shapes, with the out_proj
    weight's cast to f32 that the f32 product takes) and the rest, from
    one profile with shapes recorded.  Returns ``(busy, K3, K2, mamba)``
    in ms a step."""
    from torch.profiler import ProfilerActivity, profile
    d, di = cfg.d_model, cfg.ssm_d_inner
    in_dim = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state_dim \
        + cfg.ssm_num_heads
    weights = ([d, in_dim], [di, d])
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()

    def mamba_product(ev):
        shapes = ev.input_shapes or []
        if ev.name == "aten::matmul":
            return len(shapes) >= 2 and list(shapes[1]) in weights
        return ev.name == "aten::to" and bool(shapes) \
            and list(shapes[0]) == [di, d]

    mamba = sum(ev.device_time_total for ev in prof.events()
                if mamba_product(ev)) / 1e3 / reps
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ev.self_device_time_total for ev in kernels) / 1e3 / reps

    def kernel_ms(part):
        return sum(ev.self_device_time_total for ev in kernels
                   if part in ev.key) / 1e3 / reps

    k3, k2 = kernel_ms("fused_ffn"), kernel_ms("flash_attn")
    if mamba <= 0 or k3 <= 0:
        raise RuntimeError(f"the profile split found Mamba products {mamba} "
                           f"ms, K3 {k3} ms")
    return busy, k3, k2, mamba


def hybrid_step_bytes(params, eng):
    """Bytes a hybrid decode step must move at least: every weight read
    once but the shared block's, read at each of its sites (the tied
    unembedding reads the whole table); the f32 SSM state and the conv
    tail read and written; each active slot's shared K/V rows read at
    every site and its new row written.  Returns ``(weights, state,
    kv)``."""
    from repro_torch.models.layers import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    cache = eng._cache
    sites = cache["shared_k"].shape[1]
    weights = nbytes({k: v for k, v in params.items()
                      if k != "shared_attn"}) \
        + sites * nbytes(params["shared_attn"])
    state = 2 * (nbytes(cache["ssm"]) + nbytes(cache["conv"]))
    _, _, _, _, kvh, hd = cache["shared_k"].shape
    row = 2 * sites * kvh * hd * cache["shared_k"].element_size()
    rows = sum(min(int(p), eng.max_seq - 1) + 1 for p, r in zip(
        cache["pos"].tolist(), eng._active) if r is not None)
    return weights, state, rows * row


def step_repeats(torch, eng, what):
    """A whole decode step repeats bit for bit: the step run eagerly on
    two clones of one engine state gives equal tokens and equal cache
    (and pool) leaves.  Returns the eager step on the first clone."""
    from repro_torch.models.layers import tree_leaves
    fill_slots(eng, 32)
    step_a, state_a = eager_on_clones(torch, eng)
    step_b, state_b = eager_on_clones(torch, eng)
    toks_a, toks_b = step_a(), step_b()
    if not (torch.equal(toks_a, toks_b) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(state_a),
                                              tree_leaves(state_b)))):
        raise AssertionError(f"the {what} decode step does not repeat "
                             "bit for bit on two clones of one state")
    log(f"a whole {what} decode step repeats bit for bit (tokens and "
        f"every cache leaf)")
    return step_a


def p4_measured(torch, cfg, lens, new_tokens, seed, what):
    """P4 on the hybrid, measured and not held: the same greedy requests
    with the bf16 caches the JAX package keeps (conv tail and shared
    K/V in bf16, f32 activations), batched, on the card and on the CPU.
    Logs per stream the first step where the two part (or that they stay
    equal) and the CPU's top-2 logit margin there."""
    import numpy as np
    prompts = greedy_prompts(seed, cfg.vocab_size, lens)
    streams = {}
    for dev in ("cuda", "cpu"):
        streams[dev], _, params = serve_greedy(
            torch, cfg, prompts, new_tokens, dev, max_seq=512,
            decode_mode="batched")
    parts = []
    for p, a, b in zip(prompts, streams["cuda"], streams["cpu"]):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            parts.append("equal")
            continue
        margin = top2_margin(torch, params, cfg, np.concatenate([p, b[:i]]))
        parts.append(f"step {i} (CPU top-2 margin {margin:.3g})")
    log(f"  P4, {what}, bf16 conv and shared K/V caches (measured, not "
        f"held): {parts.count('equal')} of {len(parts)} streams equal card "
        f"and CPU over {new_tokens} tokens; per stream: " + "; ".join(parts))


def phase_hybrid(torch, smi):
    """The hybrid on the card: 9.0 the kernels at zamba2-1.2b's shapes;
    9a full-width zamba2-1.2b served batched in bf16; 9b card == CPU on
    the reduced hybrid (5 layers at period 2) in f32, and P4 measured.
    Returns ``({kernel name: launches}, {kernel name: timing fields})``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.layers import cast_params, tree_leaves
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.serving import CompileCache, ServingEngine
    t_phase = time.perf_counter()
    extra = hybrid_kernels_alone(torch)
    totals = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    # --- 9a: full-width zamba2-1.2b, bf16, batched ---------------------
    cfg = get_config("zamba2-1.2b")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # drawn in f32 (the config's param dtype), cast once on the card to
    # bf16 (a_log, d_skip and dt_bias stay f32), shared by every engine
    params = cast_params(init_params(cfg, seed=0, device="cuda"),
                         torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"zamba2-1.2b: {n_params / 1e9:.3f} B parameters drawn from seed 0 "
        f"on the host, moved to the card and cast to bf16 in {init_s:.1f} "
        "s")
    cache = CompileCache()

    def engine():
        return ServingEngine(cfg, params, slots=8, max_seq=2048,
                             decode_mode="batched", compile_cache=cache,
                             device="cuda")

    eng = engine()
    zero_counts()
    waves = []
    for wave in range(2):
        waves.append(serve_wave(torch, eng, _zamba_prompts(
            60 + wave, cfg.vocab_size), 12000 + 100 * wave, 64))
        if wave == 0:
            warm = eng.stats.recompiles
    counts = check_counts([eng], "zamba2-1.2b batched, two waves")
    if set(counts) != {"ssd_scan", "flash_attention", "fused_ffn"}:
        raise AssertionError(f"zamba2 launched {sorted(counts)}")
    if eng.stats.recompiles != warm:
        raise AssertionError(f"the second zamba2 wave built "
                             f"{eng.stats.recompiles - warm} new programs")
    if not 1 <= captures(eng) <= 2:
        raise AssertionError(f"zamba2: {captures(eng)} graph captures "
                             "(expected at most decode and decode_greedy)")
    add(counts)
    for wave, (tps, ms, reqs) in enumerate(waves):
        log(f"zamba2-1.2b batched on {smi}, wave {wave + 1}: {tps:.1f} "
            f"tok/s, {ms:.3f} ms/decode step; TTFT by bucket " + "; ".join(
                f"{b}: mean {mean:.1f} ms, max {mx:.1f} ms over {n}"
                for b, (mean, mx, n) in ttft_by_bucket(eng, reqs).items()))
    log(f"  decode steps {eng.stats.decode_calls}, prefill calls "
        f"{eng.stats.prefill_calls}, programs built {warm}, graph captures "
        f"{captures(eng)}")
    busy_eng = engine()
    step = step_repeats(torch, busy_eng, "zamba2-1.2b")
    weights, state, kv = hybrid_step_bytes(params, busy_eng)
    graph_ms, _, g_busy, _ = graph_vs_eager(
        torch, engine(), "zamba2-1.2b batched step", smi)
    busy, k3, k2, mamba = hybrid_split(torch, step, cfg)
    bound_ms = 1e3 * (weights + state + kv) / H100_BYTES_PER_S
    log(f"zamba2-1.2b decode step on {smi}: eager device {busy:.3f} ms = "
        f"K3 {k3:.4f} + K2 {k2:.4f} + Mamba products {mamba:.3f} + the "
        f"rest {busy - k3 - k2 - mamba:.3f}; graph-replayed "
        f"{graph_ms:.3f} ms host (device {g_busy:.3f} ms, idle share "
        f"{1 - g_busy / graph_ms:.3f}); byte bound {bound_ms:.3f} ms "
        f"({weights / 1e9:.3f} GB of weights with the shared block at "
        f"each site, {state / 1e9:.3f} GB of SSM and conv state read and "
        f"written, {kv / 1e6:.1f} MB of shared K/V at 8 busy slots, at "
        f"{H100_BYTES_PER_S / 1e12:.2f} TB/s): graph step at "
        f"{bound_ms / graph_ms:.3f} of the bound")
    del params, eng, busy_eng, step
    torch.cuda.empty_cache()

    # --- 9b: card == CPU, f32, the reduced hybrid at period 2 -----------
    rcfg = get_config("zamba2-1.2b").reduced(num_layers=5).with_updates(
        shared_attn_period=2, activation_dtype="float32")
    f32 = RuntimeOptions(kv_cache_dtype="float32")
    what = "zamba2 reduced (5 layers, period 2)"
    lens = (8, 37, 120, 200)
    for mode in ("batched", "per_slot"):
        keep = []
        zero_counts()
        card_vs_cpu(torch, rcfg, lens, 24, 90, f"{what} {mode}, f32 "
                    "caches", keep=keep, max_seq=512, decode_mode=mode,
                    opts=f32)
        add(check_counts(keep, f"{what} {mode}"))
    for swap in ("same", "other"):
        keep = []
        zero_counts()
        _, st = card_vs_cpu(torch, rcfg, (8, 37, 120, 200, 60, 90), 24, 91,
                            f"{what} batched, f32 caches, swap_model to "
                            f"the {swap} weights after 4 steps", swap=swap,
                            keep=keep, max_seq=512, decode_mode="batched",
                            opts=f32)
        if st["requeues"] != 4 or st["thaws"] != (4 if swap == "same"
                                                  else 0):
            raise AssertionError(f"zamba2 swap ({swap}): {st}")
        add(check_counts(keep, f"{what} swap ({swap})"))
    # the full-depth, full-width config in f32 (4.4 GB of weights): a
    # short wave with every kernel on its f32 route at zamba2's widths
    fcfg = get_config("zamba2-1.2b").with_updates(activation_dtype="float32")
    keep = []
    zero_counts()
    card_vs_cpu(torch, fcfg, (8, 30, 100), 8, 92, "zamba2-1.2b full width, "
                "f32 caches", keep=keep, max_seq=256, decode_mode="batched",
                opts=f32)
    add(check_counts(keep, "zamba2-1.2b full width, f32"))
    p4_measured(torch, rcfg, lens, 48, 90, what)
    log(f"hybrid phase: {time.perf_counter() - t_phase:.1f} s")
    return totals, extra


# --------------------------------------------------------------- phase 10
WHISPER_MAX_SEQ = 512        # the served wave's max_seq (10b): mb 32


def _time_kernel(torch, fn, plain, library, part, nbytes, flops, iters=50,
                 plain_iters=5, tries=6):
    """The timing fields of one kernel call: CUDA-event and device ms
    (``device_ms`` with up to ``tries`` profiler windows), its plain
    version's and a library call's ms, its bound."""
    t = dict(ms=cuda_ms(torch, fn, iters=iters),
             device_ms=device_ms(torch, fn, iters=min(iters, 50),
                                 part=part, tries=tries),
             plain_ms=cuda_ms(torch, plain, iters=plain_iters, warmup=1))
    if library is not None:
        t["library_ms"] = cuda_ms(torch, library, iters=iters)
        t["library_device_ms"] = device_ms(torch, library,
                                           iters=min(iters, 50))
    else:
        t["library_ms"] = None
    t["bound_ms"], t["bound_by"] = bound(nbytes, flops, H100_BF16_FLOPS)
    return t


def k1_times(torch, args, sc, window=0):
    """The timing fields of one K1 problem: CUDA-event and device ms, its
    plain version's ms, SDPA's over the K/V gathered beforehand, and its
    bound."""
    from repro_torch.kernels.paged_decode_attn import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attn_ref

    def k1():
        return paged_decode_attention(*args, window=window, **sc)

    t = dict(ms=cuda_ms(torch, k1),
             device_ms=device_ms(torch, k1, part="paged_decode"),
             plain_ms=cuda_ms(torch, lambda: paged_decode_attn_ref(
                 *args, window=window, **sc), iters=20))
    t["library_ms"], t["library_device_ms"] = sdpa_yardstick(torch, args, sc,
                                                             window)
    t["bound_ms"], t["bound_by"] = paged_bound_ms(args, sc, window)
    return t


def k3_times(torch, x, wg, wu, wd, activation, tries=6):
    """The timing fields of one K3 problem on its bf16 route: the route
    that ran (the wrapper's ``last_route``), CUDA-event and device ms, its
    plain version's ms, the unfused cuBLAS chain's, its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_ffn
    from repro_torch.kernels.ref import fused_ffn_ref
    act = (F.silu if activation == "silu"
           else lambda t: F.gelu(t, approximate="tanh"))
    (m, d), f = x.shape, wg.shape[1]

    def chain():
        return (act(x @ wg) * (x @ wu)) @ wd

    iters = 100 if m == 8 else 10
    fused_ffn(x, wg, wu, wd, activation)
    route = fused_ffn.last_route
    t = _time_kernel(
        torch, lambda: fused_ffn(x, wg, wu, wd, activation),
        lambda: fused_ffn_ref(x, wg, wu, wd, activation), None, "fused_ffn",
        (2 * x.numel() + 3 * wg.numel()) * 2, 6 * m * d * f, iters=iters,
        plain_iters=3, tries=tries)
    t.update(route=route, chain_ms=cuda_ms(torch, chain, iters=iters),
             chain_device_ms=device_ms(torch, chain, iters=10,
                                       tries=tries))
    return t


def encdec_kernels_alone(torch):
    """10.0: K2 at whisper-small's encoder self-attention (8 x 1500
    frames, 12 heads of 64, non-causal) and its cross-attention (8 x 16
    and 8 x 448 decoder queries over the 1500 frames: the key length
    apart from the query length) and K1 at its paged decode step, each
    against its plain version and repeating bit for bit, then timed
    beside its bound, its plain version and SDPA.  Returns the timing
    fields for the kernels line, by kernel name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import paged_decode_attn_ref
    gen = torch.Generator().manual_seed(2300)
    times = {}
    b, h, hd, se = 8, 12, 64, 1500
    # K2, the encoder: 8 x 1500 frames, non-causal
    q, k, v = flash_case(torch, gen, b, h, h, se, hd, "bfloat16")
    nc = dict(causal=False)
    err = check_close("flash_attention", flash_attention(q, k, v, **nc),
                      flash_plain(q, k, v, **nc), TOL["bfloat16"],
                      "whisper encoder 8 x 1500, 12 heads of 64")
    if not torch.equal(flash_attention(q, k, v, **nc),
                       flash_attention(q, k, v, **nc)):
        raise AssertionError("flash_attention does not repeat at the "
                             "whisper encoder's shape")
    times["encoder"] = _time_kernel(
        torch, lambda: flash_attention(q, k, v, **nc),
        lambda: flash_plain(q, k, v, **nc),
        lambda: F.scaled_dot_product_attention(q, k, v), "flash_attn",
        4 * q.numel() * 2, 4 * b * h * se * se * hd)
    times["encoder"]["max_abs_err"] = err
    # K2, the cross-attention: decoder queries over the 1500 frames
    for sq in (16, 448):
        qc = torch.randn(b, sq, h, hd, generator=gen).to(
            torch.bfloat16).cuda().transpose(1, 2)
        out = flash_attention(qc, k, v, **nc)
        err = check_close("flash_attention", out, flash_plain(qc, k, v, **nc),
                          TOL["bfloat16"], f"whisper cross-attention {b} x "
                          f"{sq} queries over {se} keys")
        if not torch.equal(out, flash_attention(qc, k, v, **nc)):
            raise AssertionError(f"flash_attention does not repeat at {sq} "
                                 f"queries over {se} keys")
        times[f"cross{sq}"] = _time_kernel(
            torch, lambda: flash_attention(qc, k, v, **nc),
            lambda: flash_plain(qc, k, v, **nc),
            lambda: F.scaled_dot_product_attention(qc, k, v), "flash_attn",
            (2 * qc.numel() + 2 * k.numel()) * 2, 4 * b * h * sq * se * hd)
        times[f"cross{sq}"]["max_abs_err"] = err
    del q, k, v, qc, out
    # K1 at whisper's paged decode: 8 slots x 12 heads of 64 (group 1), an
    # int8 pool of 12 layers, block 16, mb 32 (max_seq 512)
    mb = WHISPER_MAX_SEQ // 16
    err = 0.0
    for pos_kind in ("ragged", "full_tail", "short"):
        args, sc = make_case(torch, gen, slots=b, heads=h, kvh=h, hd=hd,
                             bs=16, mb=mb, pool_dtype="int8",
                             q_dtype="bfloat16", pos_kind=pos_kind,
                             layers=12, layer=5)
        err = max(err, check_close(
            "paged_decode_attention", k1_repeated(torch, args, sc, 0),
            paged_decode_attn_ref(*args, **sc), TOL["bfloat16"],
            f"whisper decode, pos {pos_kind}"))
    times["k1"] = dict(k1_times(torch, args, sc), max_abs_err=err)
    labels = {"encoder": "K2, whisper encoder (8 x 1500, 12 heads of 64, "
                         "non-causal)",
              "cross16": "K2, whisper cross-attention (8 x 16 over 1500)",
              "cross448": "K2, whisper cross-attention (8 x 448 over 1500)",
              "k1": "K1, whisper paged decode (8 slots x 12 heads of 64, "
                    "int8, mb 32)"}
    log_times(times, labels)
    log("phase 10 shapes: K2 (whisper's encoder and cross-attention at "
        "its key length) and K1 (whisper's paged decode) == plain "
        "versions, each repeating bit for bit")
    extra = {"flash_attention": {}, "paged_decode_attention": {}}
    for key, t in times.items():
        name = ("paged_decode_attention" if key == "k1"
                else "flash_attention")
        suffix = {"encoder": "_whisper_encoder", "cross16": "_whisper_cross16",
                  "cross448": "_whisper_cross448", "k1": "_whisper"}[key]
        extra[name].update({f"{k}{suffix}": v for k, v in t.items()})
    return extra


def log_times(times, labels):
    """One line per timed kernel case: its times beside its plain
    version's, its yardstick's and its bound."""
    for key, t in times.items():
        log(f"{labels[key]}" + (f" (route {t['route']})" if "route" in t
                                else "")
            + f": kernel_ms {t['ms']:.4f} device {fmt(t['device_ms'])}; "
            f"plain_ms {t['plain_ms']:.4f}; "
            + (f"SDPA {t['library_ms']:.4f} ms, device "
               f"{fmt(t['library_device_ms'])}; " if t["library_ms"]
               else "")
            + (f"unfused cuBLAS chain {t['chain_ms']:.4f} ms, device "
               f"{fmt(t['chain_device_ms'])}; " if "chain_ms" in t else "")
            + f"bound_ms {t['bound_ms']:.5f} ({t['bound_by']}); "
            f"max_abs_err {t['max_abs_err']:.3g}")


def whisper_frames(torch, cfg, batch, seed):
    """Stub audio frames (batch, S_enc, D): std normal x 0.1, drawn from a
    numpy seed (as ``test_arch_smoke.py`` draws them)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(
        (batch, cfg.encoder_seq_len, cfg.d_model)) * 0.1).astype(np.float32))


def decode_split(torch, step, se, max_seq, reps=SPLIT_REPS):
    """Device time of an eager model-level decode step split into the
    cross-attention over an encoder-decoder's cached encoder K/V (the
    top-level ops one of whose inputs, or their children's, spans the
    ``se`` encoder frames: the f32 casts, products, mask and softmax of
    ``decode_attention``; none when ``se`` is None), the self-attention
    over the dense ``max_seq`` cache (the same for ``max_seq``), the
    weight products (top-level ``aten::matmul``/``aten::mm``), K3 (the
    ``fused_ffn`` kernels) and the rest, from one profile with shapes
    recorded.  Returns ``(busy, cross, self, matmuls, k3)`` in ms a
    step."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()

    def spans(ev, n):
        # an einsum records no input shapes: its children's show them
        return any(n in s for s in ev.input_shapes or []) or any(
            spans(c, n) for c in ev.cpu_children)

    parts = {"cross": 0.0, "self": 0.0, "matmuls": 0.0}
    for ev in prof.events():
        if ev.cpu_parent is not None or not ev.name.startswith("aten::"):
            continue
        if se is not None and spans(ev, se):
            key = "cross"
        elif spans(ev, max_seq):
            key = "self"
        elif ev.name in ("aten::matmul", "aten::mm"):
            key = "matmuls"
        else:
            continue
        parts[key] += ev.device_time_total / 1e3 / reps
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ev.self_device_time_total for ev in kernels) / 1e3 / reps
    k3 = sum(ev.self_device_time_total for ev in kernels
             if "fused_ffn" in ev.key) / 1e3 / reps
    if (se is not None and parts["cross"] <= 0) or parts["matmuls"] <= 0 \
            or parts["self"] <= 0:
        raise RuntimeError(f"the profile split found {parts}")
    return busy, parts["cross"], parts["self"], parts["matmuls"], k3


def encdec_step_bytes(params, cache, pos):
    """Bytes a model-level whisper decode step must move at least: the
    decoder's weights it reads (every decoder leaf but the cross blocks'
    K/V projections, whose products the prefill cached) and the tied
    embedding, each once; the cross K/V of every layer read; each row's
    self K/V up to ``pos`` read and its new row written.  Returns
    ``(weights, cross, self)``."""
    from repro_torch.models.layers import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    layers = dict(params["layers"])
    layers["cross"] = {k: v for k, v in layers["cross"].items()
                       if k not in ("wk", "wv")}
    weights = nbytes(layers) + nbytes(params["embed"]) \
        + nbytes(params["final_norm"])
    cross = nbytes(cache["cross_k"]) + nbytes(cache["cross_v"])
    n, b, _, kvh, hd = cache["k"].shape
    row = 2 * n * kvh * hd * cache["k"].element_size()
    return weights, cross, b * (pos + 1) * row


def whisper_transcribe(torch, smi, params, cfg):
    """10a: the transcription path at full width, bf16: ``prefill`` of 8
    prompts of 16 tokens with 8 x 1500 stub frames, then 64 greedy
    ``decode_step``s.  K2 exactly 36 a prefill call (12 encoder, 12
    self, 12 cross), nothing else launched; the encoder's and the
    prefill's times, the decode step's host and device ms, idle share,
    device split and byte bound.  Returns ``{kernel name: launches}``."""
    import numpy as np
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.runtime import DEFAULT_OPTIONS
    from repro_torch.models.transformer import encode
    b, s, steps = 8, 16, 64
    max_seq = 128
    rng = np.random.default_rng(71)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)).cuda()
    frames = whisper_frames(torch, cfg, b, 72).cuda()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, tokens,
                            init_cache(cfg, b, max_seq), encoder_frames=frames)
    torch.cuda.synchronize()
    ttft_ms = 1e3 * (time.perf_counter() - t0)
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1).to(torch.int32)
    streams = [tok]
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, cache = decode_step(params, cfg, cache, tok)
        tok = torch.argmax(lg[:, :cfg.vocab_size], -1).to(torch.int32)
        streams.append(tok)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    counts = {name: fn.launches for name, fn in _kernel_fns().items()}
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = cfg.encoder_layers + 2 * cfg.num_layers
    if counts != want:
        raise AssertionError(f"whisper prefill + {steps} decode steps: "
                             f"launches {counts}, expected {want}")
    toks = torch.stack(streams, 1).cpu()
    if int(cache["pos"]) != s + steps or not bool(torch.isfinite(
            lg.float()).all()) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError("whisper decode: bad positions, logits or "
                             "tokens")
    log(f"whisper-small transcription on {smi}: prefill of {b} x {s} tokens "
        f"with {b} x {cfg.encoder_seq_len} frames {ttft_ms:.2f} ms host "
        f"(first call), {steps} greedy decode steps {step_ms:.3f} ms/step "
        f"host; launches {counts} (K2 = 36 a prefill call); "
        f"{len(set(toks[:, 1:].flatten().tolist()))} distinct tokens")
    enc_ms = cuda_ms(torch, lambda: encode(params, cfg, frames,
                                           DEFAULT_OPTIONS), 10, 2)
    enc_dev = device_ms(torch, lambda: encode(params, cfg, frames,
                                              DEFAULT_OPTIONS), iters=10,
                        tries=3)

    def run_prefill():
        return prefill(params, cfg, tokens, init_cache(cfg, b, max_seq),
                       encoder_frames=frames)

    pre_ms = cuda_ms(torch, run_prefill, 10, 2)
    pre_dev = device_ms(torch, run_prefill, iters=10, tries=3)
    log(f"  encoder (12 layers over 8 x 1500 frames): {enc_ms:.3f} ms, "
        f"device {fmt(enc_dev)}; prefill (encoder + 12 decoder layers "
        f"with cross K/V captured): {pre_ms:.3f} ms (CUDA events), device "
        f"{fmt(pre_dev)}")
    pos = int(cache["pos"])

    def one_step():
        return decode_step(params, cfg, cache, tok)[0]

    # the steps below write row pos again and again (its position stays),
    # the same work a step at that depth does
    pos_t = cache["pos"].clone()

    def fixed_step():
        cache["pos"].copy_(pos_t)
        return one_step()

    busy, cross, self_, mm, _ = decode_split(torch, fixed_step,
                                             cfg.encoder_seq_len, max_seq)
    weights, cross_b, self_b = encdec_step_bytes(params, cache, pos)
    bound_ms = 1e3 * (weights + cross_b + self_b) / H100_BYTES_PER_S
    log(f"  decode step at pos {pos}, 8 rows: host {step_ms:.3f} ms, "
        f"device {busy:.3f} ms (idle share {1 - busy / step_ms:.3f}) = "
        f"cross-attention {cross:.3f} + self-attention {self_:.3f} + "
        f"weight products {mm:.3f} + the rest {busy - cross - self_ - mm:.3f}"
        f"; byte bound {bound_ms:.4f} ms ({weights / 1e9:.3f} GB of decoder "
        f"weights and the embedding, {cross_b / 1e9:.3f} GB of cross K/V, "
        f"{self_b / 1e6:.2f} MB of self K/V, at "
        f"{H100_BYTES_PER_S / 1e12:.2f} TB/s): the step at "
        f"{bound_ms / step_ms:.3f} of the bound")
    return {k: n for k, n in counts.items() if n}


def whisper_served(torch, smi, params, cfg):
    """10b: whisper-small at full width served as the JAX engine serves
    it (no frames: zero cross K/V, R8): paged, ``paged_kernel=True``,
    ``kv_dtype="int8"``, 8 slots, two waves of 16 requests.  Exact K1
    (12 a step) and K2 (12 a prefill call) launches, no K3; no new
    program on the second wave; a whole step repeats bit for bit; graph
    == eager; one slot frozen and thawed (its cross leaves whole) gives
    the stream of an unfrozen run.  Returns ``{kernel name:
    launches}``."""
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.serving import CompileCache, ServingEngine
    opts = RuntimeOptions(paged_kernel=True, kv_dtype="int8")
    cache = CompileCache()

    def engine():
        return ServingEngine(cfg, params, slots=8, max_seq=WHISPER_MAX_SEQ,
                             opts=opts, decode_mode="paged",
                             compile_cache=cache, device="cuda")

    eng = engine()
    zero_counts()
    waves = []
    for wave in range(2):
        waves.append(serve_wave(torch, eng, _prompts(
            16, 80 + wave, cfg.vocab_size), 23000 + 100 * wave, 32))
        if wave == 0:
            warm = eng.stats.recompiles
    counts = check_counts([eng], "whisper-small paged int8, two waves")
    if set(counts) != {"paged_decode_attention", "flash_attention"}:
        raise AssertionError(f"whisper launched {sorted(counts)}")
    if eng.stats.recompiles != warm:
        raise AssertionError(f"the second whisper wave built "
                             f"{eng.stats.recompiles - warm} new programs")
    for wave, (tps, ms, reqs) in enumerate(waves):
        log(f"whisper-small paged int8 on {smi}, wave {wave + 1}: "
            f"{tps:.1f} tok/s, {ms:.3f} ms/decode step; TTFT by bucket "
            + "; ".join(f"{b}: mean {mean:.1f} ms, max {mx:.1f} ms over {n}"
                        for b, (mean, mx, n) in ttft_by_bucket(
                            eng, reqs).items()))
    log(f"  decode steps {eng.stats.decode_calls}, prefill calls "
        f"{eng.stats.prefill_calls}, programs built {warm}, graph captures "
        f"{captures(eng)}")
    # freeze and thaw one slot mid-wave: the same stream as unfrozen
    prompts = _prompts(8, 85, cfg.vocab_size)
    zero_counts()
    ref = engine()
    ref_reqs = greedy_requests(prompts, 24, rid_base=24000)
    for r in ref_reqs:
        ref.submit(r)
    ref.drain()
    fz = engine()
    reqs = greedy_requests(prompts, 24, rid_base=24000)
    for r in reqs:
        fz.submit(r)
    for _ in range(5):
        fz.step()
    moved = fz.freeze(reqs[3].rid)
    shape = tuple(moved.frozen.leaves["cross_k"].shape)
    if shape != (cfg.num_layers, 1, cfg.encoder_seq_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim) or not fz.thaw(moved):
        raise AssertionError(f"whisper freeze: cross leaves {shape}")
    fz.drain()
    if [r.generated for r in reqs] != [r.generated for r in ref_reqs] \
            or fz.stats.freezes != 1 or fz.stats.thaws != 1:
        raise AssertionError("whisper: a frozen and thawed slot's stream "
                             "differs from the unfrozen run")
    log(f"whisper-small: one slot frozen after 5 steps (cross leaves "
        f"{shape}, kept whole) and thawed: 8 streams equal the unfrozen "
        f"run's, {fz.stats.prefill_calls} prefill calls against "
        f"{ref.stats.prefill_calls}")
    for k, n in check_counts([ref, fz], "whisper freeze/thaw runs").items():
        counts[k] = counts.get(k, 0) + n
    step_repeats(torch, engine(), "whisper-small paged int8")
    graph_vs_eager(torch, engine(), "whisper-small paged int8 step", smi)
    return counts


def encdec_card_vs_cpu(torch):
    """10c: card == CPU in f32 with f32 caches: reduced whisper with
    frames (prefill and 32 greedy decode steps), reduced whisper in the
    engine (``batched``, ``per_slot``, ``paged`` and both swaps), the
    full-width whisper-small with frames on a short prefill and decode
    and through the engine, and reduced internvl2 with patch embeddings
    (``forward`` logits, prefill and greedy decode).  Returns ``{kernel
    name: launches}`` of the card's runs."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.runtime import RuntimeOptions
    totals = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    f32 = RuntimeOptions(kv_cache_dtype="float32")

    def model_streams(cfg, device, toks, steps, **stub):
        """Greedy prefill + decode at model level on ``device``."""
        params = init_params(cfg, seed=0, device=device)
        t = torch.from_numpy(toks).to(device)
        kw = {k: v.to(device) for k, v in stub.items()}
        cache = init_cache(cfg, t.shape[0], t.shape[1] + steps, f32,
                           device=device)
        logits, cache = prefill(params, cfg, t, cache, f32, **kw)
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1).to(
            torch.int32)
        out = [tok]
        for _ in range(steps):
            lg, cache = decode_step(params, cfg, cache, tok, f32)
            tok = torch.argmax(lg[:, :cfg.vocab_size], -1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, 1).cpu(), logits[:, -1].float().cpu(), params

    def held(cfg, toks, steps, what, k2_per_call, k3_per_call=0, **stub):
        zero_counts()
        card, card_lg, _ = model_streams(cfg, "cuda", toks, steps, **stub)
        counts = {name: fn.launches for name, fn in _kernel_fns().items()}
        want = dict.fromkeys(counts, 0)
        want["flash_attention"] = k2_per_call
        want["fused_ffn"] = k3_per_call * (steps + 1)
        if counts != want:
            raise AssertionError(f"{what}: launches {counts}, expected "
                                 f"{want}")
        cpu, cpu_lg, _ = model_streams(cfg, "cpu", toks, steps, **stub)
        err = check_close("prefill logits", card_lg, cpu_lg, LOGITS_TOL,
                          what)
        if not torch.equal(card, cpu):
            raise AssertionError(f"{what}: card and CPU greedy streams "
                                 f"differ:\ncuda {card.tolist()}\ncpu  "
                                 f"{cpu.tolist()}")
        log(f"{what}: card == CPU greedy streams {tuple(card.shape)}, "
            f"last prefill logits max_abs_err {err:.3g}; launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        add(counts)

    rng = np.random.default_rng(93)
    wr = get_config("whisper-small").reduced().with_updates(
        activation_dtype="float32")
    toks = rng.integers(0, wr.vocab_size, (4, 12)).astype(np.int32)
    held(wr, toks, 32, "whisper reduced with frames, f32",
         wr.encoder_layers + 2 * wr.num_layers,
         encoder_frames=whisper_frames(torch, wr, 4, 94))
    wf = get_config("whisper-small").with_updates(activation_dtype="float32")
    toks = rng.integers(0, wf.vocab_size, (2, 8)).astype(np.int32)
    held(wf, toks, 8, "whisper-small full width with frames, f32",
         wf.encoder_layers + 2 * wf.num_layers,
         encoder_frames=whisper_frames(torch, wf, 2, 95))
    vr = get_config("internvl2-26b").reduced().with_updates(
        activation_dtype="float32")
    toks = rng.integers(0, vr.vocab_size, (4, 12)).astype(np.int32)
    vis = torch.from_numpy((rng.standard_normal(
        (4, vr.num_vision_tokens, vr.vision_embed_dim)) * 0.1).astype(
            np.float32))
    held(vr, toks, 16, "internvl2 reduced with patch embeddings, f32",
         vr.num_layers, vr.num_layers, vision_embeds=vis)
    params = init_params(vr, seed=0, device="cuda")
    t = torch.from_numpy(toks)
    zero_counts()
    card = forward(params, vr, t.cuda(), vision_embeds=vis.cuda())[0]
    if {k: fn.launches for k, fn in _kernel_fns().items()
            if fn.launches} != {"flash_attention": vr.num_layers,
                                "fused_ffn": vr.num_layers}:
        raise AssertionError("internvl2 forward: launches")
    add({"flash_attention": vr.num_layers, "fused_ffn": vr.num_layers})
    cpu = forward(to_cpu(params), vr, t, vision_embeds=vis)[0]
    err = check_close("forward logits", card.cpu(), cpu, LOGITS_TOL,
                      "internvl2 reduced forward with patch embeddings")
    log(f"internvl2 reduced forward with patch embeddings card == CPU: "
        f"max_abs_err {err:.3g} (atol {LOGITS_TOL['atol']}, rtol "
        f"{LOGITS_TOL['rtol']})")
    # the engines, as the JAX engine serves whisper (no frames)
    lens = (8, 37, 120, 200)
    paged = dict(decode_mode="paged", opts=RuntimeOptions(
        paged_kernel=True, kv_dtype="int8", kv_cache_dtype="float32"))
    for what, kw in (("batched", dict(decode_mode="batched", opts=f32)),
                     ("per_slot", dict(decode_mode="per_slot", opts=f32)),
                     ("paged int8", paged)):
        keep = []
        zero_counts()
        card_vs_cpu(torch, wr, lens, 24, 96, f"whisper reduced {what}",
                    keep=keep, max_seq=512, **kw)
        add(check_counts(keep, f"whisper reduced {what}"))
    for swap in ("same", "other"):
        keep = []
        zero_counts()
        _, st = card_vs_cpu(torch, wr, (8, 37, 120, 200, 60, 90), 24, 97,
                            f"whisper reduced paged int8, swap_model to the "
                            f"{swap} weights after 4 steps", swap=swap,
                            keep=keep, max_seq=512, **paged)
        if st["requeues"] != 4 or st["thaws"] != (4 if swap == "same"
                                                  else 0):
            raise AssertionError(f"whisper swap ({swap}): {st}")
        add(check_counts(keep, f"whisper reduced swap ({swap})"))
    keep = []
    zero_counts()
    card_vs_cpu(torch, wf, (8, 30, 100), 8, 98, "whisper-small full width "
                "batched, f32 caches", keep=keep, max_seq=256,
                decode_mode="batched", opts=f32)
    add(check_counts(keep, "whisper-small full width, f32"))
    return totals


def phase_encdec(torch, smi):
    """The encoder-decoder and the VLM stub on the card: 10.0 the kernels
    at whisper-small's shapes; 10a whisper-small's
    transcription path at full width in bf16; 10b whisper-small served
    by the engine at full width; 10c card == CPU in f32.  Returns
    ``({kernel name: launches}, {kernel name: timing fields})``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.layers import cast_params, tree_leaves
    t_phase = time.perf_counter()
    extra = encdec_kernels_alone(torch)
    torch.cuda.empty_cache()
    totals = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    cfg = get_config("whisper-small")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = cast_params(init_params(cfg, seed=0, device="cuda"),
                         torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"whisper-small: {n_params / 1e9:.3f} B parameters (param_count() "
        f"{cfg.param_count() / 1e9:.3f} B) drawn from seed 0 on the host, "
        f"moved to the card and cast to bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    add(whisper_transcribe(torch, smi, params, cfg))
    add(whisper_served(torch, smi, params, cfg))
    del params
    torch.cuda.empty_cache()
    add(encdec_card_vs_cpu(torch))
    log(f"encoder-decoder phase: {time.perf_counter() - t_phase:.1f} s")
    return totals, extra


# --------------------------------------------------------------- phase 11
# K6's gradients through its autograd route against autograd through the
# plain version: both differentiate the same f32 graph of the plain scan
# on the card (the route's backward recomputes it), so they differ only
# in the order of reduced sums; bf16 gradients of the conv row are
# rounded to bf16 once on both sides (one bf16 ulp, 2**-8 relative)
GRAD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
            "bfloat16": dict(atol=2e-2, rtol=1e-2)}
TRAIN_SHAPE = (4, 1024)       # zamba2-1.2b's train batch in 11a: B x S


def plain_scan(x, dt, a, b, c, *, chunk):
    """The plain SSD scan as the CPU path computes it (x in f32, y
    rounded to x's dtype)."""
    from repro_torch.kernels.ref import ssd_scan_ref
    y, st = ssd_scan_ref(x.float(), dt, a, b, c, chunk=chunk)
    return y.to(x.dtype), st


def ssd_grad_case(torch, gen, bsz, s, h, p, n, dtype):
    """An ``ssd_case`` whose conv row, dt and a are leaves that require
    grad, x/b/c views of the row, and random output gradients."""
    x, dt, a, bm, cm = ssd_case(torch, gen, bsz, s, h, 1, p, n, dtype)
    row = x._base.detach().requires_grad_()
    x = row[..., :h * p].reshape(bsz, s, h, p)
    bm = row[..., h * p:h * p + n].reshape(bsz, s, 1, n)
    cm = row[..., h * p + n:].reshape(bsz, s, 1, n)
    dy = torch.randn(x.shape, generator=gen).to(x.dtype).cuda()
    dst = torch.randn((bsz, h, p, n), generator=gen).cuda()
    return (row, x, dt.requires_grad_(), a.requires_grad_(), bm, cm, dy,
            dst)


def trainer_kernels_alone(torch):
    """11.0: K6 under autograd at the trainer's shape (zamba2-1.2b, 4 x
    1024, H 64, P 64, N 64, G 1, chunk 256, x/b/c views of a 4224-wide
    row) and at mamba2-370m's (H 32, P 64, N 128), f32 and bf16: the
    gradients of the row, dt and a through the kernel's autograd route
    against autograd through the plain version.  Then K6, K2 (32 heads of
    64, causal) and K3 (gelu, D 2048, F 8192, M 4096) at the trainer's
    bf16 shapes, forward and backward, timed beside their bounds, their
    plain versions and a library call.  Returns the timing fields by
    kernel name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, fused_ffn
    from repro_torch.kernels.flash_attn import flash_attention_backward
    from repro_torch.kernels.fused_ffn import fused_ffn_backward
    from repro_torch.kernels.ref import fused_ffn_ref
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_backward
    gen = torch.Generator().manual_seed(111)
    bsz, s = TRAIN_SHAPE
    out = {"ssd_scan": {}}
    for what, (h, p, n) in (("zamba2", (64, 64, 64)),
                            ("mamba2", (32, 64, 128))):
        for dtype in ("float32", "bfloat16"):
            row, x, dt, a, bm, cm, dy, dst = ssd_grad_case(
                torch, gen, bsz, s, h, p, n, dtype)
            grads = {}
            for route, scan in (("kernel", ssd_scan), ("plain", plain_scan)):
                before = ssd_scan.launches
                y, st = scan(x, dt, a, bm, cm, chunk=256)
                if route == "kernel" and (y.grad_fn is None or
                                          ssd_scan.launches != before + 1):
                    raise AssertionError("ssd_scan under autograd: no "
                                         "grad_fn or no launch")
                grads[route] = torch.autograd.grad([y, st], [row, dt, a],
                                                   [dy, dst])
            case = (f"{what} {bsz} x {s}, H {h}, P {p}, N {n}, {dtype}, "
                    "x/b/c views")
            err = 0.0
            for name, g, ref in zip(("row", "dt", "a"), grads["kernel"],
                                    grads["plain"]):
                tol = GRAD_TOL[dtype] if name == "row" else \
                    GRAD_TOL["float32"]
                err = max(err, check_close("ssd_scan backward", g, ref, tol,
                                           f"d{name}, {case}"))
            if what == "zamba2" and dtype == "bfloat16":
                args = [t.detach() for t in (x, dt, a, bm, cm)]
                out["ssd_scan"].update(
                    bwd_ms=cuda_ms(torch, lambda: ssd_scan_backward(
                        *args, dy, dst, chunk=256), iters=5, warmup=1),
                    bwd_max_abs_err=err)
            del row, x, dt, a, bm, cm, dy, dst, grads, y, st
    log("11.0: K6's autograd route == autograd through the plain scan at "
        "zamba2's and mamba2's shapes, f32 and bf16")

    # the forward kernels and their backwards at the trainer's shapes
    x, dt, a, bm, cm = ssd_case(torch, gen, bsz, s, 64, 1, 64, 64,
                                "bfloat16")
    nbytes, flops = ssd_work(bsz, s, 64, 1, 64, 64, 256, 2, 2)
    out["ssd_scan"].update(_time_kernel(
        torch, lambda: ssd_scan(x, dt, a, bm, cm, chunk=256),
        lambda: plain_scan(x, dt, a, bm, cm, chunk=256), None, "ssd_scan",
        nbytes, flops, iters=20, plain_iters=3))
    del x, dt, a, bm, cm
    q, k, v = flash_case(torch, gen, bsz, 32, 32, s, 64, "bfloat16")
    o = flash_attention(q, k, v)
    do = torch.randn(o.shape, generator=gen).to(o.dtype).cuda()
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    pairs = flash_pairs(s, True, 0, None) * bsz * 32
    k2t = _time_kernel(
        torch, lambda: flash_attention(q, k, v), lambda: flash_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        "flash_attn", 4 * q.numel() * q.element_size(), 4 * 64 * pairs)
    k2t.update(
        bwd_ms=cuda_ms(torch, lambda: flash_attention_backward(
            q, k, v, o, do), iters=10, warmup=2),
        library_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            lib, (qg, kg, vg), do, retain_graph=True), iters=10, warmup=2))
    out["flash_attention"] = k2t
    del q, k, v, o, do, qg, kg, vg, lib
    m = bsz * s
    x, wg, wu, wd = ffn_case(torch, gen, m, 2048, 8192, "bfloat16")
    dy = torch.randn((m, 2048), generator=gen).to(x.dtype).cuda()
    xg, wgg, wug, wdg = (t.detach().requires_grad_() for t in (x, wg, wu,
                                                               wd))
    chain = (F.gelu(xg @ wgg, approximate="tanh") * (xg @ wug)) @ wdg
    k3t = _time_kernel(
        torch, lambda: fused_ffn(x, wg, wu, wd, "gelu"),
        lambda: fused_ffn_ref(x, wg, wu, wd, "gelu"), None, "fused_ffn",
        (2 * x.numel() + wg.numel() + wu.numel() + wd.numel())
        * x.element_size(), 6 * m * 2048 * 8192, iters=10, plain_iters=2)
    k3t.update(
        chain_ms=cuda_ms(torch, lambda: (F.gelu(x @ wg, approximate="tanh")
                                         * (x @ wu)) @ wd, iters=10),
        bwd_ms=cuda_ms(torch, lambda: fused_ffn_backward(
            x, wg, wu, wd, dy, "gelu"), iters=5, warmup=1),
        library_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            chain, (xg, wgg, wug, wdg), dy, retain_graph=True), iters=5,
            warmup=1))
    out["fused_ffn"] = k3t
    del x, wg, wu, wd, dy, xg, wgg, wug, wdg, chain
    for name, t in out.items():
        log(f"{name} at the trainer's shape: kernel_ms {t['ms']:.4f} "
            f"device {fmt(t['device_ms'])}; plain_ms {t['plain_ms']:.4f}; "
            + (f"library {t['library_ms']:.4f} ms; " if t["library_ms"]
               else "")
            + (f"cuBLAS chain {t['chain_ms']:.4f} ms; " if "chain_ms" in t
               else "")
            + f"bound_ms {t['bound_ms']:.5f} ({t['bound_by']}); backward "
            f"{t['bwd_ms']:.4f} ms"
            + (f" (library's backward {t['library_bwd_ms']:.4f} ms)"
               if "library_bwd_ms" in t else ""))
    return {name: {f"{key}_trainer": val for key, val in t.items()}
            for name, t in out.items()}


def bits(t):
    """A tensor's raw bits, for bit-for-bit comparisons."""
    import torch
    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[t.element_size()])


def same_bits(a, b):
    from repro_torch.checkpoint import flatten_with_keys
    fa, fb = dict(flatten_with_keys(a)), dict(flatten_with_keys(b))
    return sorted(fa) == sorted(fb) and all(
        fa[k].dtype == fb[k].dtype and bool((bits(fa[k]) == bits(fb[k])
                                             .to(fa[k].device)).all())
        for k in fa)


def meta_like(torch, tree):
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def exact_counts(expect, what):
    """The launches since the last ``zero_counts`` must be ``expect`` (any
    kernel not named: 0).  Returns the non-zero counts."""
    counts = {name: fn.launches for name, fn in _kernel_fns().items()}
    want = {name: expect.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    log(f"{what}: launches {({k: n for k, n in counts.items() if n})}")
    return {k: n for k, n in counts.items() if n}


def profile_parts(torch, fn, reps=2):
    """Device ms of one call of ``fn`` (the profiler's kernel sum over
    ``reps`` calls after one warm call), and of the port's K2, K3 and K6
    in it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    ours = {k: sum(e.self_device_time_total for e in kernels
                   if part in e.key) / 1e3 / reps
            for k, part in PROFILED_KERNELS.items()}
    return total, ours


def train_split(torch, cfg, opts, params, opt_state, batch):
    """One train step's device time split into its forward (the port's
    kernels and the rest), its backward (autograd: the kernels' PyTorch-op
    backwards and the rest) and the optimizer, each by the profiler,
    mirroring ``make_train_step``."""
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import forward, lm_loss
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import warmup_cosine
    p = tree_map(lambda t: t.detach().requires_grad_(t.is_floating_point()),
                 params)
    leaves = [t for t in tree_leaves(p) if t.requires_grad]

    def fwd():
        logits, aux = forward(p, cfg, batch["tokens"], opts)
        return lm_loss(logits, batch["labels"]) + cfg.router_aux_weight * aux

    def fwd_bwd():
        return torch.autograd.grad(fwd(), leaves)

    grads = iter(fwd_bwd())
    grads = tree_map(lambda t: next(grads), p)
    f_ms, f_ours = profile_parts(torch, fwd)
    fb_ms, _ = profile_parts(torch, fwd_bwd)
    with torch.no_grad():
        o_ms, _ = profile_parts(torch, lambda: adamw.apply(
            grads, params, opt_state, lr_scale=warmup_cosine(
                opt_state.step)))
    return f_ms, f_ours, fb_ms - f_ms, o_ms


def zamba2_trained(torch, smi):
    """11a: full-width zamba2-1.2b (1.105 B parameters, nothing cut)
    trained by ``train_loop`` for 6 steps at 4 x 1024 tokens, bf16
    activations over f32 weights and AdamW, checkpointed at the end.
    Returns ``{kernel name: launches}``."""
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, place_batch
    from repro_torch.launch.steps import make_train_step, options_for
    from repro_torch.launch.train import train_loop
    from repro_torch.models.configs import InputShape
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import _n_shared_sites
    from repro_torch.optim import adamw
    cfg = get_config("zamba2-1.2b")
    bsz, s = TRAIN_SHAPE
    shape, steps = InputShape("cli", s, bsz, "train"), 6
    sites = _n_shared_sites(cfg)
    per_step = {"ssd_scan": cfg.num_layers, "flash_attention": sites,
                "fused_ffn": sites}
    rec = {"t": [], "loss": [], "gnorm": []}

    def callback(i, params, opt_state, metrics):
        torch.cuda.synchronize()
        rec["t"].append(time.perf_counter())
        rec["loss"].append(float(metrics["loss"]))
        rec["gnorm"].append(float(metrics["grad_norm"]))
        return params, opt_state

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    totals = {}
    zero_counts()
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        out = train_loop(cfg, shape, steps, log_every=1, checkpoint_dir=td,
                         callback=callback)
        t_end = time.perf_counter()
        totals.update(exact_counts({k: n * steps for k, n in
                                    per_step.items()},
                                   f"zamba2-1.2b train_loop, {steps} steps"))
        peak = torch.cuda.max_memory_allocated()
        params = out["params"]
        n_params = sum(t.numel() for t in tree_leaves(params))
        if not all(map(math.isfinite, rec["loss"] + rec["gnorm"])) or \
                min(rec["gnorm"]) <= 0:
            raise AssertionError(f"zamba2 training: losses {rec['loss']}, "
                                 f"grad norms {rec['gnorm']}")
        ckpt = Path(td) / f"step_{steps:06d}"
        ck_bytes = sum(f.stat().st_size for f in ckpt.iterdir())
        save_s = t_end - rec["t"][-1]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        restored, step = restore_checkpoint(ckpt, meta_like(torch, params))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        if step != steps or not same_bits(restored, params):
            raise AssertionError("zamba2 checkpoint does not restore bit "
                                 "for bit")
        del restored
    step_s = [b - a for a, b in zip(rec["t"], rec["t"][1:])]
    log(f"zamba2-1.2b trained on {smi}: {n_params / 1e9:.3f} B parameters, "
        f"{steps} steps of {bsz} x {s} tokens; losses "
        + ", ".join(f"{x:.4f}" for x in rec["loss"]) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in rec["gnorm"])
        + f"; init + first step {rec['t'][0] - t0:.1f} s, then host "
        f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms a step; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; checkpoint "
        f"{ck_bytes / 1e9:.3f} GB saved in {save_s:.2f} s, restored bit "
        f"for bit in {restore_s:.2f} s")

    # one make_train_step call from a fresh AdamW state: m = (1 - b1) *
    # clip * grad, so every floating leaf (each layer of each stacked
    # leaf) must have a non-zero m — a_log and dt_bias get theirs only
    # through K6's backward
    opts = options_for(cfg, shape, {"remat": "none"})
    batch = place_batch(SyntheticLM(DataConfig(
        cfg.vocab_size, s, bsz)).batch(steps), "cuda")
    state = adamw.init(params)
    zero_counts()
    _, state1, metrics = make_train_step(cfg, opts)(params, state, batch)
    for k, n in exact_counts(per_step, "zamba2-1.2b one make_train_step "
                             "call").items():
        totals[k] = totals.get(k, 0) + n
    from repro_torch.checkpoint import flatten_with_keys
    zero = []
    for key, m in flatten_with_keys(state1.m):
        rows = m.reshape(m.shape[0], -1) if key.startswith("layers/") \
            else m.reshape(1, -1)
        if not bool((rows.abs().sum(dim=1) > 0).all()):
            zero.append(key)
    if zero:
        raise AssertionError(f"zamba2: zero gradient in {zero}")
    log(f"zamba2-1.2b: every floating leaf got a non-zero gradient, each "
        f"Mamba layer's in_proj, conv_w, conv_b, dt_bias and a_log "
        f"included ({len(list(flatten_with_keys(state1.m)))} leaves; grad "
        f"norm {float(metrics['grad_norm']):.3f})")
    del state1, metrics
    f_ms, f_ours, b_ms, o_ms = train_split(torch, cfg, opts, params, state,
                                           batch)
    kern = f_ours["K6"] + f_ours["K2"] + f_ours["K3"]
    log(f"zamba2-1.2b train step device split on {smi}: forward "
        f"{f_ms:.2f} ms (K6 {f_ours['K6']:.2f} + K2 {f_ours['K2']:.3f} + K3 "
        f"{f_ours['K3']:.2f} = {kern:.2f} in the port's kernels, the rest "
        f"{f_ms - kern:.2f}), backward {b_ms:.2f} ms (autograd, the "
        f"kernels' PyTorch-op backwards), optimizer {o_ms:.2f} ms; "
        f"device {f_ms + b_ms + o_ms:.2f} ms against a host step of "
        f"{1e3 * min(step_s):.1f}–{1e3 * max(step_s):.1f} ms")
    del params, state, out
    torch.cuda.empty_cache()
    return totals


def serve_segments(torch, cfg, params):
    """``launch.serve``'s loop on the card (16 requests, 4 slots, adapt
    every 8 steps), with each binding the engine served under (its
    variant and the engine's decode steps and prefill calls under it)
    recorded around ``swap_model``.  Returns the loop's result and the
    launches expected of its K2 and K3."""
    from repro_torch.launch.serve import serve_loop
    from repro_torch.serving import ServingEngine
    segs = []
    swap = ServingEngine.swap_model

    def recording(self, vcfg, vparams, opts, **kw):
        segs.append((self.cfg, self.params, self.stats.decode_calls,
                     self.stats.prefill_calls))
        return swap(self, vcfg, vparams, opts, **kw)

    ServingEngine.swap_model = recording
    try:
        out = serve_loop(cfg, params, requests=16, slots=4, adapt_every=8,
                         device="cuda")
    finally:
        ServingEngine.swap_model = swap
    eng = out["engine"]
    segs.append((eng.cfg, eng.params, eng.stats.decode_calls,
                 eng.stats.prefill_calls))
    expect = {"flash_attention": 0, "fused_ffn": 0}
    d0 = p0 = 0
    for vcfg, vparams, d, p in segs:
        n = vcfg.num_layers
        expect["flash_attention"] += (p - p0) * n
        if dense_gated(vcfg, vparams):
            expect["fused_ffn"] += (p - p0 + d - d0) * n
        d0, p0 = d, p
    return out, expect, len(segs) - 1


def backbone_trained(torch, smi):
    """11b: full-width paper-backbone trained by ``train_loop`` with
    ``launch/train.py``'s defaults (100 steps, batch 8, seq 256),
    checkpointed, restored into a fresh tree and served through
    ``launch/serve.py``'s loop; a greedy wave from the restored weights
    equals the wave from the trained weights.  Returns ``{kernel name:
    launches}``."""
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.models import init_params
    from repro_torch.models.configs import InputShape
    from repro_torch.serving import CompileCache, ServingEngine
    cfg = get_config("paper-backbone")
    steps, n = 100, cfg.num_layers
    totals = {}

    def add(counts):
        for k, c in counts.items():
            totals[k] = totals.get(k, 0) + c

    zero_counts()
    with tempfile.TemporaryDirectory() as td:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_loop(cfg, InputShape("cli", 256, 8, "train"), steps,
                         checkpoint_dir=td)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        add(exact_counts({"flash_attention": n * steps,
                          "fused_ffn": n * steps},
                         f"paper-backbone train_loop, {steps} steps"))
        first, last = out["losses"][0][1], out["losses"][-1][1]
        if not last < first:
            raise AssertionError(f"paper-backbone: loss {first} -> {last}")
        fresh = init_params(cfg, seed=1, device="cuda")
        restored, _ = restore_checkpoint(Path(td) / f"step_{steps:06d}",
                                         fresh)
        if not same_bits(restored, out["params"]) or same_bits(fresh,
                                                               restored):
            raise AssertionError("paper-backbone checkpoint does not "
                                 "restore bit for bit")
    log(f"paper-backbone trained on {smi}: loss {first:.4f} -> {last:.4f} "
        f"in {steps} steps of 8 x 256 tokens, {train_s:.1f} s "
        f"({1e3 * train_s / steps:.1f} ms a step with the init); restored "
        "bit for bit into a fresh tree")
    zero_counts()
    served, expect, swaps = serve_segments(torch, cfg, restored)
    eng = served["engine"]
    if eng.stats.tokens_out != 16 * 12 or any(
            len(r.generated) != 12 for r in served["requests"]):
        raise AssertionError(f"serve loop: {eng.stats.tokens_out} tokens")
    add(exact_counts(expect, f"launch.serve loop on the restored weights "
                     f"({swaps} swaps)"))
    log(f"launch.serve loop on {smi}: 16 requests, {eng.stats.tokens_out} "
        f"tokens in {served['seconds']:.2f} s, {eng.stats.steps} steps, "
        f"{eng.stats.prefills} prefills, {eng.generation} variant swaps")
    zero_counts()
    prompts = greedy_prompts(77, cfg.vocab_size, (8, 40, 120, 200, 17, 64))
    streams, engines = [], []
    for params in (restored, out["params"]):
        eng = ServingEngine(cfg, params, slots=4, max_seq=256,
                            compile_cache=CompileCache(), device="cuda")
        reqs = greedy_requests(prompts, 16)
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams.append([tuple(r.generated) for r in reqs])
        engines.append(eng)
    if streams[0] != streams[1]:
        raise AssertionError("greedy waves differ between the restored and "
                             "the trained weights")
    add(check_counts(engines, "paper-backbone greedy waves, restored and "
                     "trained weights"))
    log("paper-backbone: the greedy wave from the restored weights == the "
        "wave from the trained weights (6 requests x 16 tokens)")
    return totals


def train_card_vs_cpu(torch):
    """11c: two ``make_train_step`` calls on the card and on the CPU from
    the same f32 weights and batches (2 x 300 tokens: two chunks, the
    second ragged), reduced zamba2 (d 256, 5 layers, period 2) and
    reduced mamba2-370m: the loss, the gradient norm, every gradient leaf
    (AdamW's first moment after the first call, (1 - b1) x clip x grad)
    and the parameters after the second.  Returns ``{kernel name:
    launches}`` of the card's calls."""
    from repro_torch.checkpoint import flatten_with_keys
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, place_batch
    from repro_torch.launch.steps import make_train_step, options_for
    from repro_torch.models import init_params
    from repro_torch.models.configs import InputShape
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import _n_shared_sites
    from repro_torch.optim import adamw
    totals = {}
    shape = InputShape("t", 300, 2, "train")
    cfgs = (("zamba2 reduced (d 256, 5 layers, period 2)",
             get_config("zamba2-1.2b").reduced(num_layers=5).with_updates(
                 shared_attn_period=2, activation_dtype="float32")),
            ("mamba2-370m reduced", get_config("mamba2-370m").reduced()
             .with_updates(activation_dtype="float32")))
    lr = adamw.AdamWConfig().lr
    for what, cfg in cfgs:
        step = make_train_step(cfg, options_for(cfg, shape,
                                                {"remat": "none"}))
        data = SyntheticLM(DataConfig(cfg.vocab_size, shape.seq_len, 2))
        p_cpu = init_params(cfg, seed=0, device="cpu")
        p_card = tree_map(lambda t: t.cuda(), p_cpu)
        s_cpu, s_card = adamw.init(p_cpu), adamw.init(p_card)
        zero_counts()
        worst = 0.0
        for i in range(2):
            b = data.batch(i)
            p_card, s_card, m_card = step(p_card, s_card,
                                          place_batch(b, "cuda"))
            p_cpu, s_cpu, m_cpu = step(p_cpu, s_cpu, place_batch(b, "cpu"))
            for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-4)):
                a, c = float(m_card[key]), float(m_cpu[key])
                if abs(a - c) > rtol * abs(c):
                    raise AssertionError(f"{what} step {i}: {key} card {a} "
                                         f"CPU {c}")
            if i == 0:
                cpu_m = dict(flatten_with_keys(s_cpu.m))
                for key, g in flatten_with_keys(s_card.m):
                    ref = cpu_m[key]
                    scale = float(ref.abs().max())
                    err = float((g.cpu() - ref).abs().max())
                    if err > GRAD_REL_TOL * scale + 1e-12:
                        raise AssertionError(f"{what}: gradient of {key} "
                                             f"card vs CPU max err {err} of "
                                             f"max {scale}")
                    worst = max(worst, err / max(scale, 1e-30))
        # AdamW moves an element by ~lr x warmup_cosine(step) whatever its
        # gradient, so a rounding-level gradient can land 2 lr x scale apart
        cpu_p = dict(flatten_with_keys(p_cpu))
        for key, t in flatten_with_keys(p_card):
            err = float((t.cpu() - cpu_p[key]).abs().max())
            if err > 2 * lr * 0.01 + 1e-6:
                raise AssertionError(f"{what}: parameter {key} card vs CPU "
                                     f"max err {err} after two steps")
        n = cfg.num_layers
        sites = _n_shared_sites(cfg)
        for k, c in exact_counts({"ssd_scan": 2 * n,
                                  "flash_attention": 2 * sites,
                                  "fused_ffn": 2 * sites},
                                 f"{what}, two train steps").items():
            totals[k] = totals.get(k, 0) + c
        log(f"{what}: card == CPU in f32 over two train steps (loss, grad "
            f"norm, {len(cpu_m)} gradient leaves, worst error {worst:.3g} "
            f"of the leaf's largest gradient (tolerance {GRAD_REL_TOL}); "
            "parameters)")
    return totals


def baselines_on_card(torch, smi):
    """11d: the variants that ``HANDCRAFTED``, ``adadeep_select`` (at 0.5
    and 0.25 of the full model's estimated latency) and ``ofa_select``
    (width x depth grid, 0.5) choose for full-width paper-backbone, run
    through ``Middleware.infer`` on the card in bf16 and in f32 (exact K2
    and K3 per ``infer``); the f32 logits equal the same variant's (its
    weights derived on the card, copied) on the CPU.  Returns ``{kernel
    name: launches}``."""
    from repro_torch.baselines import HANDCRAFTED, adadeep_select, ofa_select
    from repro_torch.configs import get_config
    from repro_torch.core import (Action, ActionEvaluator, Middleware,
                                  ResourceContext)
    from repro_torch.core.loop import Decision
    from repro_torch.elastic import VariantSpec
    from repro_torch.models import forward, init_params
    from repro_torch.models.configs import InputShape
    from repro_torch.models.layers import cast_params
    cfg = get_config("paper-backbone")
    shape = InputShape("app", 256, 4, "prefill")
    ev = ActionEvaluator(cfg, shape)
    full = ev.evaluate(Action(), ResourceContext()).latency_s
    chosen = dict(HANDCRAFTED)
    for frac in (0.5, 0.25):
        chosen[f"adadeep@{frac}"] = adadeep_select(cfg, shape, full * frac,
                                                   ev)
    chosen["ofa@0.5"] = ofa_select(
        cfg, shape, full * 0.5, [VariantSpec(width_ratio=w, depth_ratio=d)
                                 for w in (1.0, 0.75, 0.5)
                                 for d in (1.0, 0.75, 0.5)], ev)
    tokens = torch.stack([torch.from_numpy(p) for p in greedy_prompts(
        5, cfg.vocab_size, (256,) * 4)]).cuda()
    params = init_params(cfg, seed=0, device="cuda")
    mws = {"bf16": Middleware(cfg=cfg, params=cast_params(
               params, torch.bfloat16), shape=shape, allow_offload=False),
           "f32": Middleware(cfg=cfg.with_updates(activation_dtype="float32"),
                             params=params, shape=shape,
                             allow_offload=False)}
    fns = _kernel_fns()
    totals = dict.fromkeys(fns, 0)
    worst = 0.0
    for name, spec in chosen.items():
        for which, mw in mws.items():
            mw.loop.current = Decision(tick=-1, ctx=ResourceContext(),
                                       action=Action(variant=spec),
                                       eval=None, reason=name)
            vcfg, vparams, _ = mw.current_runtime()
            before = {k: fn.launches for k, fn in fns.items()}
            logits = mw.infer(tokens)
            delta = {k: fn.launches - before[k] for k, fn in fns.items()}
            expect = expected_launches(vcfg, vparams)
            if delta != expect:
                raise AssertionError(f"baseline {name} ({which}): launches "
                                     f"{delta}, expected {expect}")
            totals = {k: c + expect[k] for k, c in totals.items()}
            if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
                raise AssertionError(f"baseline {name} ({which}): logits "
                                     "not finite")
        cpu = forward(to_cpu(vparams), vcfg, tokens.cpu())[0]
        worst = max(worst, check_close(
            "baseline variant", logits.cpu(), cpu, LOGITS_TOL,
            f"{name} ({spec_name(spec)}) card vs CPU, f32"))
        log(f"  baseline {name:12s} {spec_name(spec)}: K2 "
            f"{expect['flash_attention']}, K3 {expect['fused_ffn']} an "
            "infer")
    log(f"11d: {len(chosen)} baseline variants through Middleware.infer on "
        f"{smi} (bf16 and f32) with exact launches; card == CPU in f32, "
        f"logits within {worst:.3g} (atol {LOGITS_TOL['atol']}, rtol "
        f"{LOGITS_TOL['rtol']})")
    return {k: c for k, c in totals.items() if c}


def planner_run():
    """11e: ``launch/dryrun.py --arch all --shape all`` into a temporary
    directory, without JAX."""
    import tempfile
    from repro_torch.launch import dryrun
    with tempfile.TemporaryDirectory() as td:
        argv = sys.argv
        sys.argv = ["dryrun", "--arch", "all", "--shape", "all", "--out", td]
        try:
            dryrun.main()
        except SystemExit as e:
            code = e.code
        finally:
            sys.argv = argv
        recs = [json.loads(p.read_text()) for p in Path(td).glob("*.json")]
    if code != 0 or len(recs) != 40 or any(r["status"] != "ok"
                                           for r in recs):
        raise AssertionError(f"planner: exit {code}, {len(recs)} records")
    if any(m.split(".")[0] == "jax" for m in sys.modules):
        raise AssertionError("the planner imported JAX")
    fits = sorted(f"{r['arch']}:{r['shape']}" for r in recs if r["fits"])
    log(f"11e: the one-card planner wrote 40 records (arch x shape), no "
        f"JAX; fits 80 GB without activations: {', '.join(fits)}")


def phase_trainer(torch, smi):
    """The trainer on the card: 11.0 K6's gradient and the kernels at the
    trainer's shapes; 11a full-width zamba2-1.2b trained; 11b full-width
    paper-backbone trained, checkpointed, restored and served; 11c card
    == CPU train steps in f32; 11d the baselines; 11e the planner.
    Returns ``({kernel name: launches}, {kernel name: timing fields})``."""
    t_phase = time.perf_counter()
    extra = trainer_kernels_alone(torch)
    torch.cuda.empty_cache()
    totals = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    add(zamba2_trained(torch, smi))
    add(backbone_trained(torch, smi))
    add(train_card_vs_cpu(torch))
    add(baselines_on_card(torch, smi))
    planner_run()
    log(f"trainer phase: {time.perf_counter() - t_phase:.1f} s")
    return totals, extra


# --------------------------------------------------------------- phase 12
VLM_BUCKET = 512             # 12a's prompts: 256 patches, then text


def vlm_kernels_alone(torch):
    """12.0: K1 at internvl2-26b's paged decode (8 slots x 48 heads of
    128 over 8 KV heads: group 6; int8 pool, mb 64), K2 at its prefill
    (8 x 512 tokens, 48 / 8 heads of 128, causal) and K3 at its FFN
    (silu, D 6144, F 16384 at M 8, 2048 and the prefill's 4096), each
    against its plain version and repeating bit for bit, then timed
    beside its bound, its plain version and SDPA (K1, K2) or the unfused
    cuBLAS chain (K3).  Returns the timing fields for the kernels line,
    by kernel name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, fused_ffn
    from repro_torch.kernels.fused_ffn import ffn_plan
    from repro_torch.kernels.ref import fused_ffn_ref, paged_decode_attn_ref
    gen = torch.Generator().manual_seed(2600)
    times = {}
    # K1 at group 6, which no earlier phase runs
    err = 0.0
    for pos_kind in ("ragged", "full_tail", "short"):
        args, sc = make_case(torch, gen, slots=8, heads=48, kvh=8, hd=128,
                             bs=16, mb=64, pool_dtype="int8",
                             q_dtype="bfloat16", pos_kind=pos_kind)
        err = max(err, check_close(
            "paged_decode_attention", k1_repeated(torch, args, sc, 0),
            paged_decode_attn_ref(*args, **sc), TOL["bfloat16"],
            f"internvl2 decode, group 6, pos {pos_kind}"))
    times["k1"] = dict(k1_times(torch, args, sc), max_abs_err=err)
    del args, sc
    # K2 at the prefill bucket: 8 x 512, 48 heads over 8 KV heads
    q, k, v = flash_case(torch, gen, 8, 48, 8, VLM_BUCKET, 128, "bfloat16")
    out = flash_attention(q, k, v)
    err = check_close("flash_attention", out, flash_plain(q, k, v),
                      TOL["bfloat16"], "internvl2 prefill 8 x 512, 48/8 "
                      "heads of 128")
    if not torch.equal(out, flash_attention(q, k, v)):
        raise AssertionError("flash_attention does not repeat at 8 x 512, "
                             "48/8 heads of 128")
    # SDPA's yardstick over K/V repeated to 48 heads beforehand
    kr, vr = k.repeat_interleave(6, 1), v.repeat_interleave(6, 1)
    pairs = flash_pairs(VLM_BUCKET, True, 0, None) * 8 * 48
    times["k2"] = _time_kernel(
        torch, lambda: flash_attention(q, k, v), lambda: flash_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True),
        "flash_attn", (2 * q.numel() + 2 * k.numel()) * 2, 4 * 128 * pairs)
    times["k2"]["max_abs_err"] = err
    del q, k, v, kr, vr, out
    # K3 at the FFN: a decode step, PERF.md's prefill row, the prefill
    for m in (8, 2048, 8 * VLM_BUCKET):
        x, wg, wu, wd = ffn_case(torch, gen, m, 6144, 16384, "bfloat16")
        route = ffn_plan(x.dtype, m, 6144, 16384).route
        out = fused_ffn(x, wg, wu, wd)
        err = check_close("fused_ffn", out, fused_ffn_ref(x, wg, wu, wd),
                          FFN_TOL["bfloat16"], f"internvl2 M {m}, D 6144, F "
                          f"16384 ({route})")
        if not torch.equal(out, fused_ffn(x, wg, wu, wd)):
            raise AssertionError(f"fused_ffn does not repeat at M {m}, "
                                 "D 6144")
        times[f"ffn{m}"] = dict(k3_times(torch, x, wg, wu, wd, "silu"),
                                max_abs_err=err)
        del x, wg, wu, wd, out
    log_times(times, {
        "k1": "K1, internvl2-26b paged decode (8 slots x 48 heads of 128 "
              "over 8, group 6, int8, mb 64)",
        "k2": "K2, internvl2-26b prefill (8 x 512, 48/8 heads of 128, "
              "causal)",
        "ffn8": "K3, internvl2-26b FFN (M 8, D 6144, F 16384)",
        "ffn2048": "K3, internvl2-26b FFN (M 2048, D 6144, F 16384)",
        "ffn4096": "K3, internvl2-26b FFN (M 4096 = 8 x 512, D 6144, F "
                   "16384)"})
    log("phase 12 shapes: K1 (group 6, hd 128), K2 (8 x 512, 48/8 heads of "
        "128) and K3 (D 6144, F 16384 at M 8, 2048 and 4096) == plain "
        "versions, each repeating bit for bit")
    extra = {"paged_decode_attention": {}, "flash_attention": {},
             "fused_ffn": {}}
    for key, t in times.items():
        name, suffix = {
            "k1": ("paged_decode_attention", "_internvl2"),
            "k2": ("flash_attention", "_internvl2"),
            "ffn8": ("fused_ffn", "_internvl2"),
            "ffn2048": ("fused_ffn", "_internvl2_m2048"),
            "ffn4096": ("fused_ffn", "_internvl2_m4096")}[key]
        extra[name].update({f"{k}{suffix}": v for k, v in t.items()})
    return extra


def card_params(torch, cfg, dtype=None):
    """``cfg``'s weight tree drawn straight onto the card, leaf by leaf in
    ``init_params``'s order, from a CUDA generator seeded 0, in ``dtype``
    (bf16 by default): the host's f32 draw of a full-width tree (77 GB
    for internvl2-26b, 136 GB for qwen1.5-32b) would not fit the card
    beside its cast, and takes minutes on the host."""
    from repro_torch.models.transformer import param_tree
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(shape, std, dt=dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=dt).mul_(std)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device="cuda")

    # a Mamba stack's constant leaves (a_log, d_skip) are made on the host
    return tree_to(param_tree(cfg, normal, zeros), "cuda")


def tree_bytes(tree):
    from repro_torch.models.layers import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def vlm_prefill_decode(torch, smi, params, cfg):
    """12a: the VLM path at model level, bf16: ``prefill`` of 8 prompts of
    512 positions, the first 256 of them stub patch embeddings of width
    3200 (``vision_embeds``), then 64 greedy ``decode_step``s over the
    dense cache.  K2 48 and K3 48 a prefill call, K3 48 a step, nothing
    else; the whole run repeats bit for bit (logits and tokens); the
    prefill's device ms, the decode step's host and device ms, its device
    split and byte bound.  Returns ``{kernel name: launches}``."""
    import numpy as np
    from repro_torch.models.model import decode_step, init_cache, prefill
    b, steps, n = 8, 64, cfg.num_layers
    max_seq = VLM_BUCKET + steps
    rng = np.random.default_rng(120)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, VLM_BUCKET)).astype(np.int32)).cuda()
    vis = torch.from_numpy((rng.standard_normal(
        (b, cfg.num_vision_tokens, cfg.vision_embed_dim)) * 0.1).astype(
            np.float32)).cuda()

    def run_prefill():
        return prefill(params, cfg, tokens, init_cache(cfg, b, max_seq),
                       vision_embeds=vis)

    def run():
        logits, cache = run_prefill()
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1).to(
            torch.int32)
        streams = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, cache = decode_step(params, cfg, cache, tok)
            tok = torch.argmax(lg[:, :cfg.vocab_size], -1).to(torch.int32)
            streams.append(tok)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        return logits, torch.stack(streams, 1), cache, lg, step_ms

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, toks, cache, lg, step_ms = run()
    wall_s = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in _kernel_fns().items()}
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=n, fused_ffn=n * (1 + steps))
    if counts != want:
        raise AssertionError(f"internvl2 prefill + {steps} decode steps: "
                             f"launches {counts}, expected {want}")
    if tuple(logits.shape[:2]) != (b, VLM_BUCKET) or int(cache["pos"]) \
            != VLM_BUCKET + steps or not bool(torch.isfinite(
                logits[..., :cfg.vocab_size].float()).all()) \
            or not bool(torch.isfinite(lg[:, :cfg.vocab_size].float()).all()) \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("internvl2 prefill/decode: bad logits, "
                             "positions or tokens")
    logits2, toks2, _, _, _ = run()
    if not (torch.equal(logits, logits2) and torch.equal(toks, toks2)):
        raise AssertionError("internvl2 prefill + decode does not repeat "
                             "bit for bit")
    log(f"internvl2-26b VLM path on {smi}: prefill of {b} x {VLM_BUCKET} "
        f"positions ({cfg.num_vision_tokens} patch embeddings of width "
        f"{cfg.vision_embed_dim}, then text) returning all positions' "
        f"logits {tuple(logits.shape)} {logits.dtype}, then {steps} greedy "
        f"decode steps: {wall_s:.2f} s host for the first run, "
        f"{step_ms:.3f} ms/step host; launches {counts} (K2 and K3 48 a "
        f"prefill call, K3 48 a step); the run repeats bit for bit "
        f"(logits and {tuple(toks.shape)} tokens); "
        f"{len(set(toks[:, 1:].flatten().tolist()))} distinct tokens")
    del logits2, toks2
    pre_ms = cuda_ms(torch, run_prefill, 3, 1)
    pre_dev = device_ms(torch, run_prefill, iters=3, tries=3)
    pos_t = cache["pos"].clone()
    tok = toks[:, -1].contiguous()

    def fixed_step():
        # rewrites row pos each time: the work of a step at that depth
        cache["pos"].copy_(pos_t)
        return decode_step(params, cfg, cache, tok)[0]

    busy, _, attn, mm, k3 = decode_split(torch, fixed_step, None, max_seq)
    weights = tree_bytes(params)
    _, _, _, kvh, hd = cache["k"].shape
    kv = 2 * n * b * (int(pos_t) + 1) * kvh * hd * cache["k"].element_size()
    bound_ms = 1e3 * (weights + kv) / H100_BYTES_PER_S
    log(f"  prefill ({b} x {VLM_BUCKET}): {pre_ms:.2f} ms (CUDA events), "
        f"device {fmt(pre_dev)}; decode step at pos {int(pos_t)}, {b} rows: "
        f"host {step_ms:.3f} ms, device {busy:.3f} ms (idle share "
        f"{1 - busy / step_ms:.3f}) = K3 {k3:.3f} + attention {attn:.3f} + "
        f"weight products {mm:.3f} + the rest {busy - k3 - attn - mm:.3f}; "
        f"byte bound {bound_ms:.3f} ms ({weights / 1e9:.2f} GB of weights, "
        f"the tree's bytes, and {kv / 1e6:.1f} MB of K/V, at "
        f"{H100_BYTES_PER_S / 1e12:.2f} TB/s): the step at "
        f"{bound_ms / busy:.3f} of the bound on the device")
    return {k: c for k, c in counts.items() if c}


def paged_split(torch, step, reps=SPLIT_REPS):
    """Device time of an eager paged decode step split into K3 (the
    ``fused_ffn`` kernels), K1 (``paged_decode``), the weight products
    (top-level ``aten::matmul``/``aten::mm``: the attention projections
    and the tied LM head) and the rest, from one profile.  Returns
    ``(busy, k3, k1, matmuls)`` in ms a step."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    matmuls = sum(ev.device_time_total for ev in prof.events()
                  if ev.cpu_parent is None
                  and ev.name in ("aten::matmul", "aten::mm")) / 1e3 / reps
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]

    def ms(part):
        return sum(ev.self_device_time_total for ev in kernels
                   if part in ev.key) / 1e3 / reps

    busy, k3, k1 = ms(""), ms("fused_ffn"), ms("paged_decode")
    if min(k3, k1, matmuls) <= 0:
        raise RuntimeError(f"the paged step's split found K3 {k3}, K1 {k1}, "
                           f"products {matmuls} ms")
    return busy, k3, k1, matmuls


def served_paged(torch, smi, params, cfg, *, what, max_seq, lo, hi, seed,
                 rid, n=12, new_tokens=64, pool_blocks=None, steps=16):
    """``cfg`` served as the JAX engine serves it: paged,
    ``paged_kernel=True``, ``kv_dtype="int8"``, 8 slots, block 16, two
    waves of ``n`` requests of ``lo``..``hi`` tokens x ``new_tokens`` new
    tokens, through a pool of ``pool_blocks`` blocks (the engine's default,
    8 slots' tables, when None).  Exact K1 (``num_layers`` a step), K2 (a
    prefill call) and K3
    (a call and a step) launches, replays included; no new program on the
    second wave; the step captured once; a whole step repeating bit for
    bit, whose eager device time is split (:func:`paged_split`) beside
    its byte bound (:func:`step_bytes` at 8 busy slots); graph == eager
    on clones, timed over ``steps`` steps each.  Returns
    ``{kernel name: launches}``."""
    from repro_torch.models.runtime import RuntimeOptions
    from repro_torch.serving import CompileCache, ServingEngine
    opts = RuntimeOptions(paged_kernel=True, kv_dtype="int8")
    cache = CompileCache()

    def engine():
        return ServingEngine(cfg, params, slots=8, max_seq=max_seq,
                             block_size=16, opts=opts, decode_mode="paged",
                             compile_cache=cache, device="cuda",
                             pool_blocks=pool_blocks)

    eng = engine()
    zero_counts()
    waves = []
    for wave in range(2):
        waves.append(serve_wave(torch, eng, _tight_prompts(
            seed + wave, cfg.vocab_size, n=n, lo=lo, hi=hi),
            rid + 100 * wave, new_tokens))
        if wave == 0:
            warm = eng.stats.recompiles
    counts = check_counts([eng], f"{what} paged int8, two waves")
    if set(counts) != {"paged_decode_attention", "flash_attention",
                       "fused_ffn"}:
        raise AssertionError(f"{what} launched {sorted(counts)}")
    if eng.stats.recompiles != warm:
        raise AssertionError(f"the second {what} wave built "
                             f"{eng.stats.recompiles - warm} new programs")
    if captures(eng) != 1:
        raise AssertionError(f"the {what} paged step was not captured once")
    for wave, (tps, ms, reqs) in enumerate(waves):
        log(f"{what} paged int8 on {smi}, wave {wave + 1}: "
            f"{tps:.1f} tok/s, {ms:.3f} ms/decode step; TTFT by bucket "
            + "; ".join(f"{b}: mean {mean:.1f} ms, max {mx:.1f} ms over {n}"
                        for b, (mean, mx, n) in ttft_by_bucket(
                            eng, reqs).items()))
    log(f"  decode steps {eng.stats.decode_calls}, prefill calls "
        f"{eng.stats.prefill_calls}, programs built {warm}, graph captures "
        f"{captures(eng)}")
    del eng
    busy_eng = engine()
    step = step_repeats(torch, busy_eng, f"{what} paged int8")
    weights, kv = step_bytes(params, busy_eng)
    busy, k3, k1, mm = paged_split(torch, step)
    del busy_eng, step
    torch.cuda.empty_cache()
    graph_ms, _, g_busy, _ = graph_vs_eager(
        torch, engine(), f"{what} paged int8 step", smi, steps=steps)
    bound_ms = 1e3 * (weights + kv) / H100_BYTES_PER_S
    log(f"{what} decode step on {smi}: eager device {busy:.3f} ms = K3 "
        f"{k3:.3f} + K1 {k1:.3f} + weight products {mm:.3f} + the rest "
        f"{busy - k3 - k1 - mm:.3f}; graph-replayed {graph_ms:.3f} ms host "
        f"(device {g_busy:.3f} ms, idle share {1 - g_busy / graph_ms:.3f}); "
        f"byte bound {bound_ms:.3f} ms ({weights / 1e9:.2f} GB of weights, "
        f"{kv / 1e6:.1f} MB of KV at 8 busy slots, at "
        f"{H100_BYTES_PER_S / 1e12:.2f} TB/s): the graph step's device time "
        f"at {bound_ms / g_busy:.3f} of the bound")
    return counts


def vlm_card_vs_cpu(torch):
    """12c: card == CPU in f32 at every published width of internvl2-26b,
    depth cut to 2 layers (1.37 B parameters, 5.5 GB a side, drawn once
    on the CPU and copied to the card): :func:`depth_card_vs_cpu` over 2
    prompts of 256 patch embeddings and 16 text tokens, 16 greedy decode
    steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("internvl2-26b").with_updates(
        num_layers=2, param_dtype="float32", activation_dtype="float32")
    t0 = time.perf_counter()
    cpu_params = init_params(cfg, seed=0, device="cpu")
    card = tree_to(cpu_params, "cuda")
    return depth_card_vs_cpu(
        torch, cfg, cpu_params, card, text_len=16, steps=16, seed=121,
        what="internvl2-26b, 2 layers at full width, f32, patch embeddings",
        drawn=f"drawn on the host and copied to the card in "
              f"{time.perf_counter() - t0:.1f} s")


def depth_card_vs_cpu(torch, cfg, cpu_params, card_tree, *, text_len,
                      steps, seed, what, drawn, b=2):
    """Card == CPU in f32 at ``cfg``'s published widths and cut depth:
    the model-level prefill of ``b`` prompts of ``text_len`` tokens (after
    the stub patch embeddings of a VLM), then ``steps`` greedy decode
    steps over the dense cache.  The greedy streams must be equal and the
    last prefill logits within ``LOGITS_TOL``; K2 ``num_layers`` a
    prefill call and K3 ``num_layers`` a call and a step, on their f32
    routes.  ``card_tree`` (the same weights on the card) is emptied
    before the CPU side runs.  Returns
    ``{kernel name: launches}``."""
    import numpy as np
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.models.runtime import RuntimeOptions
    f32 = RuntimeOptions(kv_cache_dtype="float32")
    n = cfg.num_layers
    s = cfg.num_vision_tokens + text_len
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32))
    stub = {}
    if cfg.vision_embed_dim:
        stub["vision_embeds"] = torch.from_numpy((rng.standard_normal(
            (b, cfg.num_vision_tokens, cfg.vision_embed_dim)) * 0.1).astype(
                np.float32))
    n_params = sum(t.numel() for t in tree_leaves(cpu_params))

    def streams(params, device):
        cache = init_cache(cfg, b, s + steps, f32, device=device)
        logits, cache = prefill(params, cfg, toks.to(device), cache, f32,
                                **{k: v.to(device) for k, v in stub.items()})
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1).to(
            torch.int32)
        out = [tok]
        for _ in range(steps):
            lg, cache = decode_step(params, cfg, cache, tok, f32)
            tok = torch.argmax(lg[:, :cfg.vocab_size], -1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, 1).cpu(), logits[:, -1].float().cpu()

    zero_counts()
    card, card_lg = streams(card_tree, "cuda")
    counts = {name: fn.launches for name, fn in _kernel_fns().items()}
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=n, fused_ffn=n * (1 + steps))
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    card_tree.clear()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cpu, cpu_lg = streams(cpu_params, "cpu")
    cpu_s = time.perf_counter() - t1
    err = check_close("prefill logits", card_lg, cpu_lg, LOGITS_TOL, what)
    if not torch.equal(card, cpu):
        raise AssertionError(f"{what}: card and CPU greedy streams differ:"
                             f"\ncuda {card.tolist()}\ncpu  {cpu.tolist()}")
    log(f"{what} ({n_params / 1e9:.3f} B parameters {drawn}): card == CPU "
        f"greedy streams {tuple(card.shape)}, last prefill logits "
        f"max_abs_err {err:.3g} (atol {LOGITS_TOL['atol']}, rtol "
        f"{LOGITS_TOL['rtol']}); the CPU side took {cpu_s:.1f} s; launches "
        f"{ {k: c for k, c in counts.items() if c} }")
    return {k: c for k, c in counts.items() if c}


def tree_to(tree, device):
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def phase_vlm(torch, smi):
    """internvl2-26b at full width on the card: 12.0 the kernels at its
    shapes; the 19.3 B weights drawn in bf16 on the card; 12a the VLM
    path at model level; 12b served paged int8 by the engine; 12c card
    == CPU in f32 at depth 2.  Returns ``({kernel name: launches},
    {kernel name: timing fields})``."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import tree_leaves
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    extra = vlm_kernels_alone(torch)
    torch.cuda.empty_cache()
    totals = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    cfg = get_config("internvl2-26b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = card_params(torch, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    if round(n_params / 1e9, 1) != 19.3:
        raise AssertionError(f"internvl2-26b has {n_params} parameters, "
                             "not 19.3 B")
    log(f"internvl2-26b: {n_params / 1e9:.3f} B parameters "
        f"({tree_bytes(params) / 1e9:.2f} GB) drawn in bf16 on the card "
        f"from seed 0 in {init_s:.1f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    add(vlm_prefill_decode(torch, smi, params, cfg))
    torch.cuda.empty_cache()
    add(served_paged(torch, smi, params, cfg, what="internvl2-26b",
                     max_seq=1024, lo=8, hi=500, seed=120, rid=26000))
    log(f"  phase 12 max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    add(vlm_card_vs_cpu(torch))
    log(f"VLM phase: {time.perf_counter() - t_phase:.1f} s")
    return totals, extra


# ---------------------------------------------------------------- phase 13
# 13a..13e in this order: (config, max_seq asked, least max_seq taken,
# prompt lengths lo..hi, prompt seed).  gemma3-12b's prompts reach bucket
# 2048, so its local layers' window of 1024 masks real columns in K2 and
# K1; qwen1.5-32b's stay in bucket 128, since a burst of 8 prompts of
# bucket 256 (~13 GB of K/V and int8 temporaries) does not fit beside its
# 68.8 GB of weights.  max_seq 512 is the least that holds step_repeats'
# 8 requests of 24..136 tokens (a bucket of max_seq admits none)
DENSE_FAMILIES = (
    ("gemma3-12b", 2048, 2048, 8, 1800, 130),
    ("phi3-mini", 1024, 1024, 8, 500, 132),
    ("gemma-7b", 1024, 1024, 8, 500, 134),
    ("yi-34b", 1024, 1024, 8, 500, 136),
    ("qwen1.5-32b", 1024, 512, 8, 120, 138),
)
# parameter counts of the full-width trees, billions
DENSE_PARAMS_B = {"gemma3-12b": 11.77, "phi3-mini": 3.72, "gemma-7b": 8.54,
                  "yi-34b": 33.93, "qwen1.5-32b": 34.42}
# 13f's depths: gemma3-12b's layer 5 is its first global layer
DENSE_DEPTHS = {"gemma3-12b": 6, "phi3-mini": 2, "gemma-7b": 2, "yi-34b": 2,
                "qwen1.5-32b": 2}


def prompt_bucket(n):
    """The engine's prompt bucket of an ``n``-token prompt (uncapped)."""
    b = 16
    while b < n:
        b *= 2
    return b


def fit_max_seq(torch, cfg, want, least, lens):
    """The largest max_seq from ``want`` down to ``least`` (halving) whose
    paged int8 pool fits the card's free memory beside what serving it
    needs at once.  The pool holds 8 slots' tables and room for one wave
    of prompts of ``lens`` tokens whose blocks the prefix cache keeps, so
    that the second wave admits its bursts as the first did.  Needed at
    once: three pools (the engine's and the two clones of
    :func:`step_repeats`), or one pool beside the largest prefill burst
    (8 prompts of the longest prompt's bucket: ~5x their bf16 K/V, the
    stacked, padded and block-ordered copies and the f32 temporaries of
    the int8 quantization, and two copies of their bf16 logits), with 2
    GiB kept free.  Raises when ``least`` does not fit; logs the choice.
    Returns ``(max_seq, pool blocks)``."""
    free = torch.cuda.mem_get_info()[0]
    n, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    token = 2 * n * (kvh * hd + 4)          # int8 K and V, f32 row scales
    max_seq = want
    while max_seq >= least:
        bucket = min(prompt_bucket(max(lens)), max_seq)
        blocks = 8 * max_seq // 16 + 1 + sum(
            min(prompt_bucket(m), max_seq) // 16 for m in lens)
        pool = 16 * blocks * token
        burst = 5 * 2 * n * 8 * bucket * kvh * hd * 2 \
            + 2 * 8 * bucket * cfg.padded_vocab * 2
        need = max(3 * pool, pool + burst) + 2 * 2 ** 30
        if need <= free:
            log(f"{cfg.name}: max_seq {max_seq} (asked {want}): a pool of "
                f"{blocks} blocks, {pool / 1e9:.2f} GB ({token} B a token), "
                f"the bucket-{bucket} burst ~{burst / 1e9:.2f} GB, need "
                f"{need / 1e9:.2f} GB of the {free / 1e9:.2f} GB free")
            return max_seq, blocks
        max_seq //= 2
    raise RuntimeError(f"{cfg.name}: no max_seq >= {least} fits the "
                       f"{free / 1e9:.2f} GB free")


def dense_kernels_alone(torch, shapes):
    """13.0: K1, K2 and K3 at each dense family's served shapes, each held
    against its plain version and repeating bit for bit, then timed by
    CUDA events and by the profiler's device time (a window of its own
    for each measured call) beside its bound, its plain version and SDPA
    (K1, K2) or the unfused cuBLAS chain (K3).  ``shapes``: ``(cfg,
    max_seq, bucket)`` each.  K1: 8 slots over the config's heads, an int8
    pool of mb ``max_seq / 16``, ragged positions, under gemma3-12b's
    window on its local layers; K2: 8 prompts of ``bucket`` tokens,
    causal, and windowed for the local layers; K3: M 8 (a decode step) and
    M 8 x ``bucket`` (a prefill burst).  Returns the timing fields for
    the kernels line, by kernel name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, fused_ffn
    from repro_torch.kernels.ref import fused_ffn_ref, paged_decode_attn_ref
    gen = torch.Generator().manual_seed(2613)
    extra = {"paged_decode_attention": {}, "flash_attention": {},
             "fused_ffn": {}}
    times, labels, names = {}, {}, {}
    for cfg, max_seq, bucket in shapes:
        tag = cfg.name.replace("-", "_").replace(".", "_")
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        heads = f"{h}/{kvh} heads of {hd}"
        windows = (0, cfg.sliding_window) if cfg.local_global_ratio else (0,)
        # K1 at the decode step
        args, sc = make_case(torch, gen, slots=8, heads=h, kvh=kvh, hd=hd,
                             bs=16, mb=max_seq // 16, pool_dtype="int8",
                             q_dtype="bfloat16", pos_kind="ragged")
        args[4].copy_(torch.randint(max_seq // 2, max_seq + 1, (8,),
                                    generator=gen, dtype=torch.int32))
        for w in windows:
            out = k1_repeated(torch, args, sc, w)
            err = check_close("paged_decode_attention", out,
                              paged_decode_attn_ref(*args, window=w, **sc),
                              TOL["bfloat16"], f"{cfg.name} decode, window "
                              f"{w}")
            key = f"k1_{tag}" + ("_local" if w else "")
            times[key] = dict(k1_times(torch, args, sc, w), max_abs_err=err)
            names[key] = "paged_decode_attention"
            labels[key] = (f"K1, {cfg.name} decode (8 slots x {heads}, "
                           f"int8, mb {max_seq // 16}, positions "
                           f"{max_seq // 2}..{max_seq}"
                           + (f", window {w})" if w else ")"))
        del args, sc, out
        # K2 at the prefill burst
        q, k, v = flash_case(torch, gen, 8, h, kvh, bucket, hd, "bfloat16")
        kr, vr = (t.repeat_interleave(h // kvh, 1) for t in (k, v))
        for w in windows:
            mask = dict(causal=True, window=w)
            out = flash_attention(q, k, v, **mask)
            err = check_close("flash_attention", out, flash_plain(q, k, v,
                                                                  **mask),
                              TOL["bfloat16"], f"{cfg.name} prefill 8 x "
                              f"{bucket}, window {w}")
            if not torch.equal(out, flash_attention(q, k, v, **mask)):
                raise AssertionError(f"flash_attention does not repeat at "
                                     f"{cfg.name}'s prefill")
            if w:
                rows = torch.arange(bucket, device=q.device)
                keep = (rows[None] <= rows[:, None]) \
                    & (rows[None] > rows[:, None] - w)

                def sdpa():
                    return F.scaled_dot_product_attention(q, kr, vr,
                                                          attn_mask=keep)
            else:
                def sdpa():
                    return F.scaled_dot_product_attention(q, kr, vr,
                                                          is_causal=True)
            pairs = flash_pairs(bucket, True, w, None) * 8 * h
            key = f"k2_{tag}" + ("_local" if w else "")
            t = _time_kernel(
                torch, lambda: flash_attention(q, k, v, **mask),
                lambda: flash_plain(q, k, v, **mask), sdpa, "flash_attn",
                (2 * q.numel() + 2 * k.numel()) * 2, 4 * hd * pairs,
                plain_iters=3)
            t["max_abs_err"] = err
            times[key], names[key] = t, "flash_attention"
            labels[key] = (f"K2, {cfg.name} prefill (8 x {bucket}, {heads}, "
                           + (f"window {w})" if w else "causal)"))
        del q, k, v, kr, vr, out
        # K3 at a decode step and at the prefill burst
        d, f = cfg.d_model, cfg.d_ff
        for m in (8, 8 * bucket):
            x, wg, wu, wd = ffn_case(torch, gen, m, d, f, "bfloat16")
            out = fused_ffn(x, wg, wu, wd, cfg.activation)
            err = check_close("fused_ffn", out, fused_ffn_ref(
                x, wg, wu, wd, cfg.activation), FFN_TOL["bfloat16"],
                f"{cfg.name} M {m}, D {d}, F {f}")
            if not torch.equal(out, fused_ffn(x, wg, wu, wd,
                                              cfg.activation)):
                raise AssertionError(f"fused_ffn does not repeat at "
                                     f"{cfg.name}'s M {m}")
            key = f"k3_{tag}_m{m}"
            times[key] = dict(k3_times(torch, x, wg, wu, wd, cfg.activation),
                              max_abs_err=err)
            names[key] = "fused_ffn"
            labels[key] = (f"K3, {cfg.name} FFN ({cfg.activation}, M {m}, "
                           f"D {d}, F {f})")
            del x, wg, wu, wd, out
    log_times(times, labels)
    log("phase 13 shapes: K1 (hd 96, 256 with and without window 1024, "
        "group 7), K2 (hd 96, 256 windowed and causal, 128 at group 7 and "
        "MHA 40) and K3 (five (D, F) pairs at M 8 and the prefill bursts) "
        "== plain versions, each repeating bit for bit")
    for key, t in times.items():
        suffix = key[key.index("_"):]
        extra[names[key]].update({f"{k}{suffix}": v for k, v in t.items()})
    return extra


def phase_dense(torch, smi):
    """The dense families at full width on the card, nothing cut: 13.0
    the kernels at their shapes; 13a..13e gemma3-12b, phi3-mini,
    gemma-7b, yi-34b and qwen1.5-32b, each drawn in bf16 on the card
    (its parameter count asserted) and served paged int8 by
    :func:`served_paged`; 13f card == CPU in f32 at published widths,
    gemma3-12b at depth 6 (its first global layer in) and the others at
    depth 2.  Returns ``({kernel name: launches}, {kernel name: timing
    fields})``."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import tree_leaves
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    extra = dense_kernels_alone(torch, [
        (get_config(name), want, prompt_bucket(hi))
        for name, want, _, _, hi, _ in DENSE_FAMILIES])
    totals = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    total_mem = torch.cuda.mem_get_info()[1]
    for i, (name, want, least, lo, hi, seed) in enumerate(DENSE_FAMILIES):
        t_cfg = time.perf_counter()
        cfg = get_config(name)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = card_params(torch, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params))
        if round(n_params / 1e9, 2) != DENSE_PARAMS_B[name]:
            raise AssertionError(f"{name} has {n_params} parameters, not "
                                 f"{DENSE_PARAMS_B[name]} B")
        log(f"13{'abcde'[i]} {name}: {n_params / 1e9:.3f} B parameters "
            f"({tree_bytes(params) / 1e9:.2f} GB) drawn in bf16 on the card "
            f"from seed 0 in {init_s:.1f} s")
        lens = [len(p) for p in _tight_prompts(seed, cfg.vocab_size, n=12,
                                                lo=lo, hi=hi)]
        max_seq, blocks = fit_max_seq(torch, cfg, want, least, lens)
        add(served_paged(torch, smi, params, cfg, what=name, max_seq=max_seq,
                         lo=lo, hi=hi, seed=seed, rid=27000 + 1000 * i,
                         pool_blocks=blocks, new_tokens=32, steps=8))
        log(f"  {name}: max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of the card's "
            f"{total_mem / 1e9:.2f} GB; {time.perf_counter() - t_cfg:.1f} s")
        del params
    torch.cuda.empty_cache()
    for name, depth in DENSE_DEPTHS.items():
        cfg = get_config(name).with_updates(
            num_layers=depth, param_dtype="float32",
            activation_dtype="float32")
        t0 = time.perf_counter()
        card = card_params(torch, cfg, torch.float32)
        cpu = tree_to(card, "cpu")
        drawn = (f"drawn in f32 on the card and copied to the host in "
                 f"{time.perf_counter() - t0:.1f} s")
        add(depth_card_vs_cpu(
            torch, cfg, cpu, card, text_len=64, steps=8, seed=139,
            what=f"13f {name}, {depth} layers at full width, f32",
            drawn=drawn))
        del card, cpu
    log(f"dense phase: {time.perf_counter() - t_phase:.1f} s")
    return totals, extra


# --------------------------------------------------------------- phase 14
REMAT_POLICIES = ("none", "dots", "full")
PHI3_PARAMS_B = 3.723            # phi3-mini, nothing cut (PERF.md §4)


def ladder_keep(policy):
    """The share of the activation bytes a rung of the engine's ladder
    (``engine.remat.POLICY_LADDER``) keeps."""
    from repro_torch.engine.remat import POLICY_LADDER
    return {name: keep for name, keep, _ in POLICY_LADDER}[policy]


def remat_counts(cfg, remat, steps=1):
    """K6, K2 and K3 launches of ``steps`` train steps of ``cfg`` under
    ``remat``: a forward runs each Mamba layer's K6 and each attention
    layer's and shared site's K2 and K3 (a dense gated FFN); the backward
    launches again those of the recomputation regions (the full periods
    and the shared sites; not the leftover layers), K3 not under
    ``dots``."""
    from repro_torch.models.model import _n_shared_sites
    from repro_torch.models.transformer import _pattern_period
    period = len(_pattern_period(cfg)[0])
    n, sites = cfg.num_layers, _n_shared_sites(cfg)
    mamba = cfg.arch_type in ("ssm", "hybrid")
    attn = sites if mamba else n
    fwd = {"ssd_scan": n if mamba else 0, "flash_attention": attn,
           "fused_ffn": attn if cfg.gated_ffn else 0}
    in_regions = n // period * period
    again = {"ssd_scan": in_regions if mamba else 0,
             "flash_attention": sites if mamba else in_regions}
    again["fused_ffn"] = again["flash_attention"] if cfg.gated_ffn else 0
    if remat == "none":
        again = {}
    elif remat == "dots":
        again["fused_ffn"] = 0
    return {k: steps * (fwd[k] + again.get(k, 0)) for k in fwd
            if fwd[k] + again.get(k, 0)}


def measured_grads(torch, cfg, remat, params, batch, what):
    """One train step's loss and gradients (``launch.steps.
    loss_and_grads``) under ``remat``, with its exact launches, its peak
    memory and its activation part (the peak less the bytes resident
    before the forward)."""
    from repro_torch.launch.steps import loss_and_grads, options_for
    from repro_torch.models.configs import InputShape
    b, s = batch["tokens"].shape
    opts = options_for(cfg, InputShape("cli", s, b, "train"),
                       {"remat": remat})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(params, cfg, opts, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = exact_counts(remat_counts(cfg, remat), f"{what}, {remat}")
    peak = torch.cuda.max_memory_allocated()
    return loss, grads, counts, {"peak": peak, "act": peak - before,
                                 "s": secs}


def rungs(torch, cfg, params, sizes, what, check=None,
          policies=REMAT_POLICIES):
    """One train step's gradients under each rung of ``policies`` at each
    ``(batch, seq)`` of ``sizes`` (``measured_grads``), those at
    ``check`` held bit for bit to the first rung's.  Returns ``({size:
    {rung: memory}}, {kernel name: launches})``."""
    from repro_torch.models.layers import tree_leaves
    mem, totals = {}, {}
    for size in sizes:
        b, s = size
        batch = place_on_card(cfg, b, s)
        ref = None
        for remat in policies:
            loss, grads, counts, m = measured_grads(
                torch, cfg, remat, params, batch,
                f"{what}, {b} x {s}")
            mem.setdefault(size, {})[remat] = m
            for k, n in counts.items():
                totals[k] = totals.get(k, 0) + n
            if size != check:
                del grads
            elif ref is None:
                ref = (loss, grads)
            else:
                if not (torch.equal(loss, ref[0])
                        and same_bits(grads, ref[1])):
                    raise AssertionError(
                        f"{what} {b} x {s}: the loss or gradients under "
                        f"{remat} differ from {policies[0]}'s")
                del grads
        if ref is not None:
            log(f"{what} {b} x {s}: loss {float(ref[0]):.6f} and all "
                f"{len(list(tree_leaves(ref[1])))} gradient leaves equal bit "
                f"for bit under {', '.join(policies)}")
        del ref, batch
    return mem, totals


def place_on_card(cfg, b, s, index=0):
    from repro_torch.data import DataConfig, SyntheticLM, place_batch
    return place_batch(SyntheticLM(DataConfig(cfg.vocab_size, s, b))
                       .batch(index), "cuda")


def log_rungs(cfg, mem, smi, what):
    """Each rung's peak and activation part at the larger size beside the
    ladder's ``activation_bytes x keep``, and its bytes a token between
    the two sizes beside the ladder's."""
    from repro_torch.engine.remat import activation_bytes
    (b0, s0), (b1, s1) = sorted(mem, key=lambda bs: bs[0] * bs[1])
    base = activation_bytes(cfg, b1, s1)
    per_token = activation_bytes(cfg, 1, 1)
    dt = b1 * s1 - b0 * s0
    for remat in REMAT_POLICIES:
        m, m0 = mem[(b1, s1)][remat], mem[(b0, s0)][remat]
        keep = ladder_keep(remat)
        slope = (m["act"] - m0["act"]) / dt
        log(f"{what} {remat} on {smi}: at {b1} x {s1} max_memory_allocated "
            f"{m['peak'] / 1e9:.3f} GB, activation part "
            f"{m['act'] / 1e9:.3f} GB beside the ladder's "
            f"{base * keep / 1e9:.3f} GB (activation_bytes "
            f"{base / 1e9:.3f} GB x keep {keep}); {slope / 1e6:.4f} MB a "
            f"token from {b0} x {s0} beside the ladder's "
            f"{per_token * keep / 1e6:.4f}; forward + backward "
            f"{1e3 * m['s']:.1f} ms (host clock, {b0} x {s0}: "
            f"{1e3 * m0['s']:.1f})")


def zamba2_ladder(torch, smi):
    """14a: full-width zamba2-1.2b (f32 weights drawn on the card, bf16
    activations): one train step's gradients under each rung at 4 x 512
    and 4 x 1024 tokens (bit for bit equal at 4 x 1024), with exact
    launches, each rung's peak and activation part, ordered none > dots >
    full; then one donated ``make_train_step`` call under each rung at
    4 x 1024 from a clone of the same weights and a fresh AdamW state
    (exact launches, equal loss and gradient norm).  Returns ``{kernel
    name: launches}``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step, options_for
    from repro_torch.models.configs import InputShape
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    cfg = get_config("zamba2-1.2b")
    bsz, s = TRAIN_SHAPE
    params = card_params(torch, cfg, torch.float32)
    mem, totals = rungs(torch, cfg, params, ((bsz, s // 2), (bsz, s)),
                        "14a zamba2-1.2b", check=(bsz, s))
    log_rungs(cfg, mem, smi, "14a zamba2-1.2b")
    acts = [mem[(bsz, s)][r]["act"] for r in REMAT_POLICIES]
    if not acts[0] > acts[1] > acts[2]:
        raise AssertionError(f"14a: activation parts {acts} not ordered "
                             "none > dots > full")
    batch = place_on_card(cfg, bsz, s)
    metrics = {}
    for remat in REMAT_POLICIES:
        opts = options_for(cfg, InputShape("cli", s, bsz, "train"),
                           {"remat": remat})
        p = tree_map(lambda t: t.clone(), params)
        state = adamw.init(p)
        zero_counts()
        p2, state2, m = make_train_step(cfg, opts, donate=True)(p, state,
                                                                batch)
        torch.cuda.synchronize()
        for k, n in exact_counts(
                remat_counts(cfg, remat),
                f"14a one donated make_train_step call, {remat}").items():
            totals[k] = totals.get(k, 0) + n
        if p2 is not p or state2.m is not state.m or int(state2.step) != 1:
            raise AssertionError("14a: the donated step did not return "
                                 "the donated tensors")
        metrics[remat] = (m["loss"], m["grad_norm"])
        del p, p2, state, state2
    for remat in ("dots", "full"):
        if not all(torch.equal(a, b) for a, b in zip(metrics[remat],
                                                     metrics["none"])):
            raise AssertionError(f"14a: the step's loss / grad norm under "
                                 f"{remat} differ from none's")
    log(f"14a: one donated make_train_step call a rung: loss "
        f"{float(metrics['none'][0]):.6f}, grad norm "
        f"{float(metrics['none'][1]):.6f}, equal bit for bit")
    del params, batch
    torch.cuda.empty_cache()
    return totals


def phi3_step_split(torch, cfg, opts, params, state, batch):
    """Device ms of one donated train step's forward, backward (with the
    recomputation) and AdamW update by CUDA events, mirroring
    ``make_train_step``."""
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import forward, lm_loss
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import warmup_cosine
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    p = tree_map(lambda t: t.detach().requires_grad_(t.is_floating_point()),
                 params)
    logits, aux = forward(p, cfg, batch["tokens"], opts)
    loss = lm_loss(logits, batch["labels"]) + cfg.router_aux_weight * aux
    del logits, aux
    ev[1].record()
    leaves = [t for t in tree_leaves(p) if t.requires_grad]
    grads = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda t: next(grads), p)
    ev[2].record()
    with torch.no_grad():
        adamw.apply_(grads, params, state,
                     lr_scale=warmup_cosine(state.step))
    ev[3].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def phi3_trained(torch, smi):
    """14b: full-width phi3-mini (3.723 B parameters, nothing cut), f32
    weights drawn on the card from seed 0, bf16 activations: one train
    step's gradients under each rung at 1 x 256 and 1 x 512 tokens (bit
    for bit equal at 512, exact launches, peak and activation part beside
    the ladder), whose bytes a token reckon each rung's need at 4 x 1024
    beside the AdamW state; the rungs reckoned to fit are then measured
    at 4 x 1024 (gradients bit for bit equal again).  Then ``train_loop``
    for 6 donated steps at 4 x 1024 under ``full``: finite losses,
    positive gradient norms, exact launches, host ms a step, a further
    step's device split, and the peak beside the planner's figure.
    Returns ``{kernel name: launches}``."""
    from repro_torch.configs import get_config
    from repro_torch.engine.remat import activation_bytes
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import options_for
    from repro_torch.launch.train import train_loop
    from repro_torch.models.configs import InputShape
    from repro_torch.models.layers import tree_leaves
    cfg = get_config("phi3-mini")
    params = card_params(torch, cfg, torch.float32)
    n_params = sum(t.numel() for t in tree_leaves(params))
    if abs(n_params / 1e9 - PHI3_PARAMS_B) > 0.001:
        raise AssertionError(f"phi3-mini: {n_params} parameters")
    mem, totals = rungs(torch, cfg, params, ((1, 256), (1, 512)),
                        f"14b phi3-mini ({n_params / 1e9:.3f} B)",
                        check=(1, 512))

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    log_rungs(cfg, mem, smi, "14b phi3-mini")
    shape = InputShape("cli", 1024, 4, "train")
    card = torch.cuda.get_device_properties(0).total_memory
    tokens = shape.global_batch * shape.seq_len
    moments = 2 * tree_bytes(params)              # AdamW's f32 m and v
    fits = []
    for remat in REMAT_POLICIES:
        # the weights and moments, then the 1 x 512 step's activation
        # part grown by its bytes a token from 256 to 512 tokens
        m, m0 = mem[(1, 512)][remat], mem[(1, 256)][remat]
        slope = (m["act"] - m0["act"]) / 256
        need = tree_bytes(params) + moments + m["act"] + slope * (
            tokens - 512)
        if need < 0.9 * card:
            fits.append(remat)
        log(f"14b phi3-mini under {remat}: reckoned need of a train step "
            f"at 4 x 1024 {need / 1e9:.1f} GB of the card's "
            f"{card / 1e9:.2f} GB (the ladder's activations there "
            f"{activation_bytes(cfg, 4, 1024) * ladder_keep(remat) / 1e9:.2f}"
            f" GB); {'run' if remat in fits else 'not run'} at 4 x 1024")
    big, counts = rungs(torch, cfg, params, ((4, 1024),), "14b phi3-mini",
                        check=(4, 1024), policies=tuple(fits))
    add(counts)
    for remat, m in big.get((4, 1024), {}).items():
        log(f"14b phi3-mini {remat} at 4 x 1024 (no AdamW state): "
            f"activation part {m['act'] / 1e9:.3f} GB; with the weights "
            f"and the moments a train step's need is "
            f"{(tree_bytes(params) + m['act'] + moments) / 1e9:.3f} GB; "
            f"forward + backward {1e3 * m['s']:.1f} ms (host clock)")
    del params
    torch.cuda.empty_cache()

    rec = {"t": [], "loss": [], "gnorm": []}

    def callback(i, params, opt_state, metrics):
        torch.cuda.synchronize()
        rec["t"].append(time.perf_counter())
        rec["loss"].append(float(metrics["loss"]))
        rec["gnorm"].append(float(metrics["grad_norm"]))
        rec["state"] = opt_state
        return params, opt_state

    torch.cuda.reset_peak_memory_stats()
    steps = 6
    zero_counts()
    t0 = time.perf_counter()
    out = train_loop(cfg, shape, steps, log_every=1, remat="full",
                     callback=callback)
    add(exact_counts(remat_counts(cfg, "full", steps),
                     f"14b phi3-mini train_loop, {steps} steps, full"))
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, rec["loss"] + rec["gnorm"])) or \
            min(rec["gnorm"]) <= 0:
        raise AssertionError(f"14b: losses {rec['loss']}, grad norms "
                             f"{rec['gnorm']}")
    plan = dryrun.memory_bytes(cfg, shape, options_for(cfg, shape))
    step_s = [b - a for a, b in zip(rec["t"], rec["t"][1:])]
    log(f"14b phi3-mini trained on {smi}: {steps} donated steps of 4 x "
        f"1024 tokens under full; losses "
        + ", ".join(f"{x:.4f}" for x in rec["loss"]) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in rec["gnorm"])
        + f"; init + first step {rec['t'][0] - t0:.1f} s, then host "
        f"{', '.join(f'{1e3 * x:.1f}' for x in step_s)} ms a step; "
        f"max_memory_allocated {peak / 1e9:.3f} GB beside the planner's "
        f"{plan['total'] / 1e9:.3f} GB (params, grads, AdamW state and "
        f"inputs; dryrun.memory_bytes) of the card's {card / 1e9:.2f} GB")
    batch = place_on_card(cfg, 4, 1024, steps)
    zero_counts()
    f_ms, b_ms, o_ms = phi3_step_split(
        torch, cfg, options_for(cfg, shape, {"remat": "full"}),
        out["params"], rec.pop("state"), batch)
    add(exact_counts(remat_counts(cfg, "full"),
                     "14b phi3-mini, the split step"))
    log(f"14b phi3-mini train step device split on {smi} (CUDA events): "
        f"forward {f_ms:.1f} ms, backward with the recomputation "
        f"{b_ms:.1f} ms, AdamW in place {o_ms:.1f} ms; device "
        f"{f_ms + b_ms + o_ms:.1f} ms against a host step of "
        f"{1e3 * min(step_s):.1f}–{1e3 * max(step_s):.1f} ms")
    del out, batch
    torch.cuda.empty_cache()
    return totals


def remat_card_vs_cpu(torch):
    """14c: 11c's reduced configs in f32, one train step's gradients under
    ``full`` on the card against ``none`` on the CPU (the loss within
    rtol 1e-5, each leaf within GRAD_REL_TOL of its largest gradient),
    with exact launches.  Returns ``{kernel name: launches}``."""
    from repro_torch.checkpoint import flatten_with_keys
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, place_batch
    from repro_torch.launch.steps import loss_and_grads, options_for
    from repro_torch.models import init_params
    from repro_torch.models.configs import InputShape
    from repro_torch.models.layers import tree_map
    totals = {}
    shape = InputShape("t", 300, 2, "train")
    cfgs = (("zamba2 reduced (d 256, 5 layers, period 2)",
             get_config("zamba2-1.2b").reduced(num_layers=5).with_updates(
                 shared_attn_period=2, activation_dtype="float32")),
            ("mamba2-370m reduced", get_config("mamba2-370m").reduced()
             .with_updates(activation_dtype="float32")))
    for what, cfg in cfgs:
        p_cpu = init_params(cfg, seed=0, device="cpu")
        p_card = tree_map(lambda t: t.cuda(), p_cpu)
        b = SyntheticLM(DataConfig(cfg.vocab_size, shape.seq_len, 2)).batch(0)
        zero_counts()
        loss, g_card = loss_and_grads(
            p_card, cfg, options_for(cfg, shape, {"remat": "full"}),
            place_batch(b, "cuda"))
        torch.cuda.synchronize()
        for k, n in exact_counts(remat_counts(cfg, "full"),
                                 f"14c {what}, full").items():
            totals[k] = totals.get(k, 0) + n
        loss_cpu, g_cpu = loss_and_grads(
            p_cpu, cfg, options_for(cfg, shape, {"remat": "none"}),
            place_batch(b, "cpu"))
        if abs(float(loss) - float(loss_cpu)) > 1e-5 * abs(float(loss_cpu)):
            raise AssertionError(f"14c {what}: loss {float(loss)} card, "
                                 f"{float(loss_cpu)} CPU")
        cpu = dict(flatten_with_keys(g_cpu))
        worst = 0.0
        for key, g in flatten_with_keys(g_card):
            scale = float(cpu[key].abs().max())
            err = float((g.cpu() - cpu[key]).abs().max())
            if err > GRAD_REL_TOL * scale + 1e-12:
                raise AssertionError(f"14c {what}: gradient of {key} max "
                                     f"err {err} of max {scale}")
            worst = max(worst, err / max(scale, 1e-30))
        log(f"14c {what}: gradients under full on the card == none on the "
            f"CPU in f32 ({len(cpu)} leaves, worst error {worst:.3g} of the "
            f"leaf's largest, tolerance {GRAD_REL_TOL})")
    return totals


def phase_remat(torch, smi):
    """The recomputation ladder and the donated update on the card: 14a
    zamba2-1.2b under each rung, 14b phi3-mini trained at full width,
    14c card == CPU.  Returns ``({kernel name: launches}, {})``."""
    t_phase = time.perf_counter()
    totals = {}
    for part in (zamba2_ladder(torch, smi), phi3_trained(torch, smi),
                 remat_card_vs_cpu(torch)):
        for k, n in part.items():
            totals[k] = totals.get(k, 0) + n
    log(f"remat phase: {time.perf_counter() - t_phase:.1f} s")
    return totals, {}


def main() -> int:
    global STAMP_T0
    import torch
    seconds = {}
    t0 = time.perf_counter()
    if "--stamp" in sys.argv[1:]:
        STAMP_T0 = t0

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[phase] = round(time.perf_counter() - t, 1)
        return out

    smi, idle_w = timed("1 device", phase_device, torch)
    name = torch.cuda.get_device_name(0)
    kernels = timed("2 kernels", lambda: [
        phase_paged(torch), phase_flash(torch), phase_ffn(torch),
        phase_ssd(torch)] + phase_act_quant(torch))
    launches = timed("3 serving", phase_serving, torch, smi)
    for k, n in timed("3 modes", phase_modes, torch, smi).items():
        launches[k] = launches.get(k, 0) + n
    launches.update(timed("3 batched", phase_batched, torch, smi))
    launches.update(timed("4 engine", phase_engine, torch, smi))
    timed("5 card vs cpu", phase_card_vs_cpu, torch)
    for k, n in timed("6 adapt", phase_adapt, torch, smi, idle_w).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in timed("7 crowd", phase_crowd, torch, smi).items():
        launches[k] = launches.get(k, 0) + n
    extras = []
    for label, phase in (("8 experts", phase_experts),
                         ("9 hybrid", phase_hybrid),
                         ("10 encdec", phase_encdec),
                         ("11 trainer", phase_trainer),
                         ("12 vlm", phase_vlm), ("13 dense", phase_dense),
                         ("14 remat", phase_remat)):
        counts, extra = timed(label, phase, torch, smi)
        extras.append(extra)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    for k in kernels:
        k["launches"] = launches[k["name"]]
        for extra in extras:
            k.update(extra.get(k["name"], {}))
    seconds["total"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"phase_seconds": seconds}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
