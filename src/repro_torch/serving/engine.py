"""Serving runtime: request scheduler + slot-batched decode engine.

Port of the JAX package's ``ServingEngine``.  Requests queue, are
admitted into fixed decode slots by burst prefill, and every tick one
slot-batched decode step advances every slot and samples on the device.
Three decode modes:

* ``decode_mode="batched"`` (the default, as in the JAX package) — ONE
  slot-stacked cache of shape ``(slots, ...)`` (dense KV for attention
  stacks, SSM and conv state for the SSM stack) and one step per tick.
  Free slots are decoded too and their outputs ignored, never skipped.
  Ticks on which no active slot samples take the pure-argmax step.
  ``prefill_mode="per_request"`` admits one request per prefill call
  instead of a burst.
* ``decode_mode="paged"`` — self-attention KV lives in a
  :class:`~repro_torch.serving.paging.BlockPool`.  With
  ``paged_kernel=True`` the step reads it straight through the block
  tables with the paged decode kernel; otherwise it gathers each slot's
  blocks to a dense view and runs the dense step.  ``kv_dtype="int8"``
  stores the pool int8.
* ``decode_mode="per_slot"`` — the reference loop: one batch=1 cache and
  one step call per active slot, admission always per request.  Token
  streams are the same in every mode.

* Admission drains every waiting request that shares the head-of-line
  request's prompt bucket and prefills the burst in ONE call (burst
  sizes bucketed to powers of two capped at the slot count, short
  bursts padded with leading throwaway rows).  The head is never
  skipped, so later same-bucket arrivals cannot starve an earlier
  waiter from another bucket.
* (paged) Prompt blocks are deduplicated by prefix chain hash after each burst
  (copy-on-write: decode always writes a private tail block), and a
  full-prompt prefix cache re-admits an already-seen padded prompt with
  no prefill call at all.
* Block tables and positions are runtime data of constant shape, so
  occupancy, sharing and admission churn never build a new program;
  ``ServeStats.recompiles`` counts the programs this engine's requests
  caused to be built (see :mod:`repro_torch.serving.compile_cache`).
* Where the JAX package donates the slot cache and the pool to each
  step, this engine's steps update them in place.  On the card the
  batched ``decode``/``decode_greedy`` steps and the paged block-table
  step are replayed as CUDA graphs (:mod:`repro_torch.serving.graphs`),
  one launch a tick where the JAX package dispatches one compiled
  program; tokens and block tables reach them through static input
  buffers.  Prefill, admission, copy-on-write, thaw, the gather step
  and ``per_slot`` stay eager.

An in-flight request can be **frozen** into a host-side
:class:`~repro_torch.serving.paging.FrozenRequest` (KV densified and
trimmed to ``pos``, sampling state, consumed count) and **thawed** on
any engine whose ``(cfg, opts, params_version)`` fingerprint matches,
with zero token loss and zero re-prefill.  Preemption under pool
pressure, ``requeue_active`` and ``swap_model`` go through freeze/thaw;
a fingerprint mismatch falls back to re-prefilling prompt + generated.
``inject_oom`` fails admissions on purpose, and admission then backs off
exponentially.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..kernels.act_quant import kv_dequant_rows
from ..models.configs import ModelConfig
from ..models.layers import Params, cast_params, dtype_of
from ..models.model import (init_cache, init_paged_pool,
                            init_paged_slot_cache, init_slot_cache)
from ..models.runtime import DEFAULT_OPTIONS, RuntimeOptions
from ..obs.metrics import MetricsRegistry
from ..obs.recorder import NULL_RECORDER
from .compile_cache import GLOBAL_COMPILE_CACHE, CompileCache, ServePrograms
from .graphs import StepGraph
from .paging import (DEFAULT_BLOCK_SIZE, TRASH_BLOCK, BlockPool,
                     FrozenRequest, PrefixCache, PrefixEntry,
                     block_hash_chain, blocks_needed)
from .sampling import DEFAULT_SAMPLING, SamplingOpts, request_key

DECODE_MODES = ("batched", "per_slot", "paged")
PREFILL_MODES = ("batched", "per_request")

# cache leaves whose sequence axis (axis 2 in batch=1 layout) is trimmed
# to ``pos`` when freezing — everything past pos is zero by construction.
# An encoder-decoder's cross K/V span the encoder frames, not the
# decoded sequence, and are frozen whole.
_SEQ_TRIM_LEAVES = ("k", "v", "shared_k", "shared_v")

# default observability pids: distinct per engine so two untagged
# engines sharing one TraceRecorder never interleave on one track
_ENGINE_SEQ = itertools.count()


@dataclass
class Request:
    """One generation request in the serving queue.  ``rid`` is the
    caller's identifier (folded into the request's PRNG key); ``prompt``
    is the int32 token array to prefill; ``max_new_tokens`` bounds the
    generated continuation (the prefill's first sampled token counts
    toward it).  ``sampling`` overrides the engine's default
    :class:`SamplingOpts` (``None`` inherits it).  The engine fills
    ``generated``, ``done`` and the ``*_s`` stamps (``arrived_s`` at
    :meth:`ServingEngine.submit` when left 0, ``first_token_s`` when the
    prefill's token lands on the host)."""
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    arrived_s: float = 0.0
    sampling: Optional[SamplingOpts] = None
    # filled by the engine
    generated: List[int] = field(default_factory=list)
    done: bool = False
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    # set when the request carries serialized in-flight state (a requeue,
    # preemption or migration); a compatible engine thaws it with zero
    # re-prefill, an incompatible one re-prefills prompt + generated
    frozen: Optional[FrozenRequest] = None


class ServeStats:
    """Counters for one engine's lifetime, as a view over its
    :class:`~repro_torch.obs.metrics.MetricsRegistry`: ``steps`` taken,
    ``decode_calls`` (steps that ran the decode program — the ones that
    launch the decode kernels), ``tokens_out`` emitted (prefill +
    decode), ``prefills`` (requests prefilled), ``prefill_calls``
    (prefill invocations — a burst of k is k prefills but 1 call),
    ``sampled_tokens`` (tokens drawn at temperature > 0),
    ``recompiles`` (programs this engine caused to be built),
    ``oom_events`` (failed admissions), ``requeues`` (requests put back
    at the queue head), ``freezes`` and ``thaws``.  A ``per_slot`` step
    makes one decode call per active slot."""

    _COUNTERS = {"steps": "engine.steps",
                 "decode_calls": "engine.decode_calls",
                 "tokens_out": "engine.tokens_out",
                 "prefills": "engine.prefills",
                 "prefill_calls": "engine.prefill_calls",
                 "sampled_tokens": "engine.sampled_tokens",
                 "recompiles": "engine.recompiles",
                 "oom_events": "engine.oom_events",
                 "requeues": "engine.requeues",
                 "freezes": "engine.freezes",
                 "thaws": "engine.thaws"}

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        for name in self._COUNTERS.values():
            self.metrics.counter(name)

    def _get(self, attr: str) -> int:
        return self.metrics.counter(self._COUNTERS[attr]).value

    def _set(self, attr: str, v: int) -> None:
        self.metrics.counter(self._COUNTERS[attr]).value = v

    steps = property(lambda s: s._get("steps"),
                     lambda s, v: s._set("steps", v))
    decode_calls = property(lambda s: s._get("decode_calls"),
                            lambda s, v: s._set("decode_calls", v))
    tokens_out = property(lambda s: s._get("tokens_out"),
                          lambda s, v: s._set("tokens_out", v))
    prefills = property(lambda s: s._get("prefills"),
                        lambda s, v: s._set("prefills", v))
    prefill_calls = property(lambda s: s._get("prefill_calls"),
                             lambda s, v: s._set("prefill_calls", v))
    sampled_tokens = property(lambda s: s._get("sampled_tokens"),
                              lambda s, v: s._set("sampled_tokens", v))
    recompiles = property(lambda s: s._get("recompiles"),
                          lambda s, v: s._set("recompiles", v))
    oom_events = property(lambda s: s._get("oom_events"),
                          lambda s, v: s._set("oom_events", v))
    requeues = property(lambda s: s._get("requeues"),
                        lambda s, v: s._set("requeues", v))
    freezes = property(lambda s: s._get("freezes"),
                       lambda s, v: s._set("freezes", v))
    thaws = property(lambda s: s._get("thaws"),
                     lambda s, v: s._set("thaws", v))

    @property
    def tokens_per_step(self) -> float:
        return self.tokens_out / max(self.steps, 1)

    def __repr__(self) -> str:
        fields = ", ".join(f"{a}={self._get(a)}" for a in self._COUNTERS)
        return f"ServeStats({fields})"


class ServingEngine:
    """Slot-based continuous batching.

    ``slots`` fixes the decode batch width (requests beyond it queue);
    ``max_seq`` bounds prompt+generation length per slot.  In the paged
    mode ``opts.paged_kernel`` selects the block-table step (else the
    gather-to-dense step) and ``kv_dtype="int8"`` stores the pool int8
    with per-row scales.  The batched and per-slot modes keep their dense
    caches in ``kv_cache_dtype`` and refuse both paged options; the
    batched mode's ``prefill_mode`` is ``"batched"`` (bursts) or
    ``"per_request"``, the per-slot mode always admits per request.
    ``sampling`` is the default :class:`SamplingOpts` for requests that
    carry none.
    ``compile_cache`` / ``compile_domain`` share programs across engines,
    keyed on ``(cfg, opts, slots, max_seq, domain)``.  ``device`` is
    where the pool, the caches and the steps live (``"cuda"`` unless the
    caller asks for the CPU); ``params`` must already be there."""

    def __init__(self, cfg: ModelConfig, params: Params, *, slots: int = 8,
                 max_seq: int = 512, opts: RuntimeOptions = DEFAULT_OPTIONS,
                 decode_mode: str = "batched",
                 prefill_mode: str = "batched",
                 sampling: SamplingOpts = DEFAULT_SAMPLING,
                 compile_cache: Optional[CompileCache] = None,
                 compile_domain: str = "",
                 recorder=NULL_RECORDER,
                 pid: Optional[str] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 pool_blocks: Optional[int] = None,
                 prefix_entries: int = 32,
                 params_version: Optional[int] = None,
                 device: str = "cuda"):
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"unknown decode_mode {decode_mode!r}; "
                             f"expected one of {DECODE_MODES}")
        if prefill_mode not in PREFILL_MODES:
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}; "
                             f"expected one of {PREFILL_MODES}")
        if decode_mode == "paged":
            # every prompt bucket (powers of two from 16, capped at
            # max_seq) must be block-aligned so prompts fill whole blocks
            # and decode always writes a private tail block
            if block_size < 1 or block_size & (block_size - 1) \
                    or block_size > 16:
                raise ValueError(f"block_size {block_size} must be a "
                                 "power of two <= 16")
            if max_seq % block_size:
                raise ValueError(f"block_size {block_size} must divide "
                                 f"max_seq {max_seq}")
            per_slot_blocks = max_seq // block_size
            if pool_blocks is None:
                # dense-equivalent capacity plus the trash block; prefix
                # sharing only ever *reduces* usage below this
                pool_blocks = slots * per_slot_blocks + 1
            if pool_blocks < per_slot_blocks + 1:
                raise ValueError(f"pool_blocks {pool_blocks} cannot hold "
                                 "one full-length request (need "
                                 f"{per_slot_blocks + 1})")
        elif opts.kv_dtype != "auto" or opts.paged_kernel:
            raise ValueError("kv_dtype/paged_kernel are paged-pool options; "
                             f"decode_mode={decode_mode!r} keeps its dense "
                             "cache in kv_cache_dtype")
        self.cfg = cfg
        self.device = torch.device(device)
        # execution copy of the weights, cast once (the JAX package casts
        # inside every jitted step, where the cast is fused away)
        self.params = cast_params(params, dtype_of(cfg.activation_dtype))
        self.slots = slots
        self.max_seq = max_seq
        self.opts = opts
        self.decode_mode = decode_mode
        # the per-slot loop has no stacked cache to scatter a burst into;
        # the paged path only has burst admission (its per-request path
        # is the k=1 burst)
        if decode_mode == "per_slot":
            self.prefill_mode = "per_request"
        elif decode_mode == "paged":
            self.prefill_mode = "batched"
        else:
            self.prefill_mode = prefill_mode
        self.block_size = block_size
        self.pool_blocks = pool_blocks
        self.prefix_entries = prefix_entries
        # the freeze/thaw fingerprint's weights part, which also salts the
        # prefix hashes (KV content is a function of the weights).  Engines
        # sharing a params dict share its id; callers juggling transient
        # params should pass one explicitly.
        self.params_version = (params_version if params_version is not None
                               else id(params))
        self.sampling = sampling
        self.compile_cache = (compile_cache if compile_cache is not None
                              else GLOBAL_COMPILE_CACHE)
        self.compile_domain = compile_domain
        self.recorder = recorder
        self.pid = pid if pid is not None else f"engine{next(_ENGINE_SEQ)}"
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = ServeStats(self.metrics)
        self._ewma = self.metrics.ewma("engine.step_time_s", alpha=0.2)
        self._step_hist = self.metrics.histogram("engine.step_time_hist_s")
        # decode steps captured as CUDA graphs (on the card only), and
        # the wall time of the last capture's first call (the eager
        # warm-up step plus the capture)
        self._captures = self.metrics.counter("engine.graph_captures")
        self._capture_s = self.metrics.gauge("engine.graph_capture_s")
        self._queue: Deque[Request] = deque()
        self._active: List[Optional[Request]] = [None] * slots
        self.generation = 0
        self._programs: ServePrograms = self._bind_programs()
        self._reset_caches()
        # wall time of recent decode sweeps (bounded: engines are
        # long-lived); optional sink called with (step_seconds,
        # tokens_emitted, generation) after every step
        self.step_times: Deque[float] = deque(maxlen=2048)
        self.on_step: Optional[Callable[[float, int, int], None]] = None
        # SLO feed: when a tracker is installed, TTFT is reported at each
        # request's true first token and the per-token decode time per
        # step; None (the default) costs one attribute load a step
        self.slo = None
        # fault plane: injected OOM failures pending at admission and the
        # exponential admission hold-off (in steps) they trigger
        self._oom_pending = 0
        self._admit_holdoff = 0
        self._oom_backoff = 0
        self.oom_backoff_cap = 8

    # ------------------------------------------------------------ programs --
    def _note_compile(self, what: str, **detail) -> None:
        self.stats.recompiles += 1
        if self.recorder.enabled:
            self.recorder.instant("engine.compile", pid=self.pid,
                                  tid="engine", cat="engine",
                                  args={"what": what, **detail})

    def _bind_programs(self) -> ServePrograms:
        entry, fresh = self.compile_cache.entry_for(
            self.cfg, self.opts, self.slots, self.max_seq,
            self.compile_domain)
        if fresh:
            self._note_compile("programs", generation=self.generation)
        return entry

    def _prefill_fn(self, bucket: int) -> Callable:
        fn, fresh = self._programs.prefill(bucket)
        if fresh:
            self._note_compile("prefill", bucket=bucket)
        return fn

    def _prefill_batch_fn(self, bucket: int, k: int) -> Callable:
        fn, fresh = self._programs.prefill_batch(bucket, k)
        if fresh:
            self._note_compile("prefill_batch", bucket=bucket, k=k)
        return fn

    def _paged_decode_fn(self) -> Callable:
        fn, fresh = self._programs.paged_decode(self.pool_blocks,
                                                self.block_size)
        if fresh:
            self._note_compile("paged_decode", pool_blocks=self.pool_blocks,
                               block_size=self.block_size)
        return fn

    def _paged_prefill_fn(self, bucket: int, k: int) -> Callable:
        fn, fresh = self._programs.paged_prefill_batch(
            bucket, k, self.pool_blocks, self.block_size)
        if fresh:
            self._note_compile("paged_prefill_batch", bucket=bucket, k=k)
        return fn

    def _paged_admit_fn(self) -> Callable:
        fn, fresh = self._programs.paged_admit()
        if fresh:
            self._note_compile("paged_admit")
        return fn

    def _thaw_scatter_fn(self, nblk: int) -> Callable:
        fn, fresh = self._programs.thaw_scatter(nblk, self.pool_blocks,
                                                self.block_size)
        if fresh:
            self._note_compile("thaw_scatter", nblk=nblk)
        return fn

    def _copy_block_fn(self) -> Callable:
        fn, fresh = self._programs.copy_block(self.pool_blocks,
                                              self.block_size)
        if fresh:
            self._note_compile("copy_block")
        return fn

    def _reset_caches(self) -> None:
        # graphs bind the buffers made here: new buffers, new graphs
        self._graphs: Dict[str, StepGraph] = {}
        # the decode steps' static inputs, filled before every step
        self._tokens_in = torch.zeros(self.slots, dtype=torch.int32,
                                      device=self.device)
        if self.decode_mode == "per_slot":
            self._caches = [init_cache(self.cfg, 1, self.max_seq, self.opts,
                                       self.device)
                            for _ in range(self.slots)]
            return
        if self.decode_mode == "batched":
            self._cache = init_slot_cache(self.cfg, self.slots, self.max_seq,
                                          self.opts, self.device)
            return
        self._cache = init_paged_slot_cache(self.cfg, self.slots,
                                            self.max_seq, self.opts,
                                            self.device)
        self._pool = init_paged_pool(self.cfg, self.pool_blocks,
                                     self.block_size, self.opts, self.device)
        self._blocks = BlockPool(self.slots, self.pool_blocks,
                                 self.block_size, self.max_seq)
        self._tables_in = torch.zeros(tuple(self._blocks.tables.shape),
                                      dtype=torch.int32, device=self.device)
        self._prefix = PrefixCache(self.prefix_entries)
        # host-authoritative next-write position per slot (mirrors the
        # device ``pos`` leaf; drives tail-block growth and freezing)
        self._slot_pos = [0] * self.slots
        # admission sequence per slot: preemption under pool pressure
        # evicts the youngest admission first
        self._slot_seq = [0] * self.slots
        self._admit_seq = itertools.count(1)
        self._update_block_gauges()

    def _update_block_gauges(self) -> None:
        self.metrics.gauge("engine.blocks_used").set(self._blocks.used_blocks)
        self.metrics.gauge("engine.blocks_free").set(self._blocks.free_blocks)
        self.metrics.gauge("engine.blocks_shared").set(
            self._blocks.shared_blocks)

    @property
    def block_pool(self) -> Optional[BlockPool]:
        """The host-side block allocator (``None`` off the paged path) —
        exposed so tests and benches can assert refcounts/sharing."""
        return self._blocks if self.decode_mode == "paged" else None

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _run_step(self, name: Optional[str], step: Callable[[], torch.Tensor]
                  ) -> torch.Tensor:
        """Run one decode step: on the card, the engine's CUDA graph
        ``name`` (warmed up and captured on its first call, replayed
        after); eagerly when ``name`` is None or on the CPU."""
        if name is None or self.device.type != "cuda":
            return step()
        graph = self._graphs.get(name)
        if graph is not None:
            return graph()
        t0 = time.perf_counter()
        graph = self._graphs[name] = StepGraph(step, self.device)
        out = graph()
        self._captures.inc()
        self._capture_s.set(time.perf_counter() - t0)
        return out

    # ------------------------------------------------------------- intake --
    def submit(self, req: Request) -> None:
        if not req.arrived_s:
            req.arrived_s = time.perf_counter()
        if self.recorder.enabled:
            self.recorder.instant("req.queued", pid=self.pid, tid="queue",
                                  cat="request", wall_s=req.arrived_s,
                                  args={"rid": req.rid,
                                        "prompt_len": len(req.prompt)})
        self._queue.append(req)

    @property
    def has_work(self) -> bool:
        """True while any request is in flight or waiting."""
        return any(r is not None for r in self._active) or bool(self._queue)

    def _bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def _k_bucket(self, k: int) -> int:
        """Round a burst size up to its program bucket: powers of two,
        capped at the slot count."""
        b = 1
        while b < k:
            b *= 2
        return min(b, self.slots)

    def _sampling_of(self, req: Request) -> SamplingOpts:
        return req.sampling if req.sampling is not None else self.sampling

    # ------------------------------------------------------------ stepping --
    def _gather_burst(self, limit: int):
        """Pop the head request plus every same-bucket waiter behind it
        (up to ``limit``) off the queue.  The head anchors the bucket;
        budget-spent requests met on the way complete inline;
        passed-over requests keep their order at the queue head.
        Returns ``(bucket, requests)``."""
        head = self._queue.popleft()
        bucket = self._bucket(len(head.prompt))
        batch = [head]
        if limit > 1:
            kept: List[Request] = []
            while self._queue and len(batch) < limit:
                r = self._queue.popleft()
                if len(r.generated) >= r.max_new_tokens:
                    r.done = True
                    continue
                if r.frozen is not None:
                    # frozen state thaws (or falls back) only at the queue
                    # head — bursting it through prefill here would drop
                    # its generated suffix from the bucket computation
                    kept.append(r)
                    continue
                if self._bucket(len(r.prompt)) == bucket:
                    batch.append(r)
                else:
                    kept.append(r)
            for r in reversed(kept):
                self._queue.appendleft(r)
        return bucket, batch

    def _emit_first(self, req: Request, token: int, stamp: float,
                    free: List[int], slot: int) -> bool:
        """Book-keep a request's prefill token; returns True when the
        request stays active in ``slot`` (False = budget completed at
        prefill, slot returned to the free pool)."""
        req.generated.append(token)
        if req.first_token_s is None:
            # keep the original stamp across swap re-admissions: TTFT is
            # submit→first token, not submit→latest re-prefill
            req.first_token_s = stamp
            if self.slo is not None:
                self.slo.observe("ttft", stamp - req.arrived_s)
        self.stats.prefills += 1
        self.stats.tokens_out += 1
        if self._sampling_of(req).temperature > 0:
            self.stats.sampled_tokens += 1
        rec = self.recorder
        if rec.enabled:
            tid = f"slot{slot}"
            rec.instant("req.first_token", pid=self.pid, tid=tid,
                        cat="request", wall_s=stamp,
                        args={"rid": req.rid, "token": token})
            rec.begin("req.slot", pid=self.pid, tid=tid, cat="request",
                      wall_s=stamp, args={"rid": req.rid})
        if len(req.generated) >= req.max_new_tokens:
            req.done = True          # prefill token completed the budget
            if rec.enabled:
                rec.end("req.slot", pid=self.pid, tid=f"slot{slot}",
                        cat="request", wall_s=stamp,
                        args={"rid": req.rid, "reason": "done_at_prefill",
                              "tokens": len(req.generated)})
            free.append(slot)
            return False
        self._active[slot] = req
        return True

    def _truncate(self, req: Request, bucket: int) -> None:
        if len(req.prompt) > bucket:
            # prompt exceeds max_seq (e.g. a swap re-queue whose prompt
            # grew by the generated prefix): keep the newest context
            req.prompt = req.prompt[-bucket:]

    def _admit_burst(self, batch: List[Request], bucket: int,
                     free: List[int]) -> None:
        """ONE call admits the whole burst: stacked ``(k, bucket)``
        prompts are prefilled together and every row's cache and
        sampling state is written into its slot (in the paged mode its
        KV into freshly allocated blocks and its ``pos`` into the slot).
        Bursts smaller than their k-bucket are padded with leading
        throwaway rows aimed at the first real slot (and the trash
        block) — written first, overwritten by the real row."""
        k = len(batch)
        kb = self._k_bucket(k)
        pad = kb - k
        slots_for = [free.pop(0) for _ in range(k)]
        toks = np.zeros((kb, bucket), np.int32)
        keys = np.zeros((kb, 2), np.int64)
        temps = np.zeros((kb,), np.float32)
        top_ks = np.zeros((kb,), np.int32)
        slot_ids = np.full((kb,), slots_for[0], np.int64)
        for i, req in enumerate(batch):
            self._truncate(req, bucket)
            row = pad + i
            toks[row, bucket - len(req.prompt):] = req.prompt  # left-pad
            s = self._sampling_of(req)
            keys[row] = request_key(s.seed, req.rid, len(req.generated))
            temps[row] = s.temperature
            top_ks[row] = s.top_k
            slot_ids[row] = slots_for[i]
        if self.recorder.enabled:
            self.recorder.begin("engine.prefill", pid=self.pid,
                                tid="engine", cat="engine",
                                args={"bucket": bucket, "k": k,
                                      "k_bucket": kb,
                                      "rids": [r.rid for r in batch]})
        paged = self.decode_mode == "paged"
        if paged:
            nblk = bucket // self.block_size
            dest = np.zeros((kb, nblk), np.int32)
            for i, req in enumerate(batch):
                ids = self._blocks.alloc(nblk)
                dest[pad + i] = ids
                for j, b in enumerate(ids):
                    self._blocks.assign(slots_for[i], j, b)
            fn = self._paged_prefill_fn(bucket, kb)
            first, last, self._cache, self._pool = fn(
                self.params, self._cache, self._pool, self._to_device(toks),
                self._to_device(slot_ids), self._to_device(keys),
                self._to_device(temps), self._to_device(top_ks),
                self._to_device(dest))
        else:
            fn = self._prefill_batch_fn(bucket, kb)
            first, self._cache = fn(
                self.params, self._cache, self._to_device(toks),
                self._to_device(slot_ids), self._to_device(keys),
                self._to_device(temps), self._to_device(top_ks))
        first = first.cpu().numpy()
        self.stats.prefill_calls += 1
        stamp = time.perf_counter()
        if self.recorder.enabled:
            self.recorder.end("engine.prefill", pid=self.pid, tid="engine",
                              cat="engine", wall_s=stamp)
        for i, req in enumerate(batch):
            slot = slots_for[i]
            if not paged:
                self._emit_first(req, int(first[pad + i]), stamp, free, slot)
                continue
            # dedup freshly written prompt blocks against live blocks
            # holding the same padded-prefix chain hash, then cache the
            # whole prefill for prefix-skip re-admission
            padded = toks[pad + i]
            self._blocks.dedup_slot_prefix(
                slot, block_hash_chain(padded, self.block_size,
                                       salt=self.params_version))
            self._slot_pos[slot] = bucket
            self._slot_seq[slot] = next(self._admit_seq)
            if self.prefix_entries > 0:
                self._prefix.insert(
                    self._prefix.key_of(padded, self.params_version),
                    PrefixEntry(
                        block_ids=tuple(
                            int(b) for b in self._blocks.tables[slot, :nblk]),
                        logits_row=last[pad + i],
                        leaves=self._snapshot_slot_leaves(slot),
                        pos=bucket),
                    self._blocks)
            if not self._emit_first(req, int(first[pad + i]), stamp, free,
                                    slot):
                # budget completed at prefill: the slot's references go,
                # but a cached prefix entry keeps the blocks live
                self._blocks.release_slot(slot)
            self._update_block_gauges()

    def _snapshot_slot_leaves(self, slot: int) -> dict:
        """Copies, on the device, of one slot's non-KV, non-sampling
        cache leaves (batch=1 layout): what a prefix-cache re-admission
        restores beside the shared blocks (``pos``; an encoder-decoder's
        cross K/V)."""
        return {name: leaf[slot].clone() for name, leaf in self._cache.items()
                if name != "sample"}

    def _admit_from_prefix(self, req: Request, entry: PrefixEntry,
                           free: List[int]) -> None:
        """Admit a request whose padded prompt hit the prefix cache: no
        prefill call at all.  Shared blocks are increfed into the slot's
        table, the cached non-KV leaves and the request's own sampling
        state are written to its slot, and the first token is sampled
        from the cached last-position logits row with the request's own
        key."""
        slot = free.pop(0)
        for j, bid in enumerate(entry.block_ids):
            self._blocks.incref(bid)
            self._blocks.assign(slot, j, bid)
        s = self._sampling_of(req)
        key = self._to_device(request_key(s.seed, req.rid,
                                          len(req.generated))
                              .astype(np.int64))
        temp = torch.tensor(s.temperature, dtype=torch.float32,
                            device=self.device)
        top_k = torch.tensor(s.top_k, dtype=torch.int32, device=self.device)
        tok, key = self._programs.sample_first(entry.logits_row, key, temp,
                                               top_k)
        row = {name: torch.as_tensor(arr, device=self.device)
               for name, arr in entry.leaves.items()}
        self._cache = self._paged_admit_fn()(self._cache, row, slot, key,
                                             temp, top_k)
        self._slot_pos[slot] = entry.pos
        self._slot_seq[slot] = next(self._admit_seq)
        stamp = time.perf_counter()
        if self.recorder.enabled:
            self.recorder.instant("engine.prefix_hit", pid=self.pid,
                                  tid="engine", cat="engine", wall_s=stamp,
                                  args={"rid": req.rid,
                                        "blocks": len(entry.block_ids)})
        if not self._emit_first(req, int(tok), stamp, free, slot):
            self._blocks.release_slot(slot)
        self._update_block_gauges()

    def _admit_one(self, req: Request, free: List[int]) -> None:
        """Sequential admission: one batch=1 prefill call for this
        request, its first token drawn by the same ``sample_logits`` the
        batched paths use."""
        slot = free.pop(0)
        bucket = self._bucket(len(req.prompt))
        self._truncate(req, bucket)
        if self.recorder.enabled:
            self.recorder.begin("engine.prefill", pid=self.pid,
                                tid="engine", cat="engine",
                                args={"bucket": bucket, "k": 1,
                                      "rids": [req.rid]})
        toks = np.zeros((1, bucket), np.int32)
        toks[0, bucket - len(req.prompt):] = req.prompt  # left-pad
        cache = init_cache(self.cfg, 1, self.max_seq, self.opts, self.device)
        logits, cache = self._prefill_fn(bucket)(
            self.params, cache, self._to_device(toks))
        self.stats.prefill_calls += 1
        s = self._sampling_of(req)
        key = self._to_device(request_key(s.seed, req.rid,
                                          len(req.generated))
                              .astype(np.int64))
        temp = torch.tensor(s.temperature, dtype=torch.float32,
                            device=self.device)
        top_k = torch.tensor(s.top_k, dtype=torch.int32, device=self.device)
        tok, key = self._programs.sample_first(logits[0, -1], key, temp,
                                               top_k)
        nxt = int(tok)
        stamp = time.perf_counter()
        if self.recorder.enabled:
            self.recorder.end("engine.prefill", pid=self.pid, tid="engine",
                              cat="engine", wall_s=stamp)
        if not self._emit_first(req, nxt, stamp, free, slot):
            return
        if self.decode_mode == "batched":
            self._cache = self._programs.admit_slot(self._cache, cache, slot,
                                                    key, temp, top_k)
        else:
            cache["sample"] = {"key": key, "temp": temp, "top_k": top_k}
            self._caches[slot] = cache

    def inject_oom(self, n: int = 1) -> None:
        """Fault injection: the next ``n`` admission attempts fail as if
        cache allocation ran out of memory.  The request stays queued
        (zero token loss) and admission backs off exponentially (the
        hold-off in steps doubles, capped at ``oom_backoff_cap``) before
        it tries again; a successful admission heals the back-off."""
        self._oom_pending += max(int(n), 0)

    def _admit(self) -> None:
        if self._admit_holdoff > 0:
            self._admit_holdoff -= 1
            return
        free = [s for s in range(self.slots) if self._active[s] is None]
        if self._oom_pending > 0 and free and self._queue:
            # injected OOM: this admission attempt fails, the head stays
            # queued untouched, and admission backs off
            self._oom_pending -= 1
            self.stats.oom_events += 1
            self._oom_backoff = min(max(2 * self._oom_backoff, 1),
                                    self.oom_backoff_cap)
            self._admit_holdoff = self._oom_backoff
            if self.recorder.enabled:
                self.recorder.instant(
                    "engine.oom", pid=self.pid, tid="engine", cat="engine",
                    args={"backoff_steps": self._admit_holdoff,
                          "queued": len(self._queue)})
            return
        admitted = False
        while free and self._queue:
            head = self._queue[0]
            if len(head.generated) >= head.max_new_tokens:
                # re-queued with its budget already spent (or submitted
                # with max_new_tokens=0): a prefill token would overshoot
                self._queue.popleft()
                head.done = True
                continue
            if head.frozen is not None:
                if self.can_thaw(head.frozen):
                    if not self._thaw_capacity_ok(head.frozen):
                        # pool backpressure: decode frees blocks.  A thaw
                        # never preempts to fit — a preempted victim at
                        # the head would thaw by preempting right back
                        break
                    self._queue.popleft()
                    self._thaw_into_slot(head, free.pop(0))
                    admitted = True
                    continue
                # fingerprint mismatch: drop the blob and re-prefill
                # prompt + generated
                self._discard_frozen(head)
            if self.decode_mode == "paged":
                if not self._admit_paged_head(head, free):
                    break           # pool exhausted: wait for decode frees
            elif self.prefill_mode == "batched":
                bucket, batch = self._gather_burst(len(free))
                self._admit_burst(batch, bucket, free)
            else:
                self._queue.popleft()
                self._admit_one(head, free)
            admitted = True
        if admitted:
            self._oom_backoff = 0     # a successful admission heals

    def _admit_paged_head(self, head: Request, free: List[int]) -> bool:
        """Admit the head request (plus any same-bucket burst).  Returns
        False when the pool cannot cover the head's prompt blocks even
        after evicting cached prefixes — admission then waits for decode
        to free blocks (backpressure, not loss)."""
        bucket = self._bucket(len(head.prompt))
        nblk = bucket // self.block_size
        entry = self._prefix.lookup(
            self._prefix.key_of(self._padded_prompt(head, bucket),
                                self.params_version))
        if entry is not None:
            self._queue.popleft()
            self._admit_from_prefix(head, entry, free)
            return True
        if self._blocks.free_blocks < nblk:
            self._prefix.evict_for_blocks(nblk, self._blocks)
        max_k = self._blocks.free_blocks // nblk
        if max_k == 0:
            return False
        bucket, batch = self._gather_burst(min(len(free), max_k))
        self._admit_burst(batch, bucket, free)
        return True

    def _padded_prompt(self, req: Request, bucket: int) -> np.ndarray:
        """The left-padded prompt row exactly as prefill sees it — the
        prefix-sharing unit (KV content is a pure function of it)."""
        row = np.zeros(bucket, np.int32)
        prompt = req.prompt[-bucket:] if len(req.prompt) > bucket \
            else req.prompt
        row[bucket - len(prompt):] = prompt
        return row

    def _bookkeep_decode(self, out: torch.Tensor) -> int:
        """Post-step bookkeeping for the batched and paged steps: one bulk
        device→host transfer of ``out`` (next tokens and positions,
        ``(2, slots)`` int32), per-slot token append, finish detection
        and trace emission."""
        nxt, pos = out.cpu().numpy()
        paged = self.decode_mode == "paged"
        emitted = 0
        freed_blocks = False
        rec = self.recorder
        stamp = time.perf_counter()
        for slot, req in enumerate(self._active):
            if req is None:      # masked slot: decoded, output ignored
                continue
            req.generated.append(int(nxt[slot]))
            emitted += 1
            if paged:
                self._slot_pos[slot] = int(pos[slot])
            if self._sampling_of(req).temperature > 0:
                self.stats.sampled_tokens += 1
            if rec.enabled:
                rec.instant("req.decode", pid=self.pid, tid=f"slot{slot}",
                            cat="request", wall_s=stamp,
                            args={"rid": req.rid, "token": int(nxt[slot])})
            if len(req.generated) >= req.max_new_tokens \
                    or int(pos[slot]) >= self.max_seq - 1:
                req.done = True
                self._active[slot] = None
                if paged:
                    self._blocks.release_slot(slot)
                    freed_blocks = True
                if rec.enabled:
                    rec.end("req.slot", pid=self.pid, tid=f"slot{slot}",
                            cat="request", wall_s=stamp,
                            args={"rid": req.rid, "reason": "finished",
                                  "tokens": len(req.generated)})
        if freed_blocks:
            self._update_block_gauges()
        return emitted

    def _fill_tokens(self) -> bool:
        """Write every active slot's last token into the static token
        buffer (free slots decode token 0); returns whether any active
        slot samples."""
        tokens = np.zeros(self.slots, np.int32)
        sampling = False
        for slot, req in enumerate(self._active):
            if req is not None:
                tokens[slot] = req.generated[-1]
                sampling = sampling or \
                    self._sampling_of(req).temperature > 0
        self._tokens_in.copy_(torch.from_numpy(tokens))
        return sampling

    def _decode_batched(self) -> int:
        if not any(r is not None for r in self._active):
            return 0
        sampling = self._fill_tokens()
        # all-greedy ticks take the pure-argmax step; tokens are the same
        # either way, so mixed workloads can alternate
        name = "decode" if sampling else "decode_greedy"
        step_fn = getattr(self._programs, name)
        params, cache, tokens = self.params, self._cache, self._tokens_in

        def step():
            nxt, pos, _ = step_fn(params, cache, tokens)
            return torch.stack([nxt.to(torch.int32), pos.to(torch.int32)])

        out = self._run_step(name, step)
        self.stats.decode_calls += 1
        return self._bookkeep_decode(out)

    def _decode_per_slot(self) -> int:
        emitted = 0
        rec = self.recorder
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            tok = torch.tensor(req.generated[-1], dtype=torch.int32,
                               device=self.device)
            nxt, cache = self._programs.sample_ref(
                self.params, self._caches[slot], tok)
            self._caches[slot] = cache
            self.stats.decode_calls += 1
            nxt, pos = (int(v) for v in torch.stack(
                [nxt.to(torch.int32), cache["pos"].to(torch.int32)]).cpu())
            req.generated.append(nxt)
            emitted += 1
            if self._sampling_of(req).temperature > 0:
                self.stats.sampled_tokens += 1
            if rec.enabled:
                rec.instant("req.decode", pid=self.pid, tid=f"slot{slot}",
                            cat="request",
                            args={"rid": req.rid, "token": nxt})
            if len(req.generated) >= req.max_new_tokens \
                    or pos >= self.max_seq - 1:
                req.done = True
                self._active[slot] = None
                if rec.enabled:
                    rec.end("req.slot", pid=self.pid, tid=f"slot{slot}",
                            cat="request",
                            args={"rid": req.rid, "reason": "finished",
                                  "tokens": len(req.generated)})
        return emitted

    # ------------------------------------------------------ paged decode --
    def _alloc_blocks_reclaiming(self, n: int,
                                 keep_slot: Optional[int] = None
                                 ) -> Optional[List[int]]:
        """Allocate ``n`` blocks, reclaiming under pressure: first evict
        cached prefix entries (LRU), then preempt the youngest-admitted
        active slot (freeze → requeue at the head, zero token loss) —
        never ``keep_slot``, the slot the allocation is for."""
        ids = self._blocks.alloc(n)
        while ids is None:
            if self._prefix.evict_for_blocks(n, self._blocks) == 0:
                victims = [s for s, r in enumerate(self._active)
                           if r is not None and s != keep_slot]
                if not victims:
                    return None
                victim = max(victims, key=lambda s: self._slot_seq[s])
                req = self._active[victim]
                req.frozen = self._freeze_slot(victim, reason="preempt")
                self._queue.appendleft(req)
                self.stats.requeues += 1
            ids = self._blocks.alloc(n)
        return ids

    def _ensure_tail_blocks(self) -> None:
        """Pre-decode growth pass: every active slot must own a private
        block for the row this step writes.  Buckets are block-aligned,
        so growth happens exactly at block boundaries; the copy-on-write
        branch guards the shared-block invariant (a shared block is
        never written in place)."""
        bs = self.block_size
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            idx = self._slot_pos[slot] // bs
            if idx >= self._blocks.blocks_per_slot:
                continue             # finishes at the max_seq bound
            bid = int(self._blocks.tables[slot, idx])
            if bid != TRASH_BLOCK and self._blocks.refs[bid] <= 1:
                continue             # private tail already in place
            ids = self._alloc_blocks_reclaiming(1, keep_slot=slot)
            if ids is None:          # only this slot is active and the
                continue             # pool is drained; write lands in
                                     # trash and the request requeues
            if bid != TRASH_BLOCK:   # copy-on-write off a shared block
                self._pool = self._copy_block_fn()(self._pool, bid, ids[0])
                self._blocks.decref(bid)
            self._blocks.assign(slot, idx, ids[0])
            self._update_block_gauges()

    def _decode_paged(self) -> int:
        if not any(r is not None for r in self._active):
            return 0
        self._ensure_tail_blocks()
        self._fill_tokens()
        # block tables are runtime data: constant (slots, max_seq/bs)
        # shape, so occupancy/sharing churn reuses one program
        self._tables_in.copy_(torch.from_numpy(self._blocks.tables))
        step_fn = self._paged_decode_fn()
        params, cache, pool = self.params, self._cache, self._pool
        tokens, tables = self._tokens_in, self._tables_in

        def step():
            nxt, pos, _, _ = step_fn(params, cache, pool, tokens, tables)
            return torch.stack([nxt.to(torch.int32), pos.to(torch.int32)])

        # the block-table step is replayed as a graph; the gather step,
        # whose dense view is as large as a dense cache, stays eager
        out = self._run_step("paged" if self.opts.paged_kernel else None,
                             step)
        self.stats.decode_calls += 1
        return self._bookkeep_decode(out)

    def step(self) -> int:
        """One engine tick: admit waiting requests, decode one token for
        every active slot.  Returns number of tokens emitted."""
        self._admit()
        # time only the decode sweep: prefill costs would otherwise
        # masquerade as decode-step latency in the telemetry channel.  The
        # sweep ends in a device→host transfer, so the host clock covers
        # the device work.
        rec = self.recorder
        t0 = time.perf_counter()
        if rec.enabled:
            rec.begin("engine.step", pid=self.pid, tid="engine",
                      cat="engine", wall_s=t0,
                      args={"generation": self.generation})
        if self.decode_mode == "batched":
            emitted = self._decode_batched()
        elif self.decode_mode == "paged":
            emitted = self._decode_paged()
        else:
            emitted = self._decode_per_slot()
        self.stats.steps += 1
        self.stats.tokens_out += emitted
        t1 = time.perf_counter()
        dt = t1 - t0
        self.step_times.append(dt)
        self._ewma.update(dt)
        self._step_hist.observe(dt)
        if rec.enabled:
            rec.end("engine.step", pid=self.pid, tid="engine",
                    cat="engine", wall_s=t1, args={"emitted": emitted})
        if self.slo is not None and emitted:
            # every active slot advanced one token this step, so the
            # step wall time is each of those tokens' inter-token time
            self.slo.observe("tpot", dt, n=emitted)
        if self.on_step is not None:
            self.on_step(dt, emitted, self.generation)
        return emitted

    @property
    def step_time_ewma_s(self) -> Optional[float]:
        """Smoothed recent decode-step wall time (seconds), or ``None``
        before the first step: a view over the registry's
        ``engine.step_time_s`` EWMA gauge (``alpha=0.2``, i.e.
        ``0.8·prev + 0.2·dt``)."""
        return self._ewma.value

    def drain(self, max_steps: int = 10_000) -> None:
        while self.has_work and max_steps:
            self.step()
            max_steps -= 1

    # ---------------------------------------------------------- freeze/thaw --
    @property
    def fingerprint(self) -> tuple:
        """The freeze/thaw compatibility fingerprint: a
        :class:`FrozenRequest` thaws here iff its fingerprint equals this
        (same config, same runtime options, same weights).  Pool-storage
        options are normalized out: blobs hold KV in ``kv_cache_dtype``
        however the pool stores it, so an int8-pool blob thaws on a
        bf16-pool engine and the other way round (thaw re-quantizes), and
        ``paged_kernel`` never touches the blob.  Across ``kv_dtype`` the
        continuation decodes with the destination's numerics."""
        opts = self.opts.replace(kv_dtype="auto", paged_kernel=False)
        return (self.cfg, opts, self.params_version)

    def can_thaw(self, frozen: Optional[FrozenRequest]) -> bool:
        """Whether a frozen blob can resume here without re-prefill.  A
        blob frozen at the sequence bound has nowhere left to write, so
        it falls back to the requeue path (which truncates to the newest
        context)."""
        return (frozen is not None
                and frozen.fingerprint == self.fingerprint
                and frozen.pos < self.max_seq - 1)

    def _freeze_slot(self, slot: int, reason: str = "freeze"
                     ) -> FrozenRequest:
        """Serialize ``slot``'s in-flight state into a host-side
        :class:`FrozenRequest` and vacate the slot.  KV is densified
        (paged blocks gathered, rows trimmed to ``pos``) so the blob is
        portable across block sizes and into dense or per-slot engines;
        int8 pools dequantize into ``kv_cache_dtype``.  The sampling
        state carries the slot's advanced key, so a thawed stream
        continues as if never interrupted."""
        req = self._active[slot]
        if self.decode_mode == "per_slot":
            cache = self._caches[slot]
            pos = int(cache["pos"])
            leaves = {name: _host(leaf) for name, leaf in cache.items()
                      if name != "sample"}
            sample = {name: _host(v) for name, v in cache["sample"].items()}
        else:
            pos = (self._slot_pos[slot] if self.decode_mode == "paged"
                   else int(self._cache["pos"][slot]))
            leaves = {name: _host(leaf[slot])
                      for name, leaf in self._cache.items()
                      if name != "sample"}
            sample = {name: _host(arr[slot])
                      for name, arr in self._cache["sample"].items()}
        for name in _SEQ_TRIM_LEAVES:
            if name in leaves:
                leaves[name] = leaves[name][:, :, :pos]
        if self.decode_mode == "paged":
            # gather this slot's blocks into dense (n_attn, 1, pos, ...) KV
            bs = self.block_size
            nblk = blocks_needed(pos, bs)
            ids = self._to_device(self._blocks.tables[slot, :nblk]).long()
            for name in ("k", "v"):
                blocks = self._pool[name][ids]
                if name + "_scale" in self._pool:
                    blocks = kv_dequant_rows(
                        blocks, self._pool[name + "_scale"][ids],
                        dtype_of(self.opts.kv_cache_dtype))
                g = _host(blocks)          # (nblk, n_attn, bs, kvh, hd)
                n_attn, kvh, hd = g.shape[1], g.shape[3], g.shape[4]
                dense = g.transpose(0, 1).reshape(
                    n_attn, nblk * bs, kvh, hd)[:, :pos]
                leaves[name] = dense[:, None]
        frozen = FrozenRequest(rid=req.rid, pos=pos,
                               consumed=len(req.generated), leaves=leaves,
                               sample=sample, fingerprint=self.fingerprint,
                               reason=reason)
        self.stats.freezes += 1
        rec = self.recorder
        if rec.enabled:
            stamp = time.perf_counter()
            rec.instant("req.freeze", pid=self.pid, tid=f"slot{slot}",
                        cat="request", wall_s=stamp,
                        args={"rid": req.rid, "reason": reason, "pos": pos})
            rec.end("req.slot", pid=self.pid, tid=f"slot{slot}",
                    cat="request", wall_s=stamp,
                    args={"rid": req.rid, "reason": reason,
                          "tokens": len(req.generated)})
        self._active[slot] = None
        if self.decode_mode == "paged":
            self._blocks.release_slot(slot)
            self._update_block_gauges()
        return frozen

    def freeze(self, rid: int) -> Optional[Request]:
        """Freeze the active request with id ``rid`` and hand it back
        (blob attached as ``req.frozen``); the caller owns it and may
        :meth:`thaw` it on a compatible engine.  Returns ``None`` when
        ``rid`` is not decoding here."""
        for slot, r in enumerate(self._active):
            if r is not None and r.rid == rid:
                r.frozen = self._freeze_slot(slot, reason="freeze")
                return r
        return None

    def freeze_all(self, reason: str = "freeze") -> List[Request]:
        """Freeze every in-flight request (slot order) and hand the
        detached requests back — the migration primitive."""
        out: List[Request] = []
        for slot, r in enumerate(self._active):
            if r is not None:
                r.frozen = self._freeze_slot(slot, reason=reason)
                out.append(r)
        return out

    def thaw(self, req: Request) -> bool:
        """Accept a frozen request at the *head* of the queue: it resumes
        with zero re-prefill at the next admission if its blob matches
        this engine's fingerprint.  Returns False when the blob is
        incompatible — it is dropped and the request re-admits by
        re-prefilling prompt + generated (still zero token loss)."""
        ok = self.can_thaw(req.frozen)
        if not ok and req.frozen is not None:
            self._discard_frozen(req)
        self._queue.appendleft(req)
        return ok

    def _discard_frozen(self, req: Request) -> None:
        """Fingerprint-mismatch fallback: fold the generated suffix into
        the prompt and drop the blob.  The request re-admits through an
        ordinary prefill, its key folded with its consumed count so the
        stream advances instead of replaying."""
        req.prompt = np.concatenate([np.asarray(req.prompt, np.int32),
                                     np.asarray(req.generated, np.int32)])
        req.frozen = None

    def _padded_to(self, src: torch.Tensor, shape, dtype) -> torch.Tensor:
        """A trimmed blob leaf zero-padded back to a full cache leaf, as a
        new tensor on the engine's device."""
        if tuple(src.shape) == tuple(shape):
            return src.to(self.device, dtype, copy=True)
        buf = torch.zeros(tuple(shape), dtype=dtype)
        buf[tuple(slice(0, d) for d in src.shape)] = src
        return buf.to(self.device)

    def _thaw_capacity_ok(self, frozen: FrozenRequest) -> bool:
        """Paged-mode admission guard: can the pool cover this blob's
        blocks now (after evicting cached prefixes if needed)?  Off the
        paged path there is nothing to allocate."""
        if self.decode_mode != "paged":
            return True
        need = blocks_needed(frozen.pos, self.block_size)
        if self._blocks.free_blocks < need:
            self._prefix.evict_for_blocks(need, self._blocks)
        return self._blocks.free_blocks >= need

    def _thaw_into_slot(self, req: Request, slot: int) -> None:
        """Re-materialize a frozen request in ``slot`` with zero
        re-prefill: blob leaves are zero-padded back to full cache shape
        (padding beyond ``pos`` is never read unmasked) and the slot
        resumes from the blob's advanced sampling key."""
        fz = req.frozen
        key = fz.sample["key"].to(self.device)
        temp = fz.sample["temp"].to(self.device, torch.float32)
        top_k = fz.sample["top_k"].to(self.device, torch.int32)
        if self.decode_mode == "per_slot":
            cache = init_cache(self.cfg, 1, self.max_seq, self.opts,
                               self.device)
            cache = {name: self._padded_to(fz.leaves[name], leaf.shape,
                                           leaf.dtype)
                     for name, leaf in cache.items()}
            cache["sample"] = {"key": key, "temp": temp, "top_k": top_k}
            self._caches[slot] = cache
        elif self.decode_mode == "batched":
            row = {name: self._padded_to(fz.leaves[name], leaf.shape[1:],
                                         leaf.dtype)
                   for name, leaf in self._cache.items() if name != "sample"}
            self._cache = self._programs.admit_slot(self._cache, row, slot,
                                                    key, temp, top_k)
        else:
            bs = self.block_size
            nblk = blocks_needed(fz.pos, bs)
            # program count stays bounded: the scatter is keyed on the
            # *bucketed* block count, trailing ids aimed at trash
            nblk_prog = self._bucket(fz.pos) // bs
            ids = self._alloc_blocks_reclaiming(nblk, keep_slot=slot)
            if ids is None:
                raise RuntimeError("paged pool cannot hold one thawed "
                                   "request — pool_blocks misconfigured")
            for j, b in enumerate(ids):
                self._blocks.assign(slot, j, b)
            rows = {}
            for name in ("k", "v"):
                src = fz.leaves[name][:, 0]          # (n_attn, pos, kvh, hd)
                n_attn, _, kvh, hd = src.shape
                buf = torch.zeros((n_attn, nblk_prog * bs, kvh, hd),
                                  dtype=src.dtype)
                buf[:, :fz.pos] = src
                rows[name] = buf.reshape(n_attn, nblk_prog, bs, kvh, hd) \
                    .transpose(0, 1).to(self.device)
            ids_arr = np.full(nblk_prog, TRASH_BLOCK, np.int64)
            ids_arr[:nblk] = ids
            self._pool = self._thaw_scatter_fn(nblk_prog)(
                self._pool, rows["k"], rows["v"], self._to_device(ids_arr))
            row = {name: self._padded_to(fz.leaves[name], leaf.shape[1:],
                                         leaf.dtype)
                   for name, leaf in self._cache.items() if name != "sample"}
            self._cache = self._paged_admit_fn()(self._cache, row, slot, key,
                                                 temp, top_k)
            self._slot_pos[slot] = fz.pos
            self._slot_seq[slot] = next(self._admit_seq)
            self._update_block_gauges()
        req.frozen = None
        self._active[slot] = req
        self.stats.thaws += 1
        if self.recorder.enabled:
            stamp = time.perf_counter()
            self.recorder.instant("req.thaw", pid=self.pid,
                                  tid=f"slot{slot}", cat="request",
                                  wall_s=stamp,
                                  args={"rid": req.rid, "pos": fz.pos,
                                        "consumed": fz.consumed})
            self.recorder.begin("req.slot", pid=self.pid, tid=f"slot{slot}",
                                cat="request", wall_s=stamp,
                                args={"rid": req.rid})

    def drain_waiting(self) -> List[Request]:
        """Detach every *waiting* (queued, not yet admitted) request in
        FIFO order — a migration re-submits them on the destination
        engine beside the frozen in-flight ones."""
        out = list(self._queue)
        self._queue.clear()
        return out

    # ----------------------------------------------------------- adaptation --
    def requeue_active(self, reason: str = "requeue") -> int:
        """Re-queue every in-flight request at the head of the queue with
        zero token loss and zero re-prefill: each is frozen and thaws
        straight back when its blob matches the engine's fingerprint.
        Incompatible blobs (after a variant swap) fall back to
        re-prefilling prompt + generated.  Returns the number
        re-queued."""
        pending: List[Request] = []
        for slot, r in enumerate(self._active):
            if r is not None:
                r.frozen = self._freeze_slot(slot, reason=reason)
                pending.append(r)
        for r in reversed(pending):
            self._queue.appendleft(r)
        self.stats.requeues += len(pending)
        return len(pending)

    def swap_model(self, cfg: ModelConfig, params: Params,
                   opts: RuntimeOptions,
                   params_version: Optional[int] = None) -> None:
        """Switch the serving variant (the middleware's hook).  Active
        requests are frozen and re-queued; after the caches are rebuilt
        they thaw with zero re-prefill when the new binding matches their
        blob (same cfg, opts and weights), and re-prefill their generated
        prefix when the variant really changed.  Programs come from the
        compile cache, so swapping back to a served variant builds
        nothing; the CUDA graphs bind the old buffers and go with them.
        ``params`` must already be on the engine's device."""
        requeued = self.requeue_active(reason="swap_requeue")
        if self.recorder.enabled:
            self.recorder.instant(
                "engine.swap", pid=self.pid, tid="engine", cat="engine",
                args={"generation": self.generation + 1,
                      "requeued": requeued})
        self.cfg, self.opts = cfg, opts
        self.params = cast_params(params, dtype_of(cfg.activation_dtype))
        self.params_version = (params_version if params_version is not None
                               else id(params))
        self.generation += 1
        self._programs = self._bind_programs()
        self._reset_caches()
        # blobs that cannot thaw against the new binding re-admit by
        # prefill; dropping them up front lets the whole requeue merge
        # into one admission burst instead of k head-of-line fragments
        for r in self._queue:
            if r.frozen is not None and not self.can_thaw(r.frozen):
                self._discard_frozen(r)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that no later step writes into."""
    return t.detach().to("cpu", copy=True)
