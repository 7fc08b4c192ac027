"""Serving runtime: request scheduler + slot-batched decode engine.

Port of the JAX package's ``ServingEngine``.  Requests queue, are
admitted into fixed decode slots by burst prefill, and every tick one
slot-batched decode step advances every slot and samples on the device.
Two decode modes:

* ``decode_mode="batched"`` (the default, as in the JAX package) — ONE
  slot-stacked cache of shape ``(slots, ...)`` (dense KV for attention
  stacks, SSM and conv state for the SSM stack) and one step per tick.
  Free slots are decoded too and their outputs ignored, never skipped.
  Ticks on which no active slot samples take the pure-argmax step.
  ``prefill_mode="per_request"`` admits one request per prefill call
  instead of a burst.
* ``decode_mode="paged"`` — self-attention KV lives in a
  :class:`~repro_torch.serving.paging.BlockPool` and the step reads it
  straight through the block tables with the paged decode kernel
  (``paged_kernel=True``; ``kv_dtype="int8"`` stores the pool int8).

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
  step, this engine's steps update them in place.

Not ported yet: the ``per_slot`` decode mode, freeze/thaw (and with it
preemption under pool pressure and ``swap_model``), and the
injected-OOM admission hold-off.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.layers import Params, cast_params, dtype_of
from ..models.model import (init_cache, init_paged_pool,
                            init_paged_slot_cache, init_slot_cache)
from ..models.runtime import DEFAULT_OPTIONS, RuntimeOptions
from ..obs.metrics import MetricsRegistry
from ..obs.recorder import NULL_RECORDER
from .compile_cache import GLOBAL_COMPILE_CACHE, CompileCache, ServePrograms
from .paging import (DEFAULT_BLOCK_SIZE, TRASH_BLOCK, BlockPool,
                     PrefixCache, PrefixEntry, block_hash_chain)
from .sampling import DEFAULT_SAMPLING, SamplingOpts, request_key

DECODE_MODES = ("batched", "paged")
_LATER_MODES = ("per_slot",)
PREFILL_MODES = ("batched", "per_request")

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


class ServeStats:
    """Counters for one engine's lifetime, as a view over its
    :class:`~repro_torch.obs.metrics.MetricsRegistry`: ``steps`` taken,
    ``decode_calls`` (steps that ran the decode program — the ones that
    launch the decode kernels), ``tokens_out`` emitted (prefill +
    decode), ``prefills`` (requests prefilled), ``prefill_calls``
    (prefill invocations — a burst of k is k prefills but 1 call),
    ``sampled_tokens`` (tokens drawn at temperature > 0) and
    ``recompiles`` (programs this engine caused to be built)."""

    _COUNTERS = {"steps": "engine.steps",
                 "decode_calls": "engine.decode_calls",
                 "tokens_out": "engine.tokens_out",
                 "prefills": "engine.prefills",
                 "prefill_calls": "engine.prefill_calls",
                 "sampled_tokens": "engine.sampled_tokens",
                 "recompiles": "engine.recompiles"}

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

    def __repr__(self) -> str:
        fields = ", ".join(f"{a}={self._get(a)}" for a in self._COUNTERS)
        return f"ServeStats({fields})"


class ServingEngine:
    """Slot-based continuous batching.

    ``slots`` fixes the decode batch width (requests beyond it queue);
    ``max_seq`` bounds prompt+generation length per slot.  In the paged
    mode ``opts`` must select the block-table step (``paged_kernel=
    True``); ``kv_dtype="int8"`` stores the pool int8 with per-row
    scales.  The batched mode keeps its dense cache in
    ``kv_cache_dtype`` and refuses both paged options; its
    ``prefill_mode`` is ``"batched"`` (bursts) or ``"per_request"``.
    ``sampling`` is
    the default :class:`SamplingOpts` for requests that carry none.
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
        if decode_mode in _LATER_MODES:
            raise NotImplementedError(
                f"decode_mode={decode_mode!r} is not ported yet; "
                f"the port serves {DECODE_MODES}")
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
        # the paged path only has burst admission (its per-request path
        # is the k=1 burst)
        self.prefill_mode = "batched" if decode_mode == "paged" \
            else prefill_mode
        self.block_size = block_size
        self.pool_blocks = pool_blocks
        self.prefix_entries = prefix_entries
        # salts the prefix hashes: KV content is a function of the weights
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
        self._queue: Deque[Request] = deque()
        self._active: List[Optional[Request]] = [None] * slots
        self._programs: ServePrograms = self._bind_programs()
        self._reset_caches()
        # wall time of recent decode sweeps (bounded: engines are
        # long-lived)
        self.step_times: Deque[float] = deque(maxlen=2048)

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
            self._note_compile("programs")
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

    def _copy_block_fn(self) -> Callable:
        fn, fresh = self._programs.copy_block(self.pool_blocks,
                                              self.block_size)
        if fresh:
            self._note_compile("copy_block")
        return fn

    def _reset_caches(self) -> None:
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
        self._prefix = PrefixCache(self.prefix_entries)
        # host-authoritative next-write position per slot (mirrors the
        # device ``pos`` leaf; drives tail-block growth)
        self._slot_pos = [0] * self.slots
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
            req.first_token_s = stamp
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
            # prompt exceeds max_seq: keep the newest context
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
            if self.prefix_entries > 0:
                self._prefix.insert(
                    self._prefix.key_of(padded, self.params_version),
                    PrefixEntry(
                        block_ids=tuple(
                            int(b) for b in self._blocks.tables[slot, :nblk]),
                        logits_row=last[pad + i],
                        leaves={"pos": np.asarray(bucket, np.int32)},
                        pos=bucket),
                    self._blocks)
            if not self._emit_first(req, int(first[pad + i]), stamp, free,
                                    slot):
                # budget completed at prefill: the slot's references go,
                # but a cached prefix entry keeps the blocks live
                self._blocks.release_slot(slot)
            self._update_block_gauges()

    def _admit_from_prefix(self, req: Request, entry: PrefixEntry,
                           free: List[int]) -> None:
        """Admit a request whose padded prompt hit the prefix cache: no
        prefill call at all.  Shared blocks are increfed into the slot's
        table, ``pos`` and the request's own sampling state are written
        to its slot, and the first token is sampled from the cached
        last-position logits row with the request's own key."""
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
        self._cache = self._programs.admit_slot(self._cache, cache, slot,
                                                key, temp, top_k)

    def _admit(self) -> None:
        free = [s for s in range(self.slots) if self._active[s] is None]
        while free and self._queue:
            head = self._queue[0]
            if len(head.generated) >= head.max_new_tokens:
                # submitted with its budget already spent: emitting a
                # prefill token would overshoot it
                self._queue.popleft()
                head.done = True
                continue
            if self.decode_mode == "paged":
                if not self._admit_paged_head(head, free):
                    break           # pool exhausted: wait for decode frees
            elif self.prefill_mode == "batched":
                bucket, batch = self._gather_burst(len(free))
                self._admit_burst(batch, bucket, free)
            else:
                self._queue.popleft()
                self._admit_one(head, free)

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

    def _bookkeep_decode(self, nxt: torch.Tensor, pos: torch.Tensor) -> int:
        """Post-step bookkeeping: one bulk device→host transfer, per-slot
        token append, finish detection and trace emission."""
        nxt, pos = torch.stack([nxt.to(torch.int32),
                                pos.to(torch.int32)]).cpu().numpy()
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

    def _decode_batched(self) -> int:
        if not any(r is not None for r in self._active):
            return 0
        tokens = np.zeros(self.slots, np.int32)
        sampling = False
        for slot, req in enumerate(self._active):
            if req is not None:
                tokens[slot] = req.generated[-1]
                sampling = sampling or \
                    self._sampling_of(req).temperature > 0
        # all-greedy ticks take the pure-argmax step; tokens are the same
        # either way, so mixed workloads can alternate
        step_fn = (self._programs.decode if sampling
                   else self._programs.decode_greedy)
        nxt, pos, self._cache = step_fn(self.params, self._cache,
                                        self._to_device(tokens))
        self.stats.decode_calls += 1
        return self._bookkeep_decode(nxt, pos)

    # ------------------------------------------------------ paged decode --
    def _alloc_blocks_reclaiming(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, evicting cached prefix entries (LRU)
        under pressure.  Preempting an active request would need
        freeze/thaw, which is not ported: a pool too small for its
        active requests raises instead."""
        ids = self._blocks.alloc(n)
        while ids is None:
            if self._prefix.evict_for_blocks(n, self._blocks) == 0:
                raise NotImplementedError(
                    "the pool is exhausted by active requests; preemption "
                    "needs freeze/thaw, which is not ported yet — size "
                    "pool_blocks for slots * max_seq / block_size + 1")
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
            ids = self._alloc_blocks_reclaiming(1)
            if bid != TRASH_BLOCK:   # copy-on-write off a shared block
                self._pool = self._copy_block_fn()(self._pool, bid, ids[0])
                self._blocks.decref(bid)
            self._blocks.assign(slot, idx, ids[0])
            self._update_block_gauges()

    def _decode_paged(self) -> int:
        if not any(r is not None for r in self._active):
            return 0
        self._ensure_tail_blocks()
        tokens = np.zeros(self.slots, np.int32)
        for slot, req in enumerate(self._active):
            if req is not None:
                tokens[slot] = req.generated[-1]
        # block tables are runtime data: constant (slots, max_seq/bs)
        # shape, so occupancy/sharing churn reuses one program
        nxt, pos, self._cache, self._pool = self._paged_decode_fn()(
            self.params, self._cache, self._pool, self._to_device(tokens),
            self._to_device(self._blocks.tables))
        self.stats.decode_calls += 1
        return self._bookkeep_decode(nxt, pos)

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
                      cat="engine", wall_s=t0)
        emitted = (self._decode_batched() if self.decode_mode == "batched"
                   else self._decode_paged())
        self.stats.steps += 1
        self.stats.tokens_out += emitted
        t1 = time.perf_counter()
        self.step_times.append(t1 - t0)
        if rec.enabled:
            rec.end("engine.step", pid=self.pid, tid="engine",
                    cat="engine", wall_s=t1, args={"emitted": emitted})
        return emitted

    def drain(self, max_steps: int = 10_000) -> None:
        while self.has_work and max_steps:
            self.step()
            max_steps -= 1
