"""Process-wide cache of serving programs.

``CompileCache`` keys program sets on ``(cfg, opts, slots, max_seq,
domain)`` and hands the *same* program objects to every engine that
asks, exactly as the JAX package's cache does for its jitted programs.
PyTorch runs eagerly and has no jit, so here a "compile" is the first
build of a program for its key: the engine counts it in
``ServeStats.recompiles``, which therefore keeps its meaning — 0 for an
engine whose programs were all built already, and no growth across
occupancy churn, because block tables, positions and sampling state are
runtime tensors and never enter a key.

The batched mode's programs, as in the JAX package:

* ``decode`` — one sampling step over the slot-stacked cache (updated
  in place where the JAX package donates it)
* ``decode_greedy`` — the pure-argmax step, which the engine takes on
  ticks where no active slot samples
* ``decode_ref`` / ``sample_ref`` — the batch=1 ``decode_step`` and
  ``sample_step`` of the ``per_slot`` reference loop
* ``sample_first`` — draws a first token from a prefill's logits row
* ``admit_slot`` — writes a batch=1 prefill and its sampling state into
  one slot
* ``prefill(bucket)`` — batch=1 prefill for one prompt bucket, lazy
* ``prefill_batch(bucket, k)`` — ONE-call burst admission of ``(k,
  bucket)`` prompts into their slots, lazy, keyed on the k-bucket

Those built with the entry count no compile of their own, as in the
JAX package (whose ``jit`` objects are made there and compile at first
call); the lazy ones count one each.  Paged-mode programs are lazy dicts
keyed on the pool geometry ``(num_blocks, block_size)`` (and the prompt
bucket and burst k-bucket for admission), as in the JAX package:

* ``paged_decode(nb, bs)`` — one batched sampling step, through the
  paged decode kernel (``paged_kernel=True``) or by gathering each slot's
  blocks to a dense view first (slot cache and pool updated in place)
* ``paged_prefill_batch(bucket, k, nb, bs)`` — burst admission that
  writes prefilled KV into destination blocks
* ``paged_admit`` — writes ``pos`` + sampling state into one slot
  (prefix-cache re-admission)
* ``thaw_scatter(nblk, nb, bs)`` — writes a thawed request's densified
  KV into ``nblk`` blocks (keyed on the bucketed block count)
* ``copy_block(nb, bs)`` — copy-on-write block duplication
* ``sample_first`` — draws a first token from a cached logits row
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

from ..models.configs import ModelConfig
from ..models.model import (admit_slot, batched_prefill_admit, decode_step,
                            greedy_batched_step, paged_copy_block,
                            paged_kernel_sample_batched_step,
                            paged_prefill_admit, paged_sample_batched_step,
                            paged_thaw_write, prefill, sample_batched_step,
                            sample_logits, sample_step)
from ..models.runtime import RuntimeOptions

Key = Tuple[ModelConfig, RuntimeOptions, int, int, str]


class ServePrograms:
    """The serving programs for one (cfg, opts, slots, max_seq, domain)."""

    def __init__(self, cfg: ModelConfig, opts: RuntimeOptions,
                 max_seq: int):
        self._cfg, self._opts, self._max_seq = cfg, opts, max_seq
        self.decode: Callable = functools.partial(
            _decode, step=sample_batched_step, cfg=cfg, opts=opts)
        self.decode_greedy: Callable = functools.partial(
            _decode, step=greedy_batched_step, cfg=cfg, opts=opts)
        self.decode_ref: Callable = functools.partial(
            _decode, step=decode_step, cfg=cfg, opts=opts)
        self.sample_ref: Callable = functools.partial(
            _decode, step=sample_step, cfg=cfg, opts=opts)
        self.sample_first: Callable = functools.partial(
            _sample_first, vocab=cfg.vocab_size)
        self.admit_slot: Callable = admit_slot
        self._prefills: Dict[int, Callable] = {}
        self._prefill_batches: Dict[Tuple[int, int], Callable] = {}
        self._paged_decodes: Dict[Tuple[int, int], Callable] = {}
        self._paged_prefill_batches: Dict[Tuple[int, int, int, int],
                                          Callable] = {}
        self._paged_admit: Dict[str, Callable] = {}
        self._thaw_scatters: Dict[Tuple[int, int, int], Callable] = {}
        self._copy_blocks: Dict[Tuple[int, int], Callable] = {}

    def prefill(self, bucket: int) -> Tuple[Callable, bool]:
        """The batch=1 prefill for one prompt bucket, plus whether this
        call built it."""
        fresh = bucket not in self._prefills
        if fresh:
            self._prefills[bucket] = functools.partial(
                _prefill, cfg=self._cfg, opts=self._opts)
        return self._prefills[bucket], fresh

    def prefill_batch(self, bucket: int, k: int) -> Tuple[Callable, bool]:
        """The one-call burst admission for ``(prompt bucket, k-bucket)``:
        prefill ``(k, bucket)`` stacked prompts and write each row's cache
        and sampling state into its slot of the slot-stacked cache."""
        fresh = (bucket, k) not in self._prefill_batches
        if fresh:
            self._prefill_batches[(bucket, k)] = functools.partial(
                _prefill_batch, cfg=self._cfg, opts=self._opts,
                max_seq=self._max_seq)
        return self._prefill_batches[(bucket, k)], fresh

    def paged_decode(self, num_blocks: int,
                     block_size: int) -> Tuple[Callable, bool]:
        """The batched paged sampling step for one pool geometry, plus
        whether this call built it: through the block tables with the
        paged decode kernel when ``opts.paged_kernel``, else gathered to
        a dense view.  Block tables ride in as runtime data, so every
        occupancy shares this one program."""
        key = (num_blocks, block_size)
        fresh = key not in self._paged_decodes
        if fresh:
            step = (paged_kernel_sample_batched_step
                    if self._opts.paged_kernel else paged_sample_batched_step)
            self._paged_decodes[key] = functools.partial(
                _paged_decode, step=step, cfg=self._cfg, opts=self._opts)
        return self._paged_decodes[key], fresh

    def paged_prefill_batch(self, bucket: int, k: int, num_blocks: int,
                            block_size: int) -> Tuple[Callable, bool]:
        """Burst admission into the paged cache for ``(prompt bucket,
        k-bucket)``: KV rows go into destination blocks, ``pos`` and
        sampling state into slots."""
        key = (bucket, k, num_blocks, block_size)
        fresh = key not in self._paged_prefill_batches
        if fresh:
            self._paged_prefill_batches[key] = functools.partial(
                _paged_prefill, cfg=self._cfg, opts=self._opts)
        return self._paged_prefill_batches[key], fresh

    def paged_admit(self) -> Tuple[Callable, bool]:
        """``admit_slot`` over the paged (KV-less) slot cache."""
        fresh = "admit" not in self._paged_admit
        if fresh:
            self._paged_admit["admit"] = admit_slot
        return self._paged_admit["admit"], fresh

    def thaw_scatter(self, nblk: int, num_blocks: int,
                     block_size: int) -> Tuple[Callable, bool]:
        """Writes ``nblk`` densified thawed KV blocks into the pool;
        keyed on the block count, which callers bucket through the
        prompt buckets so thaws of similar depth share programs."""
        key = (nblk, num_blocks, block_size)
        fresh = key not in self._thaw_scatters
        if fresh:
            self._thaw_scatters[key] = paged_thaw_write
        return self._thaw_scatters[key], fresh

    def copy_block(self, num_blocks: int,
                   block_size: int) -> Tuple[Callable, bool]:
        """Copy-on-write block duplication, one program per geometry."""
        key = (num_blocks, block_size)
        fresh = key not in self._copy_blocks
        if fresh:
            self._copy_blocks[key] = paged_copy_block
        return self._copy_blocks[key], fresh


def _sample_first(logits_row, key, temp, top_k, *, vocab):
    return sample_logits(logits_row, key, temp, top_k, vocab)


def _decode(params, cache, tokens, *, step, cfg, opts):
    return step(params, cfg, cache, tokens, opts)


def _prefill(params, cache, tokens, *, cfg, opts):
    return prefill(params, cfg, tokens, cache, opts)


def _prefill_batch(params, stacked, tokens, slot_ids, keys, temps, top_ks,
                   *, cfg, opts, max_seq):
    return batched_prefill_admit(params, cfg, stacked, tokens, slot_ids,
                                 keys, temps, top_ks, opts, max_seq)


def _paged_decode(params, slot_cache, pool, tokens, tables, *, step, cfg,
                  opts):
    return step(params, cfg, slot_cache, pool, tokens, tables, opts)


def _paged_prefill(params, slot_cache, pool, tokens, slot_ids, keys, temps,
                   top_ks, dest, *, cfg, opts):
    return paged_prefill_admit(params, cfg, slot_cache, pool, tokens,
                               slot_ids, keys, temps, top_ks, dest, opts)


class CompileCache:
    """Shares :class:`ServePrograms` across engines.  Thread-hostile like
    the rest of the serving layer (one engine loop per process)."""

    def __init__(self):
        self._entries: Dict[Key, ServePrograms] = {}

    def entry_for(self, cfg: ModelConfig, opts: RuntimeOptions, slots: int,
                  max_seq: int, domain: str = ""
                  ) -> Tuple[ServePrograms, bool]:
        key: Key = (cfg, opts, slots, max_seq, domain)
        entry = self._entries.get(key)
        if entry is not None:
            return entry, False
        entry = ServePrograms(cfg, opts, max_seq)
        self._entries[key] = entry
        return entry, True


# Engines that aren't handed an explicit cache share this one.
GLOBAL_COMPILE_CACHE = CompileCache()
