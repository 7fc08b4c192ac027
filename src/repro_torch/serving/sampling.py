"""Per-request sampling policy for the serving engine.

:class:`SamplingOpts` is the host-side description of how one request's
tokens are drawn; the *device-side* state it induces (a PRNG key, a
temperature and a top-k per slot) lives inside the slot-stacked cache
pytree (see :func:`repro_torch.models.model.init_slot_cache`), so it is
donated, vmapped and slot-scattered exactly like the model's KV/SSM
state.  Because temperature/top-k/keys are runtime *arrays*, not compile
constants, sampling never enters a :class:`CompileCache` key — engines
with heterogeneous per-slot policies still share one decode program.

``temperature == 0`` short-circuits (on device, via ``jnp.where``) to
the exact argmax the pre-sampling engine computed, so greedy token
streams are bit-identical to the historical greedy decode.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SamplingOpts", "DEFAULT_SAMPLING", "request_key"]


@dataclass(frozen=True)
class SamplingOpts:
    """How one request's continuation is sampled.

    ``temperature`` — 0 selects greedy argmax (bit-identical to the
    pre-sampling decode path); > 0 samples from the softmax of
    ``logits / temperature``.  ``top_k`` — 0 keeps the full vocabulary;
    k > 0 masks everything below the k-th largest logit (``top_k=1`` is
    argmax again).  ``seed`` — folded with the request id into the
    slot's PRNG key, so fixed seeds give reproducible streams."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


DEFAULT_SAMPLING = SamplingOpts()


def request_key(seed: int, rid: int, consumed: int = 0) -> np.ndarray:
    """Deterministic per-request PRNG key material (``(2,) uint32``).

    Depends only on ``(seed, rid, tokens already generated)`` — never on
    the slot index, the admission order or the decode mode — so a
    request's sampled stream is reproducible across runs and identical
    across the batched and per-slot decode paths.  A swap re-queue is
    re-admitted with its ``consumed`` count folded in, so the resumed
    continuation advances the stream instead of replaying it."""
    hi = (int(seed) ^ (int(consumed) * 2654435761)) & 0xFFFFFFFF
    return np.array([hi, int(rid) & 0xFFFFFFFF], dtype=np.uint32)
