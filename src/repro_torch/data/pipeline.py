"""Synthetic data pipeline.

Deterministic, seekable token streams (a mixture of Zipfian unigram noise
and copy/induction patterns so a ~100M model has real structure to learn),
plus drift injection for the TTA experiments — the live-data distribution
shift the paper's runtime parameter adaptation handles.

Batches are made on the host as numpy, by the same ``np.random`` calls as
the JAX package's pipeline (the same seed and index give the same
bytes), and :func:`place_batch` copies them to the device as tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.configs import InputShape, ModelConfig


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_period: int = 16      # induction structure: token repeats period
    drift: float = 0.0         # 0..1 distribution shift magnitude


class SyntheticLM:
    """Seekable synthetic LM stream: batch(i) is pure function of (seed, i)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        v = cfg.vocab_size
        rng = np.random.default_rng(cfg.seed)
        base = 1.0 / np.arange(1, v + 1) ** cfg.zipf_a
        self.base_probs = base / base.sum()
        # drifted distribution: permuted zipf mixed in
        perm = rng.permutation(v)
        self.drift_probs = self.base_probs[perm]

    def probs(self) -> np.ndarray:
        d = self.cfg.drift
        return (1 - d) * self.base_probs + d * self.drift_probs

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, index))
        p = self.probs()
        toks = rng.choice(c.vocab_size, size=(c.batch_size, c.seq_len + 1),
                          p=p).astype(np.int32)
        # induction structure: every copy_period-th token repeats the one
        # copy_period earlier — learnable signal for the train driver
        for off in range(c.copy_period, c.seq_len + 1, c.copy_period):
            toks[:, off] = toks[:, off - c.copy_period]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def make_batch_fn(cfg: ModelConfig, shape: InputShape, seed: int = 0,
                  drift: float = 0.0):
    """Batch factory including the modality-stub inputs (audio frames /
    vision patch embeddings) each arch family needs."""
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=shape.seq_len,
                                  batch_size=shape.global_batch,
                                  seed=seed, drift=drift))

    def get(index: int) -> Dict[str, np.ndarray]:
        b = data.batch(index)
        rng = np.random.default_rng((seed, index, 7))
        if cfg.is_encoder_decoder:
            b["encoder_frames"] = rng.standard_normal(
                (shape.global_batch, cfg.encoder_seq_len, cfg.d_model)
            ).astype(np.float32) * 0.1
        if cfg.vision_embed_dim:
            b["vision_embeds"] = rng.standard_normal(
                (shape.global_batch, cfg.num_vision_tokens,
                 cfg.vision_embed_dim)).astype(np.float32) * 0.1
        return b

    return get


def place_batch(batch: Dict[str, np.ndarray],
                device="cuda") -> Dict[str, torch.Tensor]:
    """Each array of ``batch`` as a tensor on ``device`` (one host-to-
    device copy each; the JAX package's ``device_put`` with the batch
    sharding, on one device)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
