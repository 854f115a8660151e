"""Deterministic, host-sharded synthetic data.  A NumPy copy of
``repro.data.pipeline``: the batches equal the reference's array for array.

Every batch is a pure function of ``(seed, host_id, n_hosts, step)``: no
filesystem, no coordination, the same batch when a step is replayed after a
recovery (``train/ft.py``).  The token stream is the affine Markov chain
``x[t+1] = (a * x[t] + c) % V`` from a random start per sequence: learnable
structure, so a few steps of training visibly lower the loss.  The frontend
stubs are seeded normals times 0.02, drawn after the tokens from the same
generator: a vlm's ``patch_embeds`` ``[b, n_patches, d_model]`` and an audio
model's ``frames`` ``[b, encoder_seq, d_model]``, float32.  The arrays are
NumPy; the caller puts them on its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    chain_a: int = 31
    chain_c: int = 7


class ShardedSyntheticStream:
    """Yields the host-local slice of each global batch."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, n_hosts: int = 1,
                 family: str = "dense", model_cfg=None):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} not divisible by {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self.family = family
        self.model_cfg = model_cfg

    def batch(self, step: int) -> dict:
        """``{"tokens", "labels"}``: int32 ``[local_batch, seq_len]``, the
        labels the tokens shifted by one; and ``patch_embeds`` or ``frames``
        for a vlm or audio stream given its ``model_cfg``."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.host_id, step))
        starts = rng.integers(0, cfg.vocab_size, size=(self.local_batch, 1))
        seq = np.empty((self.local_batch, cfg.seq_len + 1), np.int64)
        seq[:, 0] = starts[:, 0]
        for t in range(cfg.seq_len):
            seq[:, t + 1] = (cfg.chain_a * seq[:, t] + cfg.chain_c) % cfg.vocab_size
        out = {"tokens": seq[:, :-1].astype(np.int32), "labels": seq[:, 1:].astype(np.int32)}
        mc = self.model_cfg
        if self.family == "vlm" and mc is not None:
            out["patch_embeds"] = rng.standard_normal(
                (self.local_batch, mc.n_patches, mc.d_model), np.float32) * 0.02
        if self.family == "audio" and mc is not None:
            out["frames"] = rng.standard_normal(
                (self.local_batch, mc.encoder_seq, mc.d_model), np.float32) * 0.02
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_stream_for(model_cfg, seq_len: int, global_batch: int, *, seed: int = 0,
                    host_id: int = 0, n_hosts: int = 1) -> ShardedSyntheticStream:
    return ShardedSyntheticStream(
        DataConfig(model_cfg.vocab_size, seq_len, global_batch, seed=seed),
        host_id=host_id, n_hosts=n_hosts, family=model_cfg.family, model_cfg=model_cfg,
    )
