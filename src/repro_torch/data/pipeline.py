"""Deterministic, host-sharded synthetic data.  A NumPy copy of
``repro.data.pipeline``: the batches equal the reference's array for array.

Every batch is a pure function of ``(seed, host_id, n_hosts, step)``: no
filesystem, no coordination, the same batch when a step is replayed after a
recovery (``train/ft.py``).  The token stream is the affine Markov chain
``x[t+1] = (a * x[t] + c) % V`` from a random start per sequence: learnable
structure, so a few steps of training visibly lower the loss.  The arrays are
NumPy; the caller puts them on its device.  (The vlm patches and audio frames
of the reference come with those families, ROADMAP.md Queue A item 9.)
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
        if family in ("vlm", "audio"):
            raise NotImplementedError(f"the {family!r} family's batches come with ROADMAP.md "
                                      "Queue A item 9")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self.family = family
        self.model_cfg = model_cfg

    def batch(self, step: int) -> dict:
        """``{"tokens", "labels"}``: int32 ``[local_batch, seq_len]``, the
        labels the tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.host_id, step))
        starts = rng.integers(0, cfg.vocab_size, size=(self.local_batch, 1))
        seq = np.empty((self.local_batch, cfg.seq_len + 1), np.int64)
        seq[:, 0] = starts[:, 0]
        for t in range(cfg.seq_len):
            seq[:, t + 1] = (cfg.chain_a * seq[:, t] + cfg.chain_c) % cfg.vocab_size
        return {"tokens": seq[:, :-1].astype(np.int32), "labels": seq[:, 1:].astype(np.int32)}

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
