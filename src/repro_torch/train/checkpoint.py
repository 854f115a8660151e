"""Checkpoints of trees of tensors as NumPy files.  Port of
``repro.train.checkpoint``, in its layout.

``save`` writes one ``arrays.npz`` keyed by the leaves' flattened paths
(``"stack/blocks/0/sub0/mix/wq"``) and a ``manifest.json`` (``step``, the
sorted keys, ``extra``); each is written to a temporary file in the
directory and ``os.replace``d into place, so a crash mid-save never leaves a
torn checkpoint.  The ``.npz`` is what ``np.savez`` writes (an uncompressed
zip of ``.npy`` members), but written a leaf at a time, so the host holds
one leaf, not the whole state (a full-width phi4-mini state is tens of GB).
NumPy has no bf16, so bf16 leaves are stored as float32 (exact).
``restore`` reads a leaf at a time into a target tree's tensors, in place,
each cast to the dtype of its target leaf on that leaf's device: a state
restored over the one it replaces never takes its memory twice (where the
JAX package's ``restore`` builds new arrays).

Across meshes (the mechanism heSRPT's elasticity rides on): ``save`` of a
tree of DTensors gathers each leaf whole on every rank (``full_tensor()``,
a collective, so every rank calls ``save``), rank 0 writes, and a barrier
holds every rank until the files are in place.  ``restore`` into DTensor
targets of any mesh shape reads each array whole on every rank, places it
by the target's own mesh and placements and copies the rank's shard into
the target's local tensor, in place: a state saved from a ``(4, 2)`` mesh
restores onto ``(2, 1)``.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile

import numpy as np
import torch

from repro_torch.device import is_dtensor
from repro_torch.train.tree import leaves_with_paths, tree_map


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def save(path: str, tree, *, step: int = 0, extra: dict | None = None) -> None:
    flat = leaves_with_paths(tree)
    if any(is_dtensor(leaf) for _, leaf in flat):
        return _save_sharded(path, flat, step=step, extra=extra)
    _write(path, ((key, _to_numpy(leaf)) for key, leaf in flat),
           sorted(key for key, _ in flat), step=step, extra=extra)


def _save_sharded(path: str, flat, *, step: int, extra: dict | None) -> None:
    """Every rank gathers each leaf whole; rank 0 writes; then a barrier."""
    import torch.distributed as dist

    writer = dist.get_rank() == 0

    def arrays():
        for key, leaf in flat:
            whole = leaf.full_tensor() if is_dtensor(leaf) else leaf
            yield key, _to_numpy(whole) if writer else None

    if writer:
        _write(path, arrays(), sorted(key for key, _ in flat), step=step, extra=extra)
    else:
        for _ in arrays():
            pass
    dist.barrier()


def _write(path: str, arrays, keys: list, *, step: int, extra: dict | None) -> None:
    """``arrays`` (``(key, ndarray)`` pairs, consumed one at a time) into
    ``arrays.npz``, then the manifest, each atomically."""
    os.makedirs(path, exist_ok=True)
    manifest = {"step": step, "keys": keys, "extra": extra or {}}
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    with os.fdopen(fd, "wb") as f, zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                                                   allowZip64=True) as zf:
        for key, arr in arrays:
            with zf.open(key + ".npy", "w", force_zip64=True) as member:
                np.lib.format.write_array(member, arr, allow_pickle=False)
    os.replace(tmp, os.path.join(path, "arrays.npz"))
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "manifest.json"))


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def restore(path: str, target_tree):
    """Each array of the checkpoint copied into ``target_tree``'s tensor of
    the same key (its shape checked); returns ``target_tree``.  A DTensor
    target takes its own shard of the array, by its mesh and placements."""
    with np.load(os.path.join(path, "arrays.npz")) as data:
        keys = set(data.files)
        it = iter(key for key, _ in leaves_with_paths(target_tree))

        def load(leaf):
            key = next(it)
            if key not in keys:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs target "
                                 f"{tuple(leaf.shape)}")
            if is_dtensor(leaf):
                from torch.distributed.tensor import distribute_tensor

                whole = torch.from_numpy(arr).to(leaf.device)
                shard = distribute_tensor(whole, leaf.device_mesh, leaf.placements,
                                          src_data_rank=None)
                leaf.to_local().copy_(shard.to_local())
                return leaf
            return leaf.copy_(torch.from_numpy(arr))

        return tree_map(load, target_tree)


def exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json")) and os.path.exists(
        os.path.join(path, "arrays.npz")
    )
