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
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile

import numpy as np
import torch

from repro_torch.train.tree import leaves_with_paths, tree_map


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def save(path: str, tree, *, step: int = 0, extra: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = leaves_with_paths(tree)
    manifest = {"step": step, "keys": sorted(key for key, _ in flat), "extra": extra or {}}
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    with os.fdopen(fd, "wb") as f, zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                                                   allowZip64=True) as zf:
        for key, leaf in flat:
            with zf.open(key + ".npy", "w", force_zip64=True) as member:
                np.lib.format.write_array(member, _to_numpy(leaf), allow_pickle=False)
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
    the same key (its shape checked); returns ``target_tree``."""
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
            return leaf.copy_(torch.from_numpy(arr))

        return tree_map(load, target_tree)


def exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json")) and os.path.exists(
        os.path.join(path, "arrays.npz")
    )
