"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.
Port of ``repro.launch.sharding``: the rules and :func:`spec_for` are the
reference's, and the placements are DTensor ``Shard`` / ``Replicate``.

Every parameter / batch / cache leaf gets a tuple of LOGICAL axis names
matched by path-regex rules; each logical axis maps to an ordered list of
candidate mesh axes.  Assignment walks the dims in order, taking the first
candidate whose size divides the dim and which is not already used by an
earlier dim of the same leaf (a mesh axis may appear at most once per spec);
dims with no viable candidate stay unsharded.

A spec is a tuple with one entry a dim (trailing unsharded dims dropped, as
the reference's ``PartitionSpec``): ``None``, a mesh axis name, or a tuple
of names for one dim sharded over several axes (``("pod", "data")``).
:func:`to_placements` turns it into one placement per mesh dimension.

The layout map.  The reference's rules are written for its own tree: blocks
stacked on a leading ``"layers"`` dim and linear weights ``[in, out]``.  The
port keeps a list of blocks and its linears ``[out, in]``
(``models/convert.py``).  So each port leaf's spec is computed as the
reference computes it for the counterpart JAX leaf (the stacked dim put back
where the JAX leaf has one, the last two dims of a transposed linear swapped
back, the path without the block index), then mapped through the layout:
the stacked dim dropped and the last two dims swapped again.  A hybrid's
tail layers are not stacked in either tree, so there the reference's rules
shift by one dim (recurrentgemma-9b's ``stack/tail/sub0/mlp/gate`` gets
``d_ff`` over data and ``embed`` unsharded); the port keeps that
(ROADMAP.md Queue C).
"""

from __future__ import annotations

import re
from collections.abc import Sequence

from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.train.tree import leaves_with_paths, tree_map

# logical axis -> ordered mesh-axis candidates
LOGICAL_CANDIDATES = {
    "layers": (),
    "batch": (("pod", "data"),),  # joint axes tuple = shard over both
    "batch_data": (("data",),),
    "embed": ("data",),
    "ff": ("model",),
    "heads": ("model",),
    "vocab": ("model",),
    "experts": ("data", "model"),
    "seq": (),
    "cache_seq": (),
    "kv_heads": ("model",),
    "head_dim": ("model",),
    "conv": (),
    "state": ("model",),
    "lru": ("model",),
    "none": (),
}

# (path regex, logical axes per dim).  First match wins; leaves are matched
# on their '/'-joined tree path.  Missing rule -> fully replicated.
PARAM_RULES: tuple[tuple[str, tuple[str, ...]], ...] = (
    # embeddings / output head
    (r"(^|/)embed$", ("vocab", "embed")),
    (r"(^|/)lm_head$", ("vocab", "embed")),
    # attention (stacked under blocks: leading "layers" dim)
    (r"mix/w[qkv]$", ("layers", "embed", "heads")),
    (r"mix/wo$", ("layers", "heads", "embed")),
    (r"mix/b[qkv]$", ("layers", "heads")),
    (r"(self|cross)_attn/w[qkv]$", ("layers", "embed", "heads")),
    (r"(self|cross)_attn/wo$", ("layers", "heads", "embed")),
    (r"(self|cross)_attn/b[qkv]$", ("layers", "heads")),
    # dense mlp
    (r"mlp/(gate|up|w1)$", ("layers", "embed", "ff")),
    (r"mlp/(down|w2)$", ("layers", "ff", "embed")),
    (r"mlp/b1$", ("layers", "ff")),
    (r"mlp/b2$", ("layers", "embed")),
    # moe
    (r"mlp/router$", ("layers", "embed", "none")),
    (r"mlp/(gate|up)$", ("layers", "experts", "embed", "ff")),  # (unreachable, doc)
    (r"mlp/down$", ("layers", "experts", "ff", "embed")),
    # mamba2
    (r"mix/in_proj$", ("layers", "embed", "ff")),
    (r"mix/out_proj$", ("layers", "ff", "embed")),
    (r"mix/conv_w$", ("layers", "conv", "ff")),
    (r"mix/conv_b$", ("layers", "ff")),
    (r"mix/(a_log|d_skip|dt_bias)$", ("layers", "none")),
    (r"mix/gnorm$", ("layers", "ff")),
    # rg-lru
    (r"mix/(w_rec|w_gelu)$", ("layers", "embed", "lru")),
    (r"mix/w_out$", ("layers", "lru", "embed")),
    (r"mix/(wgx|bgx|wga|bga|a_param)$", ("layers", "lru")),
    # norms (stacked or not) stay replicated on the feature dim
    (r"norm", ("layers", "none")),
)

# MoE gate/up need 4 dims (in the reference's stacked layout); the generic
# mlp rule above matches dense first.
MOE_RULES: tuple[tuple[str, tuple[str, ...]], ...] = (
    (r"mlp/(gate|up)$", ("layers", "experts", "embed", "ff")),
    (r"mlp/down$", ("layers", "experts", "ff", "embed")),
)

BATCH_RULES: tuple[tuple[str, tuple[str, ...]], ...] = (
    (r"^(tokens|labels)$", ("batch", "seq")),
    (r"^patch_embeds$", ("batch", "seq", "embed")),
    (r"^frames$", ("batch", "seq", "embed")),
    (r"^cache_length$", ()),
)

CACHE_RULES: tuple[tuple[str, tuple[str, ...]], ...] = (
    (r"/(k|v)$", ("layers", "batch", "kv_heads", "cache_seq", "head_dim")),
    (r"/conv$", ("layers", "batch", "conv", "ff")),
    (r"/ssm$", ("layers", "batch", "none", "head_dim", "state")),
    (r"/h$", ("layers", "batch", "lru")),
)

#: The leaves ``models/convert.py`` transposes: the port's ``[out, in]``
#: linears (a MoE layer's behind its expert axis).
LINEAR_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "in_proj", "out_proj", "w_rec", "w_gelu", "w_out",
    "gate", "up", "down", "router", "w1", "w2",
})

#: A block index under one of these lists: the reference stacks the list.
_STACKED = re.compile(r"(^|/)(blocks|enc_blocks|dec_blocks)/(\d+)(/|$)")


def _mesh_axes_of(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def spec_for(shape: Sequence[int], logical: Sequence[str], mesh) -> tuple:
    """Greedy assignment of mesh axes to dims with divisibility + reuse
    checks.  ``mesh`` is a ``DeviceMesh`` or any object whose ``shape`` maps
    axis names to sizes."""
    sizes = axis_sizes(mesh)
    ndim = len(shape)
    logical = tuple(logical)[:ndim] + ("none",) * max(0, ndim - len(logical))
    used: set = set()
    out = []
    for dim, name in zip(shape, logical, strict=True):
        placed = None
        for cand in LOGICAL_CANDIDATES.get(name, ()):
            axes = _mesh_axes_of(cand)
            if any(a not in sizes for a in axes):
                # candidate references an axis this mesh lacks (e.g. "pod" on
                # the single-pod mesh): use the surviving sub-axes.
                axes = tuple(a for a in axes if a in sizes)
                if not axes:
                    continue
            if used & set(axes):
                continue
            size = 1
            for a in axes:
                size *= sizes[a]
            if size > 1 and dim % size == 0:
                placed = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
        out.append(placed)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _match(path: str, rules) -> tuple[str, ...] | None:
    for pat, logical in rules:
        if re.search(pat, path):
            return logical
    return None


def _reference_leaf(path: str, shape: tuple, counts: dict, linear: bool):
    """``(path, shape, stacked, transposed)`` of the reference's counterpart
    of a port leaf: the block index dropped from the path and the list's
    length put in front of the shape where the reference stacks the list,
    the last two dims swapped back for a transposed linear."""
    stacked = _STACKED.search(path)
    transposed = linear and len(shape) >= 2 and path.rsplit("/", 1)[-1] in LINEAR_NAMES
    if transposed:
        shape = shape[:-2] + (shape[-1], shape[-2])
    if stacked:
        lst = path[:stacked.end(2)]
        path = path[:stacked.start(3)] + path[stacked.end(3) + 1:]
        shape = (counts[lst],) + shape
    return path, shape, bool(stacked), transposed


def _to_port(spec: tuple, ndim: int, stacked: bool, transposed: bool) -> tuple:
    """The reference's spec of a leaf of ``ndim`` dims, mapped to the port's
    layout."""
    full = list(spec) + [None] * (ndim - len(spec))
    if stacked:
        full = full[1:]
    if transposed:
        full[-2], full[-1] = full[-1], full[-2]
    while full and full[-1] is None:
        full.pop()
    return tuple(full)


def _list_lengths(tree, prefix: str = "") -> dict:
    """``{path of a list: its length}`` for every list in ``tree``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_list_lengths(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        out[prefix] = len(tree)
        for i, v in enumerate(tree):
            out.update(_list_lengths(v, f"{prefix}/{i}"))
    return out


def _tree_specs(tree, mesh, rules, *, moe: bool = False, linear: bool = False):
    """A spec for every leaf of ``tree`` (anything with ``shape``), as the
    reference computes it for its counterpart leaf, in the port's layout."""
    counts = _list_lengths(tree)
    specs = []
    for path, leaf in leaves_with_paths(tree):
        ndim = len(getattr(leaf, "shape", ()))
        ref_path, ref_shape, stacked, transposed = _reference_leaf(
            path, tuple(getattr(leaf, "shape", ())), counts, linear)
        logical = None
        if moe and len(ref_shape) == 4:
            logical = _match(ref_path, MOE_RULES)
        if logical is None:
            logical = _match(ref_path, rules)
        if logical is None or ndim == 0:
            specs.append(())
        else:
            spec = spec_for(ref_shape, logical, mesh)
            specs.append(_to_port(spec, len(ref_shape), stacked, transposed))
    it = iter(specs)
    return tree_map(lambda _: next(it), tree)


def param_specs(params, mesh, cfg=None):
    """Spec tree for a parameter tree (tensors, meta or fake tensors)."""
    moe = bool(cfg is not None and cfg.n_experts)
    return _tree_specs(params, mesh, PARAM_RULES, moe=moe, linear=True)


def opt_state_specs(params, mesh, cfg=None, *, keep_master: bool = False):
    """Spec tree of ``train/optimizer.py``'s state: the moments (and the
    float32 master copy) as the parameters, ``step`` replicated."""
    ps = param_specs(params, mesh, cfg)
    out = {"m": ps, "v": ps, "step": ()}
    if keep_master:
        out["master"] = ps
    return out


def batch_specs(batch, mesh):
    return _tree_specs(batch, mesh, BATCH_RULES)


def cache_specs_tree(caches, mesh):
    return _tree_specs(caches, mesh, CACHE_RULES)


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dimension:
    ``Shard(d)`` where tensor dim ``d`` names that axis, ``Replicate()``
    elsewhere.  A dim over several axes is sharded on each of them in the
    mesh's order (pod major), which must be the spec's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    where = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _mesh_axes_of(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for a in axes:
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in names)


def distribute(tree, specs, mesh):
    """Each leaf of ``tree`` as a DTensor on ``mesh`` placed by its spec:
    the counterpart of the reference's ``named`` plus ``device_put``.  Every
    rank passes the whole tensor (the same values: rank 0's are sent).  A
    DTensor's local shard may keep its input's storage (a replicated one
    does), so the tree is handed over: a donated train step's in-place
    AdamW writes through to it."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, s: distribute_tensor(t, mesh, to_placements(s, mesh)),
                    tree, specs)
