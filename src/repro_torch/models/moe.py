"""Mixture-of-Experts MLP: top-k routing and two single-device dispatches.
Port of ``repro.models.moe``.

``impl="dense"`` (the default, as the reference's): every token through every
expert, then the weighted combine.  It computes ``n_experts / top_k`` times
the routed work, and its ``[B, S, E, d_ff]`` intermediates are the layer's
memory peak.  The combine weights are folded into the hidden activations
before the down-projection, which contracts experts and ``d_ff`` together,
so no ``[B, S, E, d_model]`` tensor is ever made.

``impl="ragged_local"``: the reference's dropless dispatch without a mesh.
The ``B * S * top_k`` (token, expert) assignments are sorted by expert
(a stable sort, so within an expert tokens keep their order), each expert
runs its SwiGLU on its own rows (one product a projection), and the rows go
back to their tokens through the inverse permutation.  The group sizes are
read to the host once a layer, to slice the rows.  The products are PyTorch
matrix products: the JAX package has no Pallas kernel here (its
``lax.ragged_dot`` is XLA's), and a grouped GEMM for Hopper is a speed lever
(ROADMAP.md "Speed of the port").

``impl="ragged"`` (``shard_map`` over a mesh) and ``"dense_ep"`` (expert
sharding constraints) need a mesh: they raise, naming ROADMAP.md Queue A
item 10.  No impl falls back to another.

Both return ``(out, aux)``, ``aux`` the switch load-balance loss
``E * sum_e f_e * p_e``: ``f_e`` the share of the routed assignments that go
to expert ``e`` (from the ids, so it carries no gradient) and ``p_e`` the
mean router probability of ``e``.

Weights are ``[out, in]`` as everywhere in the port: ``router`` ``[E, d]``,
``gate`` / ``up`` ``[E, d_ff, d]``, ``down`` ``[E, d, d_ff]``.

Routing takes the top ``k`` router probabilities by a stable descending
sort, so exact ties go to the lower expert index, as ``lax.top_k`` breaks
them (``torch.topk`` does not promise an order among ties).
:func:`recording_routes` collects each layer's ids and its smallest top-k
margin, for the checks that hold two runs' routing against each other.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from repro_torch.models.layers import uniform_scale_init

#: The dispatches :func:`moe_apply` takes on one device, and those that need
#: a mesh (they raise).
IMPLS = ("dense", "ragged_local")
MESH_IMPLS = ("ragged", "dense_ep")

_ROUTES: list | None = None


@contextmanager
def recording_routes():
    """Within the block, every routing appends ``(ids [B, S, k], margin
    [B, S])`` to the yielded list, detached: the chosen experts and, per
    token, its k-th router probability less its (k+1)-th (``inf`` when
    ``k == E``), in float32."""
    global _ROUTES
    outer, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = outer


def moe_init(generator: torch.Generator, cfg, dtype=torch.float32):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": uniform_scale_init(generator, (e, d), dtype),
        "gate": uniform_scale_init(generator, (e, f, d), dtype),
        "up": uniform_scale_init(generator, (e, f, d), dtype),
        "down": uniform_scale_init(generator, (e, d, f), dtype),
    }


def _route(p, x, cfg):
    """Router: top-k expert ids ``[B, S, k]``, their weights renormalised to
    sum to one (float32), and the load-balance loss."""
    k, e = cfg.top_k, cfg.n_experts
    logits = F.linear(x, p["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = ranked[..., :k], order[..., :k]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    if _ROUTES is not None:
        margin = (ranked[..., k - 1] - ranked[..., k] if k < e
                  else torch.full_like(ranked[..., 0], float("inf")))
        _ROUTES.append((ids.detach(), margin.detach()))
    f_e = F.one_hot(ids, e).float().sum(-2).mean((0, 1)) / k
    p_e = probs.mean((0, 1))
    return w, ids, e * (f_e * p_e).sum()


def moe_apply_dense(p, x, cfg):
    """Every token through every expert.  x ``[B, S, D]`` -> ``[B, S, D]``."""
    w, ids, aux = _route(p, x, cfg)
    # The combine weights [B, S, E]: w at each token's experts, zero elsewhere
    # (the reference's one-hot contraction, which adds only zeros to w).
    cw = torch.zeros(*ids.shape[:-1], cfg.n_experts, dtype=x.dtype, device=x.device)
    cw = cw.scatter(-1, ids, w.to(x.dtype))
    g = torch.einsum("bsd,efd->bsef", x, p["gate"].to(x.dtype))
    u = torch.einsum("bsd,efd->bsef", x, p["up"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype)
    del g
    h = h * u
    del u
    h = h * cw[..., None]
    return torch.einsum("bsef,edf->bsd", h, p["down"].to(x.dtype)), aux


def moe_apply_ragged_local(p, x, cfg):
    """Each token through its own ``top_k`` experts only.  x ``[B, S, D]``
    -> ``[B, S, D]``."""
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    w, ids, aux = _route(p, x, cfg)
    t = b * s
    flat_ids = ids.reshape(t * k)
    order = torch.argsort(flat_ids, stable=True)
    xs = x.reshape(t, d).index_select(0, order // k)  # [t k, D], grouped by expert
    sizes = torch.bincount(flat_ids, minlength=e).tolist()  # the layer's one host read
    parts, start = [], 0
    for ex, n in enumerate(sizes):
        if n:
            rows = xs[start:start + n]
            g = F.linear(rows, p["gate"][ex].to(x.dtype))
            u = F.linear(rows, p["up"][ex].to(x.dtype))
            h = F.silu(g.float()).to(x.dtype) * u
            parts.append(F.linear(h, p["down"][ex].to(x.dtype)))
        start += n
    part = torch.cat(parts) if parts else xs.new_zeros(0, d)
    y = torch.empty_like(part).index_copy(0, order, part).reshape(t, k, d)
    out = torch.einsum("tkd,tk->td", y, w.reshape(t, k).to(x.dtype))
    return out.reshape(b, s, d), aux


def moe_apply(p, x, cfg, *, impl: str = "dense"):
    """``(out [B, S, D], aux)`` by the dispatch ``impl``."""
    if impl == "dense":
        return moe_apply_dense(p, x, cfg)
    if impl == "ragged_local":
        return moe_apply_ragged_local(p, x, cfg)
    if impl in MESH_IMPLS:
        raise NotImplementedError(
            f"moe impl {impl!r} needs a device mesh, which the port does not have yet "
            "(ROADMAP.md Queue A item 10); on one device take 'dense' or 'ragged_local'")
    raise ValueError(f"moe impl must be one of {IMPLS + MESH_IMPLS}, got {impl!r}")
