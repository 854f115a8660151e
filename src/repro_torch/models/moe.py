"""Mixture-of-Experts MLP: top-k routing, two single-device dispatches and
two over a mesh.  Port of ``repro.models.moe``.

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
back to their tokens through the inverse permutation.  Its backward
gathers and scatters by unique indices only and sums each token's
``top_k`` rows in a fixed order, so it adds no two values with float
atomics: two backward passes on the card agree bit for bit.  The
group sizes are read to the host once a layer, to slice the rows.  The
products are PyTorch matrix products: the JAX package has no Pallas kernel
here (its ``lax.ragged_dot`` is XLA's), and a grouped GEMM for Hopper is a
speed lever (ROADMAP.md "Speed of the port").

Under a mesh (``parallel``, a ``models.common.ParallelConfig``; the
activations and weights DTensors):

``impl="ragged"``: the reference's ``moe_apply_ragged``.  A ``local_map``
(the counterpart of ``shard_map``) over x sharded on the batch over the data
axes, the router replicated and the experts' ``d_ff`` over the model axis
(``gate`` / ``up`` ``[E, f, d]`` ``Shard(1)``, ``down`` ``[E, d, f]``
``Shard(2)``): each rank routes its own tokens and runs the ragged dispatch
on its ``d_ff`` shard, then one ``all_reduce`` (sum) over the model axis
combines the down-projection's partials; ``aux`` is averaged over the data
and model axes.  The collectives inside are autograd functions whose
backward is the one the placements imply: the partial sum's gradient passes
through as it is, and the gradients of the tensors a rank reads whole (x on
its way into the experts over the model axis, the router and the expert
shards over the data axes) are summed.

``impl="dense_ep"``: the dense dispatch with its ``[B, S, E, d_ff]``
intermediates placed as the reference's ``_expert_sharded`` places them,
experts over the data axes (where ``E`` divides) and ``d_ff`` over the model
axis (where it divides): a ``local_map`` over each rank's experts and
``d_ff`` shard with the whole batch, one ``all_reduce`` of the
down-projection's partials.  ``impl="dense"`` under a mesh is the plain
dense dispatch on each rank's rows of the batch (a ``local_map``, the
weights whole, the load-balance means over the whole batch).

Without a mesh ``ragged`` and ``dense_ep`` raise (the reference quietly
takes ``dense``; ROADMAP.md Queue C).  No impl falls back to another.

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
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.device import is_dtensor
from repro_torch.models.layers import uniform_scale_init

#: The dispatches :func:`moe_apply` takes on one device, and those that need
#: a mesh (without one they raise).
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


def _route(p, x, cfg, mean=None):
    """Router: top-k expert ids ``[B, S, k]``, their weights renormalised to
    sum to one (float32), and the load-balance loss.  ``mean`` takes the
    per-expert means over this rank's tokens to their means over every
    rank's (the batch split over data shards)."""
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
    if mean is not None:
        f_e, p_e = mean(f_e), mean(p_e)
    return w, ids, e * (f_e * p_e).sum()


def moe_apply_dense(p, x, cfg, *, mean=None, rows=None, experts=None, combine=None):
    """Every token through every expert.  x ``[B, S, D]`` -> ``[B, S, D]``.
    On local tensors under a mesh: ``mean`` is :func:`_route`'s; the experts
    run on ``rows`` (``x`` by default; the same values) with the weights
    given (a rank's experts and ``d_ff`` shard), ``experts`` takes the
    combine weights ``[B, S, E]`` to those experts' columns, and
    ``combine`` sums the down-projection's partials."""
    w, ids, aux = _route(p, x, cfg, mean)
    # The combine weights [B, S, E]: w at each token's experts, zero elsewhere
    # (the reference's one-hot contraction, which adds only zeros to w).
    cw = torch.zeros(*ids.shape[:-1], cfg.n_experts, dtype=x.dtype, device=x.device)
    cw = cw.scatter(-1, ids, w.to(x.dtype))
    if experts is not None:
        cw = experts(cw)
    rows = x if rows is None else rows
    g = torch.einsum("bsd,efd->bsef", rows, p["gate"].to(x.dtype))
    u = torch.einsum("bsd,efd->bsef", rows, p["up"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype)
    del g
    h = h * u
    del u
    h = h * cw[..., None]
    out = torch.einsum("bsef,edf->bsd", h, p["down"].to(x.dtype))
    return (out if combine is None else combine(out)), aux


class _GatherRepeated(torch.autograd.Function):
    """``rows[order // k]``: each token's row at its ``k`` assignments, in
    the order ``order`` (a permutation of the ``t k`` assignments).  The
    backward takes the gradient back to assignment order by the inverse
    permutation and sums each token's ``k`` rows in a fixed order, where
    ``index_select``'s own backward would add them with float atomics on
    the card (every token index appears ``k`` times)."""

    @staticmethod
    def forward(ctx, rows, order, k):
        ctx.save_for_backward(order)
        ctx.k = k
        return rows.index_select(0, order // k)

    @staticmethod
    def backward(ctx, grad):
        (order,) = ctx.saved_tensors
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device))
        return grad.index_select(0, inv).view(-1, ctx.k, grad.shape[-1]).sum(1), None, None


def _ragged(router, gate, up, down, x, cfg, *, rows=None, combine=None):
    """The dropless dispatch on local tensors: routes ``x`` ``[b, S, D]``,
    runs each expert's SwiGLU on its rows of ``rows`` (``x`` by default;
    the same values) with the given weights (a ``d_ff`` shard of them
    under a mesh), passes the down-projection's ``[b S k, D]`` through
    ``combine`` (the model axis's sum under a mesh) and weights the rows
    back into their tokens.  Returns ``(out, aux)``."""
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    w, ids, aux = _route({"router": router}, x, cfg)
    rows = x if rows is None else rows
    t = b * s
    flat_ids = ids.reshape(t * k)
    order = torch.argsort(flat_ids, stable=True)
    xs = _GatherRepeated.apply(rows.reshape(t, d), order, k)  # [t k, D], grouped by expert
    sizes = torch.bincount(flat_ids, minlength=e).tolist()  # the layer's one host read
    # One unbind a weight: its backward stacks the experts' gradients in one
    # pass, where an index an expert would make a whole-weight gradient each.
    gates, ups, downs = gate.unbind(0), up.unbind(0), down.unbind(0)
    parts, start = [], 0
    for ex, n in enumerate(sizes):
        if n:
            r = xs[start:start + n]
            g = F.linear(r, gates[ex].to(x.dtype))
            u = F.linear(r, ups[ex].to(x.dtype))
            h = F.silu(g.float()).to(x.dtype) * u
            parts.append(F.linear(h, downs[ex].to(x.dtype)))
        start += n
    part = torch.cat(parts) if parts else xs.new_zeros(0, d)
    if combine is not None:
        part = combine(part)
    y = torch.empty_like(part).index_copy(0, order, part).reshape(t, k, d)
    out = torch.einsum("tkd,tk->td", y, w.reshape(t, k).to(x.dtype))
    return out.reshape(b, s, d), aux


def moe_apply_ragged_local(p, x, cfg):
    """Each token through its own ``top_k`` experts only.  x ``[B, S, D]``
    -> ``[B, S, D]``."""
    return _ragged(p["router"], p["gate"], p["up"], p["down"], x, cfg)


def _groups(mesh, axes) -> list:
    return [mesh.get_group(a) for a in axes]


class _SumForward(torch.autograd.Function):
    """``scale`` times the sum over ``groups`` (one ``all_reduce`` a group)
    forward; the gradient times ``grad_scale`` backward: what passes back
    to a rank is its share of a replicated output's gradient."""

    @staticmethod
    def forward(ctx, t, groups, scale, grad_scale):
        out = t.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        ctx.grad_scale = grad_scale
        return out * scale if scale != 1 else out

    @staticmethod
    def backward(ctx, grad):
        return (grad * ctx.grad_scale if ctx.grad_scale != 1 else grad), None, None, None


class _SumBackward(torch.autograd.Function):
    """The identity forward; backward, the gradient summed over ``groups``:
    a tensor every rank of the groups reads whole, whose gradient each rank
    holds a part of."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        for g in ctx.groups:
            dist.all_reduce(grad, group=g)
        return grad, None


def _as_dtensor(t, mesh):
    """``t``, a plain tensor taken as replicated on every rank, as a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    return t if is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def moe_apply_dense_mesh(p, x, cfg, parallel):
    """The dense dispatch under a mesh, as a ``local_map``: each rank sends
    its rows of the batch (split over the data axes where it divides)
    through every expert with the weights whole, and the load-balance
    loss takes its per-expert means over the whole batch (one mean over the
    data axes each), so out and ``aux`` are the plain dispatch's.  DTensor's
    own sharding search for the dispatch's einsums does not finish in
    minutes on a mesh with a joint ("pod", "data") batch axis."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = parallel.mesh
    n_data = parallel.size(parallel.data_axes)
    split = n_data > 1 and x.shape[0] % n_data == 0
    data_groups = _groups(mesh, parallel.data_axes) if split else []
    rep = parallel.placements()
    x_pl = parallel.placements(Shard(0)) if split else rep

    def mean(t):
        return _SumForward.apply(t, data_groups, 1.0 / n_data, 1.0 / n_data)

    def local(x, router, gate, up, down):
        w = dict(zip(("router", "gate", "up", "down"),
                     (_SumBackward.apply(t, data_groups) for t in (router, gate, up, down))))
        return moe_apply_dense(w, x, cfg, mean=mean if split else None)

    fn = local_map(local, out_placements=(x_pl, rep),
                   in_placements=(x_pl, rep, rep, rep, rep), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*(_as_dtensor(t, mesh) for t in (x, p["router"], p["gate"], p["up"], p["down"])))


def moe_apply_dense_ep(p, x, cfg, parallel):
    """The dense dispatch with its ``[B, S, E, d_ff]`` intermediates
    expert-sharded, as a ``local_map``: experts over the data axes (where
    ``E`` divides) and ``d_ff`` over the model axis (where it divides), the
    reference's ``_expert_sharded`` placement.  Each rank takes the whole
    batch (gathered over the data axes), routes it, runs its experts' ``d_ff``
    shard and its combine weights' columns, and one ``all_reduce`` over the
    sharded axes sums the down-projection's partials; the output is
    replicated (the model's next ``constrain_batch`` takes each rank's rows)
    and ``aux`` is the plain dispatch's.  The gradients of what every rank
    reads whole but uses in part (the expert rows, the combine weights) are
    summed over the sharded axes.  (DTensor's own propagation of the
    dispatch's einsums fails on a view of two dims sharded over two mesh
    dims in torch 2.11.)"""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, dp, mp = parallel.mesh, parallel.data_axes, parallel.model_axis
    by_expert = parallel.size(dp) > 1 and cfg.n_experts % parallel.size(dp) == 0
    by_ff = parallel.size(mp) > 1 and cfg.d_ff % parallel.size(mp) == 0
    sharded = (dp if by_expert else ()) + ((mp,) if by_ff else ())
    groups = _groups(mesh, sharded)
    rep = parallel.placements()
    gu_pl = parallel.placements(Shard(0) if by_expert else None, Shard(1) if by_ff else None)
    d_pl = parallel.placements(Shard(0) if by_expert else None, Shard(2) if by_ff else None)

    def local(x, router, gate, up, down):
        e_loc = gate.shape[0]
        e0 = 0
        if by_expert:  # this rank's experts: its data coordinate, pod major
            for a in dp:
                e0 = e0 * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
            e0 *= e_loc
        return moe_apply_dense(
            {"router": router, "gate": gate, "up": up, "down": down}, x, cfg,
            rows=_SumBackward.apply(x, groups),
            experts=lambda cw: _SumBackward.apply(cw, groups)[..., e0:e0 + e_loc],
            combine=lambda part: _SumForward.apply(part, groups, 1, 1))

    fn = local_map(local, out_placements=(rep, rep),
                   in_placements=(rep, rep, gu_pl, gu_pl, d_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*(_as_dtensor(t, mesh) for t in (x, p["router"], p["gate"], p["up"], p["down"])))


def moe_apply_ragged(p, x, cfg, parallel):
    """``local_map`` over the mesh: tokens stay on their data shard; the
    experts are ``d_ff``-tensor-parallel over the model axis.  Plain-tensor
    inputs are taken as replicated; the outputs are DTensors."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, dp, mp = parallel.mesh, parallel.data_axes, parallel.model_axis
    n_data = parallel.size(dp)
    rep = parallel.placements()
    x_pl = parallel.placements(Shard(0))
    gu_pl = parallel.placements(model=Shard(1))
    d_pl = parallel.placements(model=Shard(2))
    data_groups, model_groups = _groups(mesh, dp), _groups(mesh, (mp,))
    n_all = parallel.size(dp + (mp,))

    def local(x, router, gate, up, down):
        rows = _SumBackward.apply(x, model_groups)
        router, gate, up, down = (_SumBackward.apply(w, data_groups)
                                  for w in (router, gate, up, down))
        out, aux = _ragged(router, gate, up, down, x, cfg, rows=rows,
                           combine=lambda part: _SumForward.apply(part, model_groups, 1, 1))
        # aux alike over the model axis: its mean over every rank, whose
        # gradient each data shard's ranks share
        aux = _SumForward.apply(aux, data_groups + model_groups, 1.0 / n_all, 1.0 / n_data)
        return out, aux

    fn = local_map(local, out_placements=(x_pl, rep),
                   in_placements=(x_pl, rep, gu_pl, gu_pl, d_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*(_as_dtensor(t, mesh) for t in (x, p["router"], p["gate"], p["up"], p["down"])))


def moe_apply(p, x, cfg, *, impl: str = "dense", parallel=None):
    """``(out [B, S, D], aux)`` by the dispatch ``impl``; ``ragged`` and
    ``dense_ep`` need ``parallel``."""
    if impl == "dense":
        if parallel is not None and is_dtensor(x):
            return moe_apply_dense_mesh(p, x, cfg, parallel)
        return moe_apply_dense(p, x, cfg)
    if impl == "ragged_local":
        return moe_apply_ragged_local(p, x, cfg)
    if impl in MESH_IMPLS:
        if parallel is None:
            raise NotImplementedError(
                f"moe impl {impl!r} needs a device mesh (ModelOptions.parallel); on one "
                "device take 'dense' or 'ragged_local'")
        if impl == "ragged":
            return moe_apply_ragged(p, x, cfg, parallel)
        return moe_apply_dense_ep(p, x, cfg, parallel)
    raise ValueError(f"moe impl must be one of {IMPLS + MESH_IMPLS}, got {impl!r}")
