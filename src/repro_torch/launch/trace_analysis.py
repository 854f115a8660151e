"""Cost analysis of a traced step: the counterpart of
``repro.launch.hlo_analysis``, which reads the compiled per-device HLO.
PyTorch has no HLO, so the port reads a trace of the local aten ops that one
rank runs for the step, recorded by :class:`TraceMode`.

The mode sits *below* DTensor: an op on DTensors is handed on to DTensor
(the mode returns ``NotImplemented`` for it), which runs the local op on
each rank's shard, and that local op is what the trace records, with the
collectives DTensor runs for a redistribute.  So the totals are per
device, as the reference's SPMD program is.  DTensor also infers each
op's global output shape by running the op on fake tensors of the global
shape; the mode runs those past itself and the modes below it
(``FlopCounterMode``), so neither counts them.  Fake tensors
(``FakeTensorMode`` under the mode) give a full-width trace with no memory;
real tensors, on the CPU or the card, give the same records.

There is no trip-count walk.  The reference multiplies each ``while`` body
by its trip count because a compiled scan holds it once; eager PyTorch runs
every iteration of every loop (the blocks, the microbatches), so the trace
already holds each one.

Accounting model (per device), as ``hlo_analysis.py``'s:

- flops: 2 * prod(out) * prod(contracted dims) for ``mm``, ``addmm``,
  ``bmm`` and ``baddbmm`` (what ``linear``, ``matmul`` and ``einsum``
  decompose into); a convolution 2 * prod(out) * prod(kernel dims but the
  output features), its backward the same for each gradient it computes.
  Recorded by the dtype of the product, so the roofline can take the card's
  two peaks.  Elementwise ops count no flops, as in the reference.
- bytes: every op's operand bytes plus output bytes.  Ops that move nothing
  are free: views (``view``, ``t``, ``expand``, ``permute``, ``slice``,
  ``alias``, ``detach``, ... : every output aliases an input and none is
  written, read from the op's schema), ``empty`` and the collectives'
  waits, the counterpart of the reference's free ``tuple`` / ``gte`` /
  ``parameter`` / ``constant`` / ``bitcast`` and its skipped ``*-done``.
  Eager PyTorch does not fuse, so this counts every elementwise pass: more
  than XLA's fusion-boundary count, and not comparable with it.
- collectives: per kind, the bytes of the op's result (for the in-place
  ``c10d`` ops, of their destination), and twice that in ``bytes``, mapped
  to the reference's five kinds: ``all_reduce`` -> all-reduce,
  ``all_gather_into_tensor`` / ``allgather`` -> all-gather,
  ``reduce_scatter_tensor`` -> reduce-scatter, ``all_to_all_single`` /
  ``alltoall`` -> all-to-all, point-to-point (``send`` / ``recv``) and
  ``broadcast`` -> collective-permute.
- memory: every storage an op creates is recorded with its bytes, and its
  release as it happens, so :func:`analyze_trace` gives the peak of the
  bytes that the step itself allocated and held at once (the arguments,
  which exist before it, are not among them).  This is a count of tensor
  storages, not an allocator's figure: no caching, rounding or
  fragmentation.

A trace is a list of records, one an op (``{"op", "in", "out"}`` with
``[shape, dtype]`` pairs, ``"view"`` for a free view, ``"coll"`` and
``"coll_bytes"`` for a collective, ``"new"`` the ``[id, bytes]`` of each
storage it created) or one a release (``{"free": id}``); it is written and
read as gzipped JSON lines (:func:`write_trace`, :func:`read_trace`).
"""

from __future__ import annotations

import gzip
import json
import weakref
from contextlib import nullcontext

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: Collective op names (namespace and op, no overload) and their kind.
COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_gather_into_tensor": "all-gather",
    "_c10d_functional_autograd.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}

#: Ops that move no bytes beyond the views the schema already frees.
FREE_OPS = frozenset({
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.lift_fresh", "aten._local_scalar_dense",
    "_c10d_functional.wait_tensor",
})

#: Products counted as 2 * prod(out) * contracted: the op and the index of
#: the argument whose last dim is contracted.
MATMUL_OPS = {"aten.mm": 0, "aten.bmm": 0, "aten.addmm": 1, "aten.baddbmm": 1}
CONV_OPS = frozenset({"aten.convolution", "aten._convolution"})
CONV_BACKWARD = "aten.convolution_backward"

DTYPE_BYTES = {
    "bool": 1, "uint8": 1, "int8": 1, "int16": 2, "int32": 4, "int64": 8,
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
    "complex64": 8, "complex128": 16, "float8_e4m3fn": 1, "float8_e5m2": 1,
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _op_name(func) -> str:
    """``"aten.mm"``: the op's namespace and name, without the overload."""
    packet = func.overloadpacket
    return f"{func.namespace}.{packet.__name__}"


def _is_view(func) -> bool:
    """Every output aliases an input and none is written: a view."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _desc(t: torch.Tensor) -> list:
    return [list(t.shape), _dtype_name(t.dtype)]


class TraceMode(TorchDispatchMode):
    """Records every local aten op run under it into ``self.trace``.

    Ops on DTensors go on to DTensor, which runs the local ops (and its
    collectives) on the shards; those are recorded.  The ops DTensor runs to
    infer an output's global shape are run past every mode and not
    recorded.  A storage created by a recorded op gets an id and a weak
    reference whose release appends a ``{"free": id}`` record while the mode
    is open."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        self.trace: list[dict] = []
        self._open = False
        self._ids = 0
        self._seen: dict[int, tuple] = {}  # storage address -> (weak ref, id)
        self._hidden = 0
        self._dtensor, self._fake = DTensor, FakeTensor

    def __enter__(self):
        self._open = True
        self._hide_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        self._open = False
        name, orig = self._restore
        setattr(self._propagator, name, orig)
        return super().__exit__(*exc)

    def _hide_propagation(self):
        """DTensor infers each output's global shape by running the op on
        fake tensors of the global shape (its sharding propagator's tensor
        meta): not the rank's program.  While the mode is open, those ops
        are run past every mode (this one, ``FlopCounterMode``) unrecorded."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = next(n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                    if hasattr(ShardingPropagator, n))
        orig = getattr(ShardingPropagator, name)

        def hidden(prop, *args, **kwargs):
            self._hidden += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                self._hidden -= 1

        self._propagator, self._restore = ShardingPropagator, (name, orig)
        setattr(ShardingPropagator, name, hidden)

    def _on_free(self, key: int, sid: int):
        def cb(_ref):
            if self._seen.get(key, (None, None))[1] == sid:
                del self._seen[key]
            if self._open:
                self.trace.append({"free": sid})
        return cb

    def _new_storages(self, outs, ins) -> list:
        """The storages ``outs`` bring that no earlier op of the trace made
        and no input of this op holds: an in-place op's or a view's output
        on a storage from before the trace (a parameter, a moment) is none
        of the step's own bytes."""
        held = {t.untyped_storage()._cdata for t in ins
                if not (t.device.type == "meta" and not isinstance(t, self._fake))}
        new = []
        for t in outs:
            if t.device.type == "meta" and not isinstance(t, self._fake):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in held:
                continue
            seen = self._seen.get(key)
            if seen is not None and seen[0]() is st:
                continue
            self._ids += 1
            self._seen[key] = (weakref.ref(st, self._on_free(key, self._ids)), self._ids)
            new.append([self._ids, int(st.nbytes())])
        return new

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._hidden:  # under the propagator's fake mode alone
            fake = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
            with _disable_current_modes(), fake or nullcontext():
                return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, self._dtensor) for t in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        name = _op_name(func)
        outs = _tensors(out)
        kind = COLLECTIVE_OPS.get(name)
        if not outs and kind is None:  # metadata queries (prim.device, sym_size)
            return out
        rec = {"op": name, "in": [_desc(t) for t in ins], "out": [_desc(t) for t in outs]}
        if _is_view(func):
            rec["view"] = True
        if kind is not None:
            dest = outs if name.startswith("_c10d") else _tensors(args[0])
            rec["coll"] = kind
            rec["coll_bytes"] = sum(_nbytes(_desc(t)) for t in dest)
        new = self._new_storages(outs, ins)
        if new:
            rec["new"] = new
        self.trace.append(rec)
        return out


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def _nbytes(desc) -> int:
    shape, dtype = desc
    return _prod(shape) * DTYPE_BYTES[dtype]


def _conv_flops(out_shape, w_shape) -> float:
    return 2.0 * _prod(out_shape) * _prod(w_shape[1:])


def op_flops(rec: dict) -> float:
    """The products' flops of one op record (0 for every other op)."""
    name, ins, outs = rec["op"], rec["in"], rec["out"]
    if name in MATMUL_OPS:
        lhs = ins[MATMUL_OPS[name]][0]
        return 2.0 * _prod(outs[0][0]) * lhs[-1]
    if name in CONV_OPS:
        return _conv_flops(outs[0][0], ins[1][0])
    if name == CONV_BACKWARD:
        # (grad_out, input, weight, [bias]) -> (grad_input, grad_weight, grad_bias):
        # each of the first two gradients costs a forward convolution.
        grad_out, weight = ins[0][0], ins[2][0]
        return _conv_flops(grad_out, weight) * sum(
            1 for o, shape in zip(outs[:2], (ins[1][0], weight)) if o[0] == shape)
    return 0.0


def analyze_trace(trace) -> dict:
    """Per-device totals of a trace: ``flops`` (and ``flops_by_dtype``),
    ``bytes``, ``collective_bytes`` and ``collective_counts`` by kind, and
    ``peak_live_bytes``, the most bytes the step's own storages held at
    once."""
    flops, by_dtype, nbytes = 0.0, {}, 0.0
    coll_bytes = {k: 0.0 for k in COLLECTIVE_KINDS}
    coll_counts = {k: 0.0 for k in COLLECTIVE_KINDS}
    live, peak, sizes = 0, 0, {}
    for rec in trace:
        if "free" in rec:
            live -= sizes.pop(rec["free"], 0)
            continue
        for sid, n in rec.get("new", ()):
            live += n - sizes.get(sid, 0)
            sizes[sid] = n
        peak = max(peak, live)
        kind = rec.get("coll")
        if kind is not None:
            coll_bytes[kind] += rec["coll_bytes"]
            coll_counts[kind] += 1
            nbytes += 2 * rec["coll_bytes"]
            continue
        f = op_flops(rec)
        if f:
            flops += f
            dt = rec["in"][MATMUL_OPS.get(rec["op"], 0)][1]
            by_dtype[dt] = by_dtype.get(dt, 0.0) + f
        if rec.get("view") or rec["op"] in FREE_OPS:
            continue
        nbytes += sum(_nbytes(d) for d in rec["in"]) + sum(_nbytes(d) for d in rec["out"])
    return {
        "flops": flops,
        "flops_by_dtype": by_dtype,
        "bytes": nbytes,
        "collective_bytes": coll_bytes,
        "collective_counts": coll_counts,
        "peak_live_bytes": peak,
    }


def op_histogram(trace) -> dict[str, float]:
    """How many times each op ran in the trace: the counterpart of the
    reference's trip-count-weighted histogram (a loop's ops appear once an
    iteration, since the trace holds every iteration)."""
    h: dict[str, float] = {}
    for rec in trace:
        if "op" in rec:
            h[rec["op"]] = h.get(rec["op"], 0.0) + 1.0
    return h


def trace_fn(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), trace)``: ``fn`` run once under :class:`TraceMode`."""
    with TraceMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.trace


def write_trace(path: str, trace) -> None:
    with gzip.open(path, "wt") as f:
        for rec in trace:
            f.write(json.dumps(rec, separators=(",", ":")))
            f.write("\n")


def read_trace(path: str) -> list[dict]:
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f if line.strip()]
