"""Name parity: every public function, class and parameter of the JAX
package has its counterpart in the port, or is a held difference.

The reference is read by ``ast`` (no JAX module is imported): each module
of ``src/repro/`` gives its module-level public functions and classes, each
function's parameters, each class's annotated fields, its public methods
(and ``__init__``) and their parameters.  The port's module of the same
path is imported and must hold each name (defined or imported there), each
parameter in its signature and each field or method on its class.

What the port spells its own way is listed in ``ALLOWED``, each group under
the label of its line in ``ROADMAP.md``'s Queue C ("Names the port spells
its own way"); an entry that no longer names a gap fails the test, as does
a label Queue C does not hold.
"""

import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"

_INIT = ("attn_init", "encdec_init", "uniform_scale_init", "swiglu_init", "gelu_mlp_init",
         "embed_init", "moe_init", "rg_init", "ssm_init", "stack_init")
_INIT_MODULES = {"attn_init": "attention", "encdec_init": "encdec", "moe_init": "moe",
                 "rg_init": "rglru", "ssm_init": "ssm", "stack_init": "transformer"}

#: Queue C label -> the gaps it holds: (module, name, what).
ALLOWED = {
    "TPU tile and interpret options": {
        *(("kernels/flash_attention", "flash_attention", f"param {p}")
          for p in ("block_q", "block_k", "interpret")),
        *(("kernels/ssd_scan", "ssd_scan", f"param {p}") for p in ("block_q", "interpret")),
        *(("kernels/rglru_scan", "rglru_scan", f"param {p}")
          for p in ("block_t", "block_w", "interpret")),
    },
    "alloc's impl=": {("kernels/alloc", f, "param impl")
                      for f in ("hesrpt_alloc_fused", "hesrpt_theta_fused")},
    "axis_name -> group": {
        ("train/compression", f, "param axis_name")
        for f in ("compress_psum_int8", "compress_psum_topk", "plain_psum", "make_grad_reducer")
    },
    "devices -> ranks": {("launch/mesh", "make_job_mesh", "param devices")},
    "restore(shardings=) in place": {("train/checkpoint", "restore", "param shardings"),
                                     ("train/ft", "run_with_recovery", "param shardings")},
    "hlo_analysis.py -> trace_analysis.py": {
        ("launch/hlo_analysis", "*", "module"),
        ("launch/dryrun", "collective_bytes", "missing"),
        ("launch/roofline", "CellRoofline.hlo_flops_global", "field"),
    },
    "ShapeConfig in configs/shapes.py": {("configs/base", "ShapeConfig", "missing"),
                                         ("configs/base", "cell_applicable", "missing")},
    "threefry keys -> torch.Generator": {
        ("core/engine", "poisson_source", "param key"),
        *(("core/scenarios", f, "param key")
          for f in ("poisson_arrivals", "bursty_arrivals", "pareto_sizes")),
        *((f"models/{_INIT_MODULES.get(f, 'layers')}", f, "param rng") for f in _INIT),
        ("models/layers", "split_tree", "missing"),
    },
    "the _jax names": {("core/engine", "quantize_allocation_jax", "missing"),
                       ("core/engine", "snap_to_slices_jax", "missing")},
    "the JAX mesh API": {("models/common", "shard_map", "missing"),
                         ("models/common", "use_mesh", "missing"),
                         ("launch/sharding", "named", "missing"),
                         ("models/moe", "moe_apply_dense", "param parallel")},
    "generate is greedy": {("launch/serve", "generate", "param greedy"),
                           ("launch/serve", "generate", "param rng")},
    "prefill_cache has no caller": {("models/attention", "prefill_cache", "missing")},
    "pattern_of -> ModelConfig.block_pattern": {("models/transformer", "pattern_of", "missing")},
}


def _params(node) -> list[str]:
    a = node.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _signature(obj):
    try:
        return inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return None


def _param_gaps(mod, qual, node, obj) -> list:
    have = _signature(obj)
    if have is None:
        return []
    return [(mod, qual, f"param {p}") for p in _params(node) if p not in have]


def _class_gaps(mod, node, cls) -> list:
    gaps = []
    fields = set(getattr(cls, "_fields", ()))
    if dataclasses.is_dataclass(cls):
        fields |= {f.name for f in dataclasses.fields(cls)}
    for sub in node.body:
        if (isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name)
                and not sub.target.id.startswith("_")):
            name = sub.target.id
            if name not in fields and not hasattr(cls, name):
                gaps.append((mod, f"{node.name}.{name}", "field"))
        if isinstance(sub, ast.FunctionDef) and (not sub.name.startswith("_")
                                                 or sub.name == "__init__"):
            qual = f"{node.name}.{sub.name}"
            if not hasattr(cls, sub.name):
                gaps.append((mod, qual, "missing"))
            else:
                gaps += _param_gaps(mod, qual, sub, getattr(cls, sub.name))
    return gaps


def name_gaps() -> set:
    """Every name of ``src/repro/`` the port lacks, as (module, name, what)."""
    gaps = []
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).with_suffix("")
        mod = "/".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts)
        try:
            port = importlib.import_module(".".join(("repro_torch", *mod.split("/"))))
        except ModuleNotFoundError:
            gaps.append((mod, "*", "module"))
            continue
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or node.name.startswith("_"):
                continue
            if not hasattr(port, node.name):
                gaps.append((mod, node.name, "missing"))
            elif isinstance(node, ast.ClassDef):
                gaps += _class_gaps(mod, node, getattr(port, node.name))
            else:
                gaps += _param_gaps(mod, node.name, node, getattr(port, node.name))
    return set(gaps)


def test_every_reference_name_has_a_counterpart_or_a_queue_c_line():
    allowed = set().union(*ALLOWED.values())
    gaps = name_gaps()
    assert sorted(gaps - allowed) == []
    assert sorted(allowed - gaps) == []  # no entry outlives its gap


def test_every_allowlist_label_is_a_queue_c_line():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    queue_c = roadmap[roadmap.index("### Queue C"):]
    queue_c = queue_c[:queue_c.index("\n## ")]
    for label in ALLOWED:
        assert f"*{label}*" in queue_c, label
