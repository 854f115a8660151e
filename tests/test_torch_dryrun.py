"""The dry-run contract and its tooling (``Model.input_specs`` /
``cache_specs``, ``launch/trace_analysis.py``, ``launch/dryrun.py``,
``launch/roofline.py``, ``reanalyze.py``, ``report.py``) against the
reference, on the CPU.

- The specs of all ten configs at the four grid shapes equal JAX's leaf for
  leaf, the port's caches mapped through the layout (``launch/sharding.py``:
  a list of blocks for the reference's stacked dim); the cache specs equal
  a real prefill cache of each family's smoke config.
- The analyzer's flops equal ``FlopCounterMode``'s on the smoke prefills and
  train steps, and JAX's ``analyze_hlo`` on the smoke prefills: exactly for
  the dense, vlm and audio families, and for the others less what JAX
  counts as a product and the port computes without one (ROADMAP.md Queue
  C): the depthwise conv (mamba2's and each RG-LRU layer's, K shifted
  multiply-adds in the port, a convolution in JAX: 2 B S C K a layer) and
  the MoE combine weights (a scatter in the port, a one-hot einsum in JAX:
  2 B S k E a layer).
- Bytes, peak and collectives on hand-counted programs (a matmul, an add, a
  view; a ``(2, 2)`` fake-mesh all-gather and all-reduce).
- The sort counts of the port's heSRPT policy and allocate beside the
  reference's (``tests/test_alloc_fused.py``).
- ``roofline.model_flops`` equal to JAX's for all 40 cells, and
  ``analyze_record``'s terms equal to JAX's times the ratio of the H100 and
  TPU v5e constants.
- The miniature dry run (JAX's ``test_miniature_dryrun``: smoke mixtral's
  train step on a fake ``(2, 2, 2)`` pod/data/model mesh), the smoke
  whisper's train step on the fake meshes that reproduce whisper-base's
  train_4k cell, a refused cell, and the options a fake trace cannot run.

Every fake world runs in a subprocess: the default process group is
process-global, and the test workers share processes.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.launch.hlo_analysis import op_histogram as jax_op_histogram  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, reanalyze, report, roofline  # noqa: E402
from repro_torch.launch import trace_analysis as ta  # noqa: E402
from repro_torch.launch.sharding import _list_lengths, _reference_leaf  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.rglru import RG_CONV  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402
from repro_torch.train.optimizer import init_opt_state  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
ARCHS = tconfigs.ARCH_IDS
FAMILY_ARCHS = ("phi4-mini-3.8b", "mamba2-130m", "recurrentgemma-9b", "mixtral-8x7b",
                "internvl2-1b", "whisper-base")
CELLS = [(a, s.name) for a in ARCHS for s in SHAPES]


def _jax_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in flat}


def _port_leaves(tree) -> dict:
    """``{reference path: (reference shape, dtype)}``: each port leaf (a
    meta tensor) mapped through the layout, the blocks' list its stacked
    dim; every block of a list must hold the same leaves."""
    counts = _list_lengths(tree)
    out = {}
    for path, leaf in leaves_with_paths(tree):
        assert leaf.device.type == "meta", path
        ref_path, ref_shape, _, _ = _reference_leaf(path, tuple(leaf.shape), counts, False)
        desc = (ref_shape, str(leaf.dtype).removeprefix("torch."))
        assert out.setdefault(ref_path, desc) == desc, path
    return out


def _models(arch):
    jm = jax_build_model(jconfigs.get_config(arch))
    tm = build_model(tconfigs.get_config(arch), device="cpu")
    return jm, tm


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax(arch, shape):
    jm, tm = _models(arch)
    assert _port_leaves(tm.input_specs(tconfigs.SHAPE_BY_NAME[shape])) == _jax_leaves(
        jm.input_specs(jconfigs.SHAPE_BY_NAME[shape]))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cache_specs_match_jax_through_the_layout(arch, shape):
    jm, tm = _models(arch)
    assert _port_leaves(tm.cache_specs(tconfigs.SHAPE_BY_NAME[shape])) == _jax_leaves(
        jm.cache_specs(jconfigs.SHAPE_BY_NAME[shape]))


def _smoke_model(arch, dtype="float32", remat="none"):
    cfg = tconfigs.smoke_config(arch)
    model = build_model(cfg, ModelOptions(attn_impl="ref", mixer_impl="ref",
                                          activation_dtype=dtype, remat=remat), device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _batch(cfg, model, shape, seed=0):
    """Real tensors shaped by ``input_specs``: tokens and labels drawn with
    numpy, float inputs standard normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, m in model.input_specs(shape).items():
        if m.dtype == torch.int32:
            out[k] = torch.tensor(rng.integers(0, cfg.vocab_size, m.shape), dtype=torch.int32)
        else:
            out[k] = torch.tensor(rng.standard_normal(m.shape), dtype=m.dtype)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_specs_equal_a_real_prefill_cache(arch, dtype):
    cfg, model, params = _smoke_model(arch, dtype)
    shape = ShapeConfig("small", 24, 2, "prefill")
    _, cache = model.prefill_fn(params, _batch(cfg, model, shape))
    want = [(p, tuple(t.shape), t.dtype) for p, t in leaves_with_paths(model.cache_specs(shape))]
    assert [(p, tuple(t.shape), t.dtype) for p, t in leaves_with_paths(cache)] == want


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_analyzer_flops_equal_flop_counter(arch, kind):
    """The prefill in float32, the train step (two microbatches) in bf16 with
    remat, as the dry run traces it; flops by dtype add up to the total."""
    if kind == "prefill":
        cfg, model, params = _smoke_model(arch)
        shape = ShapeConfig("small", 32, 2, "prefill")
        fn, args = model.prefill_fn, (params, _batch(cfg, model, shape))
    else:
        cfg, model, params = _smoke_model(arch, "bfloat16", "full")
        shape = ShapeConfig("small", 32, 4, "train")
        fn = make_train_step(model, TrainConfig(microbatches=2))
        args = (params, init_opt_state(params), _batch(cfg, model, shape))
    with FlopCounterMode(display=False) as counter:
        _, trace = ta.trace_fn(fn, *args)
    got = ta.analyze_trace(trace)
    assert got["flops"] > 0
    assert got["flops"] == counter.get_total_flops()
    assert sum(got["flops_by_dtype"].values()) == got["flops"]
    if kind == "train":
        assert set(got["flops_by_dtype"]) >= {"bfloat16"}


def test_bytes_and_peak_of_a_hand_counted_program(tmp_path):
    """[8, 16] @ [16, 4] f32: 512 + 256 read, 128 written; + 1: 128 + 128;
    a view: free; a sum: 128 + 4.  The product is released before the sum,
    so the peak is the product and the add's output (kept by the view)."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)

    def program():
        c = a @ b
        d = (c + 1).view(4, 8)
        del c
        return d.sum()

    _, trace = ta.trace_fn(program)
    got = ta.analyze_trace(trace)
    assert got["flops"] == 2 * 8 * 4 * 16
    assert got["flops_by_dtype"] == {"float32": 2 * 8 * 4 * 16}
    assert got["bytes"] == (512 + 256 + 128) + (128 + 128) + (128 + 4)
    assert got["peak_live_bytes"] == 128 + 128
    assert [r["op"] for r in trace if "op" in r] == ["aten.mm", "aten.add", "aten.view",
                                                     "aten.sum"]
    assert next(r for r in trace if r.get("op") == "aten.view")["view"] is True
    assert {"free": 1} in trace  # the product, released inside the program
    assert sum(got["collective_bytes"].values()) == 0
    path = str(tmp_path / "t.trace.jsonl.gz")
    ta.write_trace(path, trace)
    assert ta.read_trace(path) == trace


def test_peak_leaves_out_what_lands_on_an_arguments_storage():
    """An in-place op on an argument (a donated step's AdamW on its moments)
    and a view of one (the train step's detached aliases) bring no bytes of
    the step's own: the peak is the one new [64, 32] float32 storage."""
    a = torch.ones(64, 32)

    def program():
        a.mul_(2)
        b = a.detach()
        return (b + 1).sum()

    _, trace = ta.trace_fn(program)
    got = ta.analyze_trace(trace)
    assert [r["op"] for r in trace if "op" in r] == ["aten.mul_", "aten.detach", "aten.add",
                                                     "aten.sum"]
    assert got["peak_live_bytes"] == 64 * 32 * 4 + 4


def _run_fake_world(body: str, timeout: int = 240) -> dict:
    """``body`` in a fresh interpreter on one thread; it prints one JSON
    line last, which is returned."""
    code = textwrap.dedent("""
        import json, sys
        import torch
        torch.set_num_threads(1)
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.launch import dryrun, mesh as mesh_lib, trace_analysis as ta
    """) + textwrap.dedent(body)
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_fake_mesh_redistribute_collectives():
    """A ``(2, 2)`` fake mesh: an [8, 6] float32 sharded over data gathered
    whole (one all-gather of 192 bytes), a partial sum over model made
    whole (one all-reduce of 192 bytes); each counts twice its bytes, and
    nothing else moves any."""
    got = _run_fake_world("""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        dryrun.start_fake_world(4)
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(4, 6), mesh, [Shard(0), Replicate()],
                                   run_check=False)
            p = DTensor.from_local(torch.empty(8, 6), mesh, [Replicate(), Partial()],
                                   run_check=False)
            with ta.TraceMode() as mode:
                x.redistribute(mesh, [Replicate(), Replicate()])
                p.redistribute(mesh, [Replicate(), Replicate()])
        print(json.dumps(ta.analyze_trace(mode.trace)))
    """)
    assert got["collective_bytes"] == {"all-reduce": 192.0, "all-gather": 192.0,
                                       "reduce-scatter": 0.0, "all-to-all": 0.0,
                                       "collective-permute": 0.0}
    assert got["collective_counts"] == {"all-reduce": 1.0, "all-gather": 1.0,
                                        "reduce-scatter": 0.0, "all-to-all": 0.0,
                                        "collective-permute": 0.0}
    assert got["bytes"] == 2 * 192 + 2 * 192
    assert got["flops"] == 0


def _jax_prefill_flops(arch, b, s) -> float:
    cfg = jconfigs.smoke_config(arch)
    model = jax_build_model(cfg, JaxOptions(activation_dtype="float32", remat="none",
                                            attn_impl="ref", mixer_impl="ref"))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = jax.ShapeDtypeStruct((b, cfg.n_patches, cfg.d_model),
                                                     jnp.float32)
    if cfg.family == "audio":
        batch["frames"] = jax.ShapeDtypeStruct((b, cfg.encoder_seq, cfg.d_model), jnp.float32)
    hlo = jax.jit(model.prefill_fn).lower(params, batch).compile().as_text()
    return analyze_hlo(hlo)["flops"]


def products_jax_counts_apart(cfg, b, s) -> int:
    """What JAX counts as a product and the port computes without one:
    the depthwise conv (2 B S C K a mamba2 or RG-LRU layer) and the MoE
    combine weights (2 B S k E a layer)."""
    kinds = cfg.layer_kinds()
    if cfg.family == "ssm":
        return 2 * b * s * (cfg.d_inner + 2 * cfg.ssm_state) * cfg.ssm_conv * kinds.count("ssm")
    if cfg.family == "hybrid":
        return 2 * b * s * (cfg.lru_width or cfg.d_model) * RG_CONV * kinds.count("rglru")
    if cfg.n_experts:
        return 2 * b * s * cfg.top_k * cfg.n_experts * len(kinds)
    return 0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_flops_match_jax_analyze_hlo(arch):
    b, s = 2, 64
    cfg, model, params = _smoke_model(arch)
    _, trace = ta.trace_fn(model.prefill_fn, params,
                           _batch(cfg, model, ShapeConfig("small", s, b, "prefill")))
    got = ta.analyze_trace(trace)["flops"]
    apart = products_jax_counts_apart(cfg, b, s)
    assert (apart == 0) == (cfg.family in ("dense", "vlm", "audio"))
    assert got + apart == _jax_prefill_flops(arch, b, s)


def test_op_histogram_counts_the_sorts_as_the_reference():
    """heSRPT's shares sort once and the unfused allocate three times, as
    the reference's compiled HLO (1 and 3); the fused plain version twice
    (the reference's fused ref 2).  The CUDA kernel (the reference's Pallas
    kernel, 0) cannot be traced here."""
    from repro.core import engine as jengine
    from repro.core.policies import hesrpt as jhesrpt
    from repro.kernels.alloc import hesrpt_alloc_fused_ref as jfused
    from repro_torch.core import engine
    from repro_torch.core.policies import hesrpt
    from repro_torch.kernels.alloc import hesrpt_alloc_fused_ref

    x_np = np.random.default_rng(0).pareto(1.5, 64) + 1.0
    x = torch.tensor(x_np)

    def port(f):
        return ta.op_histogram(ta.trace_fn(f)[1]).get("aten.sort", 0.0)

    def ref(f):
        hlo = jax.jit(f).lower(jnp.asarray(x_np), 0.5).compile().as_text()
        return jax_op_histogram(hlo).get("sort", 0.0)

    got = (port(lambda: hesrpt(x, 0.5)),
           port(lambda: engine.quantize_allocation(hesrpt(x, 0.5), 16)),
           port(lambda: hesrpt_alloc_fused_ref(x, 0.5, 16)))
    want = (ref(jhesrpt),
            ref(lambda xv, pv: jengine.quantize_allocation_jax(jhesrpt(xv, pv), 16)),
            ref(lambda xv, pv: jfused(xv, pv, 16)[1]))
    assert got == want == (1, 3, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_jax(arch):
    for shape in SHAPES:
        assert roofline.model_flops(tconfigs.get_config(arch), shape) == \
            jroofline.model_flops(jconfigs.get_config(arch), jconfigs.SHAPE_BY_NAME[shape.name])


def _records(flops, nbytes, coll, dtype="bfloat16"):
    """The same totals as a port record and a reference record."""
    head = {"status": "ok", "arch": "phi4-mini-3.8b", "shape": "train_4k", "mesh": "pod16x16",
            "tag": "baseline", "n_devices": 256, "memory": {"temp_size_in_bytes": 7e9}}
    cb = {k: 0.0 for k in ta.COLLECTIVE_KINDS}
    cb["all-gather"] = coll
    port = dict(head, trace_analysis={"flops": flops, "flops_by_dtype": {dtype: flops},
                                      "bytes": nbytes, "collective_bytes": cb})
    ref = dict(head, hlo_analysis={"flops": flops, "bytes": nbytes, "collective_bytes": cb})
    return port, ref


@pytest.mark.parametrize("flops,nbytes,coll", [(1e16, 1e12, 1e9), (1e12, 1e14, 1e9),
                                               (1e12, 1e12, 1e13)])
def test_analyze_record_is_the_reference_at_h100_figures(flops, nbytes, coll):
    port, ref = _records(flops, nbytes, coll)
    got, want = roofline.analyze_record(port), jroofline.analyze_record(ref)
    np.testing.assert_allclose(got.compute_s, want.compute_s * 197e12 / 989e12, rtol=1e-12)
    np.testing.assert_allclose(got.memory_s, want.memory_s * 819e9 / 3.35e12, rtol=1e-12)
    np.testing.assert_allclose(got.collective_s, want.collective_s * 50e9 / 450e9, rtol=1e-12)
    assert got.dominant == want.dominant
    assert got.useful_ratio == want.useful_ratio
    assert got.model_flops == want.model_flops
    # float32 products take the card's float32 peak
    f32 = roofline.analyze_record(_records(flops, nbytes, coll, "float32")[0])
    np.testing.assert_allclose(f32.compute_s, flops / 67e12, rtol=1e-12)


def test_table_report_and_reanalyze(tmp_path):
    """A record with its saved trace: ``reanalyze`` recomputes what the
    record holds from the trace; ``table`` and ``report`` render it."""
    a = torch.ones(64, 32)
    _, trace = ta.trace_fn(lambda: (a @ a.T).relu().sum())
    deep = ta.analyze_trace(trace)
    res = tmp_path / "dryrun"
    res.mkdir()
    for tag in ("baseline", "opt"):
        cell = f"phi4-mini-3.8b__decode_32k__pod16x16__{tag}"
        rec = {"status": "ok", "arch": "phi4-mini-3.8b", "shape": "decode_32k",
               "mesh": "pod16x16", "tag": tag, "n_devices": 256,
               # 75 GB of temporaries fit alone; with 15 GB of arguments they do not
               "memory": {"temp_size_in_bytes": 7.5e10 if tag == "baseline" else 1e9,
                          "argument_size_in_bytes": 1.5e10},
               "trace_analysis": {**deep, "flops": 0.0}}
        (res / f"{cell}.json").write_text(json.dumps(rec))
        ta.write_trace(str(res / f"{cell}.trace.jsonl.gz"), trace)
    (res / "whisper-base__long_500k__pod16x16__baseline.json").write_text(json.dumps(
        {"status": "skipped", "arch": "whisper-base", "shape": "long_500k", "mesh": "pod16x16",
         "tag": "baseline", "reason": "pure full-attention stack"}))
    reanalyze.main([str(res)])
    rec = json.loads((res / "phi4-mini-3.8b__decode_32k__pod16x16__baseline.json").read_text())
    assert rec["trace_analysis"] == deep

    cells, skips, errors = roofline.load_cells(str(res), "baseline")
    assert len(cells) == 1 and len(skips) == 1 and not errors
    text = roofline.table(cells)
    assert "fits 80G" in text.splitlines()[0]
    assert "| phi4-mini-3.8b | decode_32k | pod16x16 |" in text and "n (90G)" in text

    md = tmp_path / "notes.md"
    md.write_text("# notes\n\n<!-- BASELINE_TABLES -->\n\n<!-- OPT_TABLES -->\n")
    report.main(str(res), str(md))
    out = md.read_text()
    assert "<!-- BASELINE_TABLES -->" not in out and "<!-- OPT_TABLES -->" not in out
    assert "### Single-pod (16x16 = 256 cards)" in out
    assert "whisper-base x long_500k" in out
    assert "n (90G)→y" in out


def test_miniature_dryrun():
    """The counterpart of JAX's ``test_miniature_dryrun``: smoke mixtral's
    train step (two microbatches, bf16, remat) on a fake ``(2, 2, 2)``
    pod/data/model mesh traces with flops, bytes, collective bytes (the pod
    axis really shards) and the step's memory recorded, the optimizer's
    moments placed as the parameters."""
    got = _run_fake_world("""
        from repro_torch.configs import ShapeConfig, smoke_config
        dryrun.start_fake_world(8)
        mesh = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
        with FakeTensorMode():
            fn, args = dryrun.build_cell(smoke_config("mixtral-8x7b"),
                                         ShapeConfig("mini", 32, 8, "train"), mesh,
                                         microbatches=2)
            rec, trace = dryrun.trace_step(fn, args)
        from torch.distributed.tensor import DTensor
        from repro_torch.train.tree import leaves
        params, opt, _ = args
        rec["opt_placed"] = all(
            isinstance(s, DTensor) and s.placements == p.placements
            for key in ("m", "v") for s, p in zip(leaves(opt[key]), leaves(params), strict=True))
        print(json.dumps(rec))
    """, timeout=300)
    assert got["opt_placed"]  # the moments placed as their parameters (opt_state_specs)
    deep = got["trace_analysis"]
    assert deep["flops"] > 0 and deep["bytes"] > 0
    assert sum(deep["collective_bytes"].values()) > 0
    assert got["cost"]["flops"] == got["cost"]["flop_counter_flops"] == deep["flops"]
    mem = got["memory"]
    assert mem["temp_size_in_bytes"] > 0 and mem["argument_size_in_bytes"] > 0
    assert got["trace_ops"] > 0


@pytest.mark.parametrize("model_axis,kv_heads", [(8, 2), (4, 4)])
def test_whisper_train_step_traces_on_a_fake_mesh(model_axis, kv_heads):
    """The smoke whisper's train step on a fake ``(2, model_axis)`` mesh,
    the reproducer of whisper-base's train_4k cell on ``(16, 16)``.

    - ``(8, 2)``: 4 query heads do not divide the model axis, as whisper's 8
      do not divide 16.  The decoder's self-attention residual left a
      partial sum that DTensor turned into a strided token shard over the
      model axis, and a weight gradient's ``mm`` then failed its sharding
      propagation (``aten._local_scalar_dense``); ``encdec._dec_block`` now
      pins that residual to the batch layout as every other sublayer.
    - ``(4, 4)``: as many K/V heads as query heads (whisper-base's 8 and 8),
      dividing the model axis.  The backward of ``local_map``'s input
      redistribution gave K's and V's gradients contiguous local tensors
      under transposed global strides, and the view that merges the heads
      back failed; ``common.rank_by_rank`` hands them on contiguous."""
    got = _run_fake_world(f"""
        from repro_torch.configs import ShapeConfig, smoke_config
        dryrun.start_fake_world({2 * model_axis})
        mesh = mesh_lib.make_mesh((2, {model_axis}), ("data", "model"), device_type="cpu")
        cfg = smoke_config("whisper-base").scaled(n_kv_heads={kv_heads})
        with FakeTensorMode():
            fn, args = dryrun.build_cell(cfg, ShapeConfig("mini", 32, 4, "train"), mesh,
                                         microbatches=1)
            rec, trace = dryrun.trace_step(fn, args)
        print(json.dumps(rec))
    """)
    assert got["cost"]["flops"] == got["cost"]["flop_counter_flops"] > 0
    assert got["memory"]["temp_size_in_bytes"] > 0 and got["trace_ops"] > 0


def test_a_refused_cell_is_recorded_as_skipped(tmp_path):
    rec = dryrun.run_cell("phi4-mini-3.8b", "long_500k", multi_pod=False, out_dir=str(tmp_path))
    ok, why = jconfigs.cell_applicable(jconfigs.get_config("phi4-mini-3.8b"),
                                       jconfigs.SHAPE_BY_NAME["long_500k"])
    assert not ok
    assert rec["status"] == "skipped" and rec["reason"] == why
    assert json.loads((tmp_path / "phi4-mini-3.8b__long_500k__pod16x16__baseline.json")
                      .read_text()) == rec
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,option,value,reason", [
    ("phi4-mini-3.8b", "attn_impl", "cuda", "ctypes"),
    ("mamba2-130m", "mixer_impl", "cuda", "ctypes"),
    ("mixtral-8x7b", "moe_impl", "ragged", ".tolist()"),
    ("mixtral-8x7b", "moe_impl", "ragged_local", ".tolist()"),
])
def test_untraceable_options_are_recorded_as_errors(tmp_path, arch, option, value, reason):
    """The hand-written kernels and the ragged dispatches cannot run in a
    fake trace: the cell records the reason, and no plain path is traced in
    their place (no world is even started)."""
    rec = dryrun.run_cell(arch, "decode_32k", multi_pod=False, out_dir=str(tmp_path),
                          **{option: value})
    assert rec["status"] == "error"
    assert f"{option}={value!r} cannot be traced" in rec["error"] and reason in rec["error"]
    assert "trace_analysis" not in rec
    assert not dist.is_initialized()
