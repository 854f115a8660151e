"""The port's training path against the JAX package, on the CPU: the loss
and its gradient, remat, AdamW, the train step, the data stream,
checkpoints, fault-tolerant recovery and the training CLI.

The smoke configs of phi4-mini-3.8b (dense), mamba2-130m (ssm),
recurrentgemma-9b (hybrid), mixtral-8x7b and qwen3-moe-235b-a22b (moe),
internvl2-1b (vlm) and whisper-base (audio) are built in both packages on
the same parameters: the JAX model's ``init`` draws them, ``convert.params_from_jax``
carries them over (``opt_state_from_jax`` carries the optimizer state).
Both run float32 activations with the mixers on their ``chunked`` paths (the
ones with a backward), tokens from a numpy seed or the shared synthetic
stream; a vlm's batch carries patch embeddings and an audio batch frames.

Tolerances (each measured gap is far inside its bar; ``CHANGES.md`` lists
them):

- ``loss_fn``: the loss (and the MoE load-balance loss) within
  ``LOSS_REL`` = 1e-5 relative and every gradient leaf within ``GRAD_REL``
  = 1e-4 in relative norm.  Both sides
  compute in float32 and differ in summation order and in the ulps of
  ``exp``/``rsqrt``/``pow``; a missed transpose or a wrong mask moves a leaf
  by O(1).
- AdamW on the same gradients: params, ``m``, ``v`` (and the master) within
  ``OPT_REL`` = 1e-6 relative (they agree bit for bit on these inputs).
- One train step on the same parameters and batch (microbatches, bf16
  casts): the loss as ``loss_fn``'s, the updated float32 masters within
  ``STEP_REL``; bf16 products differ in rounding between XLA and PyTorch, so
  the bf16-cast step is held at ``BF16_LOSS_REL``.
- 20 steps through ``run_with_recovery``: JAX's recoveries exactly, every
  loss within ``RUN_REL`` = 1e-4 relative of JAX's run (float32 gaps of
  ~1e-7 a step, grown by 20 AdamW steps); against the port's own
  uninterrupted run, the final parameters bit for bit.
- The stream's batches and a checkpoint round trip: exact.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import checkpoint as jcheckpoint  # noqa: E402
from repro.train import ft as jft  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jtrain  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import checkpoint, ft, optimizer  # noqa: E402
from repro_torch.train import train_step as ttrain  # noqa: E402
from repro_torch.train.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("phi4-mini-3.8b", "mamba2-130m", "recurrentgemma-9b", "mixtral-8x7b",
         "qwen3-moe-235b-a22b", "internvl2-1b", "whisper-base")
LOSS_REL, GRAD_REL, OPT_REL = 1e-5, 1e-4, 1e-6
STEP_REL, BF16_LOSS_REL, RUN_REL = 1e-5, 1e-3, 1e-4
B, S = 4, 24


@functools.lru_cache(maxsize=None)
def _models(arch, remat="none"):
    """The JAX model and its params, and the port's model on the CPU."""
    jm = jax_build_model(jconfigs.smoke_config(arch),
                         JaxOptions(attn_impl="chunked", mixer_impl="chunked",
                                    activation_dtype="float32", remat="none"))
    params_j = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tconfigs.smoke_config(arch),
                     ModelOptions(activation_dtype="float32", remat=remat), device="cpu")
    return jm, params_j, tm


def _port_params(arch, params_j):
    return params_from_jax(jax.tree.map(np.asarray, params_j), tconfigs.smoke_config(arch),
                           device="cpu")


def _batch(cfg, seed=1, b=B, s=S):
    """Tokens and labels from a numpy seed, then a vlm's patch embeddings or
    an audio model's frames (normals times 0.05)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal((b, cfg.n_patches, cfg.d_model))
                               * 0.05).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
                         * 0.05).astype(np.float32)
    return out


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _tree_rel(arch, got, want_j) -> dict:
    """Relative norm gap per leaf of a port tree against a JAX tree of the
    same parameters (carried over by ``params_from_jax``)."""
    want = _port_params(arch, want_j)
    return {k: _rel(g, w) for (k, g), (_, w) in zip(leaves_with_paths(got),
                                                     leaves_with_paths(want), strict=True)}


def _value_and_grad(tm, params, batch):
    alias = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = tm.loss_fn(alias, batch)
    loss.backward()
    return loss.detach(), metrics, tree_map(lambda p: p.grad, alias)


# ------------------------------------------------------------- loss, remat
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax(arch):
    jm, params_j, tm = _models(arch)
    batch = _batch(jm.cfg)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _value_and_grad(tm, _port_params(arch, params_j), batch)
    assert _rel(loss, loss_j) <= LOSS_REL
    assert _rel(metrics["ce"], metrics_j["ce"]) <= LOSS_REL
    if jm.cfg.n_experts:  # ce + 0.01 * aux
        assert float(metrics_j["aux_loss"]) > 0
        assert _rel(metrics["aux_loss"], metrics_j["aux_loss"]) <= LOSS_REL
    else:
        assert float(metrics["aux_loss"]) == float(metrics_j["aux_loss"]) == 0.0
    gaps = _tree_rel(arch, grads, grads_j)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_REL, (worst, gaps[worst])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_none_bit_for_bit(arch):
    jm, params_j, plain = _models(arch)
    remat = _models(arch, "full")[2]
    assert remat.opts.remat == "full" and plain.opts.remat == "none"
    params = _port_params(arch, params_j)
    batch = _batch(jm.cfg, seed=2)
    loss_a, _, grads_a = _value_and_grad(plain, params, batch)
    loss_b, _, grads_b = _value_and_grad(remat, params, batch)
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(leaves(grads_a), leaves(grads_b), strict=True):
        assert torch.equal(a, b)


def test_cross_entropy_masks_and_takes_the_float32_reduction():
    from repro.models.model import cross_entropy as jce
    from repro_torch.models.model import cross_entropy

    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    for mask in (np.ones((2, 5), np.float32), (rng.random((2, 5)) < 0.5).astype(np.float32),
                 np.zeros((2, 5), np.float32)):
        want = jce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
        got = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16).float(),
                            torch.from_numpy(labels), torch.from_numpy(mask))
        want_bf = jce(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels),
                      jnp.asarray(mask))
        assert abs(got.item() - float(want_bf)) <= 1e-5 * max(1.0, abs(float(want_bf)))
        got32 = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                              torch.from_numpy(mask))
        assert abs(got32.item() - float(want)) <= 1e-6 * max(1.0, abs(float(want)))


# ----------------------------------------------------------------- AdamW
def _opt_tree(f):
    return {"w": f((8, 16)), "blocks": [{"b": f((32,))}, {"b": f((32,))}], "k": f((4, 4, 4))}


@pytest.mark.parametrize("keep_master", [False, True])
def test_apply_updates_matches_jax_over_three_steps(keep_master):
    rng = np.random.default_rng(4)
    p_np = _opt_tree(lambda s: rng.standard_normal(s).astype(np.float32))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if keep_master else (jnp.float32, torch.float32)
    # warmup over the first two steps; clip_norm below every step's norm (~15)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    pj = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    pt = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), p_np)
    sj = jopt.init_opt_state(pj, keep_master=keep_master)
    st = optimizer.init_opt_state(pt, keep_master=keep_master)
    for step in range(3):
        g_np = _opt_tree(lambda s: rng.standard_normal(s).astype(np.float32))
        pj, sj, mj = jopt.apply_updates(pj, jax.tree.map(lambda a: jnp.asarray(a, jdt), g_np),
                                        sj, jopt.OptimizerConfig(**cfg))
        pt, st, mt = optimizer.apply_updates(
            pt, jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), g_np), st,
            optimizer.OptimizerConfig(**cfg))
        assert float(mj["grad_norm"]) > 10 * cfg["clip_norm"]  # the clip binds
        assert _rel(mt["grad_norm"], mj["grad_norm"]) <= OPT_REL
        assert _rel(mt["lr"], mj["lr"]) <= OPT_REL
        assert int(st["step"]) == int(sj["step"]) == step + 1
        assert st["step"].dtype == torch.int32
    names = ("m", "v") + (("master",) if keep_master else ())
    for got, want in [(pt, pj)] + [(st[n], sj[n]) for n in names]:
        for a, b in zip(jax.tree.leaves(got, is_leaf=torch.is_tensor), jax.tree.leaves(want),
                        strict=True):
            assert a.dtype == (tdt if got is pt else torch.float32)
            assert _rel(a, b) <= OPT_REL


def _in_place_equals_functional(dtype, keep_master):
    rng = np.random.default_rng(5)
    params = _opt_tree(lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                       .to(dtype))
    cfg = optimizer.OptimizerConfig(lr=1e-2, warmup_steps=1, clip_norm=0.5)
    state = optimizer.init_opt_state(params, keep_master=keep_master)
    for _ in range(2):
        grads = _opt_tree(lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
        want_p, want_s, want_m = optimizer.apply_updates(params, tree_map(torch.clone, grads),
                                                         state, cfg)
        donated_p, donated_s = tree_map(torch.clone, params), tree_map(torch.clone, state)
        got_p, got_s, got_m = optimizer.apply_updates(donated_p, grads, donated_s, cfg,
                                                      inplace=True)
        assert all(a is b for a, b in zip(leaves(got_p), leaves(donated_p)))
        assert all(a.dtype == dtype for a in leaves(got_p))
        for a, b in zip(leaves((got_p, got_s, got_m)), leaves((want_p, want_s, want_m)),
                        strict=True):
            assert torch.equal(a, b)
        params, state = want_p, want_s
    return params, state


def test_apply_updates_in_place_equals_the_functional_update():
    _in_place_equals_functional(torch.float32, False)


@pytest.mark.parametrize("dtype, keep_master", [
    (torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, True)])
def test_apply_updates_in_place_equals_the_functional_update_in_every_layout(dtype,
                                                                              keep_master):
    params, _ = _in_place_equals_functional(dtype, keep_master)
    if dtype == torch.bfloat16 and not keep_master:
        # A bf16 leaf with no master is updated in float32 and rounded once:
        # its decay term is not rounded to bf16 on the way.
        rng = np.random.default_rng(5)
        p0 = _opt_tree(lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                       .to(dtype))
        cfg = optimizer.OptimizerConfig(lr=1e-2, warmup_steps=1, clip_norm=0.5)
        grads = _opt_tree(lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
        got, _, _ = optimizer.apply_updates(p0, grads, optimizer.init_opt_state(p0), cfg)
        f32 = tree_map(lambda t: t.float(), p0)
        want, _, _ = optimizer.apply_updates(f32, grads, optimizer.init_opt_state(f32), cfg)
        for a, b in zip(leaves(got), leaves(want), strict=True):
            assert torch.equal(a, b.to(dtype))


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("arch, micro, cast", [
    ("phi4-mini-3.8b", 2, False), ("phi4-mini-3.8b", 2, True), ("recurrentgemma-9b", 1, True),
    ("mixtral-8x7b", 2, False), ("qwen3-moe-235b-a22b", 1, False), ("internvl2-1b", 2, False),
    ("whisper-base", 2, False), ("whisper-base", 1, True),
])
def test_train_step_matches_jax(arch, micro, cast):
    jm, params_j, tm = _models(arch)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jtrain.make_train_step(jm, jtrain.TrainConfig(
        microbatches=micro, optimizer=jopt.OptimizerConfig(**ocfg), cast_params_bf16=cast))
    tstep = ttrain.make_train_step(tm, ttrain.TrainConfig(
        microbatches=micro, optimizer=optimizer.OptimizerConfig(**ocfg), cast_params_bf16=cast))
    batch = _batch(jm.cfg, seed=6)
    state_j = jopt.init_opt_state(params_j)
    pj, sj, mj = jstep(params_j, state_j, {k: jnp.asarray(v) for k, v in batch.items()})
    state_t = opt_state_from_jax(jax.tree.map(np.asarray, state_j), tm.cfg, device="cpu")
    pt, st, mt = tstep(_port_params(arch, params_j), state_t, batch)
    assert set(mt) == set(mj)
    loss_rel = BF16_LOSS_REL if cast else STEP_REL
    assert _rel(mt["loss"], mj["loss"]) <= loss_rel
    if not cast:  # bf16 products round apart: the update of a near-zero gradient may flip
        assert _rel(mt["grad_norm"], mj["grad_norm"]) <= GRAD_REL
        gaps = _tree_rel(arch, st["m"], sj["m"])
        assert max(gaps.values()) <= GRAD_REL, ("m", max(gaps, key=gaps.get))
        # A leaf that starts at zero (a bias) is -lr g / (|g| + eps) after the
        # step, element by element: where |g| is near AdamW's eps its
        # summation-order gap is not damped (whisper's smoke cross_norm
        # bias: 1.27e-4 of the leaf from one element of gradient 1.75e-9).
        # Those leaves are held together, as one vector; every other leaf
        # alone.
        start = _port_params(arch, params_j)
        zero = {k for k, v in leaves_with_paths(start) if not v.any()}
        gaps = _tree_rel(arch, pt, pj)
        assert max(g for k, g in gaps.items() if k not in zero) <= GRAD_REL, (
            "params", max(gaps, key=gaps.get))
        if zero:
            want = dict(leaves_with_paths(_port_params(arch, pj)))
            got = dict(leaves_with_paths(pt))
            assert _rel(torch.cat([got[k].flatten() for k in sorted(zero)]),
                        torch.cat([want[k].flatten() for k in sorted(zero)])) <= GRAD_REL
    assert all(t.dtype == torch.float32 for t in leaves(pt))  # float32 masters either way


def test_microbatched_step_equals_the_mean_of_its_microbatches():
    jm, params_j, tm = _models("phi4-mini-3.8b")
    params = _port_params("phi4-mini-3.8b", params_j)
    batch = _batch(jm.cfg, seed=7)
    step = ttrain.make_train_step(tm, ttrain.TrainConfig(microbatches=2))
    _, _, metrics = step(params, optimizer.init_opt_state(params), batch)
    halves = [_value_and_grad(tm, params, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})[0]
              for i in range(2)]
    assert metrics["loss"].item() == ((halves[0] + halves[1]) / 2).item()
    with pytest.raises(ValueError, match="divisible"):
        ttrain._split_micro({"tokens": torch.zeros(3, 2)}, 2)


def test_init_fn_and_the_serve_steps_are_exported():
    from repro_torch import train

    _, _, tm = _models("phi4-mini-3.8b")
    params, state = train.make_init_fn(tm, train.TrainConfig())(torch.Generator().manual_seed(0))
    assert set(state) == {"m", "v", "step"} and int(state["step"]) == 0
    assert len(leaves(state["m"])) == len(leaves(params))
    logits, _ = train.make_prefill_step(tm)(params, {"tokens": torch.zeros(1, 3, dtype=torch.long)})
    assert logits.shape == (1, tm.cfg.vocab_size)


# ---------------------------------------------------------- data, checkpoint
@pytest.mark.parametrize("arch", ARCHS)
def test_stream_batches_equal_jax_exactly(arch):
    for kw in (dict(), dict(seed=3, host_id=1, n_hosts=2)):
        mine = pipeline.make_stream_for(tconfigs.smoke_config(arch), 33, 4, **kw)
        ref = jpipeline.make_stream_for(jconfigs.smoke_config(arch), 33, 4, **kw)
        stub = {"vlm": {"patch_embeds"}, "audio": {"frames"}}.get(mine.family, set())
        for step, (got, want) in enumerate(zip(mine, ref)):
            assert set(got) == set(want) == {"tokens", "labels"} | stub
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            if step == 3:
                break


def test_checkpoint_round_trip_is_exact(tmp_path):
    rng = np.random.default_rng(8)
    tree = {"params": _opt_tree(lambda s: torch.from_numpy(rng.standard_normal(s)
                                                           .astype(np.float32))),
            "bf16": torch.randn(5, 7, generator=torch.Generator().manual_seed(1))
            .to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}
    checkpoint.save(str(tmp_path), tree, step=7, extra={"arch": "x"})
    assert checkpoint.exists(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["arrays.npz", "manifest.json"]
    manifest = checkpoint.load_manifest(str(tmp_path))
    assert manifest == {"step": 7, "keys": sorted(k for k, _ in leaves_with_paths(tree)),
                        "extra": {"arch": "x"}}
    assert "params/blocks/1/b" in manifest["keys"]
    target = tree_map(torch.zeros_like, tree)
    got = checkpoint.restore(str(tmp_path), target)
    for a, b, t in zip(leaves(got), leaves(tree), leaves(target), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a is t  # restored in place, into the target's tensors
    # the layout is the JAX package's: its own restore reads the file
    back = jcheckpoint.restore(str(tmp_path), {"step": np.zeros((), np.int32),
                                               "bf16": np.zeros((5, 7), np.float32)}
                               | {"params": jax.tree.map(np.zeros_like, jax.tree.map(
                                   lambda t: t.numpy(), tree["params"],
                                   is_leaf=torch.is_tensor))})
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]), tree["params"]["w"].numpy())
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(str(tmp_path), {**target, "step": torch.zeros(2, dtype=torch.int32)})
    with pytest.raises(KeyError, match="missing"):
        checkpoint.restore(str(tmp_path), {**target, "extra_leaf": torch.zeros(1)})


# ------------------------------------------------------------- recovery
def _jax_run(arch, n_steps, fail_at, ckpt_dir, ckpt_every):
    jm, params_j, _ = _models(arch)
    tc = jtrain.TrainConfig(optimizer=jopt.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                                           total_steps=n_steps))
    step_fn = jax.jit(jtrain.make_train_step(jm, tc))
    stream = jpipeline.make_stream_for(jm.cfg, S, B)
    return jft.run_with_recovery(
        step_fn, lambda s: {k: jnp.asarray(v) for k, v in stream.batch(s).items()},
        params_j, jopt.init_opt_state(params_j), n_steps=n_steps, ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every, injector=jft.FailureInjector(fail_at))


def _port_run(arch, n_steps, fail_at, ckpt_dir, ckpt_every, donate=False):
    _, params_j, tm = _models(arch)
    tc = ttrain.TrainConfig(optimizer=optimizer.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                                                total_steps=n_steps))
    stream = pipeline.make_stream_for(tm.cfg, S, B)
    params = _port_params(arch, params_j)
    seen = []
    out = ft.run_with_recovery(
        ttrain.make_train_step(tm, tc, donate=donate), stream.batch, params,
        optimizer.init_opt_state(params), n_steps=n_steps, ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every, injector=ft.FailureInjector(fail_at),
        on_metrics=lambda step, m: seen.append(step))
    return (*out, seen)


def test_run_with_recovery_matches_jax_and_an_uninterrupted_run(tmp_path):
    arch, n, every = "phi4-mini-3.8b", 20, 4
    _, _, hist_j = _jax_run(arch, n, (5, 12), str(tmp_path / "jax"), every)
    params, state, hist, seen = _port_run(arch, n, (5, 12), str(tmp_path / "port"), every)
    assert hist["recoveries"] == hist_j["recoveries"] == [
        {"failed_at": 5, "resumed_from": 4}, {"failed_at": 12, "resumed_from": 12}]
    assert all(isinstance(x, float) for x in hist["loss"])
    assert len(hist["loss"]) == len(hist_j["loss"]) == n + 1
    assert seen == list(range(5)) + list(range(4, n))
    gaps = [abs(a - b) / abs(b) for a, b in zip(hist["loss"], hist_j["loss"], strict=True)]
    assert max(gaps) <= RUN_REL, max(gaps)
    assert hist["loss"][-1] < hist["loss"][0]
    assert checkpoint.load_manifest(str(tmp_path / "port"))["step"] == n
    # the same run with no failure, donated: the same final state bit for bit
    params_u, state_u, hist_u, _ = _port_run(arch, n, (), str(tmp_path / "plain"), every,
                                             donate=True)
    assert hist_u["recoveries"] == []
    assert hist_u["loss"] == hist["loss"][:5] + hist["loss"][6:]
    for a, b in zip(leaves((params, state)), leaves((params_u, state_u)), strict=True):
        assert torch.equal(a, b)


def test_heartbeat_and_failure_injector():
    hb = ft.Heartbeat(timeout_s=5.0)
    hb.beat(0, now=0.0)
    hb.beat(1, now=4.0)
    assert hb.dead_workers(now=6.0) == [0]
    inj = ft.FailureInjector([2, 2, 5])
    assert [inj.check(s) for s in range(6)] == [False, False, True, False, False, True]
    assert not inj.check(2) and inj.injected == [2, 5]


def test_train_cli_recovers_and_finishes(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "phi4-mini-3.8b",
         "--smoke", "--steps", "6", "--device", "cpu", "--fail-at", "3", "--ckpt-every", "3",
         "--seq-len", "32", "--global-batch", "4", "--log-every", "1",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
        capture_output=True, text=True, timeout=300, check=True,
    )
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("done: 6 steps, final loss ")
    assert lines[-1].endswith("recoveries 1")
    assert sum(line.startswith("step ") for line in lines) == 6
    assert lines[0].startswith("step     0 loss ")
    assert " gnorm " in lines[0] and " tok/s " in lines[0]


@pytest.mark.parametrize("arch", ARCHS[3:])
def test_train_cli_trains_the_other_families(arch, tmp_path, capsys):
    """``launch.train`` on the moe, vlm and audio smoke configs: the stream's
    patches or frames reach the loss, and four steps lower it."""
    from repro_torch.launch import train as train_cli

    hist = train_cli.main(["--arch", arch, "--smoke", "--steps", "4", "--device", "cpu",
                           "--seq-len", "16", "--global-batch", "2", "--log-every", "1",
                           "--ckpt-every", "2", "--lr", "1e-2",
                           "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(hist["loss"]) == 4 and hist["recoveries"] == []
    assert all(np.isfinite(hist["loss"])) and hist["loss"][-1] < hist["loss"][0]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("done: 4 steps")
