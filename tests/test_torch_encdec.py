"""The port's vlm and audio families and their layers against the JAX
package, on the CPU; and the configs, counts and parameter trees of all
four new configs.

- The layers only whisper uses (``layer_norm``, the tanh ``gelu_mlp``, the
  sinusoidal positions) and the VLM splice and loss mask, on numpy inputs.
- The smoke whisper-base (2 + 2 layers, 8 frames, 4 / 2 heads of 16) built
  in both packages on the same parameters (the JAX model's ``init`` draws
  them, ``convert.params_from_jax`` carries them over): the encoder's
  states, the prefill's self- and cross-attention caches, and cross
  attention reading its cache at decode.
- ``params_from_jax`` on the trees of the four new configs: the port's
  tree, leaf for leaf in names and shapes, and the counts of the reference's
  formula plus ``uncounted_params`` against the JAX trees' own sizes
  (``jax.eval_shape``, no arrays made) at full size.
- ``serve.main`` on the CPU for the four archs.

Tolerances: float32 2e-4 absolute and relative on logits, states and
caches (the bar of ``tests/test_models.py``); the layers 1e-6 (one op
each); the sinusoid 1e-5 (``exp`` differs in the last ulp between XLA-CPU
and PyTorch, and the angle multiplies it by the position); masks and
shapes exact.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import uncounted_params  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import encdec, layers, vlm  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
NEW_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b", "internvl2-1b", "whisper-base")
AUDIO = "whisper-base"


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               **(tol or TOL))


# ------------------------------------------------------------------ layers
def test_layer_norm_matches_jax_in_float32_and_bf16():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 64)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _close(got, want, rtol=1e-6, atol=1e-6)
    want = jlayers.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
    got = layers.layer_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                            torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)
    # eps defaults to 1e-5, not the configs' norm_eps of 1e-6
    flat = np.full((1, 64), 2.0, np.float32)
    flat[0, 0] += 1e-3
    _close(layers.layer_norm(torch.from_numpy(flat), torch.ones(64), torch.zeros(64)),
           jlayers.layer_norm(jnp.asarray(flat), jnp.ones(64), jnp.zeros(64)),
           rtol=1e-6, atol=1e-6)


def test_gelu_mlp_is_the_tanh_form_on_transposed_weights():
    rng = np.random.default_rng(1)
    p = {"w1": rng.standard_normal((16, 40)), "b1": rng.standard_normal(40),
         "w2": rng.standard_normal((40, 16)), "b2": rng.standard_normal(16)}
    p = {k: (v * 0.3).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = jlayers.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    port = {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v) for k, v in p.items()}
    got = layers.gelu_mlp(port, torch.from_numpy(x))
    _close(got, want, rtol=1e-5, atol=1e-5)
    # the erf form is measurably elsewhere: the tanh form is the one held
    h = torch.from_numpy(x) @ port["w1"].T + port["b1"]
    erf = torch.nn.functional.linear(torch.nn.functional.gelu(h), port["w2"], port["b2"])
    assert (erf - got).abs().max().item() > 1e-4
    init = layers.gelu_mlp_init(torch.Generator().manual_seed(0), 16, 40)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        "w1": (40, 16), "b1": (40,), "w2": (16, 40), "b2": (16,)}
    assert not init["b1"].any() and not init["b2"].any()


def test_sinusoidal_positions_match_jax():
    for n, d in ((32, 64), (448, 512), (7, 2)):
        want = jlayers.sinusoidal_positions(n, d)
        got = layers.sinusoidal_positions(n, d)
        assert got.shape == (n, d) and got.dtype == torch.float32
        _close(got, want, rtol=0, atol=1e-5 * max(1, n / 32))
    # [sin | cos] halves, not interleaved; position 0 is [0...0 | 1...1]
    got = layers.sinusoidal_positions(3, 8)
    assert got[0, :4].abs().max() == 0 and (got[0, 4:] == 1).all()
    _close(got[2, 1], math.sin(2 * math.exp(-math.log(10000.0) / 3)), rtol=1e-6, atol=1e-6)
    for pos in (0, 5, 447):
        want = jencdec._sinusoidal_at(jnp.int32(pos), 512)
        got = layers.sinusoidal_at(torch.tensor(pos, dtype=torch.int32), 512)
        _close(got, want, rtol=0, atol=1e-5 * max(1, pos / 32))
        torch.testing.assert_close(got, layers.sinusoidal_positions(pos + 1, 512)[pos],
                                   rtol=0, atol=0)


def test_splice_patches_and_vlm_loss_mask_match_jax():
    cfg = tconfigs.smoke_config("internvl2-1b")
    rng = np.random.default_rng(2)
    tok = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    patches = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    want = jvlm.splice_patches(jnp.asarray(tok), jnp.asarray(patches))
    got = vlm.splice_patches(torch.from_numpy(tok), torch.from_numpy(patches))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == tok.shape  # replaced, not prepended
    got = vlm.splice_patches(torch.from_numpy(tok).to(torch.bfloat16), torch.from_numpy(patches))
    assert got.dtype == torch.bfloat16
    tokens = rng.integers(0, 256, (3, 10)).astype(np.int32)
    want = jvlm.vlm_loss_mask(jconfigs.smoke_config("internvl2-1b"), jnp.asarray(tokens))
    got = vlm.vlm_loss_mask(cfg, torch.from_numpy(tokens))
    assert got.shape == (1, 10) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- whisper smoke
@functools.lru_cache(maxsize=None)
def _whisper(attn_impl="ref"):
    cfg_j = jconfigs.smoke_config(AUDIO)
    jm = jax_build_model(cfg_j, JaxOptions(activation_dtype="float32", remat="none",
                                           attn_impl=attn_impl))
    params_j = jm.init(jax.random.PRNGKey(0))
    cfg_t = tconfigs.smoke_config(AUDIO)
    tm = build_model(cfg_t, ModelOptions(activation_dtype="float32"), device="cpu")
    return jm, params_j, tm, params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                                             device="cpu")


def _frames(cfg, b=2, seed=3):
    return (np.random.default_rng(seed).standard_normal((b, cfg.encoder_seq, cfg.d_model))
            * 0.05).astype(np.float32)


@pytest.mark.parametrize("attn_impl", ["ref", "interpret"])
def test_encode_matches_jax(attn_impl):
    """The encoder's states: non-causal self-attention without RoPE over
    the frames plus sinusoids (the JAX side through its Pallas kernel in
    interpret mode too)."""
    jm, params_j, tm, params_t = _whisper(attn_impl)
    frames = _frames(tm.cfg)
    want = jencdec.encode(params_j, jnp.asarray(frames), cfg=jm.cfg, opts=jm.opts)
    got = encdec.encode(params_t, torch.from_numpy(frames), cfg=tm.cfg, opts=tm.opts)
    assert got.shape == frames.shape
    _close(got, want)


def test_prefill_caches_hold_self_and_cross_kv_as_jax():
    jm, params_j, tm, params_t = _whisper()
    cfg = tm.cfg
    frames = _frames(cfg)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    _, cj = jm.prefill_fn(params_j, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
                          max_len=10)
    _, ct = tm.prefill_fn(params_t, {"tokens": torch.from_numpy(toks),
                                     "frames": torch.from_numpy(frames)}, max_len=10)
    assert set(ct) == {"blocks"} and len(ct["blocks"]) == cfg.n_layers
    for i, block in enumerate(ct["blocks"]):
        assert set(block) == {"self", "cross"}
        assert block["self"]["k"].shape == (2, cfg.n_kv_heads, 10, cfg.head_dim)
        assert block["cross"]["k"].shape == (2, cfg.n_kv_heads, cfg.encoder_seq, cfg.head_dim)
        for kind in ("self", "cross"):
            for name in ("k", "v"):
                _close(block[kind][name], cj["blocks"][kind][name][i])


def test_cross_attention_projects_once_and_decode_reads_its_cache():
    """The cross K/V come from the encoder states at the prefill; a decode
    step leaves them as they are (the same tensors) and gives the logits of
    a prefill of the longer prefix."""
    _, _, tm, params = _whisper()
    cfg = tm.cfg
    frames = torch.from_numpy(_frames(cfg))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9)))
    _, caches = tm.prefill_fn(params, {"tokens": toks[:, :6], "frames": frames}, max_len=9)
    cross = [(b["cross"]["k"], b["cross"]["v"]) for b in caches["blocks"]]
    snapshot = [(k.clone(), v.clone()) for k, v in cross]
    for t in range(6, 9):
        logits, caches = tm.decode_fn(params, toks[:, t:t + 1], caches, t)
        want, _ = tm.prefill_fn(params, {"tokens": toks[:, :t + 1], "frames": frames})
        torch.testing.assert_close(logits[:, 0], want, **TOL)
    for (k, v), (k0, v0), b in zip(cross, snapshot, caches["blocks"]):
        assert b["cross"]["k"] is k and b["cross"]["v"] is v
        assert torch.equal(k, k0) and torch.equal(v, v0)
    enc = encdec.encode(params, frames, cfg=cfg, opts=tm.opts)
    bp = params["dec_blocks"][0]
    k = torch.nn.functional.linear(enc, bp["cross_attn"]["wk"])
    torch.testing.assert_close(
        cross[0][0], k.reshape(2, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2),
        rtol=0, atol=0)


def test_cross_attention_has_no_bias_and_the_encoder_no_remat():
    cfg = tconfigs.smoke_config(AUDIO).scaled(qkv_bias=True)
    params = encdec.encdec_init(torch.Generator().manual_seed(0), cfg)
    assert "bq" in params["dec_blocks"][0]["self_attn"]
    assert "bq" in params["enc_blocks"][0]["attn"]
    assert not {"bq", "bk", "bv"} & set(params["dec_blocks"][0]["cross_attn"])
    # remat leaves the loss and gradient as they are (checked bit for bit in
    # test_torch_train.py); here: the encoder's blocks run once, the decoder
    # blocks twice (their forward again in the backward)
    model = build_model(tconfigs.smoke_config(AUDIO),
                        ModelOptions(activation_dtype="float32", remat="full"), device="cpu")
    params = tree_map(lambda t: t.requires_grad_(True),
                      model.init(torch.Generator().manual_seed(1)))
    calls = {"gelu_mlp": 0, "_dec_block": 0}
    real = {name: getattr(encdec, name) for name in calls}

    def counting(name):
        def fn(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return fn

    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (2, 5))),
             "labels": torch.from_numpy(rng.integers(0, 256, (2, 5))),
             "frames": torch.from_numpy(_frames(model.cfg))}
    try:
        for name in calls:
            setattr(encdec, name, counting(name))
        loss, _ = model.loss_fn(params, batch)
        loss.backward()
    finally:
        for name, fn in real.items():
            setattr(encdec, name, fn)
    n_enc, n_dec = model.cfg.encoder_layers, model.cfg.n_layers
    assert calls == {"gelu_mlp": n_enc + 2 * n_dec, "_dec_block": 2 * n_dec}
    assert params["enc_blocks"][0]["attn"]["wq"].grad.abs().sum() > 0


# ---------------------------------------------------- trees, counts, configs
def _jax_tree_size(arch, smoke=False):
    cfg = (jconfigs.smoke_config if smoke else jconfigs.get_config)(arch)
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))
    return sum(math.prod(s.shape) for s in jax.tree.leaves(shapes))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_from_jax_gives_the_ports_tree(arch):
    """Leaf for leaf in path and shape the tree the port's ``init`` draws;
    the projections transposed and the rest carried as it is (checked by
    value on a layer past the first)."""
    cfg_t, cfg_j = tconfigs.smoke_config(arch), jconfigs.smoke_config(arch)
    tree = jax.tree.map(np.asarray, jax_build_model(cfg_j).init(jax.random.PRNGKey(1)))
    got = params_from_jax(tree, cfg_t, device="cpu")
    want = build_model(cfg_t, device="cpu").init(torch.Generator().manual_seed(0))
    assert [(k, tuple(v.shape)) for k, v in leaves_with_paths(got)] == \
        [(k, tuple(v.shape)) for k, v in leaves_with_paths(want)]
    assert sum(t.numel() for t in leaves(got)) == sum(a.size for a in jax.tree.leaves(tree))
    if cfg_t.family == "audio":
        blk_j, blk_t = tree["dec_blocks"], got["dec_blocks"][1]
        for kind, name in (("mlp", "w1"), ("mlp", "w2"), ("cross_attn", "wk"),
                           ("self_attn", "wo")):
            np.testing.assert_array_equal(blk_t[kind][name].numpy(), blk_j[kind][name][1].T)
        for kind, name in (("mlp", "b1"), ("cross_norm", "b"), ("mlp_norm", "w")):
            np.testing.assert_array_equal(blk_t[kind][name].numpy(), blk_j[kind][name][1])
        np.testing.assert_array_equal(got["enc_blocks"][1]["attn"]["wv"].numpy(),
                                      tree["enc_blocks"]["attn"]["wv"][1].T)
        np.testing.assert_array_equal(got["dec_final"]["b"].numpy(), tree["dec_final"]["b"])
    else:
        mlp_j = tree["stack"]["blocks"]["sub0"]["mlp"]
        mlp_t = got["stack"]["blocks"][1]["sub0"]["mlp"]
        for name in mlp_t:
            np.testing.assert_array_equal(mlp_t[name].numpy(), np.swapaxes(mlp_j[name][1], -1, -2))
        if cfg_t.n_experts:
            e, d, f = cfg_t.n_experts, cfg_t.d_model, cfg_t.d_ff
            assert {k: tuple(v.shape) for k, v in mlp_t.items()} == {
                "router": (e, d), "gate": (e, f, d), "up": (e, f, d), "down": (e, d, f)}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_counts_match_the_jax_trees(arch):
    """The reference's formula, copied, and what its trees hold: at full size
    (abstract shapes only) and at the smoke size, where the port's own init
    holds the same number."""
    cfg_t, cfg_j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert cfg_t.param_count() == cfg_j.param_count()
    assert cfg_t.active_param_count() == cfg_j.active_param_count()
    assert cfg_t.param_count() + uncounted_params(cfg_t) == _jax_tree_size(arch)
    small = tconfigs.smoke_config(arch)
    n = sum(t.numel() for t in leaves(build_model(small, device="cpu").init(
        torch.Generator().manual_seed(0))))
    assert n == small.param_count() + uncounted_params(small) == _jax_tree_size(arch, smoke=True)


def test_the_published_counts():
    """The published sizes, counted from the JAX trees: qwen3-moe's 22B
    active of 235B, whisper-base 44,544 short."""
    count = {a: tconfigs.get_config(a).param_count() for a in NEW_ARCHS}
    assert count == {"mixtral-8x7b": 46_702_792_704, "qwen3-moe-235b-a22b": 235_093_610_496,
                     "internvl2-1b": 629_636_224, "whisper-base": 70_614_016}
    assert tconfigs.get_config("qwen3-moe-235b-a22b").active_param_count() == 22_190_739_456
    assert uncounted_params(tconfigs.get_config(AUDIO)) == 44_544
    assert all(uncounted_params(tconfigs.get_config(a)) == 0 for a in NEW_ARCHS[:3])


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cell_applicable_and_shapes_match_jax(arch):
    assert tconfigs.SHAPES == tuple(tconfigs.ShapeConfig(**vars(s)) for s in jconfigs.SHAPES)
    assert set(tconfigs.SHAPE_BY_NAME) == set(jconfigs.SHAPE_BY_NAME)
    cfg_t, cfg_j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert cfg_t.is_encdec == cfg_j.is_encdec
    assert cfg_t.attention_is_subquadratic == cfg_j.attention_is_subquadratic
    for shape in jconfigs.SHAPES:
        assert tconfigs.cell_applicable(cfg_t, tconfigs.SHAPE_BY_NAME[shape.name]) == \
            jconfigs.cell_applicable(cfg_j, shape)
    with pytest.raises(ValueError, match="bad shape kind"):
        tconfigs.ShapeConfig("x", 1, 1, "serve")


# -------------------------------------------------------------------- serve
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_main_runs_the_new_archs_on_the_cpu(arch, capsys):
    ids = tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "12", "--gen-len", "3"])
    assert ids.shape == (2, 3)
    assert "on cpu: generated (2, 3)" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-base"])
def test_serve_batch_draws_the_frontend_stubs_as_jax(arch):
    """The prompt, then the patches or frames from the same generator,
    standard normals times 0.02 in float32, as the JAX entry point."""
    cfg = tconfigs.smoke_config(arch)
    batch = tserve.make_batch(cfg, 2, 12, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(batch["tokens"].numpy(), rng.integers(0, 256, (2, 12)))
    name, n = ("patch_embeds", cfg.n_patches) if arch == "internvl2-1b" else ("frames",
                                                                               cfg.encoder_seq)
    want = jnp.asarray(rng.standard_normal((2, n, cfg.d_model)), jnp.float32) * 0.02
    assert set(batch) == {"tokens", name} and batch[name].dtype == torch.float32
    np.testing.assert_array_equal(batch[name].numpy(), np.asarray(want))
