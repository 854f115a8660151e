"""The port's models against the JAX package, at the smoke size.

The smoke-size ``phi4-mini-3.8b`` (2 layers, width 64, 4 query / 2 KV heads
of dim 16, vocab 256), and of the other families mixtral-8x7b and
qwen3-moe-235b-a22b (moe: 4 experts, top-2; mixtral with a window of 16),
internvl2-1b (vlm: 4 patches spliced over the first token embeddings) and
whisper-base (audio: 2 + 2 layers over 8 frames), are built in both packages
on the same parameters: the JAX model's ``init`` draws them,
``convert.params_from_jax`` carries them over.  The JAX model runs with
``attn_impl="ref"`` and with ``"interpret"``
(its Pallas flash kernel executed in Python); the port runs on the CPU,
where attention takes its plain version.  Tokens come from a numpy seed.

Tolerance: ``TOL`` = 2e-4 absolute and relative on logits and caches, the
bar of ``tests/test_models.py``'s prefill/decode check.  Both sides compute
in float32 and differ only in summation order and in the ulps of
``pow``/``exp``/``rsqrt`` between XLA-CPU and PyTorch; a missed transpose
or a wrong RoPE convention moves the logits by O(1e-2) or more.

Also here: the port's configs and layers against the JAX package's and the
initialisers' distributions.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.attention import init_cache  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "phi4-mini-3.8b"
B, S, GEN = 2, 20, 4  # prompt S; decode GEN steps past it
#: The moe, vlm and audio configs, beside phi4-mini in the whole-model tests.
FAMILY_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b", "internvl2-1b", "whisper-base")
#: (arch, attn_impl) cases: phi4-mini's keep their ids, "ref" and "interpret".
CASES = [pytest.param(ARCH, impl, id=impl) for impl in ("ref", "interpret")] + [
    pytest.param(arch, impl, id=f"{arch}-{impl}")
    for arch in FAMILY_ARCHS for impl in ("ref", "interpret")]


@functools.lru_cache(maxsize=None)
def _models(attn_impl, arch=ARCH):
    cfg_j = jconfigs.smoke_config(arch)
    jm = jax_build_model(cfg_j, JaxOptions(activation_dtype="float32", remat="none",
                                           attn_impl=attn_impl))
    params_j = jm.init(jax.random.PRNGKey(0))
    cfg_t = tconfigs.smoke_config(arch)
    tm = build_model(cfg_t, ModelOptions(activation_dtype="float32"), device="cpu")
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
    return jm, params_j, tm, params_t


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _batches(cfg, toks, seed=1):
    """``{"tokens"}`` and, for a vlm or audio config, its patches or frames
    (numpy normals times 0.05), as JAX arrays and as tensors."""
    batch = {"tokens": toks}
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((toks.shape[0], cfg.n_patches, cfg.d_model))
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((toks.shape[0], cfg.encoder_seq, cfg.d_model))
    batch = {k: v if k == "tokens" else (v * 0.05).astype(np.float32) for k, v in batch.items()}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _cache_pairs(cfg, ct, cj):
    """(port tensor, JAX array) of every K/V cache leaf, layer by layer."""
    kinds = ("self", "cross") if cfg.family == "audio" else ("sub0",)
    return [(block[kind][name], cj["blocks"][kind][name][i])
            for i, block in enumerate(ct["blocks"]) for kind in kinds for name in ("k", "v")]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), **TOL)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_configs_match_the_jax_package(arch):
    for get in ("get_config", "smoke_config"):
        t = dataclasses.asdict(getattr(tconfigs, get)(arch))
        j = dataclasses.asdict(getattr(jconfigs, get)(arch))
        assert t == j, get
    assert tconfigs.get_config(arch).param_count() == jconfigs.get_config(arch).param_count()


def test_phi4_mini_parameter_count():
    cfg = tconfigs.get_config(ARCH)
    assert cfg.param_count() == 4_450_618_368
    # The port's init at smoke size holds exactly the analytic count.
    small = tconfigs.smoke_config(ARCH)
    model = build_model(small, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    n = sum(t.numel() for t in jax.tree.leaves(params, is_leaf=torch.is_tensor))
    assert n == small.param_count()


# ------------------------------------------------------------------- layers
def test_rms_norm_and_rope_match_the_jax_package():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    pos = np.arange(100, 107, dtype=np.int32)
    for theta in (10000.0, 1_000_000.0):
        _close(tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_swiglu_matches_the_jax_package_on_transposed_weights():
    rng = np.random.default_rng(1)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.2
         for n, s in (("gate", (16, 24)), ("up", (16, 24)), ("down", (24, 16)))}
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = jlayers.swiglu({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x))
    got = tlayers.swiglu({n: torch.from_numpy(a.T.copy()) for n, a in p.items()},
                         torch.from_numpy(x))
    _close(got, want)


def test_initialisers_draw_the_jax_distributions():
    """U(-1, 1) * sqrt(3 / fan_in), and U(-1, 1) * 0.02 for the tables: the
    bounds hold and the standard deviation is the uniform's, scale / sqrt(3)."""
    gen = torch.Generator().manual_seed(0)
    w = tlayers.uniform_scale_init(gen, (512, 300))  # [out, in]: fan_in 300
    bound = (3.0 / 300) ** 0.5
    assert w.abs().max().item() <= bound
    assert abs(w.std().item() - bound / 3 ** 0.5) < 0.01 * bound
    e = tlayers.embed_init(gen, 1000, 64)
    assert e.abs().max().item() <= 0.02
    assert abs(e.std().item() - 0.02 / 3 ** 0.5) < 0.01 * 0.02
    j = jlayers.uniform_scale_init(jax.random.PRNGKey(0), (300, 512))  # [in, out]
    assert abs(float(jnp.std(j)) - w.std().item()) < 0.01 * bound


# ------------------------------------------------------------- whole model
@pytest.mark.parametrize("arch, attn_impl", CASES)
def test_prefill_logits_and_caches_match_the_jax_model(arch, attn_impl):
    jm, params_j, tm, params_t = _models(attn_impl, arch)
    cfg = tm.cfg
    bj, bt = _batches(cfg, _tokens(cfg, B, S))
    lj, cj = jm.prefill_fn(params_j, bj, max_len=S + GEN)
    lt, ct = tm.prefill_fn(params_t, bt, max_len=S + GEN)
    assert lt.shape == (B, cfg.vocab_size)
    _close(lt, lj)
    capacity = min(S + GEN, cfg.window) if cfg.window else S + GEN
    self_kind = "self" if cfg.family == "audio" else "sub0"
    for block in ct["blocks"]:
        assert block[self_kind]["k"].shape == (B, cfg.n_kv_heads, capacity, cfg.head_dim)
    for got, want in _cache_pairs(cfg, ct, cj):
        _close(got, want)


@functools.lru_cache(maxsize=None)
def _bf16_models(attn_impl):
    """Both models with bf16 activations (the packages' default), float32
    parameters carried over from the JAX model."""
    cfg_j = jconfigs.smoke_config(ARCH)
    jm = jax_build_model(cfg_j, JaxOptions(activation_dtype="bfloat16", remat="none",
                                           attn_impl=attn_impl))
    params_j = jm.init(jax.random.PRNGKey(0))
    cfg_t = tconfigs.smoke_config(ARCH)
    tm = build_model(cfg_t, ModelOptions(), device="cpu")
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
    return jm, params_j, tm, params_t


@pytest.mark.parametrize("attn_impl", ["ref", "interpret"])
def test_bf16_prefill_logits_match_the_jax_model(attn_impl):
    """The prefill in bf16, the path the card's bf16 flash kernel serves.
    Tolerance 1e-2 absolute: each side rounds every activation to bf16 at
    its own points (XLA fuses and keeps float32 inside a fusion, PyTorch
    rounds after each op), so the smoke model's logits (|logit| < 0.5, one
    bf16 ulp ~2e-3 there) differ by a few ulps."""
    jm, params_j, tm, params_t = _bf16_models(attn_impl)
    toks = _tokens(tm.cfg, B, S)
    lj, _ = jm.prefill_fn(params_j, {"tokens": jnp.asarray(toks)})
    lt, ct = tm.prefill_fn(params_t, {"tokens": torch.from_numpy(toks)})
    assert lt.dtype == torch.bfloat16 and ct["blocks"][0]["sub0"]["k"].dtype == torch.bfloat16
    assert lt.shape == (B, tm.cfg.vocab_size)
    np.testing.assert_allclose(lt.double().numpy(), np.asarray(lj, np.float64), rtol=0, atol=1e-2)


@pytest.mark.parametrize("arch, attn_impl", CASES)
def test_teacher_forced_decode_matches_the_jax_model(arch, attn_impl):
    """Prefill S - 3 tokens, then decode the next GEN + 3 given tokens, past
    the prefill length (and, for mixtral, past its window of 16): the logits
    of every step agree."""
    jm, params_j, tm, params_t = _models(attn_impl, arch)
    toks = _tokens(tm.cfg, B, S + GEN, seed=2)
    p0 = S - 3
    bj, bt = _batches(tm.cfg, toks[:, :p0], seed=2)
    lj, cj = jm.prefill_fn(params_j, bj, max_len=S + GEN)
    lt, ct = tm.prefill_fn(params_t, bt, max_len=S + GEN)
    _close(lt, lj)
    decode_j = jax.jit(jm.decode_fn)
    for t in range(p0, S + GEN):
        lj, cj = decode_j(params_j, jnp.asarray(toks[:, t : t + 1]), cj, jnp.int32(t))
        lt, ct = tm.decode_fn(params_t, torch.from_numpy(toks[:, t : t + 1]), ct, t)
        assert lt.shape == (B, 1, tm.cfg.vocab_size)
        _close(lt, lj)


def test_generate_gives_the_jax_models_greedy_ids():
    jm, params_j, tm, params_t = _models("ref")
    toks = _tokens(tm.cfg, B, S, seed=3)
    want = jax_generate(jm, params_j, {"tokens": jnp.asarray(toks)}, gen_len=6)
    timings = {}
    got = tserve.generate(tm, params_t, {"tokens": torch.from_numpy(toks)}, gen_len=6,
                          timings=timings)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert timings["prefill_s"] > 0 and timings["decode_s"] > 0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_generate_gives_the_jax_models_greedy_ids_for_the_other_families(arch):
    """As the test above, for the moe, vlm and audio configs (the prompt's
    patches or frames in the batch)."""
    jm, params_j, tm, params_t = _models("ref", arch)
    bj, bt = _batches(tm.cfg, _tokens(tm.cfg, B, S, seed=3), seed=3)
    want = jax_generate(jm, params_j, bj, gen_len=6)
    got = tserve.generate(tm, params_t, bt, gen_len=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_main_runs_on_the_cpu(capsys):
    ids = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "12", "--gen-len", "3"])
    assert ids.shape == (2, 3)
    assert "on cpu: generated (2, 3)" in capsys.readouterr().out


def test_decode_from_empty_caches_matches_prefill():
    """Token by token from ``init_cache`` (capacity S, zeros) gives, at every
    step, the logits of a prefill of the prefix."""
    _, _, tm, params_t = _models("ref")
    cfg = tm.cfg
    toks = torch.from_numpy(_tokens(cfg, B, 8, seed=5))
    caches = {"blocks": [{"sub0": init_cache(cfg, B, 8, torch.float32, "cpu")}
                         for _ in range(cfg.n_layers)]}
    assert caches["blocks"][0]["sub0"]["k"].shape == (B, cfg.n_kv_heads, 8, cfg.head_dim)
    for t in range(8):
        logits, caches = tm.decode_fn(params_t, toks[:, t : t + 1], caches, t)
        want, _ = tm.prefill_fn(params_t, {"tokens": toks[:, : t + 1]})
        _close(logits[:, 0], want)


def test_decode_through_a_window_ring_cache_matches_full_prefill():
    """With a sliding window the cache is a ring of ``window`` slots; decode
    through it past the window gives the logits of a full-prefix prefill
    (the JAX package's consistency check, on the port alone)."""
    cfg = tconfigs.smoke_config(ARCH).scaled(window=6)
    model = build_model(cfg, ModelOptions(activation_dtype="float32"), device="cpu")
    params = model.init(torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_tokens(cfg, B, 16, seed=4))
    logits, caches = model.prefill_fn(params, {"tokens": toks[:, :9]}, max_len=16)
    assert caches["blocks"][0]["sub0"]["k"].shape[2] == 6
    for t in range(9, 16):
        logits, caches = model.decode_fn(params, toks[:, t : t + 1], caches, t)
        want, _ = model.prefill_fn(params, {"tokens": toks[:, : t + 1]})
        _close(logits[:, 0], want)
