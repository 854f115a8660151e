"""The port's recurrentgemma (``hybrid`` family) against the JAX package, at
the smoke size.

The smoke-size ``recurrentgemma-9b`` (3 layers: one (rglru, rglru, attn)
block; width 64, LRU width 64, 4 query / 1 KV head of dim 16, window 16,
MLP 128, vocab 256, tied embeddings) is built in both packages on the same
parameters: the JAX model's ``init`` draws them, ``convert.params_from_jax``
carries them over.  At 5 layers the stack gains two unstacked tail layers,
as the full config's 38 = 12 x 3 + 2 does.  The JAX model runs with
``mixer_impl="chunked"`` and with ``"interpret"`` (its Pallas RG-LRU kernel
executed in Python); the port runs on the CPU, where the RG-LRU takes its
log-depth scan, attention its plain version, and decode the recurrence.
Tokens come from a numpy seed.

Tolerance: ``TOL`` = 2e-4 absolute and relative on logits and caches, the
bar of ``tests/test_models.py``'s prefill/decode check.  Both sides compute
in float32 and differ only in summation order and in the ulps of
``exp``/``tanh``/``rsqrt`` between XLA-CPU and PyTorch; a missed transpose,
the erf form of GeLU, a conv cache taken after the conv or a window ring
folded wrong moves the logits by more.

Also here: the config and parameter counts against the JAX package's, with
the ``conv_b`` the JAX count leaves out, and the RG-LRU block alone.
"""

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
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.transformer import block_counts as jax_block_counts  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import uncounted_params  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.transformer import block_counts  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "recurrentgemma-9b"
B, S, GEN = 2, 20, 8  # prompt S (past the smoke window of 16); decode GEN steps past it
K = trglru.RG_CONV


@functools.lru_cache(maxsize=None)
def _models(mixer_impl, n_layers=3):
    cfg_j = jconfigs.smoke_config(ARCH).scaled(n_layers=n_layers)
    jm = jax_build_model(cfg_j, JaxOptions(activation_dtype="float32", remat="none",
                                           mixer_impl=mixer_impl))
    params_j = jm.init(jax.random.PRNGKey(0))
    cfg_t = tconfigs.smoke_config(ARCH).scaled(n_layers=n_layers)
    tm = build_model(cfg_t, ModelOptions(activation_dtype="float32"), device="cpu")
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
    return jm, params_j, tm, params_t


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), **TOL)


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=torch.is_tensor)


def _close_caches(ct, cj, tail):
    """The port's per-block caches against the JAX stacked ones (and the
    unstacked tail)."""
    for i, block in enumerate(ct["blocks"]):
        for sub, c in block.items():
            for name, t in c.items():
                _close(t, cj["blocks"][sub][name][i])
    assert ("tail" in ct) == bool(tail) == ("tail" in cj)
    for sub, c in ct.get("tail", {}).items():
        for name, t in c.items():
            _close(t, cj["tail"][sub][name])


# ------------------------------------------------------------------ configs
def test_recurrentgemma_config_and_counts_match_the_jax_package():
    """The published widths; ``param_count`` is the JAX formula as it
    stands, which leaves out each RG-LRU layer's ``conv_b`` (ROADMAP.md
    Queue C): the models of both packages hold that many more."""
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.layer_pattern, cfg.lru_width, cfg.window,
            cfg.tie_embeddings) == (38, 4096, 16, 1, 256, 12288, 256000,
                                    ("rglru", "rglru", "attn"), 4096, 2048, True)
    assert cfg.source == jconfigs.get_config(ARCH).source
    assert cfg.param_count() == jconfigs.get_config(ARCH).param_count() == 8_524_099_584
    assert uncounted_params(cfg) == 26 * 4096
    assert cfg.param_count() + uncounted_params(cfg) == 8_524_206_080
    full = jax.eval_shape(jax_build_model(jconfigs.get_config(ARCH)).init,
                          jax.random.PRNGKey(0))
    assert sum(a.size for a in jax.tree.leaves(full)) == 8_524_206_080
    for n_layers, counted, held in ((3, 126_528, 126_656), (5, 201_664, 201_920)):
        small = tconfigs.smoke_config(ARCH).scaled(n_layers=n_layers)
        assert small.param_count() == jconfigs.smoke_config(ARCH).scaled(
            n_layers=n_layers).param_count() == counted
        assert small.param_count() + uncounted_params(small) == held
        _, params_j, tm, _ = _models("chunked", n_layers)
        assert sum(a.size for a in jax.tree.leaves(params_j)) == held
        params = tm.init(torch.Generator().manual_seed(0))
        assert sum(t.numel() for t in _leaves(params)) == held
        assert ("tail" in params["stack"]) == (n_layers == 5)


@pytest.mark.parametrize("arch,n_layers", [(ARCH, 38), (ARCH, 3), (ARCH, 4), (ARCH, 5),
                                           ("mamba2-130m", 24), ("phi4-mini-3.8b", 32)])
def test_layer_kinds_match_the_jax_block_split(arch, n_layers):
    """``layer_kinds`` (the one place the port splits ``n_layers`` into
    pattern repeats and a tail) gives the JAX package's ``block_counts``."""
    cfg = tconfigs.get_config(arch).scaled(n_layers=n_layers)
    n_blocks, tail = jax_block_counts(jconfigs.get_config(arch).scaled(n_layers=n_layers))
    assert block_counts(cfg) == (n_blocks, tuple(tail))
    assert cfg.layer_kinds() == cfg.block_pattern * n_blocks + tuple(tail)
    assert len(cfg.layer_kinds()) == n_layers


def test_init_draws_the_jax_distributions():
    """a_param in U[-2, 1], gate weights ones and biases zeros, conv_b zero,
    conv_w U(-1, 1) * sqrt(3 / K) (fan-in K of the [K, lw] layout), the
    projections U(-1, 1) * sqrt(3 / fan_in) laid out [out, in]."""
    cfg = tconfigs.get_config(ARCH).scaled(d_model=256, lru_width=512)
    p = trglru.rg_init(torch.Generator().manual_seed(0), cfg)
    pj = jrglru.rg_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    assert set(p) == set(pj)
    for name in ("wgx", "bgx", "wga", "bga", "conv_b"):
        _close(p[name], pj[name])
    for name, fan_in in (("w_rec", 256), ("w_gelu", 256), ("w_out", 512), ("conv_w", K)):
        assert p[name].shape == (pj[name].shape if name == "conv_w" else pj[name].shape[::-1])
        bound = (3.0 / fan_in) ** 0.5
        assert p[name].abs().max().item() <= bound
        assert abs(p[name].std().item() - bound / 3 ** 0.5) < 0.05 * bound
    a = p["a_param"]
    assert a.min().item() >= -2.0 and a.max().item() <= 1.0
    assert abs(a.mean().item() + 0.5) < 0.15 and abs(a.std().item() - 3 / 12 ** 0.5) < 0.1


def test_gelu_is_the_tanh_form_of_the_jax_package():
    """``jax.nn.gelu`` defaults to the tanh approximation; the erf form
    differs from it by more than the logits' tolerance."""
    x = np.linspace(-3, 3, 601, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 2e-4


# --------------------------------------------------------------- the block
def _block_params(cfg, seed=0):
    """One RG-LRU block's parameters in both layouts, ``conv_b`` and the gate
    vectors drawn off their init values (zeros and ones) so that each of
    them counts."""
    p = jrglru.rg_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    p = {n: np.array(a) for n, a in p.items()}
    for name in ("conv_b", "wgx", "bgx", "wga", "bga"):
        p[name] = p[name] + 0.3 * rng.standard_normal(p[name].shape).astype(np.float32)
    pt = {n: torch.from_numpy(a.T.copy() if n in ("w_rec", "w_gelu", "w_out") else a)
          for n, a in p.items()}
    return {n: jnp.asarray(a) for n, a in p.items()}, pt


@pytest.mark.parametrize("impl", ["chunked", "interpret"])
@pytest.mark.parametrize("prompt", [12, 2])  # 2 < K - 1: the conv cache is left-padded
def test_rg_apply_prefill_decode_and_caches_match_the_jax_block(impl, prompt):
    cfg = tconfigs.smoke_config(ARCH).scaled(lru_width=48)  # lw != d: a transpose shows
    pj, pt = _block_params(cfg)
    x = np.random.default_rng(1).standard_normal((B, prompt + 4, cfg.d_model)).astype(np.float32)
    yj, cj = jrglru.rg_apply(pj, jnp.asarray(x[:, :prompt]), cfg=cfg, impl=impl,
                             return_cache=True)
    yt, ct = trglru.rg_apply(pt, torch.from_numpy(x[:, :prompt]), cfg=cfg)
    _close(yt, yj)
    assert ct["conv"].shape == (B, K - 1, 48) and ct["h"].shape == (B, 48)
    assert ct["h"].dtype == torch.float32
    for name in ("conv", "h"):
        _close(ct[name], cj[name])
    for t in range(prompt, prompt + 4):
        yj, cj = jrglru.rg_apply(pj, jnp.asarray(x[:, t:t + 1]), cfg=cfg, cache=cj,
                                 return_cache=True)
        yt, ct = trglru.rg_apply(pt, torch.from_numpy(x[:, t:t + 1]), cfg=cfg, cache=ct)
        _close(yt, yj)
        for name in ("conv", "h"):
            _close(ct[name], cj[name])
    with pytest.raises(NotImplementedError):
        trglru.rg_apply(pt, torch.from_numpy(x[:, :2]), cfg=cfg, cache=ct)


# ------------------------------------------------------------- whole model
@pytest.mark.parametrize("n_layers", [3, 5])
@pytest.mark.parametrize("mixer_impl", ["chunked", "interpret"])
@pytest.mark.parametrize("prompt", [S, 2])  # 2 < K - 1: the conv caches are left-padded
def test_prefill_logits_and_caches_match_the_jax_model(n_layers, mixer_impl, prompt):
    jm, params_j, tm, params_t = _models(mixer_impl, n_layers)
    cfg = tm.cfg
    toks = _tokens(cfg, B, prompt)
    lj, cj = jm.prefill_fn(params_j, {"tokens": jnp.asarray(toks)}, max_len=prompt + GEN)
    lt, ct = tm.prefill_fn(params_t, {"tokens": torch.from_numpy(toks)}, max_len=prompt + GEN)
    assert lt.shape == (B, cfg.vocab_size)
    _close(lt, lj)
    block = ct["blocks"][0]
    assert block["sub0"]["conv"].shape == (B, K - 1, cfg.lru_width)
    assert block["sub2"]["k"].shape == (B, 1, min(prompt + GEN, cfg.window), cfg.head_dim)
    _close_caches(ct, cj, tail=n_layers == 5)


@pytest.mark.parametrize("n_layers", [3, 5])
@pytest.mark.parametrize("mixer_impl", ["chunked", "interpret"])
@pytest.mark.parametrize("p0", [S - 3, 5])  # 5: decode crosses the window of 16
def test_teacher_forced_decode_past_the_window_matches_the_jax_model(n_layers, mixer_impl, p0):
    """Prefill ``p0`` tokens, then decode the following given tokens to
    S + GEN = 28, past the window of 16: the logits of every step and the
    caches at the end agree."""
    jm, params_j, tm, params_t = _models(mixer_impl, n_layers)
    toks = _tokens(tm.cfg, B, S + GEN, seed=2)
    lj, cj = jm.prefill_fn(params_j, {"tokens": jnp.asarray(toks[:, :p0])}, max_len=S + GEN)
    lt, ct = tm.prefill_fn(params_t, {"tokens": torch.from_numpy(toks[:, :p0])},
                           max_len=S + GEN)
    _close(lt, lj)
    decode_j = jax.jit(jm.decode_fn)
    for t in range(p0, S + GEN):
        lj, cj = decode_j(params_j, jnp.asarray(toks[:, t : t + 1]), cj, jnp.int32(t))
        lt, ct = tm.decode_fn(params_t, torch.from_numpy(toks[:, t : t + 1]), ct, t)
        assert lt.shape == (B, 1, tm.cfg.vocab_size)
        _close(lt, lj)
    _close_caches(ct, cj, tail=n_layers == 5)


@pytest.mark.parametrize("n_layers", [3, 5])
def test_generate_gives_the_jax_models_greedy_ids(n_layers):
    jm, params_j, tm, params_t = _models("chunked", n_layers)
    toks = _tokens(tm.cfg, B, S, seed=3)
    want = jax_generate(jm, params_j, {"tokens": jnp.asarray(toks)}, gen_len=6)
    got = tserve.generate(tm, params_t, {"tokens": torch.from_numpy(toks)}, gen_len=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_continues_the_prefill():
    """On the port alone: a prefill of t + 1 tokens and a prefill of t
    tokens plus one decode step give the same logits (the recurrence
    continues the log-depth scan's state and the pre-conv cache; the ring
    holds the window)."""
    _, _, tm, params_t = _models("chunked", 5)
    toks = torch.from_numpy(_tokens(tm.cfg, B, 24, seed=4))
    for t in (1, 2, 3, 15, 16, 23):
        _, caches = tm.prefill_fn(params_t, {"tokens": toks[:, :t]}, max_len=t + 1)
        got, _ = tm.decode_fn(params_t, toks[:, t : t + 1], caches, t)
        want, _ = tm.prefill_fn(params_t, {"tokens": toks[:, : t + 1]})
        _close(got[:, 0], want)


@pytest.mark.parametrize("batch", [1, 2])
def test_prefill_caches_hold_only_their_own_memory(batch):
    """Every cache tensor's storage is its own size: a view of a layer's
    [B, S, lw] output or input would keep the whole of it alive for the
    conversation (26 x 268 MB at the full model's prefill)."""
    _, _, tm, params_t = _models("chunked", 5)
    toks = torch.from_numpy(_tokens(tm.cfg, batch, S, seed=5))
    _, caches = tm.prefill_fn(params_t, {"tokens": toks}, max_len=S + GEN)
    tensors = _leaves(caches)
    assert len(tensors) == 2 * 5
    for t in tensors:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_params_from_jax_refuses_a_tree_of_another_pattern():
    _, params_j, _, _ = _models("chunked", 5)
    tree = jax.tree.map(np.asarray, params_j)
    with pytest.raises(ValueError, match="stack of pattern"):
        params_from_jax(tree, tconfigs.smoke_config(ARCH), device="cpu")


def test_serve_main_runs_recurrentgemma_on_the_cpu(capsys):
    ids = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "20", "--gen-len", "3"])
    assert ids.shape == (2, 3)
    assert "recurrentgemma-9b on cpu: generated (2, 3)" in capsys.readouterr().out
