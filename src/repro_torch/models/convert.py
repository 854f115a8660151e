"""Parameters (and optimizer state) of the JAX package's decoder, as the
port lays them out.

``params_from_jax(tree, cfg)`` takes the tree that
``repro.models.build_model(cfg).init`` returns for any config of the
registry, with its leaves as numpy arrays (``jax.tree.map(numpy.asarray,
params)``), and returns the port's parameter dict.  Two layouts differ:

- The JAX tree stacks the blocks on a leading ``n_blocks`` axis under
  ``["stack"]["blocks"]["sub{j}"]``, one ``sub`` per kind of the pattern;
  the port keeps a list of per-block dicts (``["stack"]["blocks"][i]
  ["sub{j}"]``).  A hybrid's tail layers (``["stack"]["tail"]["sub{j}"]``)
  are not stacked in either.  The encoder-decoder's ``enc_blocks`` and
  ``dec_blocks`` are stacked in the JAX tree and lists in the port's.
- JAX linear weights are ``[in, out]`` and used as ``x @ w``; the port's are
  ``[out, in]`` for ``F.linear``, so every projection is transposed:
  ``wq``/``wk``/``wv``/``wo`` (of ``attn``, ``self_attn`` and
  ``cross_attn`` alike), the MLP's ``gate``/``up``/``down``, the GeLU MLP's
  ``w1``/``w2``, the SSD block's ``in_proj`` and ``out_proj``, and the
  RG-LRU block's ``w_rec``, ``w_gelu`` and ``w_out``.  A MoE layer's weights
  are transposed in their last two axes, behind the expert axis: ``router``
  ``[d, E]`` becomes ``[E, d]``, ``gate``/``up`` ``[E, d, f]`` become
  ``[E, f, d]`` and ``down`` ``[E, f, d]`` becomes ``[E, d, f]``.  On a
  square weight (``wq``/``wo`` when ``n_heads * head_dim == d_model``, the
  RG-LRU projections when ``lru_width == d_model``) a missed transpose
  raises no shape error; only the parity tests catch it.

Everything else carries over as it is: norm scales, LayerNorm ``w`` and
``b``, biases, the ``[vocab,
d]`` embedding and LM-head tables, the conv weights ``conv_w`` (``[K, C]``
in both packages: ``models/ssm.py`` says why), and the SSD block's and the
RG-LRU block's vectors (``conv_b``, ``a_log``, ``d_skip``, ``dt_bias``,
``gnorm``; ``wgx``, ``bgx``, ``wga``, ``bga``, ``a_param``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import block_counts

_LINEAR = {"attn": ("wq", "wk", "wv", "wo"), "ssm": ("in_proj", "out_proj"),
           "rglru": ("w_rec", "w_gelu", "w_out")}
_MLP_LINEAR = ("gate", "up", "down", "router", "w1", "w2")


def params_from_jax(tree, cfg, *, device: str | torch.device = "cuda"):
    """The port's parameters for ``cfg`` from a JAX parameter tree of numpy
    arrays, on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)

    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # numpy has no bf16 of its own: through float32, exact
            return torch.tensor(a.astype(np.float32), device=dev).to(torch.bfloat16)
        return torch.tensor(a, device=dev)

    def group(arrays, take, linear):
        return {name: t(np.swapaxes(take(a), -1, -2)) if name in linear else t(take(a))
                for name, a in arrays.items()}

    if cfg.family == "audio":
        return _encdec_from_jax(tree, cfg, t, group)
    pat = cfg.block_pattern
    n_blocks, tail = block_counts(cfg)
    want = {"blocks"} | ({"tail"} if tail else set())
    if set(tree["stack"]) != want \
            or set(tree["stack"]["blocks"]) != {f"sub{j}" for j in range(len(pat))}:
        raise ValueError(f"not a {cfg.family!r} stack of pattern {pat} and tail {tail}: "
                         f"{sorted(tree['stack'])}")

    def sublayer(sp, kind, take):
        sub = {"norm": t(take(sp["norm"])), "mix": group(sp["mix"], take, _LINEAR[kind])}
        if "mlp" in sp:
            sub["mlp_norm"] = t(take(sp["mlp_norm"]))
            sub["mlp"] = group(sp["mlp"], take, _MLP_LINEAR)
        return sub

    def block(subs, kinds, take):
        return {f"sub{j}": sublayer(subs[f"sub{j}"], kind, take) for j, kind in enumerate(kinds)}

    stack = {"blocks": [block(tree["stack"]["blocks"], pat, lambda a, i=i: a[i])
                        for i in range(n_blocks)]}
    if tail:
        stack["tail"] = block(tree["stack"]["tail"], tail, lambda a: a)
    params = {
        "embed": t(tree["embed"]),
        "stack": stack,
        "final_norm": t(tree["final_norm"]),
    }
    if "lm_head" in tree:
        params["lm_head"] = t(tree["lm_head"])
    return params


def _encdec_from_jax(tree, cfg, t, group):
    """The encoder-decoder's tree: each stack unstacked into a list of
    blocks, their projections transposed."""
    want = {"embed", "enc_blocks", "enc_final", "dec_blocks", "dec_final"}
    if set(tree) != want:
        raise ValueError(f"not an encoder-decoder tree: {sorted(tree)}")
    linear = _LINEAR["attn"] + _MLP_LINEAR

    def blocks(stacked, n):
        return [{name: group(sub, lambda a, i=i: a[i], linear) for name, sub in stacked.items()}
                for i in range(n)]

    return {
        "embed": t(tree["embed"]),
        "enc_blocks": blocks(tree["enc_blocks"], cfg.encoder_layers),
        "enc_final": {k: t(v) for k, v in tree["enc_final"].items()},
        "dec_blocks": blocks(tree["dec_blocks"], cfg.n_layers),
        "dec_final": {k: t(v) for k, v in tree["dec_final"].items()},
    }


def opt_state_from_jax(state, cfg, *, device: str | torch.device = "cuda"):
    """The port's optimizer state from ``repro.train.optimizer``'s (leaves
    as numpy arrays), on ``device``: the moments ``m`` and ``v`` and, where
    it was kept, the float32 ``master`` are parameter-shaped trees and map
    as :func:`params_from_jax` maps parameters (linear ones transposed);
    ``step`` becomes a 0-d int32 tensor."""
    dev = resolve_device(device)
    out = {name: params_from_jax(state[name], cfg, device=dev)
           for name in ("m", "v", "master") if name in state}
    out["step"] = torch.tensor(np.asarray(state["step"]), dtype=torch.int32, device=dev)
    return out
