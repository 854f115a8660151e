"""Parameters of the JAX package's decoder, as the port lays them out.

``params_from_jax(tree, cfg)`` takes the tree that
``repro.models.build_model(cfg).init`` returns for a dense or ssm config,
with its leaves as numpy arrays (``jax.tree.map(numpy.asarray, params)``),
and returns the port's parameter dict.  Two layouts differ:

- The JAX tree stacks the blocks on a leading ``n_blocks`` axis under
  ``["stack"]["blocks"]["sub0"]``; the port keeps a list of per-block dicts
  (``["stack"]["blocks"][i]["sub0"]``).
- JAX linear weights are ``[in, out]`` and used as ``x @ w``; the port's are
  ``[out, in]`` for ``F.linear``, so every projection is transposed:
  ``wq``/``wk``/``wv``/``wo`` and the MLP's ``gate``/``up``/``down``, and the
  SSD block's ``in_proj`` and ``out_proj``.  On a square weight (``wq``/``wo``
  when ``n_heads * head_dim == d_model``) a missed transpose raises no shape
  error; only the parity tests catch it.

Everything else carries over as it is: norm scales, biases, the ``[vocab,
d]`` embedding and LM-head tables, and the SSD block's ``conv_w`` (``[K, C]``
in both packages: ``models/ssm.py`` says why), ``conv_b``, ``a_log``,
``d_skip``, ``dt_bias`` and ``gnorm``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

_LINEAR = {"attn": ("wq", "wk", "wv", "wo"), "ssm": ("in_proj", "out_proj")}
_MLP_LINEAR = ("gate", "up", "down")


def params_from_jax(tree, cfg, *, device: str | torch.device = "cuda"):
    """The port's parameters for ``cfg`` from a JAX parameter tree of numpy
    arrays, on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(a, device=dev)

    def group(arrays, i, linear):
        return {name: t(np.swapaxes(a[i], -1, -2)) if name in linear else t(a[i])
                for name, a in arrays.items()}

    kind = "ssm" if cfg.family == "ssm" else "attn"
    if cfg.family not in ("dense", "ssm") or set(tree["stack"]) != {"blocks"} \
            or set(tree["stack"]["blocks"]) != {"sub0"}:
        raise ValueError(f"not a dense ('attn',) or ssm ('ssm',) stack: {cfg.family!r}, "
                         f"{sorted(tree['stack'])}")
    stacked = tree["stack"]["blocks"]["sub0"]
    blocks = []
    for i in range(cfg.n_layers):
        sub = {"norm": t(stacked["norm"][i]), "mix": group(stacked["mix"], i, _LINEAR[kind])}
        if "mlp" in stacked:
            sub["mlp_norm"] = t(stacked["mlp_norm"][i])
            sub["mlp"] = group(stacked["mlp"], i, _MLP_LINEAR)
        blocks.append({"sub0": sub})
    params = {
        "embed": t(tree["embed"]),
        "stack": {"blocks": blocks},
        "final_norm": t(tree["final_norm"]),
    }
    if "lm_head" in tree:
        params["lm_head"] = t(tree["lm_head"])
    return params
