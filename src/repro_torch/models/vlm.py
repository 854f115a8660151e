"""InternVL-style VLM support: the vision tower is a stub, as in the
reference.  Port of ``repro.models.vlm``.

The LM backbone takes precomputed patch embeddings ``[B, n_patches,
d_model]`` (what InternViT and the MLP projector would emit); they replace
the first ``n_patches`` token embeddings of the sequence (the sequence keeps
its length), and the LM loss is masked over those positions.  Everything
downstream is the shared decoder stack.  Decode takes no patches.
"""

from __future__ import annotations

import torch


def splice_patches(token_embeds: torch.Tensor, patch_embeds: torch.Tensor) -> torch.Tensor:
    """Replace the first P positions of the embedded sequence ``[B, S, D]``
    with the patch embeddings ``[B, P, D]`` (cast to the sequence's dtype)."""
    p = patch_embeds.shape[1]
    return torch.cat([patch_embeds.to(token_embeds.dtype), token_embeds[:, p:]], dim=1)


def vlm_loss_mask(cfg, batch_tokens: torch.Tensor) -> torch.Tensor:
    """``[1, S]`` float32: 0 at the patch positions, 1 after them.  One row,
    as the reference's, so ``cross_entropy`` divides the batch's summed loss
    by ``S - n_patches``, not by ``B (S - n_patches)`` (ROADMAP.md Queue C)."""
    s = batch_tokens.shape[1]
    pos = torch.arange(s, device=batch_tokens.device)[None, :]
    return (pos >= cfg.n_patches).float()


def patch_embed_spec(cfg, batch: int, dtype) -> torch.Tensor:
    """The patch embeddings' stand-in: ``[B, n_patches, d_model]`` on the
    meta device (a shape and a dtype, no storage)."""
    return torch.empty((batch, cfg.n_patches, cfg.d_model), dtype=dtype, device="meta")
