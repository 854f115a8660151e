"""The model configuration dataclass, a copy of ``repro.configs.base``.

``ModelConfig`` is the single source of truth a model is built from:
``models.model.build_model(cfg)`` dispatches on ``cfg.family``.  The port
keeps its own copy (it imports nothing of the JAX package); the fields and
the analytic parameter count are the reference's, field for field.  The
input-shape grid (``ShapeConfig``, ``SHAPES``, ``cell_applicable``) lives in
``configs/shapes.py``.

The reference's count leaves out parameters its models hold: for the
``ssm`` family each layer's ``conv_b`` (``d_inner + 2 * ssm_state``) and
``dt_bias`` (``n_ssm_heads``) vectors, for the ``hybrid`` family each RG-LRU
layer's ``conv_b`` (``lru_width``), and for the ``audio`` family every
LayerNorm bias, the MLP biases and two of its three final-norm vectors.  The
copy keeps those formulas as they stand, so that the two counts agree;
:func:`uncounted_params` gives the difference (ROADMAP.md Queue C).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Field semantics:

    - ``family``: dispatch key — dense | moe | ssm | hybrid | vlm | audio.
    - ``n_heads`` / ``n_kv_heads``: GQA query / key-value head counts.
    - ``head_dim``: per-head dim (decoupled from ``d_model // n_heads``).
    - ``d_ff``: MLP hidden (for MoE: the *per-expert* hidden).
    - ``window``: sliding-window size for SWA / local attention; 0 = full.
    - ``layer_pattern``: repeating mixer pattern for hybrids, e.g.
      ``("rglru", "rglru", "attn")`` for recurrentgemma's 2:1.
    - ``encoder_layers`` / ``encoder_seq``: whisper-style encoder stack; the
      audio frontend is a stub, the encoder takes frame embeddings of length
      ``encoder_seq``.
    - ``n_patches``: vlm stub — patch embeddings that replace the first
      ``n_patches`` token embeddings of the sequence.
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # hybrid (recurrentgemma)
    layer_pattern: tuple[str, ...] = ()
    lru_width: int = 0
    # attention variant
    window: int = 0
    rope_theta: float = 10000.0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm
    n_patches: int = 0
    # numerics
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"  # master copy
    source: str = ""  # provenance tag: [hf:... | arXiv:... ; tier]

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family == "hybrid" and not self.layer_pattern:
            raise ValueError("hybrid family needs a layer_pattern")

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_is_subquadratic(self) -> bool:
        """True iff the arch can decode at 500k context without O(S^2)
        attention or an unbounded KV cache: SSM, or every attention layer
        windowed (a hybrid's local attention, mixtral's SWA)."""
        return self.family == "ssm" or self.window > 0

    @property
    def block_pattern(self) -> tuple[str, ...]:
        """The mixer kinds of one repeated block of the stack."""
        if self.family == "ssm":
            return ("ssm",)
        if self.family == "hybrid":
            return tuple(self.layer_pattern)
        return ("attn",)

    def layer_kinds(self) -> tuple[str, ...]:
        """The mixer kind of each of the ``n_layers`` layers: the block
        pattern repeated, then tail layers that repeat the pattern's prefix."""
        pat = self.block_pattern
        return pat * (self.n_layers // len(pat)) + pat[:self.n_layers % len(pat)]

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula: embedding, LM
        head (unless tied), final norm, and per layer

        - dense and vlm: the attention projections (+ QKV bias), the SwiGLU
          MLP and two norms;
        - moe: the same with ``n_experts`` SwiGLU experts and the router
          (``d_model * n_experts``) in place of the MLP;
        - ssm: ``in_proj``, the depthwise conv weight, ``out_proj``, A and
          D per head, the gated norm and the block norm (not ``conv_b`` or
          ``dt_bias``: see :func:`uncounted_params`);
        - hybrid: per layer of :meth:`layer_kinds`, each ``attn`` layer as
          a dense layer and each ``rglru`` layer as its three projections,
          the conv weight, five gate vectors (not ``conv_b``: see
          :func:`uncounted_params`), two norms and the MLP.  The reference
          counts the tail layers as ``rglru`` layers, which they are for
          every pattern that starts with two ``rglru`` layers, as the
          registered one does;
        - audio: each decoder layer as a dense layer with the two-matrix
          GeLU MLP, plus its cross attention and two norms, and each encoder
          layer as a dense layer with that MLP (one norm vector each, no
          biases: see :func:`uncounted_params`)."""
        return self._count(active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token: as :meth:`param_count`, with the
        routed ``top_k`` experts of a MoE layer in place of all of them."""
        return self._count(active_only=True)

    def _count(self, active_only: bool) -> int:
        d = self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * d
        n = self.vocab_size * d + head + d
        if self.family == "ssm":
            di, ds, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            in_proj = d * (2 * di + 2 * ds + nh)
            conv = self.ssm_conv * (di + 2 * ds)
            per_layer = in_proj + conv + di * d + nh * 2 + di + d  # A, D, gnorm, norm
            return n + self.n_layers * per_layer
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        attn += 2 * d  # the block's two norms
        mlp = (2 if self.family == "audio" else 3) * d * self.d_ff
        if self.n_experts:
            mlp = (self.top_k if active_only else self.n_experts) * mlp + d * self.n_experts
        if self.family == "hybrid":
            lw = self.lru_width or d
            # rec-in, gelu-gate and out projections, the conv weight, the
            # gates and Lambda (the reference's 5 * lw), two norms.
            rglru = 3 * d * lw + 4 * lw + 5 * lw + 2 * d
            return n + sum((attn if kind == "attn" else rglru) + mlp
                           for kind in self.layer_kinds())
        total = n + self.n_layers * (attn + mlp)
        if self.is_encdec:  # encoder self-attention + MLP; the decoder's cross attention
            total += self.encoder_layers * (attn + 2 * d * self.d_ff) + self.n_layers * attn
        return total

    def scaled(self, **overrides) -> ModelConfig:
        """A reduced-config variant of the same family (for smoke tests)."""
        return dataclasses.replace(self, **overrides)


def uncounted_params(cfg: ModelConfig) -> int:
    """Parameters a model holds that :meth:`ModelConfig.param_count` (the
    reference's formula) leaves out: per ``ssm`` layer ``conv_b`` and
    ``dt_bias``; per ``rglru`` layer of a ``hybrid`` ``conv_b``.  For
    ``audio`` the formula counts two norm vectors a block and no bias, while
    an encoder layer holds two LayerNorms (four vectors) and the MLP's two
    biases and a decoder layer three LayerNorms (six vectors, four counted
    with its cross attention) and the MLP's biases: ``3 d_model + d_ff``
    beyond the count in a layer of either stack; and the two final
    LayerNorms hold four vectors where one is counted.  Zero for every
    other family."""
    if cfg.family == "ssm":
        return cfg.n_layers * (cfg.d_inner + 2 * cfg.ssm_state + cfg.n_ssm_heads)
    if cfg.family == "hybrid":
        return cfg.layer_kinds().count("rglru") * (cfg.lru_width or cfg.d_model)
    if cfg.family == "audio":
        d = cfg.d_model
        return (cfg.encoder_layers + cfg.n_layers) * (3 * d + cfg.d_ff) + 3 * d
    return 0
