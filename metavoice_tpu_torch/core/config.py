"""Model and runtime configuration dataclasses (port of
metavoice_tpu/core/config.py; its ``MeshConfig``, which nothing there
reads, has no counterpart: a rank's place in the (data, tensor) grid is
``parallel/mesh.make_mesh``'s ``Mesh``).

One ``TransformerConfig`` covers both stages (the reference splits this
across fam/llm/fast_model.py:52-94 ``ModelArgs`` and fam/llm/model.py:26-46
``GPTConfig``); causal vs non-causal and single-vocab vs multi-hierarchy are
config fields, not separate model classes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from math import gcd

from metavoice_tpu_torch.core import tokens as T


def find_multiple(n: int, *args: int) -> int:
    """Round ``n`` up to the least common multiple of ``args``.

    Same rule the reference uses to size the SwiGLU hidden dim
    (fam/llm/fast_model.py:45-49,66-73).
    """
    k = reduce(lambda x, y: x * y // gcd(x, y), args + (1,))
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclass(frozen=True)
class TransformerConfig:
    """Architecture of one transformer stage.

    Defaults are the metavoice-1B first stage: 24L/16H/2048d, vocab 2562,
    block 2048, RMSNorm + SwiGLU, learned absolute position embeddings,
    256-d speaker conditioning (fam/llm/fast_model.py:87-94).
    """

    block_size: int = 2048
    n_layer: int = 24
    n_head: int = 16
    dim: int = 2048
    speaker_emb_dim: int = 256
    intermediate_size: int | None = None
    n_local_heads: int = -1  # GQA KV heads; -1 => MHA
    norm_eps: float = 1e-5
    causal: bool = True
    # Single flat vocab (first stage) or per-hierarchy vocabs (second stage).
    vocab_sizes: tuple[int, ...] = (T.FIRST_STAGE_VOCAB_SIZE,)
    # Output vocabs; None => same as vocab_sizes with weight tying
    # (reference fam/llm/model.py:139-143).
    target_vocab_sizes: tuple[int, ...] | None = None
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    nonlinearity_type: str = "swiglu"  # "swiglu" | "gelu"
    bias: bool = False
    dropout: float = 0.0
    spkemb_dropout: float = 0.0
    spk_emb_on_text: bool = True
    # Explicit head_dim for tensor-parallel LOCAL views of the model, where
    # n_head is the per-device head count but dim stays the full residual
    # width (parallel/tp_decode.local_view). None => dim // n_head.
    head_dim_override: int | None = None

    def __post_init__(self):
        if self.n_local_heads == -1:
            object.__setattr__(self, "n_local_heads", self.n_head)
        if self.intermediate_size is None:
            hidden = int(2 * (4 * self.dim) / 3)
            object.__setattr__(self, "intermediate_size", find_multiple(hidden, 256))

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.n_head

    @property
    def vocab_size(self) -> int:
        """Flat vocab size (first hierarchy) — first-stage convenience."""
        return self.vocab_sizes[0]

    @property
    def num_hierarchies(self) -> int:
        return len(self.vocab_sizes)

    @property
    def output_vocab_sizes(self) -> tuple[int, ...]:
        return self.target_vocab_sizes if self.target_vocab_sizes is not None else self.vocab_sizes


def first_stage_config(**overrides) -> TransformerConfig:
    """metavoice-1B first stage (fam/llm/fast_model.py:87-94)."""
    base = dict(
        block_size=2048,
        n_layer=24,
        n_head=16,
        dim=2048,
        vocab_sizes=(T.FIRST_STAGE_VOCAB_SIZE,),
        causal=True,
        norm_type="rmsnorm",
        nonlinearity_type="swiglu",
        bias=False,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def second_stage_config(**overrides) -> TransformerConfig:
    """The ~10M non-causal hierarchy-completion transformer.

    The reference takes its exact shape from checkpoint-embedded model_args
    (fam/llm/inference.py:124-131); these defaults reproduce a ~10M-param
    model (README.md:164) mapping 2 input hierarchies to the remaining 6
    EnCodec codebooks. Input vocab per hierarchy covers text-offset ids
    (row 0 carries text, fam/llm/inference.py:283-287); outputs are the
    1025-way per-codebook distributions (1024 codes + pad).
    """
    base = dict(
        block_size=1024,
        n_layer=4,
        n_head=8,
        dim=512,
        vocab_sizes=(T.FIRST_STAGE_VOCAB_SIZE, T.CODEBOOK_SIZE + 1),
        target_vocab_sizes=tuple([T.CODEBOOK_SIZE + 1] * 6),
        causal=False,
        norm_type="layernorm",
        nonlinearity_type="gelu",
        bias=True,
    )
    base.update(overrides)
    return TransformerConfig(**base)


@dataclass(frozen=True)
class SamplingConfig:
    """First-stage sampling defaults (fam/llm/fast_inference.py:111)."""

    temperature: float = 1.0
    top_p: float | None = 0.95
    top_k: int | None = None
    guidance_scale: float = 3.0
    max_new_tokens: int | None = None
    end_of_audio_token: int = T.END_OF_AUDIO_TOKEN
    seed: int = 1337


@dataclass(frozen=True)
class SecondStageSamplingConfig:
    """Second-stage sampling defaults (fam/llm/fast_inference.py:146-156)."""

    temperature: float = 1.0
    top_k: int = 200


@dataclass(frozen=True)
class RuntimeConfig:
    """End-to-end runtime knobs for the TTS engine."""

    dtype: str = "bfloat16"  # compute dtype for transformer stages
    # None | "int4" | "int8" (= packed int8-in-int32, the fast int8 path;
    # "int8_packed" is an alias) | "int8_plain" (plain arrays, 1-byte DMA)
    quantisation_mode: str | None = None
    # None (bf16, the speed default) | "int8" (half cache memory — capacity
    # lever for large serving batches; ~20% slower decode on v5e)
    kv_cache_dtype: str | None = None
    max_batch_size: int = 1  # utterances decoded concurrently (x2 CFG rows)
    prompt_pad_multiple: int = 128  # bucket prompts to static shapes
    output_dir: str = "outputs"
    seed: int = 1337


DEFAULT_SAMPLING = SamplingConfig()
DEFAULT_SECOND_STAGE_SAMPLING = SecondStageSamplingConfig()
