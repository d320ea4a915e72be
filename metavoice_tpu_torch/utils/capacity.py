"""Serving capacity planner: the device memory of a serving configuration.

Port of metavoice_tpu/utils/capacity.py. The two terms that scale with the
engine's slot count are the first stage's weights and its KV cache, both
buffers of fixed shape, so they are planned exactly before any allocation:
``params_abstract`` builds the port's own parameter tree (``init_params``
and the quantize functions) and ``cache_abstract`` the port's own
``KVCache``, both on the ``meta`` device (shapes and dtypes, no memory), and
the plan sums their bytes. Where the port's layouts are the JAX package's,
so are the bytes.

The memory total is the card's (``torch.cuda.get_device_properties``). The
utilization margin covers what the plan leaves out: the second stage, the
vocoder, the speaker encoder, activations and the allocator's slack.
``DEFAULT_UTILIZATION`` is set from ``chip_smoke.py`` phase 49, which fills
every slot of ``slots="auto"`` engines at the largest prompt bucket (int4
weights, bf16 and int8 cache) and reads ``torch.cuda.max_memory_reserved``
against the plan (PERF.md, section 6).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from metavoice_tpu_torch.core.config import TransformerConfig

DEFAULT_UTILIZATION = 0.7
MAX_AUTO_SLOTS = 32  # the JAX package's cap on slots="auto", so that "auto" means the same in both


def _tree_bytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def params_abstract(cfg: TransformerConfig, quantisation_mode: str | None):
    """The first stage's parameter tree for a quantisation mode, on the meta
    device: the runtime's own init and quantize functions, so the plan counts
    the buffers the runtime holds (scale tables, packed words, padded FFN
    dims, the int4 head)."""
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as qz

    quantizers = {None: None, "int4": qz.quantize_params_int4_i32, "int8": qz.quantize_params_int8_i32,
                  "int8_packed": qz.quantize_params_int8_i32, "int8_plain": qz.quantize_params_int8}
    if quantisation_mode not in quantizers:
        raise ValueError(f"unknown quantisation_mode {quantisation_mode!r}")
    p = tfm.init_params(cfg, device="meta", dtype=torch.bfloat16)
    return quantizers[quantisation_mode](p) if quantizers[quantisation_mode] else p


@functools.lru_cache(maxsize=32)
def _weights_bytes(cfg: TransformerConfig, quantisation_mode: str | None) -> int:
    return _tree_bytes(params_abstract(cfg, quantisation_mode))


def cache_abstract(cfg: TransformerConfig, rows: int, block_size: int | None, kv_cache_dtype: str | None):
    """The engine's ``KVCache`` for ``rows`` physical rows (2 or 3 a slot) on
    the meta device."""
    from metavoice_tpu_torch.models import transformer as tfm

    dtype = {None: torch.bfloat16, "bf16": torch.bfloat16}.get(kv_cache_dtype, kv_cache_dtype)
    return tfm.KVCache.create(cfg, rows, block_size, dtype=dtype, device="meta")


def _cache_bytes(kv) -> int:
    return sum(_tree_bytes(getattr(kv, f)) for f in ("k", "v", "k_scale", "v_scale"))


def device_memory_bytes(device="cuda") -> int:
    """The card's memory. There is none to plan from on the CPU: raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no device memory to plan from on {dev}: pass a slot count or a memory size")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass the memory size to plan for")
    return torch.cuda.get_device_properties(dev).total_memory


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """The byte budget of one serving configuration on one card."""

    weights_bytes: int
    cache_bytes: int
    slots: int
    cfg_rows_per_slot: int
    block_size: int
    quantisation_mode: str | None
    kv_cache_dtype: str | None
    hbm_bytes: int
    utilization: float

    @property
    def total_bytes(self) -> int:
        return self.weights_bytes + self.cache_bytes

    @property
    def budget_bytes(self) -> int:
        return int(self.hbm_bytes * self.utilization)

    @property
    def fits(self) -> bool:
        return self.total_bytes <= self.budget_bytes

    @property
    def headroom_bytes(self) -> int:
        return self.budget_bytes - self.total_bytes

    def describe(self) -> str:
        gb = 1024**3
        return "\n".join([
            "scope: FIRST-STAGE weights + KV cache (the two terms that scale with slots; the utilization "
            "margin covers the second stage, the vocoder, activations and the allocator's slack)",
            f"weights ({self.quantisation_mode or 'bf16'}): {self.weights_bytes / gb:.2f} GiB",
            f"kv cache ({self.kv_cache_dtype or 'bf16'}, {self.slots} slots x {self.cfg_rows_per_slot} CFG rows, "
            f"block {self.block_size}): {self.cache_bytes / gb:.2f} GiB",
            f"total {self.total_bytes / gb:.2f} GiB of {self.budget_bytes / gb:.2f} GiB usable "
            f"({self.hbm_bytes / gb:.1f} GiB device memory x {self.utilization:.0%})",
            f"fits: {self.fits} (headroom {self.headroom_bytes / gb:+.2f} GiB)",
        ])


def memory_plan(
    cfg: TransformerConfig,
    *,
    hbm_bytes: int,
    quantisation_mode: str | None = "int4",
    kv_cache_dtype: str | None = None,
    slots: int = 8,
    block_size: int | None = None,
    cfg_rows: int = 2,
    utilization: float = DEFAULT_UTILIZATION,
) -> MemoryPlan:
    """The exact weights + cache bytes of a serving configuration against
    ``hbm_bytes`` (``device_memory_bytes()`` for the card). ``slots`` is the
    engine's concurrent requests, each of ``cfg_rows`` cache rows (2 for
    CFG, 3 with prompt guidance)."""
    bs = block_size or cfg.block_size
    return MemoryPlan(
        weights_bytes=_weights_bytes(cfg, quantisation_mode),
        cache_bytes=_cache_bytes(cache_abstract(cfg, cfg_rows * slots, bs, kv_cache_dtype)),
        slots=slots, cfg_rows_per_slot=cfg_rows, block_size=bs, quantisation_mode=quantisation_mode,
        kv_cache_dtype=kv_cache_dtype, hbm_bytes=hbm_bytes, utilization=utilization,
    )


def max_slots(
    cfg: TransformerConfig,
    *,
    hbm_bytes: int,
    quantisation_mode: str | None = "int4",
    kv_cache_dtype: str | None = None,
    block_size: int | None = None,
    cfg_rows: int = 2,
    utilization: float = DEFAULT_UTILIZATION,
    limit: int = 256,
) -> int:
    """The largest slot count whose plan fits (0 if one slot does not), at
    most ``limit``: a guess from the one-slot plan (the cache is linear in
    slots but for the scale tables' 128-column padding), then checked
    exactly, as in the JAX package."""
    kw = dict(hbm_bytes=hbm_bytes, quantisation_mode=quantisation_mode, kv_cache_dtype=kv_cache_dtype,
              block_size=block_size, cfg_rows=cfg_rows, utilization=utilization)
    one = memory_plan(cfg, slots=1, **kw)
    if not one.fits:
        return 0

    def fits(n: int) -> bool:
        return memory_plan(cfg, slots=n, **kw).fits

    guess = max(1, min(limit, 1 + one.headroom_bytes // max(one.cache_bytes, 1)))
    while guess > 1 and not fits(guess):
        guess -= 1
    while guess < limit and fits(guess + 1):
        guess += 1
    return guess
