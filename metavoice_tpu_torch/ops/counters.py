"""The hand-written kernels' launch counters, one table.

Each wrapper adds one to its counter where it launches its kernel (a CPU
tensor takes the plain version and counts nothing). A decode step replayed
from a CUDA graph launches no wrapper: ``models/first_stage`` credits each
replay with the launches of the step it captured.
"""

from __future__ import annotations

from metavoice_tpu_torch.ops.attention import (
    decode_attention,
    decode_attention_block_int4,
    decode_attention_block_int8,
    decode_attention_multi,
)
from metavoice_tpu_torch.ops.decode_stack import decode_stack_int4
from metavoice_tpu_torch.ops.quantized import (
    decode_ffn_int4,
    ffn_int8,
    matmul_int4,
    matmul_int4_i32,
    matmul_int4_packed,
    matmul_int8,
    matmul_int8_i32,
)

# TTS.stats key -> (the kernel's wrapper, its attribute that counts launches)
KERNEL_COUNTERS = {
    "k1_launches": (decode_attention, "launches"),
    "k2_launches": (matmul_int4_i32, "launches"),
    "k3_launches": (decode_stack_int4, "launches"),
    "k4_launches": (decode_attention_multi, "launches"),
    "k5_launches": (decode_attention_block_int4, "launches"),
    "k6_launches": (decode_ffn_int4, "launches"),
    "k7_launches": (decode_stack_int4, "launches_i8"),
    "k8_launches": (matmul_int8_i32, "launches"),
    "k9_launches": (decode_attention_block_int8, "launches"),
    "k10_launches": (ffn_int8, "launches"),
    "k11_launches": (matmul_int8, "launches"),
    "k12_launches": (matmul_int4, "launches"),
    "k13_launches": (matmul_int4_packed, "launches"),
}


# counters no TTS.stats key reads, which a replay credits all the same: K11's
# launches on its GEMV route (a share of k11_launches)
SUB_COUNTERS = ((matmul_int8, "gemv_launches"),)


def launch_counts() -> dict[str, int]:
    """Every counter's value now, by TTS.stats key."""
    return {k: getattr(fn, attr) for k, (fn, attr) in KERNEL_COUNTERS.items()}
