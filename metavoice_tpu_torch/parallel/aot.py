"""Full-scale sharded layouts without weights (port of
metavoice_tpu/parallel/aot.py, its serving half).

The JAX package builds the real metavoice-1B first stage (24L/16H/2048d)
as abstract arrays carrying shardings and compiles its sharded decode and
train steps ahead of time, so a virtual CPU mesh can show the full-scale
programs build. Eager PyTorch has no ahead-of-time compile. What stays is
:func:`abstract_params`: each rank's shard tree at full scale on the
``meta`` device (shapes and dtypes, no memory), through the same layout
rules as the serving path (``tp_decode.prepare_tp_params``). The evidence
that the full-scale sharded decode step builds and runs, the role of
``compile_sharded_decode_step``, is ``chip_smoke.py`` phase 57, which runs
it: ``TTS(tensor_parallel=2)`` at full width on two ranks.
``compile_sharded_train_step`` waits for the sharded training slice.
"""

from __future__ import annotations

import torch

from metavoice_tpu_torch.core.config import TransformerConfig, first_stage_config
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.parallel import tp_decode as tpd
from metavoice_tpu_torch.parallel.mesh import Mesh


def abstract_params(cfg: TransformerConfig | None = None, tp: int = 1, quantisation_mode: str | None = None,
                    dtype=torch.bfloat16) -> list[dict]:
    """Every tensor rank's param tree of ``cfg`` (default the full-scale
    first stage) split ``tp`` ways, on the ``meta`` device -> one tree a
    rank, in rank order."""
    cfg = cfg or first_stage_config()
    params = tfm.init_params(cfg, device="meta", dtype=dtype)
    meta = torch.device("meta")
    return [tpd.prepare_tp_params(params, cfg, Mesh(tp, 1, r, 0, tuple(range(tp)), None, None, meta),
                                  quantisation_mode) for r in range(tp)]
