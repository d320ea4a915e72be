"""The port's capacity planner (utils/capacity.py) and ``slots="auto"``.

At full width, for every weight mode, cache format and 2 or 3 rows a slot,
the plan's bytes are those of the port's own parameter tree and ``KVCache``
(built on the meta device), and the JAX package's plan for the same
configuration (the layouts are the same, and so is every byte: no difference
to list). At a small width the plan equals the bytes of real CPU tensors
built the same way, so the meta device counts what an allocation holds.
``max_slots`` agrees with the JAX package's for the same memory and
utilization. On the CPU there is no device memory to plan from.
"""

import functools

import pytest
import torch

jax = pytest.importorskip("jax")

from metavoice_tpu.core.config import first_stage_config as jax_first_stage_config  # noqa: E402
from metavoice_tpu.utils import capacity as jcap  # noqa: E402
from metavoice_tpu_torch.core.config import first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.utils import capacity as cap  # noqa: E402

MODES = [None, "int4", "int8", "int8_plain"]
CACHES = [None, "int8", "int8_packed"]
GIB80 = 80 * 1024**3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _cache_nbytes(kv) -> int:
    return sum(_nbytes(t) for t in (kv.k, kv.v, kv.k_scale, kv.v_scale) if t is not None)


@pytest.fixture(scope="module", autouse=True)
def _jax_trees_traced_once():
    """The JAX planner traces its parameter tree (jax.eval_shape) on every
    plan its slot search makes; the tree of a (cfg, mode) is always the same."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcap, "params_abstract", functools.lru_cache(maxsize=None)(jcap.params_abstract))
        yield


@pytest.fixture(scope="module")
def weights():
    """A mode's weight bytes: the port's tree on the meta device, and the JAX
    package's (jax.eval_shape, no allocation)."""
    return {m: (_nbytes(cap.params_abstract(first_stage_config(), m)),
                jcap._tree_bytes(jcap.params_abstract(jax_first_stage_config(), m))) for m in MODES}


@pytest.mark.parametrize("rows", [2, 3])
@pytest.mark.parametrize("kv", CACHES)
@pytest.mark.parametrize("mode", MODES)
def test_full_width_plan_is_the_ports_buffers_and_jaxs(mode, kv, rows, weights):
    cfg = first_stage_config()
    plan = cap.memory_plan(cfg, hbm_bytes=GIB80, quantisation_mode=mode, kv_cache_dtype=kv, slots=5, cfg_rows=rows)
    assert (plan.weights_bytes, plan.weights_bytes) == weights[mode]
    cache = tfm.KVCache.create(cfg, rows * 5, cfg.block_size, dtype=kv or torch.bfloat16, device="meta")
    assert plan.cache_bytes == _cache_nbytes(cache)
    jplan = jcap.memory_plan(jax_first_stage_config(), quantisation_mode=mode, kv_cache_dtype=kv, slots=5,
                             cfg_rows=rows, hbm_bytes=GIB80)
    assert (plan.weights_bytes, plan.cache_bytes, plan.total_bytes) == (jplan.weights_bytes, jplan.cache_bytes,
                                                                        jplan.total_bytes)


@pytest.mark.parametrize("mode", MODES)
def test_small_width_plan_is_what_real_tensors_hold(mode):
    from metavoice_tpu_torch.cli import quantize_first_stage

    cfg = first_stage_config(n_layer=2, dim=1024, n_head=8, block_size=64)
    params = tfm.init_params(cfg, device="cpu", dtype=torch.bfloat16)
    if mode:
        params = quantize_first_stage(params, "int8" if mode == "int8" else mode)
    for kv in CACHES:
        plan = cap.memory_plan(cfg, hbm_bytes=GIB80, quantisation_mode=mode, kv_cache_dtype=kv, slots=3)
        real = tfm.KVCache.create(cfg, 6, cfg.block_size, dtype=kv or torch.bfloat16, device="cpu")
        assert (plan.weights_bytes, plan.cache_bytes) == (_nbytes(params), _cache_nbytes(real))


@pytest.mark.parametrize("kv", CACHES)
@pytest.mark.parametrize("mode", MODES)
def test_max_slots_agrees_with_jax(mode, kv):
    for hbm, util in ((GIB80, 0.75), (16 * 1024**3, 0.75), (GIB80, cap.DEFAULT_UTILIZATION)):
        ours = cap.max_slots(first_stage_config(), hbm_bytes=hbm, quantisation_mode=mode, kv_cache_dtype=kv,
                             utilization=util)
        assert ours == jcap.max_slots(jax_first_stage_config(), quantisation_mode=mode, kv_cache_dtype=kv,
                                      hbm_bytes=hbm, utilization=util)
    assert cap.max_slots(first_stage_config(), hbm_bytes=1024**3, quantisation_mode=mode, kv_cache_dtype=kv) == 0


def test_auto_slots_needs_a_card(tmp_path):
    from metavoice_tpu_torch.runtime.engine import ContinuousBatchingEngine
    from metavoice_tpu_torch.runtime.tts import TTS

    with pytest.raises(ValueError, match="pass a slot count"):
        cap.device_memory_bytes("cpu")
    tts = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="pass a slot count"):
        ContinuousBatchingEngine(tts, slots="auto")
    assert cap.MAX_AUTO_SLOTS == 32
