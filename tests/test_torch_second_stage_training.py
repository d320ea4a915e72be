"""The port's second-stage training (metavoice_tpu_torch/training/second_stage.py)
against the JAX package's (metavoice_tpu/training/second_stage.py):
``build_example`` equal, three full-batch AdamW steps from the same numpy
weights, and the ``.npz`` both packages' loaders read.

Tolerances: the loss rtol 1e-5; the params as in test_torch_finetune.py
(Adam's step is about +-lr an element, and a near-zero grad whose sign the
two packages' f32 sums disagree on moves its element by up to 2 lr): every
element within 2 x 3 lr, all but 1e-3 of them within 1e-3 lr.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.tree_util as jtu  # noqa: E402

from metavoice_tpu.core.config import second_stage_config as jsecond_stage_config  # noqa: E402
from metavoice_tpu.training import second_stage as jss  # noqa: E402
from metavoice_tpu.utils import checkpoint as jck  # noqa: E402
from metavoice_tpu_torch.core.config import second_stage_config  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.training import second_stage as ss  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ck  # noqa: E402

SMALL = dict(n_layer=2, n_head=2, dim=32, block_size=24)
JCFG, CFG = jsecond_stage_config(**SMALL), second_stage_config(**SMALL)
STEPS, LR = 3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jtu.keystr(k): (v.detach().float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32))
            for k, v in jtu.tree_flatten_with_path(tree)[0]}


def _codes(seed, t):
    return np.random.default_rng(seed).integers(0, 1024, (8, t)).astype(np.int32)


@pytest.mark.parametrize("n_text,t", [(5, 10), (9, 30), (0, 24)])
def test_build_example_matches_jax(n_text, t):
    text = list(range(1030, 1030 + n_text))
    got, want = ss.build_example(text, _codes(t, t), CFG), jss.build_example(text, _codes(t, t), JCFG)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def batch():
    xs, ys, ms = zip(*(ss.build_example(list(range(1030, 1030 + n)), _codes(n, 16), CFG) for n in (4, 7)))
    spk = np.random.default_rng(1).normal(size=(2, 256)).astype(np.float32)
    return {"x": np.stack(xs), "y": np.stack(ys), "mask": np.stack(ms), "spk_emb": spk}


@pytest.fixture(scope="module")
def numpy_params():
    rng = np.random.default_rng(0)
    shapes = tfm.init_params(CFG, device="cpu")
    return jtu.tree_map_with_path(
        lambda path, t: ((1 + 0.1 * rng.normal(size=tuple(t.shape))) if jtu.keystr(path).endswith("norm_w']")
                         else 0.02 * rng.normal(size=tuple(t.shape))).astype(np.float32), shapes)


def test_three_steps_match_jax(numpy_params, batch):
    tcfg = dict(learning_rate=LR, max_iters=STEPS)
    want, want_loss = jss.train_second_stage(jax.tree.map(np.asarray, numpy_params), JCFG, batch,
                                             jss.SecondStageTrainConfig(**tcfg))
    got, got_loss = ss.train_second_stage(ck.params_from_numpy(numpy_params, device="cpu"), CFG, batch,
                                          ss.SecondStageTrainConfig(**tcfg))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    g, w, init = _flat(got), _flat(want), _flat(numpy_params)
    assert g.keys() == w.keys()
    for k in w:
        d = np.abs(g[k] - w[k])
        assert d.max() <= 2 * STEPS * LR and np.mean(d > 1e-3 * LR) <= 1e-3, k
        assert not np.array_equal(g[k], init[k]), k  # every leaf trains


def test_checkpoint_read_by_both_packages(tmp_path, numpy_params):
    params = ck.params_from_numpy(numpy_params, device="cpu", dtype=torch.bfloat16)
    path = ss.save_second_stage(str(tmp_path / "port.npz"), params, CFG, {"t": 2})
    jss.save_second_stage(str(tmp_path / "jax.npz"), jax.tree.map(lambda t: t.float().numpy(), params), JCFG,
                          {"t": 2})
    got, got_meta = jck.load_npz(path)
    want_meta = jck.load_npz(str(tmp_path / "jax.npz"))[1]
    assert got_meta == want_meta
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, _flat(params)[k])
    loaded, cfg, tok = ck.load_second_stage_npz(path, device="cpu")
    assert tok == {"t": 2} and dataclasses.asdict(cfg) == dataclasses.asdict(CFG)
    assert loaded["layers"]["wqkv"].dtype == torch.bfloat16
