"""3-row (speaker, prompt) guidance: the port's merge, sampling and row
helpers against metavoice_tpu/core/sampling.py and models/first_stage.py on
the same logits, tokens and injected Gumbel noise. Generation with a
guidance tuple is held to a JAX loop in tests/test_torch_tts.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import sampling as JS  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu_torch.core import sampling as S  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scales", [(3.0, 1.0), (2.0, 1.5), (1.0, 4.0)])
def test_cfg_merge3_matches_jax(scales):
    logits = (np.random.default_rng(0).normal(size=(6, 300)) * 2).astype(np.float32)
    ours = S.cfg_merge3(torch.from_numpy(logits), *scales).numpy()
    np.testing.assert_allclose(ours, np.asarray(JS.cfg_merge3(jnp.asarray(logits), *scales)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_sample_cfg3_and_probs_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(3, 2562)) * 4).astype(np.float32)
    noise = rng.gumbel(size=(1, 2562)).astype(np.float32)
    g_s, g_p, temp, top_p = 3.0, 1.5, 0.9, 0.95
    ours = S.sample_cfg3(torch.from_numpy(logits), g_s, g_p, temp, top_p, noise=torch.from_numpy(noise))
    merged = JS.top_p_mask(JS.apply_temperature(JS.cfg_merge3(jnp.asarray(logits), g_s, g_p), temp), top_p)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jnp.argmax(merged + jnp.asarray(noise), axis=-1)))
    probs = S.logits_to_probs(torch.from_numpy(logits), temp, top_p).numpy()
    np.testing.assert_allclose(probs, np.asarray(JS.logits_to_probs(jnp.asarray(logits), temp, top_p)),
                               rtol=1e-5, atol=1e-7)


def test_row_helpers_match_jax():
    tokens = np.array([[5, 2048, 2049, 2100, 17, 2561]], np.int32)
    np.testing.assert_array_equal(fs._uncond_prompt_rows(torch.from_numpy(tokens), 2305).numpy(),
                                  np.asarray(jfs._uncond_prompt_rows(jnp.asarray(tokens), 2305)))
    rows = fs.guidance_rows(torch.from_numpy(tokens), 3, 2305).numpy()
    np.testing.assert_array_equal(rows, np.concatenate(
        [tokens, tokens, np.asarray(jfs._uncond_prompt_rows(jnp.asarray(tokens), 2305))]))
    for n in (2, 3):
        np.testing.assert_array_equal(fs.make_spk_cond_mask(2, n, device="cpu").numpy(),
                                      np.asarray(jfs.make_spk_cond_mask(2, n)))
    for g in (None, 3.0, (3.0, 1.0), (2.0, 1.5), [1.0, 2.0]):
        assert fs._normalize_guidance(g) == jfs._normalize_guidance(g)
    for bad in ((0.5, 2.0), (2.0, 0.9)):
        with pytest.raises(ValueError, match=">= 1"):
            fs._normalize_guidance(bad)


def test_eot_guard_raises_as_in_jax():
    """Prompt guidance needs an end-of-text token above end-of-audio."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm

    cfg = first_stage_config(n_layer=1, n_head=2, dim=32, block_size=256)
    params = tfm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for eot in (0, 2048):
        with pytest.raises(ValueError, match="end_of_text_token"):
            fs.generate(params, cfg, [2100], np.zeros(256), guidance_scale=(3.0, 2.0),
                        end_of_text_token=eot, max_new_tokens=4)
    out = fs.generate(params, cfg, [2100, 2101], np.zeros(256), guidance_scale=(3.0, 2.0),
                      end_of_text_token=2305, max_new_tokens=4, compute_dtype=torch.float32)
    assert 3 <= len(out) <= 6
