"""Sampling: the port against metavoice_tpu/core/sampling.py on the same
logits and the same injected Gumbel noise."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import sampling as JS  # noqa: E402
from metavoice_tpu_torch.core import sampling as S  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kept(x) -> np.ndarray:
    return np.asarray(x) > S.NEG_INF / 2


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 0.95, 0.99])
def test_top_p_mask_matches_jax(top_p):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 2562)) * 3).astype(np.float32)
    ours = S.top_p_mask(torch.from_numpy(logits), top_p).numpy()
    ref = np.asarray(JS.top_p_mask(jnp.asarray(logits), top_p))
    np.testing.assert_array_equal(_kept(ours), _kept(ref))
    np.testing.assert_array_equal(ours[_kept(ours)], logits[_kept(ours)])


def test_top_p_boundary_ties_keep_lowest_ids():
    # five tokens tie on the boundary value; top_p admits only two of them
    logits = np.log(np.array([0.4, 0.1, 0.1, 0.2, 0.1, 0.1], np.float32))
    logits = np.stack([logits, logits[::-1].copy()])
    ours = _kept(S.top_p_mask(torch.from_numpy(logits), 0.75).numpy())
    ref = _kept(JS.top_p_mask(jnp.asarray(logits), 0.75))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[0], [True, True, True, True, False, False])
    np.testing.assert_array_equal(ours[1], [True, True, True, False, False, True])


def test_top_k_temperature_and_cfg_merge_match_jax():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(4, 300)) * 2).astype(np.float32)
    logits[0, :10] = logits[0, 10]  # ties with the k-th value are kept
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(
        S.top_k_mask(t, 20).numpy(), np.asarray(JS.top_k_mask(jnp.asarray(logits), 20))
    )
    for temp in (0.0, 0.7, 1.3):
        np.testing.assert_allclose(
            S.apply_temperature(t, temp).numpy(),
            np.asarray(JS.apply_temperature(jnp.asarray(logits), temp)), rtol=1e-6,
        )
    np.testing.assert_allclose(
        S.cfg_merge(t, 3.0).numpy(), np.asarray(JS.cfg_merge(jnp.asarray(logits), 3.0)),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("seed", range(4))
def test_sample_cfg_with_injected_noise_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(2, 2562)) * 4).astype(np.float32)
    noise = rng.gumbel(size=(1, 2562)).astype(np.float32)
    g, temp, top_p = 3.0, 0.9, 0.95
    ours = S.sample_cfg(
        torch.from_numpy(logits), g, temp, top_p, noise=torch.from_numpy(noise)
    )
    merged = JS.top_p_mask(JS.apply_temperature(JS.cfg_merge(jnp.asarray(logits), g), temp), top_p)
    ref = jnp.argmax(merged + jnp.asarray(noise), axis=-1)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_gumbel_noise_is_standard_gumbel_and_seeded():
    g1 = S.gumbel_noise((200_000,), device="cpu", generator=torch.Generator().manual_seed(3))
    g2 = S.gumbel_noise((200_000,), device="cpu", generator=torch.Generator().manual_seed(3))
    assert torch.equal(g1, g2)
    assert abs(g1.mean().item() - 0.5772) < 0.01  # Euler-Mascheroni
    assert abs(g1.var().item() - np.pi**2 / 6) < 0.03
