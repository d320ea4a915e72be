"""Speculative decoding: the port's ``accept_emit`` against the JAX package's
on JAX's own draws, the speculative-sampling identity as a frequency oracle,
and greedy ``generate_spec`` against the JAX package's ``fs.generate`` on the
same weights (f32 on the CPU; the verify runs K4's plain version).

Speculative decoding is exact, so under greedy sampling its tokens do not
depend on the draft: a draft equal to the target accepts every proposal, a
smaller one only changes how many rounds it takes.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core.config import first_stage_config as jfirst_stage_config  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import spec_decode as jsd  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu_torch.core import sampling as S  # noqa: E402
from metavoice_tpu_torch.core.config import TransformerConfig  # noqa: E402
from metavoice_tpu_torch.models import spec_decode as sd  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

# EOA=96, text ids 97..., eot 120: a scaled-down copy of the real token space
# (the JAX package's tests/test_spec_decode.py)
TINY = jfirst_stage_config(n_layer=2, n_head=4, dim=64, block_size=128, vocab_sizes=(121,))
DRAFT = jfirst_stage_config(n_layer=1, n_head=2, dim=32, block_size=128, vocab_sizes=(121,))
EOA, EOT = 96, 120
PROMPT = [100, 101, 102, 103, 5, 17]
SPK = np.ones((256,), np.float32)
GREEDY = dict(temperature=1e-6, top_p=1.0, end_of_audio_token=EOA, prompt_pad_multiple=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(key, cfg):
    params = _jax_init(jax.random.PRNGKey(key), cfg=cfg, dtype=jnp.float32)
    port = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu", dtype=torch.float32)
    return params, port, TransformerConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def target():
    return _pair(0, TINY)


@pytest.fixture(scope="module")
def draft():
    return _pair(7, DRAFT)


# ------------------------------------------------------------------ accept_emit


def _dist(rng, g, v):
    return (lambda x: x / x.sum(-1, keepdims=True))(np.exp(rng.normal(size=(g, v)) * 1.5)).astype(np.float32)


def _jax_draws(key, g, v):
    """JAX's accept_emit draws, rebuilt: its uniforms and the Gumbel noise of
    its residual ``jax.random.categorical``."""
    ku, kr = jax.random.split(key)
    return np.asarray(jax.random.uniform(ku, (g,))), np.asarray(jax.random.gumbel(kr, (v,)))


def test_categorical_is_gumbel_argmax_in_this_jax():
    key = jax.random.PRNGKey(5)
    logits = jnp.asarray(np.random.default_rng(0).normal(size=(4096,)).astype(np.float32))
    got = int(jax.random.categorical(key, logits))
    assert got == int(jnp.argmax(logits + jax.random.gumbel(key, logits.shape)))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("limit", [None, 2])
def test_accept_emit_matches_jax_on_its_draws(seed, limit):
    g, v = 4, 9
    rng = np.random.default_rng(seed)
    p, q = _dist(rng, g, v), _dist(rng, g, v)
    if seed % 2:
        q[:2] = p[:2]  # accepted for sure: the rejection lands later in the window
    drafted = rng.integers(0, v, size=(g,)).astype(np.int32)
    if seed == 3:
        drafted[1] = 6  # an EOA inside the window
    key = jax.random.PRNGKey(100 + seed)
    lim = None if limit is None else jnp.asarray(limit, jnp.int32)
    ref = jsd.accept_emit(key, jnp.asarray(drafted), jnp.asarray(q), jnp.asarray(p), 6, limit=lim)
    u, gum = _jax_draws(key, g, v)
    ours = sd.accept_emit(
        torch.from_numpy(drafted), torch.from_numpy(q), torch.from_numpy(p), 6, limit=limit,
        uniforms=torch.tensor(u), residual_noise=torch.tensor(gum),
    )
    n = int(ref[1])
    assert int(ours[1]) == n and bool(ours[2]) == bool(ref[2]) and int(ours[3]) == int(ref[3])
    np.testing.assert_array_equal(ours[0].numpy()[:n], np.asarray(ref[0])[:n])


@pytest.mark.parametrize("g", [1, 3])
def test_accept_emit_marginal_matches_target(g):
    """The speculative-sampling identity: d ~ q, then accept/reject with
    residual resampling gives an emitted first token ~ p. Frequency oracle
    over 30k independent windows, vectorised over a leading dim."""
    v, n = 7, 30_000
    rng = np.random.default_rng(10 + g)
    p, q = _dist(rng, 1, v)[0], _dist(rng, 1, v)[0]
    gen = torch.Generator().manual_seed(g)
    pt, qt = torch.from_numpy(p).expand(n, g, v), torch.from_numpy(q).expand(n, g, v)
    drafted = torch.argmax(torch.log(qt) + S.gumbel_noise((n, g, v), device="cpu", generator=gen), dim=-1)
    emitted, n_emit, _, _ = sd.accept_emit(drafted, qt, pt, end_of_audio_token=999, generator=gen)
    assert (n_emit >= 1).all()
    freq = np.bincount(emitted[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(freq, p, atol=0.015)


def test_accept_emit_edge_cases():
    rng = np.random.default_rng(3)
    p = torch.from_numpy(_dist(rng, 1, 9)).expand(4, 9)
    drafted = torch.tensor([3, 1, 4, 1])
    for seed in range(5):  # p == q accepts all
        gen = torch.Generator().manual_seed(seed)
        emitted, n_emit, done, n_acc = sd.accept_emit(drafted, p, p, 999, generator=gen)
        assert int(n_emit) == 4 and int(n_acc) == 4 and not bool(done)
        assert torch.equal(emitted, drafted)
    onehot = torch.eye(100)
    drafted = torch.tensor([5, 96, 3, 7])  # EOA accepted second: truncates there
    emitted, n_emit, done, _ = sd.accept_emit(drafted, onehot[drafted], onehot[drafted], 96)
    assert int(n_emit) == 2 and bool(done) and emitted[:2].tolist() == [5, 96]
    drafted = torch.tensor([5, 6, 3, 7])  # the budget holds
    _, n_emit, done, _ = sd.accept_emit(drafted, onehot[drafted], onehot[drafted], 96, limit=2)
    assert int(n_emit) == 2 and not bool(done)


# ------------------------------------------------------------------ end to end


def _jax_generate(params, guidance, max_new, **kw):
    return jfs.generate(params, TINY, PROMPT, jnp.asarray(SPK), key=jax.random.PRNGKey(11),
                        guidance_scale=guidance, max_new_tokens=max_new, compute_dtype=jnp.float32,
                        **GREEDY, **kw)


@pytest.mark.parametrize(
    "draft_name,guidance,draft_use_cfg,gamma",
    [("target", 3.0, True, 4), ("small", 3.0, True, 4), ("target", 1.0, False, 4),
     ("small", 3.0, False, 3), ("target", (2.0, 1.5), True, 3)],
)
def test_greedy_matches_jax_generate(target, draft, draft_name, guidance, draft_use_cfg, gamma):
    jp, p, cfg = target
    _, dp, dcfg = target if draft_name == "target" else draft
    max_new = 16 if isinstance(guidance, tuple) else 24
    eot = dict(end_of_text_token=EOT) if isinstance(guidance, tuple) else {}
    ref = _jax_generate(jp, guidance, max_new, **eot)
    ours, stats = sd.generate_spec(
        p, cfg, dp, dcfg, PROMPT, SPK, generator=torch.Generator().manual_seed(12), gamma=gamma,
        guidance_scale=guidance, max_new_tokens=max_new, compute_dtype=torch.float32,
        return_stats=True, draft_use_cfg=draft_use_cfg, **GREEDY, **eot,
    )
    np.testing.assert_array_equal(ours, ref)
    if draft_name == "target" and (draft_use_cfg or guidance == 1.0):
        assert stats["accepted"] == stats["proposed"], stats
    assert stats["emitted"] == len(ours) - len(PROMPT) - 1
    assert stats["proposed"] == stats["rounds"] * gamma
    assert stats["emitted"] <= stats["rounds"] * gamma


def test_sampling_stats_ledger(target, draft):
    """A different draft at temperature 1: valid tokens within the budget and
    a coherent ledger (every round emits at least one token)."""
    _, p, cfg = target
    _, dp, dcfg = draft
    out, stats = sd.generate_spec(
        p, cfg, dp, dcfg, PROMPT, SPK, generator=torch.Generator().manual_seed(31), gamma=4,
        temperature=1.0, top_p=0.95, guidance_scale=3.0, max_new_tokens=20, end_of_audio_token=EOA,
        prompt_pad_multiple=16, compute_dtype=torch.float32, return_stats=True,
    )
    gen = out[len(PROMPT):]
    assert 1 <= len(gen) <= 20 and (gen >= 0).all() and (gen < 121).all()
    assert stats["rounds"] >= 1 and 0 <= stats["accepted"] <= stats["proposed"]
    assert stats["emitted"] == len(gen) - 1  # the first token is the prefill's
    assert stats["emitted"] >= stats["rounds"]


def test_injected_draws_replay(target, draft):
    """The same injected draws give the same tokens and ledger: the card's run
    can be held to the CPU path's (chip_smoke.py phase 17)."""
    _, p, cfg = target
    _, dp, dcfg = draft
    draws = sd.SpecDraws.sample(12, 4, 121, generator=torch.Generator().manual_seed(2))
    kw = dict(gamma=4, temperature=1.0, top_p=0.95, guidance_scale=3.0, max_new_tokens=20,
              end_of_audio_token=EOA, prompt_pad_multiple=16, compute_dtype=torch.float32,
              return_stats=True, draws=draws)
    runs = [sd.generate_spec(p, cfg, dp, dcfg, PROMPT, SPK, generator=torch.Generator().manual_seed(s), **kw)
            for s in (1, 2)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
