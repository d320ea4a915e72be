"""Ragged batched generation of the port (``left_pad_prompts``,
``prefill_batch``, ``generate_batch``: ``decode`` with per-row windows)
against the JAX package on the same weights and the same Gumbel noise.

The JAX side is a test-side step loop over the JAX package's own functions
(``embed_inputs``, ``_batch_masks``, ``apply_blocks(..., attn_starts=pad2)``
and the sampling functions), with the noise added before the argmax where
``jax.random.categorical`` would draw it.
"""

from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import sampling as JS  # noqa: E402
from metavoice_tpu.core.config import first_stage_config as jfirst_stage_config  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu_torch.core.config import first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

DIMS = dict(n_layer=2, n_head=4, dim=64, block_size=128, vocab_sizes=(97,))
EOA = 96  # an in-vocabulary end-of-audio token, so the noise can force it
BUCKET = 32  # prompt_pad_multiple: > 16, the short-window route's most tokens
N_NEW = 12
NOISE_SCALE = 0.1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jfirst_stage_config(**DIMS)
    jparams = _jax_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, first_stage_config(**DIMS), params


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, EOA, size=n).tolist() for n in lengths]


def _spk(b, seed=1):
    return np.random.default_rng(seed).normal(size=(b, 256)).astype(np.float32)


def _noise(n, b, seed=2, scale=NOISE_SCALE, eoa_at=()):
    """(n, B, V) Gumbel noise; eoa_at: (step, row) cells that force EOA."""
    noise = (np.random.default_rng(seed).gumbel(size=(n, b, DIMS["vocab_sizes"][0])) * scale).astype(np.float32)
    for step, row in eoa_at:
        noise[step, row, EOA] = 1e4
    return noise


def _per_row(v, b):
    return jnp.broadcast_to(jnp.asarray(v, jnp.float32).reshape(-1), (b,)).reshape(b, 1)


@partial(jax.jit, static_argnames=("cfg",))
def _jax_prefill(params, cfg, tokens2, positions2, spk2, mask, pad2, kv):
    x = jtfm.embed_inputs(params, cfg, tokens2, positions2, spk2, mask, jnp.float32)
    x, kv = jtfm.apply_blocks(params, cfg, x, jfs._batch_masks(pad2, tokens2.shape[1], kv.max_seq_len), kv,
                              jnp.asarray(0))
    return jtfm.output_logits(params, cfg, x[:, -1:, :])[0][:, 0, :], kv


@partial(jax.jit, static_argnames=("cfg",))
def _jax_step(params, cfg, tokens2, pos, spk2, mask, pad2, kv):
    x = jtfm.embed_inputs(params, cfg, tokens2, (pos - pad2)[:, None], spk2, mask, jnp.float32)
    kv_pos = jnp.arange(kv.max_seq_len)
    attn = ((kv_pos[None, :] <= pos) & (kv_pos[None, :] >= pad2[:, None]))[:, None, None, :]
    y, kv, head_done = jtfm.apply_blocks(params, cfg, x, attn, kv, pos, attn_starts=pad2, fused_head=True)
    return (y if head_done else jtfm.output_logits(params, cfg, y)[0][:, 0, :]), kv


@jax.jit
def _jax_sample(logits, noise, temperature, top_p, guidance):
    merged = JS.top_p_mask(JS.apply_temperature(JS.cfg_merge(logits, guidance), temperature), top_p)
    return jnp.argmax(merged + noise, axis=-1)


def _jax_batch(model, prompts, spk, noise, temperature=0.1, top_p=0.95, guidance=3.0, n_new=N_NEW,
               cache_dtype=jnp.float32):
    """JAX ragged prefill + T=1 steps with per-row windows -> B token lists."""
    jcfg, jparams, _, _ = model
    b = len(prompts)
    bucket = -(-max(len(p) for p in prompts) // BUCKET) * BUCKET
    padded, pad_lens = jfs.left_pad_prompts(prompts, bucket)
    pad2 = jnp.asarray(np.concatenate([pad_lens, pad_lens]))
    spk2 = jnp.asarray(np.concatenate([spk, spk]))
    mask = jfs.make_spk_cond_mask(b)
    knobs = (_per_row(temperature, b), _per_row(top_p, b), _per_row(guidance, b))
    kv = jtfm.KVCache.create(jcfg, 2 * b, jcfg.block_size, dtype=cache_dtype)
    positions = np.maximum(np.arange(bucket)[None, :] - pad_lens[:, None], 0)
    logits, kv = _jax_prefill(jparams, jcfg, jnp.asarray(np.concatenate([padded, padded])),
                              jnp.asarray(np.concatenate([positions, positions])), spk2, mask, pad2, kv)
    cur = np.asarray(_jax_sample(logits, jnp.asarray(noise[0]), *knobs))
    out, done = [cur], cur == EOA
    for i in range(1, n_new):
        if done.all():
            break
        logits, kv = _jax_step(jparams, jcfg, jnp.asarray(np.concatenate([cur, cur]))[:, None],
                               jnp.int32(bucket + i - 1), spk2, mask, pad2, kv)
        cur = np.where(done, EOA, np.asarray(_jax_sample(logits, jnp.asarray(noise[i]), *knobs)))
        out.append(cur)
        done = done | (cur == EOA)
    steps = np.stack(out, axis=1)  # (B, n)
    rows = []
    for row in steps:
        stop = np.flatnonzero(row == EOA)
        rows.append(row[: stop[0] + 1] if len(stop) else row)
    return rows


def _port_batch(model, prompts, spk, noise, temperature=0.1, top_p=0.95, guidance=3.0, n_new=N_NEW, **kw):
    _, _, cfg, params = model
    return fs.generate_batch(
        params, cfg, prompts, spk, temperature=temperature, top_p=top_p, guidance_scale=guidance,
        max_new_tokens=n_new, end_of_audio_token=EOA, prompt_pad_multiple=BUCKET,
        compute_dtype=torch.float32, noise=torch.from_numpy(noise), **kw,
    )


def _assert_rows_equal(ours, ref):
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"row {i}")


@pytest.mark.parametrize("lengths,bucket", [([[1, 2, 3], [4]], 8), ([list(range(10)), [7] * 40, []], 32)])
def test_left_pad_prompts_matches_jax(lengths, bucket):
    """Left padding to the bucket; a prompt longer than it keeps its tail."""
    ours, ours_pad = fs.left_pad_prompts(lengths, bucket)
    ref, ref_pad = jfs.left_pad_prompts(lengths, bucket)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours_pad, ref_pad)
    assert ours.dtype == ours_pad.dtype == np.int32


def test_batch_masks_match_jax():
    pad2 = np.array([0, 5, 31, 0, 5, 31], np.int32)
    ours = fs._batch_masks(torch.from_numpy(pad2), 32, 128).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jfs._batch_masks(jnp.asarray(pad2), 32, 128)))


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_batch_matches_jax_loop(model, seed):
    """Four ragged prompts in one 64 bucket, 12 new tokens each."""
    prompts = _prompts([5, 17, 40, 33], seed)
    spk, noise = _spk(4, seed + 10), _noise(N_NEW, 4, seed + 20)
    ref = _jax_batch(model, prompts, spk, noise)
    ours = _port_batch(model, prompts, spk, noise)
    _assert_rows_equal(ours, ref)
    assert all(len(r) == N_NEW or (r[-1] == EOA and len(r) < N_NEW) for r in ours)


def test_end_of_audio_latch_per_row(model):
    """EOA forced in row 1 at its 4th token and in row 2 at its first (the
    prefill's): each row stops there, the others run on."""
    prompts, spk = _prompts([9, 20, 3], 3), _spk(3, 4)
    noise = _noise(N_NEW, 3, 5, scale=1.0, eoa_at=[(3, 1), (0, 2)])
    ref = _jax_batch(model, prompts, spk, noise, temperature=1.0, top_p=1.0)
    ours = _port_batch(model, prompts, spk, noise, temperature=1.0, top_p=1.0)
    _assert_rows_equal(ours, ref)
    assert [len(r) for r in ours] == [N_NEW, 4, 1] and ours[1][-1] == ours[2][-1] == EOA


def test_decode_steps_stop_at_the_latch(model):
    _, _, cfg, params = model
    noise = _noise(N_NEW, 2, 6, scale=1.0, eoa_at=[(2, 0), (1, 1)])
    stats = {}
    out = fs.generate_batch(params, cfg, _prompts([4, 6], 6), _spk(2), temperature=1.0, top_p=1.0,
                            max_new_tokens=N_NEW, end_of_audio_token=EOA, prompt_pad_multiple=BUCKET,
                            compute_dtype=torch.float32, noise=torch.from_numpy(noise), stats=stats)
    assert [len(r) for r in out] == [3, 2]
    # the host reads the latch every DONE_CHECK_EVERY steps: the loop ends at its next read
    assert stats["decode_steps"] == min(N_NEW - 1, fs.DONE_CHECK_EVERY)


def test_prefill_batch_first_tokens_match_jax(model):
    prompts, spk = _prompts([30, 2, 64], 7), _spk(3, 8)
    noise = _noise(1, 3, 9)
    ref = _jax_batch(model, prompts, spk, noise, n_new=1)
    ours = _port_batch(model, prompts, spk, noise, n_new=1)
    _assert_rows_equal(ours, ref)


def test_padding_isolation(model):
    """A prompt's first token does not depend on how far it is left-padded:
    the same prompt in a 32 and in a 96 bucket, greedy."""
    _, _, cfg, params = model
    prompt = _prompts([12], 10)[0]
    spk = torch.from_numpy(_spk(1, 11))
    firsts = []
    for bucket in (32, 96):
        padded, pad_lens = fs.left_pad_prompts([prompt], bucket)
        kv = fs.tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=torch.float32, device="cpu")
        tok = fs.prefill_batch(params, cfg, torch.from_numpy(padded).long(), torch.from_numpy(pad_lens), spk, kv,
                               1e-6, 1.0, 1.0, torch.float32, noise=torch.zeros(1, cfg.vocab_size))
        firsts.append(int(tok[0]))
    assert firsts[0] == firsts[1]


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_batch_rows_equal_single_runs(model, cache_dtype):
    """Row isolation: each row of a ragged batch equals its prompt generated
    alone (``generate``, right-padded, 2 cache rows) under that row's noise."""
    _, _, cfg, params = model
    prompts, spk = _prompts([7, 30, 19], 12), _spk(3, 13)
    noise = _noise(N_NEW, 3, 14)
    batch = _port_batch(model, prompts, spk, noise, cache_dtype=cache_dtype)
    for i, p in enumerate(prompts):
        one = fs.generate(params, cfg, p, spk[i], temperature=0.1, top_p=0.95, guidance_scale=3.0,
                          max_new_tokens=N_NEW, end_of_audio_token=EOA, prompt_pad_multiple=BUCKET,
                          compute_dtype=torch.float32, cache_dtype=cache_dtype,
                          noise=torch.from_numpy(noise[:, i : i + 1]))
        np.testing.assert_array_equal(batch[i], one[len(p):], err_msg=f"row {i}")


def test_int8_cache_batch_matches_jax_loop(model):
    """The int8 KV cache in a batch: both sides quantize the same rows the
    same way (the cache helpers are bit-identical), so the same tokens."""
    prompts, spk, noise = _prompts([11, 25], 15), _spk(2, 16), _noise(N_NEW, 2, 17)
    ref = _jax_batch(model, prompts, spk, noise, cache_dtype=jnp.int8)
    ours = _port_batch(model, prompts, spk, noise, cache_dtype="int8")
    _assert_rows_equal(ours, ref)


def test_per_row_knobs_equal_scalar_run(model):
    """Per-row values that are all the same reproduce the scalar call bit for bit."""
    prompts, spk, noise = _prompts([10, 4], 18), _spk(2, 19), _noise(N_NEW, 2, 20, scale=1.0)
    kw = dict(temperature=0.8, top_p=0.9, guidance=2.0)
    scalar = _port_batch(model, prompts, spk, noise, **kw)
    vector = _port_batch(model, prompts, spk, noise, **{k: [v, v] for k, v in kw.items()})
    _assert_rows_equal(vector, scalar)


def test_mixed_per_row_knobs_match_jax_and_each_row_alone(model):
    """Mixed temperature, top-p and guidance: the JAX loop's tokens, and each
    row the tokens of a scalar batch of that row's own values."""
    prompts, spk, noise = _prompts([8, 14, 21], 21), _spk(3, 22), _noise(N_NEW, 3, 23, scale=1.0)
    kw = dict(temperature=[0.5, 1.5, 1.0], top_p=[0.9, 0.99, 0.8], guidance=[1.5, 4.0, 3.0])
    ours = _port_batch(model, prompts, spk, noise, **kw)
    _assert_rows_equal(ours, _jax_batch(model, prompts, spk, noise, **kw))
    for i in range(3):
        alone = _port_batch(model, prompts, spk, noise, **{k: v[i] for k, v in kw.items()})
        np.testing.assert_array_equal(ours[i], alone[i], err_msg=f"row {i}")


def test_short_bucket_and_long_prompts_refused(model):
    _, _, cfg, params = model
    with pytest.raises(ValueError, match="exceed 16"):
        fs.generate_batch(params, cfg, [[1, 2]], _spk(1), prompt_pad_multiple=16, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="too long"):
        fs.generate_batch(params, cfg, [[1] * 128], _spk(1), prompt_pad_multiple=BUCKET,
                          compute_dtype=torch.float32)


def test_chip_row_check_catches_a_window_fault(model):
    """chip_smoke.py's row check (phases 36-38) on the CPU: the plain path
    swap and the logit recorder leave a batch as it is, and a decode that
    ignores the left padding (no ``attn_starts``) moves a padded row's
    logits past the loosest route's BATCH_LOGIT_TOL at its first decode
    step (on this 2-layer, 64-wide model; more on a wider, deeper one), so
    the check fails it on every route."""
    import chip_smoke as cs

    _, _, cfg, params = model
    tol = max(cs.BATCH_LOGIT_TOL.values())
    prompts, spk, noise = _prompts([5, 20, 32], 24), _spk(3, 25), _noise(6, 3, 26, scale=1.0)
    kw = dict(temperature=1.0, top_p=1.0, max_new_tokens=6, end_of_audio_token=EOA, prompt_pad_multiple=BUCKET,
              compute_dtype=torch.float32, noise=torch.from_numpy(noise))
    with cs.recorded_logits() as good:
        toks = fs.generate_batch(params, cfg, prompts, spk, **kw)
    with cs.recorded_logits() as plain, cs.plain_path():
        again = fs.generate_batch(params, cfg, prompts, spk, **kw)
    for r in range(3):
        seen, gap = cs.rows_agree(torch, "plain", toks[r], again[r], lambda i: cs._row_logits(good[i], r, 3),
                                  lambda i: cs._row_logits(plain[i], r, 3), tol)
        assert (seen, gap) == ("same", 0.0)

    apply_blocks = fs.tfm.apply_blocks

    def no_window(*args, **kwargs):
        return apply_blocks(*args, **{**kwargs, "attn_starts": None})

    fs.tfm.apply_blocks = no_window
    try:
        with cs.recorded_logits() as bad:
            wrong = fs.generate_batch(params, cfg, prompts, spk, **kw)
    finally:
        fs.tfm.apply_blocks = apply_blocks
    gap = (cs._row_logits(bad[1], 0, 3) - cs._row_logits(good[1], 0, 3)).abs().max() / good[1][[0, 3]].abs().max()
    assert gap > tol
    with pytest.raises(SystemExit):
        cs.rows_agree(torch, "window fault", toks[0], wrong[0], lambda i: cs._row_logits(good[i], 0, 3),
                      lambda i: cs._row_logits(bad[i], 0, 3), tol)


def _captured_batch(cs, cfg, params, n_new=6):
    """A ragged batch (left pads 27, 12, 0) under chip_smoke.py's capture of
    the kernel calls at the prefill, the first decode step and the last."""
    prompts, spk, noise = _prompts([5, 20, 32], 24), _spk(3, 25), _noise(n_new, 3, 26, scale=1.0)
    kw = dict(temperature=1.0, top_p=1.0, max_new_tokens=n_new, end_of_audio_token=EOA, prompt_pad_multiple=BUCKET,
              compute_dtype=torch.float32, noise=torch.from_numpy(noise))
    with cs.recorded_logits() as seen, cs.captured_calls(torch, {0, 1, n_new - 1}, lambda: len(seen)) as kept:
        fs.generate_batch(params, cfg, prompts, spk, **kw)
    return kept


def test_chip_kernel_hold_keeps_the_runs_calls(model):
    """chip_smoke.py's per-kernel check (phases 36-38) on the CPU: the
    capture keeps the decode attention's call of the first decode step and
    of the last, with the batch's rows and ragged starts, and no prefill
    call (its attention takes no kernel); each call and its move to the
    cache's last slot agree with the plain version (here the wrapper takes
    it: gap 0). A launched kernel with no kept call fails the check."""
    import chip_smoke as cs

    _, _, cfg, params = model
    kept = _captured_batch(cs, cfg, params)
    assert [(name, step) for name, _, _, _, step in kept] == [("decode_attention", 1), ("decode_attention", 5)]
    _, _, args, kw, _ = kept[0]
    assert args[0].shape[0] == 6 and args[6] == BUCKET and kw["starts"].tolist() == [27, 12, 0, 27, 12, 0]
    counts = dict.fromkeys(cs.counters(), 0) | {"k1_launches": 2 * 5}
    assert cs.hold_captured(torch, "cpu", kept, counts) == "K1 2 calls within 0 (at the last slots 0)"
    with pytest.raises(SystemExit):
        cs.hold_captured(torch, "cpu", kept, counts | {"k2_launches": 1})


@pytest.mark.parametrize("fault", ["ignores the starts", "3% off", "5% off past slot 100"])
def test_chip_kernel_hold_catches_a_faulty_kernel(model, fault, monkeypatch):
    """A decode attention that is wrong by a few percent, or only over a
    window longer than the batch reaches (slot 100; the capture's move to
    the cache's last slot reaches it), or that ignores the ragged starts,
    is caught by the per-kernel check at K1's own tolerance, though the
    batch's tokens may not show it."""
    import chip_smoke as cs
    from metavoice_tpu_torch.ops import attention as A

    _, _, cfg, params = model

    def faulty(q, k_new, v_new, kc, vc, layer, pos, starts=None):
        y, kc, vc = A.decode_attention_reference(q, k_new, v_new, kc, vc, layer, pos,
                                                 None if fault == "ignores the starts" else starts)
        scale = {"3% off": 1.03, "5% off past slot 100": 1.05 if pos > 100 else 1.0}.get(fault, 1.0)
        return y * scale, kc, vc

    monkeypatch.setattr(fs.tfm, "decode_attention", faulty)
    kept = _captured_batch(cs, cfg, params)
    monkeypatch.undo()
    counts = dict.fromkeys(cs.counters(), 0) | {"k1_launches": 2 * 5}
    with pytest.raises(SystemExit):
        cs.hold_captured(torch, "cpu", kept, counts)
