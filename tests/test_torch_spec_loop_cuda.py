"""The speculative round's device loop on the card: each round one replay of
its CUDA graph, against the host loop (``generate_spec_eager``) bit for bit,
and K4 at T = gamma with its position read on the device.

Needs a CUDA card; skips elsewhere. Imports no JAX, so on the machine with
the card it runs without the JAX package's conftest:

    python -m pytest --noconftest tests/test_torch_spec_loop_cuda.py -q
"""

import pytest
import torch

from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.models import first_stage as fs
from metavoice_tpu_torch.models import spec_decode as sd
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.ops import attention as A
from metavoice_tpu_torch.ops import quantized as Q
from metavoice_tpu_torch.ops.counters import KERNEL_COUNTERS

EOA = 2048
K4_TOL = 2e-2  # bf16 K4 against its plain version (f32 sums of bf16 values)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    fs.release_graphs()


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _counts():
    return {k: getattr(f, a) for k, (f, a) in KERNEL_COUNTERS.items()}


def _models(dev, mode):
    """(target, its config, draft, its config, draft_use_cfg, gamma): a bf16
    target with a dense CFG draft (K4 verify, K1 draft steps), or an int4
    target with an int4 CFG-free draft (K2 products and K4, K3 steps)."""
    gen = torch.Generator(device=dev).manual_seed(26)
    cfg_t = first_stage_config(n_layer=2, n_head=16, dim=2048)
    cfg_d = first_stage_config(n_layer=1, n_head=8, dim=1024)
    target = tfm.init_params(cfg_t, device=dev, generator=gen, dtype=torch.bfloat16)
    draft = tfm.init_params(cfg_d, device=dev, generator=gen, dtype=torch.bfloat16)
    if mode == "bf16":
        return target, cfg_t, draft, cfg_d, True, 4
    return Q.quantize_params_int4_i32(target), cfg_t, Q.quantize_params_int4_i32(draft), cfg_d, False, 8


def _draws(n, gamma, vocab, dev):
    d = sd.SpecDraws.sample(n, gamma, vocab, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    for t in (d.prefill, d.draft, d.residual):
        t[..., EOA] = -1e4  # never end-of-audio: every round of the budget runs
    return d


def _run(fn, models, dev, draws, seed, **kw):
    p, cfg_t, dp, cfg_d, use_cfg, gamma = models
    kv_t = tfm.KVCache.create(cfg_t, 2, cfg_t.block_size, dtype=torch.bfloat16, device=dev)
    kv_d = tfm.KVCache.create(cfg_d, 2 if use_cfg else 1, cfg_d.block_size, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    before = _counts()
    tokens, stats = fn(p, cfg_t, dp, cfg_d, list(range(2100, 2460)), torch.ones(256).numpy(), gamma=gamma,
                       draft_use_cfg=use_cfg, max_new_tokens=200, prompt_pad_multiple=8, kv_cache=kv_t,
                       draft_kv_cache=kv_d, generator=gen, draws=draws, return_stats=True, **kw)
    torch.cuda.synchronize()
    after = _counts()
    return tokens, stats, {k: after[k] - before[k] for k in after}, gen.get_state(), (kv_t, kv_d)


@pytest.mark.cuda
@pytest.mark.parametrize("draws", [True, False], ids=["spec-draws", "generator"])
@pytest.mark.parametrize("mode", ["bf16", "int4"])
def test_graph_loop_gives_the_host_loop_bits(cuda, mode, draws):
    """From pos 360 across the window buckets 384 and 512: the graph loop's
    tokens, ledger, generator state and caches below pos are the host
    loop's; with no idle round its launches are too."""
    models = _models(cuda, mode)
    gamma = models[-1]
    d = _draws(200, gamma, models[1].vocab_sizes[0], cuda) if draws else None
    te, se, ce, ge, (kt_e, kd_e) = _run(sd.generate_spec_eager, models, cuda, d, 5)
    stats = {}
    tg, sg, cg, gg, (kt_g, kd_g) = _run(sd.generate_spec, models, cuda, d, 5, stats=stats)
    assert stats["spec_loop"] == "graph" and stats["spec_reads"] < sg["rounds"]
    assert (tg == te).all() and sg == se and torch.equal(gg, ge)
    pos = 360 + se["emitted"]
    for a, b in ((kt_g, kt_e), (kd_g, kd_e)):
        assert _same_bits(a.k[:, :pos], b.k[:, :pos]) and _same_bits(a.v[:, :pos], b.v[:, :pos])
    if stats["spec_rounds_run"] == se["rounds"]:
        assert cg == ce
    assert cg["k4_launches"] == models[1].n_layer * stats["spec_rounds_run"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int4"])
def test_host_loop_repeats_its_bits(cuda, mode):
    """The host loop, run 6 times on the same inputs (rows of the verify
    crossing split boundaries of the bucket's plan): every run the first's
    tokens and caches."""
    models = _models(cuda, mode)
    d = _draws(200, models[-1], models[1].vocab_sizes[0], cuda)
    runs = [_run(sd.generate_spec_eager, models, cuda, d, 1) for _ in range(6)]
    first = runs[0]
    for r in runs[1:]:
        assert (r[0] == first[0]).all() and r[1] == first[1]
        assert all(_same_bits(a.k, b.k) and _same_bits(a.v, b.v) for a, b in zip(r[4], first[4]))


# (T, kv heads, pos, window): the split boundaries of attention_plan fall inside [pos, pos + T) (512 in 4 splits
# of 128 at pos 380; 2048 in 4 of 512 at pos 1020; GQA 1024 in 8 of 128 at pos 1020), a bucket larger than needed
K4_CASES = [(4, 16, 255, None), (8, 16, 380, None), (16, 16, 376, None), (8, 16, 1020, None), (16, 16, 2032, None),
            (4, 16, 100, 1024), (8, 2, 1016, 1024), (16, 2, 380, None), (8, 2, 1020, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,h_kv,pos,window", K4_CASES)
def test_k4_device_pos_gives_the_host_int_bits(cuda, t, h_kv, pos, window):
    gen = torch.Generator(device=cuda).manual_seed(pos + t)
    b, h, dh, s = 2, 16, 128, 2048

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    q, k_new, v_new = r(b, h, t, dh), r(b, h_kv, t, dh), r(b, h_kv, t, dh)
    kc, vc = r(2, s, b, h_kv, dh), r(2, s, b, h_kv, dh)
    kc[:, pos + t :] = float("nan")  # never read
    vc[:, pos + t :] = float("nan")
    kd, vd, kr, vr = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    window = window or A.attention_window(pos + t, s)
    st = torch.tensor((0, pos // 2), dtype=torch.int32, device=cuda)
    before = A.decode_attention_multi.launches
    y, _, _ = A.decode_attention_multi(q, k_new, v_new, kc, vc, 1, pos, st, window=window)
    yd, _, _ = A.decode_attention_multi(q, k_new, v_new, kd, vd, 1, torch.tensor(pos, dtype=torch.int32, device=cuda),
                                        st, window=window)
    assert A.decode_attention_multi.launches == before + 2
    assert _same_bits(y, yd) and _same_bits(kc, kd) and _same_bits(vc, vd) and torch.isfinite(yd.float()).all()
    ref, _, _ = A.decode_attention_multi_reference(q, k_new, v_new, kr, vr, 1, torch.tensor(pos, device=cuda), st,
                                                   window=window)
    torch.testing.assert_close(yd.float(), ref.float(), atol=K4_TOL, rtol=K4_TOL)
    assert _same_bits(kd, kr) and _same_bits(vd, vr)
