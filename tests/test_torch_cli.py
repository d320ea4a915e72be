"""The port's ``python -m metavoice_tpu_torch.cli quantize`` on the CPU writes
the JAX package's ``cmd_quantize`` file key for key and bit for bit, in all
four modes, from the same reference-format ``.pt`` (tests/test_torch_cli_serve.py
runs the other commands)."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import chip_smoke as cs  # noqa: E402
from metavoice_tpu.cli import cmd_quantize as jax_quantize  # noqa: E402
from metavoice_tpu_torch import cli  # noqa: E402
from metavoice_tpu_torch.core.config import first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402

FIRST = first_stage_config(n_layer=1, n_head=2, dim=256, block_size=64, intermediate_size=256, vocab_sizes=(256,))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def first_pt(tmp_path_factory):
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda t: torch.from_numpy((rng.standard_normal(t.shape) * 0.05).astype(np.float32)),
                        tfm.init_params(FIRST, device="meta"))
    path = str(tmp_path_factory.mktemp("pt") / "first_stage.pt")
    torch.save(cs.gpt_checkpoint(tree, FIRST, {"name": "bpe", "special_tokens": {"<|endoftext|>": 256}}), path)
    return path


@pytest.mark.parametrize("mode", ["int4", "int8", "int8_packed", "int8_plain"])
def test_quantize_writes_the_jax_file(first_pt, tmp_path, mode):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs.npz")  # ".npz" appended, as by np.savez
    assert cli.main(["quantize", "--first_stage_path", first_pt, "--mode", mode, "--out", ours,
                     "--device", "cpu"]) == 0
    assert jax_quantize(["--first_stage_path", first_pt, "--mode", mode, "--out", theirs]) == 0
    with np.load(ours + ".npz") as a, np.load(theirs) as b:
        assert a.files == b.files
        for k in a.files:
            if k == "__meta__":
                assert json.loads(str(a[k])) == json.loads(str(b[k]))
            else:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                assert a[k].tobytes() == b[k].tobytes(), k
