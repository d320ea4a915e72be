"""The serving engine's cache landing and rebase of the port
(``first_stage.merge_slot_*`` and ``shift_*_left``) against the JAX
package's functions of the same names, bit for bit, on caches made from a
numpy seed: float, int8 with its scale tables, and packed (int8 in int32
words, residue-split scales), the packed merges at every ``phys_start``
residue, the shifts with and without ``pos``, and the roll route of a
sequence length that is not a multiple of the chunk.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402

L, H, DH = 2, 2, 4
SLOTS = 3  # 6 cache rows
BHPAD = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(rng, shape):
    return rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)


def _cache(rng, kind: str, s: int, b: int):
    """(k, v, k_scale, v_scale) numpy arrays of one cache format."""
    if kind == "float":
        return [rng.normal(size=(L, s, b, H, DH)).astype(np.float32) for _ in range(2)] + [None, None]
    scales = [rng.random(size=(L, s, 1, BHPAD)).astype(np.float32) for _ in range(2)]
    if kind == "int8":
        return [rng.integers(-127, 128, size=(L, s, b, H, DH)).astype(np.int8) for _ in range(2)] + scales
    scales = [rng.random(size=(L, 4, s // 4, 1, BHPAD)).astype(np.float32) for _ in range(2)]
    return [_words(rng, (L, s // 4, b, H, DH)) for _ in range(2)] + scales


def _same(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _merge_both(kind, big, tmp, phys, rc, ru):
    """The port's and JAX's merge of one format -> (port arrays, JAX arrays)."""
    t = [torch.from_numpy(a.copy()) for a in big[:2]]
    merge, jmerge = ((fs.merge_slot_cache_packed, jfs.merge_slot_cache_packed) if kind == "packed"
                     else (fs.merge_slot_cache, jfs.merge_slot_cache))
    port = list(merge(*t, torch.from_numpy(tmp[0]), torch.from_numpy(tmp[1]), phys, rc, ru))
    ref = list(jmerge(jnp.asarray(big[0]), jnp.asarray(big[1]), jnp.asarray(tmp[0]), jnp.asarray(tmp[1]),
                      jnp.int32(phys), jnp.int32(rc), jnp.int32(ru)))
    if kind != "float":
        ts = [torch.from_numpy(a.copy()) for a in big[2:]]
        smerge, jsmerge = ((fs.merge_slot_scales_packed, jfs.merge_slot_scales_packed) if kind == "packed"
                           else (fs.merge_slot_scales, jfs.merge_slot_scales))
        port += smerge(*ts, torch.from_numpy(tmp[2]), torch.from_numpy(tmp[3]), phys, rc, ru, H)
        ref += jsmerge(jnp.asarray(big[2]), jnp.asarray(big[3]), jnp.asarray(tmp[2]), jnp.asarray(tmp[3]),
                       jnp.int32(phys), jnp.int32(rc), jnp.int32(ru), n_head=H)
    return port, ref


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("phys", [0, 37, 96, 112])
def test_merge_slot_cache_matches_jax(kind, phys):
    rng = np.random.default_rng(phys)
    big = _cache(rng, kind, 128, 2 * SLOTS)
    tmp = _cache(rng, kind, 16, 2)
    port, ref = _merge_both(kind, big, tmp, phys, 1, SLOTS + 1)
    for p, r in zip(port, ref):
        _same(p, r)
    # the landed span holds the temp rows, every other row is untouched
    span = slice(min(phys, 128 - 16), min(phys, 128 - 16) + 16)
    np.testing.assert_array_equal(port[0].numpy()[:, span, 1], tmp[0][:, :, 0])
    np.testing.assert_array_equal(port[0].numpy()[:, span, SLOTS + 1], tmp[0][:, :, 1])
    others = [r for r in range(2 * SLOTS) if r not in (1, SLOTS + 1)]
    np.testing.assert_array_equal(port[0].numpy()[:, :, others], big[0][:, :, others])


@pytest.mark.parametrize("phys", [4 * w + r for w in (0, 9, 27) for r in range(4)] + [112])
def test_merge_packed_matches_jax_at_every_residue(phys):
    """Residues 0-3 at the start, the middle and the end of the cache (the
    window's last word 31); 112 lands the span on the cache's last words."""
    s, tpad = 128, 16
    rng = np.random.default_rng(phys)
    big = _cache(rng, "packed", s, 2 * SLOTS)
    tmp = _cache(rng, "packed", tpad, 2)
    rc, ru = 2, SLOTS + 2
    port, ref = _merge_both("packed", big, tmp, phys, rc, ru)
    for p, r in zip(port, ref):
        _same(p, r)
    # byte by byte: the landed positions hold the temp's bytes, every other
    # byte of the row (the edge words' other lanes too) and every other row
    # keeps its bits
    def unpack(w):
        return w.view(np.uint8).reshape(*w.shape, 4)  # little-endian: byte j is position 4w+j

    got, was, src = unpack(port[0].numpy()), unpack(big[0]), unpack(tmp[0])
    pos_got = np.moveaxis(got, -1, 2).reshape(L, s, 2 * SLOTS, H, DH)
    pos_was = np.moveaxis(was, -1, 2).reshape(L, s, 2 * SLOTS, H, DH)
    pos_src = np.moveaxis(src, -1, 2).reshape(L, tpad, 2, H, DH)
    np.testing.assert_array_equal(pos_got[:, phys : phys + tpad, rc], pos_src[:, :, 0])
    np.testing.assert_array_equal(pos_got[:, phys : phys + tpad, ru], pos_src[:, :, 1])
    outside = np.ones(s, bool)
    outside[phys : phys + tpad] = False
    np.testing.assert_array_equal(pos_got[:, outside], pos_was[:, outside])
    others = [r for r in range(2 * SLOTS) if r not in (rc, ru)]
    np.testing.assert_array_equal(pos_got[:, :, others], pos_was[:, :, others])
    # the scales of position p sit at [p % 4, p // 4]
    ks = port[2].numpy()
    for t in (0, tpad - 1):
        p = phys + t
        np.testing.assert_array_equal(ks[:, p % 4, p // 4, 0, rc * H : rc * H + H],
                                      tmp[2][:, t % 4, t // 4, 0, :H])


@pytest.mark.parametrize("kind", ["float", "int8", "packed"])
@pytest.mark.parametrize("shift,pos", [(128, None), (128, 200), (256, 300), (0, 100), (128, 129), (64, 300)])
def test_shift_left_matches_jax(kind, shift, pos):
    s = 512
    rng = np.random.default_rng(shift + (pos or 0))
    big = _cache(rng, kind, s, 4)
    t = [torch.from_numpy(a.copy()) for a in big if a is not None]
    if kind == "packed":
        port = list(fs.shift_cache_left_packed(t[0], t[1], shift, pos))
        port += fs.shift_scales_left_packed(t[2], t[3], shift, pos)
        jp = None if pos is None else jnp.int32(pos)
        ref = list(jfs.shift_cache_left_packed(jnp.asarray(big[0]), jnp.asarray(big[1]), jnp.int32(shift), jp))
        ref += jfs.shift_scales_left_packed(jnp.asarray(big[2]), jnp.asarray(big[3]), jnp.int32(shift), jp)
    else:
        port = list(fs.shift_cache_left(t[0], t[1], shift, pos))
        jp = None if pos is None else jnp.int32(pos)
        ref = list(jfs.shift_cache_left(jnp.asarray(big[0]), jnp.asarray(big[1]), jnp.int32(shift), jp))
        if kind == "int8":
            port += fs.shift_scales_left(t[2], t[3], shift, pos)
            ref += jfs.shift_scales_left(jnp.asarray(big[2]), jnp.asarray(big[3]), jnp.int32(shift), jp)
    for p, r, orig in zip(port, ref, t):
        _same(p, r)
        assert p.data_ptr() == orig.data_ptr()  # in place
    # the valid prefix [shift, pos) now starts at 0
    end = s if pos is None else pos
    np.testing.assert_array_equal(port[0].numpy()[:, : (end - shift) // (4 if kind == "packed" else 1)],
                                  big[0][:, shift // (4 if kind == "packed" else 1) :
                                         end // (4 if kind == "packed" else 1)])


@pytest.mark.parametrize("pos", [None, 90])
def test_shift_left_roll_route_matches_jax(pos):
    """S = 96 is no multiple of the 128-position chunk: the roll route, exact
    for a shift of 37."""
    rng = np.random.default_rng(96)
    k, v = (rng.normal(size=(1, 96, 2, 2, 4)).astype(np.float32) for _ in range(2))
    port = fs.shift_cache_left(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()), 37, pos)
    ref = jfs.shift_cache_left(jnp.asarray(k), jnp.asarray(v), jnp.int32(37),
                               None if pos is None else jnp.int32(pos))
    for p, r in zip(port, ref):
        _same(p, r)
    np.testing.assert_array_equal(port[0].numpy()[:, : 96 - 37], k[:, 37:])
