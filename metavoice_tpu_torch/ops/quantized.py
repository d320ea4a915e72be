"""Weight-only quantization: the int4 and int8 serving formats in int32
words, their prefill matmul kernels' wrappers (K2, K8), the plain int8
format and its kernels' wrappers (K11, K10), and the kernels' plain PyTorch
versions.

Port of the int4-in-int32 and int8-in-int32 parts of
``metavoice_tpu/ops/quantized.py``. The on-disk layouts are kept exactly, so
a ``cli quantize`` ``.npz`` loads in both packages. int4:

  * ``pw`` (K/8, N) int32, "split-eighth" along the contraction dim: bits
    [4j, 4j+4) of word (k', n) hold q[j*K/8 + k', n] + 8, in [0, 15];
  * ``sc`` (2*Gp, N) bf16: rows [0, Gp) are the group scales s, rows
    [Gp, 2*Gp) the constants c = z - 7.5*s (Gp = K/groupsize rounded up to a
    multiple of 8; pad rows are zero).

Per K-group g of 128 rows, ``x_g @ W_g = s_g * (x_g @ nib_g) + sum(x_g) * c_g``,
so the raw nibbles (exact in bf16) go straight into the products and the
affine terms land in a per-group epilogue. Group g's rows are nibble
``j = g // (K/8/128)`` of word rows ``[(g mod (K/8/128))*128, +128)``: one
word holds one row of each of 8 groups.

int8 (``quantisation_mode="int8"``), one symmetric scale per output column:

  * ``p8`` (K/4, N) int32, "split-quarter": bits [8j, 8j+8) of word (k', n)
    hold q[j*K/4 + k', n] + 128, in [0, 255];
  * ``sc8`` (16, N) bf16: row 0 is s, row 8 is c = -128*s, the rest zero.

So ``x @ W = s * (x @ byte) + sum(x) * c``: the int4 identity with ONE group
spanning K.

Both matmuls are ``metavoice_tpu_torch/csrc/matmul_int4_i32.cu`` (one
template, two C entries), cut by :func:`prefill_plan`; a CUDA tensor
launches the kernel or raises, a CPU tensor takes the plain version
(:func:`matmul_int4_i32_reference`, :func:`matmul_int8_i32_reference`). K6, :func:`decode_ffn_int4`, one decode
layer's int4 SwiGLU FFN, replaces ``metavoice_tpu/ops/quantized.py:
decode_ffn_int4`` (the Pallas TPU kernel ``_ffn_int4_kernel``); its kernel
is ``metavoice_tpu_torch/csrc/decode_block_int4.cu``.

Plain int8 (``quantisation_mode="int8_plain"``, :func:`quantize_params_int8`):
``{"q": (L, K, N) int8, "scales": (L, N) f32}`` per layer weight, no padding,
the JAX package's layout. K11, :func:`matmul_int8`, replaces
``metavoice_tpu/ops/quantized.py:matmul_int8`` (``_int8_matmul_kernel``;
kernel in ``csrc/matmul_int8.cu``: the decode GEMV up to 8 rows
(:func:`int8_gemv_ok`), else the ring of tensor-core tiles shared with K12
and K13, cut by :func:`int8_tile_plan`); K10, :func:`ffn_int8`, one T = 1
SwiGLU FFN, replaces ``ffn_int8`` (``_ffn_int8_kernel``; kernel in
``csrc/decode_block_int8.cu``).

Groupwise int4, the JAX package's ``quantize_params_int4`` and ``_packed``
(the reference's own format, fam/llm/fast_quantize.py:70-148, g = 128 by
default): ``{"q": (L, K, N) int8 in [-8, 7], "scales", "zeros": (L, K/g, N)
f32}``, w = (q + 0.5) * s + z per group; or the values nibble-packed
split-half, ``{"p": (L, K/2, N) uint8, ...}``, the low nibble of byte (k, n)
holding q[k] + 8 and the high nibble q[k + K/2] + 8. No quantisation mode
builds them: a first stage holding them reaches ``TTS`` as it is. K12,
:func:`matmul_int4`, replaces ``metavoice_tpu/ops/quantized.py:matmul_int4``
(``_int4_matmul_kernel``) and K13, :func:`matmul_int4_packed`, replaces
``matmul_int4_packed`` (``_int4_packed_matmul_kernel``); both kernels are
``csrc/matmul_int4_grouped.cu``: y = bf16(x) @ bf16((q + 0.5) * s + z)
summed in f32, in x's dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from metavoice_tpu_torch.ops import _build

I32_GROUPSIZE = 128  # serving groupsize (reference default, fast_quantize.py:70)
DECODE_MAX_ROWS = 8  # rows of x the decode GEMVs take: their mma's N (csrc/decode_stack_gemv.cuh, matmul_int4_grouped.cu)
CARD_SMS = 132  # the H100's streaming multiprocessors
_QUANTIZABLE_LAYER_KEYS = ("wqkv", "wo", "w1", "w3", "w2", "w_fc", "w_proj")
_HIDDEN_OUT_KEYS = ("w1", "w3", "w_fc")  # hidden dim on the out axis


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def quantize_int4_grouped(w: torch.Tensor, groupsize: int = 128):
    """Asymmetric groupwise int4 (reference fast_quantize.py:70-132).

    w: (in, out) -> (q (in, out) int8 in [-8, 7], scales (n_groups, out),
    zeros (n_groups, out)) in f32; w ~= (q + 0.5) * scales + zeros per group.
    """
    in_dim, out_dim = w.shape
    if in_dim % groupsize != 0:
        raise ValueError(f"in_dim {in_dim} not divisible by groupsize {groupsize}")
    wg = w.float().reshape(in_dim // groupsize, groupsize, out_dim)
    w_min = torch.clamp(wg.amin(dim=1), max=0.0)  # (n_groups, out)
    w_max = torch.clamp(wg.amax(dim=1), min=0.0)
    scales = torch.clamp(w_max - w_min, min=1e-6) / 15.0
    zeros = w_min + scales * 7.5
    q = torch.clamp(torch.round((wg - w_min[:, None, :]) / scales[:, None, :] - 8.0), -8, 7)
    return q.to(torch.int8).reshape(in_dim, out_dim), scales, zeros


def pack_int4_i32(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 in [-8, 7] -> (K/8, N) int32, split-eighth slab layout."""
    k, n = q.shape
    if k % 8:
        raise ValueError(f"K={k} is not a multiple of 8")
    nib = (q.to(torch.int32) + 8).reshape(8, k // 8, n)  # slab j = rows [j*K/8, ...)
    word = nib[0].clone()
    for j in range(1, 8):
        word |= nib[j] << (4 * j)  # int32 wraps for j = 7, as in the JAX package
    return word


def unpack_int4_i32(pw: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_i32`: (K/8, N) int32 -> (K, N) int8 in [-8, 7]."""
    return torch.cat([(((pw >> (4 * j)) & 0xF) - 8).to(torch.int8) for j in range(8)], dim=0)


def quantize_int4_i32(w: torch.Tensor, groupsize: int = I32_GROUPSIZE):
    """(in, out) weights -> (pw (Kp/8, out) int32, sc (2*Gp, out) bf16).

    Kp is ``in`` padded to a multiple of 8*groupsize; groups made only of
    pad rows carry s = c = 0 and contribute nothing.
    """
    in_dim, out_dim = w.shape
    kp = _round_up(in_dim, 8 * groupsize)
    if kp != in_dim:
        w = torch.cat([w, w.new_zeros((kp - in_dim, out_dim))], dim=0)
    q, s, z = quantize_int4_grouped(w, groupsize)
    n_groups = kp // groupsize
    gp = _round_up(n_groups, 8)
    c = z - 7.5 * s
    if kp != in_dim:
        n_real = in_dim // groupsize + (in_dim % groupsize > 0)
        keep = (torch.arange(n_groups, device=w.device) < n_real)[:, None]
        s = torch.where(keep, s, torch.zeros_like(s))
        c = torch.where(keep, c, torch.zeros_like(c))
    pad = s.new_zeros((gp - n_groups, out_dim))
    sc = torch.cat([s, pad, c, pad], dim=0).to(torch.bfloat16)
    return pack_int4_i32(q), sc


def quantize_params_int4_i32(params: dict, groupsize: int = I32_GROUPSIZE) -> dict:
    """Param-tree quantizer for the int4 serving configuration.

    Stacked (L, in, out) layer weights become {"pw": (L, Kp/8, out) int32,
    "sc": (L, 2*Gp, out) bf16}; the FFN hidden dim is zero-padded inside the
    packed tensors (w1/w3 along out, w2 along in) to a multiple of
    8*groupsize, and the pad columns' ``sc`` is zeroed so they come out
    exactly 0. A single tied first-stage vocab whose width is a multiple of
    8*groupsize also gets ``lm_head_q``: wte^T packed with the vocab padded
    to a multiple of 1024 and zeroed pad columns (the fused head of the
    decode-stack kernel). The bf16 ``wtes`` stay for the embedding gather
    and the prefill head. Runs on the params' device.
    """
    out = dict(params)
    layers = dict(params["layers"])
    for key in _QUANTIZABLE_LAYER_KEYS:
        if key not in layers:
            continue
        w = layers[key]  # (L, in, out)
        n_real = w.shape[2]
        if key in _HIDDEN_OUT_KEYS:
            ip = _round_up(n_real, 8 * groupsize)
            if ip != n_real:
                w = torch.cat([w, w.new_zeros((w.shape[0], w.shape[1], ip - n_real))], dim=2)
        packed = [quantize_int4_i32(w[li], groupsize) for li in range(w.shape[0])]
        pw = torch.stack([p for p, _ in packed])
        sc = torch.stack([s for _, s in packed])
        if key in _HIDDEN_OUT_KEYS:
            col = torch.arange(sc.shape[2], device=sc.device) < n_real
            sc = torch.where(col[None, None, :], sc, torch.zeros_like(sc))
        layers[key] = {"pw": pw, "sc": sc}
    out["layers"] = layers
    wtes = params.get("wtes", ())
    if len(wtes) == 1 and "lm_heads" not in params and wtes[0].shape[1] % (8 * groupsize) == 0:
        wt = wtes[0].T  # (D, V)
        vocab = wt.shape[1]
        vp = _round_up(vocab, 1024)
        if vp != vocab:
            wt = torch.cat([wt, wt.new_zeros((wt.shape[0], vp - vocab))], dim=1)
        hpw, hsc = quantize_int4_i32(wt, groupsize)
        col = torch.arange(vp, device=hsc.device) < vocab
        out["lm_head_q"] = {"pw": hpw, "sc": torch.where(col[None, :], hsc, torch.zeros_like(hsc))}
    return out


def is_int4(w) -> bool:
    """True for a packed ``{"pw", "sc"}`` leaf."""
    return isinstance(w, dict) and "pw" in w and "sc" in w


def matmul_int4_i32_reference(x, pw, sc, groupsize: int = I32_GROUPSIZE):
    """Plain PyTorch version of the K2 kernel: (M, K) @ packed (K, N) -> (M, N) f32.

    The kernel's arithmetic (``_int4_group_matmul`` in the JAX package): x
    rounded to bf16; per group g, the f32 product of x_g and the raw nibbles
    (0..15), times s_g; plus ``bf16(sum x_g) * c_g`` with the group sum taken
    in f32. K must equal ``8 * pw.shape[0]`` (callers zero-pad x).
    """
    m, k = x.shape
    kp = 8 * pw.shape[0]
    if k != kp:
        raise ValueError(f"x has K={k}, the packed weight K={kp}")
    n = pw.shape[1]
    n_groups = kp // groupsize
    gp = sc.shape[0] // 2
    s = sc[:n_groups].float()
    c = sc[gp : gp + n_groups].float()
    xg = x.to(torch.bfloat16).float().reshape(m, n_groups, groupsize).transpose(0, 1)
    nib = torch.cat([(pw >> (4 * j)) & 0xF for j in range(8)], dim=0).float()
    d = torch.bmm(xg, nib.reshape(n_groups, groupsize, n))  # (G, M, N) per-group dots
    y = (d * s[:, None, :]).sum(0)
    xsum = xg.sum(-1).to(torch.bfloat16).float()  # (G, M)
    return y + xsum.T @ c


def matmul_int4_i32(x, pw, sc, groupsize: int = I32_GROUPSIZE):
    """(M, K) activations @ packed int4 (K, N) -> (M, N) f32 (K2).

    x: any float dtype (rounded to bf16); pw: (K/8, N) int32; sc: (2*Gp, N)
    bf16. A CUDA tensor launches the hand-written kernel or raises; a CPU
    tensor takes :func:`matmul_int4_i32_reference`.
    ``matmul_int4_i32.launches`` counts kernel launches.
    """
    if x.dim() != 2 or pw.dim() != 2 or sc.dim() != 2:
        raise ValueError(f"x, pw, sc must be 2-D, got {x.shape}, {pw.shape}, {sc.shape}")
    m, k = x.shape
    n = pw.shape[1]
    if k != 8 * pw.shape[0] or k % (8 * groupsize) or sc.shape[1] != n:
        raise ValueError(f"shapes x {tuple(x.shape)}, pw {tuple(pw.shape)}, sc {tuple(sc.shape)} do not fit")
    if sc.shape[0] < 2 * (k // groupsize):
        raise ValueError(f"sc has {sc.shape[0]} rows, K={k} needs 2 * {k // groupsize} at least")
    if len({x.device, pw.device, sc.device}) != 1:
        raise ValueError(f"x, pw, sc must share one device, got {x.device}, {pw.device}, {sc.device}")
    if x.device.type == "cpu":
        return matmul_int4_i32_reference(x, pw, sc, groupsize)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int4_i32 runs on cuda or cpu, not {x.device}")
    if pw.dtype != torch.int32 or sc.dtype != torch.bfloat16 or groupsize != I32_GROUPSIZE:
        raise ValueError(f"the kernel takes int32 pw, bf16 sc, groupsize 128; got {pw.dtype}, {sc.dtype}, {groupsize}")
    if n % 8:
        raise ValueError(f"the kernel takes N a multiple of 8, got {n}")
    xb = x.to(torch.bfloat16).contiguous()
    pw, sc = pw.contiguous(), sc.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    bm, _, split_wb, n_splits = prefill_plan(m, k, n, "i4")
    part, _, tickets = _prefill_scratch(n_splits, m, n, "i4", x.device, "matmul_int4_i32")
    err = _build.kernels().lib.mv_matmul_int4_i32(
        xb.data_ptr(), pw.data_ptr(), sc.data_ptr(), y.data_ptr(),
        m, k, n, sc.shape[0] // 2, bm // 16, split_wb, _ptr(part), _ptr(tickets), PREFILL_TICKETS,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"matmul_int4_i32 kernel launch failed: cudaError_t {err}")
    matmul_int4_i32.launches += 1
    return y


matmul_int4_i32.launches = 0


# ------------------------------------------------------------------ int8-in-int32

I8_GP = 8  # sc8 holds s at row 0 and c at row I8_GP (2 * I8_GP rows in all)
FFN_PAD = 1024  # the int8 packer pads the FFN hidden dim to a multiple of this
_HIDDEN_IN_KEYS = ("w2", "w_proj")  # hidden dim on the contraction axis


def quantize_int8(w: torch.Tensor):
    """Symmetric per-output-channel int8 (reference fast_quantize.py:38-67).

    w: (in, out) -> (q (in, out) int8, scales (out,) f32); w ~= q * scales.
    """
    w = w.float()
    scales = torch.clamp(w.abs().amax(dim=0), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scales), -128, 127)
    return q.to(torch.int8), scales


def pack_int8_i32(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 in [-128, 127] -> (K/4, N) int32, split-quarter layout."""
    k, n = q.shape
    if k % 4:
        raise ValueError(f"K={k} is not a multiple of 4")
    byte = (q.to(torch.int32) + 128).reshape(4, k // 4, n)  # slab j = rows [j*K/4, ...)
    word = byte[0].clone()
    for j in range(1, 4):
        word |= byte[j] << (8 * j)  # int32 wraps for j = 3, as in the JAX package
    return word


def unpack_int8_i32(p8: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int8_i32`: (K/4, N) int32 -> (K, N) int8."""
    return torch.cat([(((p8 >> (8 * j)) & 0xFF) - 128).to(torch.int8) for j in range(4)], dim=0)


def quantize_int8_i32(w: torch.Tensor):
    """(in, out) weights -> (p8 (Kp/4, out) int32, sc8 (16, out) bf16).

    Kp is ``in`` padded to a multiple of 4 with zero rows (bias byte 128,
    which the c term cancels for the zero activations callers pad with).
    """
    in_dim, out_dim = w.shape
    kp = _round_up(in_dim, 4)
    if kp != in_dim:
        w = torch.cat([w, w.new_zeros((kp - in_dim, out_dim))], dim=0)
    q, s = quantize_int8(w)
    sc = torch.zeros((2 * I8_GP, out_dim), dtype=torch.float32, device=w.device)
    sc[0] = s
    sc[I8_GP] = -128.0 * s
    return pack_int8_i32(q), sc.to(torch.bfloat16)


def quantize_params_int8_i32(params: dict) -> dict:
    """Param-tree quantizer for the packed-int8 serving mode.

    Stacked (L, in, out) layer weights become {"p8": (L, Kp/4, out) int32,
    "sc8": (L, 16, out) bf16}. The FFN hidden dim is zero-padded to a
    multiple of 1024 (w1/w3 along out, w2 along in), and the pad columns'
    ``sc8`` is zeroed so they come out exactly 0. No packed head: this mode
    keeps the bf16 tied head. Runs on the params' device.
    """
    out = dict(params)
    layers = dict(params["layers"])
    for key in _QUANTIZABLE_LAYER_KEYS:
        if key not in layers:
            continue
        w = layers[key]  # (L, in, out)
        n_real = w.shape[2]
        if key in _HIDDEN_OUT_KEYS and n_real % FFN_PAD:
            pad = _round_up(n_real, FFN_PAD) - n_real
            w = torch.cat([w, w.new_zeros((w.shape[0], w.shape[1], pad))], dim=2)
        if key in _HIDDEN_IN_KEYS and w.shape[1] % FFN_PAD:
            pad = _round_up(w.shape[1], FFN_PAD) - w.shape[1]
            w = torch.cat([w, w.new_zeros((w.shape[0], pad, w.shape[2]))], dim=1)
        packed = [quantize_int8_i32(w[li]) for li in range(w.shape[0])]
        p8 = torch.stack([p for p, _ in packed])
        sc8 = torch.stack([s for _, s in packed])
        if key in _HIDDEN_OUT_KEYS:
            col = torch.arange(sc8.shape[2], device=sc8.device) < n_real
            sc8 = torch.where(col[None, None, :], sc8, torch.zeros_like(sc8))
        layers[key] = {"p8": p8, "sc8": sc8}
    out["layers"] = layers
    return out


def is_int8_i32(w) -> bool:
    """True for a packed ``{"p8", "sc8"}`` leaf."""
    return isinstance(w, dict) and "p8" in w and "sc8" in w


def matmul_int8_i32_reference(x, p8, sc8):
    """Plain PyTorch version of the K8 kernel: (M, K) @ packed (K, N) -> (M, N) f32.

    The TPU kernel's arithmetic (``_int8_word_matmul`` in the JAX package):
    x rounded to bf16; ``bf16(sum x) * c`` with the sum in f32, then, slab by
    slab, the f32 product of x's slab and the raw bytes (0..255, exact in
    bf16) times s. K must equal ``4 * p8.shape[0]`` (callers zero-pad x).
    """
    m, k = x.shape
    kp = 4 * p8.shape[0]
    if k != kp:
        raise ValueError(f"x has K={k}, the packed weight K={kp}")
    gp = sc8.shape[0] // 2
    s, c = sc8[0].float(), sc8[gp].float()
    xb = x.to(torch.bfloat16).float()
    k4 = kp // 4
    y = xb.sum(-1, keepdim=True).to(torch.bfloat16).float() * c
    for j in range(4):
        byte = ((p8 >> (8 * j)) & 0xFF).float()
        y = y + (xb[:, j * k4 : (j + 1) * k4] @ byte) * s
    return y


def matmul_int8_i32(x, p8, sc8):
    """(M, K) activations @ packed int8 (K, N) -> (M, N) f32 (K8).

    x: any float dtype (rounded to bf16); p8: (K/4, N) int32; sc8:
    (2*Gp, N) bf16 with s at row 0 and c at row Gp. A CUDA tensor launches
    the hand-written kernel or raises; a CPU tensor takes
    :func:`matmul_int8_i32_reference`. ``matmul_int8_i32.launches`` counts
    kernel launches.
    """
    if x.dim() != 2 or p8.dim() != 2 or sc8.dim() != 2:
        raise ValueError(f"x, p8, sc8 must be 2-D, got {x.shape}, {p8.shape}, {sc8.shape}")
    m, k = x.shape
    n = p8.shape[1]
    if k != 4 * p8.shape[0] or sc8.shape[1] != n or sc8.shape[0] < 2 or sc8.shape[0] % 2:
        raise ValueError(f"shapes x {tuple(x.shape)}, p8 {tuple(p8.shape)}, sc8 {tuple(sc8.shape)} do not fit")
    if len({x.device, p8.device, sc8.device}) != 1:
        raise ValueError(f"x, p8, sc8 must share one device, got {x.device}, {p8.device}, {sc8.device}")
    if x.device.type == "cpu":
        return matmul_int8_i32_reference(x, p8, sc8)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int8_i32 runs on cuda or cpu, not {x.device}")
    if p8.dtype != torch.int32 or sc8.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes int32 p8 and bf16 sc8; got {p8.dtype}, {sc8.dtype}")
    if k % 32 or n % 8:
        raise ValueError(f"the kernel takes K a multiple of 32 and N of 8, got {k}, {n}")
    xb = x.to(torch.bfloat16).contiguous()
    p8, sc8 = p8.contiguous(), sc8.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    bm, _, split_wb, n_splits = prefill_plan(m, k, n, "i8")
    part, xpart, tickets = _prefill_scratch(n_splits, m, n, "i8", x.device, "matmul_int8_i32")
    err = _build.kernels().lib.mv_matmul_int8_i32(
        xb.data_ptr(), p8.data_ptr(), sc8.data_ptr(), y.data_ptr(),
        m, k, n, sc8.shape[0] // 2, bm // 16, split_wb, _ptr(part), _ptr(xpart), _ptr(tickets), PREFILL_TICKETS,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"matmul_int8_i32 kernel launch failed: cudaError_t {err}")
    matmul_int8_i32.launches += 1
    return y


matmul_int8_i32.launches = 0


# ------------------------------------------------------------------ K2 and K8: the plan

PREFILL_BN = 64  # output columns a block: 4 warps of 16 (csrc/matmul_int4_i32.cu kPfCols)
PREFILL_WORD_BLOCK = 128  # word rows a block stages at once (kPfWordBlock); splits hold whole ones
PREFILL_BLOCKS_PER_SM = 2  # blocks an SM the grid aims for: two 128-row blocks' shared memory fit an SM
PREFILL_PART_BYTES = 16 << 20  # a call's f32 partials at most (they stay in the 50 MB L2)
PREFILL_TICKETS = 4096  # merge counters a device: tiles (row x column) a split call
_prefill_tickets: dict = {}  # device index -> (PREFILL_TICKETS,) int32, all 0 between calls


def prefill_plan(m: int, k: int, n: int, wfmt: str) -> tuple[int, int, int, int]:
    """K2's (wfmt "i4") and K8's ("i8") cut of a call -> (bm, bn, split_wb,
    n_splits): a block takes a tile of bm rows (the fewest of 16, 32, 64
    and 128 that hold M, up to 128) by bn columns, over
    split_wb blocks of ``PREFILL_WORD_BLOCK`` word rows; split i holds word blocks
    ``[i * split_wb, (i + 1) * split_wb)``, the last ends at or past the
    last word block and none lies wholly past it. K2's word block holds one
    128-row group of each slab, so its groups stay whole in a split.

    The grid (tiles x splits) aims for ``PREFILL_BLOCKS_PER_SM`` blocks an
    SM: the fewest splits that reach it, or all the word blocks where they
    cannot; splits of nearly equal word blocks; the partials' f32 bytes
    within ``PREFILL_PART_BYTES``; and one split where the tiles exceed the
    merge counters."""
    if wfmt not in ("i4", "i8"):
        raise ValueError(f"wfmt must be 'i4' or 'i8', got {wfmt!r}")
    kw = k // (8 if wfmt == "i4" else 4)
    n_wb = -(-kw // PREFILL_WORD_BLOCK)
    bm = 16 if m <= 16 else 32 if m <= 32 else 64 if m <= 64 else 128
    tiles = -(-m // bm) * -(-n // PREFILL_BN)
    need = min(-(-CARD_SMS * PREFILL_BLOCKS_PER_SM // tiles), n_wb,
               max(1, PREFILL_PART_BYTES // (4 * m * n)))
    split_wb = n_wb
    if tiles <= PREFILL_TICKETS:
        for want in range(need, n_wb + 1):
            wb = -(-n_wb // want)
            if -(-n_wb // wb) * 4 * m * n > PREFILL_PART_BYTES and wb < n_wb:
                break
            split_wb = wb
            if -(-n_wb // wb) >= need:
                break
    return bm, PREFILL_BN, split_wb, -(-n_wb // split_wb)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _prefill_scratch(n_splits: int, m: int, n: int, wfmt: str, device, who: str):
    """One K2 / K8 call's merge scratch -> (part, xpart, tickets): none for
    one split; else f32 partials (splits, m, n), K8's f32 sums of x
    (splits, column tiles, m), both from the caching allocator on every call
    (so calls on other streams, and graph captures, each get their own), and
    the device's counters, made zero by the first call and left zero by
    every launch (:func:`merge_tickets`), taken on every call, so that a
    CUDA-graph capture before any eager call raises. Calls on one device
    must not overlap in time (one stream, or streams the caller orders)."""
    tickets = merge_tickets(_prefill_tickets, PREFILL_TICKETS, device, who)
    if n_splits == 1:
        return None, None, None
    part = torch.empty((n_splits * m * n,), dtype=torch.float32, device=device)
    xpart = None
    if wfmt == "i8":
        xpart = torch.empty((n_splits * -(-n // PREFILL_BN) * m,), dtype=torch.float32, device=device)
    return part, xpart, tickets


# ------------------------------------------------------------------ K6: one int4 SwiGLU FFN

def _ffn_scratch(vpw: int, b: int, d: int, ip: int, device, who: str):
    """One K6 (vpw 8) or K10 (vpw 1) call's plans and scratch -> (the plans
    as the C entry reads them, h (b, ip) bf16, f32 partials, the merge
    counters). The cut is ``decode_stack.ffn_plan``'s; h and the partials
    come from the caching allocator on every call; the counters are the
    decode GEMV's per-device table (``decode_stack._stack_tickets``, shared
    with K3/K7 and K5/K9), taken on every call, so that a CUDA-graph capture
    before any eager call raises (:func:`merge_tickets`). Calls on one
    device must not overlap in time."""
    from metavoice_tpu_torch.ops import decode_stack as DS  # decode_stack imports this module

    w13, w2, part = DS.ffn_plan(vpw, b, d, ip)
    if ip // DS.STACK_TILE_N > DS.STACK_TICKETS:
        raise ValueError(f"{who}: {ip // DS.STACK_TILE_N} column tiles exceed the {DS.STACK_TICKETS} merge counters")
    return ((ctypes.c_int * 6)(*w13, *w2), torch.empty((b, ip), dtype=torch.bfloat16, device=device),
            torch.empty((part,), dtype=torch.float32, device=device),
            merge_tickets(DS._stack_tickets, DS.STACK_TICKETS, device, who))


def decode_ffn_int4_reference(x, pw1, sc1, pw3, sc3, pw2, sc2, layer: int, groupsize: int = I32_GROUPSIZE):
    """Plain PyTorch version of K6: the CPU path and the card's oracle.

    The JAX kernel's arithmetic (``_ffn_int4_kernel``): ``h1 = x @ w1`` and
    ``h3 = x @ w3`` in f32 (the arithmetic of
    :func:`matmul_int4_i32_reference`, x rounded to bf16); ``h =
    bf16(silu(h1) * h3)`` with silu and the product in f32; ``y = h @ w2``
    with bf16(sum h_g) in the c term -> (B, D) f32."""
    h1 = matmul_int4_i32_reference(x, pw1[layer], sc1[layer], groupsize)
    h3 = matmul_int4_i32_reference(x, pw3[layer], sc3[layer], groupsize)
    h = (F.silu(h1) * h3).to(torch.bfloat16)
    return matmul_int4_i32_reference(h, pw2[layer], sc2[layer], groupsize)


def decode_ffn_int4(x, pw1, sc1, pw3, sc3, pw2, sc2, layer: int, groupsize: int = I32_GROUPSIZE):
    """One decode layer's int4 SwiGLU FFN (K6): (B, D) normed input -> (B, D) f32.

    ``pw1``/``pw3`` (L, D/8, Ip) and ``pw2`` (L, Ip/8, D) int32 with their
    ``sc`` (L, 2*Gp, N), stacked over layers; ``layer`` an int. A CUDA
    tensor launches the hand-written kernel (``csrc/decode_block_int4.cu``:
    1..8 rows, D and Ip multiples of 1024, groupsize 128; two chained
    launches of the tensor-core GEMV, :func:`_ffn_scratch`) or raises; a
    CPU tensor takes :func:`decode_ffn_int4_reference`.
    ``decode_ffn_int4.launches`` counts kernel launches (one a call).
    """
    if x.dim() != 2:
        raise ValueError(f"x must be (B, D), got {tuple(x.shape)}")
    b, d = x.shape
    n_layer, ip = pw1.shape[0], pw1.shape[2]
    for name, pw, sc, shape in (("w1", pw1, sc1, (n_layer, d // 8, ip)), ("w3", pw3, sc3, (n_layer, d // 8, ip)),
                                ("w2", pw2, sc2, (n_layer, ip // 8, d))):
        if tuple(pw.shape) != shape or sc.dim() != 3 or sc.shape[0] != n_layer or sc.shape[2] != shape[2]:
            raise ValueError(f"{name}: pw {tuple(pw.shape)} / sc {tuple(sc.shape)} do not fit {shape}")
    if not 0 <= layer < n_layer:
        raise ValueError(f"layer {layer} outside the {n_layer} stacked layers")
    tensors = (x, pw1, sc1, pw3, sc3, pw2, sc2)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"all tensors must share one device, got {sorted({str(t.device) for t in tensors})}")
    if x.device.type == "cpu":
        return decode_ffn_int4_reference(x, pw1, sc1, pw3, sc3, pw2, sc2, layer, groupsize)
    if x.device.type != "cuda":
        raise ValueError(f"decode_ffn_int4 runs on cuda or cpu, not {x.device}")
    if not 1 <= b <= DECODE_MAX_ROWS or d % 1024 or ip % 1024 or groupsize != I32_GROUPSIZE:
        raise ValueError(f"the kernel takes 1..{DECODE_MAX_ROWS} rows, D and Ip multiples of 1024, groupsize 128; "
                         f"got {b}, {d}, {ip}, {groupsize}")
    if any(pw.dtype != torch.int32 for pw in (pw1, pw3, pw2)) or any(
            sc.dtype != torch.bfloat16 for sc in (sc1, sc3, sc2)):
        raise ValueError("packed weights must be int32 pw and bf16 sc")
    if sc3.shape[1] != sc1.shape[1] or sc1.shape[1] < 2 * (d // 128) or sc2.shape[1] < 2 * (ip // 128):
        raise ValueError(f"sc rows: w1/w3 need the same 2*Gp >= {2 * (d // 128)}, w2 2*Gp >= {2 * (ip // 128)}")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("decode_ffn_int4 needs contiguous packed weights")
    dev = x.device
    xb = x.to(torch.bfloat16).contiguous()
    plans, h, part, tickets = _ffn_scratch(8, b, d, ip, dev, "decode_ffn_int4")
    y = torch.empty((b, d), dtype=torch.float32, device=dev)
    err = _build.kernels().lib.mv_decode_ffn_int4(
        xb.data_ptr(), pw1.data_ptr(), sc1.data_ptr(), pw3.data_ptr(), sc3.data_ptr(), pw2.data_ptr(),
        sc2.data_ptr(), y.data_ptr(), layer, b, d, ip, sc1.shape[1] // 2, sc2.shape[1] // 2,
        ctypes.addressof(plans), h.data_ptr(), part.data_ptr(), part.numel(), tickets.data_ptr(),
        tickets.numel(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_ffn_int4 kernel launch failed: cudaError_t {err}")
    decode_ffn_int4.launches += 1
    return y


decode_ffn_int4.launches = 0


# ------------------------------------------------------------------ plain int8: K11, K10

def quantize_params_int8(params: dict) -> dict:
    """Param-tree quantizer for ``quantisation_mode="int8_plain"`` (the JAX
    package's ``quantize_params_int8``): each stacked (L, in, out) layer
    weight becomes {"q": (L, in, out) int8, "scales": (L, out) f32}, with no
    padding. Embeddings, norms and the tied head stay as they are. Runs on
    the params' device."""
    out = dict(params)
    layers = dict(params["layers"])
    for key in _QUANTIZABLE_LAYER_KEYS:
        if key not in layers:
            continue
        per_layer = [quantize_int8(w) for w in layers[key]]
        layers[key] = {"q": torch.stack([q for q, _ in per_layer]), "scales": torch.stack([s for _, s in per_layer])}
    out["layers"] = layers
    return out


def is_int8_plain(w) -> bool:
    """True for a plain int8 ``{"q", "scales"}`` leaf (not the int4 ones that
    add ``"zeros"``)."""
    return isinstance(w, dict) and "q" in w and "scales" in w and "zeros" not in w


def int8_dot(x, q, scales):
    """K11's arithmetic in f32: x rounded to bf16, times the int8 weights
    (exact in bf16), summed in f32, times the column scale."""
    return (x.to(torch.bfloat16).float() @ q.float()) * scales.float()


def matmul_int8_reference(x, q, scales):
    """Plain PyTorch version of K11: (M, K) @ int8 (K, N) * scales (N,) ->
    (M, N) in x's dtype.

    The TPU kernel's arithmetic (``_int8_matmul_kernel``): x rounded to
    bf16, the products summed in f32, times the column scale, then cast to
    x's dtype. (The JAX package's ``matmul_int8_reference`` skips the bf16
    rounding of x; the port follows the kernel on every device.)"""
    return int8_dot(x, q, scales).to(x.dtype)


_OUT_CODE = {torch.bfloat16: 1, torch.float32: 0}


def int8_gemv_ok(m: int, k: int, n: int) -> bool:
    """Whether K11 takes m rows of x @ a (K, N) plain-int8 weight on the
    tensor-core decode GEMV (``csrc/decode_stack_gemv.cuh`` in its plain-int8
    form, cut by ``decode_stack.stack_gemv_plan``): 1..DECODE_MAX_ROWS rows,
    K a multiple of its k-step (16), N of FFN8_ALIGN (32-column tiles, two a
    cluster) and N's tiles within its merge counters. Any other call takes
    the ring of tensor-core tiles (:func:`int8_tile_plan`)."""
    from metavoice_tpu_torch.ops import decode_stack as DS  # decode_stack imports this module

    return (1 <= m <= DECODE_MAX_ROWS and k >= DS.STACK_STEP_ROWS and k % DS.STACK_STEP_ROWS == 0
            and n % FFN8_ALIGN == 0 and n // DS.STACK_TILE_N <= DS.STACK_TICKETS)


def int8_route(m: int, k: int, n: int) -> tuple[str, tuple[int, int, int]]:
    """K11's route and cut of a call: ``("gemv", (split_steps, n_splits,
    warps))`` from ``decode_stack.stack_gemv_plan(k, n, 1, m)`` where
    :func:`int8_gemv_ok`, else ``("ring", (bm, split_chunks, n_splits))``
    from :func:`int8_tile_plan`."""
    if int8_gemv_ok(m, k, n):
        from metavoice_tpu_torch.ops import decode_stack as DS

        return "gemv", DS.stack_gemv_plan(k, n, 1, m)
    return "ring", int8_tile_plan(m, k, n)


def _int8_scratch(route: str, cut: tuple[int, int, int], m: int, n: int, device):
    """One K11 call's merge scratch -> (f32 partials or None, the merge
    counters, their count). The partials come from the caching allocator on
    every call that splits K (the GEMV's ``splits x m x (n + 1)``, the ring's
    ``splits x m x n``); the counters are the device's table of the route,
    the decode GEMV's (``decode_stack._stack_tickets``, shared with K3/K7,
    K5/K9 and K6/K10) or the ring's (``_int4g_tickets``, shared with
    K12/K13), taken on every call, so that a CUDA-graph capture before any
    eager call on the device raises (:func:`merge_tickets`). Calls on one
    device must not overlap in time."""
    from metavoice_tpu_torch.ops import decode_stack as DS

    splits = cut[1] if route == "gemv" else cut[2]
    part = None
    if splits > 1:
        part = torch.empty((splits * m * (n + 1 if route == "gemv" else n),), dtype=torch.float32, device=device)
    if route == "gemv":
        return part, merge_tickets(DS._stack_tickets, DS.STACK_TICKETS, device, "matmul_int8"), DS.STACK_TICKETS
    return part, merge_tickets(_int4g_tickets, INT4G_TICKETS, device, "matmul_int8"), INT4G_TICKETS


def matmul_int8(x, q, scales):
    """(M, K) activations @ plain int8 (K, N) * scales (N,) -> (M, N) in x's
    dtype (K11).

    x: bf16 or f32 (rounded to bf16); q: (K, N) int8; scales: (N,) f32, q
    and scales contiguous and, like x, at 16-byte boundaries (a stacked
    weight's per-layer view is). A CUDA tensor launches the hand-written
    kernel (``csrc/matmul_int8.cu``, ``mv_matmul_int8``: K a multiple of 8,
    N of 16, any M; one launch a call, on the route and cut of
    :func:`int8_route`) or raises; a CPU tensor takes
    :func:`matmul_int8_reference`. ``matmul_int8.launches`` counts kernel
    launches, ``matmul_int8.gemv_launches`` those on the GEMV route.
    """
    if x.dim() != 2 or q.dim() != 2 or scales.dim() != 1:
        raise ValueError(f"x, q must be 2-D and scales 1-D, got {x.shape}, {q.shape}, {scales.shape}")
    m, k = x.shape
    n = q.shape[1]
    if q.shape[0] != k or scales.shape[0] != n:
        raise ValueError(f"shapes x {tuple(x.shape)}, q {tuple(q.shape)}, scales {tuple(scales.shape)} do not fit")
    if len({x.device, q.device, scales.device}) != 1:
        raise ValueError(f"x, q, scales must share one device, got {x.device}, {q.device}, {scales.device}")
    if x.device.type == "cpu":
        return matmul_int8_reference(x, q, scales)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int8 runs on cuda or cpu, not {x.device}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32 or x.dtype not in _OUT_CODE:
        raise ValueError(f"the kernel takes bf16/f32 x, int8 q and f32 scales; got {x.dtype}, {q.dtype}, "
                         f"{scales.dtype}")
    if k % 8 or n % 16:
        raise ValueError(f"the kernel takes K a multiple of 8 and N of 16, got {k}, {n}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("matmul_int8 needs contiguous q and scales")
    xb = x.to(torch.bfloat16).contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    for name, t in (("x", xb), ("q", q), ("scales", scales)):
        if t.data_ptr() % 16:
            raise ValueError(f"matmul_int8: {name} must start at a 16-byte boundary (the kernel's tensor maps "
                             f"and 16-byte copies read it there), not at {t.data_ptr():#x}")
    route, cut = int8_route(m, k, n)
    part, tickets, n_tickets = _int8_scratch(route, cut, m, n, x.device)
    gemv = route == "gemv"
    err = _build.kernels().lib.mv_matmul_int8(
        xb.data_ptr(), q.data_ptr(), scales.data_ptr(), y.data_ptr(), m, k, n, _OUT_CODE[x.dtype],
        cut[0] if gemv else 0, cut[1] if gemv else 0, 0 if gemv else cut[0] // 16, 0 if gemv else cut[1],
        _ptr(part), 0 if part is None else part.numel(), tickets.data_ptr(), n_tickets,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"matmul_int8 kernel launch failed ({route} route): cudaError_t {err}")
    matmul_int8.launches += 1
    matmul_int8.gemv_launches += gemv
    return y


matmul_int8.launches = 0
matmul_int8.gemv_launches = 0


FFN8_ALIGN = 64  # K10's D and I: the GEMV's column tiles, 32 a block and 2 a cluster, in both products


def ffn_int8_kernel_ok(m: int, d: int, i_sz: int) -> bool:
    """Whether K10's kernel takes m rows of a (D, I) FFN: 1..DECODE_MAX_ROWS
    rows, D and I multiples of FFN8_ALIGN. ``models/transformer._mlp``
    routes a T = 1 plain-int8 SwiGLU by it on every device, so the CPU and
    the card take the same route."""
    return 1 <= m <= DECODE_MAX_ROWS and d % FFN8_ALIGN == 0 and i_sz % FFN8_ALIGN == 0


def ffn_int8_reference(x, w1, s1, w3, s3, w2, s2):
    """Plain PyTorch version of K10: the CPU path and the card's oracle.

    The TPU kernel's arithmetic (``_ffn_int8_kernel``): ``h1 = x @ w1 * s1``
    and ``h3 = x @ w3 * s3`` as in :func:`matmul_int8_reference` but kept in
    f32; ``h = bf16(silu(h1) * h3)`` with silu and the product in f32; ``y =
    h @ w2 * s2`` -> (M, D) f32."""
    h = (F.silu(int8_dot(x, w1, s1)) * int8_dot(x, w3, s3)).to(torch.bfloat16)
    return int8_dot(h, w2, s2)


def ffn_int8(x, w1, s1, w3, s3, w2, s2):
    """One layer's plain-int8 SwiGLU FFN at T = 1 (K10): (M, D) -> (M, D) f32.

    w1, w3: (D, I) int8 with (I,) f32 scales; w2: (I, D) int8 with (D,) f32
    scales. A CUDA tensor launches the hand-written kernel
    (``csrc/decode_block_int8.cu``, ``mv_decode_ffn_int8``: two chained
    launches of the tensor-core GEMV in its plain-int8 form; the shapes of
    :func:`ffn_int8_kernel_ok`) or raises; a CPU tensor takes
    :func:`ffn_int8_reference`. ``ffn_int8.launches`` counts kernel launches
    (one a call).
    """
    if x.dim() != 2:
        raise ValueError(f"x must be (M, D), got {tuple(x.shape)}")
    m, d = x.shape
    i_sz = w1.shape[-1]
    for name, w, s, shape in (("w1", w1, s1, (d, i_sz)), ("w3", w3, s3, (d, i_sz)), ("w2", w2, s2, (i_sz, d))):
        if tuple(w.shape) != shape or tuple(s.shape) != (shape[1],):
            raise ValueError(f"{name}: q {tuple(w.shape)} / scales {tuple(s.shape)} do not fit {shape}")
    tensors = (x, w1, s1, w3, s3, w2, s2)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"all tensors must share one device, got {sorted({str(t.device) for t in tensors})}")
    if x.device.type == "cpu":
        return ffn_int8_reference(*tensors)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_int8 runs on cuda or cpu, not {x.device}")
    if not ffn_int8_kernel_ok(m, d, i_sz):
        raise ValueError(f"the kernel takes 1..{DECODE_MAX_ROWS} rows and D, I multiples of {FFN8_ALIGN}; got "
                         f"{m} rows, D {d}, I {i_sz}")
    if any(w.dtype != torch.int8 for w in (w1, w3, w2)) or any(s.dtype != torch.float32 for s in (s1, s3, s2)):
        raise ValueError("plain int8 weights must be int8 q with f32 scales")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("ffn_int8 needs contiguous weights and scales")
    dev = x.device
    xb = x.to(torch.bfloat16).contiguous()
    plans, h, part, tickets = _ffn_scratch(1, m, d, i_sz, dev, "ffn_int8")
    y = torch.empty((m, d), dtype=torch.float32, device=dev)
    err = _build.kernels().lib.mv_decode_ffn_int8(
        xb.data_ptr(), w1.data_ptr(), s1.data_ptr(), w3.data_ptr(), s3.data_ptr(), w2.data_ptr(), s2.data_ptr(),
        y.data_ptr(), m, d, i_sz, ctypes.addressof(plans), h.data_ptr(), part.data_ptr(), part.numel(),
        tickets.data_ptr(), tickets.numel(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ffn_int8 kernel launch failed: cudaError_t {err}")
    ffn_int8.launches += 1
    return y


ffn_int8.launches = 0


# ------------------------------------------------------------------ groupwise int4: K12, K13

INT4_KERNEL_MAX_ROWS = 256  # above this, _linear takes the dense f32 route, as the JAX package does
# the GEMV of up to DECODE_MAX_ROWS rows (int4g_plan): one launch a call, the
# splits of K merged by the last block of a column tile to finish
INT4G_STEP_K = 16  # k a k-step (the mma's depth)
INT4G_TILE_N = 64  # output columns a block (the kernel's kGemvCols: 8 lanes of 8)
INT4G_WARPS = 4  # warps a block (the kernel takes 1..8)
INT4G_BLOCKS_PER_SM = 3  # blocks an SM the grid aims for
INT4G_MIN_WARP_STEPS = 2  # fewest k-steps a warp, where K allows
INT4G_MAX_SPLITS = 32
INT4G_PART_SHARE = 0.1  # partials' bytes at most this share of the weights'
INT4G_TICKETS = 4096  # merge counters a device: column tiles (GEMV) or row x column tiles (ring) a call
_int4g_tickets: dict = {}  # device index -> (INT4G_TICKETS,) int32, all 0 between calls
# the ring of tensor-core tiles (more rows, or a groupsize off the k-step; int4g_tile_plan):
# one launch a call, K split on whole staged blocks, merged by the last block of a tile to finish
INT4G_RING_BN = 128  # output columns a block (the kernel's kRgCols)
INT4G_RING_CHUNK = 64  # rows of w a staged block (kRgChunk): K12 64 k, K13 64 k of each half
INT4G_RING_ROWS = (16, 32, 64, 128, 256)  # the tiles' rows (16 kMt)
INT4G_RING_BLOCKS_PER_SM = {16: 2, 32: 2, 64: 1, 128: 1, 256: 1}  # as the blocks' shared memory allows
INT4G_RING_PART_BYTES = 24 << 20  # a call's f32 partials at most (they stay in the 50 MB L2)
INT4G_RING_FILL = 0.5  # the grid holds at least this share of the card's block slots where the chunks allow
# the plan's model of a call on the card, in SM cycles, fitted to the times of every cut of the main shapes
# at M 16, 32, 64 and 256 (NVIDIA H100 80GB HBM3; PERF.md section 6): a block takes
# INT4G_STEP_CYCLES + INT4G_STEP_ROW_CYCLES x bm a consumer step (64 k; the producers' conversion sets
# the pace) and INT4G_START_CYCLES more; blocks run in waves of the card's block slots (whole waves at one
# block an SM; at two, a part of a wave costs its part); a call of more than one split adds bm x
# (INT4G_MERGE_ROW_CYCLES + INT4G_MERGE_SPLIT_ROW_CYCLES x splits) for the partials' writes and the merge
INT4G_STEP_CYCLES = 1150
INT4G_STEP_ROW_CYCLES = 11
INT4G_START_CYCLES = 1660
INT4G_MERGE_ROW_CYCLES = 106
INT4G_MERGE_SPLIT_ROW_CYCLES = 16
# K11's constants of the same model, fitted by `tools/ring_cuts.py --kernels K11 --fit` to the times of every
# cut of its ring at M 16, 32, 64 and 256 (H100, PERF.md section 6): a cheaper step (no affine), a dearer start
INT8_STEP_CYCLES = 1013
INT8_STEP_ROW_CYCLES = 4
INT8_START_CYCLES = 9209
INT8_MERGE_ROW_CYCLES = 38
INT8_MERGE_SPLIT_ROW_CYCLES = 12


def dequantize_int4_grouped(q: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, groupsize: int = 128):
    """(K, N) int8 in [-8, 7] with (K/groupsize, N) scales and zeros -> the
    f32 weights ``(q + 0.5) * s + z`` of each group."""
    k, n = q.shape
    qg = q.float().reshape(k // groupsize, groupsize, n)
    return ((qg + 0.5) * scales.float()[:, None, :] + zeros.float()[:, None, :]).reshape(k, n)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 in [-8, 7] -> (K/2, N) uint8, split-half: the low nibble
    of byte (k, n) holds q[k] + 8, the high nibble q[k + K/2] + 8."""
    k = q.shape[0]
    if k % 2:
        raise ValueError(f"K={k} is not even")
    biased = (q.to(torch.int32) + 8).to(torch.uint8)
    return biased[: k // 2] | (biased[k // 2 :] << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (K/2, N) uint8 -> (K, N) int8 in [-8, 7]."""
    return torch.cat([(p & 0xF).to(torch.int8) - 8, (p >> 4).to(torch.int8) - 8], dim=0)


def _quantize_params_grouped(params: dict, groupsize: int, packed: bool) -> dict:
    out = dict(params)
    layers = dict(params["layers"])
    for key in _QUANTIZABLE_LAYER_KEYS:
        if key not in layers:
            continue
        per_layer = [quantize_int4_grouped(w, groupsize) for w in layers[key]]
        q = torch.stack([q for q, _, _ in per_layer])
        leaf = {"p": torch.stack([pack_int4(t) for t in q])} if packed else {"q": q}
        leaf["scales"] = torch.stack([s for _, s, _ in per_layer])
        leaf["zeros"] = torch.stack([z for _, _, z in per_layer])
        layers[key] = leaf
    out["layers"] = layers
    return out


def quantize_params_int4(params: dict, groupsize: int = 128) -> dict:
    """The JAX package's ``quantize_params_int4``: each stacked (L, in, out)
    layer weight becomes {"q": (L, in, out) int8, "scales", "zeros": (L,
    in/groupsize, out) f32}. Embeddings, norms and the tied head stay as
    they are. Runs on the params' device."""
    return _quantize_params_grouped(params, groupsize, packed=False)


def quantize_params_int4_packed(params: dict, groupsize: int = 128) -> dict:
    """The JAX package's ``quantize_params_int4_packed``: as
    :func:`quantize_params_int4`, with the values nibble-packed split-half,
    {"p": (L, in/2, out) uint8, "scales", "zeros"}."""
    return _quantize_params_grouped(params, groupsize, packed=True)


def is_int4_grouped(w) -> bool:
    """True for a groupwise int4 leaf, ``{"q" | "p", "scales", "zeros"}``."""
    return isinstance(w, dict) and "zeros" in w and "scales" in w and ("q" in w or "p" in w)


def matmul_int4_reference(x, q, scales, zeros, groupsize: int = 128):
    """Plain PyTorch version of K12: (M, K) @ groupwise int4 (K, N) -> (M,
    N) in x's dtype.

    The TPU kernel's arithmetic (``_int4_matmul_kernel``): x rounded to
    bf16, the weights dequantized in f32 and rounded to bf16, the products
    summed in f32, then cast to x's dtype. (The JAX package's
    ``matmul_int4_reference`` keeps x and the weights in f32; the port
    follows the kernel on every device.)"""
    w = dequantize_int4_grouped(q, scales, zeros, groupsize).to(torch.bfloat16).float()
    return (x.to(torch.bfloat16).float() @ w).to(x.dtype)


def matmul_int4_packed_reference(x, p, scales, zeros, groupsize: int = 128):
    """Plain PyTorch version of K13: :func:`matmul_int4_reference` on the
    unpacked values (the TPU kernel's ``nib - 7.5`` equals ``q + 0.5``)."""
    return matmul_int4_reference(x, unpack_int4(p), scales, zeros, groupsize)


def int4g_plan(m: int, k: int, n: int, packed: bool) -> tuple[int, int, int]:
    """K12's and K13's GEMV (``csrc/matmul_int4_grouped.cu``, M <= 8): the cut
    of K's ``k / INT4G_STEP_K`` k-steps -> (split_steps, n_splits, warps).
    Split i holds steps ``[i * split_steps, (i + 1) * split_steps)``, the
    last ends at or past the last step and none lies wholly past it; a
    block of ``warps`` warps takes one split of a tile of ``INT4G_TILE_N``
    columns, each warp ``ceil(split_steps / warps)`` steps of it in a row.

    It aims for ``INT4G_BLOCKS_PER_SM`` blocks an SM over the grid (column
    tiles x splits), gives every warp at least ``INT4G_MIN_WARP_STEPS``
    steps where K allows, and keeps the partials' bytes (f32) within
    ``INT4G_PART_SHARE`` of the weights'."""
    steps = k // INT4G_STEP_K
    tiles = -(-n // INT4G_TILE_N)
    weight_bytes = k * n // (2 if packed else 1)
    by_part = int(INT4G_PART_SHARE * weight_bytes) // (4 * m * n)
    by_steps = steps // (INT4G_WARPS * INT4G_MIN_WARP_STEPS)
    want = round(CARD_SMS * INT4G_BLOCKS_PER_SM / tiles)
    n_splits = max(1, min(want, by_part, by_steps, INT4G_MAX_SPLITS))
    warps = max(1, min(INT4G_WARPS, steps // n_splits))
    split_steps = -(-steps // (n_splits * warps)) * warps
    return split_steps, -(-steps // split_steps), warps


def _ring_cost(bm: int, steps: int, n_splits: int, m: int, n: int, cycles: tuple) -> float:
    """The modelled SM cycles of a call of the ring: waves of blocks, each
    ``steps`` consumer steps and a start, then the partials' writes and the
    merge; ``cycles`` the format's (step, step a row, start, merge a row,
    merge a split and row) constants."""
    step, step_row, start, merge_row, merge_split_row = cycles
    tiles = -(-m // bm) * -(-n // INT4G_RING_BN)
    per_sm = INT4G_RING_BLOCKS_PER_SM[bm]
    waves = tiles * n_splits / (CARD_SMS * per_sm)
    waves = max(1.0, waves) if per_sm > 1 else math.ceil(waves)
    block = steps * (step + step_row * bm) + start
    merge = bm * (merge_row + merge_split_row * n_splits) if n_splits > 1 else 0
    return waves * block + merge


def _int4g_ring_cost(bm: int, split_chunks: int, n_splits: int, m: int, n: int, packed: bool) -> float:
    """K12's and K13's modelled SM cycles of a call of the ring (K13 walks
    two consumer steps a staged block)."""
    return _ring_cost(bm, split_chunks * (2 if packed else 1), n_splits, m, n,
                      (INT4G_STEP_CYCLES, INT4G_STEP_ROW_CYCLES, INT4G_START_CYCLES, INT4G_MERGE_ROW_CYCLES,
                       INT4G_MERGE_SPLIT_ROW_CYCLES))


def _int8_ring_cost(bm: int, split_chunks: int, n_splits: int, m: int, n: int) -> float:
    """K11's modelled SM cycles of a call of the ring, on its own constants."""
    return _ring_cost(bm, split_chunks, n_splits, m, n,
                      (INT8_STEP_CYCLES, INT8_STEP_ROW_CYCLES, INT8_START_CYCLES, INT8_MERGE_ROW_CYCLES,
                       INT8_MERGE_SPLIT_ROW_CYCLES))


def _ring_tile_plan(m: int, rows_w: int, n: int, cost) -> tuple[int, int, int]:
    """The ring's cut of a call over ``rows_w`` rows of w, the least
    ``cost(bm, split_chunks, n_splits)`` among the candidates that
    :func:`int4g_tile_plan` describes -> (bm, split_chunks, n_splits)."""
    n_chunks = -(-rows_w // INT4G_RING_CHUNK)
    bm0 = next(b for b in INT4G_RING_ROWS if b >= min(m, INT4G_RING_ROWS[-1]))
    best = None
    for bm in (bm0, bm0 // 2) if bm0 >= 128 else (bm0,):
        tiles = -(-m // bm) * -(-n // INT4G_RING_BN)
        for split_chunks in range(n_chunks, 0, -1):  # fewer splits first
            n_splits = -(-n_chunks // split_chunks)
            if n_splits > 1 and (tiles > INT4G_TICKETS or n_splits * m * n * 4 > INT4G_RING_PART_BYTES):
                break
            c = cost(bm, split_chunks, n_splits)
            slots = CARD_SMS * INT4G_RING_BLOCKS_PER_SM[bm]
            full = tiles * n_splits >= INT4G_RING_FILL * min(slots, tiles * n_chunks)
            if best is None or (full, -c) > (best[0], -best[1]):
                best = (full, c, bm, split_chunks, n_splits)
    return best[2:]


def int4g_tile_plan(m: int, k: int, n: int, packed: bool) -> tuple[int, int, int]:
    """K12's and K13's ring of tensor-core tiles (``csrc/matmul_ring.cuh``,
    ``int4g_ring_kernel``): the cut of a call -> (bm, split_chunks, n_splits).
    A block takes a tile of bm rows by ``INT4G_RING_BN`` columns over
    ``split_chunks`` staged blocks of ``INT4G_RING_CHUNK`` rows of w (K12's
    q rows, K13's packed rows: each feeds 64 k of both halves); split i
    holds staged blocks ``[i * split_chunks, (i + 1) * split_chunks)``, the
    last ends at or past the last one and none lies wholly past it.

    bm is the fewest rows of ``INT4G_RING_ROWS`` that hold M (at most 256:
    more rows take more row tiles), or half of it from 128 rows up (each
    weight is then converted twice, for a grid that fills the card with a
    cheaper merge). Of those tiles and every split count whose grid holds
    ``INT4G_RING_FILL`` of the card's block slots (``CARD_SMS`` x
    ``INT4G_RING_BLOCKS_PER_SM``) where the staged blocks allow, it takes
    the least modelled time (:func:`_int4g_ring_cost`), the fewest splits
    on a tie, with the partials' f32 bytes within ``INT4G_RING_PART_BYTES``
    and one split where the tiles exceed the merge counters."""
    return _ring_tile_plan(m, k // 2 if packed else k, n,
                           lambda bm, sc, ns: _int4g_ring_cost(bm, sc, ns, m, n, packed))


def int8_tile_plan(m: int, k: int, n: int) -> tuple[int, int, int]:
    """K11's cut of a call on the ring (``int4g_ring_kernel`` on plain int8
    q (K, N), staged blocks of 64 k) -> (bm, split_chunks, n_splits), chosen
    as :func:`int4g_tile_plan` chooses, by K11's own model
    (:func:`_int8_ring_cost`)."""
    return _ring_tile_plan(m, k, n, lambda bm, sc, ns: _int8_ring_cost(bm, sc, ns, m, n))


def _int4g_scratch(n_splits: int, m: int, n: int, device, tiles: int | None = None):
    """The partials and merge counters of one K12/K13 call -> (part,
    tickets): none for one split; else f32 partials of (splits, m, n), from
    the caching allocator on every call (so calls on other streams, and
    graph captures, each get their own), and the device's counters, one a
    tile (the GEMV's column tiles, or ``tiles`` of the ring), made zero by
    the first call and left zero by every launch (the last block of a tile
    resets its own; :func:`merge_tickets`; K11's ring shares them), taken on
    every call, so that a CUDA-graph capture before any eager call raises.
    Calls on one device must not overlap in time (one stream, or streams the
    caller orders), as for K1/K4's counters."""
    tickets = merge_tickets(_int4g_tickets, INT4G_TICKETS, device, "matmul_int4")
    if n_splits == 1:
        return None, None
    tiles = -(-n // INT4G_TILE_N) if tiles is None else tiles
    if tiles > INT4G_TICKETS:
        raise ValueError(f"{tiles} tiles exceed the {INT4G_TICKETS} merge counters")
    part = torch.empty((n_splits * m * n,), dtype=torch.float32, device=device)
    return part, tickets


def merge_tickets(table: dict, size: int, device, who: str) -> torch.Tensor:
    """The device's merge counters of a one-launch kernel (K1/K4, K12/K13)
    from ``table`` (device index -> (size,) int32): made zero by the first
    call and left zero by every launch. They cannot be made inside a
    CUDA-graph capture, where the zero fill would only be recorded and
    eager calls before the first replay would read unset counters: such a
    capture raises, and one eager call on the device before it makes them."""
    tickets = table.get(device.index)
    if tickets is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{who}: the merge counters are made by the first call on {device}, which must be "
                               "an eager call, not one inside a CUDA-graph capture")
        tickets = table[device.index] = torch.zeros((size,), dtype=torch.int32, device=device)
    return tickets


def _int4_grouped_kernel(x, w, scales, zeros, groupsize: int, packed: bool):
    """Launch ``mv_matmul_int4_grouped`` (csrc/matmul_int4_grouped.cu) on
    CUDA tensors -> (M, N) in x's dtype, or raise. Rows <= DECODE_MAX_ROWS
    with a groupsize that is a multiple of 16 take its tensor-core GEMV
    (:func:`int4g_plan`), other calls its ring of tensor-core tiles
    (:func:`int4g_tile_plan`); one launch a call either way."""
    name = "matmul_int4_packed" if packed else "matmul_int4"
    m, k = x.shape
    n = w.shape[1]
    wtype = torch.uint8 if packed else torch.int8
    if w.dtype != wtype or scales.dtype != torch.float32 or zeros.dtype != torch.float32 or x.dtype not in _OUT_CODE:
        raise ValueError(f"{name} takes bf16/f32 x, {wtype} weights and f32 scales and zeros; got {x.dtype}, "
                         f"{w.dtype}, {scales.dtype}, {zeros.dtype}")
    if k % 8 or n % 16:
        raise ValueError(f"{name}'s kernel takes K a multiple of 8 and N of 16, got {k}, {n}")
    xb = x.to(torch.bfloat16).contiguous()
    w, scales, zeros = w.contiguous(), scales.contiguous(), zeros.contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    split_steps = warps = mt = split_chunks = 0  # split_steps 0: the ring
    if m <= DECODE_MAX_ROWS and groupsize % INT4G_STEP_K == 0:
        split_steps, n_splits, warps = int4g_plan(m, k, n, packed)
        part, tickets = _int4g_scratch(n_splits, m, n, x.device)
    else:
        bm, split_chunks, n_splits = int4g_tile_plan(m, k, n, packed)
        mt = bm // 16
        part, tickets = _int4g_scratch(n_splits, m, n, x.device, -(-m // bm) * -(-n // INT4G_RING_BN))
    err = _build.kernels().lib.mv_matmul_int4_grouped(
        xb.data_ptr(), w.data_ptr(), scales.data_ptr(), zeros.data_ptr(), y.data_ptr(), m, k, n, groupsize,
        int(packed), _OUT_CODE[x.dtype], split_steps, warps, mt, split_chunks, _ptr(part), _ptr(tickets),
        INT4G_TICKETS, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    return y


def _check_int4_grouped(x, w, scales, zeros, groupsize: int, packed: bool):
    name = "matmul_int4_packed" if packed else "matmul_int4"
    if x.dim() != 2 or w.dim() != 2 or scales.dim() != 2 or zeros.dim() != 2:
        raise ValueError(f"{name}: x, weights, scales, zeros must be 2-D, got {x.shape}, {w.shape}, "
                         f"{scales.shape}, {zeros.shape}")
    k, n = x.shape[1], w.shape[1]
    if k != w.shape[0] * (2 if packed else 1) or groupsize < 1 or (k // (2 if packed else 1)) % groupsize \
            or tuple(scales.shape) != (k // groupsize, n) or zeros.shape != scales.shape:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, weights {tuple(w.shape)}, scales "
                         f"{tuple(scales.shape)}, zeros {tuple(zeros.shape)} do not fit groupsize {groupsize}"
                         + (" (K/2 must be a multiple of it)" if packed else ""))
    if len({x.device, w.device, scales.device, zeros.device}) != 1:
        raise ValueError(f"{name}: all tensors must share one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def matmul_int4(x, q, scales, zeros, groupsize: int = 128):
    """(M, K) activations @ groupwise int4 (K, N) -> (M, N) in x's dtype (K12).

    x: bf16 or f32 (rounded to bf16); q: (K, N) int8 in [-8, 7]; scales and
    zeros: (K/groupsize, N) f32. A CUDA tensor launches the hand-written
    kernel (``csrc/matmul_int4_grouped.cu``: K a multiple of 8, N of 16) or
    raises; a CPU tensor takes :func:`matmul_int4_reference`.
    ``matmul_int4.launches`` counts kernel launches."""
    _check_int4_grouped(x, q, scales, zeros, groupsize, packed=False)
    if x.device.type == "cpu":
        return matmul_int4_reference(x, q, scales, zeros, groupsize)
    y = _int4_grouped_kernel(x, q, scales, zeros, groupsize, packed=False)
    matmul_int4.launches += 1
    return y


matmul_int4.launches = 0


def matmul_int4_packed(x, p, scales, zeros, groupsize: int = 128):
    """(M, K) activations @ split-half nibble-packed int4 (K/2, N) -> (M, N)
    in x's dtype (K13). As :func:`matmul_int4`, with p (K/2, N) uint8 from
    :func:`pack_int4`; K/2 must be a multiple of groupsize, so that each
    group lies in one half. A CPU tensor takes
    :func:`matmul_int4_packed_reference`. ``matmul_int4_packed.launches``
    counts kernel launches."""
    _check_int4_grouped(x, p, scales, zeros, groupsize, packed=True)
    if x.device.type == "cpu":
        return matmul_int4_packed_reference(x, p, scales, zeros, groupsize)
    y = _int4_grouped_kernel(x, p, scales, zeros, groupsize, packed=True)
    matmul_int4_packed.launches += 1
    return y


matmul_int4_packed.launches = 0
