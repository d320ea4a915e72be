"""The functional transformer core for both TTS stages, in PyTorch.

Port of the dense path of metavoice_tpu/models/transformer.py. Parameters
are the JAX package's pytree as plain dicts of tensors:

  * layer weights are stacked along a leading L axis and the block stack is
    a Python loop over layer views;
  * every linear weight is stored (in, out), so a projection is ``x @ w``;
  * the KV cache is a pair of sequence-major (L, S, B, H, Dh) tensors: float,
    or int8 with per-(slot, row, kv head) f32 scales, or those int8 values
    packed four slots to an int32 word (``KVCache``, the JAX layouts).

Unlike the JAX package, which threads the cache functionally, the cache is
updated IN PLACE: prefill writes its window of rows, and a T=1 decode step
writes its row inside the decode-attention kernel
(ops/attention.py:decode_attention, a hand-written CUDA kernel on the card;
a GQA model's step goes to the multi-query kernel at T = 1). A cached
forward of 1 < T <= 16 tokens (the speculative verify) writes its rows and
attends inside the multi-query kernel (ops/attention.py:
decode_attention_multi), on every device: its plain version on the CPU.
Norms run in f32 and round to the compute dtype before the weight multiply;
attention scores and softmax are f32; the output heads accumulate in f32.

Training (training/finetune.py) runs the no-cache forward under autograd: each
layer is recomputed in the backward pass (``torch.utils.checkpoint``, the JAX
package's per-layer ``jax.checkpoint``) whenever it has something to
differentiate, and ``forward(dropout_generator=...)`` turns on ``cfg.dropout``
on the embedding sum and on the attention and MLP residual branches. The
no-cache loop takes the stacked layer weights, or a list of per-layer weight
dicts (the finetune step's frozen head and trainable tail, never
concatenated).

int4 serving (``ops/quantized.quantize_params_int4_i32``): a linear weight
may be a packed ``{"pw", "sc"}`` leaf, which ``_linear`` runs through the
int4 matmul kernel (prefill). A T=1 step whose layer weights are int4 runs
all layers in one decode-stack kernel (ops/decode_stack.py), with the final
norm and the int4 tied head fused in when asked. The port follows that
kernel's semantics on every device, the CPU included (its plain version);
the JAX package's CPU route instead runs per-layer reference matmuls and
the bf16 head. A step that neither the decode-stack kernel nor the
per-layer kernels take (``int4_decode_route`` -> ``"unfused"``: a width off
the 1024 grid, more than 8 rows) runs that per-layer route: ``_linear``
(K2 on the card) and the decode attention, then the bf16 tied head.

int8 serving (``ops/quantized.quantize_params_int8_i32``): ``{"p8", "sc8"}``
leaves run through the int8 matmul kernel in ``_linear``. A T=1 step whose
layers meet the decode-stack kernel's conditions (the JAX package's) runs
all layers in its int8 form, then the final norm and the bf16 tied head;
otherwise each layer runs ``_linear`` at M = B and the decode-attention
kernel, as in the JAX package.

Plain int8 (``ops/quantized.quantize_params_int8``, ``quantisation_mode=
"int8_plain"``): ``{"q", "scales"}`` leaves run through the plain-int8
matmul kernel (K11) in ``_linear``, on every device (its plain version on
the CPU). A T=1 step of an MHA model on a bf16 cache runs each layer's
attention block in one kernel (ops/attention.py:decode_attention_block_int8,
K9: qkv, the new row, attention, o-proj) where ``int8_block_ok`` holds, and
its FFN in another (ops/quantized.py:ffn_int8, K10) whenever w1, w3 and w2
are plain int8 and ``ffn_int8_kernel_ok`` holds (D and the FFN width
multiples of 64); other T=1 layers take K11 and the decode attention. The
JAX package takes K9/K10 only on the TPU; the port follows the kernels on
every device.

Groupwise int4 (``ops/quantized.quantize_params_int4`` and ``_packed``, the
JAX package's trees, taken with ``quantisation_mode=None``): ``{"q" | "p",
"scales", "zeros"}`` leaves run through K12 (``matmul_int4``) or K13
(``matmul_int4_packed``) in ``_linear`` at up to 256 rows, on every device
(their plain versions on the CPU), and through a dense f32 dequantization
above that, as in the JAX package. They have no fused T = 1 route: a step
runs each layer's five projections through ``_linear`` and the decode
attention.

A quantized KV cache: prefill, and any cached forward of T <= 16, quantize
the window's rows (``quantize_kv_rows``) and attend over the dequantized
layer, as the JAX package's XLA path does. A T=1 step with int4 weights runs
per layer (``int4_decode_route``, where the kernels take its shape): the attention-block kernel
(ops/attention.py:decode_attention_block_int4, which quantizes and writes the
new row and attends over the int8 window) and the FFN kernel
(ops/quantized.py:decode_ffn_int4), then the bf16 tied head; with bf16 or
int8 weights it takes the dequantizing path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.core.device import resolve_device
from metavoice_tpu_torch.ops.attention import (
    MULTI_MAX_T,
    decode_attention,
    decode_attention_block_int4,
    decode_attention_block_int8,
    decode_attention_multi,
)
from metavoice_tpu_torch.ops.decode_stack import HEAD_DIM, MAX_BATCH, decode_stack_int4
from metavoice_tpu_torch.ops.quantized import (
    DECODE_MAX_ROWS,
    INT4_KERNEL_MAX_ROWS,
    decode_ffn_int4,
    dequantize_int4_grouped,
    ffn_int8,
    ffn_int8_kernel_ok,
    is_int4,
    is_int4_grouped,
    is_int8_i32,
    is_int8_plain,
    matmul_int4,
    matmul_int4_i32,
    matmul_int4_packed,
    matmul_int8,
    matmul_int8_i32,
    unpack_int4,
)

Params = dict[str, Any]


KV_PACK = 4  # sequence positions per int32 word in the packed int8 cache


@dataclass
class KVCache:
    """Static-shape per-layer KV cache, layout (L, S, B, H_kv, Dh), updated in
    place. Three formats, the JAX package's layouts:

      * float (bf16 on the serving path), ``k_scale is None``;
      * int8 (``dtype=torch.int8`` or ``"int8"``): int8 values with one f32
        absmax scale per (position, batch row, kv head) in ``k_scale``/
        ``v_scale`` (L, S, 1, kv_scale_width(B*H_kv)), column ``b*H_kv + h``,
        the padding columns zero;
      * packed (``"int8_packed"``): the same int8 values four positions to an
        int32 word, k/v (L, S/4, B, H_kv, Dh) with byte j of word w holding
        position 4w+j, and residue-split scales (L, 4, S/4, 1, BHpad): the
        scale of position p at [:, p % 4, p // 4].

    The int8 formats halve the cache's bytes (a capacity feature, as in the
    JAX package: on the card it buys no decode speed)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(
        cls,
        cfg: TransformerConfig,
        batch_size: int,
        max_seq_len: int | None = None,
        dtype=torch.bfloat16,
        device="cuda",
    ) -> "KVCache":
        s = max_seq_len or cfg.block_size
        shape = (cfg.n_layer, s, batch_size, cfg.n_local_heads, cfg.head_dim)
        dev = resolve_device(device)
        if isinstance(dtype, str):
            # strings select a format: "int8" is the scale-table cache, never
            # a scale-less raw int8 one
            if dtype not in ("int8", "int8_packed"):
                raise ValueError(
                    f"unknown KV cache dtype string {dtype!r}; expected 'int8', 'int8_packed', or a torch dtype"
                )
            dtype = torch.int8 if dtype == "int8" else dtype
        width = kv_scale_width(batch_size * cfg.n_local_heads)
        if dtype == torch.int8:
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=dev),
                v=torch.zeros(shape, dtype=torch.int8, device=dev),
                k_scale=torch.zeros((cfg.n_layer, s, 1, width), dtype=torch.float32, device=dev),
                v_scale=torch.zeros((cfg.n_layer, s, 1, width), dtype=torch.float32, device=dev),
            )
        if dtype == "int8_packed":
            if s % KV_PACK:
                raise ValueError(f"packed int8 cache needs seq len % {KV_PACK} == 0, got {s}")
            wshape = (cfg.n_layer, s // KV_PACK, *shape[2:])
            sshape = (cfg.n_layer, KV_PACK, s // KV_PACK, 1, width)
            return cls(
                k=torch.zeros(wshape, dtype=torch.int32, device=dev),
                v=torch.zeros(wshape, dtype=torch.int32, device=dev),
                k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
                v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            )
        if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
            raise ValueError(f"a KV cache is float, int8, 'int8' or 'int8_packed', got {dtype!r}")
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
        )

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[1] * (KV_PACK if self.packed else 1)

    @property
    def batch_size(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def packed(self) -> bool:
        """int8-in-int32 packed cache (4 positions per word along S)."""
        return self.k_scale is not None and self.k.dtype == torch.int32


def kv_scale_width(bh: int) -> int:
    """Column count of the int8-cache scale tables: B*H_kv rounded up to 128."""
    return -(-bh // 128) * 128


def pack_kv_s(q8: torch.Tensor) -> torch.Tensor:
    """(T, ...) int8 rows (T % 4 == 0) -> (T/4, ...) int32 words; word w holds
    positions 4w..4w+3 in bytes 0..3 (little-endian). Inverse of unpack_kv_s."""
    t = q8.shape[0]
    if t % KV_PACK:
        raise ValueError(f"pack_kv_s takes a multiple of {KV_PACK} rows, got {t}")
    b = (q8.to(torch.int32) & 0xFF).reshape(t // KV_PACK, KV_PACK, *q8.shape[1:])
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)  # byte 3 wraps, as in JAX


def unpack_kv_s(words: torch.Tensor) -> torch.Tensor:
    """(Sw, ...) int32 words -> (4*Sw, ...) int32 sign-extended int8 values."""
    parts = [(words << (24 - 8 * j)) >> 24 for j in range(KV_PACK)]
    return torch.stack(parts, dim=1).reshape(words.shape[0] * KV_PACK, *words.shape[1:])


def packed_kv_update(words_full: torch.Tensor, q8_rows: torch.Tensor, li: int, pos) -> torch.Tensor:
    """Write T int8 rows into the packed (L, Sw, B, H, Dh) int32 cache at
    positions [pos, pos+T) of layer ``li``, IN PLACE: a read-modify-write of
    the touched words, right at any alignment of ``pos``. ``pos`` may be a
    one-element int tensor on the cache's device for one row (T = 1), read
    on the device: the same read-modify-write of word pos // 4."""
    t = q8_rows.shape[0]
    if isinstance(pos, torch.Tensor):
        if t != 1:
            raise ValueError(f"a device pos writes one row, got {t}")
        p = pos.reshape(1).long()
        vals = unpack_kv_s(words_full[li].index_select(0, p // KV_PACK))  # (4, B, H, Dh)
        vals.index_copy_(0, p % KV_PACK, q8_rows.to(torch.int32))
        words_full[li].index_copy_(0, p // KV_PACK, pack_kv_s(vals))
        return words_full
    w0, w1 = pos // KV_PACK, -(-(pos + t) // KV_PACK)
    vals = unpack_kv_s(words_full[li, w0:w1])
    vals[pos - KV_PACK * w0 : pos - KV_PACK * w0 + t] = q8_rows.to(torch.int32)
    words_full[li, w0:w1] = pack_kv_s(vals)
    return words_full


def packed_scale_update(table: torch.Tensor, s_rows: torch.Tensor, li: int, pos: int) -> torch.Tensor:
    """Residue-split scale table (L, 4, Sw, 1, BHpad): write the (T, BH) f32
    scales of positions [pos, pos+T) of layer ``li`` IN PLACE (any
    alignment; the padding columns are written as zeros). ``pos`` may be a
    one-element int tensor on the table's device, read on the device."""
    t, bh = s_rows.shape
    p = pos + torch.arange(t, device=table.device)
    rows = torch.zeros((t, table.shape[-1]), dtype=torch.float32, device=table.device)
    rows[:, :bh] = s_rows.float()
    table[li, p % KV_PACK, p // KV_PACK, 0] = rows
    return table


def packed_kv_dequant(words_full: torch.Tensor, table: torch.Tensor, li: int, dtype=torch.float32) -> torch.Tensor:
    """Dequantize layer ``li`` of the packed cache to (S, B, H, Dh)."""
    _, sw, b, h, _ = words_full.shape
    vals = unpack_kv_s(words_full[li]).float()  # (S, B, H, Dh)
    sc = table[li, :, :, 0, : b * h]  # (4, Sw, BH)
    sc = sc.transpose(0, 1).reshape(sw * KV_PACK, b, h, 1)
    return (vals * sc).to(dtype)


def quantize_kv_rows(w: torch.Tensor):
    """(..., Dh) f32/bf16 -> (int8 values, (..., 1) f32 absmax scales):
    ``s = max(absmax, 1e-8) / 127``, ``q = clip(round_half_even(w / s))``."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s


def _dequant_int8_layer(cache: torch.Tensor, table: torch.Tensor, li: int, dtype) -> torch.Tensor:
    """Layer ``li`` of the int8 cache (L, S, B, H, Dh) with its (L, S, 1,
    BHpad) scales -> (S, B, H, Dh)."""
    s, b, h = cache.shape[1:4]
    sc = table[li, :, 0, : b * h].reshape(s, b, h, 1)
    return (cache[li].float() * sc).to(dtype)


def init_params(
    cfg: TransformerConfig,
    *,
    device="cuda",
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random-normal(0.02) init in the JAX package's layout (reference
    fam/llm/model.py:170-176); output projections use 0.02/sqrt(2L)."""
    dev = resolve_device(device)

    def normal(*shape, std=0.02):
        w = torch.randn(shape, dtype=torch.float32, device=dev, generator=generator)
        return (w * std).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    d, i_sz, l = cfg.dim, cfg.intermediate_size, cfg.n_layer
    qkv_out = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim
    out_std = 0.02 / (2 * l) ** 0.5
    layers = {
        "attn_norm_w": ones(l, d),
        "wqkv": normal(l, d, qkv_out),
        "wo": normal(l, d, d, std=out_std),
        "ffn_norm_w": ones(l, d),
    }
    if cfg.nonlinearity_type == "swiglu":
        layers["w1"] = normal(l, d, i_sz)
        layers["w3"] = normal(l, d, i_sz)
        layers["w2"] = normal(l, i_sz, d, std=out_std)
    elif cfg.nonlinearity_type == "gelu":
        layers["w_fc"] = normal(l, d, 4 * d)
        layers["w_proj"] = normal(l, 4 * d, d, std=out_std)
    else:
        raise ValueError(f"unknown nonlinearity {cfg.nonlinearity_type}")
    params: Params = {
        "wtes": [normal(v, d) for v in cfg.vocab_sizes],
        "wpe": normal(cfg.block_size, d),
        "layers": layers,
        "ln_f_w": ones(d),
    }
    if cfg.bias:
        layers["attn_norm_b"] = zeros(l, d)
        layers["ffn_norm_b"] = zeros(l, d)
        layers["wqkv_b"] = zeros(l, qkv_out)
        layers["wo_b"] = zeros(l, d)
        if cfg.nonlinearity_type == "gelu":
            layers["w_fc_b"] = zeros(l, 4 * d)
            layers["w_proj_b"] = zeros(l, d)
        params["ln_f_b"] = zeros(d)
    if cfg.speaker_emb_dim:
        params["speaker_cond"] = normal(cfg.speaker_emb_dim, d)
    if cfg.target_vocab_sizes is not None:
        params["lm_heads"] = [normal(d, v) for v in cfg.target_vocab_sizes]
    # else: heads are weight-tied to wtes (fam/llm/model.py:139-143)
    return params


# --------------------------------------------------------------------------------------
# Building blocks
# --------------------------------------------------------------------------------------


def _norm(x, w, b, norm_type: str, eps: float):
    """RMSNorm / LayerNorm in f32, cast to x.dtype, THEN times the weight.
    LayerNorm's eps is 1e-5 whatever ``eps`` says, as in the JAX package."""
    xf = x.float()
    if norm_type == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    elif norm_type == "layernorm":
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        xf = (xf - mean) * torch.rsqrt(var + 1e-5)
    else:
        raise ValueError(norm_type)
    out = xf.to(x.dtype) * w.to(x.dtype)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def _linear(x, w, b=None):
    """Dense (in, out) projection in x's dtype; a plain int8 one through K11
    (x's dtype out); a groupwise int4 one through K12 (``{"q", "scales",
    "zeros"}``) or K13 (``{"p", "scales", "zeros"}``), x's dtype out, the
    groupsize K / scales rows; or a packed int4 or int8 one through
    its matmul kernel (f32 out, cast to x's dtype). The packers pad K (int4
    to a multiple of 1024, int8 to one of 4, and the FFN hidden dim to one
    of 1024); narrower activations are zero-padded to it, which adds nothing
    (int4 pad groups carry s = c = 0; int8 pad rows meet zero x both in the
    byte product and in sum(x)).

    Groupwise int4 at more than INT4_KERNEL_MAX_ROWS rows takes the JAX
    package's route on every device (its TPU kernels hold the whole (M, K)
    block in VMEM): the weights dequantized in f32, an f32 product, cast to
    x's dtype."""
    if is_int8_plain(w):
        y = matmul_int8(x.reshape(-1, x.shape[-1]), w["q"], w["scales"]).reshape(*x.shape[:-1], -1)
    elif is_int4_grouped(w):
        x2 = x.reshape(-1, x.shape[-1])
        s, z = w["scales"], w["zeros"]
        gs = x2.shape[1] // s.shape[0]
        if x2.shape[0] > INT4_KERNEL_MAX_ROWS:
            q = unpack_int4(w["p"]) if "p" in w else w["q"]
            y = (x2.float() @ dequantize_int4_grouped(q, s, z, gs)).to(x.dtype)
        elif "p" in w:
            y = matmul_int4_packed(x2, w["p"], s, z, gs)
        else:
            y = matmul_int4(x2, w["q"], s, z, gs)
        y = y.reshape(*x.shape[:-1], -1)
    elif is_int4(w) or is_int8_i32(w):
        kp, matmul, words, scales = ((8 * w["pw"].shape[0], matmul_int4_i32, w["pw"], w["sc"]) if is_int4(w)
                                     else (4 * w["p8"].shape[0], matmul_int8_i32, w["p8"], w["sc8"]))
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if x2.shape[-1] < kp:
            x2 = F.pad(x2, (0, kp - x2.shape[-1]))
        y = matmul(x2, words, scales).reshape(*lead, -1).to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: identity forward; backward, the gradient all-reduced
    (summed) over the tensor group. On the normed input of the column-
    parallel products, whose gradient each rank holds only its heads' or
    FFN slice's share of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: forward, the row-parallel partial sums all-reduced over
    the tensor group; backward, the identity (every rank holds the whole
    gradient of the reduced sum). ``torch.distributed.nn.functional.
    all_reduce`` is not this: its backward reduces again, which would make
    the row-parallel gradients tp times too large."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _records(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _tp_copy(x, tp):
    """Megatron's f on ``x`` when autograd records it under TP, else x."""
    return _CopyToTP.apply(x, tp) if tp is not None and _records(x) else x


def _tp_sum(y, tp):
    """Megatron's reduction: a row-parallel product's partial sums (each
    rank's share of the input features) summed over the tensor group ``tp``
    (a ``torch.distributed`` process group); every rank gets the same bits.
    When autograd records y, Megatron's g (``_ReduceFromTP``), else in place
    (inference: one reduction, no copy). ``tp`` None: y as it is."""
    if tp is None:
        return y
    if _records(y):
        return _ReduceFromTP.apply(y, tp)
    y = y.contiguous()
    dist.all_reduce(y, group=tp)
    return y


def _add_bias(y, b):
    return y if b is None else y + b.to(y.dtype)


def _mlp(x, lp: Params, cfg: TransformerConfig, tp=None):
    """SwiGLU or exact-GELU FFN. At T = 1 with plain int8 w1, w3 and w2 on
    rows and widths K10's kernel takes (``ffn_int8_kernel_ok``, on every
    device), SwiGLU runs through K10 (f32 out, cast to x's dtype); else each
    product takes ``_linear``. ``tp``: the down projection's partial sums
    are reduced over the tensor group (``_tp_sum``) before its bias."""
    if cfg.nonlinearity_type == "swiglu":
        w1, w3, w2 = lp["w1"], lp["w3"], lp["w2"]
        rows = x.numel() // x.shape[-1]
        if (x.shape[-2] == 1 and all(is_int8_plain(w) for w in (w1, w3, w2))
                and ffn_int8_kernel_ok(rows, *w1["q"].shape[-2:])):
            y = ffn_int8(x.reshape(rows, -1), w1["q"], w1["scales"], w3["q"], w3["scales"], w2["q"], w2["scales"])
            return _tp_sum(y.reshape(x.shape).to(x.dtype), tp)
        return _tp_sum(_linear(F.silu(_linear(x, w1)) * _linear(x, w3), w2), tp)
    y = _linear(F.gelu(_linear(x, lp["w_fc"], lp.get("w_fc_b")), approximate="none"), lp["w_proj"])
    return _add_bias(_tp_sum(y, tp), lp.get("w_proj_b"))


def _qkv_proj(x, lp: Params, cfg: TransformerConfig):
    """x (B, T, D) -> q (B, H, T, Dh), k/v (B, H_kv, T, Dh)."""
    b, t, _ = x.shape
    h, h_kv, dh = cfg.n_head, cfg.n_local_heads, cfg.head_dim
    qkv = _linear(x, lp["wqkv"], lp.get("wqkv_b"))
    q, k, v = torch.split(qkv, [h * dh, h_kv * dh, h_kv * dh], dim=-1)
    q = q.reshape(b, t, h, dh).transpose(1, 2)
    k = k.reshape(b, t, h_kv, dh).transpose(1, 2)
    v = v.reshape(b, t, h_kv, dh).transpose(1, 2)
    return q, k, v


def _softmax_attend(scores, v_eq: str, v, mask, out_dtype, dh: int):
    scores = scores * (1.0 / dh**0.5)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(out_dtype)
    return torch.einsum(v_eq, probs, v.to(out_dtype))


def _attend(q, k, v, cfg: TransformerConfig, mask, out_dtype):
    """q (B, H, T, Dh) x k/v (B, H_kv, S, Dh) -> (B, T, D). f32 softmax."""
    b, h, t, dh = q.shape
    if cfg.n_local_heads != cfg.n_head:
        rep = cfg.n_head // cfg.n_local_heads
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    y = _softmax_attend(scores, "bhts,bhsd->bhtd", v, mask, out_dtype, dh)
    return y.transpose(1, 2).reshape(b, t, h * dh)


def _attend_seq_major(q, k, v, cfg: TransformerConfig, mask, out_dtype):
    """q (B, H, T, Dh) x a sequence-major cache slice k/v (S, B, H_kv, Dh)
    -> (B, T, D). f32 softmax."""
    b, h, t, dh = q.shape
    if cfg.n_local_heads != cfg.n_head:
        rep = cfg.n_head // cfg.n_local_heads
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bhtd,sbhd->bhts", q.float(), k.float())
    y = _softmax_attend(scores, "bhts,sbhd->bhtd", v, mask, out_dtype, dh)
    return y.transpose(1, 2).reshape(b, t, h * dh)


# --------------------------------------------------------------------------------------
# Full forward
# --------------------------------------------------------------------------------------


def embed_inputs(
    params: Params,
    cfg: TransformerConfig,
    idx,
    positions,
    spk_emb,
    spk_cond_mask=None,
    compute_dtype=torch.bfloat16,
):
    """Token + position + speaker-conditioning embeddings.

    idx: (B, T) single-vocab or (B, C, T) multi-hierarchy (summed).
    spk_emb: (B, spk_dim) or None. spk_cond_mask: (B, 1, 1) 0/1 rows that
    zero the speaker projection of the CFG-unconditioned rows.
    """
    if idx.dim() == 2:
        idx = idx[:, None, :]
    tok = torch.zeros((idx.shape[0], idx.shape[2], cfg.dim), dtype=compute_dtype, device=idx.device)
    for i, wte in enumerate(params["wtes"]):
        tok = tok + wte.to(compute_dtype)[idx[:, i, :]]
    x = tok + params["wpe"].to(compute_dtype)[positions]
    if spk_emb is not None and "speaker_cond" in params:
        cond = _linear(spk_emb.to(compute_dtype), params["speaker_cond"])
        if cond.dim() == 2:
            cond = cond[:, None, :]  # (B, 1, D), broadcast over time
        if spk_cond_mask is not None:
            cond = cond * spk_cond_mask.to(compute_dtype)
        x = x + cond
    return x


_STACK_KEYS = ("wqkv", "wo", "w1", "w3", "w2")


def int4_decode_route(params: Params, cfg: TransformerConfig, batch: int, cache_dtype=torch.bfloat16) -> str:
    """How a T=1 step of int4 layer weights runs: ``"stack"`` (all layers in
    the decode-stack kernel, K3), ``"layers"`` (per layer, the
    attention-block kernel K5 and the FFN kernel K6) or ``"unfused"`` (the
    ordinary per-layer loop: each projection through ``_linear``, K2 on the
    card, and the decode attention, K1 or K4 on a bf16 cache and the plain
    path on a quantized one), the JAX package's route when neither fused
    kernel takes the step. ``cache_dtype``: the cache's ``k.dtype`` (int8 or
    int32 for the int8 formats) or a ``KVCache.create`` format string.

    K3 needs five int4 matrices, SwiGLU, RMSNorm without biases, dim and the
    packed FFN width multiples of 1024, head_dim 128, at most 8 rows and a
    bf16 cache. K5/K6 need SwiGLU, no qkv bias, the same widths, head_dim
    128 and at most 8 rows, and take a bf16 or a quantized cache (the norms
    run outside them)."""
    layers = params["layers"]
    fused = (
        all(is_int4(layers.get(k)) for k in _STACK_KEYS)
        and cfg.nonlinearity_type == "swiglu"
        and "wqkv_b" not in layers
        and cfg.dim % 1024 == 0
        and layers["w1"]["pw"].shape[-1] % 1024 == 0
        and cfg.head_dim == HEAD_DIM
        and batch <= MAX_BATCH
    )
    if not fused:
        return "unfused"
    if cfg.norm_type == "rmsnorm" and "attn_norm_b" not in layers and cache_dtype == torch.bfloat16:
        return "stack"
    if cache_dtype in (torch.bfloat16, torch.int8, torch.int32, "int8", "int8_packed"):
        return "layers"
    return "unfused"


def int8_stack_ok(params: Params, cfg: TransformerConfig, batch: int, cache_dtype) -> bool:
    """Whether an int8 T=1 step runs through the decode-stack kernel: the JAX
    package's conditions (every stack weight packed int8, SwiGLU, RMSNorm,
    no qkv bias, dim a multiple of 1024, a bf16 cache) and the kernel's
    (head_dim 128, at most 8 rows)."""
    layers = params["layers"]
    return (
        all(is_int8_i32(layers.get(k)) for k in _STACK_KEYS)
        and cfg.nonlinearity_type == "swiglu"
        and cfg.norm_type == "rmsnorm"
        and "wqkv_b" not in layers
        and cfg.dim % 1024 == 0
        and layers["w1"]["p8"].shape[-1] % 1024 == 0
        and cache_dtype == torch.bfloat16
        and cfg.head_dim == HEAD_DIM
        and batch <= MAX_BATCH
    )


def int8_block_ok(params: Params, cfg: TransformerConfig, batch: int, cache_dtype) -> bool:
    """Whether a T=1 step runs each layer's attention block through K9: the
    JAX package's conditions (plain int8 wqkv and wo, MHA, no qkv bias,
    dim a multiple of 512, head_dim a multiple of 128, B*H a multiple of 8,
    a float cache; bf16 here) and the kernel's (head_dim 128, at most 8
    rows). A model with an o-proj bias takes the unfused route, since K9
    has no bias (JAX's drops it)."""
    layers = params["layers"]
    return (
        is_int8_plain(layers.get("wqkv"))
        and is_int8_plain(layers.get("wo"))
        and cfg.n_local_heads == cfg.n_head
        and "wqkv_b" not in layers
        and "wo_b" not in layers
        and cfg.dim % 512 == 0
        and cfg.head_dim == HEAD_DIM
        and (batch * cfg.n_head) % 8 == 0
        and batch <= DECODE_MAX_ROWS
        and cache_dtype == torch.bfloat16
    )


def _layer(layers: Params, li: int) -> Params:
    """Layer li's view of the stacked weights (packed leaves included)."""
    return {
        name: {k: v[li] for k, v in w.items()} if isinstance(w, dict) else w[li]
        for name, w in layers.items()
    }


def _decode_stack(params: Params, cfg: TransformerConfig, x, kv_cache: KVCache, cache_pos,
                  attn_starts, fused_head: bool):
    """A T=1 step of int4 layers through the decode-stack kernel."""
    layers = params["layers"]
    head = params.get("lm_head_q") if fused_head and "ln_f_b" not in params else None
    head_kw = {} if head is None else dict(ln_f_w=params["ln_f_w"], head_pw=head["pw"], head_sc=head["sc"])
    outs = decode_stack_int4(
        x[:, 0, :],
        layers["attn_norm_w"], layers["ffn_norm_w"],
        *[t for k in _STACK_KEYS for t in (layers[k]["pw"], layers[k]["sc"])],
        kv_cache.k, kv_cache.v, cache_pos, cfg.n_head,
        n_kv_head=cfg.n_local_heads, starts=attn_starts, norm_eps=cfg.norm_eps, **head_kw,
    )
    if head is not None:
        # vocab padding columns carry zeroed scales: slice them off
        return outs[3][:, : cfg.vocab_sizes[0]], kv_cache, True
    xo = _norm(outs[0][:, None, :].to(x.dtype), params["ln_f_w"], params.get("ln_f_b"),
               cfg.norm_type, cfg.norm_eps)
    return (xo, kv_cache, False) if fused_head else (xo, kv_cache)


def _decode_layers_int4(params: Params, cfg: TransformerConfig, x, kv_cache: KVCache, cache_pos,
                        attn_starts, fused_head: bool, attn_window=None):
    """A T=1 step of int4 layers one layer at a time (the JAX package's
    ``body4``): norm, the attention-block kernel (K5: qkv, the cache row in
    any format, attention, o-proj; bf16 out), the residual add in x's dtype,
    norm, the FFN kernel (K6, f32 out), the residual add; then the final
    norm. The bf16 tied head stays with the caller (head_done=False).
    ``attn_window``: K5's window bucket (``apply_blocks``)."""
    layers = params["layers"]
    w = {k: (layers[k]["pw"], layers[k]["sc"]) for k in _STACK_KEYS}
    for li in range(cfg.n_layer):
        lp = _layer(layers, li)
        xa = _norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"), cfg.norm_type, cfg.norm_eps)
        y2, *_ = decode_attention_block_int4(
            xa[:, 0, :], *w["wqkv"], *w["wo"], kv_cache.k, kv_cache.v, li, cache_pos, cfg.n_head,
            n_kv_head=cfg.n_local_heads, starts=attn_starts, k_scale=kv_cache.k_scale, v_scale=kv_cache.v_scale,
            window=attn_window,
        )
        h = x + y2[:, None, :].to(x.dtype)
        hn = _norm(h, lp["ffn_norm_w"], lp.get("ffn_norm_b"), cfg.norm_type, cfg.norm_eps)
        x = h + decode_ffn_int4(hn[:, 0, :], *w["w1"], *w["w3"], *w["w2"], li)[:, None, :].to(x.dtype)
    x = _norm(x, params["ln_f_w"], params.get("ln_f_b"), cfg.norm_type, cfg.norm_eps)
    return (x, kv_cache, False) if fused_head else (x, kv_cache)


def _decode_stack_int8(params: Params, cfg: TransformerConfig, x, kv_cache: KVCache, cache_pos,
                       attn_starts, fused_head: bool):
    """A T=1 step of int8 layers through the decode-stack kernel, then the
    final norm; the bf16 tied head stays with the caller (head_done=False)."""
    layers = params["layers"]
    xo, _, _ = decode_stack_int4(
        x[:, 0, :],
        layers["attn_norm_w"], layers["ffn_norm_w"],
        *[t for k in _STACK_KEYS for t in (layers[k]["p8"], layers[k]["sc8"])],
        kv_cache.k, kv_cache.v, cache_pos, cfg.n_head,
        n_kv_head=cfg.n_local_heads, starts=attn_starts, norm_eps=cfg.norm_eps, wfmt="i8",
    )
    xo = _norm(xo[:, None, :].to(x.dtype), params["ln_f_w"], params.get("ln_f_b"),
               cfg.norm_type, cfg.norm_eps)
    return (xo, kv_cache, False) if fused_head else (xo, kv_cache)


def _quantized_window(kv_cache: KVCache, li: int, cache_pos, k_new, v_new, dtype):
    """Quantize the window's K/V rows (B, H_kv, T, Dh), from the rows in the
    compute dtype, write them at [cache_pos, cache_pos+T) of layer ``li`` (a
    word read-modify-write for the packed cache), and return the layer
    dequantized -> (k, v), each (S, B, H_kv, Dh) in ``dtype``. ``cache_pos``
    may be a one-element int tensor on the cache's device (a T = 1 step
    captured in a CUDA graph), read on the device: the rows go in by
    ``index_copy_`` at either kind of ``cache_pos``."""
    t = k_new.shape[2]
    bh = k_new.shape[0] * k_new.shape[1]
    out = []
    for cache, table, new in ((kv_cache.k, kv_cache.k_scale, k_new), (kv_cache.v, kv_cache.v_scale, v_new)):
        q8, s = quantize_kv_rows(new.permute(2, 0, 1, 3))
        if kv_cache.packed:
            packed_kv_update(cache, q8, li, cache_pos)
            packed_scale_update(table, s.reshape(t, bh), li, cache_pos)
            out.append(packed_kv_dequant(cache, table, li, dtype))
        else:
            p = cache_pos + torch.arange(t, device=cache.device)
            cache[li].index_copy_(0, p, q8)
            table[li, :, 0, :bh].index_copy_(0, p, s.reshape(t, bh))
            out.append(_dequant_int8_layer(cache, table, li, dtype))
    return out


def _window_mask(cache_pos, t: int, seq_len: int, starts, device):
    """(1 or B, 1, T, S) mask of the causal window every cached caller asks
    for: query t sees slots [starts[b], cache_pos + t] (a start past
    ``cache_pos`` taken as ``cache_pos``). ``cache_pos``: an int or a 0-d
    int tensor on ``device``, compared on the device."""
    valid = causal_mask_for(cache_pos + torch.arange(t, device=device), seq_len)[None, None]
    if starts is not None:
        valid = valid & (torch.arange(seq_len, device=device) >= starts.clamp(max=cache_pos)[:, None, None, None])
    return valid


def _attention_block(xa, lp: Params, cfg: TransformerConfig, li: int, mask, kv_cache: KVCache | None, cache_pos,
                     attn_starts, int8_block: bool, tp=None, attn_window=None):
    """One layer's attention and o-proj of the normed input xa (B, T, D) as
    ``apply_blocks`` routes it -> (B, T, D) in xa's dtype; the cache is
    updated in place. ``tp``: the o-proj's partial sums are reduced over
    the tensor group before its bias. ``attn_window``: the decode
    attention's window bucket (``apply_blocks``)."""
    t = xa.shape[1]
    if int8_block:
        w, wo = lp["wqkv"], lp["wo"]
        y2, _, _ = decode_attention_block_int8(xa[:, 0, :], w["q"], w["scales"], wo["q"], wo["scales"],
                                               kv_cache.k, kv_cache.v, li, cache_pos, cfg.n_head, starts=attn_starts,
                                               window=attn_window)
        return y2[:, None, :].to(xa.dtype)
    quantized = kv_cache is not None and kv_cache.quantized
    q, k_new, v_new = _qkv_proj(xa, lp, cfg)
    if kv_cache is None:
        y = _attend(q, k_new, v_new, cfg, mask, xa.dtype)
    elif quantized:
        layer_k, layer_v = _quantized_window(kv_cache, li, cache_pos, k_new, v_new, xa.dtype)
        y = _attend_seq_major(q, layer_k, layer_v, cfg, mask, xa.dtype)
    elif t == 1:
        y3, _, _ = decode_attention(
            q[:, :, 0].contiguous(),
            k_new[:, :, 0].contiguous(),
            v_new[:, :, 0].contiguous(),
            kv_cache.k,
            kv_cache.v,
            li,
            cache_pos,
            starts=attn_starts,
            **({} if attn_window is None else {"window": attn_window}),
        )
        y = y3.reshape(xa.shape[0], 1, cfg.n_head * cfg.head_dim).to(xa.dtype)
    elif t <= MULTI_MAX_T:
        y4, _, _ = decode_attention_multi(
            q.contiguous(), k_new.contiguous(), v_new.contiguous(), kv_cache.k, kv_cache.v,
            li, cache_pos, starts=attn_starts, window=attn_window,
        )
        y = y4.transpose(1, 2).reshape(xa.shape[0], t, cfg.n_head * cfg.head_dim).to(xa.dtype)
    else:
        rows = slice(cache_pos, cache_pos + t)
        kv_cache.k[li, rows] = k_new.permute(2, 0, 1, 3).to(kv_cache.k.dtype)
        kv_cache.v[li, rows] = v_new.permute(2, 0, 1, 3).to(kv_cache.v.dtype)
        y = _attend_seq_major(q, kv_cache.k[li], kv_cache.v[li], cfg, mask, xa.dtype)
    return _add_bias(_tp_sum(_linear(y, lp["wo"]), tp), lp.get("wo_b"))


def dropout_keep(x, rate: float, generator: torch.Generator, rows: tuple[int, int] | None = None):
    """A keep-mask of x's shape, each element kept with probability 1 - rate,
    drawn from ``generator`` (on x's device). ``rows`` (global batch,
    first row): x holds rows [first, first + B) of a global batch, whose
    mask is drawn whole and cut to them, so a data-parallel rank keeps the
    mask one process would draw for its rows."""
    if rows is None:
        return torch.rand(x.shape, generator=generator, device=x.device) >= rate
    batch, first = rows
    keep = torch.rand((batch, *x.shape[1:]), generator=generator, device=x.device) >= rate
    return keep[first : first + x.shape[0]]


def _dropout(x, rate: float, keep):
    """Inverted dropout (torch nn.Dropout's train-time semantics): kept
    values scaled by 1/(1-rate), in x's dtype."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)).to(x.dtype)


def _block(x, lp: Params, cfg: TransformerConfig, li: int, mask, kv_cache: KVCache | None, cache_pos, attn_starts,
           int8_block: bool, keep=None, tp=None, attn_window=None):
    """One layer: x + attention(norm(x)), then + MLP(norm(h)); ``keep`` (the
    attention and MLP branches' dropout masks) drops each branch. Under TP
    with autograd, each normed input passes Megatron's f (``_tp_copy``)."""
    xa = _tp_copy(_norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"), cfg.norm_type, cfg.norm_eps), tp)
    a = _attention_block(xa, lp, cfg, li, mask, kv_cache, cache_pos, attn_starts, int8_block, tp, attn_window)
    if keep is not None:
        a = _dropout(a, cfg.dropout, keep[0])
    h = x + a
    xm = _tp_copy(_norm(h, lp["ffn_norm_w"], lp.get("ffn_norm_b"), cfg.norm_type, cfg.norm_eps), tp)
    m = _mlp(xm, lp, cfg, tp)
    if keep is not None:
        m = _dropout(m, cfg.dropout, keep[1])
    return h + m


def layer_list(layers: Params) -> list[Params]:
    """The stacked weights -> one weight dict per layer (views)."""
    cols = {name: ({k: v.unbind(0) for k, v in w.items()} if isinstance(w, dict) else w.unbind(0))
            for name, w in layers.items()}
    first = next(iter(cols.values()))
    n = len(next(iter(first.values())) if isinstance(first, dict) else first)
    return [{name: ({k: v[li] for k, v in c.items()} if isinstance(c, dict) else c[li]) for name, c in cols.items()}
            for li in range(n)]


def _needs_grad(x, lp: Params) -> bool:
    return x.requires_grad or any(
        t.requires_grad for w in lp.values() for t in (w.values() if isinstance(w, dict) else (w,)))


def apply_blocks(
    params: Params,
    cfg: TransformerConfig,
    x,
    mask,
    kv_cache: KVCache | None = None,
    cache_pos: int | None = None,
    attn_starts=None,
    fused_head: bool = False,
    dropout_generator: torch.Generator | None = None,
    tp=None,
    dropout_rows: tuple[int, int] | None = None,
    attn_window: int | None = None,
):
    """Run the L-layer block stack and the final norm -> (x, kv_cache).

    * no cache: full attention under ``mask`` (None = non-causal);
    * cache, T > 16 (prefill): write rows [cache_pos, cache_pos+T) of every
      layer in place, attend over the whole cache layer under ``mask``;
    * cache, 1 < T <= 16 (the speculative verify): ``decode_attention_multi``
      writes the rows and query t attends [attn_starts, cache_pos + t], the
      causal window every cached caller asks for; ``mask`` is not used.
      ``cache_pos`` may be a 0-d int32 tensor on the device there too (the
      verify of ``models/spec_decode``'s round captured in a CUDA graph),
      read on the device by K4, which plans at the window bucket
      ``attn_window`` (default: ``[0, cache_pos + T)`` of an int). Packed
      int4/int8 projections run through their matmul kernels;
    * cache, T = 1 (decode): ``decode_attention`` writes the row and attends
      over the window [attn_starts, cache_pos] (GQA: through
      ``decode_attention_multi``); ``mask`` is not used. ``cache_pos`` may
      be a 0-d int32 tensor on the device there (the CUDA-graph step of
      ``first_stage.decode``), read on the device by every T = 1 route
      without tensor parallelism: the decode attention (K1, and K4 for
      GQA), K5 and K9, each planned at the window bucket ``attn_window``
      (default: the bucket of an int ``cache_pos``, so both give the same
      bits), the int4 / int8 decode-stack kernels, and the quantized
      cache's plain path (its row written by ``index_copy_``, its window
      mask compared on the device). Where
      ``int8_block_ok`` holds (plain int8), each layer's attention block is
      one ``decode_attention_block_int8`` call instead. With int4 layer
      weights the step runs as ``int4_decode_route`` says: all layers in
      the decode-stack kernel, per layer through the attention-block and
      FFN kernels, or, when neither takes it, through the loop below (each
      int4 projection in ``_linear``); with int8 ones through the
      decode-stack kernel too, where ``int8_stack_ok`` holds.

    A quantized cache (``KVCache.quantized``) takes the plain path at
    prefill, at every cached forward of T <= 16 and at T = 1 with bf16 or
    int8 weights, as in the JAX package: the window's rows are quantized
    (``quantize_kv_rows``) and written, the layer is dequantized and attended
    densely, under ``mask`` at prefill and under the causal window
    [attn_starts, cache_pos + t] for T <= 16. With int4 weights its T = 1
    step is the per-layer route.

    ``fused_head=True`` (decode callers) returns a THREE-tuple
    ``(x_or_logits, kv_cache, head_done)``: when the int4 stack ran with a
    packed head (``params["lm_head_q"]``), the final norm and the tied head
    are fused into it and ``x_or_logits`` is the (B, V) f32 logits
    (head_done=True); otherwise it is the normed hidden state.

    Without a cache, ``params["layers"]`` may also be a list of per-layer
    weight dicts, and a layer with something to differentiate (grad mode on,
    and x or a weight requiring grad) is recomputed in the backward pass.
    ``dropout_generator`` (training, no cache) drops each layer's attention
    and MLP branch with probability ``cfg.dropout`` (inverted scaling), the
    masks cut from the global batch's by ``dropout_rows`` (``dropout_keep``).
    As in the JAX package, the attention probabilities get no dropout: the
    reference's SDPA dropout at the finetune default p = 0.1 is subsumed by
    the residual dropouts.

    ``tp`` (a ``torch.distributed`` process group, or None): Megatron
    tensor parallelism (parallel/tp_decode.py). ``params`` and ``cfg`` are
    this rank's shards and local view, and each layer reduces its o-proj
    and its FFN down projection over the group (``_tp_sum``), adding their
    biases after. The routes that fuse across those reductions stay off, as
    the JAX package gates them: the int4 decode stack and attention-block /
    FFN kernels (``int4_decode_route``), the int8 decode stack
    (``int8_stack_ok``) and the plain-int8 attention block
    (``int8_block_ok``); a T = 1 step runs the per-layer loop below.
    Under autograd (training) the pair is Megatron's: f on each normed
    input of the column-parallel products, g for each reduction
    (``_tp_copy``, ``_tp_sum``); a recomputed layer issues its forward
    reductions again inside the backward pass, up to the last tensor the
    backward saved.
    """
    t = x.shape[1]
    if kv_cache is not None and t == 1 and tp is None:
        route = None
        if any(is_int4(w) for w in params["layers"].values()):
            route = int4_decode_route(params, cfg, x.shape[0], kv_cache.k.dtype)
        if route == "stack":
            return _decode_stack(params, cfg, x, kv_cache, cache_pos, attn_starts, fused_head)
        if route == "layers":
            return _decode_layers_int4(params, cfg, x, kv_cache, cache_pos, attn_starts, fused_head, attn_window)
        if int8_stack_ok(params, cfg, x.shape[0], kv_cache.k.dtype):
            return _decode_stack_int8(params, cfg, x, kv_cache, cache_pos, attn_starts, fused_head)
    quantized = kv_cache is not None and kv_cache.quantized
    if quantized and t <= MULTI_MAX_T:
        mask = _window_mask(cache_pos, t, kv_cache.max_seq_len, attn_starts, x.device)
    int8_block = (kv_cache is not None and t == 1 and tp is None
                  and int8_block_ok(params, cfg, x.shape[0], kv_cache.k.dtype))
    layers = params["layers"]
    if kv_cache is None and not isinstance(layers, list):
        # unbind once: its backward stacks the layers' grads in one go, where
        # indexing a layer would add a whole-stack grad for every layer
        layers = layer_list(layers)
    for li in range(cfg.n_layer):
        lp = layers[li] if isinstance(layers, list) else _layer(layers, li)
        keep = None
        if dropout_generator is not None:
            # drawn outside the recomputed block: the recompute restores the
            # global RNG state, not an explicit generator's
            keep = tuple(dropout_keep(x, cfg.dropout, dropout_generator, dropout_rows) for _ in range(2))
        if kv_cache is None and torch.is_grad_enabled() and _needs_grad(x, lp):
            # the block uses no global RNG, so there is no RNG state to stash. Under TP the recompute
            # issues the layer's forward reductions again inside the backward pass (those before the
            # last tensor the backward saved: it stops there), where the backward first needs the
            # layer: every rank of the group runs the same backward graph, so each issues them, and
            # Megatron's f's, in the same order
            x = checkpoint(_block, x, lp, cfg, li, mask, None, None, None, False, keep, tp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block(x, lp, cfg, li, mask, kv_cache, cache_pos, attn_starts, int8_block, keep, tp, attn_window)
    x = _norm(x, params["ln_f_w"], params.get("ln_f_b"), cfg.norm_type, cfg.norm_eps)
    return (x, kv_cache, False) if fused_head else (x, kv_cache)


def output_logits(params: Params, cfg: TransformerConfig, x) -> list[torch.Tensor]:
    """Per-hierarchy lm-head logits in f32: ``lm_heads`` when the config has
    target vocabs (second stage), else tied to ``wtes`` (first stage)."""
    xf = x.float()
    if cfg.target_vocab_sizes is not None:
        return [xf @ h.to(x.dtype).float() for h in params["lm_heads"]]
    return [xf @ w.to(x.dtype).float().T for w in params["wtes"]]


def causal_mask_for(positions, kv_len: int):
    """(..., T, kv_len) bool mask: query at absolute position p sees slots [0, p]."""
    kv_pos = torch.arange(kv_len, device=positions.device)
    return positions[..., :, None] >= kv_pos


def forward(
    params: Params,
    cfg: TransformerConfig,
    idx,
    *,
    positions=None,
    spk_emb=None,
    spk_cond_mask=None,
    kv_cache: KVCache | None = None,
    cache_pos: int = 0,
    compute_dtype=torch.bfloat16,
    dropout_generator: torch.Generator | None = None,
    tp=None,
    dropout_rows: tuple[int, int] | None = None,
):
    """(B, [C,] T) tokens -> (per-hierarchy (B, T, V) f32 logits, kv_cache).

    Causal without a cache (training-style forward), causal with a cache
    (prefill for T > 1, decode for T = 1, at ``cache_pos``; the cache is
    updated in place), or non-causal (second stage).

    ``dropout_generator`` with ``cfg.dropout > 0`` and no cache (training)
    drops the embedding sum (the reference's ``transformer.drop``) and each
    layer's residual branches, the masks drawn from the generator (on the
    tokens' device). Inference callers pass none. ``tp``: the tensor
    group of a tensor-parallel forward (``apply_blocks``). ``dropout_rows``
    (global batch, first row): the tokens are those rows of a data-parallel
    batch, and every mask is cut from the global batch's
    (``dropout_keep``).
    """
    t = idx.shape[-1]
    if positions is None:
        positions = torch.arange(t, device=idx.device) + (cache_pos if kv_cache is not None else 0)
    x = embed_inputs(params, cfg, idx, positions, spk_emb, spk_cond_mask, compute_dtype)
    if dropout_generator is not None and (cfg.dropout <= 0.0 or kv_cache is not None):
        dropout_generator = None
    if dropout_generator is not None:
        x = _dropout(x, cfg.dropout, dropout_keep(x, cfg.dropout, dropout_generator, dropout_rows))
    if not cfg.causal:
        mask = None
    elif kv_cache is not None:
        mask = causal_mask_for(positions, kv_cache.max_seq_len)[None, None]
    else:
        mask = causal_mask_for(positions, t)[None, None]
    x, kv_cache = apply_blocks(
        params, cfg, x, mask, kv_cache, cache_pos if kv_cache is not None else None,
        dropout_generator=dropout_generator, tp=tp, dropout_rows=dropout_rows,
    )
    return output_logits(params, cfg, x), kv_cache
