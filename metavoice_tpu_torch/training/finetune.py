"""First-stage LLM finetuning in PyTorch: AdamW over the last N blocks.

Port of metavoice_tpu/training/finetune.py, with the reference trainer's
semantics (fam/llm/finetune.py, fam/llm/model.py):

  * per-hierarchy cross-entropy with ignore_index=-1;
  * global-norm clipping, then AdamW (b1 0.9, b2 0.95, eps 1e-8, bias
    correction, decay decoupled and scaled by the rate) on rank >= 2 leaves,
    written as plain tensor code in optax's order, the moments in each
    param's dtype (``AdamW``);
  * linear warmup then cosine decay, with optax's counting: the first update
    runs at count 0 (``lr_schedule``);
  * last-N-block freezing and the final norm, two ways: a per-layer 0/1 mask
    on the stacked tree's grads and updates (``trainable_mask``,
    ``make_train_step``), or a trainable tail split off the stacks
    (``split_trainable``, ``make_finetune_step``), whose grads and moments
    exist only for the last N blocks and ``ln_f*``;
  * gradient accumulation (a leading micro-batch axis, grads averaged);
  * speaker-embedding dropout (the CFG uncond branch) and network dropout.

Parameters stay the JAX package's stacked tree of tensors. A step updates
the params and the moments IN PLACE and returns the state with the step
advanced. Dropout draws from a torch generator seeded by ``(cfg.seed,
step)`` (and the micro-batch's index under accumulation), where the JAX
package folds the step into a PRNG key: so a resumed run draws as a straight
one, and the streams never match JAX's.

Sharded training (``mesh=``, a ``parallel/mesh.Mesh``; the JAX package
jit-compiles the same step over its (data, tensor) mesh and GSPMD inserts
the reductions): each rank holds its shards (``parallel/sharding.
shard_params``) and takes the global batch, of which it keeps its data
rank's rows. The forward reduces over the tensor group (Megatron's pair,
``models/transformer.apply_blocks(tp=...)``); the loss is the local NLL sum
over the global count of valid targets (the count summed over the data
group), so the gradients summed over the data group after the backward are
those of JAX's global mean, whatever share of ``-1`` targets each rank
holds; the global norm sums the split leaves' squares over the tensor
group and counts the replicated leaves once; dropout masks are drawn for
the global batch and cut to the rank's rows. Every rank of a data group
ends a step with the same bits, and every rank of a tensor group with the
same replicated leaves. The default mesh is the one-process grid, with
which every result is the unsharded step's, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.core.tokens import END_OF_TEXT_TOKEN
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.parallel import mesh as pmesh
from metavoice_tpu_torch.parallel.sharding import split_leaves
from metavoice_tpu_torch.parallel.tp_decode import local_view


@dataclass(frozen=True)
class FinetuneConfig:
    """Defaults mirror fam/llm/config/finetune_params.py."""

    learning_rate: float = 3e-5
    min_lr: float = 3e-6  # lr/10 rule (finetune_params.py:59)
    warmup_iters: int = 100
    lr_decay_iters: int = 5000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    batch_size: int = 2
    gradient_accumulation_steps: int = 1
    last_n_blocks_to_finetune: int = 1
    max_iters: int = 5000
    eval_interval: int = 200
    eval_iters: int = 20
    seed: int = 1337


class TrainState(NamedTuple):
    params: Any
    opt_state: Any  # AdamW's: {"count": int, "mu": tree, "nu": tree}
    step: int


# --------------------------------------------------------------------------------------
# Trees: nested dicts and lists of tensors, the JAX package's pytrees
# --------------------------------------------------------------------------------------


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``);
    ``None`` is an empty subtree, as in a JAX pytree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def global_norm(grads: Any, mesh: pmesh.Mesh | None = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, accumulated in f32. Under a
    tensor group (``mesh``), the squares of the split leaves are summed over
    the group and the replicated leaves counted once: the norm of the whole
    tree, the same bits on every rank. A collective then."""
    leaves = tree_leaves(grads)
    if mesh is None or mesh.tensor_group is None:
        return torch.sqrt(sum(g.float().square().sum() for g in leaves))
    split = tree_leaves(split_leaves(grads))
    sq = [(g.float().square().sum(), s) for g, s in zip(leaves, split)]
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    shards = sum((x for x, s in sq if s), zero)
    dist.all_reduce(shards, group=mesh.tensor_group)
    return torch.sqrt(shards + sum((x for x, s in sq if not s), zero))


# --------------------------------------------------------------------------------------
# Schedule, masks and the optimizer
# --------------------------------------------------------------------------------------


def lr_schedule(cfg: FinetuneConfig) -> Callable[[int], float]:
    """count -> learning rate: linear warmup from 0 over ``warmup_iters``,
    then cosine decay to ``min_lr`` over ``lr_decay_iters - warmup_iters``
    (fam/llm/finetune.py:170-181). optax's ``join_schedules`` of a
    ``linear_schedule`` and a ``cosine_decay_schedule`` (alpha = min_lr / lr),
    in float32 as optax computes it."""
    f32 = np.float32
    lr, warm = cfg.learning_rate, cfg.warmup_iters
    decay_steps = float(max(cfg.lr_decay_iters - warm, 1))
    alpha = cfg.min_lr / cfg.learning_rate

    def warmup(count: int):
        if warm <= 0:  # optax's linear_schedule of no steps is its init value
            return f32(0.0)
        frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
        return f32(0.0 - lr) * frac + f32(lr)

    def cosine(count: int):
        c = f32(min(float(count), decay_steps))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return f32(lr) * (f32(1 - alpha) * cos + f32(alpha))

    def schedule(count: int) -> float:
        return float(warmup(count) if count < warm else cosine(count - warm))

    return schedule


def _decays(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def weight_decay_mask(params: Any) -> Any:
    """Decay rank >= 2 leaves of the tree the optimizer sees. On the stacked
    tree this includes the per-layer norm weights (L, D), as in the JAX
    package; the reference (fam/llm/model.py:321-328) decays per-layer
    rank >= 2 tensors only."""
    return tree_map(_decays, params)


def _as(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (as a Python float): the constant JAX's
    weak typing gives an op on a tensor of that dtype."""
    return torch.tensor(value, dtype=dtype).item()


@dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    b1, b2, eps, weight_decay, mask=rank >= 2))`` as plain tensor code, in
    optax's order and roundings: every op in the leaf's dtype, its constants
    rounded to that dtype, the bias corrections ``1 - b**count`` in f32.

    Clipping scales the grads by ``max / |g|`` only when ``|g| >= max``
    (optax's rule; torch's ``clip_grad_norm_`` scales by ``max / (|g| +
    1e-6)`` whenever it is below 1); the norm accumulates in f32.

    ``learning_rate``: a schedule (count -> rate) or a constant. The moments
    are updated in place."""

    learning_rate: Callable[[int], float] | float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    grad_clip: float = 1.0

    def init(self, params: Any) -> dict:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(self, grads: Any, opt_state: dict, params: Any, norm: torch.Tensor | None = None) -> tuple[Any, dict]:
        """-> (updates to add to the params, opt_state with count + 1).
        ``norm``: the grads' global norm, when the caller has it (a sharded
        tree's is ``global_norm(grads, mesh)``)."""
        count = opt_state["count"]
        lr = self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate
        if norm is None:
            norm = global_norm(grads)
        grads = tree_map(lambda g: torch.where(norm < self.grad_clip, g,
                                               (g / norm.to(g.dtype)) * _as(self.grad_clip, g.dtype)), grads)
        f32 = np.float32
        corr1 = f32(1) - f32(self.b1) ** f32(count + 1)
        corr2 = f32(1) - f32(self.b2) ** f32(count + 1)

        def leaf(g, mu, nu, p):
            dt = g.dtype
            with torch.no_grad():
                mu.mul_(_as(self.b1, dt)).add_(g * _as(1 - self.b1, dt))
                nu.mul_(_as(self.b2, dt)).add_((g * g) * _as(1 - self.b2, dt))
                u = (mu / _as(corr1, dt)) / (torch.sqrt(nu / _as(corr2, dt)) + _as(self.eps, dt))
                if _decays(p):
                    u = u + p.detach() * _as(self.weight_decay, dt)
                return u * _as(-lr, dt)

        updates = tree_map(leaf, grads, opt_state["mu"], opt_state["nu"], params)
        opt_state["count"] = count + 1
        return updates, opt_state


def make_optimizer(cfg: FinetuneConfig) -> AdamW:
    """Clip by global norm, then AdamW with the warmup + cosine schedule and
    decay on rank >= 2 leaves (``weight_decay_mask``)."""
    return AdamW(lr_schedule(cfg), b1=cfg.beta1, b2=cfg.beta2, eps=1e-8, weight_decay=cfg.weight_decay,
                 grad_clip=cfg.grad_clip)


def trainable_mask(params: Any, model_cfg: TransformerConfig, last_n_blocks: int) -> Any:
    """0/1 grad multipliers for last-N-block finetuning (finetune.py:236-244):
    everything frozen but the last N blocks and the final norm. Stacked
    layer leaves get a per-layer (L, 1, ...) f32 multiplier, every other leaf
    a float. ``last_n_blocks < 0`` trains everything (the from-scratch mode;
    the reference has no such mode)."""
    if last_n_blocks < 0:
        return tree_map(lambda p: 1.0, params)
    n = model_cfg.n_layer

    def gate(leaf):
        g = (torch.arange(n, device=leaf.device) >= n - last_n_blocks).float()
        return g.reshape((n,) + (1,) * (leaf.dim() - 1))

    masked = {}
    for k, v in params.items():
        if k == "layers":
            masked[k] = {lk: gate(lv) for lk, lv in v.items()}
        elif k.startswith("ln_f"):
            masked[k] = 1.0
        else:
            masked[k] = tree_map(lambda p: 0.0, v)
    return masked


def apply_grad_mask(grads: Any, mask: Any) -> Any:
    return tree_map(lambda g, m: g * (m.to(g.dtype) if torch.is_tensor(m) else m), grads, mask)


# --------------------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------------------


def _nll_sum_count(logits: list, targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (the NLL summed over hierarchies and non-ignored positions, the
    count of those positions)."""
    if targets.dim() == 2:
        targets = targets[:, None, :]
    total, count = 0.0, 0
    for i, lg in enumerate(logits):
        tgt = targets[:, i, :].long()
        valid = tgt != -1
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, torch.where(valid, tgt, 0)[..., None])[..., 0]
        total = total + (nll * valid).sum()
        count = count + valid.sum()
    return total, count


def hierarchy_cross_entropy(logits: list, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over hierarchies and non-ignored positions; targets (B, [C,]
    T) with -1 = ignore (fam/llm/model.py:289-301)."""
    total, count = _nll_sum_count(logits, targets)
    return total / torch.clamp(count, min=1)


def mask_spk_emb_on_text(idx: torch.Tensor, end_of_text_token: int = END_OF_TEXT_TOKEN) -> torch.Tensor:
    """(B, [C,] T) tokens -> (B, T, 1) f32 keep-mask for the speaker
    conditioning: 0 strictly before the first end-of-text token, 1 from it on
    (fam/llm/model.py:178-193, the cumsum > 0 rule)."""
    first = idx if idx.dim() == 2 else idx[:, 0, :]
    keep = torch.cumsum((first == end_of_text_token).int(), dim=-1) > 0
    return keep.float()[:, :, None]


def spkemb_dropout_mask(generator: torch.Generator, batch_size: int, spkemb_dropout: float,
                        rows: tuple[int, int] | None = None) -> torch.Tensor:
    """(B, 1, 1) f32 per-row keep-mask on the generator's device, dropping a
    row's speaker conditioning with probability ``spkemb_dropout`` (what
    trains the CFG uncond branch), with no 1/(1-p) rescale
    (fam/llm/model.py:269-274). ``rows`` (global batch, first row): drawn
    for the global batch, rows [first, first + batch_size) kept."""
    if rows is None:
        u = torch.rand((batch_size, 1, 1), generator=generator, device=generator.device)
    else:
        u = torch.rand((rows[0], 1, 1), generator=generator, device=generator.device)[rows[1] : rows[1] + batch_size]
    return (u >= spkemb_dropout).float()


def loss_fn(params: Any, model_cfg: TransformerConfig, batch: dict, compute_dtype=torch.bfloat16,
            generator: torch.Generator | None = None, mesh: pmesh.Mesh | None = None) -> torch.Tensor:
    """The first stage's training loss on ``batch`` ({x, y, spk_emb}).
    ``generator`` (training) draws the speaker-embedding dropout rows, then
    the network dropout (``cfg.dropout``); without it, eval semantics.

    ``mesh`` (sharded training): ``params`` are this rank's shards and
    ``batch`` the global batch, of which the rank keeps its data rank's
    rows; the result is their NLL sum over the global count of valid
    targets (a collective over the data group), so the data group's losses
    sum to the global mean."""
    rows = None
    if mesh is not None and mesh.data_parallel > 1:
        b = batch["x"].shape[0]
        lo, hi = mesh.batch_rows(b)
        batch, rows = {k: v[lo:hi] for k, v in batch.items()}, (b, lo)
    spk_emb = batch.get("spk_emb")
    spk_cond_mask = None
    if spk_emb is not None:
        if not model_cfg.spk_emb_on_text:
            spk_cond_mask = mask_spk_emb_on_text(batch["x"])
        if model_cfg.spkemb_dropout > 0.0 and generator is not None:
            keep = spkemb_dropout_mask(generator, spk_emb.shape[0], model_cfg.spkemb_dropout, rows)
            spk_cond_mask = keep if spk_cond_mask is None else spk_cond_mask * keep
    tp = mesh.tensor_group if mesh is not None else None
    logits, _ = tfm.forward(
        params, model_cfg if tp is None else local_view(model_cfg, mesh.tensor_parallel), batch["x"],
        spk_emb=spk_emb, spk_cond_mask=spk_cond_mask, compute_dtype=compute_dtype,
        dropout_generator=generator if model_cfg.dropout > 0.0 else None, tp=tp, dropout_rows=rows,
    )
    total, count = _nll_sum_count(logits, batch["y"])
    if rows is not None:
        dist.all_reduce(count, group=mesh.data_group)
    return total / torch.clamp(count, min=1)


# --------------------------------------------------------------------------------------
# Steps
# --------------------------------------------------------------------------------------


def step_seed(seed: int, step: int, micro: int | None = None) -> int:
    """The dropout generator's seed for ``step`` (and a micro-batch): the
    counterpart of JAX's ``fold_in(PRNGKey(seed), step)`` (then ``fold_in(.,
    micro)``)."""
    words = np.random.SeedSequence([seed, step] + ([] if micro is None else [micro])).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def init_train_state(params: Any, cfg: FinetuneConfig) -> tuple[TrainState, AdamW]:
    opt = make_optimizer(cfg)
    return TrainState(params=params, opt_state=opt.init(params), step=0), opt


def mean_grads(params: Any, trained: list[bool], loss_of: Callable, batches: list, seeds: list[int],
               mesh: pmesh.Mesh | None = None):
    """Mean loss and mean grads over the micro-batches -> (loss, grads tree);
    leaves not ``trained`` get no autograd and zero grads. Under a data
    group (``mesh``) the losses and the trained leaves' grads are summed
    over it before the mean."""
    leaves = tree_leaves(params)
    for p, t in zip(leaves, trained):
        p.requires_grad_(t)
        p.grad = None
    dev = leaves[0].device
    loss_sum = None
    for mb, seed in zip(batches, seeds):
        loss = loss_of(mb, _generator(dev, seed))
        loss.backward()
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
    k = len(batches)
    data = mesh.data_group if mesh is not None else None
    if data is not None:
        dist.all_reduce(loss_sum, group=data)
    grads = []
    for p, t in zip(leaves, trained):
        g = p.grad if p.grad is not None else torch.zeros_like(p, requires_grad=False)
        p.grad = None
        if data is not None and t:
            g = g.contiguous()
            dist.all_reduce(g, group=data)
        grads.append(g / k if k > 1 else g)
    it = iter(grads)
    return loss_sum / k if k > 1 else loss_sum, tree_map(lambda _: next(it), params)


def apply_updates(params: Any, updates: Any) -> None:
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u)


def _mesh_of(mesh: pmesh.Mesh | None, tree: Any) -> pmesh.Mesh:
    """``mesh``, else the one-process grid on the tree's device."""
    return mesh or pmesh.local_mesh(tree_leaves(tree)[0].device)


def make_train_step(model_cfg: TransformerConfig, cfg: FinetuneConfig, opt: AdamW, grad_mask: Any | None = None,
                    compute_dtype=torch.bfloat16, mesh: pmesh.Mesh | None = None):
    """-> train_step(state, batch) -> (state, {"loss", "grad_norm"}) over the
    whole tree.

    With ``gradient_accumulation_steps`` k > 1 the batch carries a leading
    micro-batch axis of k; loss and grads are the means over the micro-batches
    (finetune.py:320-340). ``grad_mask`` (``trainable_mask``) multiplies the
    grads before the optimizer and the updates after it, so frozen slices
    stay bit-identical (AdamW's decay would move them otherwise); leaves whose
    mask is a 0 get no autograd. ``grad_norm`` is the global norm of the
    (masked) grads, before clipping. The loss and the norm are 0-d tensors on
    the params' device (no host sync).

    ``mesh``: sharded training (module docstring). ``state`` holds this
    rank's shards (``grad_mask`` the masks of them, ``model_cfg`` the whole
    model's config) and ``batch`` the global batch; every rank of the grid
    calls the step with the same batch."""
    k = cfg.gradient_accumulation_steps
    trained_by_mask = None if grad_mask is None else [
        bool((m != 0).any()) if torch.is_tensor(m) else m != 0 for m in tree_leaves(grad_mask)]

    def train_step(state: TrainState, batch: dict):
        params = state.params
        m = _mesh_of(mesh, params)
        trained = trained_by_mask or [True] * len(tree_leaves(params))
        b = to_device(batch, m.device)
        if k > 1:
            micro = [{key: v[i] for key, v in b.items()} for i in range(k)]
            seeds = [step_seed(cfg.seed, state.step, i) for i in range(k)]
        else:
            micro, seeds = [b], [step_seed(cfg.seed, state.step)]
        loss, grads = mean_grads(params, trained,
                                 lambda mb, gen: loss_fn(params, model_cfg, mb, compute_dtype, gen, m), micro, seeds,
                                 m)
        if grad_mask is not None:
            grads = apply_grad_mask(grads, grad_mask)
        norm = global_norm(grads, m)
        updates, opt_state = opt.update(grads, state.opt_state, params, norm)
        if grad_mask is not None:
            updates = apply_grad_mask(updates, grad_mask)
        apply_updates(params, updates)
        return TrainState(params, opt_state, state.step + 1), {"loss": loss, "grad_norm": norm}

    return train_step


def make_eval_step(model_cfg: TransformerConfig, compute_dtype=torch.bfloat16, mesh: pmesh.Mesh | None = None):
    """-> eval_step(params, batch) -> the loss (a 0-d tensor), no dropout.
    ``mesh``: this rank's shards and the global batch, as ``make_train_step``
    takes them; the loss is the global mean on every rank."""

    @torch.no_grad()
    def eval_step(params, batch):
        m = _mesh_of(mesh, params)
        loss = loss_fn(params, model_cfg, to_device(batch, m.device), compute_dtype, None, m)
        if m.data_group is not None:
            dist.all_reduce(loss, group=m.data_group)
        return loss

    return eval_step


# --------------------------------------------------------------------------------------
# Last-N-block finetuning on a split trainable tail
# --------------------------------------------------------------------------------------
#
# The mask path computes grads and Adam moments for EVERY parameter. The
# reference trains with requires_grad on the last N blocks only
# (fam/llm/finetune.py:236-244); the equivalent here splits each stacked
# layer leaf into a frozen head and a trainable tail, so grads and moments
# scale with the trainable fraction. The forward takes each layer's weights
# from the head or the tail (transformer.layer_list), never concatenating
# the stacks.


def split_trainable(params: Any, last_n_blocks: int) -> tuple[Any, Any]:
    """params -> (frozen_tree, trainable_tree): the trainable tree holds the
    last ``last_n_blocks`` of every stacked layer leaf (``layers_tail``) and
    the final norm, as copies; the frozen tree (``layers_head`` and every
    other leaf) views the caller's tensors."""
    n = last_n_blocks
    frozen = tree_map(lambda v: v.detach(), {k: v for k, v in params.items()
                                             if k != "layers" and not k.startswith("ln_f")})
    frozen["layers_head"] = {k: v[:-n].detach() for k, v in params["layers"].items()}
    train = {"layers_tail": {k: v[-n:].detach().clone() for k, v in params["layers"].items()}}
    for k, v in params.items():
        if k.startswith("ln_f"):
            train[k] = v.detach().clone()
    return frozen, train


def merge_trainable(frozen: Any, train: Any) -> Any:
    """-> the whole stacked tree (new tensors for the stacks)."""
    params = {k: v for k, v in frozen.items() if k != "layers_head"}
    params["layers"] = {k: torch.cat([frozen["layers_head"][k], train["layers_tail"][k].detach()])
                        for k in frozen["layers_head"]}
    for k, v in train.items():
        if k != "layers_tail":
            params[k] = v.detach()
    return params


def split_view(frozen: Any, train: Any) -> Any:
    """The params a forward needs, without copying: ``layers`` as the list of
    per-layer weight dicts, the head's then the tail's."""
    params = {k: v for k, v in frozen.items() if k != "layers_head"}
    params["layers"] = tfm.layer_list(frozen["layers_head"]) + tfm.layer_list(train["layers_tail"])
    for k, v in train.items():
        if k != "layers_tail":
            params[k] = v
    return params


def make_finetune_step(model_cfg: TransformerConfig, cfg: FinetuneConfig, opt: AdamW, frozen: Any,
                       compute_dtype=torch.bfloat16, mesh: pmesh.Mesh | None = None):
    """-> step(state, batch) -> (state, {"loss", "grad_norm"}) over the
    trainable tail only (``state.params`` is ``split_trainable``'s trainable
    tree). As in the JAX package, the step takes one batch (no accumulation)
    and draws dropout from the step's seed. ``mesh``: sharded training, the
    tail and ``frozen`` split from this rank's shards (``make_train_step``)."""

    def step(state: TrainState, batch: dict):
        train = state.params
        m = _mesh_of(mesh, frozen)
        b = to_device(batch, m.device)
        trained = [True] * len(tree_leaves(train))
        loss, grads = mean_grads(train, trained,
                                 lambda mb, gen: loss_fn(split_view(frozen, train), model_cfg, mb, compute_dtype, gen,
                                                         m),
                                 [b], [step_seed(cfg.seed, state.step)], m)
        norm = global_norm(grads, m)
        updates, opt_state = opt.update(grads, state.opt_state, train, norm)
        apply_updates(train, updates)
        return TrainState(train, opt_state, state.step + 1), {"loss": loss, "grad_norm": norm}

    return step
