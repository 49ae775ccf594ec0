"""Train and eval steps, losses, learning-rate schedule and optimizers
(port of ``featurenet_tpu/train/steps.py``).

PyTorch runs eagerly, so a step is a plain function that runs forward,
backward and the update on the state's model in place. The optimizers are
written out by hand to follow optax's update order exactly (the port does
not use optax):

- ``adamw``: ``p ← p − lr·(m̂/(√v̂ + eps) + wd·p)`` on every parameter,
  batch-norm scale/bias and biases included (optax applies no mask);
  b1 0.9, b2 0.999, eps 1e-8.
- ``adam``: the same without decay; ``sgd``: momentum 0.9,
  ``t ← g + 0.9·t``, ``p ← p − lr·t``.
- ``grad_clip > 0`` first scales the gradients to that global norm when
  they exceed it (``optax.clip_by_global_norm``).

The schedule is ``optax.warmup_cosine_decay_schedule`` with init 0, end
``peak·0.01`` and ``decay_steps = max(total, warmup + 1)``; at step 0 the
rate is 0, so the first update moves no parameter.

A step augments in the reference's order (``make_train_step``): unpack;
with ``augment_groups > 0`` either the affine warp (``augment_affine``; in
fp32, after the cast, under every precision policy, as the reference warps
its float grid) or the cube rotation (on the 0/1 bytes, before the cast);
then, with ``augment_noise``, the occupancy flips; then the update. The
step applies the draws its caller hands it (``ops/augment.py``): the
cube-group codes, the affine draw, the flip mask and dropout's generator.
``StepDraws`` makes them on the device, each draw of step ``s`` from a
generator seeded by ``(seed, s, stream)`` alone, so a step draws the same
whether it runs alone, as one of k steps of a dispatch or after a resume.
The resident step (``make_resident_train_step``, the reference's
``make_hbm_multi_train_step``) gathers its batch from a split that lives
on the device, at row indices drawn there (``draw_rows``), and runs the
same step.

The step follows the state's precision policy (``train/precision.py``):
under ``bf16_master`` and ``fp16_scaled`` the forward runs on a working
copy of the parameters (``torch.func.functional_call``) and the gradients
are taken with respect to that copy, so they are stored, rounded and, in
fp16, overflow at the working dtype, as the JAX step's do; they are upcast
to fp32 before the update. ``fp16_scaled`` is the port of the reference's
``_scaled_update``: the loss is scaled by ``state.loss_scale``, the
gradients upcast and then unscaled, one finiteness verdict taken over all
of them, and a non-finite step skipped bitwise: parameters, moments, the
optimizer's count and the batch-norm statistics (which the forward moves
in place, so they are restored from a snapshot) keep their bits; only
``state.step`` advances and the scale halves. The verdict stays on the
device: every slot is computed as if the step applied and then merged with
its old value by ``torch.where(finite, new, old)``, as the reference merges
its two states with ``jnp.where``. The optimizer's ``count`` is a 0-d
int32 tensor on the parameters' device, and the learning rate and Adam's
bias corrections are computed from it there, so no train step reads a
device value on the host. Every slot a step writes (parameters, moments,
``count``, batch-norm statistics, the loss-scale state) is written in
place, so a CUDA graph of steps (``runtime/registry.py`` ``TrainProgram``)
replays against the live state.

``task="segment"`` trains the segmenter on the per-voxel target ``seg``
(int8 on the wire, int64 in the loss) with ``segmentation_loss``: the
reference's foreground-balanced cross-entropy (``balanced_ce``), plus its
soft Dice (``ce_dice``), or the Dice alone (``dice``), in its order of
arithmetic. The cross-entropy reads the logits in the channels-last layout
the model gives (``logsumexp`` and a gather on the last axis, no transposed
copy), and the Dice takes each class's intersection as a sum of the true
class's probability over its voxels (a gather and ``class_sums``), not
through an fp32 one-hot of the target. A cube rotation in the step turns
``seg`` with the voxels, group by group, by the same codes
(``ops/augment.py`` ``rotate_pair_by_codes``). The eval step of a segment
batch sums, per class, the intersection and union of the predicted and
true voxels of the rows its mask keeps, and ``aggregate_eval`` turns them
into ``mean_iou`` (over the classes present in either) and
``per_class_iou``.

Data parallelism (``parallel/mesh.py``): in a ``torch.distributed``
world each process runs the step on its block of the global batch, and
the step computes what the reference's GSPMD step computes over the
global batch. The model normalises with the global batch's statistics and
draws the global dropout mask (``models/featurenet.py``); the segmentation
loss takes its foreground share and its Dice sums over the world. After
the backward the gradients (upcast and, under ``fp16_scaled``, unscaled)
and the metric scalars go through one all-reduce of a flat buffer and a
division by the world size: before the global norm, the clip, the
finiteness verdict and the update, so every rank applies (or skips) the
same update and logs the same metrics. Every draw of a step is made at the
global batch from generators every rank seeds alike, and each rank keeps
its rows (``StepDraws``), except the resident rows: each rank draws its
local batch from its own block of the split, its ``rows`` stream seeded
with its rank folded in, as the reference's resident draw folds the data
axis index. Without a process group none of this runs.

On a model axis (a model laid on it by ``FeatureNet.shard``) the ranks of
one data row hold the same rows: the step augments them whole and, under
``spatial``, hands the model this rank's depth slab (``model_slab``).
``sync_gradients`` reduces each gradient by where it lives (the model's
``grad_kinds``): a replicated parameter's slab or column partials are
summed over the model axis and averaged over the data axis, a gradient
already the same on every model rank is averaged over the data axis (one
flat all-reduce over the world carries both, and the metrics), and a
column shard is averaged over the data axis on its owner. The global norm
(``grad_norm``, and ``grad_clip``'s) counts each shard once, the
``fp16_scaled`` verdict is one for the model ranks, and the metrics, the
same on every model rank, are counted once each.

The update runs inside the profiler range ``optimizer``
(``record_function``), beside the model's ``casts`` and ``bn_relu``.

``eval_step`` applies the serving precision's cast (``serve_params_cast``)
before its forward, as the reference's ``make_eval_step`` does, so
held-out eval measures the forward serving runs.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from featurenet_tpu_torch.ops.augment import (
    AffineDraw,
    affine_prob,
    affine_warp,
    affine_warp_pair,
    draw_affine,
    draw_code_tensor,
    draw_flips,
    group_count,
    occupancy_noise,
    rotate_by_codes,
    rotate_pair_by_codes,
)
from featurenet_tpu_torch.config import SEG_LOSSES
from featurenet_tpu_torch.parallel.mesh import (
    all_reduce_flat,
    all_reduce_sum,
    axis_of,
    in_world,
    rank_world,
)
from featurenet_tpu_torch.runtime import forward_with
from featurenet_tpu_torch.train.precision import (
    LOSS_SCALE_GROWTH_INTERVAL,
    LOSS_SCALE_MAX,
    LOSS_SCALE_MIN,
    POLICIES,
    PrecisionPolicy,
    serve_params_cast,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SGD_MOMENTUM = 0.9


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``data.synthetic.pack_voxels`` on the device:
    ``[B, R, R, R/8] uint8`` → ``[B, R, R, R, 1] uint8`` of 0/1, MSB first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    b, d, h, w8 = packed.shape
    return bits.reshape(b, d, h, w8 * 8, 1)


def unpack_voxels(packed: torch.Tensor) -> torch.Tensor:
    """``unpack_bits`` as ``float32``."""
    return unpack_bits(packed).float()


def step_voxels(packed: torch.Tensor, codes=None,
                affine: Optional[AffineDraw] = None,
                flips: Optional[torch.Tensor] = None,
                seg: Optional[torch.Tensor] = None):
    """The float voxels a train step computes on: unpacked; with ``codes``
    (a sequence or a tensor) rotated group by group before the cast, on the
    0/1 bytes, or with ``affine`` cast and then warped; then, with
    ``flips``, their occupancy flipped. With ``seg`` (a per-voxel target
    ``[B, R, R, R]``) returns ``(voxels, seg)``, the target rotated by the
    same codes or warped by the same draw (order 0,
    ``ops/augment.py`` ``affine_warp_pair``)."""
    bits = unpack_bits(packed)
    if codes is not None:
        codes = torch.as_tensor(codes, device=bits.device)
        if seg is None:
            bits = rotate_by_codes(bits, codes)
        else:
            bits, seg = rotate_pair_by_codes(bits, seg, codes)
    voxels = bits.float()
    if affine is not None:
        if seg is None:
            voxels = affine_warp(voxels, *affine)
        else:
            voxels, seg = affine_warp_pair(voxels, seg, *affine)
    if flips is not None:
        voxels = occupancy_noise(voxels, flips)
    return voxels if seg is None else (voxels, seg)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        label_smoothing: float = 0.0):
    """Mean softmax cross-entropy (labels smoothed toward uniform by
    ``label_smoothing``) and accuracy; returns ``(loss, metrics)``."""
    labels = labels.long()
    loss = F.cross_entropy(logits, labels, label_smoothing=label_smoothing)
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def class_sums(index: torch.Tensor, values: torch.Tensor,
               n_cls: int) -> torch.Tensor:
    """``out[c] = Σ values[index == c]`` over ``[B, D, H, W]`` tensors, in
    ``values``' dtype (differentiable in ``values``): a scatter-add into
    one row of ``n_cls`` bins per ``(b, d)`` plane, then the rows summed.
    The adds of a 64³ batch spread over ``B·D·n_cls`` addresses; one row of
    bins for the whole batch makes 8 M atomic adds contend for 25 (on an
    H100 the seg64 loss's forward took 32.7 ms that way, 7.5 ms spread)."""
    rows = index.reshape(-1, index.shape[-2] * index.shape[-1]).long()
    bins = torch.zeros((rows.shape[0], n_cls), dtype=values.dtype,
                       device=values.device)
    return bins.scatter_add(1, rows, values.reshape(rows.shape)).sum(0)


def _soft_dice(logits: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Mean soft-Dice loss over the classes present in the batch
    (background included): ``1 - (2·inter + 1) / (Σprob + count + 1)`` per
    class. ``inter`` sums the probability of each voxel's true class into
    that class, ``count`` the voxels of each class (``class_sums``)."""
    n_cls = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    p_true = probs.gather(-1, seg[..., None])[..., 0]
    inter = class_sums(seg, p_true, n_cls)
    count = class_sums(seg, torch.ones_like(p_true), n_cls)
    total = probs.sum(dim=tuple(range(probs.dim() - 1)))
    if rank_world()[1] > 1:  # the global batch's sums
        inter, count, total = all_reduce_sum(torch.stack([inter, count, total]))
    denom = total + count
    present = (count > 0).float()
    dice = 1.0 - (2.0 * inter + 1.0) / (denom + 1.0)
    return (dice * present).sum() / torch.clamp(present.sum(), min=1.0)


def segmentation_loss(logits: torch.Tensor, seg: torch.Tensor,
                      variant: str = "balanced_ce"):
    """Per-voxel loss of fp32 logits ``[B, D, H, W, C+1]`` against ``seg``
    ``[B, D, H, W]`` (0 = background) and its metrics (``loss``,
    ``accuracy``, ``fg_accuracy``); returns ``(loss, metrics)``.

    - ``balanced_ce``: cross-entropy with each foreground voxel weighted
      ``0.5 / max(fg_frac, 1e-4)`` and each background one ``0.5 /
      max(1 - fg_frac, 1e-4)``, ``fg_frac`` the batch's foreground share;
    - ``ce_dice``: that plus ``_soft_dice``;
    - ``dice``: ``_soft_dice`` alone."""
    if variant not in SEG_LOSSES:
        raise ValueError(f"unknown segmentation loss variant {variant!r}")
    seg = seg.long()
    with record_function("loss"):
        lse = torch.logsumexp(logits, dim=-1)
        per_voxel = lse - logits.gather(-1, seg[..., None])[..., 0]
        fg = seg > 0
        is_fg = fg.float()
        with torch.no_grad():
            hit = (logits.argmax(dim=-1) == seg).float()
        world = rank_world()[1]
        if world > 1:
            # The global batch's foreground count and foreground hits.
            with torch.no_grad():
                n_fg, fg_hits = all_reduce_sum(
                    torch.stack([is_fg.sum(), (hit * is_fg).sum()]))
            fg_frac = n_fg / (is_fg.numel() * world)
        else:
            n_fg, fg_hits = is_fg.sum(), None
            fg_frac = is_fg.mean()
        w = torch.where(fg, 0.5 / torch.clamp(fg_frac, min=1e-4),
                        0.5 / torch.clamp(1.0 - fg_frac, min=1e-4))
        ce = (per_voxel * w).mean()
        if variant == "balanced_ce":
            loss = ce
        elif variant == "ce_dice":
            loss = ce + _soft_dice(logits, seg)
        else:
            loss = _soft_dice(logits, seg)
        with torch.no_grad():
            acc = hit.mean()
            if fg_hits is None:
                fg_hits = (hit * is_fg).sum()
            fg_acc = torch.where(n_fg > 0,
                                 fg_hits / torch.clamp(n_fg, min=1.0),
                                 torch.zeros_like(n_fg))
    return loss, {"loss": loss, "accuracy": acc, "fg_accuracy": fg_acc}


def global_norm(tensors: Sequence[torch.Tensor],
                shards: Optional[Sequence[bool]] = None,
                group=None) -> torch.Tensor:
    """``sqrt(Σ x²)`` over every element of every tensor (optax's). With
    ``shards`` (one flag per tensor: a column shard of a model axis), the
    shards' squares are summed over ``group``, the model axis, so each
    shard counts once and every model rank gets the same norm."""
    if shards is None or not any(shards):
        return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))
    sq = [(t.float() * t.float()).sum() for t in tensors]
    part = torch.stack([q for q, sh in zip(sq, shards) if sh]).sum()
    whole = all_reduce_flat([part.reshape(1)], group=group)[0].reshape(())
    rest = [q for q, sh in zip(sq, shards) if not sh]
    return torch.sqrt(sum(rest) + whole)


def make_lr_schedule(peak_lr: float, warmup_steps: int,
                     total_steps: int) -> Callable[[torch.Tensor | int], torch.Tensor]:
    """``optax.warmup_cosine_decay_schedule``: linear warmup from 0 to
    ``peak_lr``, then cosine decay to ``peak_lr·0.01`` at
    ``max(total_steps, warmup_steps + 1)``. The schedule maps a count (a
    tensor, or an int) to a 0-d fp32 tensor on the count's device,
    evaluated in fp32 in optax's order of operations."""
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    end = peak_lr * 0.01
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr

    def schedule(count) -> torch.Tensor:
        step = torch.as_tensor(count).float()
        if warmup_steps > 0:
            frac = 1.0 - torch.clamp(step, 0, warmup_steps) / warmup_steps
            warm = (0.0 - peak_lr) * frac + peak_lr
        else:
            warm = torch.zeros_like(step)
        t = torch.clamp(step - warmup_steps, max=decay_steps)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / decay_steps))
        decayed = peak_lr * ((1.0 - alpha) * cosine + alpha)
        return torch.where(step < warmup_steps, warm, decayed)

    return schedule


class Optimizer:
    """optax's ``adamw``/``adam``/``sgd(momentum=0.9)``, optionally after
    ``clip_by_global_norm``, over a fixed list of parameters.

    ``mu``/``nu`` are Adam's moments (``mu`` is SGD's trace), one tensor per
    parameter; ``count`` is the number of updates applied, which is also
    the schedule's step: a 0-d int32 tensor on the parameters' device.
    Every slot is written in place by ``update`` (a CUDA graph of it reads
    the addresses it saw at capture); ``count`` reads as a copy, a value
    as optax's is, and assigning it copies into the live tensor.
    """

    def __init__(self, params: Sequence[torch.Tensor], kind: str,
                 schedule: Callable, weight_decay: float = 0.0,
                 grad_clip: float = 0.0):
        if kind not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.params = list(params)
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = weight_decay if kind == "adamw" else 0.0
        self.grad_clip = grad_clip
        device = self.params[0].device if self.params else None
        self._count = torch.zeros((), dtype=torch.int32, device=device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = ([torch.zeros_like(p) for p in self.params]
                   if kind != "sgd" else [])
        # On a model axis: which parameters are column shards, and the
        # model axis's group, so grad_clip's norm counts each shard once.
        self.shards: Optional[list[bool]] = None
        self.model_group = None

    @property
    def count(self) -> torch.Tensor:
        return self._count.clone()

    @count.setter
    def count(self, value) -> None:
        with torch.no_grad():
            self._count.copy_(torch.as_tensor(value))

    def tensors(self) -> list[torch.Tensor]:
        """The live slots ``update`` writes besides the parameters: the
        moments and ``count``."""
        return [*self.mu, *self.nu, self._count]

    @torch.no_grad()
    @record_function("optimizer")
    def update(self, grads: Sequence[torch.Tensor],
               finite: torch.Tensor | None = None) -> None:
        """Apply one update from ``grads`` (one per parameter) in place.
        With ``finite`` (a 0-d bool tensor), every slot (parameters,
        moments, count) becomes ``torch.where(finite, updated, old)``: a
        false verdict leaves them bitwise as they were, decided on the
        device."""
        grads = list(grads)
        if self.grad_clip > 0.0:
            norm = global_norm(grads, self.shards, self.model_group)
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, g / norm * self.grad_clip)
                     for g in grads]
        lr = self.schedule(self._count)
        count = self._count + 1

        def put(dst: torch.Tensor, new: torch.Tensor) -> None:
            dst.copy_(new if finite is None else torch.where(finite, new, dst))

        if self.kind == "sgd":
            for p, g, t in zip(self.params, grads, self.mu):
                trace = g + SGD_MOMENTUM * t
                put(p, p + trace * (-lr))
                put(t, trace)
        else:
            c1 = 1.0 - ADAM_B1 ** count
            c2 = 1.0 - ADAM_B2 ** count
            for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
                m_new = (1.0 - ADAM_B1) * g + ADAM_B1 * m
                v_new = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v
                u = (m_new / c1) / (torch.sqrt(v_new / c2) + ADAM_EPS)
                if self.weight_decay:
                    u = u + self.weight_decay * p
                put(p, p + u * (-lr))
                put(m, m_new)
                put(v, v_new)
        put(self._count, count)


def make_optimizer(cfg, params: Sequence[torch.Tensor]) -> Optimizer:
    sched = make_lr_schedule(cfg.peak_lr, cfg.warmup_steps, cfg.total_steps)
    return Optimizer(params, cfg.optimizer, sched,
                     weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)


def loss_and_grads(model, voxels: torch.Tensor, labels: torch.Tensor,
                   label_smoothing: float = 0.0,
                   generator: torch.Generator | None = None,
                   policy: PrecisionPolicy = POLICIES["fp32"],
                   loss_scale: torch.Tensor | None = None,
                   loss_fn: Callable | None = None):
    """Train-mode forward (batch statistics move) and the gradient of the
    loss (times ``loss_scale`` when given) for every parameter, in
    ``model.parameters()`` order, with respect to ``policy``'s working
    copy: the masters under ``fp32``, else a cast of them, whose gradients
    come back at the working dtype. The loss is ``classification_loss`` of
    ``labels``, or ``loss_fn(logits, labels) -> (loss, metrics)`` when
    given. Metrics hold the unscaled loss."""
    if policy.working_dtype is None:
        logits = model(voxels, train=True, generator=generator)
        leaves = list(model.parameters())
    else:
        work = policy.working_params(dict(model.named_parameters()))
        logits = forward_with(model, work, voxels, train=True,
                              generator=generator)
        leaves = list(work.values())
    if loss_fn is None:
        loss, metrics = classification_loss(logits, labels, label_smoothing)
    else:
        loss, metrics = loss_fn(logits, labels)
    target = loss if loss_scale is None else loss * loss_scale
    grads = torch.autograd.grad(target, leaves)
    return grads, metrics


def sync_gradients(grads, metrics: dict, model):
    """In a process group: ``grads`` of ``model``'s parameters reduced by
    where each lives on its mesh (``axis_of``; see the module docstring),
    and the world's mean of the metric scalars; a data axis alone (no model
    axis) takes the world's mean of every gradient, all from one all-reduce
    of a flat buffer (a one-process world's is the identity). Without a
    process group, both as they are."""
    if not in_world():
        return list(grads), metrics
    keys, axis, grads = list(metrics), axis_of(model), list(grads)
    # Without a model axis every gradient is the same kind.
    kinds = (model.grad_kinds() if axis.size > 1
             else ["replicated"] * len(grads))
    world = [i for i, k in enumerate(kinds) if k != "shard"]
    shards = [i for i, k in enumerate(kinds) if k == "shard"]
    out = all_reduce_flat([*(grads[i] for i in world),
                           *(metrics[k].reshape(1) for k in keys)])
    synced = list(grads)
    for i, g in zip(world, out):
        # The world's sum: M equal copies of a replicated gradient, or the
        # M parts of a partial one, on each of D data rows.
        synced[i] = g / (axis.data_size * (axis.size if kinds[i] ==
                                           "replicated" else 1))
    if shards and axis.data_size > 1:
        for i, g in zip(shards, all_reduce_flat(
                [grads[i] for i in shards], mean=True, group=axis.data_group)):
            synced[i] = g
    ranks = axis.data_size * axis.size
    return synced, {k: (v / ranks).reshape(())
                    for k, v in zip(keys, out[len(world):])}


def grad_norm(state, grads) -> torch.Tensor:
    """The global norm of synced ``grads`` of ``state``'s parameters,
    each column shard of a model axis counted once."""
    opt = state.optimizer
    return global_norm(grads, opt.shards, opt.model_group)


def model_slab(model, voxels: torch.Tensor) -> torch.Tensor:
    """This rank's depth slab of ``voxels`` on ``model``'s spatial model
    axis, else ``voxels``."""
    return axis_of(model).slab(voxels)


def _scaled_update(state, voxels, labels, label_smoothing, generator,
                   loss_fn=None) -> dict:
    """The ``fp16_scaled`` step (the reference's ``_scaled_update``): scale
    the loss, upcast then unscale the gradients, one finiteness verdict;
    apply, or skip bitwise with the batch-norm statistics put back; grow
    the scale after ``LOSS_SCALE_GROWTH_INTERVAL`` finite steps in a row,
    halve it on a non-finite one."""
    model, policy, scale = state.model, state.policy, state.loss_scale
    stats = [b.detach().clone() for b in model.buffers()]
    grads, metrics = loss_and_grads(model, voxels, labels, label_smoothing,
                                    generator, policy, loss_scale=scale,
                                    loss_fn=loss_fn)
    # Upcast first, then unscale: dividing in fp16 would overflow again.
    inv = 1.0 / scale
    grads = [g * inv for g in policy.master_grads(grads)]
    # One verdict for the world: a rank's overflow is in the sum (and a
    # column shard's, on a model axis, in the model ranks' count).
    grads, metrics = sync_gradients(
        grads, {k: v.detach() for k, v in metrics.items()}, model)
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    if state.optimizer.shards is not None:
        bad = all_reduce_flat([(~finite).float().reshape(1)],
                              group=state.optimizer.model_group)[0]
        finite = (bad == 0).reshape(())
    with torch.no_grad():
        for b, old in zip(model.buffers(), stats):
            b.copy_(torch.where(finite, b, old))
    metrics["grad_norm"] = grad_norm(state, grads)
    # Applied where finite, as it was elsewhere; the step advances either way.
    state.apply_gradients(grads, finite)
    good = torch.where(finite, state.good_steps + 1,
                       torch.zeros_like(state.good_steps))
    grow = good >= LOSS_SCALE_GROWTH_INTERVAL
    new_scale = torch.where(
        finite,
        torch.where(grow, torch.clamp(scale * 2.0, max=LOSS_SCALE_MAX), scale),
        torch.clamp(scale * 0.5, min=LOSS_SCALE_MIN))
    state.good_steps.copy_(torch.where(grow, torch.zeros_like(good), good))
    state.loss_scale.copy_(new_scale)
    metrics["loss_scale"] = new_scale
    metrics["grads_finite"] = finite.float()
    return metrics


def make_train_step(label_smoothing: float = 0.0, augment_groups: int = 0,
                    augment_affine: bool = False,
                    augment_noise: float = 0.0, task: str = "classify",
                    seg_loss: str = "balanced_ce") -> Callable:
    """``step(state, batch, generator, codes, affine, flips) -> metrics``:
    one update of ``state`` (``train/state.py``) in place from a wire batch
    (bit-packed voxels unpacked on the device), with the draws given
    (``StepDraws`` makes them): dropout draws from ``generator``; with
    ``augment_groups > 0`` the batch's ``group_count(B, augment_groups)``
    slices are posed by ``affine`` (an ``AffineDraw``) under
    ``augment_affine``, else rotated by the cube-group ``codes``; with
    ``augment_noise > 0`` the voxels in ``flips`` are flipped. Metrics are
    device scalars: ``loss``, ``accuracy`` and ``grad_norm``, the global
    norm of the gradients, and under ``fp16_scaled`` ``loss_scale`` (after
    the verdict) and ``grads_finite`` (1.0 or 0.0).

    ``task="segment"`` trains on the batch's per-voxel ``seg`` with
    ``segmentation_loss(variant=seg_loss)`` (metrics add ``fg_accuracy``),
    rotating it with the voxels, or under ``augment_affine`` warping it by
    the same draw (nearest, so labels never blend)."""
    warp = bool(augment_affine and augment_groups)
    if task not in ("classify", "segment"):
        raise ValueError(f"unknown task {task!r}")
    target_key = "label" if task == "classify" else "seg"
    loss_fn = (None if task == "classify" else
               lambda logits, seg: segmentation_loss(logits, seg, seg_loss))

    def train_step(state, batch: dict, generator=None, codes=None,
                   affine: Optional[AffineDraw] = None,
                   flips: Optional[torch.Tensor] = None) -> dict:
        groups = group_count(batch["voxels"].shape[0], augment_groups) \
            if augment_groups else 0
        if groups and not warp and (codes is None or len(codes) != groups):
            raise ValueError(f"the step rotates {groups} groups; got "
                             f"rotation codes {codes}")
        if groups and warp and (affine is None or len(affine.take) != groups):
            raise ValueError(f"the step warps {groups} groups; got affine "
                             f"draw {affine}")
        if (codes is not None and (warp or not groups)) or \
                (affine is not None and not warp):
            raise ValueError("pose draws given to a step that does not pose "
                             "by them")
        if (flips is None) != (augment_noise <= 0.0):
            raise ValueError(f"a step with augment_noise={augment_noise} "
                             f"needs a flip mask exactly when it is > 0")
        if loss_fn is None:
            voxels = step_voxels(batch["voxels"], codes, affine, flips)
            target = batch["label"]
        else:
            voxels, target = step_voxels(batch["voxels"], codes, affine, flips,
                                         seg=batch["seg"])
        voxels = model_slab(state.model, voxels)
        policy = state.policy
        if policy.loss_scaling:
            return _scaled_update(state, voxels, target, label_smoothing,
                                  generator, loss_fn)
        grads, metrics = loss_and_grads(state.model, voxels, target,
                                        label_smoothing, generator, policy,
                                        loss_fn=loss_fn)
        grads, metrics = sync_gradients(
            policy.master_grads(grads),
            {k: v.detach() for k, v in metrics.items()}, state.model)
        metrics["grad_norm"] = grad_norm(state, grads)
        state.apply_gradients(grads)
        return metrics

    return train_step


def draw_rows(generator: torch.Generator, rows: int, batch: int) -> torch.Tensor:
    """``batch`` row indices drawn uniformly from ``[0, rows)`` on the
    generator's device."""
    return torch.randint(0, rows, (batch,), generator=generator,
                         device=generator.device)


def gather_rows(data: torch.Tensor, labels: torch.Tensor,
                idx: torch.Tensor, key: str = "label") -> dict:
    """The wire batch of resident rows ``idx``: packed voxels of ``data``
    ``uint8 [N, R, R, R/8]`` and, under ``key``, the targets of ``labels``
    (``int32 [N]`` labels, or the int8 per-voxel ``seg [N, R, R, R]``)."""
    return {"voxels": data.index_select(0, idx),
            key: labels.index_select(0, idx)}


def make_resident_train_step(label_smoothing: float = 0.0,
                             augment_groups: int = 0,
                             augment_affine: bool = False,
                             augment_noise: float = 0.0,
                             task: str = "classify",
                             seg_loss: str = "balanced_ce") -> Callable:
    """``step(state, data, labels, idx, generator, codes, affine, flips) ->
    metrics``: the train step of ``make_train_step`` on the rows ``idx`` of
    a split that lives on the device (``draw_rows`` draws them there; one
    inner step of the reference's ``make_hbm_multi_train_step``);
    ``labels`` holds the split's targets, the per-voxel ``seg`` for
    ``task="segment"``."""
    step = make_train_step(label_smoothing, augment_groups, augment_affine,
                           augment_noise, task, seg_loss)
    key = "label" if task == "classify" else "seg"

    def resident_step(state, data, labels, idx, generator=None, codes=None,
                      affine=None, flips=None) -> dict:
        return step(state, gather_rows(data, labels, idx, key), generator,
                    codes, affine, flips)

    return resident_step


# The draw streams of a train step, each with its constant; rows' and the
# cube codes' are the reference's folds for its resident draw and the
# constants of earlier runs.
DRAW_STREAMS = {"dropout": 0xD20, "rows": 0x5A11, "codes": 0xA06,
                "affine": 0xAFF1, "noise": 0xF11B}


def stream_seed(seed: int, step: int, stream: str,
                fold: Optional[int] = None) -> int:
    """The 64-bit generator seed of one draw stream at one step, with
    ``fold`` (a rank) folded in when given."""
    key = [seed, step, DRAW_STREAMS[stream]] + ([] if fold is None else [fold])
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


class StepDraws:
    """The random draws of a run's train steps, made on ``device``: one
    ``torch.Generator`` per stream for each of ``slots`` inner steps of a
    dispatch, so each of k steps captured in one CUDA graph has its own
    (registered with the graph, ``generators``). ``seed(step, take)``
    reseeds slot ``j`` for step ``step + j`` (every stream from
    ``stream_seed(seed, step + j, stream)``) and writes ``step + j`` into
    ``steps[j]``, the device step count the affine ramp reads; the host
    does this before each dispatch, and a graph reads the generators' seeds
    and the counts at replay.

    Streams: ``dropout`` always; ``rows`` for a resident split (``rows >
    0``); with ``cfg.device_augment`` the cube ``codes``, or under
    ``cfg.augment_affine`` the ``affine`` draw; ``noise`` when
    ``cfg.augment_noise > 0``.

    In a data-parallel world (``shard`` of ``num_shards`` feed groups, the
    ``parallel/mesh.py`` ``feed_shards`` of this rank) every stream but
    ``rows`` is seeded alike on every rank and ``step_args`` draws at the
    global batch and hands over this shard's part: its groups' codes or
    affine draws (the global group count must divide over the shards), its
    rows' flips. ``rows`` draws this shard's ``global_batch / num_shards``
    rows from its own block of ``rows``, its seed folded with the shard.
    """

    def __init__(self, cfg, slots: int, device, rows: int = 0,
                 num_shards: int = 1, shard: int = 0):
        self.seed_value = cfg.seed
        self.num_shards, self.shard = num_shards, shard
        self.batch = cfg.global_batch // num_shards
        self.rows = rows
        self.groups = cfg.augment_groups if cfg.device_augment else 0
        global_groups = (group_count(cfg.global_batch, self.groups)
                         if self.groups else 0)
        if global_groups % num_shards:
            raise ValueError(
                f"{global_groups} augmentation groups of a global batch "
                f"of {cfg.global_batch} do not divide over {num_shards} feed "
                "groups; set augment_groups to a multiple of the data axis")
        self.affine = bool(cfg.augment_affine and self.groups)
        self.noise = cfg.augment_noise
        self.affine_opts = dict(scale_range=cfg.augment_scale_range,
                                rotate=cfg.augment_affine_rotate,
                                translate_vox=cfg.augment_translate_vox)
        self.prob, self.ramp_steps = cfg.augment_affine_prob, cfg.augment_ramp_steps
        streams = ["dropout"]
        streams += ["rows"] if rows else []
        streams += (["affine"] if self.affine else ["codes"]) if self.groups else []
        streams += ["noise"] if self.noise > 0.0 else []
        self.streams = tuple(streams)
        device = torch.device(device)
        self._gens = [{s: torch.Generator(device=device) for s in self.streams}
                      for _ in range(slots)]
        self._offsets = torch.arange(slots, device=device)
        self.steps = torch.zeros(slots, dtype=torch.int64, device=device)

    @property
    def slots(self) -> int:
        return len(self._gens)

    def generators(self) -> list[torch.Generator]:
        return [g for slot in self._gens for g in slot.values()]

    def seed(self, step: int, take: int) -> None:
        if not 1 <= take <= self.slots:
            raise ValueError(f"{take} steps for {self.slots} draw slots")
        fold = self.shard if self.num_shards > 1 else None
        for j in range(take):
            for stream, g in self._gens[j].items():
                g.manual_seed(stream_seed(self.seed_value, step + j, stream,
                                          fold if stream == "rows" else None))
        torch.add(self._offsets, step, out=self.steps)

    def draw_rows(self, slot: int) -> torch.Tensor:
        return draw_rows(self._gens[slot]["rows"], self.rows, self.batch)

    def step_args(self, slot: int, batch: int, resolution: int) -> dict:
        """The keyword draws of ``make_train_step``'s step for inner step
        ``slot`` of this shard's batch of ``batch`` rows at
        ``resolution``."""
        gens = self._gens[slot]
        args = {"generator": gens["dropout"]}
        n, at = self.num_shards, self.shard
        full = batch * n

        def mine(t: torch.Tensor) -> torch.Tensor:  # this shard's part
            return t if n == 1 else t[at * (t.shape[0] // n):
                                      (at + 1) * (t.shape[0] // n)]

        if "codes" in gens:
            args["codes"] = mine(draw_code_tensor(gens["codes"], full,
                                                  self.groups))
        if "affine" in gens:
            prob = affine_prob(self.prob, self.ramp_steps, self.steps[slot])
            draw = draw_affine(gens["affine"], full, self.groups,
                               prob, **self.affine_opts)
            args["affine"] = draw if n == 1 else type(draw)(*map(mine, draw))
        if "noise" in gens:
            shape = (full, resolution, resolution, resolution, 1)
            args["flips"] = mine(draw_flips(gens["noise"], shape, self.noise))
        return args


@torch.no_grad()
def eval_step(model, batch: dict, serve_precision: str = "fp32") -> dict:
    """Eval sums (not means) of one wire batch, so batches add up exactly:
    ``correct``, ``loss_sum`` and ``count``, with ``confusion`` [true,
    pred] for a labelled batch, or for a segment batch (one with ``seg``)
    per-voxel sums and the per-class ``intersection`` and ``union`` of
    predicted and true voxels; rows with ``mask`` 0 count nowhere. The
    forward reads ``serve_params_cast(params, serve_precision)`` of the
    model's parameters (the masters as they are under ``fp32``)."""
    params = (None if serve_precision == "fp32" else
              serve_params_cast(dict(model.named_parameters()), serve_precision))
    logits = forward_with(model, params,
                          model_slab(model, unpack_voxels(batch["voxels"])),
                          train=False)
    mask = batch["mask"].float()
    pred = logits.argmax(dim=-1)
    n = logits.shape[-1]
    if "seg" in batch:
        seg = batch["seg"].long()
        vmask = mask[:, None, None, None]
        lse = torch.logsumexp(logits, dim=-1)
        loss = lse - logits.gather(-1, seg[..., None])[..., 0]
        vm = vmask.expand_as(seg)
        inter = class_sums(seg, (pred == seg).float() * vm, n)
        union = class_sums(pred, vm, n) + class_sums(seg, vm, n) - inter
        return {
            "correct": ((pred == seg).float() * vmask).sum(),
            "loss_sum": (loss * vmask).sum(),
            "count": mask.sum() * seg[0].numel(),
            "intersection": inter,
            "union": union,
        }
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels, reduction="none")
    confusion = (F.one_hot(labels, n).float()[:, :, None]
                 * F.one_hot(pred, n).float()[:, None, :]
                 * mask[:, None, None]).sum(0)
    return {
        "correct": ((pred == labels).float() * mask).sum(),
        "loss_sum": (loss * mask).sum(),
        "count": mask.sum(),
        "confusion": confusion,
    }


def aggregate_eval(metric_list: list[dict]) -> dict:
    """Host-side exact aggregation of per-batch eval sums: accuracy and
    loss, with the per-class accuracies and the confusion matrix of a
    classifier, or a segmenter's ``mean_iou`` over the classes present in
    the predictions or the truth and its ``per_class_iou`` (index 0 the
    background; ``None`` for a class absent from both)."""
    total: dict = {}
    for m in metric_list:
        for k, v in m.items():
            total[k] = total.get(k, 0) + v.detach().cpu().double().numpy()
    out = {
        "accuracy": float(total["correct"] / total["count"]),
        "loss": float(total["loss_sum"] / total["count"]),
    }
    if "confusion" in total:
        conf = total["confusion"]
        row = conf.sum(axis=1)
        per_class = np.where(row > 0, np.diag(conf) / np.maximum(row, 1), 0.0)
        seen = row > 0
        out["per_class_accuracy"] = per_class.round(4).tolist()
        out["mean_class_accuracy"] = float(per_class[seen].mean()
                                           if seen.any() else 0.0)
        out["confusion"] = conf.astype(int).tolist()
    if "intersection" in total:
        union = total["union"]
        present = union > 0
        iou = np.where(present, total["intersection"] / np.maximum(union, 1), 0.0)
        out["mean_iou"] = float(iou.sum() / np.maximum(present.sum(), 1))
        out["per_class_iou"] = [round(float(v), 4) if p else None
                                for v, p in zip(iou, present)]
    return out
