"""The train step (twin of ``outgridvit_tpu/training/steps.py:
make_train_step``).

One step, in the JAX step's order: augment the raw uint8 batch, mix,
train-mode forward (BatchNorm batch statistics, drop-path), soft-target or
label-smoothed cross-entropy, backward, global gradient norm, clip + masked
AdamW, the non-finite guard, metrics. The step updates the model's
parameters, BatchNorm statistics and the optimizer state in place (JAX
donates the state instead).

Randomness: the step consumes :class:`StepDraws` (augment draws, mix draws,
drop-path masks), given by the caller or sampled from a ``torch.Generator``
with :func:`sample_step_draws`: one the caller hands in, or, given a
``seed``, the step's own from :func:`step_generator` seeded from ``(seed,
state.step)``, as the JAX step folds ``state.step`` into its key, so a
resumed run draws what an uninterrupted one drew. The drop-path masks are
drawn during the forward, or, given the order the forward calls its
DropPaths in, before it (``drop_order``): bitwise the same masks. Dropout's
element-wise masks are not drawn on the host: the step computes them on the
device (``ops/dropout.py:HashedDropout``) from the seed (or, given only a
generator, its initial seed), the state's device step and the site.
``jax.random`` bits cannot be reproduced, so parity tests hand both
frameworks the same draws.

Step count: the ``lr`` metric reads the state's device step, which the step
increments in place; the returned state's host step is one more.

Non-finite guard: when the loss or the gradient norm is not finite, the
parameters, the optimizer state (moments and count) and the BatchNorm
statistics keep their values, ``nonfinite`` is 1 and the reported loss and
grad_norm are 0; the state's step advances all the same. The guard is a
select on the device, so the step needs no host sync.

The K-step train superstep (twin of ``make_train_superstep``'s
``lax.scan``) replays K train steps captured in one CUDA graph, their draws
in static device buffers (:class:`TrainSuperstep`).

On a mesh (``parallel/mesh.py``; the model placed there by
``shard_train_state``) each rank runs the step on its rows of the global
batch and the step equals the single device's, as GSPMD's does in JAX:
every rank draws the global step's draws (augment, mix and drop-path for
all rows, dropout masks by global index) and keeps its rows; the mix pairs
rows across ranks, so the augmented images and labels are gathered over
the data group before it and the rank keeps its rows of the mixed batch;
BatchNorm takes global statistics (``models/layers.py:BatchNorm``); the
gradients are summed over the data group in one all-reduce of a flat
buffer between the backward and AdamW and divided by its size; the loss
and the metrics are the means of the ranks' means; the global norm sums a
tensor-parallel parameter's blocks over the model group. Every rank then
takes the same guard decision and ends with the same BatchNorm
statistics. The all-reduces are NCCL's on the card and stay inside the
K-step graph; a gloo mesh runs eagerly only (its collectives cannot be
captured), and the supersteps raise on the card under one.

The eval step (twin of ``make_eval_step``) normalizes a raw uint8 batch in
the step when asked, runs the eval-mode forward and returns the loss and
top-1/3/5 as 0-d device tensors. The K-batch eval superstep (twin of
``make_eval_superstep``'s ``lax.scan``) replays K eval steps captured in
one CUDA graph (:class:`EvalSuperstep`).
"""

from __future__ import annotations

import dataclasses
from typing import (
    Callable,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from outgridvit_tpu_torch.ops.augment import (
    AugmentConfig,
    AugmentDraws,
    apply_augment_draws,
    normalize_batch,
    sample_augment_draws,
)
from outgridvit_tpu_torch.ops.drop_path import DropPathMasks, draw_drop_masks
from outgridvit_tpu_torch.ops.dropout import HashedDropout
from outgridvit_tpu_torch.training.losses import (
    cross_entropy_smoothed,
    soft_target_cross_entropy,
)
from outgridvit_tpu_torch.training.metrics import accuracy_topk
from outgridvit_tpu_torch.training.mixing import (
    MixDraws,
    apply_mix_draws,
    sample_mix_draws,
)
from outgridvit_tpu_torch.parallel import collectives
from outgridvit_tpu_torch.parallel.mesh import mesh_of, shard_dims_of
from outgridvit_tpu_torch.training.optim import global_norm
from outgridvit_tpu_torch.training.train_state import TrainState


@dataclasses.dataclass(frozen=True)
class StepConfig:
    num_classes: int
    label_smoothing: float = 0.1
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    mix_prob: float = 1.0
    grad_clip_norm: Optional[float] = 1.0
    # set: batches are raw uint8 images and the augmentation recipe runs in
    # the step (ops/augment.py)
    augment: Optional[AugmentConfig] = None

    @property
    def mixing(self) -> bool:
        return self.mixup_alpha > 0.0 or self.cutmix_alpha > 0.0


class StepDraws(NamedTuple):
    """Every random input of one train step; a field is None when its stage
    is off."""

    augment: Optional[AugmentDraws] = None
    mix: Optional[MixDraws] = None
    drop_masks: Optional[DropPathMasks] = None


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step ``step``'s draws, seeded from
    ``(seed, step)`` through a numpy ``SeedSequence``: the same draws
    whichever device the step runs on (they are moved to it)."""
    hi, lo = np.random.SeedSequence((int(seed), int(step))).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed((int(hi) & 0x7FFFFFFF) << 32
                                         | int(lo))


def sample_step_draws(generator: torch.Generator, cfg: StepConfig,
                      shape: Tuple[int, int, int, int], device=None,
                      drop_order: Optional[Sequence[Tuple[str, float]]]
                      = None) -> StepDraws:
    """Draw a step's augment and mix draws from ``generator``, then its
    drop-path masks: during the forward, or, given ``drop_order`` (the
    ``(path, rate)`` order the forward draws them in, as
    ``DropPathMasks(record=...)`` records it), now, bitwise the same."""
    B, H, W, _ = shape
    aug = (sample_augment_draws(generator, shape, cfg.augment, device)
           if cfg.augment is not None else None)
    mix = (sample_mix_draws(generator, B, H, W, cfg.mixup_alpha,
                            cfg.cutmix_alpha, cfg.mix_prob, device)
           if cfg.mixing and cfg.mix_prob > 0.0 else None)
    if drop_order is None:
        return StepDraws(aug, mix, DropPathMasks(generator=generator))
    masks = draw_drop_masks(generator, drop_order, B)
    return StepDraws(aug, mix, DropPathMasks(
        {p: m.to(device) for p, m in masks.items()}))


def data_rows(model: torch.nn.Module, local_batch: int
              ) -> Optional[Tuple[slice, int]]:
    """``(this rank's rows, the global batch)`` where the model's mesh
    splits the batch over more than one data rank, else None."""
    mesh = mesh_of(model)
    if mesh is None or mesh.data.size == 1:
        return None
    first = mesh.data.index * local_batch
    return slice(first, first + local_batch), local_batch * mesh.data.size


def local_draws(draws: StepDraws, rows: Optional[Tuple[slice, int]]
                ) -> StepDraws:
    """The draws of a data rank's rows (``rows`` from :func:`data_rows`)
    from a global step's draws: the per-image augment draws and drop-path
    masks of the rows (a mask generator draws for the global batch and
    keeps the rows); the mix draws stay global, as the mix runs on the
    gathered batch."""
    if rows is None:
        return draws
    sl = rows[0]
    aug = draws.augment
    if aug is not None:  # op_ids and signs are [num_ops, B]
        aug = AugmentDraws(*(
            None if t is None else (t[:, sl] if f in ("op_ids", "signs")
                                    else t[sl])
            for f, t in zip(AugmentDraws._fields, aug)))
    drop = draws.drop_masks
    if drop is not None:
        if drop.masks is not None:
            drop = DropPathMasks({p: torch.as_tensor(m)[sl]
                                  for p, m in drop.masks.items()},
                                 dropout=drop.dropout)
        else:
            drop.rows = rows
    return StepDraws(aug, draws.mix, drop)


def _all_reduce_grads(grads: Dict[str, torch.Tensor], axis
                      ) -> Dict[str, torch.Tensor]:
    """The gradients' mean over the data axis: one all-reduce of a flat
    buffer, then views of it by name."""
    names = list(grads)
    ts = [grads[k] for k in names]
    flat = torch.cat([t.reshape(-1) for t in ts])
    collectives.all_reduce_(flat, axis)
    if axis.size > 1:
        flat.div_(axis.size)
    return {k: piece.view_as(t) for k, piece, t in
            zip(names, flat.split([t.numel() for t in ts]), ts)}


def _graph_collectives(mesh, what: str) -> None:
    """Refuse a CUDA graph whose collectives would be gloo's."""
    if mesh is not None and mesh.active and mesh.backend != "nccl":
        raise RuntimeError(
            f"{what}: the mesh's {mesh.backend} collectives cannot be "
            "captured in a CUDA graph; run the single steps "
            "(steps_per_dispatch=1) or an NCCL mesh")


def make_train_step(cfg: StepConfig,
                    lr_schedule: Optional[Callable] = None):
    """Build the train step: ``(state, (images NHWC, int labels), draws=None,
    generator=None, seed=None) -> (state, metrics)``, with ``draws`` (a
    :class:`StepDraws`), a ``generator`` to sample them, or a ``seed`` to
    sample them from :func:`step_generator` at ``state.step`` (moved to
    the batch's device). The metrics are 0-d device tensors: loss, top1, top3,
    top5, grad_norm, clipped, nonfinite and, with ``lr_schedule``, lr (at
    the state's device step, which the step then increments in place).
    Sampled draws carry the step's dropout masks as a
    :class:`~outgridvit_tpu_torch.ops.dropout.HashedDropout` of ``seed``
    (else the generator's initial seed) and the device step; given
    ``draws`` bring their own (``drop_masks.dropout``) or none."""

    def train_step(state: TrainState, batch, draws: Optional[StepDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   seed: Optional[int] = None):
        images, labels = batch
        mesh = mesh_of(state.model)
        rows = data_rows(state.model, images.shape[0])
        if draws is None:
            if generator is None:
                if seed is None:
                    raise ValueError(
                        "give the step's draws or a generator, or a seed")
                generator = step_generator(seed, state.step)
            shape = tuple(images.shape)
            if rows is not None:
                shape = (rows[1],) + shape[1:]
            draws = local_draws(sample_step_draws(
                generator, cfg, shape, images.device), rows)
            draws.drop_masks.dropout = HashedDropout(
                generator.initial_seed() if seed is None else seed,
                state.device_step,
                rows=None if rows is None else (rows[0].start,
                                                images.shape[0]))
        if cfg.augment is not None:
            images = apply_augment_draws(images, draws.augment, cfg.augment)
        if cfg.mixing and cfg.mix_prob > 0.0:
            if rows is None:
                images, targets = apply_mix_draws(images, labels, draws.mix,
                                                  cfg.num_classes)
            else:  # partners cross ranks: mix the gathered batch
                images, targets = apply_mix_draws(
                    collectives.gather(images, mesh.data),
                    collectives.gather(labels, mesh.data), draws.mix,
                    cfg.num_classes)
                images, targets = images[rows[0]], targets[rows[0]]
        else:
            targets = torch.nn.functional.one_hot(
                labels.long(), cfg.num_classes).float()

        model = state.model.train()
        params = dict(model.named_parameters())
        buffers = [b for b in model.buffers()]
        stats_before = [b.clone() for b in buffers]
        for p in params.values():
            p.grad = None
        logits = model(images, draws.drop_masks)
        if cfg.mixing:
            loss = soft_target_cross_entropy(logits, targets)
        else:
            loss = cross_entropy_smoothed(logits, labels,
                                          cfg.label_smoothing)
        loss.backward()
        loss = loss.detach()
        with torch.no_grad():
            accs = accuracy_topk(logits.detach(),
                                 targets if cfg.mixing else labels)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if mesh is None or not mesh.active:
            gnorm = global_norm(list(grads.values()))
        else:
            grads = _all_reduce_grads(grads, mesh.data)
            shards = shard_dims_of(model)
            gnorm = global_norm(list(grads.values()),
                                [k in shards for k in grads], mesh.model)
            # the loss and metrics: the means of the ranks' means
            loss, accs[1], accs[3], accs[5] = collectives.mean(
                torch.stack([loss, accs[1], accs[3], accs[5]]),
                mesh.data).unbind()
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        if mesh is not None and mesh.model.size > 1:
            # one guard decision in the model group
            bad = collectives.all_reduce_((~finite).float(), mesh.model)
            finite = bad == 0
        state.tx.apply_(params, grads, state.opt_state, gnorm, finite)
        with torch.no_grad():
            for b, old in zip(buffers, stats_before):
                b.copy_(torch.where(finite, b, old))
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            metrics: Dict[str, torch.Tensor] = {
                "loss": torch.where(finite, loss, zero),
                "top1": accs[1], "top3": accs[3], "top5": accs[5],
                "grad_norm": torch.where(finite, gnorm, zero),
                "clipped": ((gnorm > cfg.grad_clip_norm).float()
                            if cfg.grad_clip_norm is not None else zero),
                "nonfinite": (~finite).float(),
            }
            if lr_schedule is not None:
                metrics["lr"] = lr_schedule(state.device_step)
            state.device_step.add_(1)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def make_eval_step(model: torch.nn.Module, label_smoothing: float = 0.0,
                   normalize: Optional[Tuple[Sequence[float],
                                             Sequence[float]]] = None):
    """Build the eval step: ``((images NHWC, int labels)) -> {"loss",
    "top1", "top3", "top5"}``, 0-d fp32 device tensors: cross-entropy
    (``label_smoothing``, none by default) and top-k in percent of the
    eval-mode forward of ``model``. With ``normalize=(mean, std)`` the
    images come as raw uint8 and are normalized in the step
    (``normalize_batch``, which keeps the mean and std on each device), so
    a step makes no host tensor once it has run on a device.

    On a mesh (the one the model was placed on, ``parallel/mesh.py:
    shard_model``) the batch is the rank's rows of the global batch and
    the metrics are the means of the data group's, the global batch's."""

    @torch.no_grad()
    def eval_step(batch) -> Dict[str, torch.Tensor]:
        images, labels = batch
        if normalize is not None:
            images = normalize_batch(images, *normalize)
        logits = model.eval()(images)
        accs = accuracy_topk(logits, labels)
        out = {"loss": cross_entropy_smoothed(logits, labels,
                                              label_smoothing),
               "top1": accs[1], "top3": accs[3], "top5": accs[5]}
        mesh = mesh_of(model)
        if mesh is not None and mesh.active:
            out = dict(zip(out, collectives.mean(
                torch.stack(list(out.values())), mesh.data).unbind()))
        return out

    return eval_step


class EvalSuperstep:
    """K eval steps in one dispatch (twin of ``make_eval_superstep``):
    ``((images [K, B, ...], labels [K, B])) -> metrics dict of [K] fp32
    tensors``, equal to K :func:`make_eval_step` calls.

    On a CUDA device the K steps are captured once per input shape in one
    CUDA graph that reads static ``[K, B, H, W, C]`` and ``[K, B]`` buffers
    and writes ``[K]`` metric buffers; each call copies its batches into
    the buffers, replays the graph and returns copies of the metrics. A
    warm-up step on a side stream first builds and loads the kernels and
    computes each launch plan, so the capture makes no host sync. The
    graph reads the parameters and BatchNorm statistics by address: it
    follows their in-place updates (the train step's and a resume's
    ``copy_``) and would not follow a rebinding. The kernel wrappers count
    their launches once, at the capture; :attr:`captures` and
    :attr:`replays` count the captures and replays of every instance. On a
    CPU device the K steps run eagerly."""

    captures = 0
    replays = 0

    def __init__(self, model: torch.nn.Module, k: int,
                 label_smoothing: float = 0.0, normalize=None):
        self.k = int(k)
        self.model = model
        self.step = make_eval_step(model, label_smoothing, normalize)
        self.graphs: Dict[tuple, tuple] = {}

    def _steps(self, images, labels) -> Dict[str, torch.Tensor]:
        ms = [self.step((images[i], labels[i])) for i in range(self.k)]
        return {key: torch.stack([m[key] for m in ms]) for key in ms[0]}

    def _capture(self, images, labels):
        _graph_collectives(mesh_of(self.model), "eval graph")
        static = (torch.empty_like(images), torch.empty_like(labels))
        side = torch.cuda.Stream(images.device)
        side.wait_stream(torch.cuda.current_stream(images.device))
        with torch.cuda.stream(side):
            self.step((static[0][0].zero_(), static[1][0].zero_()))
        torch.cuda.current_stream(images.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._steps(*static)
        EvalSuperstep.captures += 1
        return graph, static, out

    def __call__(self, superbatch) -> Dict[str, torch.Tensor]:
        images, labels = superbatch
        if images.shape[0] != self.k or labels.shape[0] != self.k:
            raise ValueError(f"eval superstep of K={self.k}: got "
                             f"{tuple(images.shape)} / {tuple(labels.shape)}")
        if images.device.type != "cuda":
            return self._steps(images, labels)
        key = (images.device, tuple(images.shape), images.dtype,
               tuple(labels.shape), labels.dtype)
        if key not in self.graphs:
            self.graphs[key] = self._capture(images, labels)
        graph, (x, y), out = self.graphs[key]
        x.copy_(images)
        y.copy_(labels)
        graph.replay()
        EvalSuperstep.replays += 1
        return {key: v.clone() for key, v in out.items()}


def make_eval_superstep(model: torch.nn.Module, label_smoothing: float = 0.0,
                        normalize=None, k: int = 8) -> EvalSuperstep:
    """The K-batch eval superstep (:class:`EvalSuperstep`)."""
    return EvalSuperstep(model, k, label_smoothing, normalize)


def _draw_tensors(draws: StepDraws) -> List[Tuple[tuple, torch.Tensor]]:
    """Every tensor of a step's draws (a drop-path mapping, not a
    generator), keyed ``("augment" | "mix", field)`` or ``("drop", path)``."""
    out = []
    for group, nt in (("augment", draws.augment), ("mix", draws.mix)):
        if nt is not None:
            out += [((group, f), t) for f, t in zip(nt._fields, nt)
                    if t is not None]
    if draws.drop_masks is None or draws.drop_masks.masks is None:
        raise ValueError("the superstep needs drop-path masks drawn before "
                         "the forward (sample_step_draws(drop_order=...))")
    out += [(("drop", p), torch.as_tensor(m))
            for p, m in draws.drop_masks.masks.items()]
    return out


class DrawLayout:
    """K steps' draws in one flat byte buffer: each tensor of a step's
    :class:`StepDraws` gets a ``[K, ...]`` slot of its dtype, 16-byte
    aligned, laid out from a template step. :meth:`fill` writes K steps'
    draws into a buffer's slots; :meth:`steps` reads them back as K
    :class:`StepDraws` of views into it. One copy of the buffer moves a
    group's draws to the card."""

    def __init__(self, template: StepDraws, k: int):
        self.k = int(k)
        self.groups = (template.augment is not None, template.mix is not None)
        self.slots = []  # (key, shape, dtype, offset, bytes)
        off = 0
        for key, t in _draw_tensors(template):
            n = self.k * t.numel() * t.element_size()
            self.slots.append((key, tuple(t.shape), t.dtype, off, n))
            off += -(-n // 16) * 16
        self.nbytes = max(off, 16)

    def views(self, buf: torch.Tensor) -> Dict[tuple, torch.Tensor]:
        """The ``[K, ...]`` slot of each draw in ``buf`` (uint8
        [nbytes])."""
        return {key: buf[off:off + n].view(dtype).view(self.k, *shape)
                for key, shape, dtype, off, n in self.slots}

    def fill(self, views: Dict[tuple, torch.Tensor],
             draws: Sequence[StepDraws]) -> None:
        """Write K steps' draws into a buffer's :meth:`views`."""
        if len(draws) != self.k:
            raise ValueError(f"{len(draws)} steps' draws for K={self.k}")
        for i, d in enumerate(draws):
            got = _draw_tensors(d)
            if ([(key, tuple(t.shape), t.dtype) for key, t in got]
                    != [s[:3] for s in self.slots]):
                raise ValueError(
                    f"step {i}'s draws do not match the superstep's layout "
                    f"{[s[:3] for s in self.slots]}: "
                    f"{[(key, tuple(t.shape), t.dtype) for key, t in got]}")
            for key, t in got:
                views[key][i].copy_(t)

    def steps(self, buf: torch.Tensor) -> List[StepDraws]:
        """K :class:`StepDraws` of views into ``buf``."""
        views = self.views(buf)
        out = []
        for i in range(self.k):
            field = {key: v[i] for key, v in views.items()}
            aug = (AugmentDraws(*(field.get(("augment", f))
                                  for f in AugmentDraws._fields))
                   if self.groups[0] else None)
            mix = (MixDraws(*(field[("mix", f)] for f in MixDraws._fields))
                   if self.groups[1] else None)
            out.append(StepDraws(aug, mix, DropPathMasks(
                {key[1]: v for key, v in field.items()
                 if key[0] == "drop"})))
        return out


class _Prepared:
    """A superstep's state for one (train state, input shape): the
    drop-path order, the draws' layout and buffers, and on the card the
    graph and its static inputs and outputs."""

    def __init__(self, state: TrainState, order, dropout_seed):
        self.state = state  # keeps what the key's ids name alive
        self.order = order
        self.dropout_seed = dropout_seed
        self.layout: Optional[DrawLayout] = None
        self.host: List[Tuple[torch.Tensor, Dict, Optional[object]]] = []
        self.turn = 0
        self.graph = None


class TrainSuperstep:
    """K train steps in one dispatch (twin of ``make_train_superstep``):
    ``(state, (images [K, B, H, W, C], labels [K, B]), seed=None,
    draws=None) -> (state, metrics dict of [K] tensors)``, the keys of
    :func:`make_train_step`'s metrics, equal to K :func:`make_train_step`
    calls with ``seed`` (bitwise on the CPU). ``draws``: K steps'
    :class:`StepDraws` with drop-path masks to use instead of sampling.

    The first call for a (state, input shape) runs one warm-up step from
    a snapshot of the state (parameters, BatchNorm statistics, AdamW
    ``mu``, ``nu`` and ``count``, the device step) and restores it: the
    warm-up records the order the forward draws its drop-path masks in,
    and on the card builds the kernels and computes their launch plans,
    on a side stream. Each call draws K steps' augment, mix and drop-path
    draws on the host from ``step_generator(seed, state.step + i)``,
    bitwise what K single steps draw, and writes them into one flat
    buffer (:class:`DrawLayout`). Dropout masks are computed in the steps
    on the device from ``seed`` and the device step (``HashedDropout``,
    as a single step with ``seed`` computes them; with ``draws``, from the
    seed of the first step's ``drop_masks.dropout``), so the seed is part
    of what a graph is captured for.

    On a CUDA device the K steps are captured once per state and input
    shape in one CUDA graph that reads static image, label and draw
    buffers and writes ``[K]`` metric buffers. Each call copies its draws
    (from one of two pinned buffers, one transfer) and its batches into
    the static buffers, replays the graph and returns copies of the
    metrics; the host's next group is drawn while this one replays. The
    graph reads and writes the parameters, BatchNorm statistics, optimizer
    state and device step in place, by address, and follows a resume's
    ``copy_``. A capture or a replay that fails raises: there is no eager
    fallback on the card. The kernel wrappers count their launches once,
    at the capture; :attr:`replays` counts the replays of every instance.
    On the CPU the K steps run eagerly on the same draws. On a mesh the
    steps are the mesh's (a rank's rows; given ``draws`` are the rank's
    draws, :func:`local_draws`); the graph holds their NCCL all-reduces,
    which the warm-up runs once first (NCCL makes its communicators at the
    first collective); a gloo mesh on the card raises."""

    replays = 0

    def __init__(self, cfg: StepConfig, lr_schedule: Optional[Callable] = None,
                 k: int = 8):
        self.cfg, self.k = cfg, int(k)
        self.step = make_train_step(cfg, lr_schedule)
        self.prepared: Dict[tuple, _Prepared] = {}
        self.stream = None

    @staticmethod
    def _tensors(state: TrainState) -> List[torch.Tensor]:
        model, opt = state.model, state.opt_state
        return [*model.parameters(), *model.buffers(), *opt.mu.values(),
                *opt.nu.values(), opt.count, state.device_step]

    @staticmethod
    def _with_dropout(draws: StepDraws, state: TrainState,
                      dropout_seed: Optional[int], rows=None) -> StepDraws:
        if dropout_seed is not None:
            draws.drop_masks.dropout = HashedDropout(
                dropout_seed, state.device_step,
                rows=None if rows is None else (
                    rows[0].start, rows[0].stop - rows[0].start))
        return draws

    def _global_shape(self, images, rows) -> tuple:
        shape = tuple(images.shape[1:])
        return shape if rows is None else (rows[1],) + shape[1:]

    def _warm_up(self, state: TrainState, images, labels,
                 dropout_seed) -> list:
        """One step from a snapshot of the state, then the snapshot back;
        returns the drop-path order the forward drew its masks in."""
        order: List[Tuple[str, float]] = []
        tensors = self._tensors(state)
        with torch.no_grad():
            snap = [t.detach().clone() for t in tensors]
        g = torch.Generator()  # the warm-up's draws are thrown away
        rows = data_rows(state.model, images.shape[1])
        draws = sample_step_draws(g, self.cfg, self._global_shape(
            images, rows), images.device)
        draws = local_draws(draws._replace(drop_masks=DropPathMasks(
            generator=g, record=order)), rows)
        draws = self._with_dropout(draws, state, dropout_seed, rows)
        self.step(state, (torch.zeros_like(images[0]),
                          torch.zeros_like(labels[0])), draws=draws)
        with torch.no_grad():
            for t, old in zip(tensors, snap):
                t.copy_(old)
        return order

    def _run(self, state, images, labels, draws,
             dropout_seed) -> Dict[str, torch.Tensor]:
        ms = []
        rows = data_rows(state.model, images.shape[1])
        for i in range(self.k):
            state, m = self.step(state, (images[i], labels[i]),
                                 draws=self._with_dropout(
                                     draws[i], state, dropout_seed, rows))
            ms.append(m)
        return {key: torch.stack([m[key] for m in ms]) for key in ms[0]}

    def _prepare(self, state, images, labels, dropout_seed) -> _Prepared:
        if images.device.type != "cuda":
            return _Prepared(state, self._warm_up(state, images, labels,
                                                  dropout_seed), dropout_seed)
        _graph_collectives(mesh_of(state.model), "train graph")
        dev = images.device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            order = self._warm_up(state, images, labels, dropout_seed)
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        return _Prepared(state, order, dropout_seed)

    def _capture(self, prep: _Prepared, state, images, labels):
        dev = images.device
        x, y = torch.zeros_like(images), torch.zeros_like(labels)
        buf = torch.zeros(prep.layout.nbytes, dtype=torch.uint8, device=dev)
        draws = prep.layout.steps(buf)
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = self._run(state, x, y, draws, prep.dropout_seed)
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        prep.graph = (graph, x, y, buf, out)

    def __call__(self, state: TrainState, superbatch, seed: Optional[int]
                 = None, draws: Optional[Sequence[StepDraws]] = None):
        images, labels = superbatch
        if images.shape[0] != self.k or labels.shape[0] != self.k:
            raise ValueError(f"train superstep of K={self.k}: got "
                             f"{tuple(images.shape)} / "
                             f"{tuple(labels.shape)}")
        if (seed is None) == (draws is None):
            raise ValueError("give the superstep a seed or its K steps' "
                             "draws")
        if seed is not None:
            dropout_seed = seed
        else:
            given = draws[0].drop_masks.dropout if draws[0].drop_masks \
                else None
            dropout_seed = (given.seed if isinstance(given, HashedDropout)
                            else None)
        key = (id(state.model), id(state.opt_state), id(state.device_step),
               images.device, tuple(images.shape), images.dtype,
               tuple(labels.shape), labels.dtype, dropout_seed)
        prep = self.prepared.get(key)
        if prep is None:
            prep = self.prepared[key] = self._prepare(state, images, labels,
                                                      dropout_seed)
        if draws is None:  # on the host, bitwise what K single steps draw
            rows = data_rows(state.model, images.shape[1])
            draws = [local_draws(sample_step_draws(
                step_generator(seed, state.step + i), self.cfg,
                self._global_shape(images, rows), drop_order=prep.order),
                rows) for i in range(self.k)]
        cuda = images.device.type == "cuda"
        if prep.layout is None:
            prep.layout = DrawLayout(draws[0], self.k)
            for _ in range(2 if cuda else 1):
                buf = torch.empty(prep.layout.nbytes, dtype=torch.uint8,
                                  pin_memory=cuda)
                prep.host.append((buf, prep.layout.views(buf), None))
        buf, views, done = prep.host[prep.turn]
        if done is not None:
            done.synchronize()  # its last copy to the card has been read
        prep.layout.fill(views, draws)
        if not cuda:
            metrics = self._run(state, images, labels,
                                prep.layout.steps(buf), prep.dropout_seed)
            return dataclasses.replace(state, step=state.step + self.k), \
                metrics
        if prep.graph is None:
            self._capture(prep, state, images, labels)
        graph, x, y, dev_buf, out = prep.graph
        dev_buf.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        prep.host[prep.turn] = (buf, views, done)
        prep.turn = (prep.turn + 1) % len(prep.host)
        x.copy_(images)
        y.copy_(labels)
        graph.replay()
        TrainSuperstep.replays += 1
        return dataclasses.replace(state, step=state.step + self.k), \
            {key: v.clone() for key, v in out.items()}


def make_train_superstep(cfg: StepConfig,
                         lr_schedule: Optional[Callable] = None,
                         k: int = 8) -> TrainSuperstep:
    """The K-step train superstep (:class:`TrainSuperstep`)."""
    return TrainSuperstep(cfg, lr_schedule, k)
