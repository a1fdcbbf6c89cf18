"""Optimizer and LR schedule (twin of ``outgridvit_tpu/training/optim.py``):
global-norm clipping then AdamW with weight decay on kernels only, in
optax's order, and the step-based warmup-cosine schedule.

optax's order, per step, on the fp32 gradients g of the fp32 params p:

1. ``clip_by_global_norm``: g scaled by ``max_norm / |g|`` only when
   ``|g| >= max_norm`` (not ``torch.nn.utils.clip_grad_norm_``'s
   ``max_norm / (|g| + 1e-6)``);
2. ``scale_by_adam``: ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g^2``,
   bias-corrected with the incremented count, ``u = mu_hat / (sqrt(nu_hat)
   + eps)``;
3. ``add_decayed_weights``: ``u += wd p`` for the leaves named ``kernel``,
   which in the port are exactly the parameters with ``dim() >= 2``;
4. ``scale_by_schedule``: ``u *= -lr(count)`` at the count before the
   increment; then ``p += u``.

The optimizer keeps its own count: a step the non-finite guard skips leaves
it (and mu, nu, p) unchanged, while the train state's step advances.
Everything stays on the device, so a step needs no host sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Union

import torch


def warmup_cosine_lr(base_lr: float, total_steps: int, warmup_steps: int,
                     min_lr: float = 0.0):
    """Step-based linear warmup then cosine decay; the value at 0-based step
    ``count`` is the warmup's value after ``count + 1`` steps (warmup starts
    at step 0). ``count`` is an int or an int tensor; the result is a 0-d
    fp32 tensor on its device, computed in fp32 as the JAX schedule is."""

    def schedule(count) -> torch.Tensor:
        t = torch.as_tensor(count, dtype=torch.int32) + 1
        warm = (base_lr * t.to(torch.float32) / warmup_steps
                if warmup_steps > 0 else torch.full_like(t, base_lr,
                                                         dtype=torch.float32))
        tt = torch.clamp(t, max=total_steps)
        progress = (tt - warmup_steps) / max(1, total_steps - warmup_steps)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * progress))
        decayed = min_lr + (base_lr - min_lr) * cosine
        in_warmup = (t <= warmup_steps) & (warmup_steps > 0)
        return torch.where(in_warmup, warm, decayed)

    return schedule


@dataclass
class AdamWState:
    """count: int32 0-d tensor (Adam's and the schedule's count, which move
    together); mu, nu: fp32 moments by parameter name."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def global_norm(grads: List[torch.Tensor],
                sharded: Optional[List[bool]] = None,
                model_axis=None) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient tensor (fp32). With
    ``sharded`` (one flag a tensor) the flagged tensors are a rank's blocks
    of tensor-parallel parameters: their squares are summed over
    ``model_axis`` (``parallel/collectives.py:Axis``), so each block counts
    once and each replicated tensor once."""
    if not sharded or not any(sharded):
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    from outgridvit_tpu_torch.parallel.collectives import all_reduce_

    def squares(ts):
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(ts))).square()

    blocks = all_reduce_(squares([g for g, s in zip(grads, sharded) if s]),
                         model_axis)
    rest = [g for g, s in zip(grads, sharded) if not s]
    return torch.sqrt(blocks + squares(rest) if rest else blocks)


@dataclass(frozen=True)
class AdamW:
    """``make_optimizer`` of the JAX package: clip + masked AdamW + LR."""

    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]]
    weight_decay: float = 0.05
    grad_clip_norm: Optional[float] = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        device = next(iter(params.values())).device
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.full((), self.learning_rate, dtype=torch.float32,
                          device=count.device)

    @torch.no_grad()
    def apply_(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: AdamWState,
               gnorm: torch.Tensor, finite: torch.Tensor) -> None:
        """One update in place, of ``params``, ``state.mu``, ``state.nu`` and
        ``state.count``, each kept as it was where ``finite`` (0-d bool
        tensor) is false. ``gnorm`` is :func:`global_norm` of the grads."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        if self.grad_clip_norm is not None:
            clip = float(self.grad_clip_norm)
            g = torch._foreach_mul(g, torch.where(
                gnorm < clip, torch.ones_like(gnorm), clip / gnorm))
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1),
                                torch._foreach_mul([state.mu[k] for k in names],
                                                   b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2),
            torch._foreach_mul([state.nu[k] for k in names], b2))
        count_inc = state.count + 1
        c = count_inc.to(torch.float32)
        # the bases as 0-d host tensors: a device op reads them as launch
        # arguments, with no host-to-device copy (a CUDA graph captures it)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), c)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), c)
        u = torch._foreach_div(
            torch._foreach_div(mu, bc1),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(nu, bc2)), self.eps))
        for ui, pi in zip(u, p):
            if pi.dim() >= 2 and self.weight_decay:
                ui.add_(pi, alpha=self.weight_decay)
        u = torch._foreach_mul(u, -self.lr(state.count))
        new_p = torch._foreach_add(p, u)
        for old, new in zip(p, new_p):
            old.copy_(torch.where(finite, new, old))
        for k, m, n in zip(names, mu, nu):
            state.mu[k].copy_(torch.where(finite, m, state.mu[k]))
            state.nu[k].copy_(torch.where(finite, n, state.nu[k]))
        state.count.copy_(torch.where(finite, count_inc, state.count))
