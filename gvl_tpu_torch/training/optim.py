"""The optimizer of the decoder's trainers: the Optax chain the JAX
package uses (``clip_by_global_norm``, then ``adamw`` over a schedule,
inside ``MultiSteps`` for the LoRA trainer), as one PyTorch optimizer over
a list of parameters, each update a few ``torch._foreach_*`` calls.

It keeps Optax's semantics, where they differ from ``torch.optim``'s:

- the schedule is read at the count of updates made before this one, so
  the first update of a warmup schedule has learning rate 0;
- the clip scales by ``max_norm / norm``, with no epsilon;
- ``eps`` is added outside the square root, and every parameter given to
  it decays (default ``weight_decay`` 1e-4), after the Adam step and
  before the learning rate;
- frozen parameters are not given to it: they keep their bits, hold no
  state and stay out of the clip's norm (Optax's ``multi_transform`` with
  ``set_to_zero``);
- ``every_k`` > 1 makes one update of the mean of every k gradients, and
  the schedule counts those updates only (Optax's ``MultiSteps``);
- a parameter the loss did not reach takes a zero gradient, as
  ``jax.grad`` gives it, and so still decays.

It also keeps Optax's order of operations, so that its rounding is
Optax's: ``torch.optim.AdamW`` computes the same function in another order
(``lerp`` for the first moment, ``sqrt(v) / sqrt(c2)``, the decay as
``p * (1 - lr * wd)``), and the port's trainers are held to the JAX
package's losses within 1e-5 after several steps.  Schedules are computed
in float32, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch

Schedule = Callable[[int], float]

_F32 = np.float32


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------

def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: float(_F32(init_value))

    def schedule(count: int) -> float:
        frac = _F32(1) - _F32(min(max(count, 0), transition_steps)) / _F32(transition_steps)
        return float((_F32(init_value) - _F32(end_value)) * frac + _F32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    if decay_steps <= 0:
        raise ValueError("cosine_decay_schedule needs decay_steps > 0")

    def schedule(count: int) -> float:
        frac = _F32(min(count, decay_steps)) / _F32(decay_steps)
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * frac, dtype=_F32))
        return float(_F32(init_value) * ((_F32(1) - _F32(alpha)) * cosine + _F32(alpha)))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """Linear from ``init_value`` to ``peak_value`` over ``warmup_steps``,
    then a cosine to ``end_value`` at ``decay_steps`` (counted from 0)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


# --------------------------------------------------------------------------
# The clip and the optimizer
# --------------------------------------------------------------------------

def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """Optax's clip in place: every gradient becomes ``g / norm * max_norm``
    when the global L2 norm reaches ``max_norm`` (chosen on the device, with
    no wait for the norm: below it the factors are 1)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))


class AdamW:
    """``clip_by_global_norm(clip)`` (none when ``clip`` is None), then
    Optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8) with ``learning_rate``
    (a number or a schedule of the update count) over ``params``, one
    update every ``every_k`` calls of :meth:`step`.  ``weight_decay=0`` is
    Optax's ``adam``."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: Union[float, Schedule], clip: Optional[float],
                 weight_decay: float = 1e-4, every_k: int = 1):
        self.params = list(params)
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda count: learning_rate))
        self.clip, self.weight_decay, self.every_k = clip, weight_decay, every_k
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0      # updates made
        self.calls = 0      # calls of step
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """After ``backward``: every ``every_k``-th call, the update of the
        gradients' mean, in place; the gradients are cleared after it."""
        self.calls += 1
        if self.calls % self.every_k:
            return
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.every_k > 1:
            torch._foreach_div_(grads, float(self.every_k))
        if self.clip is not None:
            clip_by_global_norm_(grads, self.clip)
        b1, b2 = self.B1, self.B2
        # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        squares = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squares, 1 - b2)
        torch._foreach_add_(self.nu, squares)
        self.count += 1
        # bias corrections in f32, as JAX computes 1 - decay**count
        c1 = float(_F32(1) - _F32(b1) ** _F32(self.count))
        c2 = float(_F32(1) - _F32(b2) ** _F32(self.count))
        # u = (mu / c1) / (sqrt(nu / c2) + eps) + wd p; p += -lr u
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        updates = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(updates, denom)
        torch._foreach_add_(updates, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(updates, -float(_F32(self.schedule(self.count - 1))))
        torch._foreach_add_(self.params, updates)
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count, "calls": self.calls}

    def load_state_dict(self, state: dict) -> None:
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            torch._foreach_copy_(mine, theirs)
        self.count, self.calls = state["count"], state["calls"]


def train_step(model, optimizer: AdamW, loss_fn) -> torch.Tensor:
    """The loss's gradients into ``optimizer``'s parameters and its
    :meth:`~AdamW.step`; returns the loss, still on the device."""
    loss = loss_fn(model)
    loss.backward()
    optimizer.step()
    return loss.detach()
