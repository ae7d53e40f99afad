"""Learning-rate schedules and optimizers (torch.optim).

Counterpart of ``heatnet_tpu/train/optim.py:22-158``. Each schedule is a
plain function of the step count that returns the learning rate, as the
optax schedules are. ``create_optimizer`` builds SGD, Adam or RMSprop with a
base learning rate of 1 and a ``LambdaLR`` that sets the rate to
``schedule(count)``; stepped once per optimizer step, it reads ``lr(count)``
before the count moves on, as optax does. Gradient clipping runs as a step
pre-hook and is optax's ``clip_by_global_norm``, ``g * c / max(|g|, c)``
(``clip_grad_norm_`` adds 1e-6 to the norm); weight decay is additive, as
torch's is. The flat-buffer ``maybe_flatten`` is an opt-state layout knob of
the JAX package with no counterpart here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR


def poly_lr(init_lr: float, max_iter: int = 100, power: float = 0.9) -> Callable:
    """``poly_lr_scheduler`` (helper/utils.py:71-84): lr·(1 - it/max)^power,
    held at 0 past ``max_iter``."""

    def schedule(count):
        return init_lr * max(1.0 - count / max_iter, 0.0) ** power

    return schedule


def step_lr(init_lr: float, step_size: int, gamma: float = 0.1,
            steps_per_epoch: int = 1) -> Callable:
    """torch ``StepLR`` (epoch-mode): lr·gamma^(epoch // step_size)."""

    def schedule(count):
        return init_lr * gamma ** ((count // steps_per_epoch) // step_size)

    return schedule


def multistep_lr(init_lr: float, milestones, gamma: float = 0.1,
                 steps_per_epoch: int = 1) -> Callable:
    """lr·gamma^(number of milestones <= epoch)."""
    milestones = sorted(milestones)

    def schedule(count):
        epoch = count // steps_per_epoch
        return init_lr * gamma ** sum(1 for m in milestones if epoch >= m)

    return schedule


def exponential_lr(init_lr: float, gamma: float, steps_per_epoch: int = 1) -> Callable:
    def schedule(count):
        return init_lr * gamma ** (count // steps_per_epoch)

    return schedule


def linear_lr(init_lr: float, alpha: float, beta: float,
              steps_per_epoch: int = 1) -> Callable:
    """torch 'linear' LambdaLR (helper/utils.py:139-143): lr·(epoch·α + β)."""

    def schedule(count):
        return init_lr * ((count // steps_per_epoch) * alpha + beta)

    return schedule


def lambda_linear_decay(n_epochs: int, offset: int, decay_start_epoch: int,
                        init_lr: float, steps_per_epoch: int = 1) -> Callable:
    """CycleGAN ``LambdaLR`` (utils.py:115-123): flat, then linear to zero."""

    def schedule(count):
        epoch = count // steps_per_epoch
        return init_lr * (1.0 - max(0, epoch + offset - decay_start_epoch)
                          / (n_epochs - decay_start_epoch))

    return schedule


def make_schedule(optimizer_config: Dict[str, Any],
                  steps_per_epoch: int = 1) -> Callable:
    """Schedule from the JSON ``optimizer.schedule`` section."""
    lr = optimizer_config["learning_rate"]
    sched = optimizer_config.get("schedule", {"type": "constant"})
    stype = sched.get("type", "constant")
    params = sched.get("params", {})
    spe = steps_per_epoch if sched.get("mode", "epoch") == "epoch" else 1
    if stype == "constant":
        return lambda count: lr
    if stype == "step":
        return step_lr(lr, params["step_size"], params.get("gamma", 0.1), spe)
    if stype == "multistep":
        return multistep_lr(lr, params["milestones"], params.get("gamma", 0.1), spe)
    if stype == "exponential":
        return exponential_lr(lr, params["gamma"], spe)
    if stype == "linear":
        return linear_lr(lr, params["alpha"], params["beta"], spe)
    raise KeyError(f"unrecognized schedule {stype}")


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """Scale every gradient by ``max_norm / max(global norm, max_norm)``."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def with_schedule(optimizer: torch.optim.Optimizer, schedule: Callable) -> LambdaLR:
    """A ``LambdaLR`` that sets every group's rate to ``schedule(count)``
    (the optimizer's base rate must be 1)."""
    return LambdaLR(optimizer, lambda count: float(schedule(count)))


def create_optimizer(optimizer_config: Dict[str, Any], params: Iterable[torch.Tensor],
                     steps_per_epoch: int = 1, schedule: Optional[Callable] = None
                     ) -> Tuple[torch.optim.Optimizer, LambdaLR]:
    """Optimizer and its schedule from the JSON config (helper/utils.py:86-146).

    Adam takes optax's defaults (0.9, 0.999, eps 1e-8); RMSprop torch's
    (alpha .99, eps 1e-8 outside the square root).
    """
    params = list(params)
    sched = schedule or make_schedule(optimizer_config, steps_per_epoch)
    otype = optimizer_config.get("type", "SGD")
    wd = optimizer_config.get("weight_decay", 0.0)
    if otype == "SGD":
        opt = torch.optim.SGD(params, lr=1.0,
                              momentum=optimizer_config.get("momentum", 0.9),
                              nesterov=optimizer_config.get("nesterov", False),
                              weight_decay=wd)
    elif otype == "Adam":
        opt = torch.optim.Adam(params, lr=1.0, weight_decay=wd)
    elif otype == "RMSprop":
        opt = torch.optim.RMSprop(params, lr=1.0, alpha=0.99, eps=1e-8,
                                  weight_decay=wd)
    else:
        raise KeyError(f"unrecognized optimizer {otype}")
    clip = optimizer_config.get("clip", 0)
    if clip and clip > 0:
        opt.register_step_pre_hook(
            lambda optimizer, args, kwargs: clip_by_global_norm(params, clip))
    return opt, with_schedule(opt, sched)


def masked_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                     trainable: Callable[[str], bool], make: Callable,
                     schedule: Callable) -> Tuple[torch.optim.Optimizer, LambdaLR]:
    """An optimizer over the parameters whose name ``trainable`` accepts,
    with its own schedule (optim.py:161-179, ``masked_optimizer``).

    The functional counterpart of ``requires_grad`` phase flips in the JAX
    package is an optax ``multi_transform``: the masked-out leaves get no
    update and their moments stay untouched, and the inner schedule counts
    only the updates it is called for. Here the masked-out parameters are
    simply not in this optimizer, and ``LambdaLR`` counts this optimizer's
    steps. A parameter may sit in two such optimizers, each with its own
    moments. ``make(params)`` builds the optimizer at a base rate of 1.
    """
    opt = make([p for name, p in named_params if trainable(name)])
    return opt, with_schedule(opt, schedule)


def rmsprop(params) -> torch.optim.RMSprop:
    """torch's RMSprop (alpha .99, eps 1e-8 outside the square root), the
    reference's and optax's ``rmsprop(eps_in_sqrt=False)``, at rate 1."""
    return torch.optim.RMSprop(params, lr=1.0, alpha=0.99, eps=1e-8)
