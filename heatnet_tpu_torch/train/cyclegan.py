"""CycleGAN day↔night IR translation with a jointly trained segnet.

Counterpart of ``heatnet_tpu/train/cyclegan.py:28-228``: two generators and
two discriminators, a ``netSeg`` trained with the generators; the generator
loss is identity (x5) + GAN (MSE to 1) + cycle (x10) + cross-entropy of
netSeg on real_A and on fake_B against the day labels; a discriminator's loss
is ``(MSE(D(real), 1) + MSE(D(fake), 0)) / 2`` on replayed fakes. Three
Adam(0.5, 0.999) optimizers (the generators with netSeg, and one per
discriminator), each with its own schedule count.

The JAX steps are pure functions of a state pytree. Here the modules and
optimizers update in place: ``g_step`` runs netSeg in train mode twice,
real_A then fake_B, so its BN running statistics update twice in that
order, as the JAX step threads them; the discriminators' parameters have
``requires_grad`` off during the generator step, so no gradient reaches them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .optim import with_schedule
from .state import TrainState
from .supervised import cross_entropy_ignore

NET_NAMES = ("netG_A2B", "netG_B2A", "netD_A", "netD_B", "netSeg")


class ReplayBuffer:
    """History buffer for discriminator inputs (utils.py:92-112), numpy; the
    JAX package's host buffer, draw for draw."""

    def __init__(self, max_size: int = 50, seed: int = 0):
        if max_size <= 0:
            raise ValueError("max_size must be positive")
        self.max_size = max_size
        self.data = []
        self._rng = np.random.RandomState(seed)

    def push_and_pop(self, batch: np.ndarray) -> np.ndarray:
        out = []
        for element in np.asarray(batch):
            element = element[None]
            if len(self.data) < self.max_size:
                self.data.append(element)
                out.append(element)
            elif self._rng.uniform() > 0.5:
                i = self._rng.randint(0, self.max_size)
                out.append(self.data[i].copy())
                self.data[i] = element
            else:
                out.append(element)
        return np.concatenate(out, axis=0)


class DeviceReplayBuffer:
    """The replay buffer with its history as one device tensor.

    Semantics of ``DeviceReplayBuffer`` (``train/cyclegan.py:52-94``): while
    the buffer is not full, an element is appended and passes through; once
    full, with p = 0.5 it replaces a random slot and the slot's old element
    is emitted, else it passes through. The coin and the slot come from the
    caller's ``torch.Generator`` (a CPU one: the decisions are made on the
    host, so a push makes no host-device synchronisation).
    """

    def __init__(self, max_size: int, item_shape: Sequence[int],
                 device: torch.device, dtype: torch.dtype = torch.float32):
        self.data = torch.zeros((max_size, *item_shape), dtype=dtype, device=device)
        self.size = 0

    def push_and_pop(self, batch: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        max_size = self.data.shape[0]
        out = []
        for element in batch.to(self.data.dtype):
            if self.size < max_size:
                self.data[self.size].copy_(element)
                self.size += 1
                out.append(element)
                continue
            swap = float(torch.rand((), generator=generator)) > 0.5
            i = int(torch.randint(max_size, (), generator=generator))
            if swap:
                out.append(self.data[i].clone())
                self.data[i].copy_(element)
            else:
                out.append(element)
        return torch.stack(out)


@dataclasses.dataclass
class CycleGANState:
    """The five nets and the three optimizers with their schedules."""

    nets: nn.ModuleDict   # NET_NAMES
    g: TrainState         # netG_A2B, netG_B2A and netSeg
    d_a: TrainState
    d_b: TrainState

    @classmethod
    def create(cls, nets: Dict[str, nn.Module], schedule: Callable) -> "CycleGANState":
        """Adam(0.5, 0.999) at ``schedule`` for each of the three groups."""

        def adam(names):
            group = nn.ModuleDict({k: nets[k] for k in names})
            opt = torch.optim.Adam(group.parameters(), lr=1.0, betas=(0.5, 0.999))
            return TrainState(group, opt, with_schedule(opt, schedule))

        return cls(nn.ModuleDict({k: nets[k] for k in NET_NAMES}),
                   adam(("netG_A2B", "netG_B2A", "netSeg")), adam(("netD_A",)),
                   adam(("netD_B",)))

    @property
    def step(self) -> int:
        return self.g.step


def mse(x: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean((x.float() - target) ** 2)


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x.float() - y.float()))


@contextlib.contextmanager
def frozen(*modules: nn.Module) -> Iterator[None]:
    """``requires_grad`` off on the modules' parameters, restored after."""
    params = [p for m in modules for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def make_cyclegan_steps(gen_a2b: nn.Module, gen_b2a: nn.Module, disc_a: nn.Module,
                        disc_b: nn.Module, seg_net: nn.Module):
    """``(g_step, d_a_step, d_b_step)``.

    ``g_step(state, batch)`` takes A (day IR), B (night IR) and label (day
    labels, -1 ignored) and returns ``(fake_A, fake_B, metrics)``, the fakes
    detached; ``d_a_step(state, real_A, fake_A)`` and ``d_b_step`` return
    their loss. Every step applies its optimizer and schedule.
    """

    def g_step(state: CycleGANState, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        real_a, real_b = batch["A"], batch["B"]
        label_a = batch["label"]
        seg_net.train()
        with frozen(disc_a, disc_b):
            loss_identity_b = l1(gen_a2b(real_b), real_b) * 5.0
            loss_identity_a = l1(gen_b2a(real_a), real_a) * 5.0
            fake_b = gen_a2b(real_a)
            loss_gan_a2b = mse(disc_b(fake_b), 1.0)
            fake_a = gen_b2a(real_b)
            loss_gan_b2a = mse(disc_a(fake_a), 1.0)
            loss_cycle_aba = l1(gen_b2a(fake_b), real_a) * 10.0
            loss_cycle_bab = l1(gen_a2b(fake_a), real_b) * 10.0
            seg_a = seg_net(real_a)[0]
            seg_fake_b = seg_net(fake_b)[0]
            loss_seg_a = cross_entropy_ignore(seg_a, label_a, ignore_index=-1)
            loss_seg_fake_b = cross_entropy_ignore(seg_fake_b, label_a, ignore_index=-1)
            loss_g = (loss_identity_a + loss_identity_b + loss_gan_a2b + loss_gan_b2a
                      + loss_cycle_aba + loss_cycle_bab + loss_seg_a + loss_seg_fake_b)
            loss_g.backward()
        state.g.apply_gradients()
        metrics = {
            "loss_G": loss_g,
            "loss_G_identity": loss_identity_a + loss_identity_b,
            "loss_G_GAN": loss_gan_a2b + loss_gan_b2a,
            "loss_G_cycle": loss_cycle_aba + loss_cycle_bab,
            "loss_segmentation_A": loss_seg_a,
            "loss_segmentation_fake_A": loss_seg_fake_b,
        }
        return (fake_a.detach(), fake_b.detach(),
                {k: v.detach() for k, v in metrics.items()})

    def d_step(disc: nn.Module, which: str):
        def step(state: CycleGANState, real: torch.Tensor, fake: torch.Tensor
                 ) -> torch.Tensor:
            loss = (mse(disc(real), 1.0) + mse(disc(fake), 0.0)) * 0.5
            loss.backward()
            getattr(state, which).apply_gradients()
            return loss.detach()

        return step

    return g_step, d_step(disc_a, "d_a"), d_step(disc_b, "d_b")
