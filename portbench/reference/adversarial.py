"""Plain PyTorch reference of HeatNet's adversarial training steps.

The confusion-maximisation trainer (HeatNet, IROS 2020,
train_trgb_segnet_conf.py): a segnet, one patch critic per feature tap, an
IR-only teacher for the night images, two phases.

- Critic step: the segnet (batch-norm statistics of the batch, no
  gradient) runs on the day and the night inputs; each critic scores its
  tap of both; the loss is the sum over critics of mean((c_day - 1)^2) +
  mean(c_night^2); RMSprop updates the critics.
- Seg step: the day inputs are augmented once more (``augment.augment_day``);
  the loss is the day cross-entropy, plus the cross-entropy of the night
  logits against the teacher's argmax, plus 0.1 times the sum over critics
  of mean((c_day - 1)^2) + mean((c_night - 1)^2) (the critics frozen, the
  gradient flowing through them); RMSprop updates the segnet.

RMSprop: sq = 0.99 sq + 0.01 g^2, p -= lr g / (sqrt(sq) + 1e-8), one state
per phase. Float32 throughout; the caller turns TF32 off.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .augment import augment_day
from .segnet import Conv, Ctx, Quant, Segnet, segnet_from_config

CRITIC_STD = 0.02


class Critic(nn.Module):
    """Four 4x4 stride-2 convs with leaky ReLU 0.2, a 1-channel 4x4 stride-2
    classifier, the map resized (bilinear, half-pixel) to the tap's size."""

    def __init__(self, cin: int, ndf: int = 64):
        super().__init__()
        for i, w in enumerate((ndf, ndf * 2, ndf * 4, ndf * 8)):
            self.add_module(f"conv{i + 1}", Conv(cin, w, 4, 2, 1, bias=True, std=CRITIC_STD))
            cin = w
        self.classifier = Conv(cin, 1, 4, 2, 1, bias=True, std=CRITIC_STD)

    def forward(self, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        hw = x.shape[1:3]
        x = x.float().permute(0, 3, 1, 2)
        for i in range(4):
            x = ctx.held(F.leaky_relu(getattr(self, f"conv{i + 1}")(x, ctx), 0.2))
        x = self.classifier(x, ctx)
        x = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)
        return x.permute(0, 2, 3, 1)


def tap_channels(net: Segnet) -> List[int]:
    c2 = net.mod2_1.block1.conv3.weight.shape[0]
    return [net.aspp.final_conv.conv1.weight.shape[0],
            net.aspp.fuse_conv.conv1.weight.shape[0] + c2,
            net.mod4_1.block1.conv3.weight.shape[0], net.mod3_1.block1.conv3.weight.shape[0],
            c2, 64]


class ConfNet(nn.Module):
    """``trgb_segnet`` and ``critics_0 .. critics_{n-1}``."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.trgb_segnet = segnet_from_config(cfg)
        self.n = cfg["critics"]["count"]
        for i, c in enumerate(tap_channels(self.trgb_segnet)[:self.n]):
            self.add_module(f"critics_{i}", Critic(c))

    def critics(self):
        return [getattr(self, f"critics_{i}") for i in range(self.n)]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over pixels not labelled -1 of -log softmax at the label."""
    valid = labels != -1
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


class Trainer:
    """The two phases' steps over ``net`` (a ``ConfNet``) and ``teacher`` (an
    IR-only ``Segnet`` in eval mode). Each step returns (loss tensor, {leaf
    name: gradient or None}) and updates the phase's leaves in place."""

    def __init__(self, net: ConfNet, teacher: Segnet, cfg: dict, quant: Quant = None):
        self.net, self.teacher, self.quant = net, teacher, quant
        t = cfg["training"]
        self.lr, self.alpha, self.eps = t["lr"], t["rmsprop_alpha"], t["rmsprop_eps"]
        self.conf_weight = t["conf_weight"]
        self.moddrop, self.irscale = t["moddrop"], t["irscale"]
        self.act = cfg["segnet"]["activation"]
        self.sq: Dict[str, torch.Tensor] = {}

    def _update(self, loss: torch.Tensor, prefix: str) -> Dict[str, Optional[torch.Tensor]]:
        """The gradients of the phase's leaves (None where no loss reads
        one), then RMSprop on them."""
        leaves = {k: p for k, p in self.net.named_parameters() if k.startswith(prefix)}
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                     allow_unused=True)))
        self._rmsprop(leaves, grads)
        return grads

    @torch.no_grad()
    def _rmsprop(self, leaves: Dict[str, nn.Parameter], grads: Dict[str, torch.Tensor]):
        for k, p in leaves.items():
            g = grads[k]
            if g is None:
                continue
            sq = self.sq.get(k)
            sq = (1 - self.alpha) * g * g if sq is None else self.alpha * sq + (1 - self.alpha) * g * g
            self.sq[k] = sq
            p -= self.lr * g / (sq.sqrt() + self.eps)

    def _seg(self, batch, day: bool, ctx):
        sfx = "day" if day else "night"
        return self.net.trgb_segnet(torch.cat([batch[f"rgb_{sfx}"], batch[f"ir_{sfx}"]], -1), ctx)

    def critic_step(self, batch):
        ctx = Ctx(True, self.act, quant=self.quant)
        with torch.no_grad():
            _, taps_a = self._seg(batch, True, ctx)
            _, taps_b = self._seg(batch, False, ctx)
        loss = 0.0
        for i, c in enumerate(self.net.critics()):
            loss = loss + torch.mean((c(taps_a[i], ctx) - 1.0) ** 2)
            loss = loss + torch.mean(c(taps_b[i], ctx) ** 2)
        return loss, self._update(loss, "critics_")

    def seg_step(self, batch, seg_draws):
        ctx = Ctx(True, self.act, quant=self.quant)
        batch = augment_day(batch, seg_draws, self.moddrop, self.irscale)
        pred_a, taps_a = self._seg(batch, True, ctx)
        pred_b, taps_b = self._seg(batch, False, ctx)
        loss = cross_entropy(pred_a, batch["label_day"])
        with torch.no_grad():
            t_logits, _ = self.teacher(batch["ir_night"], Ctx(False, self.act, quant=self.quant))
            pseudo = torch.softmax(t_logits.float(), -1).argmax(-1)
        loss = loss + cross_entropy(pred_b, pseudo)
        conf = 0.0
        for i, c in enumerate(self.net.critics()):
            conf = conf + torch.mean((c(taps_a[i], ctx) - 1.0) ** 2)
            conf = conf + torch.mean((c(taps_b[i], ctx) - 1.0) ** 2)
        loss = loss + self.conf_weight * conf
        return loss, self._update(loss, "trgb_segnet.")
