"""Adversarial confusion-maximisation wrapper: the segnet and its critics.

Counterpart of ``heatnet_tpu/models/conf_segnet.py:32-171`` (the
reference's ``conv_segnet``): the trgb segnet, ``num_critics`` critics over
its feature taps, optional ``DownNet`` feedback nets (the seg logits shrunk
and concatenated onto taps 1-5), and an optional UNet input adapter with
its own critic, which scores the adapter's *output* (:148-157). ``forward``
runs the segnet on the day and the night inputs and every critic on both
tap sets, and returns the JAX module's dict.

Submodule names are the flax tree's (``trgb_segnet``, ``critics_0``,
``downscale_nets_0``, ``input_adapter_net``, ``adapter_disc``), so a
``state_dict`` key is the flax path joined with ``.``. The segnet is arch
``custom`` (ResNeXt-ASPP) or ``pspnet`` (always on the ``resnet50``
backend, :76-83), early or late fusion; the critics' widths follow its taps
(``tap_channels`` / ``pspnet_tap_channels``). ``bn_groups > 1`` takes
the ResNeXt segnet's train-mode BN statistics per contiguous batch group
(``layers.BatchNorm``), as the JAX module's ``NormAct(bn_groups)`` does.

PSPNet's channel dropout draws from an explicit generator:
``draw_dropout(n, generator)`` returns the keep masks of one dual forward
(day, then night; None for arch ``custom``), and ``forward`` takes them
as ``dropout``.

Phases are PyTorch's own idiom, the reference's ``setPhase``
(conf_segnet.py:90-104): ``set_phase`` turns ``requires_grad`` off on the
frozen side (the critics in ``train_seg``, the segnet in ``train_critic``);
the downscale nets, the adapter and its critic train in both. When the
segnet is frozen and its inputs need no gradient (the critic phase without
an adapter), it runs under ``torch.no_grad()`` in train mode: its BN
statistics still update, and no graph is built through it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from .critics import DownNet, create_critic
from .layers import NormAct
from .pspnet import DropoutMasks, pspnet_tap_channels
from .registry import build_network
from .trgb_segnet import ResNeXtSeg, tap_channels
from .unet import UNetAdapter

PHASES = ("train_seg", "train_critic")
NUM_DOWNSCALE = (3, 3, 3, 2, 2)  # DownNet depth per tap 1-5 (conf_segnet.py:62-70)


def num_input_channels(modalities: str) -> int:
    return (3 if "rgb" in modalities else 0) + (1 if "ir" in modalities else 0)


class ConfSegnet(nn.Module):
    """Segmentation network + adversarial critics over its feature taps."""

    def __init__(self, disc_arch: str = "resnet18", num_critics: int = 6,
                 feedback_seg: bool = False, no_conf: bool = False,
                 modalities: str = "ir_rgb", input_adapter: bool = False,
                 cert_branch: bool = False, arch: str = "custom",
                 late_fusion: bool = False, classes: int = 13,
                 structure: Sequence[int] = (3, 4, 6, 3), bn_groups: int = 1):
        super().__init__()
        n_in = num_input_channels(modalities)
        self.feedback_seg, self.no_conf = feedback_seg, no_conf
        self.input_adapter, self.num_critics = input_adapter, num_critics
        if arch == "custom":
            self.trgb_segnet = ResNeXtSeg(structure=tuple(structure), input_channels=n_in,
                                          cert_branch=cert_branch, classes=classes,
                                          late_fusion=late_fusion,
                                          norm_act=NormAct(bn_groups=bn_groups))
            chans = tap_channels(classes, self.trgb_segnet.late_fusion)
        elif arch == "pspnet":
            self.trgb_segnet = build_network("resnet50", n_classes=classes,
                                             in_channels=n_in, late_fusion=late_fusion)
            chans = pspnet_tap_channels("resnet50", classes, self.trgb_segnet.late_fusion)
        else:
            raise ValueError(f"unsupported arch {arch}")
        if input_adapter:
            self.input_adapter_net = UNetAdapter(n_in, n_in)
            self.adapter_disc = create_critic(disc_arch, n_in)
        if not no_conf:
            if feedback_seg:
                # one per critic after the first, as flax creates the ones
                # that run
                for i, n in enumerate(NUM_DOWNSCALE[:num_critics - 1]):
                    self.add_module(f"downscale_nets_{i}", DownNet(n, classes))
            for i in range(num_critics):
                extra = classes if feedback_seg and i > 0 else 0
                self.add_module(f"critics_{i}", create_critic(disc_arch, chans[i] + extra))
        self._segnet_frozen = False

    def critics(self) -> List[nn.Module]:
        return [] if self.no_conf else [getattr(self, f"critics_{i}")
                                        for i in range(self.num_critics)]

    def set_phase(self, phase: str) -> None:
        """``requires_grad`` off on the frozen side of ``phase``
        (conf_segnet.py:90-104)."""
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase}")
        seg = phase == "train_seg"
        self.trgb_segnet.requires_grad_(seg)
        for c in self.critics():
            c.requires_grad_(not seg)
        self._segnet_frozen = not seg

    @staticmethod
    def _split(inputs) -> tuple:
        """An input list → (modal_1, modal_2), as the trainer packs it."""
        return (inputs[0], inputs[1]) if len(inputs) == 2 else (inputs[0], None)

    def draw_dropout(self, n: int, generator: torch.Generator
                     ) -> Optional[tuple]:
        """The segnet's dropout keep masks for the day and the night forward
        of batch ``n``, or None when it has no dropout (arch ``custom``)."""
        draw = getattr(self.trgb_segnet, "draw_dropout", None)
        return None if draw is None else (draw(n, generator), draw(n, generator))

    def _segnet(self, inputs, dropout: Optional[DropoutMasks]):
        m1, m2 = self._split(inputs)
        needs_graph = not self._segnet_frozen or any(
            t is not None and t.requires_grad for t in (m1, m2))
        kw = {} if dropout is None else {"dropout": dropout}
        with torch.set_grad_enabled(torch.is_grad_enabled() and needs_graph):
            return self.trgb_segnet(m1, m2, **kw)

    def forward(self, input_a: Sequence[torch.Tensor], input_b: Sequence[torch.Tensor],
                dropout: Optional[tuple] = None) -> Dict[str, Any]:
        """Dual forward (day = a, night = b) over NHWC input lists;
        ``dropout`` is ``draw_dropout``'s pair, needed by a train-mode PSPNet."""
        output: Dict[str, Any] = {}
        if self.input_adapter:
            cat_a, cat_b = (torch.cat(list(i), -1) for i in (input_a, input_b))
            adapted_a = self.input_adapter_net(cat_a)
            adapted_b = self.input_adapter_net(cat_b)
            output["input_a"], output["input_b"] = adapted_a, adapted_b
            if len(input_a) == 2:
                n1 = input_a[0].shape[-1]
                input_a = [adapted_a[..., :n1], adapted_a[..., n1:]]
                input_b = [adapted_b[..., :n1], adapted_b[..., n1:]]
            else:
                input_a, input_b = [adapted_a], [adapted_b]

        drop_a, drop_b = dropout if dropout is not None else (None, None)
        pred_a, taps_a, cert_a = self._segnet(input_a, drop_a)
        pred_b, taps_b, cert_b = self._segnet(input_b, drop_b)

        if not self.no_conf:
            output["critics_a"], output["critics_b"] = [], []
            for i, critic in enumerate(self.critics()):
                tap_a, tap_b = taps_a[i], taps_b[i]
                if self.feedback_seg and i > 0:
                    down = getattr(self, f"downscale_nets_{i - 1}")
                    tap_a = torch.cat([tap_a, down(pred_a).to(tap_a.dtype)], -1)
                    tap_b = torch.cat([tap_b, down(pred_b).to(tap_b.dtype)], -1)
                output["critics_a"].append(critic(tap_a))
                output["critics_b"].append(critic(tap_b))
            if self.input_adapter:
                output["critics_a"].append(self.adapter_disc(adapted_a))
                output["critics_b"].append(self.adapter_disc(adapted_b))

        output["pred_label_a"] = pred_a
        output["pred_label_b"] = pred_b
        output["cert_a"] = cert_a
        output["cert_b"] = cert_b
        output["inter_f_b"] = list(taps_b)
        return output
