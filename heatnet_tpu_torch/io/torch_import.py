"""Reference (PyTorch) checkpoints → the port's ``state_dict``.

Counterpart of ``heatnet_tpu/io/torch_import.py``'s name rules. The
reference and the port are both PyTorch, so no layout changes: weights keep
``(O, I, kh, kw)``, transposed convs ``(I, O, kh, kw)`` unflipped, BN keeps
its ``weight``/``bias``/``running_*``. Only the module names differ, by the
rules of ``_rename_path`` (:37-110), copied: the ``.convs.`` and
``start_features`` Sequentials flattened, the trgb stem's ``conv1_2``/``bn1_2``
→ ``conv1``/``bn1``, torchvision's and RTFNet's Sequential indices →
``block{i+1}``, ``downsample.{0,1}`` / ``upsample.{0,1}`` → ``*_conv``/``*_bn``,
PSPNet's ``stages.i.1`` → ``stage{i+1}_conv``, DenseNet's duplicate
``blocks`` list dropped, and the others below; plus the dotted-prefix maps
of the CycleGAN generator and discriminator, DownNet and the input-adapter
UNet (:113-160). Prefixes (``module.``, ``module.trgb_segnet.``) are
rewritten by ``io/checkpoint.py::restore_renamed`` (``initModelRenamed``), as
the JAX ``import_into`` rewrites them after conversion.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def _rename_path(parts) -> list:
    if parts and parts[0] == "blocks":
        # DenseNet registers every block twice: in the ModuleList ``blocks``
        # and as denseblockN/transitionN attributes (extractors.py:274-292);
        # keep only the named aliases
        return []
    out = []
    for p in parts:
        prev = out[-1] if out else ""
        if p in ("convs", "start_features"):
            continue  # Sequential containers flattened in the port's modules
        if p == "conv1_2" and prev.startswith("mod1"):
            # the trgb initBlock names its first pair conv1_2/bn1_2
            # (trgb_segnet.py:230-239), in both stems mod1 and mod1_2;
            # top-level conv1_2/bn1_2 (late-fusion extractors) keep theirs
            p = "conv1"
        elif p == "bn1_2" and prev.startswith("mod1"):
            p = "bn1"
        elif p.isdigit():
            d = int(p)
            if "layer" in prev:
                # torchvision Sequential block index (extractors.py:168-182;
                # also RTFNet's encoder_{rgb,thermal}_layerN)
                p = f"block{d + 1}"
            elif prev.startswith("deconv") and prev[6:].isdigit():
                # RTFNet decoder stages deconvN = Sequential(TransBottleneck…)
                p = f"block{d + 1}"
            elif prev == "upsample":
                # TransBottleneck.upsample = Sequential(ConvTranspose2d|Conv2d,
                # BatchNorm2d) (RTFNet.py:68-80)
                out.pop()
                p = "upsample_conv" if d == 0 else "upsample_bn"
            elif prev == "downsample":
                out.pop()
                p = "downsample_conv" if d == 0 else "downsample_bn"
            elif prev == "stages":
                # PSPModule.stages[i] = Sequential(AdaptiveAvgPool2d, Conv2d)
                out.pop()
                p = f"stage{d + 1}"
            elif prev.startswith("stage") and prev[5:].isdigit():
                out[-1] = out[-1] + "_conv"  # the inner Sequential's Conv2d
                continue
            elif prev == "conv" and len(out) >= 2 and out[-2].startswith("up_"):
                # PSPUpsample.conv = Sequential(Conv2d, BatchNorm2d, PReLU)
                out.pop()
                p = ("conv", "bn", "prelu")[d]
            elif prev == "final":
                continue  # final = Sequential(Conv2d) (pspnet.py:57-59)
            elif prev in ("norm", "conv", "relu"):
                # DenseNet _DenseLayer's dotted names norm.1/conv.2 → norm1/conv2
                out[-1] = prev + p
                continue
            elif (prev[:4] == "down" or prev[:2] == "up") and \
                    prev.lstrip("downup").isdigit():
                # SegNet baseline stages downN/upN = Sequential(ConvBnRelu2d…)
                p = f"m{d}"
            elif prev.startswith("feat_"):
                # SqueezeNet Sequentials (extractors.py:334-351):
                # feat_1.0=conv; feat_2/3.{1,2}=Fire (0=pool); feat_4.{0-3}=Fire
                n = prev[-1]
                out.pop()
                if n == "1":
                    p = "feat1_conv"
                elif n == "4":
                    p = f"feat4_fire{d + 1}"
                else:
                    p = f"feat{n}_fire{d}"
        out.append(p)
    return out


def cyclegan_generator_renames(n_residual_blocks: int = 9) -> Dict[str, str]:
    """Dotted-key prefix map: the reference Generator's Sequential indices
    (cyclegan/models.py:26-67) → the port's named modules (models/cyclegan.py)."""
    m = {"model.1": "inconv", "model.4": "down1", "model.7": "down2"}
    for i in range(n_residual_blocks):
        m[f"model.{10 + i}.conv_block.1"] = f"res{i + 1}.conv1"
        m[f"model.{10 + i}.conv_block.5"] = f"res{i + 1}.conv2"
    base = 10 + n_residual_blocks
    m[f"model.{base}"] = "up1"
    m[f"model.{base + 3}"] = "up2"
    m[f"model.{base + 7}"] = "outconv"
    return m


# the reference patch Discriminator's Sequential (cyclegan/models.py:69-97 ==
# discriminator_model.py:5-33) → conv1..conv5 (InstanceNorms carry no
# parameters)
PATCHGAN_DISC_RENAMES = {
    "model.0": "conv1", "model.2": "conv2", "model.5": "conv3",
    "model.8": "conv4", "model.11": "conv5",
}


def downnet_renames(downsampling: int) -> Dict[str, str]:
    """DownNet Sequential (downscale_network.py:23-35) → downN_conv names."""
    return {f"net.{i}.conv1": f"down{i + 1}_conv" for i in range(downsampling)}


def unet_adapter_renames() -> Dict[str, str]:
    """input_adapter UNet Sequential names (input_adapter.py:5-101) → the port's.

    DoubleConv = Sequential(conv, bn, relu, conv, bn, relu); Down wraps it
    under ``maxpool_conv.1``; Up under ``conv``; OutConv under ``conv``.
    """
    m = {"inc.double_conv.0": "inc.conv1", "inc.double_conv.1": "inc.bn1",
         "inc.double_conv.3": "inc.conv2", "inc.double_conv.4": "inc.bn2",
         "outc.conv": "outc"}
    for i in (1, 2, 3, 4):
        for j, (c, b) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
            m[f"down{i}.maxpool_conv.1.double_conv.{j * 3}"] = f"down{i}.conv.{c}"
            m[f"down{i}.maxpool_conv.1.double_conv.{j * 3 + 1}"] = f"down{i}.conv.{b}"
            m[f"up{i}.conv.double_conv.{j * 3}"] = f"up{i}.conv.{c}"
            m[f"up{i}.conv.double_conv.{j * 3 + 1}"] = f"up{i}.conv.{b}"
    return m


def _apply_rename_map(key: str, rename_map: Dict[str, str]) -> str:
    for old in sorted(rename_map, key=len, reverse=True):
        if key == old or key.startswith(old + "."):
            return rename_map[old] + key[len(old):]
    return key


def convert_state_dict(state_dict: Dict[str, Any],
                       rename_map: Optional[Dict[str, str]] = None
                       ) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` with the port's names: ``rename_map``'s
    dotted-prefix renames first (longest prefix wins), then the name rules.
    Tensors are copied, unchanged. Prefixes such as ``module.`` stay, for
    ``restore_renamed``."""
    out: Dict[str, torch.Tensor] = {}
    for key, tensor in state_dict.items():
        if rename_map:
            key = _apply_rename_map(key, rename_map)
        parts = _rename_path(key.split("."))
        if parts:
            out[".".join(parts)] = torch.as_tensor(tensor).detach().clone()
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A ``.pth``/``.pth.tar`` file's ``state_dict`` (its ``"state_dict"``
    entry where it has one), on the CPU. Reference checkpoints pickle more
    than tensors (epochs, optimizer states), so this loads with
    ``weights_only=False``: load only files you trust."""
    saved = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(saved, dict) and "state_dict" in saved:
        saved = saved["state_dict"]
    return saved

