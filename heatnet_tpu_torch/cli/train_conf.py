"""HeatNet's adversarial trainer, the ``train_trgb_segnet_conf.py`` surface.

Counterpart of ``heatnet_tpu/cli/train_conf.py:23-466``: a ``ConfSegnet``
(the ResNeXt-ASPP segnet or, with ``--arch pspnet``, PSPNet on the dilated
ResNet-50, early or ``--late_fusion``; ``--num_critics`` critics on its
feature taps, optional ``--feedback_seg`` downscale nets and
``--train_input_adapter`` UNet), trained in two phases that a ``PhaseMachine`` alternates
(``--iter_initial_critic_phase`` critic iterations, then
``--iter_critic_phase`` critic and ``--iter_seg_phase`` seg iterations in
turn), one RMSprop with a StepLR(gamma .5) schedule per phase. With conf
on, ``n_epochs`` and ``half_lr_every_epoch`` double (:204-208). The chain
per step: a heatnet-train-pack-v1 directory (day frames with labels, night
frames) → numpy batches → augmentation on the device → the phase's step
(``train/adversarial.py``) → ``Current loss``.

``--pretraining`` loads a ``cli.train_plain`` checkpoint (``--pretraining_path``)
into ``trgb_segnet``; ``--night_supervision_model`` loads the teacher with
the ``trgb_segnet.`` prefix stripped, in eval mode: a ResNeXt-50 (its
grouped convs run the fused kernel on the card) or, with ``--arch pspnet``,
a PSPNet-ResNet-50, late fusion when it takes RGB and IR (:168-190).
PSPNet's channel dropout draws its masks from the run's generator in both
phases. ``--resume`` (or ``auto``) restores a checkpoint of this trainer. Checkpoints are
``torch.save({"epoch", "state_dict", "best_iou"})`` files,
``<checkpointname>.pth``, one per epoch: the JAX trainer writes one after
each periodic eval, which is not ported yet. Weights are random from seed 0
otherwise. Runs on the card unless ``--device cpu``.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
``--bn_groups > 1`` (7), ``--trainsetname MF`` (9), ``--eval``/``--infer``
and the periodic eval of ``--testroot_*`` (5: the validators and the PNG
trees, whose loader needs cv2), ``--vis`` (12).

Usage::

    python -m heatnet_tpu_torch.cli.train_conf --dataroot TRAIN_PACK --moddrop --irscale
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import torch

from ..data.loaders import DeviceAugment, batch_iterator
from ..data.packed import PackedFreiburgTrainDataset, is_train_pack_dir
from ..device import resolve
from ..io.checkpoint import (best_iou_tracker, load_state_dict, restore_partial,
                             restore_renamed, resolve_auto_resume, save_checkpoint)
from ..io.logging import AverageMeter, RunLogger
from ..models import ConfSegnet, ResNeXtSeg, build_network
from ..models.conf_segnet import num_input_channels
from ..models.layers import prepare_for_inference
from ..train.adversarial import (AdversarialConfig, PhaseMachine, draw_seg_aug,
                                 make_adversarial_steps, make_phase_optimizers)
from ..train.optim import step_lr
from ..train.state import init_model


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HeatNet adversarial trainer (PyTorch/CUDA)")
    p.add_argument('--epoch', type=int, default=0, help='starting epoch')
    p.add_argument('--n_epochs', type=int, default=100)
    p.add_argument('--dataroot', type=str, required=True,
                   help='heatnet-train-pack-v1 directory')
    p.add_argument('--testroot_day', type=str, default='')
    p.add_argument('--testroot_night', type=str, default='')
    p.add_argument('--testroot_fence', type=str, default='')
    p.add_argument('--testroot_mfnet', type=str, default='')
    p.add_argument('--discarch', type=str, default='cyclegan')
    p.add_argument('--lr', type=float, default=0.0001)
    p.add_argument('--lr_disc', type=float, default=0.0001,
                   help='parity: unused, as in the reference (both phases use --lr)')
    p.add_argument('--conf_weight', type=float, default=0.1)
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--input_nc', type=int, default=1)
    p.add_argument('--output_nc', type=int, default=1)
    p.add_argument('--cuda', action='store_true', help='parity no-op')
    p.add_argument('--n_cpu', type=int, default=8)
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--iter_seg_phase', type=int, default=50)
    p.add_argument('--iter_critic_phase', type=int, default=500)
    p.add_argument('--iter_initial_critic_phase', type=int, default=1000)
    p.add_argument('--moddrop', action='store_true')
    p.add_argument('--irscale', action='store_true')
    p.add_argument('--smartirscale', action='store_true')
    p.add_argument('--no_conf', action='store_true')
    p.add_argument('--vis', action='store_true')
    p.add_argument('--gpus', nargs='+', type=int, help='parity no-op')
    p.add_argument('--num_critics', type=int, default=6)
    p.add_argument('--half_lr_every_epoch', type=int, default=30)
    p.add_argument('--feedback_seg', action='store_true')
    p.add_argument('--checkpointname', type=str, default='checkpoint')
    p.add_argument('--modalities', default='ir_rgb', type=str)
    p.add_argument('--pretraining', action='store_true')
    p.add_argument('--pretraining_path', type=str,
                   default='models_finished/training_nc_irrgb_best',
                   help='cli.train_plain checkpoint used when --pretraining')
    p.add_argument('--night_supervision_model', type=str, default="")
    p.add_argument('--night_supervision_model_modalities', type=str, default="")
    p.add_argument('--resume', type=str, default="")
    p.add_argument('--train_input_adapter', action='store_true')
    p.add_argument('--cert_branch', action='store_true')
    p.add_argument('--weight_ir_sup', action='store_true')
    p.add_argument('--late_fusion', action='store_true')
    p.add_argument('--arch', default='custom', type=str)
    p.add_argument('--critic_weights', nargs='+', type=float,
                   default=[1., 1., 1., 1., 1., 1., 1.])
    p.add_argument('--adv_loss', default='MSE', type=str)
    p.add_argument('--multidir', action='store_true')
    p.add_argument('--trainsetname', type=str, default="FR")
    p.add_argument('--bdd_dir', type=str, default="")
    p.add_argument('--eval', type=str, default="")
    p.add_argument('--infer', type=str, default="")
    p.add_argument('--im_save_dir', type=str, default="")
    # additive knobs
    p.add_argument('--max_iters_per_epoch', type=int, default=None)
    p.add_argument('--eval_everyn', type=int, default=None)
    p.add_argument('--log_everyn', type=int, default=10,
                   help='log metrics every N iterations')
    p.add_argument('--log_dir', type=str, default='runs')
    p.add_argument('--crop_height', type=int, default=320)
    p.add_argument('--crop_width', type=int, default=640)
    p.add_argument('--structure', nargs=4, type=int, default=[3, 4, 6, 3],
                   help='backbone block counts (debug/smoke)')
    p.add_argument('--bn_groups', type=int, default=1)
    p.add_argument('--device', default=None, help='cuda (the default) or cpu')
    return p


@dataclasses.dataclass
class TrainConfRun:
    losses: Dict[str, List[float]]  # each step's total loss, by phase
    phases: List[str]               # the phase of each iteration
    step_seconds: List[float]       # each step, augmentation to loss on the host
    checkpoint: str                 # the last checkpoint written


def _refuse_unported(opt: argparse.Namespace) -> None:
    unported = [
        (opt.bn_groups > 1, "--bn_groups > 1", 7),
        (opt.trainsetname == "MF", "--trainsetname MF", 9),
        (bool(opt.eval), "--eval", 5),
        (bool(opt.infer), "--infer", 5),
        (bool(opt.testroot_day or opt.testroot_night or opt.testroot_fence
              or opt.testroot_mfnet), "the periodic eval of --testroot_*", 5),
        (opt.vis, "--vis", 12),
    ]
    for hit, flag, item in unported:
        if hit:
            raise NotImplementedError(
                f"{flag} is not ported to heatnet_tpu_torch yet (ROADMAP item {item})")
    if opt.trainsetname != "FR":
        raise SystemExit(f"Dataset {opt.trainsetname} not known")


def load_teacher(path: str, modalities: str, cert_branch: bool,
                 device: torch.device, arch: str = "custom") -> torch.nn.Module:
    """The frozen night-supervision model (train_conf.py:168-190) over
    ``modalities``: a ResNeXt-50, or for arch ``pspnet`` a PSPNet-ResNet-50
    (late fusion over RGB and IR), its checkpoint read with the
    ``trgb_segnet.`` prefix stripped, prepared for inference."""
    n_in = num_input_channels(modalities)
    if arch == "pspnet":
        teacher = build_network("resnet50", in_channels=n_in, late_fusion=n_in >= 4)
    else:
        teacher = ResNeXtSeg(structure=(3, 4, 6, 3), input_channels=n_in,
                             cert_branch=cert_branch)
    restore_renamed(teacher, load_state_dict(path), "trgb_segnet.", "")
    return prepare_for_inference(teacher, device)


def main(argv=None) -> TrainConfRun:
    opt = build_parser().parse_args(argv)
    _refuse_unported(opt)
    device = resolve(opt.device)
    if not is_train_pack_dir(opt.dataroot):
        raise SystemExit(f"{opt.dataroot} is not a heatnet-train-pack-v1 directory "
                         "(PNG training trees are not read by the port yet)")
    logger = RunLogger("hotnet", log_dir=opt.log_dir)

    model = init_model(ConfSegnet(
        disc_arch=opt.discarch, num_critics=opt.num_critics,
        feedback_seg=opt.feedback_seg, no_conf=opt.no_conf,
        modalities=opt.modalities, input_adapter=opt.train_input_adapter,
        cert_branch=opt.cert_branch, arch=opt.arch, late_fusion=opt.late_fusion,
        structure=tuple(opt.structure), bn_groups=opt.bn_groups), seed=0, device=device)
    if opt.pretraining:
        # the supervised segnet into trgb_segnet (conf_segnet.py:80-81)
        restore_partial(model.trgb_segnet, load_state_dict(opt.pretraining_path))

    teacher = None
    ns_mod = opt.night_supervision_model_modalities or "ir"
    if opt.night_supervision_model:
        teacher = load_teacher(opt.night_supervision_model, ns_mod,
                               opt.cert_branch, device, opt.arch)

    cfg = AdversarialConfig(
        adv_loss=opt.adv_loss, conf_weight=opt.conf_weight,
        critic_weights=tuple(opt.critic_weights), multidir=opt.multidir,
        cert_branch=opt.cert_branch, weight_ir_sup=opt.weight_ir_sup,
        night_supervision=teacher is not None, modalities=opt.modalities,
        moddrop=opt.moddrop, irscale=opt.irscale, smartirscale=opt.smartirscale,
        night_sup_modalities=ns_mod, iter_seg_phase=opt.iter_seg_phase,
        iter_critic_phase=opt.iter_critic_phase,
        iter_initial_critic_phase=opt.iter_initial_critic_phase)

    # n_epochs and the halving period double when both nets train (:204-208)
    n_epochs, half_every = opt.n_epochs, opt.half_lr_every_epoch
    if not opt.no_conf:
        n_epochs *= 2
        half_every *= 2

    best_track = best_iou_tracker()
    start_epoch = opt.epoch
    resume = resolve_auto_resume(opt.resume, opt.checkpointname + ".pth")
    if resume:
        saved = torch.load(resume, map_location="cpu", weights_only=True)
        restore_partial(model, saved["state_dict"])
        start_epoch = int(saved.get("epoch", 0))
        best_track.state["best"] = float(saved.get("best_iou", 0.0))

    ds = PackedFreiburgTrainDataset(opt.dataroot)
    augment = DeviceAugment(crop_hw=(opt.crop_height, opt.crop_width), device=device)
    steps_per_epoch = max(len(ds) // opt.batch_size, 1)
    if opt.max_iters_per_epoch:
        steps_per_epoch = min(steps_per_epoch, opt.max_iters_per_epoch)
    # StepLR(step_size=half_every, gamma=.5) over epochs, per phase (:338-341)
    state = make_phase_optimizers(
        model, step_lr(opt.lr, step_size=half_every, gamma=0.5,
                       steps_per_epoch=steps_per_epoch))
    seg_step, critic_step = make_adversarial_steps(model, cfg, teacher)
    pm = PhaseMachine(cfg, no_conf=opt.no_conf)
    log_everyn = max(opt.log_everyn, 1)
    meters = {k: AverageMeter() for k in
              ("total_phase1", "total_phase2", "seg", "conf", "critic")}

    run = TrainConfRun({"train_seg": [], "train_critic": []}, [], [], "")
    generator = torch.Generator().manual_seed(42)
    for epoch in range(start_epoch, n_epochs):
        for i, raw in enumerate(batch_iterator(ds, opt.batch_size, seed=epoch)):
            if opt.max_iters_per_epoch and i >= opt.max_iters_per_epoch:
                break
            t0 = time.perf_counter()
            batch = augment(generator, raw)
            phase = pm.tick()
            n = batch["label_day"].shape[0]
            if phase == "train_seg":
                draws = draw_seg_aug(generator, cfg.num_classes)
                draws.dropout = model.draw_dropout(n, generator)
                m = seg_step(state, batch, draws)
            else:
                m = critic_step(state, batch, model.draw_dropout(n, generator))
            total = float(m["total_loss"])  # waits for the step
            run.step_seconds.append(time.perf_counter() - t0)
            run.losses[phase].append(total)
            run.phases.append(phase)
            if phase == "train_seg":
                meters["total_phase1"].update(total)
                meters["seg"].update(float(m["seg_loss"]))
                meters["conf"].update(float(m["conf_loss"]))
            else:
                meters["total_phase2"].update(total)
                meters["critic"].update(float(m["critic_loss"]))
            if (i % log_everyn) == 0 or i == steps_per_epoch - 1:
                if phase == "train_seg":
                    logger.log({"epoch": epoch,
                                "total_loss_phase1": meters["total_phase1"].avg,
                                "seg_loss": meters["seg"].avg,
                                "conf_loss": float(m["conf_loss"])})
                else:
                    logger.log({"epoch": epoch,
                                "total_loss_phase2": meters["total_phase2"].avg,
                                "critic_loss": meters["critic"].avg})
                print("Current loss: %f " % meters[
                    "total_phase1" if phase == "train_seg" else "total_phase2"].avg)
        run.checkpoint = save_checkpoint(
            {"epoch": epoch + 1, "state_dict": model.state_dict(),
             "best_iou": best_track.state["best"]}, opt.checkpointname + ".pth")
    logger.finish()
    return run


if __name__ == "__main__":
    main()
