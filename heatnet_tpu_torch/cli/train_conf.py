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
per step: a Freiburg PNG training tree or a heatnet-train-pack-v1 directory
(day frames with labels, night frames; ``open_freiburg_train``, the
``--testroot_*`` trees' stamps filtered out of a tree and required of a
pack) → numpy batches → augmentation on the device → the phase's step
(``train/adversarial.py``) → ``Current loss``. With ``--trainsetname MF``
(:317-320) the frames come from an MFNet tree (``MFNetTrainDataset``: RGBA
PNGs, day labels from ``labels_from_rgbteacher/``), cropped to 384x384 by
``DeviceAugment(mfnet=True)``, and the periodic eval runs every 20 epochs
(:349). MFNet's chain draws no modality-drop rectangle, so ``--moddrop``
with ``--trainsetname MF`` is refused; the JAX trainer fails on it at its
first seg step (``heatnet_tpu/train/adversarial.py:254`` reads
``mod_drop_params``, which its MFNet chain does not return).
``--bn_groups`` takes the segnet's train-mode BN statistics per batch
group.

``--pretraining`` loads a ``cli.train_plain`` checkpoint (``--pretraining_path``)
into ``trgb_segnet``; ``--night_supervision_model`` loads the teacher with
the ``trgb_segnet.`` prefix stripped, in eval mode: a ResNeXt-50 (its
grouped convs run the fused kernel on the card) or, with ``--arch pspnet``,
a PSPNet-ResNet-50, late fusion when it takes RGB and IR (:168-190).
PSPNet's channel dropout draws its masks from the run's generator in both
phases. ``--resume`` (or ``auto``) restores a checkpoint of this trainer.
Weights are random from seed 0 otherwise. Runs on the card unless
``--device cpu``.

Evaluation (:266-314, :447-464) runs a copy of the live ``trgb_segnet``,
prepared for inference, so the training state is untouched:

- ``--eval FR_day|FR_night|MF_day|MF_night|BDD`` validates on the
  ``--testroot_day``, ``--testroot_night`` (+ ``--testroot_fence``),
  ``--testroot_mfnet`` or ``--bdd_dir`` tree, prints the IoU vector, its
  mean and ``Eval successfull!``, and returns the mean; ``--infer DIR``
  serves a capture tree, with ``--im_save_dir`` for PNG dumps (also of
  ``--eval``). BDD's JPEGs need cv2.
- With ``--testroot_day`` and ``--testroot_night`` the trainer validates
  night and day every ``--eval_everyn`` epochs (2 for FR), logs
  ``combined_Test mean IoU`` and writes ``<checkpointname>.pth`` with
  ``best_iou``, and ``<checkpointname>_best.pth`` at a new best. Without
  them it writes ``<checkpointname>.pth`` after every epoch, where the JAX
  trainer writes none.

Checkpoints are ``torch.save({"epoch", "state_dict", "best_iou"})`` files.
The logged loss averages take the losses of the log points only, as the
JAX trainer's do.

``--vis`` (:352-403) renders, at every log point, the day and night class
maps with a dot per critic (green where the critic's mean output is above
0.5), the day RGB and IR, and with ``--cert_branch`` the day certainty, to
``<log_dir>/vis/<step>_{label_day,label_night,rgb_day,ir_day,cert_day}.png``
(``render_vis``). Its forward is the eval-mode model on the running
statistics, so it changes nothing that trains.

Usage::

    python -m heatnet_tpu_torch.cli.train_conf --dataroot TREE_OR_PACK --moddrop --irscale
    python -m heatnet_tpu_torch.cli.train_conf --eval FR_day --testroot_day TREE --resume CK
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..data.loaders import (BDDValDataset, DeviceAugment, FreiburgInferDataset,
                            FreiburgThermalTestDataset, MFNetDataset, MFNetTrainDataset,
                            batch_iterator, get_test_paths, get_test_stamps,
                            open_freiburg_train, prefetch_items)
from ..device import resolve
from ..eval.validate import (eval_batch_size, inference, validate_model,
                             validate_model_bdd, validate_model_mfnet)
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
from ..utils.vis import color_code_labels, draw_critic_labels, save_image, vis_depth

MF_CROP = (384, 384)  # MFNet's train crop (train_conf.py:319)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HeatNet adversarial trainer (PyTorch/CUDA)")
    p.add_argument('--epoch', type=int, default=0, help='starting epoch')
    p.add_argument('--n_epochs', type=int, default=100)
    p.add_argument('--dataroot', type=str, default='',
                   help='Freiburg PNG training tree or heatnet-train-pack-v1 '
                        'directory (needed to train)')
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
    p.add_argument('--n_cpu', type=int, default=8,
                   help='decode threads (PNG trees: --trainsetname MF)')
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
    evals: List[float] = dataclasses.field(default_factory=list)  # combined mean IoUs


def _refuse_unported(opt: argparse.Namespace) -> None:
    if opt.trainsetname not in ("FR", "MF"):
        raise SystemExit(f"Dataset {opt.trainsetname} not known")
    if opt.trainsetname == "MF" and opt.moddrop:
        raise ValueError("--moddrop needs the modality-drop rectangles that the FR chain "
                         "draws; the MF chain draws none (mf_train_sample_preprocess), so "
                         "--trainsetname MF --moddrop has no behaviour to follow")


def eval_copy(segnet: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """A copy of ``segnet`` prepared for inference; ``prepare_for_inference``
    casts weights in place and sets eval mode, which must not reach the
    network that trains."""
    return prepare_for_inference(copy.deepcopy(segnet), device)


def render_vis(model: ConfSegnet, batch: Dict[str, torch.Tensor], it: int, vis_dir: str,
               modalities: str, cert_branch: bool = False) -> List[str]:
    """``--vis`` at one log point (train_conf.py:357-403): one eval-mode
    forward of ``model`` over the batch, then the panels of its first frame
    as PNGs (a critic's verdict is its mean over the whole batch); returns
    their paths.

    The forward runs without gradient and in eval mode, so BN normalises
    with the running statistics and updates none (on the card the grouped
    convs take the fused kernel), weights are cast per call and no random
    draw is made; every module's train flag is restored after it."""
    day = [batch[k] for k in ("rgb_day", "ir_day") if k.split("_")[0] in modalities]
    night = [batch[k] for k in ("rgb_night", "ir_night") if k.split("_")[0] in modalities]
    flags = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        with torch.no_grad():
            out = model(day, night)
    finally:
        for m, training in flags:
            m.training = training

    def host(t: torch.Tensor) -> np.ndarray:
        return t.float().cpu().numpy()

    panels = {}
    for side, name in (("a", "label_day"), ("b", "label_night")):
        img = color_code_labels(host(out[f"pred_label_{side}"][0].argmax(-1)))
        if f"critics_{side}" in out:  # visSegDisc-style dots
            img = draw_critic_labels(img, [bool(c.float().mean() > 0.5)
                                           for c in out[f"critics_{side}"]])
        panels[name] = img
    if "rgb" in modalities:
        panels["rgb_day"] = host(batch["rgb_day"][0]) * 0.5 + 0.5
    if "ir" in modalities:
        panels["ir_day"] = vis_depth(host(batch["ir_day"][0]))
    if cert_branch and out.get("cert_a") is not None:
        panels["cert_day"] = vis_depth(host(out["cert_a"][0, ..., 0]))
    paths = []
    for name, img in panels.items():
        paths.append(os.path.join(vis_dir, f"{it:07d}_{name}.png"))
        save_image(paths[-1], img)
    return paths


def _fr_test_set(roots) -> FreiburgThermalTestDataset:
    return FreiburgThermalTestDataset(*get_test_paths([r for r in roots if r]))


def run_eval(opt: argparse.Namespace, segnet: torch.nn.Module, device: torch.device,
             logger: RunLogger) -> float:
    """``--eval`` (train_conf.py:280-314): the IoU vector of one test set."""
    print('Starting evaluation on: %s....' % opt.eval)
    night = "night" in opt.eval
    mode = "night" if night else "day"
    kw = dict(logger=logger, save_dir=opt.im_save_dir, device=device)
    if "FR" in opt.eval:
        roots = [opt.testroot_night, opt.testroot_fence] if night else [opt.testroot_day]
        ious = validate_model(segnet, prefetch_items(_fr_test_set(roots)),
                              opt.modalities, mode=mode, **kw)
    elif "MF" in opt.eval:
        ds = MFNetDataset(opt.testroot_mfnet, split=mode)
        ious = validate_model_mfnet(segnet, prefetch_items(ds), opt.modalities,
                                    mode=mode, **kw)
    elif "BDD" in opt.eval:
        ious = validate_model_bdd(segnet, prefetch_items(BDDValDataset(opt.bdd_dir)), **kw)
    else:
        print('Eval dataset %s not known... exiting' % opt.eval)
        return 0.0
    print(ious)
    print(np.nanmean(ious))
    print('Eval successfull!')
    return float(np.nanmean(ious))


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


def main(argv=None):
    """Train and return a ``TrainConfRun``; with ``--eval`` return the mean
    IoU, with ``--infer`` 0.0, as the JAX trainer returns."""
    opt = build_parser().parse_args(argv)
    _refuse_unported(opt)
    device = resolve(opt.device)
    if opt.eval != "":
        print('##############EVALUATING MODE##############')
    if opt.infer != "":
        print('##############INFERENCE MODE##############')
    training = not (opt.eval or opt.infer)
    test_roots = [r for r in (opt.testroot_night, opt.testroot_day) if r]
    if training and opt.trainsetname == "MF":
        ds = MFNetTrainDataset(opt.dataroot)
    elif training:
        ds = open_freiburg_train(opt.dataroot, split="train",
                                 test_stamps=get_test_stamps(get_test_paths(test_roots)[2])
                                 if test_roots else None)
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

    # --infer and --eval run the bare segnet (:266-314)
    if opt.infer != "":
        print('Starting inference on: %s....' % opt.infer)
        inference(eval_copy(model.trgb_segnet, device),
                  prefetch_items(FreiburgInferDataset(opt.infer)), eval_batch_size(),
                  device, opt.modalities, save_dir=opt.im_save_dir)
        print('Inference successfull !!!!')
        logger.finish()
        return 0.0
    if opt.eval != "":
        miou = run_eval(opt, eval_copy(model.trgb_segnet, device), device, logger)
        logger.finish()
        return miou

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

    mfnet = opt.trainsetname == "MF"
    augment = DeviceAugment(crop_hw=MF_CROP if mfnet else (opt.crop_height, opt.crop_width),
                            device=device, mfnet=mfnet)
    steps_per_epoch = max(len(ds) // opt.batch_size, 1)
    if opt.max_iters_per_epoch:
        steps_per_epoch = min(steps_per_epoch, opt.max_iters_per_epoch)
    # StepLR(step_size=half_every, gamma=.5) over epochs, per phase (:338-341)
    state = make_phase_optimizers(
        model, step_lr(opt.lr, step_size=half_every, gamma=0.5,
                       steps_per_epoch=steps_per_epoch))
    seg_step, critic_step = make_adversarial_steps(model, cfg, teacher)
    pm = PhaseMachine(cfg, no_conf=opt.no_conf)
    eval_everyn = opt.eval_everyn or (20 if mfnet else 2)  # (:349)
    log_everyn = max(opt.log_everyn, 1)
    vis_dir = os.path.join(opt.log_dir, "vis") if opt.vis else ""
    if vis_dir:
        os.makedirs(vis_dir, exist_ok=True)
    meters = {k: AverageMeter() for k in
              ("total_phase1", "total_phase2", "seg", "conf", "critic")}

    run = TrainConfRun({"train_seg": [], "train_critic": []}, [], [], "")
    generator = torch.Generator().manual_seed(42)
    for epoch in range(start_epoch, n_epochs):
        for i, raw in enumerate(batch_iterator(ds, opt.batch_size, seed=epoch,
                                               workers=opt.n_cpu)):
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
            # the meters average the log points' losses only (:425-443)
            if (i % log_everyn) == 0 or i == steps_per_epoch - 1:
                if phase == "train_seg":
                    meters["total_phase1"].update(total)
                    meters["seg"].update(float(m["seg_loss"]))
                    meters["conf"].update(float(m["conf_loss"]))
                    logger.log({"epoch": epoch,
                                "total_loss_phase1": meters["total_phase1"].avg,
                                "seg_loss": meters["seg"].avg,
                                "conf_loss": float(m["conf_loss"])})
                else:
                    meters["total_phase2"].update(total)
                    meters["critic"].update(float(m["critic_loss"]))
                    logger.log({"epoch": epoch,
                                "total_loss_phase2": meters["total_phase2"].avg,
                                "critic_loss": meters["critic"].avg})
                print("Current loss: %f " % meters[
                    "total_phase1" if phase == "train_seg" else "total_phase2"].avg)
                if vis_dir:
                    render_vis(model, batch, state.step, vis_dir, opt.modalities,
                               opt.cert_branch)

        bundle = lambda: {"epoch": epoch + 1, "state_dict": model.state_dict(),
                          "best_iou": best_track.state["best"]}
        if not (opt.testroot_night and opt.testroot_day):
            run.checkpoint = save_checkpoint(bundle(), opt.checkpointname + ".pth")
        elif epoch % eval_everyn == 0:  # the periodic eval (:447-464)
            segnet = eval_copy(model.trgb_segnet, device)
            ious_night = validate_model(
                segnet, prefetch_items(_fr_test_set([opt.testroot_night, opt.testroot_fence])),
                opt.modalities, mode="night", logger=logger, device=device)
            ious_day = validate_model(
                segnet, prefetch_items(_fr_test_set([opt.testroot_day])),
                opt.modalities, mode="day", logger=logger, device=device)
            del segnet
            iou_mean = float(np.nanmean((ious_day + ious_night) / 2))
            logger.log({"combined_Test mean IoU": iou_mean})
            run.evals.append(iou_mean)
            is_best = best_track(iou_mean)
            run.checkpoint = save_checkpoint(bundle(), opt.checkpointname + ".pth",
                                             is_best=is_best)
    logger.finish()
    return run


if __name__ == "__main__":
    main()
