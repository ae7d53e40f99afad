"""Training cells: HeatNet's adversarial steps, driven as ``train_conf`` drives them.

Set-up builds one trainer (``ConfSegnet`` with its critics, the IR teacher,
one RMSprop per phase, ``make_adversarial_steps``) with the benchmark's
weights, and drives it from the seed through its first three steps, each a
raw batch of the pool through ``DeviceAugment`` (and ``draw_seg_aug`` in a
seg step) into ``critic_step`` or ``seg_step``. The same object then runs the
window in whole blocks of the traffic's schedule: the configuration's
schedule as the benchmark reads it (``schedule``), or seg steps alone. A
synchronise ends the window.

Correctness (``judge``): the float32 reference follows the first three steps
from the same weights, raw frames and generator, and three numbers compare
the program with it:

- ``loss_gap.first``, ``loss_gap.max``: the relative gap of the first
  step's loss, and the largest over the steps;
- ``grad_gap.<phase>``, ``grad_gap_median.<phase>``: each phase's first
  gradient, as its optimizer got it (from RMSprop's state after the step:
  |g| = sqrt(sq / (1 - alpha))), leaf by leaf: |norm(program) -
  norm(reference)| over the larger of the reference's norm and its median
  leaf's; the worst leaf, and the median over the leaves;
- ``sign_flip.<phase>``: the share of the phase's elements whose first
  update (RMSprop's first step moves each element by about 10 lr against
  its gradient's sign) goes the other way than the reference's;
- ``change_gap.max``, ``change_gap.median``: the same of each leaf's change
  over the steps;
- ``untrained_moved``: leaves that the reference leaves as they were and the
  program moved.
- ``schedule_mismatch``: steps at which the program's ``PhaseMachine``,
  ticked beside the benchmark's schedule, named another phase.

The cell's limits file names the numbers that decide ``correct``
(``PERF.md`` says why those); the others are printed as diagnostics.

Leaves whose reference gradient is under a thousandth of the median leaf's
(rounding only: no loss reads them) are left out of the gaps.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import augment as ref_aug
from ..reference.adversarial import ConfNet, Trainer
from ..reference.segnet import segnet_from_config
from . import common, roofline
from .trace import Readout, Tracer
from .traffic import train_pool
from .weights import load_reference, make_weights

TEACHER_DTYPE = torch.bfloat16  # served in eval mode: weights in the compute dtype
FIRST_STEPS = 3
TINY = 1e-3  # a leaf under TINY x the median leaf's reference gradient is left out


def _nets(cfg: dict):
    with torch.device("meta"):
        return ConfNet(cfg), segnet_from_config(cfg, input_channels=1)


def weights(cfg: dict, seed: int, device):
    net, teacher = _nets(cfg)
    return (make_weights(net, common.sub_seed(seed, 0), device, torch.float32),
            make_weights(teacher, common.sub_seed(seed, 4), device, TEACHER_DTYPE))


def schedule(cfg: dict, tr: dict):
    """The phase of every step, as an iterator, and the steps of a block.

    The benchmark's own reading of the configuration's schedule (HeatNet's
    train_trgb_segnet_conf.py): ``iter_initial_critic_phase`` critic steps,
    then ``iter_seg_phase`` seg steps and ``iter_critic_phase`` critic steps
    in turn; or seg steps alone. The program's ``PhaseMachine`` is held to it
    (``ScheduleCheck``), never the other way round."""
    if tr["phases"] == "seg":
        def seg_only():
            while True:
                yield "train_seg"
        return seg_only(), tr["block_steps"]
    s = cfg["schedule"]

    def mix():
        yield from ["train_critic"] * s["iter_initial_critic_phase"]
        while True:
            yield from ["train_seg"] * s["iter_seg_phase"]
            yield from ["train_critic"] * s["iter_critic_phase"]
    return mix(), s["iter_critic_phase"] + s["iter_seg_phase"]


class ScheduleCheck:
    """The program's ``PhaseMachine`` ticked once per step beside the
    benchmark's schedule; ``mismatches`` counts the steps where the two
    disagree (read as ``schedule_mismatch``). A seg-only mix runs no machine."""

    def __init__(self, cfg: dict, tr: dict):
        self.machine = None
        self.mismatches = 0
        if tr["phases"] != "seg":
            from heatnet_tpu_torch.train.adversarial import PhaseMachine
            self.machine = PhaseMachine(_adv_config(cfg))

    def step(self, phase: str) -> None:
        if self.machine is not None and self.machine.tick() != phase:
            self.mismatches += 1

    def readings(self) -> Dict[str, float]:
        return {} if self.machine is None else {"schedule_mismatch": float(self.mismatches)}


def _adv_config(cfg: dict):
    from heatnet_tpu_torch.train.adversarial import AdversarialConfig
    t, s = cfg["training"], cfg["schedule"]
    return AdversarialConfig(adv_loss="MSE", conf_weight=t["conf_weight"],
                             night_supervision=True, modalities=cfg["modalities"],
                             moddrop=t["moddrop"], irscale=t["irscale"],
                             num_classes=cfg["segnet"]["classes"],
                             iter_seg_phase=s["iter_seg_phase"],
                             iter_critic_phase=s["iter_critic_phase"],
                             iter_initial_critic_phase=s["iter_initial_critic_phase"])


def _meta_batch(cfg, tr, n):
    h, w = tr["crop"]
    b = {k: torch.empty(n, h, w, c, device="meta")
         for k, c in (("rgb_day", 3), ("ir_day", 1), ("rgb_night", 3), ("ir_night", 1))}
    b["label_day"] = torch.zeros(n, h, w, dtype=torch.long, device="meta")
    b["rect"] = torch.zeros(n, 4, dtype=torch.int32)
    return b


def yardstick(cfg: dict, tr: dict) -> Dict[str, Dict[str, float]]:
    """FLOPs (forward and backward) and the grouped conv's bound of one
    critic and one seg step, counted on the reference at the cell's shapes
    (meta tensors): the critic step runs the segnet's forward twice; the
    seg step its forward and dx twice and the teacher's fused forward once."""
    net, teacher = _nets(cfg)
    trainer = Trainer(net, teacher, cfg)
    batch = _meta_batch(cfg, tr, tr["batch"])
    seg_shapes = roofline.GroupedConvShapes(net.trgb_segnet)
    t_shapes = roofline.GroupedConvShapes(teacher)
    f_critic = roofline.count_flops(lambda: trainer.critic_step(batch))
    bound_critic = roofline.sum_bounds(seg_shapes.shapes)
    seg_shapes.shapes.clear()
    draws = {"moddrop": False, "irscale": False, "smart": False}
    f_seg = roofline.count_flops(lambda: trainer.seg_step(batch, draws))
    bound_seg = 2 * roofline.sum_bounds(seg_shapes.shapes) + roofline.sum_bounds(
        t_shapes.shapes, True)
    seg_shapes.remove()
    t_shapes.remove()
    return {"flops": {"critic": f_critic, "seg": f_seg},
            "bound.grouped_conv3x3": {"critic": bound_critic, "seg": bound_seg}}


class Port:
    """The program's trainer, as ``train_conf`` builds it."""

    def __init__(self, cfg: dict, tr: dict, w_net, w_teacher, seed: int, device):
        from heatnet_tpu_torch.data.loaders import DeviceAugment
        from heatnet_tpu_torch.models.conf_segnet import ConfSegnet
        from heatnet_tpu_torch.models.layers import (NormAct, prepare_for_inference,
                                                     prepare_for_training)
        from heatnet_tpu_torch.models.trgb_segnet import ResNeXtSeg
        from heatnet_tpu_torch.train import adversarial as adv

        s = cfg["segnet"]
        with torch.device("meta"):
            model = ConfSegnet(disc_arch=cfg["critics"]["arch"], num_critics=cfg["critics"]["count"],
                               modalities=cfg["modalities"], arch="custom",
                               classes=s["classes"], structure=tuple(s["structure"]))
            teacher = ResNeXtSeg(structure=tuple(s["structure"]), groups=s["groups"],
                                 classes=s["classes"], dilation=tuple(s["dilation"]),
                                 base_channels=tuple(s["base_channels"]), input_channels=1,
                                 norm_act=NormAct(activation=s["activation"]))
        model.load_state_dict(w_net, assign=True)
        teacher.load_state_dict(w_teacher, assign=True)
        self.model = prepare_for_training(model, device)
        self.teacher = prepare_for_inference(teacher, device)
        lr = cfg["training"]["lr"]
        self.state = adv.make_phase_optimizers(self.model, lambda count: lr)
        self.seg_step, self.critic_step = adv.make_adversarial_steps(
            self.model, _adv_config(cfg), self.teacher)
        self.augment = DeviceAugment(tuple(tr["crop"]), device)
        self.generator = torch.Generator().manual_seed(common.sub_seed(seed, 2))
        self.adv = adv
        self.n = tr["batch"]

    def step(self, phase: str, raw) -> torch.Tensor:
        """One step of ``phase`` on a raw host batch; its loss (on the device)."""
        with torch.profiler.record_function("pb.augment"):
            batch = self.augment(self.generator, raw)
        if phase == "train_seg":
            draws = self.adv.draw_seg_aug(self.generator)
            draws.dropout = self.model.draw_dropout(self.n, self.generator)
            with torch.profiler.record_function("pb.seg_step"):
                return self.seg_step(self.state, batch, draws)["total_loss"]
        with torch.profiler.record_function("pb.critic_step"):
            return self.critic_step(self.state, batch,
                                    self.model.draw_dropout(self.n, self.generator))["total_loss"]

    def first_gradient(self, phase: str) -> Dict[str, float]:
        """The norm of each leaf's gradient as the phase's optimizer got it in
        its first step, from RMSprop's state."""
        ts = self.state.seg if phase == "train_seg" else self.state.critic
        names = {id(p): k for k, p in self.model.named_parameters()}
        alpha = ts.optimizer.defaults["alpha"]
        out = {}
        for group in ts.optimizer.param_groups:
            for p in group["params"]:
                st = ts.optimizer.state.get(p)
                sq = 0.0 if not st else float(st["square_avg"].double().sum())
                out[names[id(p)]] = math.sqrt(sq / (1 - alpha))
        return out

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.model.named_parameters()}


def _change(params: Dict[str, torch.Tensor], p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float((p.double() - p0[k].double()).norm()) for k, p in params.items()}


def _signs(params: Dict[str, torch.Tensor], p0: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The sign of each element's update since ``p0`` (int8, on the host)."""
    return {k: torch.sign(p.detach() - p0[k]).to(torch.int8).cpu() for k, p in params.items()}


def _raw_on(raw, device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in raw.items():
        v = v.astype(np.int32) if v.dtype == np.uint16 else v
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def reference_readings(cfg: dict, tr: dict, seed: int, pool, phases: List[str], device,
                       quant=None, half: bool = False) -> dict:
    """The reference's (or the control's) losses, first gradients and changes
    over the first steps, from the run's weights, frames and draws.
    ``half``: the fault of a step on the first half of each batch."""
    common.reference_precision()
    w_net, w_teacher = weights(cfg, seed, device)
    net, teacher = _nets(cfg)
    net, teacher = load_reference(net, w_net), load_reference(teacher, w_teacher)
    p0 = {k: v.clone() for k, v in w_net.items() if k in dict(net.named_parameters())}
    del w_net, w_teacher
    trainer = Trainer(net, teacher, cfg, quant)
    gen = torch.Generator().manual_seed(common.sub_seed(seed, 2))
    n, crop = tr["batch"], tuple(tr["crop"])
    in_hw = (tr["height"], ref_aug.TRAIN_WINDOW[1] - ref_aug.TRAIN_WINDOW[0])
    losses, grads, signs = [], {}, {}
    for k, phase in enumerate(phases):
        d = ref_aug.draw_train(gen, n, in_hw, crop)
        batch = ref_aug.augment(_raw_on(pool[k % len(pool)], device), d, crop)
        if half:
            batch = {key: v[:n // 2] for key, v in batch.items()}
        if phase == "train_seg":
            loss, g = trainer.seg_step(batch, ref_aug.draw_seg(gen, cfg["segnet"]["classes"]))
        else:
            loss, g = trainer.critic_step(batch)
        losses.append(float(loss.detach()))
        if phase not in grads:
            grads[phase] = {key: (0.0 if v is None else float(v.double().norm()))
                            for key, v in g.items()}
            signs[phase] = _signs({key: p for key, p in net.named_parameters() if key in g}, p0)
    change = _change({k: p.detach() for k, p in net.named_parameters()}, p0)
    return {"losses": losses, "grads": grads, "change": change, "signs": signs}


def _median(values) -> float:
    v = [x for x in values if x > 0]
    return float(np.median(v)) if v else 0.0


def _gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> List[float]:
    """Per leaf: |norm(program) - norm(reference)| over the larger of the
    reference's norm and its median leaf's."""
    med = _median(ref[k] for k in leaves)
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """Every number the check may compare (module docstring): the first
    step's loss gap and the largest; per phase the worst and the median
    leaf's first gradient; the worst and the median leaf's change; the
    untrained leaves moved. Medians are over the leaves of one phase."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    if any(not math.isfinite(x) for x in prog["losses"]):
        gaps = [math.inf] * len(gaps)
    out = {"loss_gap.first": gaps[0], "loss_gap.max": max(gaps)}
    trained = {k for k, v in ref["change"].items() if v > 0}
    changes = []
    for phase, g in ref["grads"].items():
        med = _median(g.values())
        kept = sorted(k for k, v in g.items() if v >= TINY * med)
        name = phase.replace("train_", "")
        grad = _gaps(prog["grads"].get(phase, {}), g, kept)
        out[f"grad_gap.{name}"] = max(grad, default=0.0)
        sp, sr = prog["signs"].get(phase, {}), ref["signs"][phase]
        flips = sum(int((sp[k] != sr[k]).sum()) if k in sp else sr[k].numel() for k in kept)
        out[f"sign_flip.{name}"] = flips / max(sum(sr[k].numel() for k in kept), 1)
        out[f"grad_gap_median.{name}"] = float(np.median(grad)) if grad else 0.0
        changes += _gaps(prog["change"], ref["change"], [k for k in kept if k in trained])
    out["change_gap.max"] = max(changes, default=0.0)
    out["change_gap.median"] = float(np.median(changes)) if changes else 0.0
    out["untrained_moved"] = float(sum(1 for k, v in prog["change"].items()
                                       if k not in trained and v > 0))
    return out


def explain(prog: dict, ref: dict, top: int = 4) -> dict:
    """The losses and the worst leaves behind ``compare``'s gaps."""
    out = {"losses": [prog["losses"], ref["losses"]]}
    for phase, g in ref["grads"].items():
        med = _median(g.values())
        p = prog["grads"].get(phase, {})
        worst = sorted(g, key=lambda k: -abs(p.get(k, 0.0) - g[k]) / max(g[k], med, 1e-30))
        out["grad." + phase] = [[k, p.get(k), g[k]] for k in worst[:top]] + [["median", med]]
        c = ref["change"]
        medc = _median(c[k] for k in g)
        worst = sorted(g, key=lambda k: -abs(prog["change"][k] - c[k]) / max(c[k], medc, 1e-30))
        out["change." + phase] = [[k, prog["change"][k], c[k]] for k in worst[:top]] + [
            ["median", medc]]
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        control: str = "") -> dict:
    cfg, tr = cell.config, cell.traffic
    readout = Readout("train")
    readout.work = yardstick(cfg, tr)
    pool = train_pool(tr, common.sub_seed(seed, 1), device)
    w_net, w_teacher = weights(cfg, seed, device)
    port = Port(cfg, tr, w_net, w_teacher, seed, device)
    del w_net, w_teacher
    phases, block = schedule(cfg, tr)
    machine = ScheduleCheck(cfg, tr)

    # the first steps, which the reference follows
    first, losses, grads, signs = [], [], {}, {}
    for k in range(FIRST_STEPS):
        phase = next(phases)
        machine.step(phase)
        first.append(phase)
        losses.append(float(port.step(phase, pool[k % len(pool)])))
        if phase not in grads:
            grads[phase] = port.first_gradient(phase)
            p0 = weights(cfg, seed, device)[0]
            signs[phase] = _signs({n: p for n, p in port.params().items()
                                   if n in grads[phase]}, p0)
    p0 = {k: v for k, v in weights(cfg, seed, device)[0].items()
          if k in dict(port.model.named_parameters())}
    prog = {"losses": losses, "grads": grads, "change": _change(port.params(), p0),
            "signs": signs}
    del p0
    common.sync(device)

    tracer = Tracer(readout, device) if trace else None
    every = tr["trace"]["every_blocks"]
    t_start_wall = time.time()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k, blocks = FIRST_STEPS, 0
    counts = {"critic": 0, "seg": 0}
    while True:
        plan = [next(phases) for _ in range(block)]
        for phase in plan:
            machine.step(phase)
        units = {"critic": plan.count("train_critic"), "seg": plan.count("train_seg")}
        span = (tracer.span(**units) if tracer and blocks % every == 0
                else contextlib.nullcontext())
        with span:
            for phase in plan:
                port.step(phase, pool[k % len(pool)])
                k += 1
        for u, c in units.items():
            counts[u] += c
        blocks += 1
        if time.perf_counter() >= deadline:
            break
    common.sync(device)
    elapsed = time.perf_counter() - t0
    readout.run_units, readout.run_s = dict(counts), elapsed
    peak = common.memory_peak(device)
    del port
    common.free(device)

    ref = reference_readings(cfg, tr, seed, pool, first, device)
    steps = counts["critic"] + counts["seg"]
    return {"window_start": t_start_wall, "window_s": elapsed, "attempted": steps, "failed": 0,
            "end_to_end": {"train_frames_per_s": steps * tr["batch"] / elapsed},
            "readout": readout, "readings": dict(compare(prog, ref), **machine.readings()),
            "memory_peak_bytes": peak,
            "first": {"phases": first, "program": prog, "reference": ref}}
