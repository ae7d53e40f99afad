"""Two-phase adversarial confusion-maximisation trainer.

Counterpart of ``heatnet_tpu/train/adversarial.py:60-401`` (the reference's
``train_trgb_segnet_conf.py``): two phases, ``train_seg`` and
``train_critic``, alternating on a host counter (``PhaseMachine``); the
critic loss Σ_i conf(c_a_i → 1) + conf(c_b_i → 0); the seg loss, day
cross-entropy plus an optional night pseudo-label term from a frozen IR
teacher, an optional certainty loss and ``conf_weight`` times the
confusion loss that drives the critics to the wrong label; RMSprop with a
StepLR schedule per phase.

The JAX package keeps the model pure and runs two jitted steps over one
parameter tree with masked optimizers. Here the phases are the reference's
own idiom: ``ConfSegnet.set_phase`` turns ``requires_grad`` off on the
frozen side, and each phase has a ``torch.optim.RMSprop`` over the
parameters it trains (``make_phase_optimizers``): the seg optimizer over
everything but ``critics_*``, the critic optimizer over everything but
``trgb_segnet``. The downscale nets, the adapter and ``adapter_disc`` sit in
both, each optimizer with its own moments, and each schedule counts its own
optimizer's steps, as optax's ``multi_transform`` does.

In the critic phase without an input adapter the frozen segnet runs under
``torch.no_grad()`` (in train mode: BN statistics still update), the
counterpart of XLA dropping the frozen backward
(tests/test_train.py:136-154). With the adapter the graph goes through the
frozen segnet, so its input gradients run and its weight gradients do not.

The reference's quirks are kept: the night weighting takes the softmax of
probabilities already softmaxed (:310), the confusion target is 0 for day
only with ``multidir`` (:197), the certainty loss is weighted x10 (:320),
and BN statistics update on both forwards (day, then night) of each step.
Every random draw of the seg phase's augmentation is explicit
(``SegAugDraws``, from a ``torch.Generator`` by ``draw_seg_aug``), so that
the tests can feed in the draws of the JAX key. So are the keep masks of a
PSPNet segnet's channel dropout, which runs in train mode in both phases
(the reference never switches the segnet to eval between phases):
``ConfSegnet.draw_dropout`` draws them, ``SegAugDraws.dropout`` carries the
seg step's and ``critic_step`` takes the critic step's. The JAX steps take
theirs from the step key (seg) and from ``fold_in(PRNGKey(1), step)``
(critic) (adversarial.py:284-289, :339-343); the port's stream differs, the
distribution is the same.

Over a data-parallel mesh (``mesh=``, ``parallel/mesh.py``) each process
holds its rows of the batch, and a step equals one process's step on the
whole batch, as JAX's step on the ``shard_batch``-placed batch is. Every
mean of the losses is the whole batch's: the cross-entropies over the whole
batch's valid pixels, the night and certainty losses over its every pixel,
each critic's criterion over every critic output of the whole batch, the
night weighting's mean too. The sums behind them go through one
differentiable ``all_reduce_sum`` per reduction site (``BatchMeans``), so
every process holds the whole batch's loss, and a product of two means (the
night-weighted confusion loss, ``mean(w) · criterion(c)``) is the product of
the global ones. The convention: each process backpropagates its part,
``loss / n`` for n processes; ``all_reduce_sum``'s backward sums the parts'
gradients over the processes, so the gradient that reaches each process's
local sums is the whole loss's, and ``all_reduce_gradients`` over the phase's
trainable parameters then sums the local terms into the whole batch's
gradients. Train-mode BN statistics span the whole batch while the steps
run (``data_parallel``), the frozen segnet's in the critic phase among them.
The metrics are the whole batch's. The caller draws the seg phase's
augmentation and the dropout masks for the whole batch on every process,
from one generator in one order, and gives each step its rows of the masks
(``shard_batch``); ``mod_drop_params`` is per sample and goes with the rows.
One process (no mesh, or a mesh of one) takes ``torch.mean``.

On frames split by rows (``parallel/spatial.py::adversarial_frames``: the
steps built with the mesh, run under ``spatial_parallel``) the same
convention holds with ``RowMeans``: a map's means (the cross-entropies, the
night and certainty losses, a patch critic's criterion, the night
weighting) sum over the processes, while a pooled critic's ``(N, 1)``
score is the whole frame's on every process and its mean is each
process's own; every process backpropagates ``loss / n`` and the
gradients are summed. Train-mode BN takes its statistics over the shards
(the frozen segnet's in the critic phase too), the critics gather the maps
their windows no longer split (``models/critics.py``), and ``rect_drop``
reads the frame's rows (``spatial.row_offset``). The caller draws the
augmentation and the dropout masks once for the whole batch, the same on
every process.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..models.layers import at_least_f32
from ..ops.preprocess import (draw_ir_scale, draw_smart_augment, ir_scale_aug,
                              maybe_smart_augment, rect_drop)
from ..parallel import spatial
from ..parallel.mesh import (all_reduce_gradients, all_reduce_sum, check_same_gradients,
                             data_group, data_parallel, data_size)
from .optim import masked_optimizer, rmsprop
from .state import TrainState
from .supervised import cross_entropy_ignore


@dataclasses.dataclass(frozen=True)
class AdversarialConfig:
    """Loss and augmentation knobs (the flags of train_trgb_segnet_conf.py)."""

    adv_loss: str = "MSE"  # MSE | BCE
    conf_weight: float = 0.1
    critic_weights: Tuple[float, ...] = (1.0,) * 7
    multidir: bool = False
    cert_branch: bool = False
    weight_ir_sup: bool = False
    night_supervision: bool = False
    modalities: str = "ir_rgb"
    moddrop: bool = False
    irscale: bool = False
    smartirscale: bool = False
    num_classes: int = 13
    night_sup_modalities: str = "ir"  # the teacher's inputs: "ir" or "ir_rgb"
    iter_seg_phase: int = 50
    iter_critic_phase: int = 500
    iter_initial_critic_phase: int = 1000


class ConfCriterion:
    """MSE / BCE-with-logits against a constant target: ``elementwise(x, t)``
    per critic output, f32 (float64 stays float64); calling it takes the
    mean."""

    def __init__(self, kind: str):
        if kind not in ("MSE", "BCE"):
            raise ValueError(f"Loss not known : {kind}")
        self.kind = kind

    def elementwise(self, x: torch.Tensor, t: float) -> torch.Tensor:
        x = at_least_f32(x)
        if self.kind == "MSE":
            return (x - t) ** 2
        return torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))

    def __call__(self, x: torch.Tensor, t: float) -> torch.Tensor:
        return torch.mean(self.elementwise(x, t))


def conf_criterion(kind: str) -> ConfCriterion:
    """MSE / BCE-with-logits against a constant target, mean-reduced, f32."""
    return ConfCriterion(kind)


class LocalMeans:
    """The means of this process's batch (one process: ``torch.mean``)."""

    def means(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.mean(x) for x in xs]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.means([x])[0]

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return cross_entropy_ignore(logits, labels, ignore_index=-1)


class BatchMeans(LocalMeans):
    """The means of the whole batch of a data-parallel mesh, held by every
    process: each reduction site's local sums cross in one differentiable
    ``all_reduce_sum`` (every process holds equal rows, so an element count
    is the local one times the processes)."""

    def __init__(self, mesh):
        self.group = data_group(mesh)
        self.processes = data_size(mesh)

    def split(self, x: torch.Tensor) -> bool:
        """Whether each process holds its part of ``x`` (else all of it)."""
        return True

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(self.group, t)

    def _sums(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        dtype = parts[0].dtype
        for p in parts[1:]:
            dtype = torch.promote_types(dtype, p.dtype)
        return self._reduce(torch.stack([p.to(dtype) for p in parts]))

    def means(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        parts = [i for i, x in enumerate(xs) if self.split(x)]
        out = [None if i in parts else torch.mean(x) for i, x in enumerate(xs)]
        if parts:
            sums = self._sums([xs[i].sum() for i in parts])
            for j, i in enumerate(parts):
                out[i] = sums[j] / (xs[i].numel() * self.processes)
        return out

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """``cross_entropy_ignore`` (label -1 ignored) over the whole batch's
        valid pixels."""
        nll = cross_entropy_ignore(logits, labels, ignore_index=-1, reduce=False)
        sums = self._sums([nll.sum(), (labels != -1).sum().to(nll.dtype)])
        return sums[0] / sums[1].clamp(min=1)


class RowMeans(BatchMeans):
    """The means of the whole batch of frames split by rows over a mesh's
    ``data`` dimension, held by every process: a map (NHW or NHWC, this
    process's rows of every sample) sums over the processes, as
    ``BatchMeans``' rows of samples do; a per-sample score (a pooled
    critic's ``(N, 1)``) is the whole frame's, the same on every process,
    and its mean is each process's own. The reductions run in the
    backward's order of ``spatial.ordered``."""

    def split(self, x: torch.Tensor) -> bool:
        return x.dim() >= 3

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        return spatial.ordered(lambda u: all_reduce_sum(self.group, u), t)


def means_for(mesh) -> LocalMeans:
    """The means a step takes where it runs: ``RowMeans`` under
    ``spatial_parallel`` (the steps built with its mesh), ``BatchMeans``
    over a data-parallel mesh of several processes, else ``LocalMeans``."""
    if spatial.spatial_group() is not None:
        if mesh is None:
            raise ValueError("frames split by rows need the steps built with the mesh")
        return RowMeans(mesh)
    return BatchMeans(mesh) if data_size(mesh) > 1 else LocalMeans()


# -- the per-phase optimizers --------------------------------------------------

def is_critic_key(name: str) -> bool:
    # not adapter_disc: setPhase toggles only the critics list and the segnet
    return name.startswith("critics_")


def is_segnet_key(name: str) -> bool:
    return name.split(".")[0] == "trgb_segnet"


@dataclasses.dataclass
class AdversarialTrainState:
    """The model and one ``TrainState`` (optimizer + schedule) per phase."""

    model: nn.Module
    seg: TrainState
    critic: Optional[TrainState]
    step: int = 0


def make_phase_optimizers(model: nn.Module, lr_schedule: Callable
                          ) -> AdversarialTrainState:
    """Two RMSprops over the phases' parameters, each with its own
    ``lr_schedule`` counting its own steps (adversarial.py:148-166). A phase
    that trains nothing (the critic phase under no_conf) gets None."""
    named = list(model.named_parameters())

    def phase(trainable):
        if not any(trainable(n) for n, _ in named):
            return None
        return TrainState(model, *masked_optimizer(named, trainable, rmsprop,
                                                   lr_schedule))

    return AdversarialTrainState(model, phase(lambda n: not is_critic_key(n)),
                                 phase(lambda n: not is_segnet_key(n)))


# -- losses ----------------------------------------------------------------------

def critic_loss(out: Dict[str, Any], criterion: ConfCriterion,
                means: LocalMeans = LocalMeans()) -> torch.Tensor:
    """Σ_i conf(c_a_i → 1) + conf(c_b_i → 0) (:174-181), each criterion the
    mean of ``means``."""
    terms = means.means([criterion.elementwise(c, 1.0) for c in out["critics_a"]]
                        + [criterion.elementwise(c, 0.0) for c in out["critics_b"]])
    total = 0.0
    for term in terms:
        total = total + term
    return total


def confusion_loss(out: Dict[str, Any], criterion: ConfCriterion, cfg: AdversarialConfig,
                   conf_weighting: Optional[torch.Tensor] = None,
                   means: LocalMeans = LocalMeans()) -> torch.Tensor:
    """The fool-the-critics term of the seg phase (:184-201):
    ``criterion · mean(w)`` per critic, w ≡ 1 without IR-certainty weighting;
    both means those of ``means``."""
    w = cfg.critic_weights
    target_a = 0.0 if cfg.multidir else 1.0
    crit_a, crit_b = out["critics_a"], out["critics_b"]
    parts = ([criterion.elementwise(c, target_a) for c in crit_a]
             + [criterion.elementwise(c, 1.0) for c in crit_b])
    if conf_weighting is not None:
        parts.append(at_least_f32(conf_weighting))
    terms = means.means(parts)
    w_mean = terms.pop() if conf_weighting is not None else 1.0
    loss = 0.0
    for m, term in enumerate(terms[:len(crit_a)]):
        loss = loss + w_mean * term * w[m]
    for m, term in enumerate(terms[len(crit_a):]):
        loss = loss + w_mean * term * w[m]
    return loss


def cert_target(pred_logits: torch.Tensor, label: torch.Tensor,
                num_classes: int) -> torch.Tensor:
    """Certainty ground truth: 1 - the softmax probability of the true class."""
    probs = torch.softmax(at_least_f32(pred_logits), dim=-1)
    idx = label.long().clamp(0, num_classes - 1)[..., None]
    return 1.0 - torch.gather(probs, -1, idx)[..., 0]


# -- inputs and the seg phase's augmentation ---------------------------------------

def pack_inputs(batch: Dict[str, torch.Tensor], modalities: str,
                day: bool) -> List[torch.Tensor]:
    sfx = "day" if day else "night"
    ins = [batch[f"{m}_{sfx}"] for m in ("rgb", "ir") if m in modalities]
    if not ins:
        raise ValueError("No known modality selected")
    return ins


@dataclasses.dataclass
class SegAugDraws:
    """The random draws of one seg step's augmentation (``_augment_day``)."""

    moddrop: bool             # drop a rectangle of one modality (p = .5)
    drop_rgb: bool            # ... of RGB, else of IR (p = .5)
    irscale: bool             # scale the IR batch (p = .5)
    irscale_factor: float     # by U(0.1, 1)
    smart: bool               # per-class IR scaling (p = .5)
    smart_factors: torch.Tensor  # (num_classes + 1,) U(0.1, 1)
    dropout: Optional[tuple] = None  # a PSPNet's keep masks (ConfSegnet.draw_dropout)


def draw_seg_aug(generator: torch.Generator, num_classes: int = 13) -> SegAugDraws:
    """Draw every random choice of one seg step, in a fixed order."""
    moddrop = bool(torch.rand((), generator=generator) > 0.5)
    drop_rgb = bool(torch.rand((), generator=generator) > 0.5)
    return SegAugDraws(moddrop, drop_rgb, *draw_ir_scale(generator),
                       *draw_smart_augment(generator, num_classes + 1))


def augment_day(batch: Dict[str, torch.Tensor], draws: SegAugDraws,
                cfg: AdversarialConfig) -> Dict[str, torch.Tensor]:
    """The seg phase's input augmentations (:246-264): a rectangle dropped
    from one modality, IR scaling, per-class IR scaling."""
    rgb_day, ir_day = batch["rgb_day"], batch["ir_day"]
    if cfg.moddrop and draws.moddrop:
        # split by rows the rectangles stand in the frame's rows
        row0 = spatial.row_offset(rgb_day.shape[1])
        if draws.drop_rgb:
            rgb_day = rect_drop(rgb_day, batch["mod_drop_params"], row0)
        else:
            ir_day = rect_drop(ir_day, batch["mod_drop_params"], row0)
    if cfg.irscale:
        ir_day = ir_scale_aug(ir_day, draws.irscale, draws.irscale_factor)
    if cfg.smartirscale:
        ir_day = maybe_smart_augment(ir_day, batch["label_day"], draws.smart,
                                     draws.smart_factors)
    return dict(batch, rgb_day=rgb_day, ir_day=ir_day)


# -- the steps ---------------------------------------------------------------------

def make_adversarial_losses(model: nn.Module, cfg: AdversarialConfig,
                            teacher: Optional[nn.Module] = None, mesh=None):
    """``(seg_loss, critic_loss)``: each sets its phase, runs the train-mode
    forward and returns ``(loss, metrics)``, the loss not yet backpropagated.

    ``seg_loss(batch, draws)`` augments the day inputs with ``draws`` first;
    ``critic_loss(batch, dropout=None)``. ``teacher`` is the frozen
    night-supervision model, in eval mode (``prepare_for_inference``); its
    pseudo-labels supervise the night branch. With a ``mesh`` the batch is
    this process's rows, the forward takes train-mode BN statistics over the
    whole batch and the loss and metrics are the whole batch's (the module's
    docstring); under ``spatial_parallel`` the batch is this process's rows
    of every frame.
    """
    criterion = conf_criterion(cfg.adv_loss)

    def forward_teacher(batch):
        with torch.no_grad():
            out, _, t_cert = teacher(*pack_inputs(batch, cfg.night_sup_modalities,
                                                  day=False))
        return torch.softmax(at_least_f32(out), dim=-1), t_cert

    def forward(batch, phase: str, dropout):
        model.train()
        model.set_phase(phase)
        model.zero_grad(set_to_none=True)
        # by rows spatial_parallel has set the BN statistics' group
        by_rows = spatial.spatial_group() is not None
        with contextlib.nullcontext() if by_rows else data_parallel(mesh):
            return model(pack_inputs(batch, cfg.modalities, day=True),
                         pack_inputs(batch, cfg.modalities, day=False), dropout)

    def seg_loss_fn(batch, draws: SegAugDraws):
        means = means_for(mesh)
        batch = augment_day(batch, draws, cfg)
        out = forward(batch, "train_seg", draws.dropout)
        label_day = batch["label_day"].long()
        seg_loss = means.cross_entropy(out["pred_label_a"], label_day)
        metrics = {}
        conf_weighting = None

        if cfg.night_supervision and teacher is not None:
            night_probs, t_cert = forward_teacher(batch)
            pseudo = night_probs.argmax(-1)
            if not cfg.weight_ir_sup:
                night_loss = means.cross_entropy(out["pred_label_b"], pseudo)
            else:
                per_pix = cross_entropy_ignore(out["pred_label_b"], pseudo,
                                               ignore_index=-1, reduce=False)
                if cfg.cert_branch and t_cert is not None:
                    night_loss = means.mean((1.0 - t_cert[..., 0]) * per_pix)
                else:
                    # the reference's softmax of softmaxed probabilities
                    cert = torch.softmax(night_probs, dim=-1).amax(-1)
                    night_loss = means.mean(cert * per_pix)
                    conf_weighting = 1.0 - cert
            seg_loss = seg_loss + night_loss
            metrics["night_seg_loss"] = night_loss

        if cfg.cert_branch and not cfg.night_supervision:
            cert_gt = cert_target(out["pred_label_a"], label_day,
                                  out["pred_label_a"].shape[-1])
            cert_loss = means.mean((out["cert_a"][..., 0] - cert_gt) ** 2) * 10.0
            seg_loss = seg_loss + cert_loss
            metrics["cert_loss"] = cert_loss

        if "critics_a" in out:
            conf = confusion_loss(out, criterion, cfg, conf_weighting, means)
            total = seg_loss + cfg.conf_weight * conf
        else:
            conf = torch.zeros((), device=seg_loss.device)
            total = seg_loss
        metrics.update(conf_loss=conf, seg_loss=seg_loss, total_loss=total)
        return total, metrics

    def critic_loss_fn(batch, dropout=None):
        loss = critic_loss(forward(batch, "train_critic", dropout), criterion,
                           means_for(mesh))
        return loss, {"critic_loss": loss, "total_loss": loss}

    return seg_loss_fn, critic_loss_fn


def make_adversarial_steps(model: nn.Module, cfg: AdversarialConfig,
                           teacher: Optional[nn.Module] = None, mesh=None):
    """``(seg_step, critic_step)``: ``seg_step(state, batch, draws)`` and
    ``critic_step(state, batch, dropout=None)`` each run one step in place
    (forward, backward, the phase's optimizer and schedule) and return the
    step's detached metrics. With a ``mesh`` of n processes each backward
    runs on ``loss / n`` and the phase's trainable parameters' gradients are
    summed over the mesh's ``data`` dimension before the optimizer: the
    whole batch's step (the module's docstring). Each phase's first step
    checks that every process holds the same parameters' gradients."""
    seg_loss_fn, critic_loss_fn = make_adversarial_losses(model, cfg, teacher, mesh)
    processes = data_size(mesh)
    checked = set()

    def run(loss_fn, phase_state, state, *args):
        loss, metrics = loss_fn(*args)
        (loss / processes).backward()
        trainable = [p for p in model.parameters() if p.requires_grad]
        if loss_fn not in checked:
            check_same_gradients(mesh, trainable)
            checked.add(loss_fn)
        all_reduce_gradients(mesh, trainable)
        phase_state(state).apply_gradients()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def seg_step(state: AdversarialTrainState, batch, draws: SegAugDraws):
        return run(seg_loss_fn, lambda s: s.seg, state, batch, draws)

    def critic_step(state: AdversarialTrainState, batch, dropout=None):
        return run(critic_loss_fn, lambda s: s.critic, state, batch, dropout)

    return seg_step, critic_step


class PhaseMachine:
    """Host-side phase switcher (:376-401): ``iter_initial_critic_phase``
    critic iterations (unless no_conf), then critic and seg phases in turn."""

    def __init__(self, cfg: AdversarialConfig, no_conf: bool = False):
        self.cfg = cfg
        self.no_conf = no_conf
        self.state = "train_seg" if no_conf else "train_critic"
        self.counter = cfg.iter_initial_critic_phase

    def tick(self) -> str:
        """The phase of the current iteration; then the counter advances."""
        phase = self.state
        if not self.no_conf:
            self.counter -= 1
            if self.counter == 0:
                if self.state == "train_seg":
                    self.state = "train_critic"
                    self.counter = self.cfg.iter_critic_phase
                else:
                    self.state = "train_seg"
                    self.counter = self.cfg.iter_seg_phase
        return phase
