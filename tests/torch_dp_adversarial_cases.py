"""The adversarial steps of tests/test_torch_dp_adversarial.py's float64
cases, which torch_dp_adversarial_worker.py runs over two gloo processes
and, for comparison, in one process on the whole batch. No JAX.

``steps(case, mesh)``: a ``ConfSegnet`` at structure (1,1,1,1), 32x32,
batch 4, 2 ``resnet18`` critics, in float64, through critic, seg and critic
steps (``make_adversarial_steps``, RMSprop at ``LR``). It returns each step's
metrics, the gradients of each phase's first step (read by an optimizer
pre-hook: after the sum over the processes), the running statistics after
each step, whether the frozen side kept its bits, and, over a mesh, whether
the two replicas' parameters are equal bit for bit after each step
(``digest``). ``compare`` gives each quantity's largest
difference from the one-process run.

Float64, because at random init f32 rounding alone moves this net's
gradients far beyond the data-parallel sums' own error
(tests/torch_mesh_cases.py). ``LR`` is 1e-7: RMSprop's first update divides
a gradient by its own size, so an element near 0 whose two summation orders
(the data-parallel BN's one-pass variance against one process's two-pass)
round apart moves its parameter by an amount that does not shrink with the
rounding, and a ``resnet18`` critic at this size normalises a few values per
channel, which amplifies such a move in the next critic step's loss (at lr
1e-6, 3.5e-06 of the loss; the gradients of the first two steps agree within
2e-7 at either rate).
"""

import numpy as np
import torch

from heatnet_tpu_torch.models import ConfSegnet, ResNeXtSeg
from heatnet_tpu_torch.models.layers import init_params
from heatnet_tpu_torch.parallel import mesh as pm
from heatnet_tpu_torch.train import adversarial as ta

BATCH, HW = 4, 32
PHASES = ("train_critic", "train_seg", "train_critic")
GRAD_STEPS = (0, 1)  # each phase's first step
LR = 1e-7

# (ConfSegnet's arguments, AdversarialConfig's, whether a teacher supervises
# the night branch)
CASES = {
    "plain": ({}, dict(moddrop=True, irscale=True, smartirscale=True), False),
    # the downscale nets (trained in both phases) and the certainty loss
    "feedback_seg+cert_branch": ({"feedback_seg": True, "cert_branch": True},
                                 dict(cert_branch=True), False),
    # the product of two means; the segnet's cert head reads no loss
    "weight_ir_sup": ({"cert_branch": True},
                      dict(cert_branch=True, night_supervision=True, weight_ir_sup=True), True),
    "bn_groups2": ({"bn_groups": 2}, {}, False),
    "pspnet": ({"arch": "pspnet"}, {}, False),
}


def _float64(model: torch.nn.Module) -> torch.nn.Module:
    model = model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


def batch(seed: int) -> dict:
    """The whole batch: unlike statistics on each half, ignored labels."""
    rng = np.random.RandomState(seed)
    b = {k: rng.rand(BATCH, HW, HW, c) for k, c in (("rgb_day", 3), ("ir_day", 1),
                                                    ("rgb_night", 3), ("ir_night", 1))}
    for k in b:
        b[k][:2] = b[k][:2] * 2.0 - 0.5
    label = rng.randint(0, 13, (BATCH, HW, HW))
    label[rng.rand(BATCH, HW, HW) < 0.1] = -1
    b["label_day"] = label
    b["mod_drop_params"] = np.array([[5, 5, 20, 20], [0, 0, 10, 10], [15, 4, 6, 20],
                                     [1, 20, 25, 5]])
    return b


_WEIGHTS = [torch.ones(0, dtype=torch.int64)]


def digest(tensors) -> torch.Tensor:
    """A position-weighted sum of the tensors' bits, mod 2^64: equal for
    equal bits, and a changed bit changes it."""
    total = torch.zeros((), dtype=torch.int64)
    for t in tensors:
        bits = t.detach().reshape(-1).view(torch.int64 if t.element_size() == 8
                                           else torch.int32).long()
        if _WEIGHTS[0].numel() < bits.numel():  # odd weights 1, 3, 5, ...
            _WEIGHTS[0] = torch.arange(1, 2 * bits.numel(), 2, dtype=torch.int64)
        total = total * 1000003 + (bits * _WEIGHTS[0][:bits.numel()]).sum()
    return total


def steps(case: str, mesh=None) -> dict:
    model_kw, cfg_kw, with_teacher = CASES[case]
    model = ConfSegnet(disc_arch="resnet18", num_critics=2, structure=(1, 1, 1, 1),
                       **model_kw)
    init_params(model, torch.Generator().manual_seed(3))
    model = _float64(model)
    teacher = None
    if with_teacher:
        teacher = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=1)
        init_params(teacher, torch.Generator().manual_seed(4))
        teacher = _float64(teacher).eval()
    if mesh is not None:
        pm.replicate(mesh, model)
    cfg = ta.AdversarialConfig(**cfg_kw)
    state = ta.make_phase_optimizers(model, lambda _: LR)
    seg_step, critic_step = ta.make_adversarial_steps(model, cfg, teacher, mesh)

    grads = []
    for ts in (state.seg, state.critic):
        ts.optimizer.register_step_pre_hook(lambda *_: grads.append(
            {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}))

    generator = torch.Generator().manual_seed(42)
    out = {"metrics": [], "grads": [], "stats": [], "frozen_unchanged": [], "replicas": []}
    for i, phase in enumerate(PHASES):
        whole = {k: torch.from_numpy(v) for k, v in batch(10 + i).items()}
        # every draw for the whole batch, on every process, in one order
        dropout = model.draw_dropout(BATCH, generator)
        draws = ta.draw_seg_aug(generator, cfg.num_classes) if phase == "train_seg" else None
        rows, dropout = pm.shard_batch(mesh, (whole, dropout))
        frozen = [p for k, p in model.named_parameters()
                  if k.startswith("critics_" if phase == "train_seg" else "trgb_segnet.")]
        before = [p.detach().clone() for p in frozen]
        if phase == "train_seg":
            draws.dropout = dropout
            metrics = seg_step(state, rows, draws)
        else:
            metrics = critic_step(state, rows, dropout)
        stats = {k: b.clone() for k, b in model.named_buffers() if "running" in k}
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["grads"].append(grads[-1] if i in GRAD_STEPS else {})
        out["stats"].append(stats)
        out["frozen_unchanged"].append(all(torch.equal(a, p) for a, p in zip(before, frozen)))
        if mesh is not None:  # the two replicas after the step
            both = pm.all_gather(pm.data_group(mesh), digest(model.parameters()))
            out["replicas"].append(bool(both[0] == both[1]))
    return out


def _rel(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """Largest |got - want| over the larger of want's largest |value| and
    ``floor`` (the difference itself where both are 0)."""
    diff = float((got - want).abs().max())
    scale = max(float(want.abs().max()), floor)
    return diff / scale if scale > 0 else diff


def compare(got: dict, want: dict) -> dict:
    """Each step's largest relative difference of the metrics, the gradients
    and the running statistics, each as (difference, the worst name), and how
    many gradient tensors were compared. A gradient's difference is taken
    over the larger of its largest |value| and 1e-6 of the model's largest,
    so that 1e-6 holds a gradient that is rounding only (a conv bias before a
    train-mode BN) at 1e-12 of the model's largest."""
    out = {"metrics": [], "grads": [], "stats": [], "n_grads": 0}
    for m_got, m_want, g_got, g_want, s_got, s_want in zip(
            got["metrics"], want["metrics"], got["grads"], want["grads"], got["stats"],
            want["stats"]):
        if set(m_got) != set(m_want) or set(g_got) != set(g_want):
            raise AssertionError(f"keys differ: {set(m_got) ^ set(m_want)}, "
                                 f"{set(g_got) ^ set(g_want)}")
        out["metrics"].append(max((abs(m_got[k] - m_want[k]) / abs(m_want[k]), k)
                                  for k in m_want if m_want[k] != 0.0))
        largest = max([float(g.abs().max()) for g in g_want.values()], default=0.0)
        # within 1e-6 of the tensor's largest or 1e-12 of the model's
        out["grads"].append(max([(_rel(g_got[k], g, 1e-6 * largest), k)
                                 for k, g in g_want.items()], default=(0.0, "")))
        out["n_grads"] += len(g_want)
        out["stats"].append(max((_rel(s_got[k], s), k) for k, s in s_want.items()))
    return out
