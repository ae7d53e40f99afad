"""One process of the 4-process gloo run of tests/test_torch_spatial_adversarial.py.

Run as ``python torch_spatial_adversarial_worker.py DIR`` under a
launcher-style environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT). It imports no JAX. Frames are split by rows over all 4
processes and, for the cases against JAX, again over the first 2:

- (d) ``primitives``: the gradient of each rank's seeded linear function of
  its output of each new by-rows primitive (``PRIMITIVES``), gathered;
- (b) ``F64_ADV``: the adversarial critic / seg / critic steps
  (``spatial.adversarial_frames``) of a float64 (1,1,1,1) ``ConfSegnet``
  with 2 ``resnet18`` critics on the batches of
  ``torch_dp_adversarial_cases`` (4 x 32 x 32), and (c) ``cg64``: 2 rounds
  of CycleGAN steps (``spatial.cyclegan_frames``) in float64; each against
  the port's own unsharded steps, which ranks 2 and 3 compute while the
  2-process meshes leave them idle and send to rank 0;
- (a) the float32 critic / seg / critic steps from JAX's weights and draws
  (``DIR/adv_init.pt``, written by the test) on ``adv_batch``, and (c) 3
  CycleGAN rounds from JAX's weights (``DIR/cg_init.pt``) on ``cg_batch``;
  rank 0 holds each step's updates and step-0 gradients against JAX's
  (``DIR/adv_jax.pt``, ``DIR/cg_jax.pt``, which appear while this runs).

After every step each rank all-gathers a digest of its parameters (and
buffers): the replicas must stay equal bit for bit. Rank 0 writes
``DIR/out.pt``.
"""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from heatnet_tpu_torch.models import ConfSegnet, ResNeXtSeg  # noqa: E402
from heatnet_tpu_torch.models import layers as L  # noqa: E402
from heatnet_tpu_torch.models.cyclegan import Discriminator, Generator  # noqa: E402
from heatnet_tpu_torch.models.layers import init_params  # noqa: E402
from heatnet_tpu_torch.parallel import mesh as pm  # noqa: E402
from heatnet_tpu_torch.parallel import spatial  # noqa: E402
from heatnet_tpu_torch.train import adversarial as ta  # noqa: E402
from heatnet_tpu_torch.train import cyclegan as tc  # noqa: E402
from heatnet_tpu_torch.train.optim import lambda_linear_decay, step_lr  # noqa: E402

import torch_dp_adversarial_cases as dp_cases  # noqa: E402

TINY = (1, 1, 1, 1)
SHARDS = (4, 2)
WAIT_S = 300

# (a): 2 frames of 256x256 (the least size whose 1/8 tap the cyclegan
# critics' five stride-2 convs take), 64 rows per shard over 4 processes:
# the critics gather their maps at 1/32 of the full-size tap, and at 1/4 of
# the 1/8 tap (one row a shard). Rectangles that straddle the shards.
ADV_HW, ADV_BATCH = 256, 2
ADV_FLAGS = dict(moddrop=True, irscale=True, smartirscale=True)
ADV_PHASES = ("train_critic", "train_seg", "train_critic")
ADV_DROP = np.array([[40, 20, 150, 100], [100, 60, 120, 150]])
JAX_LR = 1e-6
# (c) against JAX: one-block generators, 1 frame of 128x128, 3 rounds
CG_HW, CG_ROUNDS, CG_CLASSES = 128, 3, 12
# (b): name: (ConfSegnet's arguments, AdversarialConfig's, whether the IR
# teacher supervises the night branch); the phases and lr of
# torch_dp_adversarial_cases
F64_ADV = {
    "adapter+feedback_seg+cert": ({"feedback_seg": True, "cert_branch": True,
                                   "input_adapter": True},
                                  dict(cert_branch=True, moddrop=True, irscale=True,
                                       smartirscale=True), False),
    "teacher+weight_ir_sup": ({"cert_branch": True},
                              dict(cert_branch=True, night_supervision=True,
                                   weight_ir_sup=True, moddrop=True), True),
}
# (c) in float64: 2 rounds at 1x32x32 (8 rows a shard, 1 at stride 8), Adam at lr 1e-6
CG64_HW, CG64_ROUNDS = 32, 2
# float64 against the unsharded steps: each tensor within F64_TOL of its
# largest |value|, a gradient at least within F64_NOISE of the model's largest
F64_TOL, F64_NOISE = 1e-5, 1e-12
# the unsharded references and the rank that computes each while the
# 2-process meshes leave ranks 2 and 3 idle: (during (a), during (c))
REFERENCES = {2: (("adapter+feedback_seg+cert",), ("cg64",)),
              3: (("teacher+weight_ir_sup",), ())}
OWNER = {name: r for r, parts in REFERENCES.items() for part in parts for name in part}

# (d): name -> (input shape (N, C, H, W) of the whole frame, by rows the
# output is this rank's rows (True) or every process's whole map (False))
PRIMITIVES = {
    "instance_norm": ((2, 3, 16, 5), True),
    "resize_0.5x": ((1, 3, 16, 6), True),
    "resize_2x": ((1, 3, 16, 5), True),
    "resize_4x": ((1, 2, 16, 5), True),
    "resize_32x": ((1, 2, 8, 3), True),
    "uneven_gather_resize": ((1, 3, 4, 6), True),
    "uneven_gather_pool": ((2, 3, 8, 5), False),
    "reflect_1": ((1, 3, 16, 5), True),
    "reflect_3": ((1, 3, 16, 5), True),
    "transposed_op": ((1, 4, 16, 5), True),
}


def primitive_fn(name: str):
    """``(fn, frame_fn)``: the primitive as a layer calls it on a shard (or
    unsharded) and, for the reference, the same function of the whole
    frame written with PyTorch's own operations."""
    g = torch.Generator().manual_seed(5)
    w = torch.randn(4, 3, 4, 4, generator=g, dtype=torch.float64)
    up = L.ConvTranspose2d(4, 3, 3, stride=2, padding=1, output_padding=1).double()
    with torch.no_grad():
        up.weight.copy_(torch.randn(up.weight.shape, generator=g, dtype=torch.float64))
        up.bias.copy_(torch.randn(3, generator=g, dtype=torch.float64))
    interp = lambda x, hw: F.interpolate(x, size=hw, mode="bilinear",  # noqa: E731
                                         align_corners=False)
    if name == "instance_norm":
        return L.instance_norm, lambda x: F.instance_norm(x, eps=1e-5)
    if name.startswith("resize_"):
        f = float(name[len("resize_"):-1])
        return (lambda x: L.resize_bilinear(x, (int(x.shape[2] * f), 2 * x.shape[3])),
                lambda x: interp(x, (int(x.shape[2] * f), 2 * x.shape[3])))
    if name == "uneven_gather_resize":  # a patch critic's: 1 row a shard, stride 2
        def by_rows(x):
            rows = x.shape[2]
            with spatial.RowsThenWhole() as frame:
                y = F.conv2d(frame.ready(x, 4, 2, 1), w, stride=2, padding=1)
            if frame.is_whole:
                return L.resize_bilinear(y, (spatial.frame_rows(rows), x.shape[3]), frame=True)
            return L.resize_bilinear(y, (rows, x.shape[3]))
        return by_rows, lambda x: interp(F.conv2d(x, w, stride=2, padding=1), tuple(x.shape[2:]))
    if name == "uneven_gather_pool":  # a pool critic's: a 4x4 stride-1 conv takes H to H-1
        def pooled(x):
            with spatial.RowsThenWhole() as frame:
                y = F.conv2d(frame.ready(x, 4, 1, 1), w, padding=1)
                return L.global_avg_pool(y).flatten(1)
        return pooled, lambda x: F.conv2d(x, w, padding=1).mean(dim=(2, 3))
    if name.startswith("reflect_"):
        p = int(name[-1])
        return (lambda x: spatial.halo_rows(x, p, p, reflect=True),
                lambda x: F.pad(x, (0, 0, p, p), mode="reflect"))
    if name == "transposed_op":
        return up, up
    raise KeyError(name)


def reference_part(name: str, y: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Rank r's part of the whole frame's output ``y`` of primitive
    ``name``: its rows (with the reflect halo, p rows a side), or all of
    ``y`` where every process holds the whole output."""
    shape, split = PRIMITIVES[name]
    if not split:
        return y
    if name.startswith("reflect_"):
        p, rows = int(name[-1]), shape[2] // n
        return y[:, :, r * rows:r * rows + rows + 2 * p]
    rows = y.shape[2] // n
    return y[:, :, r * rows:(r + 1) * rows]


def weight_of(rank: int, shape) -> torch.Tensor:
    """Rank ``rank``'s seeded coefficients of the linear function whose
    gradient (d) reads."""
    return torch.from_numpy(np.random.RandomState(60 + rank).randn(*shape))


def primitive_input(name: str) -> np.ndarray:
    return np.random.RandomState(7).randn(*PRIMITIVES[name][0])


def primitives(mesh, rank: int) -> dict:
    """(d): each primitive's gradient of this rank's function of its output,
    and that output, gathered (rows) or this rank's (whole)."""
    group = pm.data_group(mesh)
    n = pm.data_size(mesh)
    out = {}
    for name, (shape, split) in PRIMITIVES.items():
        fn = primitive_fn(name)[0]
        rows = shape[2] // n
        x = torch.from_numpy(primitive_input(name))
        shard = x[:, :, rank * rows:(rank + 1) * rows].contiguous(
            memory_format=torch.channels_last).requires_grad_()
        with spatial.spatial_parallel(mesh):
            y = fn(shard)
        (y * weight_of(rank, y.shape)).sum().backward()
        out[f"prim/{name}/grad"] = pm.all_gather(group, shard.grad.contiguous())
        out[f"prim/{name}/out"] = pm.all_gather(group, y.detach().contiguous())
    return out


# -- inputs ---------------------------------------------------------------------

def adv_batch(seed: int) -> dict:
    """(a)'s whole batch, float32 NHWC frames in [0, 1) (the day RGB of the
    first frame scaled apart) and labels in [0, 13)."""
    rng = np.random.RandomState(seed)
    b = {k: rng.rand(ADV_BATCH, ADV_HW, ADV_HW, c).astype(np.float32)
         for k, c in (("rgb_day", 3), ("ir_day", 1), ("rgb_night", 3), ("ir_night", 1))}
    b["rgb_day"][:1] = b["rgb_day"][:1] * 2.0 - 0.5
    b["label_day"] = rng.randint(0, 13, (ADV_BATCH, ADV_HW, ADV_HW)).astype(np.int32)
    b["mod_drop_params"] = ADV_DROP.astype(np.int32)
    return b


def cg_batch(i: int, hw: int = CG_HW) -> dict:
    """Round i's frames: A and B in [-1, 1), day labels with about a tenth
    of the pixels ignored (-1)."""
    rng = np.random.RandomState(20 + i)
    label = rng.randint(0, CG_CLASSES, (1, hw, hw)).astype(np.int32)
    label[rng.rand(1, hw, hw) < 0.1] = -1
    return {"A": (rng.rand(1, hw, hw, 1) * 2 - 1).astype(np.float32),
            "B": (rng.rand(1, hw, hw, 1) * 2 - 1).astype(np.float32), "label": label}


def _torch(b: dict, dtype=torch.float32) -> dict:
    out = {}
    for k, v in b.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = t.long() if k.startswith("label") else (t if k == "mod_drop_params"
                                                         else t.to(dtype))
    return out


def cg_nets(dtype=torch.float32) -> dict:
    return {"netG_A2B": Generator(1, 1), "netG_B2A": Generator(1, 1),
            "netD_A": Discriminator(1), "netD_B": Discriminator(1),
            "netSeg": ResNeXtSeg(structure=TINY, input_channels=1, classes=CG_CLASSES)}


# -- bookkeeping ---------------------------------------------------------------------

def replicas_equal(mesh, tensors) -> bool:
    if mesh is None:
        return True
    both = pm.all_gather(pm.data_group(mesh), dp_cases.digest(tensors).reshape(1))
    return bool((both == both[0]).all())


def _fill_missing(got: dict, want: dict) -> None:
    """A parameter that reads no loss has no gradient unsharded and a zero
    one by rows (``spatial.ordered`` reaches it): zeros on either side."""
    for a, b in ((got, want), (want, got)):
        for k, v in a.items():
            b.setdefault(k, torch.zeros_like(v))


def f64_differences(got: dict, want: dict) -> dict:
    """Per step: the largest relative difference of the metrics from the
    unsharded run's, and the largest difference of every gradient, running
    statistic (and fake) over its bound, ``F64_TOL`` of the tensor's largest
    |value|, at least ``F64_NOISE`` of the model's largest gradient for a
    gradient (one that is rounding only: a bias before an instance norm or
    a train-mode BN)."""
    out = {"metrics": [], "tensors": [], "n_grads": 0}
    for g, w in zip(got["steps"], want["steps"]):
        out["metrics"].append(max((abs(g["metrics"][k] - v) / abs(v), k)
                                  for k, v in w["metrics"].items() if v != 0.0))
        worst = (0.0, "")
        for kind in ("grads", "stats", "fakes"):
            if kind not in w:
                continue
            floor = 0.0
            if kind == "grads":
                _fill_missing(g[kind], w[kind])
                out["n_grads"] += len(w[kind])
                floor = F64_NOISE * max(float(t.abs().max()) for t in w[kind].values())
            for k, t in w[kind].items():
                bound = max(F64_TOL * float(t.abs().max()), floor)
                d = float((g[kind][k] - t).abs().max())
                worst = max(worst, (d / bound if bound > 0 else d, f"{kind}/{k}"))
        out["tensors"].append(worst)
    return out


# -- (b): the adversarial steps in float64 --------------------------------------------

def adv64_steps(case: str, mesh=None) -> dict:
    """Case ``case`` of ``F64_ADV``: critic, seg and critic steps, by rows
    over ``mesh`` or unsharded. Per step: the metrics, the gradients (read
    by an optimizer pre-hook: after the sum over the processes), the running
    statistics, whether the frozen side kept its bits and the replicas are
    equal."""
    model_kw, cfg_kw, with_teacher = F64_ADV[case]
    model = ConfSegnet(disc_arch="resnet18", num_critics=2, structure=TINY, **model_kw)
    init_params(model, torch.Generator().manual_seed(3))
    model = dp_cases._float64(model)
    teacher = None
    if with_teacher:
        teacher = ResNeXtSeg(structure=TINY, input_channels=1)
        init_params(teacher, torch.Generator().manual_seed(4))
        teacher = dp_cases._float64(teacher).eval()
    cfg = ta.AdversarialConfig(**cfg_kw)
    state = ta.make_phase_optimizers(model, lambda _: dp_cases.LR)
    seg_step, critic_step = ta.make_adversarial_steps(model, cfg, teacher, mesh)
    grads = []
    for ts in (state.seg, state.critic):
        ts.optimizer.register_step_pre_hook(lambda *_: grads.append(
            {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}))
    generator = torch.Generator().manual_seed(42)
    out = {"steps": []}
    for i, phase in enumerate(dp_cases.PHASES):
        whole = {k: torch.from_numpy(v) for k, v in dp_cases.batch(10 + i).items()}
        if phase == "train_seg":
            draws = ta.draw_seg_aug(generator, cfg.num_classes)
            # every augmentation on: the rectangle in the frame's rows
            draws.moddrop = draws.irscale = draws.smart = True
            step, args = seg_step, (draws,)
        else:
            step, args = critic_step, ()
        frozen = [p for k, p in model.named_parameters()
                  if k.startswith("critics_" if phase == "train_seg" else "trgb_segnet.")]
        before = dp_cases.digest(frozen)
        if mesh is None:
            metrics = step(state, whole, *args)
        else:
            metrics = spatial.adversarial_frames(step, state, whole, mesh, *args)
        out["steps"].append({
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads[-1],
            "stats": {k: b.clone() for k, b in model.named_buffers() if "running" in k},
            "frozen_unchanged": bool(dp_cases.digest(frozen) == before),
            "replicas": replicas_equal(mesh, list(model.parameters())
                                       + list(model.buffers()))})
    return out


# -- (c): CycleGAN rounds --------------------------------------------------------------

def cg_rounds(nets: dict, batches, mesh, lr: float, dtype=torch.float32, record=None):
    """Rounds of g, d_a and d_b steps (``make_cyclegan_steps``, Adam under
    the linear decay of ``tests/test_torch_cyclegan.py``) on ``batches``
    (whole frames), by rows over ``mesh`` or unsharded. Per round: the
    metrics, the two discriminator losses, the fakes (gathered), netSeg's
    running statistics, each step's gradients, whether the discriminators
    kept their bits and took no gradient across the generator step, and
    whether the replicas are equal. ``record(i, state)`` runs after round
    i."""
    for m in nets.values():
        m.train()
    state = tc.CycleGANState.create(nets, lambda_linear_decay(3, 0, 1, lr, 1))
    g_step, d_a_step, d_b_step = tc.make_cyclegan_steps(
        *(nets[k] for k in tc.NET_NAMES), mesh=mesh)
    grads = {}
    for which in ("g", "d_a", "d_b"):
        ts = getattr(state, which)
        ts.optimizer.register_step_pre_hook(lambda *_, w=which, t=ts: grads.__setitem__(
            w, {k: p.grad.clone() for k, p in t.model.named_parameters()
                if p.grad is not None}))
    d_nets = [nets["netD_A"], nets["netD_B"]]
    d_kept = {}

    def checked_g_step(state, batch):
        before = dp_cases.digest(p for d in d_nets for p in d.parameters())
        out = g_step(state, batch)
        d_kept["unchanged"] = bool(dp_cases.digest(
            p for d in d_nets for p in d.parameters()) == before)
        d_kept["no_grad"] = all(p.grad is None for d in d_nets for p in d.parameters())
        return out

    steps = (checked_g_step, d_a_step, d_b_step)
    n = pm.data_size(mesh)
    shape = (CG_HW if dtype == torch.float32 else CG64_HW) // n
    generator = torch.Generator().manual_seed(1)
    buffers = None
    rounds = []
    for i, b in enumerate(batches):
        whole = _torch(b, dtype)
        if buffers is None:
            buffers = [tc.DeviceReplayBuffer(50, (shape,) + tuple(whole["A"].shape[2:]),
                                             torch.device("cpu"), dtype) for _ in range(2)]
        if mesh is None:
            fake_a, fake_b, metrics = steps[0](state, whole)
            loss_a = d_a_step(state, whole["A"], buffers[0].push_and_pop(fake_a, generator))
            loss_b = d_b_step(state, whole["B"], buffers[1].push_and_pop(fake_b, generator))
        else:
            fake_a, fake_b, metrics, loss_a, loss_b = spatial.cyclegan_frames(
                steps, state, whole, mesh, buffers, generator)
            group = pm.data_group(mesh)
            fake_a, fake_b = (torch.cat(list(pm.all_gather(group, f.contiguous())), 1)
                              for f in (fake_a, fake_b))
        rounds.append({
            "metrics": dict({k: float(v) for k, v in metrics.items()}, loss_D_A=float(loss_a),
                            loss_D_B=float(loss_b)),
            "fakes": {"A": fake_a.clone(), "B": fake_b.clone()},
            "stats": {k: v.clone() for k, v in nets["netSeg"].named_buffers()
                      if "running" in k},
            "grads": {f"{w}/{k}": v for w, g in grads.items() for k, v in g.items()},
            "d_unchanged": d_kept["unchanged"] and d_kept["no_grad"],
            "replicas": replicas_equal(mesh, [p for m in nets.values()
                                              for p in list(m.parameters())
                                              + list(m.buffers())])})
        if record is not None:
            record(i, state)
    return {"steps": rounds}


def cg64_rounds(mesh=None) -> dict:
    nets = cg_nets()
    for i, m in enumerate(nets.values()):
        init_params(m, torch.Generator().manual_seed(i))
        dp_cases._float64(m)
    return cg_rounds(nets, [cg_batch(i, CG64_HW) for i in range(CG64_ROUNDS)], mesh,
                     1e-6, torch.float64)


# -- (a) and (c) from JAX's weights ------------------------------------------------------

def wait_for(path: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {WAIT_S} s")
        time.sleep(0.2)


def update_counts(now: dict, jax_now: dict, start: dict, lr: float) -> tuple:
    """(elements whose change since ``start`` lies beyond 5 % of JAX's
    change plus 1e-3 lr, elements), over ``jax_now``'s tensors."""
    n_el = n_bad = 0
    for k, v in jax_now.items():
        d_j, d_t = v - start[k], now[k] - start[k]
        bad = (d_t - d_j).abs() > 0.05 * d_j.abs() + 1e-3 * lr
        n_el, n_bad = n_el + bad.numel(), n_bad + int(bad.sum())
    return n_bad, n_el


def adv_from_jax(work: str, mesh, rank: int) -> dict:
    """(a) over ``mesh``: the port's critic, seg and critic steps from JAX's
    weights, on its draws; per step the metrics, whether the frozen side
    kept its bits and the replicas are equal, and (the first rank) each
    trained tensor after the step."""
    init = torch.load(os.path.join(work, "adv_init.pt"), weights_only=False)
    model = ConfSegnet(disc_arch="cyclegan", num_critics=2, structure=TINY)
    model.load_state_dict(init["state_dict"], strict=True)
    model.train()
    cfg = ta.AdversarialConfig(**ADV_FLAGS)
    state = ta.make_phase_optimizers(model, step_lr(JAX_LR, 1, 0.5, 1))
    seg_step, critic_step = ta.make_adversarial_steps(model, cfg, None, mesh)
    draws = ta.SegAugDraws(**init["draws"])
    out = {"metrics": [], "frozen_unchanged": [], "replicas": [], "after": []}
    for i, phase in enumerate(ADV_PHASES):
        whole = _torch(adv_batch(10 + i))
        frozen = "critics_" if phase == "train_seg" else "trgb_segnet."
        before = dp_cases.digest(p for k, p in model.named_parameters() if k.startswith(frozen))
        step, args = (seg_step, (draws,)) if phase == "train_seg" else (critic_step, ())
        m = spatial.adversarial_frames(step, state, whole, mesh, *args)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["frozen_unchanged"].append(bool(before == dp_cases.digest(
            p for k, p in model.named_parameters() if k.startswith(frozen))))
        out["replicas"].append(replicas_equal(mesh, list(model.parameters())
                                              + list(model.buffers())))
        if rank == 0:
            out["after"].append({k: p.detach().clone() for k, p in model.named_parameters()
                                 if not k.startswith(frozen)})
    out.update(step=state.step, schedules=[state.seg.scheduler.last_epoch,
                                           state.critic.scheduler.last_epoch])
    return out


def cg_from_jax(work: str, mesh, rank: int) -> dict:
    """(c) over ``mesh``: 3 rounds from JAX's weights (``cg_rounds``); the
    first rank keeps each round's parameters and the generator step's first
    Adam moments after round 0."""
    init = torch.load(os.path.join(work, "cg_init.pt"), weights_only=False)
    nets = cg_nets()
    for k, m in nets.items():
        m.load_state_dict(init[k], strict=True)
    kept = {"after": [], "moments": None}

    def record(i, state):
        if rank != 0:
            return
        kept["after"].append({f"{w}/{k}": p.detach().clone()
                              for w in ("g", "d_a", "d_b")
                              for k, p in getattr(state, w).model.named_parameters()})
        if i == 0:
            ts = state.g
            kept["moments"] = {n: 2 * ts.optimizer.state[p]["exp_avg"]
                               for n, p in ts.model.named_parameters()
                               if p in ts.optimizer.state}

    out = cg_rounds(nets, [cg_batch(i) for i in range(CG_ROUNDS)], mesh, JAX_LR,
                    record=record)
    out.update(kept)
    return out


def against_jax(adv: dict, cg: dict, work: str) -> dict:
    """The first rank's (a) and (c) against JAX's steps: per step the
    elements whose update lies beyond 5 % of JAX's (``update_counts``), the
    step-0 generator gradients' relative L2 distances (of norm >= 1e-4),
    and the fakes and netSeg's running statistics as arrays."""
    wait_for(os.path.join(work, "adv_jax.pt"))
    jax_adv = torch.load(os.path.join(work, "adv_jax.pt"), weights_only=False)
    out = {"adv_updates": [update_counts(now, jax_now, jax_adv["start"], JAX_LR)
                           for now, jax_now in zip(adv["after"], jax_adv["after"])]}
    del jax_adv
    wait_for(os.path.join(work, "cg_jax.pt"))
    jax_cg = torch.load(os.path.join(work, "cg_jax.pt"), weights_only=False)
    out["cg_updates"] = [update_counts(now, jax_now, jax_cg["start"], JAX_LR)
                         for now, jax_now in zip(cg["after"], jax_cg["after"])]
    rel, names = [], []
    for k, v in jax_cg["moments"].items():
        if float(v.double().norm()) >= 1e-4:
            names.append(k)
            rel.append(float((cg["moments"][k].double() - v.double()).norm()
                             / v.double().norm()))
    out["cg_grad_names"], out["cg_grad_rel_l2"] = names, rel
    return out


def main(work: str) -> None:
    torch.set_num_threads(1)
    assert pm.maybe_initialize_distributed(torch.device("cpu"))
    rank = dist.get_rank()
    meshes = {n: pm.create_mesh(num_devices=n) for n in SHARDS}
    seconds = {}
    t0 = time.perf_counter()
    out = primitives(meshes[4], rank)
    seconds["primitives"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    by_rows = {name: adv64_steps(name, meshes[4]) for name in F64_ADV}
    by_rows["cg64"] = cg64_rounds(meshes[4])
    seconds["float64_by_rows"] = time.perf_counter() - t0

    refs, jax_runs = {}, {}
    for i, (part, run) in enumerate((("adv", adv_from_jax), ("cg", cg_from_jax))):
        if part == "adv":
            wait_for(os.path.join(work, "adv_init.pt"))
        else:
            wait_for(os.path.join(work, "cg_init.pt"))
        for n, mesh in meshes.items():
            t0 = time.perf_counter()
            if mesh.get_coordinate() is None:  # idle: the float64 references
                for name in REFERENCES[rank][i]:
                    refs[name] = (cg64_rounds() if name == "cg64" else adv64_steps(name))
                seconds[f"references_{part}"] = time.perf_counter() - t0
                continue
            jax_runs[f"{part}/{n}"] = run(work, mesh, rank)
            seconds[f"{part}/{n}"] = time.perf_counter() - t0

    # the references to the first rank, one float64 tensor per item
    for name in list(by_rows):
        if rank == OWNER[name]:
            obj = refs.pop(name)
            buf = torch.frombuffer(bytearray(_dumps(obj)), dtype=torch.uint8)
            dist.send(torch.tensor([buf.numel()]), dst=0)
            dist.send(buf, dst=0)
        if rank == 0:
            size = torch.zeros(1, dtype=torch.int64)
            dist.recv(size, src=OWNER[name])
            buf = torch.empty(int(size), dtype=torch.uint8)
            dist.recv(buf, src=OWNER[name])
            want = _loads(buf)
            got = by_rows[name]
            out[f"f64/{name}"] = dict(
                f64_differences(got, want),
                replicas=[s["replicas"] for s in got["steps"]],
                frozen=[s.get("frozen_unchanged", s.get("d_unchanged")) for s in got["steps"]],
                frozen_unsharded=[s.get("frozen_unchanged", s.get("d_unchanged"))
                                  for s in want["steps"]])
        by_rows.pop(name)

    if rank == 0:
        t0 = time.perf_counter()
        for n in SHARDS:
            adv, cg = jax_runs[f"adv/{n}"], jax_runs[f"cg/{n}"]
            out[f"jax/{n}"] = dict(
                against_jax(adv, cg, work),
                adv_metrics=adv["metrics"], adv_frozen=adv["frozen_unchanged"],
                adv_replicas=adv["replicas"], adv_step=adv["step"],
                adv_schedules=adv["schedules"],
                cg_metrics=[s["metrics"] for s in cg["steps"]],
                cg_fakes=[s["fakes"] for s in cg["steps"]],
                cg_stats=[s["stats"] for s in cg["steps"]],
                cg_d_unchanged=[s["d_unchanged"] for s in cg["steps"]],
                cg_replicas=[s["replicas"] for s in cg["steps"]])
        seconds["against_jax"] = time.perf_counter() - t0
        out["seconds"] = seconds
        torch.save(out, os.path.join(work, "out.tmp"))
        os.replace(os.path.join(work, "out.tmp"), os.path.join(work, "out.pt"))
    dist.destroy_process_group()


def _dumps(obj) -> bytes:
    import io
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(t: torch.Tensor):
    import io
    return torch.load(io.BytesIO(t.numpy().tobytes()), weights_only=False)


if __name__ == "__main__":
    main(sys.argv[1])
