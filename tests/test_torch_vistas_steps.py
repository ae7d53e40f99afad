"""The Vistas pretraining step of the port against the JAX package's.

On the CPU at float32: ``cli.main``'s model (``build_model``: ResNeXt at
structure (1,1,1,1), full width, 3-channel input, 3x3 stem, leaky ReLU 0.01
from ``experiments/heatnet_conf.json``), its optimizer (``create_state``:
Adam with the poly decay per step, the global-norm clip when ``clip > 0``)
and ``train/supervised.py::make_train_step``, against JAX's
``make_train_step`` with the optax chain of ``heatnet_tpu/cli/main.py:
146-151``. The same weights (carried by ``io/from_jax.py``), the same
batches (``VistasDataset`` items, batch 4 of 64x128 crops, labels 0-13), 3
steps, once with clip 0, once with clip 0.1 and once with ``--bn-groups 2``
(the step-0 gradients' global norm is 0.21 here, so a clip at 1.0 would
leave them as they are; at 0.1 it rescales them):
losses at rtol 2e-3 / atol 2e-4 and the step-0 gradients (before the clip,
whose global norm they exceed) at rel L2 < 0.05 per tensor of norm >= 1e-4
over more than 50 tensors (the train-step contract of ``PERF.md`` §2).
JAX's gradients are read from its own step, through a pass-through optax
transformation at the head of its chain. The ``--arch pspnet`` step is held in
``test_torch_vistas.py`` with these helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heatnet_tpu.io.checkpoint import _flatten
from heatnet_tpu.io.torch_import import convert_state_dict
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.models import layers as jl
from heatnet_tpu.train.optim import maybe_flatten
from heatnet_tpu.train.optim import poly_lr as jax_poly_lr
from heatnet_tpu.train.state import TrainState as JaxTrainState
from heatnet_tpu.train.supervised import make_train_step as jax_make_train_step
from heatnet_tpu_torch.cli import main as vistas_cli
from heatnet_tpu_torch.data.loaders import VistasDataset, batch_iterator
from heatnet_tpu_torch.data.synthetic import make_vistas
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.train.supervised import make_train_step
from heatnet_tpu_torch.utils.config import load_config

from test_torch_late_fusion import numpy_init

torch.set_num_threads(2)

N, H, W, STEPS = 4, 64, 128, 3
TOTAL_STEPS = 4  # the poly decay's horizon: its rate moves every step


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    root = make_vistas(str(tmp_path_factory.mktemp("vistas")), n=N * STEPS, hw=(96, 160))
    out = list(batch_iterator(VistasDataset(root, W, H), N, seed=0))
    assert len(out) == STEPS and {int(v) for b in out for v in np.unique(b["label"])} \
        >= set(range(13))
    return out


def _capture():
    """An optax transformation that passes the updates on and keeps them."""
    return optax.GradientTransformation(lambda p: {"g": p},
                                        lambda u, s, p=None: (u, {"g": u}))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _run_jax(model_j, variables, tx_tail, batches, dropout_rng=None):
    tx = optax.chain(_capture(), *tx_tail)
    state = JaxTrainState.create(model_j.apply, variables["params"],
                                 variables.get("batch_stats"), tx)
    step = jax_make_train_step(model_j, dropout_rng=dropout_rng)
    losses, grads = [], None
    for b in batches:
        state, m = step(state, {"image": jnp.asarray(b["image"]),
                                "label": jnp.asarray(b["label"])})
        losses.append(float(m["loss"]))
        if grads is None:
            grads = jax.device_get(state.opt_state[0]["g"])
    return losses, grads


def _run_port(model_t, opt_conf, batches, dropouts=None):
    state = vistas_cli.create_state(model_t, opt_conf, TOTAL_STEPS)
    grads = []
    apply = state.apply_gradients

    def keep_and_apply():  # the raw gradients, before the clip hook
        grads.append({k: p.grad.clone() for k, p in model_t.named_parameters()
                      if p.grad is not None})
        apply()

    state.apply_gradients = keep_and_apply
    step = make_train_step(model_t)
    losses = []
    for i, b in enumerate(batches):
        state, m = step(state, {"image": torch.from_numpy(b["image"]),
                                "label": torch.from_numpy(b["label"]).long()},
                        None if dropouts is None else dropouts[i])
        losses.append(float(m["loss"]))
    return losses, grads[0]


@pytest.mark.parametrize("clip,bn_groups", [(0.0, 1), (0.1, 1), (0.0, 2)])
def test_vistas_steps_match_jax(batches, clip, bn_groups):
    conf = load_config(vistas_cli.DEFAULT_CONFIG)
    conf["optimizer"]["clip"] = clip
    lr = conf["optimizer"]["learning_rate"]
    net = conf["network"]
    model_j = JaxResNeXtSeg(
        structure=(1, 1, 1, 1), classes=net["classes"], dilation=tuple(net["dilation"]),
        input_channels=3, input_3x3=net["input_3x3"],
        norm_act=jl.NormAct(activation=net["activation"],
                            leaky_slope=net["leaky_relu_slope"], bn_groups=bn_groups),
        dtype=jnp.float32, remat=True)
    variables = numpy_init(model_j, jnp.zeros((1, H, W, 3)), seed=1)
    tail = ([optax.clip_by_global_norm(clip)] if clip > 0 else []) + \
        [maybe_flatten(optax.adam(jax_poly_lr(lr, max_iter=TOTAL_STEPS)))]
    losses_j, grads_j = _run_jax(model_j, variables, tail, batches)

    args = vistas_cli.build_parser().parse_args(
        ["--data", "-", "--valdata", "-", "--structure", "1", "1", "1", "1",
         "--bn-groups", str(bn_groups)])
    model_t = vistas_cli.build_model(args, conf)
    model_t.load_state_dict(state_dict_from_jax(variables["params"],
                                                variables["batch_stats"]), strict=True)
    losses_t, grads_t = _run_port(model_t.train(), conf["optimizer"], batches)

    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3, atol=2e-4)
    assert len(set(np.round(losses_j, 6))) == STEPS  # the steps moved the weights
    if clip:
        assert float(optax.global_norm(grads_j)) > clip  # the clip acts
    g_flat, _ = convert_state_dict(grads_t)
    compared = 0
    for k, v in _flatten(grads_j).items():
        if k.startswith("aspp/final_conv2"):  # the unused cert head
            continue
        assert k in g_flat, f"no port gradient for {k}"
        if np.linalg.norm(np.asarray(v, np.float64)) >= 1e-4:
            err = _rel_l2(g_flat[k], v)
            assert err < 0.05, f"gradient of {k}: rel L2 {err:.2e}"
            compared += 1
    assert compared > 50
