"""The port's schedules, optimizers and IoU ops against the JAX package.

Each schedule against its optax counterpart at every count of 12 steps;
each optimizer (SGD with and without Nesterov, Adam, RMSprop; with weight
decay and global-norm clipping) against ``heatnet_tpu.train.optim.
create_optimizer`` over 5 steps of the same numpy gradients (rtol 1e-5,
float32 arithmetic on both sides); the confusion matrix and IoU exactly.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heatnet_tpu.ops import iou as jiou
from heatnet_tpu.train import optim as jo
from heatnet_tpu_torch.ops import iou as tiou
from heatnet_tpu_torch.train import optim as to

SCHEDULES = [
    ("poly_lr", (0.01, 7, 0.9)),
    ("step_lr", (0.01, 2, 0.5, 3)),
    ("multistep_lr", (0.01, [1, 3], 0.3, 2)),
    ("exponential_lr", (0.01, 0.8, 2)),
    ("linear_lr", (0.01, -0.1, 1.0, 2)),
    ("lambda_linear_decay", (6, 1, 2, 0.01, 2)),
]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(name, args):
    ours, theirs = getattr(to, name)(*args), getattr(jo, name)(*args)
    for count in range(12):
        np.testing.assert_allclose(ours(count), float(theirs(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-9, err_msg=f"count {count}")


def test_make_schedule_constant_and_unknown():
    assert to.make_schedule({"learning_rate": 0.3})(5) == 0.3
    with pytest.raises(KeyError):
        to.make_schedule({"learning_rate": 0.3, "schedule": {"type": "cosine"}})


CONFIGS = [
    {"type": "SGD", "learning_rate": 0.05},
    {"type": "SGD", "learning_rate": 0.05, "nesterov": True, "momentum": 0.8,
     "weight_decay": 1e-2},
    {"type": "Adam", "learning_rate": 0.01,
     "schedule": {"type": "step", "params": {"step_size": 1, "gamma": 0.5},
                  "mode": "iteration"}},
    {"type": "Adam", "learning_rate": 0.01, "clip": 0.5, "weight_decay": 1e-3},
    {"type": "RMSprop", "learning_rate": 0.01, "clip": 1.0,
     "schedule": {"type": "exponential", "params": {"gamma": 0.7}}},
]


@pytest.mark.parametrize("config", CONFIGS,
                         ids=["sgd", "sgd_nesterov_wd", "adam_step", "adam_clip_wd",
                              "rmsprop_clip_exp"])
def test_optimizer_matches_optax_over_five_steps(config):
    rng = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 2).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]

    tx = jo.create_optimizer(config, steps_per_epoch=2)
    params_j = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params_j)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, params_j)
        params_j = optax.apply_updates(params_j, updates)

    params_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, sched = to.create_optimizer(config, params_t.values(), steps_per_epoch=2)
    for g in grads:
        for k, p in params_t.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        sched.step()
    for k in shapes:
        np.testing.assert_allclose(params_t[k].detach().numpy(),
                                   np.asarray(params_j[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError):
        to.create_optimizer({"type": "Lion", "learning_rate": 1.0},
                            [torch.nn.Parameter(torch.zeros(1))])


def test_confusion_matrix_and_iou_match_jax():
    rng = np.random.RandomState(1)
    pred = rng.randint(0, 15, (3, 11, 13))   # 14 = out of range
    target = rng.randint(-1, 15, (3, 11, 13))
    conf_t = tiou.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target), 14)
    conf_j = np.asarray(jiou.confusion_matrix(jnp.asarray(pred), jnp.asarray(target), 14))
    np.testing.assert_array_equal(conf_t.numpy(), conf_j)
    for ignore in ((), (12, 13)):
        np.testing.assert_array_equal(
            tiou.iou_from_confusion(conf_t, ignore).numpy(),
            np.asarray(jiou.iou_from_confusion(jnp.asarray(conf_j), ignore)))
