"""The MFNet harness's training CLI in the port against JAX's ``cli/train_baseline.py``.

On the CPU, float32, inputs and weights from numpy with fixed seeds:

- the SGD step (momentum 0.9, weight decay 5e-4 before the trace) on MFNet
  against the JAX step built as ``train_baseline.main`` builds it, over 3
  steps with the epoch's learning rate changed before the third: losses
  within rtol 2e-3 / atol 2e-4, each step's cumulative update within 5 %
  elementwise on >= 95 % of the elements (the step contract of
  tests/test_torch_adversarial.py), the BN running statistics within
  1e-3 / 1e-4;
- ``MFHarnessTrainDataset`` items (decode, RandomFlip + RandomCrop from
  ``default_train_augmentations(seed=0)``, resize back to 640x480, /255)
  equal to JAX's on a ``make_mfnet`` tree over two passes, in
  ``batch_iterator`` batches too, and every ``mf_augment`` transform's
  draws equal to JAX's;
- ``calculate_result`` on the JAX test's case (tests/test_cli_extra.py:76-87)
  and on random matrices with empty classes, bit-equal to JAX's;
- both CLIs resumed from the same weights (JAX's orbax checkpoint and its
  ``state_dict_from_jax`` conversion) train MFNet for one full epoch on a
  ``make_mfnet`` tree and evaluate day and night: the logged loss averages
  within rtol 2e-3 / atol 2e-4; the trained weights' class maps equal
  except where JAX's own top two logits lie within 1e-3, and the confusion
  matrices differ by no more than those pixels; ``--test`` evaluates
  ``combined`` (day + night) from the saved checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import heatnet_tpu.parallel.mesh as jax_mesh
from heatnet_tpu.cli import train_baseline as jax_tb
from heatnet_tpu.data import mf_augment as jax_aug
from heatnet_tpu.data import synthetic as jax_synthetic
from heatnet_tpu.data.loaders import MFHarnessTrainDataset as JaxMFHarnessTrainDataset
from heatnet_tpu.data.loaders import MFNetDataset as JaxMFNetDataset
from heatnet_tpu.data.loaders import batch_iterator as jax_batch_iterator
from heatnet_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from heatnet_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from heatnet_tpu.models import MFNet as JaxMFNet
from heatnet_tpu.train.state import TrainState
from heatnet_tpu.train.supervised import cross_entropy_ignore as jax_ce
from heatnet_tpu_torch.cli import train_baseline
from heatnet_tpu_torch.data import mf_augment
from heatnet_tpu_torch.data.loaders import MFHarnessTrainDataset, batch_iterator
from heatnet_tpu_torch.io.checkpoint import save_checkpoint
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import MFNet

from test_torch_late_fusion import assert_stats_close, numpy_init

torch.set_num_threads(2)

UPDATE_FLIPS = 0.05


def _jax_state(v, lr=0.01):
    """The JAX harness's train state and step (train_baseline.py:95-115)."""
    model = JaxMFNet(n_class=9)
    tx = optax.chain(optax.add_decayed_weights(5e-4),
                     optax.inject_hyperparams(optax.sgd)(learning_rate=lr, momentum=0.9))
    state = TrainState.create(model.apply, v["params"], v["batch_stats"], tx)

    @jax.jit
    def train_step(state, image, label):
        def loss_fn(p, bs):
            seg, new_vars = model.apply({"params": p, "batch_stats": bs}, image, train=True,
                                        mutable=["batch_stats"])
            return jax_ce(seg, label, ignore_index=-1), new_vars["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats)
        return state.apply_gradients(grads, new_bs), loss

    return state, train_step


def test_sgd_steps_match_jax():
    rng = np.random.RandomState(0)
    batches = [(rng.rand(2, 64, 96, 4).astype(np.float32),
                rng.randint(-1, 9, (2, 64, 96)).astype(np.int32)) for _ in range(3)]
    v = numpy_init(JaxMFNet(n_class=9), jnp.asarray(batches[0][0]), seed=2, train=True)
    state_j, step_j = _jax_state(v)
    model = MFNet(n_class=9)
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], target=model))
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9, weight_decay=5e-4)
    step_t = train_baseline.make_train_step(model, opt)

    start = {k: t.numpy() for k, t in state_dict_from_jax(v["params"]).items()}
    for i, ((image, label), epo) in enumerate(zip(batches, (1, 1, 2))):
        lr = 0.01 * 0.95 ** (epo - 1)
        state_j.opt_state[1].hyperparams["learning_rate"] = jnp.asarray(lr)
        for group in opt.param_groups:
            group["lr"] = lr
        state_j, loss_j = step_j(state_j, jnp.asarray(image), jnp.asarray(label))
        loss_t = step_t(torch.from_numpy(image), torch.from_numpy(label))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-3, atol=2e-4,
                                   err_msg=f"step {i}")
        now_j = {k: t.numpy() for k, t in state_dict_from_jax(state_j.params).items()}
        now_t = {k: p.detach().numpy() for k, p in model.named_parameters()}
        assert sorted(now_j) == sorted(now_t)
        n_el = n_bad = 0
        for k, w in now_j.items():
            d_j, d_t = w - start[k], now_t[k] - start[k]
            bad = np.abs(d_t - d_j) > 0.05 * np.abs(d_j) + 1e-3 * lr
            n_el, n_bad = n_el + bad.size, n_bad + int(bad.sum())
        assert n_bad <= UPDATE_FLIPS * n_el, f"step {i}: {n_bad} of {n_el} updates differ"
    assert_stats_close(model, state_j.batch_stats)
    # the momentum traces: the first is the gradient, as optax's trace starts at 0
    trace_j = state_dict_from_jax(state_j.opt_state[1].inner_state[0].trace)
    for k, p in model.named_parameters():
        buf = opt.state[p]["momentum_buffer"].numpy()
        scale = np.abs(trace_j[k].numpy()).max() + 1e-12
        assert np.abs(buf - trace_j[k].numpy()).max() <= 0.05 * scale, k


def test_mf_augment_draws_equal_jax():
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (48, 64, 4)).astype(np.uint8)
    label = rng.randint(0, 9, (48, 64)).astype(np.uint8)
    for name, kw in (("RandomFlip", {"prob": 0.5}), ("RandomCrop", {"crop_rate": 0.1}),
                     ("RandomCropOut", {"crop_rate": 0.2}),
                     ("RandomBrightness", {"bright_range": 0.15}),
                     ("RandomNoise", {"noise_range": 5})):
        a = getattr(jax_aug, name)(seed=4, **kw)
        b = getattr(mf_augment, name)(seed=4, **kw)
        for _ in range(6):
            (ia, la), (ib, lb) = a(image, label), b(image, label)
            assert ia.dtype == ib.dtype and la.dtype == lb.dtype
            np.testing.assert_array_equal(ib, ia, err_msg=name)
            np.testing.assert_array_equal(lb, la, err_msg=name)
    assert [type(t).__name__ for t in mf_augment.default_train_augmentations(seed=0)] == \
        [type(t).__name__ for t in jax_aug.default_train_augmentations(seed=0)]


def test_harness_items_equal_jax(tmp_path):
    root = jax_synthetic.make_mfnet(str(tmp_path), n_train=5, n_test=0, hw=(60, 90))
    want = JaxMFHarnessTrainDataset(root, transform=jax_aug.default_train_augmentations(0))
    got = MFHarnessTrainDataset(root, transform=mf_augment.default_train_augmentations(0))
    assert len(got) == len(want) == 5
    for _ in range(2):  # two passes: the transforms' draws go on
        for i in range(len(want)):
            a, b = want[i], got[i]
            assert sorted(a) == sorted(b) == ["image", "label"]
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"item {i} {k}")
    assert got[0]["image"].shape == (480, 640, 4)
    for seed in (1, 2):
        for a, b in zip(jax_batch_iterator(JaxMFHarnessTrainDataset(
                            root, transform=jax_aug.default_train_augmentations(0)), 2,
                            seed=seed),
                        batch_iterator(MFHarnessTrainDataset(
                            root, transform=mf_augment.default_train_augmentations(0)), 2,
                            seed=seed)):
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])


def test_calculate_result_equals_jax():
    cf = np.zeros((3, 3), np.int64)
    cf[1, 1], cf[1, 2], cf[2, 2], cf[0, 0] = 8, 2, 5, 100
    overall, acc, iou = train_baseline.calculate_result(cf)
    assert overall == pytest.approx(13 / 15)
    assert iou[1] == pytest.approx(8 / 10) and iou[2] == pytest.approx(5 / 7)
    rng = np.random.RandomState(2)
    for trial in range(4):
        cf = rng.randint(0, 50, (9, 9)).astype(np.int64)
        cf[:, trial] = 0  # a class never predicted
        cf[trial + 2, :] = 0  # a class never labelled
        for got, want in zip(train_baseline.calculate_result(cf),
                             jax_tb.calculate_result(cf)):
            np.testing.assert_array_equal(got, want)


def _maps_and_ties(variables, checkpoint, data_dir, split):
    """The class maps of ``split`` from JAX's trained variables and from the
    port's checkpoint, and where JAX's own top two logits lie within 1e-3."""
    model_j = JaxMFNet(n_class=9)
    apply = jax.jit(lambda v, x: model_j.apply(v, x, train=False))
    model_t = MFNet(n_class=9)
    model_t.load_state_dict(torch.load(checkpoint, weights_only=True)["state_dict"])
    model_t.eval()
    ds = JaxMFNetDataset(data_dir, split=split)
    out = []
    for i in range(len(ds)):
        item = ds[i]
        img = np.concatenate([item["rgb_org"], item["ir_org"]], axis=-1)
        seg = np.asarray(apply(variables, jnp.asarray(img)))
        with torch.no_grad():
            ours = model_t(torch.from_numpy(img)).argmax(-1).numpy()
        top2 = np.sort(seg, axis=-1)[..., -2:]
        out.append((seg.argmax(-1), ours, top2[..., 1] - top2[..., 0] < 1e-3))
    return [np.concatenate(a) for a in zip(*out)]


def _logged(log_dir, key):
    rows = []
    for name in sorted(os.listdir(log_dir)):
        if name.endswith(".jsonl"):
            rows += [json.loads(line) for line in open(os.path.join(log_dir, name))]
    return [r[key] for r in rows if key in r]


def test_cli_epoch_and_evaluation_match_jax(tmp_path, monkeypatch, capsys):
    root = jax_synthetic.make_mfnet(str(tmp_path / "mf"), n_train=4, n_test=1, seed=6)
    v = numpy_init(JaxMFNet(n_class=9), jnp.zeros((1, 64, 96, 4)), seed=3, train=True)
    jax_save_checkpoint({"epoch": 0, "state_dict": v}, str(tmp_path / "jax_init"))
    model = MFNet(n_class=9)
    save_checkpoint({"epoch": 0, "state_dict": state_dict_from_jax(
        v["params"], v["batch_stats"], target=model)}, str(tmp_path / "port_init"))

    seen_j = []
    real = jax_tb.calculate_result
    monkeypatch.setattr(jax_tb, "calculate_result", lambda cf: seen_j.append(cf) or real(cf))
    monkeypatch.setattr(jax_mesh, "create_mesh", lambda *a, **kw: None)
    argv = ["--model_name", "MFNet", "--data_dir", root, "--batch_size", "2",
            "--epoch_max", "1"]
    loss_j = jax_tb.main(argv + ["--resume", str(tmp_path / "jax_init"),
                                 "--checkpointname", str(tmp_path / "jax_ck"),
                                 "--log_dir", str(tmp_path / "jax_runs")])
    jax_out = capsys.readouterr().out
    run = train_baseline.main(argv + ["--resume", str(tmp_path / "port_init"),
                                      "--checkpointname", str(tmp_path / "port_ck"),
                                      "--log_dir", str(tmp_path / "runs"), "--device", "cpu"])
    out = capsys.readouterr().out

    assert len(run.losses) == 2 and run.checkpoint == str(tmp_path / "port_ck")
    np.testing.assert_allclose(_logged(str(tmp_path / "runs"), "loss"),
                               _logged(str(tmp_path / "jax_runs"), "loss"),
                               rtol=2e-3, atol=2e-4)
    assert run.loss_avg == pytest.approx(loss_j, rel=2e-3, abs=2e-4)
    assert out.splitlines()[0].startswith("epo 1/1 lr 0.01000 loss ")
    # the logged config is the parsed flags, as JAX's update_config writes it
    configs = [json.loads(line) for name in os.listdir(tmp_path / "runs")
               for line in open(tmp_path / "runs" / name) if '"_type": "config"' in line]
    assert configs[0]["model_name"] == "MFNet" and configs[0]["device"] == "cpu"

    trained = jax_load_checkpoint(str(tmp_path / "jax_ck"))["state_dict"]
    for cf_j, split in zip(seen_j, ("day", "night")):
        cf_t = run.confusion[split]
        assert cf_t.shape == (9, 9) and cf_t.dtype == np.int64
        assert cf_t.sum() == cf_j.sum() == 480 * 640
        map_j, map_t, tied = _maps_and_ties(trained, run.checkpoint, root, split)
        # the trained weights give the same maps but at JAX's near-ties (about
        # 1.3 % of these pixels: the logits leave a leaky ReLU), and the
        # matrices differ by at most those pixels
        assert not np.any((map_j != map_t) & ~tied), split
        assert np.abs(cf_t - np.asarray(cf_j)).sum() <= 2 * int(tied.sum()), split
        assert f"[{split}] overall_acc " in jax_out and f"[{split}] overall_acc " in out

    # --test evaluates combined = test_day + test_night from the checkpoint
    test = train_baseline.main(["--data_dir", root, "--test", "--resume", run.checkpoint,
                                "--log_dir", str(tmp_path / "runs"), "--device", "cpu"])
    np.testing.assert_array_equal(test.confusion["combined"],
                                  run.confusion["day"] + run.confusion["night"])
    assert test.eval_frames == {"combined": 2} and not test.losses
