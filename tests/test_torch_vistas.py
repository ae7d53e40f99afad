"""Vistas pretraining in the port (heatnet_tpu_torch) against the JAX package.

On the CPU, inputs from numpy with fixed seeds:

- the numpy copies of cv2's calls in the Vistas chain against cv2 itself
  (the version this suite runs with): ``warp_affine`` linear and nearest at
  several sizes and angles, ``rgb_to_hsv`` over a seeded sample of 10^5
  colours and ``hsv_to_rgb`` over a seeded sample of 10^5 HSV values (H <
  180, the 8-bit range) in rows of several widths, ``resize_and_pad``,
  ``copy_make_border`` and ``get_rotation_matrix_2d``: equal on every pixel
  (the matrix to 1e-12);
- ``VistasDataset`` items against the JAX loader's for the same seed, the
  train and the eval chain, 12 items each over frames that need and need
  not the padding: equal (labels exactly, images to 0 in float32), and
  the same batches when decoded on 4 threads; with ``contrast_enhancement``
  (CLAHE) 4 items of each chain, equal;
- train-mode BN statistics per batch group (``layers.BatchNorm(groups)``)
  against ``StatNamedBatchNorm._grouped_train_call`` at f32, g = 2 and 3:
  outputs rtol 1e-5 / atol 1e-6, the gradients of x, scale and bias rel L2
  < 1e-4, the running statistics group 0's (rtol 1e-5, atol 1e-7: f32
  rounding of means near 0); a batch g does not divide raises in both;
- ``cli.main``'s ``validate``: the mIoU and the IoU vector of the same
  weights on the same tree equal JAX's within 1e-9, the tail padded with
  label 13 (the maps are first held equal except at JAX's near-ties, and
  no pixel of the tree flips at this seed; at seed 4 one does);
- the CLI end to end: one epoch of 2 steps writes a checkpoint, ``--resume
  --evaluate`` gives its mIoU again, and ``cli.train_conf --pretraining``
  loads it into ``trgb_segnet`` (tests/test_conf_flags.py:172 in JAX).

- the ``--arch pspnet`` step with dropout: PSPNet (on the ``resnet18``
  extractor, to keep JAX's compile short; the step does not depend on the
  backend) fed, each step, the keep masks JAX's step draws from
  ``fold_in(dropout_rng, step)`` (``jax_dropout_masks``): losses over 3
  Adam steps with the poly decay at rtol 2e-3 / atol 2e-4.

The ResNeXt Vistas steps are in ``test_torch_vistas_steps.py``.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heatnet_tpu.data.loaders import VistasDataset as JaxVistasDataset
from heatnet_tpu.data.loaders import batch_iterator as jax_batch_iterator
from heatnet_tpu.data.loaders import resize_and_pad as jax_resize_and_pad
from heatnet_tpu.eval.iou_eval import IoU as JaxIoU
from heatnet_tpu.models import ResNeXtSeg as JaxResNeXtSeg
from heatnet_tpu.models import layers as jl
from heatnet_tpu.models.registry import build_network as jax_build_network
from heatnet_tpu.ops.iou import confusion_matrix as jax_confusion_matrix
from heatnet_tpu.train.optim import poly_lr as jax_poly_lr
from heatnet_tpu_torch.cli import main as vistas_cli
from heatnet_tpu_torch.cli import train_conf
from heatnet_tpu_torch.data import loaders as tl
from heatnet_tpu_torch.data.packed import write_train_pack
from heatnet_tpu_torch.data.png import write_png
from heatnet_tpu_torch.eval.iou_eval import IoU
from heatnet_tpu_torch.io.checkpoint import save_checkpoint
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import ConfSegnet, NormAct, ResNeXtSeg, build_network
from heatnet_tpu_torch.models import layers as tlayers
from heatnet_tpu_torch.utils.config import load_config

from test_torch_late_fusion import jax_dropout_masks, numpy_init
from test_torch_layers import carry, nchw, nhwc
from test_torch_vistas_steps import STEPS, TOTAL_STEPS, _run_jax, _run_port, batches  # noqa: F401

torch.set_num_threads(2)


# -- cv2's calls ---------------------------------------------------------------

@pytest.mark.parametrize("hw,angles", [((384, 768), (-19.7, -3.2, 0.4, 12.5)),
                                       ((53, 71), (-17.3, 5.0, 19.99)),
                                       ((100, 131), (-8.8, 0.0, 15.1))])
def test_warp_affine_equals_cv2(hw, angles):
    rng = np.random.RandomState(hw[1])
    h, w = hw
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    lab = rng.randint(0, 14, (h, w)).astype(np.uint8)
    for angle in angles:
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        np.testing.assert_allclose(tl.get_rotation_matrix_2d((w / 2, h / 2), angle, 1.0),
                                   m, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(
            tl.warp_affine(img, m, (w, h)),
            cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR), err_msg=str(angle))
        np.testing.assert_array_equal(
            tl.warp_affine(lab, m, (w, h), nearest=True),
            cv2.warpAffine(lab, m, (w, h), flags=cv2.INTER_NEAREST), err_msg=str(angle))


def test_rgb_to_hsv_equals_cv2():
    rgb = np.random.RandomState(0).randint(0, 256, (250, 400, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tl.rgb_to_hsv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [400, 768, 100, 13])
def test_hsv_to_rgb_equals_cv2(width):
    """cv2's vector loop truncates and its row tail rounds: widths that are
    and are not multiples of 32."""
    hsv = np.random.RandomState(width).randint(0, 256, (100000 // width, width, 3))
    hsv[..., 0] %= 180
    hsv = hsv.astype(np.uint8)
    np.testing.assert_array_equal(tl.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_resize_and_pad_and_border_equal_cv2():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (60, 400, 3)).astype(np.uint8)
    ids = rng.randint(0, 14, (60, 400)).astype(np.uint8)
    for size, color, nearest, x in (((192, 300), 0, False, img), ((192, 300), 12, True, ids),
                                    ((97, 400), 5, False, img), ((80, 512), 11, True, ids)):
        np.testing.assert_array_equal(tl.resize_and_pad(x, size, color, nearest),
                                      jax_resize_and_pad(x, size, color, nearest))
    np.testing.assert_array_equal(
        tl.copy_make_border(img, 3, 4, 0, 2, [1, 2, 3]),
        cv2.copyMakeBorder(img, 3, 4, 0, 2, cv2.BORDER_CONSTANT, value=[1, 2, 3]))
    np.testing.assert_array_equal(tl.swap_rb(img), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


# -- the loader ----------------------------------------------------------------

def _vistas_tree(root, sizes, seed=0):
    """Vistas-layout frames of the given sizes, classes 0-13 (value // 256)."""
    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate(sizes):
        name = f"v{i:05d}.png"
        for d in ("images", "labels"):
            os.makedirs(os.path.join(root, d), exist_ok=True)
        write_png(os.path.join(root, "images", name),
                  rng.randint(0, 256, (h, w, 3)).astype(np.uint8), level=1)
        cls = rng.randint(0, 14, (h, w)).astype(np.uint16)
        write_png(os.path.join(root, "labels", name), cls * 256 + rng.randint(0, 256, (h, w))
                  .astype(np.uint16), level=1)
    return root


# frames shorter than the 192-row crop take the padding in both chains (after
# the scale jitter only the widest do); (200, 300) needs none in the eval chain
SIZES = [(96, 128), (60, 400), (120, 160), (48, 320), (200, 300), (96, 128), (64, 96),
         (40, 400), (150, 200), (72, 96), (60, 380), (128, 96)]


@pytest.mark.parametrize("augment", [True, False])
def test_vistas_items_equal_jax(tmp_path, augment):
    root = _vistas_tree(str(tmp_path), SIZES)
    for seed in (0, 3):
        want = JaxVistasDataset(root, 256, 192, augment_data=augment, seed=seed)
        got = tl.VistasDataset(root, 256, 192, augment_data=augment, seed=seed)
        for i in range(len(SIZES)):
            a, b = want[i], got[i]
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"item {i} {k}")
    if augment:  # the draws cover every branch
        draws = [ds.draw(i) for seed in (0, 3)
                 for ds in [tl.VistasDataset(root, 256, 192, seed=seed)]
                 for i in range(len(SIZES))]
        assert {d["flip"] for d in draws} == {False, True}
        assert any("jitter" in d for d in draws) and any("jitter" not in d for d in draws)
        assert any("angle" in d for d in draws) and any("angle" not in d for d in draws)


def test_threaded_decode_keeps_the_draws_in_order(tmp_path):
    root = _vistas_tree(str(tmp_path), SIZES)
    want = list(jax_batch_iterator(JaxVistasDataset(root, 256, 192, seed=1), 4, seed=2))
    got = list(tl.batch_iterator(tl.VistasDataset(root, 256, 192, seed=1), 4, seed=2,
                                 workers=4))
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("augment", [True, False])
def test_contrast_enhanced_items_equal_jax(tmp_path, augment):
    """CLAHE on the padded frame (``data/clahe.py``), then the chain: items
    equal the JAX loader's, whose CLAHE is cv2's."""
    root = _vistas_tree(str(tmp_path), SIZES[:4])
    kw = dict(augment_data=augment, contrast_enhancement=True, seed=2)
    want = JaxVistasDataset(root, 256, 192, **kw)
    got = tl.VistasDataset(root, 256, 192, **kw)
    for i in range(4):
        a, b = want[i], got[i]
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"item {i} {k}")


# -- BN statistics per batch group ----------------------------------------------

@pytest.mark.parametrize("groups", [2, 3])
def test_grouped_train_bn_matches_jax(groups):
    n = 2 * groups
    x = (np.random.RandomState(groups).randn(n, 5, 6, 24) * 1.5 + 0.4).astype(np.float32)
    x[:2] *= 3.0  # unlike statistics per group
    cot = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    na_j = jl.NormAct(activation="leaky_relu", leaky_slope=0.01, bn_groups=groups)
    abn_j = jl.ABN(na_j, jnp.float32)
    abn_t = tlayers.ABN(24, tlayers.NormAct(activation="leaky_relu", bn_groups=groups))
    v = carry(abn_j, abn_t, x)

    def f(params, xx):
        y, new = abn_j.apply({"params": params, "batch_stats": v["batch_stats"]}, xx, True,
                             mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, new["batch_stats"])

    (_, (y_j, stats_j)), (g_params, g_x) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    xt = nchw(x).requires_grad_()
    y_t = abn_t.train()(xt)
    y_t.backward(nchw(cot))
    np.testing.assert_allclose(nhwc(y_t.detach()), np.asarray(y_j), rtol=1e-5, atol=1e-6)

    def rel(a, b):
        return np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b)

    assert rel(nhwc(xt.grad), np.asarray(g_x)) < 1e-4
    assert rel(abn_t.bn.weight.grad.numpy(), np.asarray(g_params["bn"]["scale"])) < 1e-4
    assert rel(abn_t.bn.bias.grad.numpy(), np.asarray(g_params["bn"]["bias"])) < 1e-4
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(abn_t.bn, name).numpy(),
                                   np.asarray(stats_j["bn"][key]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    # group 0's statistics alone moved the running ones
    m = abn_j.norm_act.bn_momentum
    g0 = x[:n // groups].reshape(-1, 24).astype(np.float64)
    np.testing.assert_allclose(
        abn_t.bn.running_mean.numpy(),
        m * np.asarray(v["batch_stats"]["bn"]["mean"]) + (1 - m) * g0.mean(0), rtol=1e-5,
        atol=1e-7)

    bad = x[:groups + 1]
    with pytest.raises(ValueError, match="not divisible"):
        abn_j.apply(v, jnp.asarray(bad), True, mutable=["batch_stats"])
    with pytest.raises(ValueError, match="not divisible"):
        abn_t(nchw(bad))
    abn_t.eval()(nchw(bad))  # eval mode takes any batch


# -- validate and the CLI ------------------------------------------------------

H, W = 64, 128
ARGS = ["--width", str(W), "--height", str(H), "--structure", "1", "1", "1", "1",
        "--device", "cpu", "-j", "2"]


def _jax_vistas_net():
    na = jl.NormAct(activation="leaky_relu", leaky_slope=0.01)
    m_j = JaxResNeXtSeg(structure=(1, 1, 1, 1), input_channels=3, norm_act=na,
                        dtype=jnp.float32)
    return m_j, numpy_init(m_j, jnp.zeros((1, H, W, 3)), seed=0)


def test_validate_matches_jax_ious(tmp_path):
    val = _vistas_tree(str(tmp_path / "val"), [(96, 160)] * 5 + [(60, 200)] * 2, seed=5)
    m_j, v = _jax_vistas_net()
    ckpt = save_checkpoint({"epoch": 1, "state_dict": state_dict_from_jax(
        v["params"], v["batch_stats"])}, str(tmp_path / "ck.pth"))

    # JAX: the eval step (heatnet_tpu/train/supervised.py:118-128: the eval
    # forward, argmax, confusion matrix) over the batch padded to 16
    ds_j = JaxVistasDataset(val, W, H, augment_data=False)
    batch = next(jax_batch_iterator(ds_j, 16, shuffle=False, drop_last=False))
    n = batch["image"].shape[0]
    image = np.concatenate([batch["image"], np.zeros((16 - n, H, W, 3), np.float32)])
    label = np.concatenate([batch["label"], np.full((16 - n, H, W), 13, np.int32)])
    seg_j = np.asarray(jax.jit(lambda x: m_j.apply(v, x, train=False)[0])(jnp.asarray(image)))
    metric = JaxIoU(14, False, [12, 13])
    metric.add_confusion(np.asarray(jax_confusion_matrix(
        jnp.argmax(jnp.asarray(seg_j), -1), jnp.asarray(label), 14)))
    iou_j, miou_j = metric.value()

    # the maps: equal except at JAX's near-ties, and no pixel of the tree
    # flips at this seed (the padding's label 13 counts nowhere)
    model_t = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=3,
                         norm_act=NormAct(activation="leaky_relu"))
    model_t.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    with torch.no_grad():
        seg_t = model_t.eval()(torch.from_numpy(image))[0].numpy()
    top2 = np.sort(seg_j, -1)[..., -2:]
    differ = seg_t.argmax(-1) != seg_j.argmax(-1)
    assert not np.any(differ & (top2[..., 1] - top2[..., 0] >= 1e-3))
    assert not differ[:n].any()

    log_dir = str(tmp_path / "runs")
    miou = vistas_cli.main(["--data", val, "--valdata", val, "--resume", ckpt, "--evaluate",
                            "--log-dir", log_dir, *ARGS])
    logged = [json.loads(line) for f in os.listdir(log_dir)
              for line in open(os.path.join(log_dir, f))]
    iou_t = np.array([logged[-1][f"val_IoU_{i}"] for i in range(14)])
    assert miou == pytest.approx(miou_j, abs=1e-9)
    np.testing.assert_allclose(iou_t, iou_j, rtol=0, atol=1e-9)
    assert np.isnan(iou_t[12]) and np.isnan(iou_t[13])  # the ignored classes


def test_iou_metric_matches_jax():
    rng = np.random.RandomState(2)
    pred, target = rng.randint(0, 14, (3, 20, 30)), rng.randint(0, 14, (3, 20, 30))
    want, got = JaxIoU(14, False, [12, 13]), IoU(14, False, [12, 13])
    want.add(pred, target)
    got.add(pred, target)
    np.testing.assert_array_equal(got.value()[0], want.value()[0])
    assert got.value()[1] == want.value()[1]


def test_cli_trains_resumes_and_hands_off_to_train_conf(tmp_path):
    data = _vistas_tree(str(tmp_path / "train"), [(96, 160)] * 4, seed=6)
    val = _vistas_tree(str(tmp_path / "val"), [(96, 160)] * 3, seed=7)
    ck = str(tmp_path / "ck")
    common = ["--data", data, "--valdata", val, "--checkpoint-dir", ck,
              "--log-dir", str(tmp_path / "runs"), *ARGS]
    run = vistas_cli.main(["--batch-size", "2", "--epochs", "1", *common])
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    assert run.checkpoint == os.path.join(ck, "checkpoint.pth")
    saved = torch.load(run.checkpoint, map_location="cpu", weights_only=True)
    assert saved["epoch"] == 1 and saved["arch"] == "resnext50"
    assert saved["best_iou"] == run.best_iou == max(run.mious)
    miou = vistas_cli.main(["--resume", "auto", "--evaluate", *common])
    assert miou == pytest.approx(run.mious[-1], abs=1e-12)

    # the adversarial trainer's --pretraining loads the backbone into
    # trgb_segnet (the 3-channel stem does not fit its 4-channel input); two
    # critic steps leave the segnet's parameters as loaded
    rng = np.random.RandomState(8)
    pack = str(tmp_path / "pack")
    write_train_pack(pack, rng.randint(0, 256, (2, 320, 960, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (2, 320, 960)).astype(np.uint16),
                     rng.randint(0, 13, (2, 320, 960)).astype(np.uint8),
                     rng.randint(0, 256, (1, 320, 960, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (1, 320, 960)).astype(np.uint16))
    conf_run = train_conf.main([
        "--dataroot", pack, "--pretraining", "--pretraining_path", run.checkpoint,
        "--structure", "1", "1", "1", "1", "--discarch", "resnet18", "--num_critics", "1",
        "--batch_size", "2", "--n_epochs", "1", "--crop_height", "64", "--crop_width", "64",
        "--iter_initial_critic_phase", "2", "--device", "cpu",
        "--checkpointname", str(tmp_path / "conf"), "--log_dir", str(tmp_path / "runs")])
    assert conf_run.phases == ["train_critic", "train_critic"]
    got = torch.load(conf_run.checkpoint, map_location="cpu", weights_only=True)["state_dict"]
    params = {k for k, _ in ConfSegnet(structure=(1, 1, 1, 1)).trgb_segnet.named_parameters()}
    shared = [k for k, v in saved["state_dict"].items()
              if k in params and got["trgb_segnet." + k].shape == v.shape]
    assert len(shared) > 50 and "mod1.conv1.weight" not in shared
    for k in shared:
        assert torch.equal(got["trgb_segnet." + k], saved["state_dict"][k]), k


# -- the --arch pspnet step ---------------------------------------------------

def test_pspnet_steps_with_jax_dropout_masks_match_jax(batches):
    model_j = jax_build_network("resnet18", n_classes=13, in_channels=3, dtype=jnp.float32)
    variables = numpy_init(model_j, jnp.zeros((1, H, W, 3)), seed=2)
    dropout_rng = jax.random.PRNGKey(1)
    # the masks are (N, C): a small input draws the step's masks alike
    small = jnp.zeros((len(batches[0]["image"]), 16, 16, 3))
    masks = [jax_dropout_masks(model_j, variables, small,
                               key=jax.random.fold_in(dropout_rng, s))[0]
             for s in range(STEPS)]
    assert not torch.equal(masks[0][0], masks[1][0])
    opt_conf = load_config(vistas_cli.DEFAULT_CONFIG)["optimizer"]
    losses_j, _ = _run_jax(model_j, variables, [optax.adam(jax_poly_lr(
        opt_conf["learning_rate"], max_iter=TOTAL_STEPS))], batches, dropout_rng)

    model_t = build_network("resnet18", n_classes=13, in_channels=3)
    model_t.load_state_dict(state_dict_from_jax(variables["params"],
                                                variables["batch_stats"]), strict=True)
    losses_t, _ = _run_port(model_t.train(), opt_conf, batches, masks)
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3, atol=2e-4)
