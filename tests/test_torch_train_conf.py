"""``heatnet_tpu_torch.cli.train_conf`` end to end on the CPU, and its flags.

A tiny train pack (4 day frames, 3 night frames, 64x960), 64x64 crops,
ResNeXt (1,1,1,1) with 2 ``resnet18`` critics: 4 iterations through both
phases with moddrop, IR scaling, a ``--pretraining`` checkpoint written as
``cli.train_plain`` writes one, and an IR-only ResNeXt-50 teacher whose
checkpoint carries the ``trgb_segnet.`` prefix; the checkpoint reloads
strictly into a fresh ``ConfSegnet`` and ``--resume auto`` continues from
it. ``--late_fusion`` and ``--arch pspnet`` (with a PSPNet IR teacher) run
through both phases. ``--vis`` renders the JAX trainer's panels: held
against its forward on the same weights, and its run's losses against a
run without it. The step-level numerics are
held against JAX in tests/test_torch_adversarial.py,
tests/test_torch_late_fusion.py and tests/test_torch_pspnet.py; ``--eval``,
``--infer`` and the periodic eval in tests/test_torch_eval.py.
"""

import numpy as np
import pytest
import torch

from heatnet_tpu_torch.cli import train_conf
from heatnet_tpu_torch.data.packed import write_train_pack
from heatnet_tpu_torch.io.checkpoint import save_checkpoint
from heatnet_tpu_torch.models import ConfSegnet, ResNeXtSeg, build_network
from heatnet_tpu_torch.models.layers import init_params

torch.set_num_threads(2)

TINY = ["--structure", "1", "1", "1", "1"]


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    d = tmp_path_factory.mktemp("conf")
    rng = np.random.RandomState(0)
    n, m, h, w = 4, 3, 64, 960
    write_train_pack(str(d / "train"),
                     rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (n, h, w)).astype(np.uint16),
                     rng.randint(0, 13, (n, h, w)).astype(np.uint8),
                     rng.randint(0, 256, (m, h, w, 3)).astype(np.uint8),
                     rng.randint(21000, 26000, (m, h, w)).astype(np.uint16))
    plain = ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4)
    init_params(plain, torch.Generator().manual_seed(3))
    save_checkpoint({"epoch": 1, "state_dict": plain.state_dict()}, str(d / "plain.pth"))
    teacher = ResNeXtSeg(structure=(3, 4, 6, 3), input_channels=1)
    init_params(teacher, torch.Generator().manual_seed(4))
    save_checkpoint({"epoch": 1, "state_dict": {
        "trgb_segnet." + k: v for k, v in teacher.state_dict().items()}},
        str(d / "teacher.pth"))
    psp_teacher = build_network("resnet50", in_channels=1)
    init_params(psp_teacher, torch.Generator().manual_seed(5))
    save_checkpoint({"epoch": 1, "state_dict": {
        "trgb_segnet." + k: v for k, v in psp_teacher.state_dict().items()}},
        str(d / "psp_teacher.pth"))
    return d


def _argv(d, *extra):
    return ["--dataroot", str(d / "train"), "--device", "cpu", *TINY,
            "--batch_size", "2", "--discarch", "resnet18", "--num_critics", "2",
            "--crop_height", "64", "--crop_width", "64",
            "--checkpointname", str(d / "ck"), "--log_dir", str(d / "runs"), *extra]


def test_train_conf_both_phases_teacher_checkpoint_and_resume(pack, capsys):
    run = train_conf.main(_argv(
        pack, "--n_epochs", "1", "--iter_initial_critic_phase", "2",
        "--iter_critic_phase", "2", "--iter_seg_phase", "2", "--moddrop", "--irscale",
        "--pretraining", "--pretraining_path", str(pack / "plain.pth"),
        "--night_supervision_model", str(pack / "teacher.pth")))
    out = capsys.readouterr().out
    n_segnet = len(ResNeXtSeg(structure=(1, 1, 1, 1), input_channels=4).state_dict())
    assert f"Updated : {n_segnet} entries" in out  # the whole pretrained segnet
    n_teacher = len(ResNeXtSeg(structure=(3, 4, 6, 3), input_channels=1).state_dict())
    assert f"Loaded dict with {n_teacher} entries" in out
    # n_epochs doubles with conf on: 2 epochs of 2 steps
    assert run.phases == ["train_critic"] * 2 + ["train_seg"] * 2
    assert len(run.losses["train_seg"]) == len(run.losses["train_critic"]) == 2
    assert all(np.isfinite(v) for vs in run.losses.values() for v in vs)
    assert len(run.step_seconds) == 4 and out.count("Current loss") == 4

    saved = torch.load(run.checkpoint, weights_only=True)
    assert saved["epoch"] == 2
    fresh = ConfSegnet(disc_arch="resnet18", num_critics=2, structure=(1, 1, 1, 1))
    fresh.load_state_dict(saved["state_dict"], strict=True)

    again = train_conf.main(_argv(pack, "--n_epochs", "2", "--max_iters_per_epoch", "1",
                                  "--iter_initial_critic_phase", "1", "--resume", "auto"))
    assert again.phases == ["train_critic", "train_seg"]  # epochs 2 and 3 of 4
    assert torch.load(again.checkpoint, weights_only=True)["epoch"] == 4


def test_train_conf_no_conf_trains_the_segnet_only(pack):
    run = train_conf.main(_argv(pack, "--n_epochs", "1", "--no_conf",
                                "--checkpointname", str(pack / "ck_noconf")))
    assert run.phases == ["train_seg"] * 2 and not run.losses["train_critic"]
    saved = torch.load(run.checkpoint, weights_only=True)["state_dict"]
    assert not any(k.startswith("critics_") for k in saved)


@pytest.mark.parametrize("flags,teacher", [
    (["--late_fusion"], "teacher.pth"),
    (["--arch", "pspnet"], "psp_teacher.pth"),
    (["--arch", "pspnet", "--late_fusion"], "psp_teacher.pth")],
    ids=["late_fusion", "pspnet", "pspnet_late_fusion"])
def test_train_conf_late_fusion_and_pspnet_run_both_phases(pack, capsys, flags, teacher):
    run = train_conf.main(_argv(
        pack, *flags, "--n_epochs", "1", "--max_iters_per_epoch", "1",
        "--iter_initial_critic_phase", "1", "--iter_seg_phase", "1", "--moddrop",
        "--irscale", "--night_supervision_model", str(pack / teacher),
        "--checkpointname", str(pack / f"ck_{teacher}{len(flags)}")))
    out = capsys.readouterr().out
    t_net = (build_network("resnet50", in_channels=1) if "pspnet" in flags
             else ResNeXtSeg(structure=(3, 4, 6, 3), input_channels=1))
    assert f"Loaded dict with {len(t_net.state_dict())} entries" in out
    assert run.phases == ["train_critic", "train_seg"]
    assert all(np.isfinite(v) for vs in run.losses.values() for v in vs)
    kw = dict(disc_arch="resnet18", num_critics=2, structure=(1, 1, 1, 1),
              late_fusion="--late_fusion" in flags,
              arch="pspnet" if "pspnet" in flags else "custom")
    saved = torch.load(run.checkpoint, weights_only=True)["state_dict"]
    ConfSegnet(**kw).load_state_dict(saved, strict=True)
    assert ("trgb_segnet.mod1_2.conv1.weight" in saved) == (flags == ["--late_fusion"])
    assert ("trgb_segnet.feats.conv1_2.weight" in saved) == (len(flags) == 3)


def test_vis_panels_equal_jax(tmp_path):
    """``render_vis`` against the JAX trainer's ``--vis`` forward and render
    (cli/train_conf.py:362-403) on the same weights (running statistics
    randomised) and batch: the label panels equal but where JAX's top two
    logits are within 1e-3, the critics' dots equal, RGB and IR equal, the
    certainty within one level; the model, its train flags and the RNG
    untouched."""
    import jax
    import jax.numpy as jnp

    from heatnet_tpu.utils import vis as jvis
    from heatnet_tpu_torch.data.png import read_png
    from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
    from test_torch_adversarial import _batch, _jax, _pair, _randomize_stats, _torch

    model_j, params, stats, model_t = _pair(cert_branch=True)
    stats = _randomize_stats(stats)
    model_t.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    b = _batch(drop=False)
    bj = _jax(b)
    out = jax.jit(lambda v, day, night: model_j.apply(v, day, night, train=False))(
        {"params": params, "batch_stats": stats}, [bj["rgb_day"], bj["ir_day"]],
        [bj["rgb_night"], bj["ir_night"]])
    before = {k: v.clone() for k, v in model_t.state_dict().items()}
    rng = torch.get_rng_state()
    paths = train_conf.render_vis(model_t, _torch(b), 7, str(tmp_path), "ir_rgb",
                                  cert_branch=True)
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        f"0000007_{n}.png" for n in ("label_day", "label_night", "rgb_day", "ir_day",
                                     "cert_day")]
    assert all(m.training for m in model_t.modules())
    assert torch.equal(torch.get_rng_state(), rng)
    for k, v in model_t.state_dict().items():
        assert torch.equal(v, before[k]), k

    def u8(img):  # the JAX package's save_image conversion
        return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)

    for side, path in (("a", paths[0]), ("b", paths[1])):
        logits = np.asarray(out[f"pred_label_{side}"])[0]
        top2 = np.sort(logits, -1)[..., -2:]
        tie = (top2[..., 1] - top2[..., 0]) < 1e-3
        verdicts = [bool(jnp.mean(c) > 0.5) for c in out[f"critics_{side}"]]
        want = u8(jvis.draw_critic_labels(jvis.color_code_labels(logits.argmax(-1)),
                                          verdicts))
        differ = (read_png(path) != want).any(-1)
        assert not (differ & ~tie).any(), f"{side}: {int((differ & ~tie).sum())} pixels"
    np.testing.assert_array_equal(read_png(paths[2]), u8(b["rgb_day"][0] * 0.5 + 0.5))
    np.testing.assert_array_equal(read_png(paths[3]), u8(jvis.vis_depth(b["ir_day"][0])))
    cert = u8(jvis.vis_depth(np.asarray(out["cert_a"])[0, ..., 0]))
    assert np.abs(read_png(paths[4]).astype(int) - cert).max() <= 1


def test_train_conf_vis_writes_the_panels_and_changes_no_loss(pack):
    """``--vis --log_everyn 1``: a critic and a seg step, the JAX trainer's
    panel names at each (steps 1 and 2, no ``--cert_branch``), and the
    losses of the same run without ``--vis`` bit for bit."""
    import os

    runs = {}
    for vis in (False, True):
        log_dir = pack / f"runs_vis{int(vis)}"
        argv = _argv(pack, "--n_epochs", "1", "--max_iters_per_epoch", "1",
                     "--iter_initial_critic_phase", "1", "--iter_seg_phase", "1",
                     "--log_everyn", "1", "--checkpointname", str(pack / f"ck_vis{vis}"))
        argv[argv.index("--log_dir") + 1] = str(log_dir)
        runs[vis] = train_conf.main(argv + (["--vis"] if vis else []))
    assert runs[True].phases == runs[False].phases == ["train_critic", "train_seg"]
    assert runs[True].losses == runs[False].losses
    names = sorted(os.listdir(pack / "runs_vis1" / "vis"))
    assert names == sorted(f"{it:07d}_{n}.png" for it in (1, 2)
                           for n in ("label_day", "label_night", "rgb_day", "ir_day"))


def test_train_conf_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_conf.main(["--dataroot", str(tmp_path)])
