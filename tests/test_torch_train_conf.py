"""``heatnet_tpu_torch.cli.train_conf`` end to end on the CPU, and its flags.

A tiny train pack (4 day frames, 3 night frames, 64x960), 64x64 crops,
ResNeXt (1,1,1,1) with 2 ``resnet18`` critics: 4 iterations through both
phases with moddrop, IR scaling, a ``--pretraining`` checkpoint written as
``cli.train_plain`` writes one, and an IR-only ResNeXt-50 teacher whose
checkpoint carries the ``trgb_segnet.`` prefix; the checkpoint reloads
strictly into a fresh ``ConfSegnet`` and ``--resume auto`` continues from
it. ``--late_fusion`` and ``--arch pspnet`` (with a PSPNet IR teacher) run
through both phases. Every flag that is not ported raises
``NotImplementedError`` with its ROADMAP item. The step-level numerics are
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


# --bn_groups and --trainsetname MF are ported (tests/test_torch_vistas.py,
# tests/test_torch_mf_train.py); the remaining case keeps its id
@pytest.mark.parametrize("flags,item", [pytest.param(["--vis"], 8, id="flags2-8")])
def test_unported_flags_raise_with_their_roadmap_item(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}\\b"):
        train_conf.main(["--dataroot", "-", *flags])


def test_train_conf_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_conf.main(["--dataroot", str(tmp_path)])
