"""The reference against the program on the CPU at a tiny size, and the check
failing the control and each planted fault with the cells' own limits.

On the CPU the program computes in float32 (its plain versions), so a sound
run reads far under every limit, and a fault or the control far over one.
"""

import pytest
import torch
from portbench_tiny import SEED, run_tiny, tiny_cell

from portbench.harness import common, train
from portbench.harness.traffic import train_pool
from portbench.reference import augment as ref_aug
from portbench.reference.lowp import fp8

SERVE = "resnext50_early.serve_b8"
MIX = "confsegnet_r50.train_mix"
SEG = "confsegnet_r50.seg_phase"


def test_serving_program_equals_reference_on_cpu():
    r = run_tiny(SERVE)
    assert r["correct"], r["check"]
    assert r["check"]["gap_mean"]["value"] < 1e-6


@pytest.mark.parametrize("name", [MIX, SEG])
def test_training_program_follows_reference_on_cpu(name):
    r = run_tiny(name)
    assert r["correct"], r["check"]
    assert r["check"]["untrained_moved"]["value"] == 0


def test_augmentation_equals_the_programs():
    from heatnet_tpu_torch.data.loaders import DeviceAugment

    tr = tiny_cell(MIX).traffic
    dev = torch.device("cpu")
    raw = train_pool(tr, 5, dev)[0]
    batch = DeviceAugment(tuple(tr["crop"]), dev)(torch.Generator().manual_seed(3), raw)
    d = ref_aug.draw_train(torch.Generator().manual_seed(3), tr["batch"],
                           (tr["height"], 700), tuple(tr["crop"]))
    ref = ref_aug.augment(train._raw_on(raw, dev), d, tuple(tr["crop"]))
    for k in ("rgb_day", "ir_day", "rgb_night", "ir_night", "label_day"):
        assert torch.equal(batch[k], ref[k].to(batch[k].dtype)), k
    assert torch.equal(batch["mod_drop_params"], ref["rect"])


def _half_predict(predict):
    def faulty(model, batch, *a, **k):
        half = {key: v[: len(v) // 2] for key, v in batch.items()}
        out = predict(model, half, *a, **k)
        return torch.cat([out, out])
    return faulty


def _altered_predict(predict):
    def faulty(model, batch, *a, **k):
        out = predict(model, batch, *a, **k).clone()
        out[:, :8, :8] = (out[:, :8, :8] + 1) % 13
        return out
    return faulty


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_serving_faults_fail_the_check(monkeypatch, fault):
    from heatnet_tpu_torch.eval import validate

    wrap = _half_predict if fault == "half_batch" else _altered_predict
    monkeypatch.setattr(validate, "predict", wrap(validate.predict))
    assert not run_tiny(SERVE)["correct"]


def test_serving_control_fails_the_check():
    assert not run_tiny(SERVE, control="fp8")["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_faults_fail_the_check(monkeypatch, fault):
    from heatnet_tpu_torch.data.loaders import DeviceAugment
    from heatnet_tpu_torch.train.state import TrainState

    if fault == "state_unchanged":
        monkeypatch.setattr(TrainState, "apply_gradients",
                            lambda self: self.optimizer.zero_grad(set_to_none=True))
    else:
        call = DeviceAugment.__call__

        def half(self, *a, **k):
            out = call(self, *a, **k)
            return {key: v[: len(v) // 2] for key, v in out.items()}
        monkeypatch.setattr(DeviceAugment, "__call__", half)
    r = run_tiny(MIX)
    assert not r["correct"], r["check"]


def test_training_control_fails_the_check():
    cell = tiny_cell(MIX)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device("cpu")
    pool = train_pool(tr, common.sub_seed(SEED, 1), dev)
    phases, _ = train.schedule(cfg, tr)
    first = [next(phases) for _ in range(train.FIRST_STEPS)]
    ref = train.reference_readings(cfg, tr, SEED, pool, first, dev)
    low = train.reference_readings(cfg, tr, SEED, pool, first, dev, quant=fp8)
    ok, check = common.check(train.compare(low, ref), cell.limits)
    assert not ok, check


def test_schedule_is_read_from_the_configuration():
    cell = tiny_cell(MIX)
    cell.config["schedule"] = {"iter_critic_phase": 3, "iter_seg_phase": 2,
                               "iter_initial_critic_phase": 2}
    phases, block = train.schedule(cell.config, cell.traffic)
    c, s = "train_critic", "train_seg"
    assert [next(phases) for _ in range(12)] == [c, c, s, s, c, c, c, s, s, c, c, c]
    assert block == 5


def test_a_schedule_fault_fails_the_check(monkeypatch):
    from heatnet_tpu_torch.train.adversarial import PhaseMachine

    monkeypatch.setattr(PhaseMachine, "tick", lambda self: "train_critic")
    r = run_tiny(MIX)
    assert not r["correct"], r["check"]
    assert r["check"]["schedule_mismatch"]["value"] > 0


def test_traced_run_on_cpu_names_its_gaps():
    r = run_tiny(SERVE, trace=True)
    assert r["correct"], r["check"]
    assert r["breakdown"]["idle_gaps"]
