"""Port of the training chaos suite (repro_torch.train.fault_injection), on
the CPU: the tests of ``tests/test_fault_injection.py`` through the port's
trainer. Each test injects one failure and asserts the documented response,
with a bit-exact loss trajectory against an uninterrupted run wherever a
resume is involved. Then the harness's own pieces against the reference's:
the same plan fires the same events, and ``trajectories_equal`` decides
alike."""
import glob
import os

import pytest
import torch

from repro.train import fault_injection as jfi
from repro_torch.data import SyntheticImages
from repro_torch.models import gan
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.checkpoint import checkpoint_steps, latest_step
from repro_torch.train.fault_injection import (
    FaultInjector,
    FaultPlan,
    NaNInjectionData,
    SimulatedCrash,
    arm_crash_before_publish,
    corrupt_checkpoint,
    trajectories_equal,
    write_stray_tmp,
)
from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

TINY = gan.GANConfig("tiny", 8, ((4, 4, 4), (8, 4, 3)))


def _data(tcfg):
    micro, _ = tcfg.micro_accum
    return SyntheticImages(
        hw=TINY.out_hw(TINY.layers[-1][0]), channels=TINY.layers[-1][2],
        global_batch=micro, device="cpu",
    )


def _trainer(tcfg, *, ckpt_dir=None, inj=None):
    data = _data(tcfg)
    if inj is not None:
        data = inj.wrap_data(data, accum=tcfg.micro_accum[1])
    return GanTrainer(TINY, tcfg, data, ckpt_dir=ckpt_dir, hooks=inj,
                      log_fn=lambda *a: None, device="cpu")


def _init(tr):
    return tr.init_state(torch.Generator().manual_seed(0))


def _reference(tcfg, steps):
    """The uninterrupted trajectory every chaos run must reproduce."""
    tr = _trainer(tcfg)
    _, hist = tr.run(_init(tr), steps=steps)
    return hist


def test_kill_and_resume_bit_exact(tmp_path):
    """Hard crash at step 5: the relaunch resumes from the step-4
    checkpoint and the combined trajectory is bit for bit the
    uninterrupted one."""
    tcfg = GanTrainerConfig(global_batch=2, ckpt_every=2)
    ref = _reference(tcfg, steps=8)

    inj = FaultInjector(FaultPlan(kill_at_step=5))
    tr1 = _trainer(tcfg, ckpt_dir=tmp_path, inj=inj)
    with pytest.raises(SimulatedCrash):
        tr1.run(_init(tr1), steps=8)
    assert ("kill", 5) in inj.fired
    assert latest_step(tmp_path) == 4  # saves land after odd steps: 2, 4

    tr2 = _trainer(tcfg, ckpt_dir=tmp_path)
    _, hist2 = tr2.run(_init(tr2), steps=8)
    assert tr2.resumed_step == 4
    assert [h["step"] for h in hist2] == [4, 5, 6, 7]
    assert trajectories_equal(ref, hist2)


def test_mid_save_kill_leaves_loadable_checkpoint(tmp_path):
    """Crash between the temp-file write and the atomic publish: the dying
    save leaves only ``*.tmp`` residue, the previous checkpoint stays the
    newest valid one, the relaunch resumes bit-exact and sweeps the
    residue."""
    tcfg = GanTrainerConfig(global_batch=2, ckpt_every=2)
    ref = _reference(tcfg, steps=6)

    inj = FaultInjector(FaultPlan(kill_mid_save_at_step=3))
    tr1 = _trainer(tcfg, ckpt_dir=tmp_path, inj=inj)
    try:
        with pytest.raises(SimulatedCrash):
            tr1.run(_init(tr1), steps=6)
    finally:
        inj.cleanup()
    assert ("arm_mid_save", 3) in inj.fired
    assert glob.glob(os.path.join(tmp_path, "*.tmp"))
    assert checkpoint_steps(tmp_path) == [2]

    tr2 = _trainer(tcfg, ckpt_dir=tmp_path)
    _, hist2 = tr2.run(_init(tr2), steps=6)
    assert tr2.resumed_step == 2
    assert [h["step"] for h in hist2] == [2, 3, 4, 5]
    assert trajectories_equal(ref, hist2)
    assert not glob.glob(os.path.join(tmp_path, "*.tmp"))


def test_sigterm_checkpoints_then_exits(tmp_path):
    """Preemption: a real SIGTERM mid-run. The in-flight step finishes, a
    checkpoint is written, and run() returns cleanly."""
    tcfg = GanTrainerConfig(global_batch=2, ckpt_every=100)
    ref = _reference(tcfg, steps=6)

    inj = FaultInjector(FaultPlan(sigterm_at_step=2))
    tr1 = _trainer(tcfg, ckpt_dir=tmp_path, inj=inj)
    _, hist1 = tr1.run(_init(tr1), steps=6)
    assert ("sigterm", 2) in inj.fired
    assert tr1.stopped
    assert [h["step"] for h in hist1] == [0, 1, 2]  # in-flight step finished
    assert latest_step(tmp_path) == 3               # ...and was checkpointed

    tr2 = _trainer(tcfg, ckpt_dir=tmp_path)
    _, hist2 = tr2.run(_init(tr2), steps=6)
    assert tr2.resumed_step == 3
    assert trajectories_equal(ref, hist1) and trajectories_equal(ref, hist2)


@pytest.mark.parametrize("mode", ["truncate", "garbage", "empty"])
def test_corrupt_newest_checkpoint_falls_back(tmp_path, mode):
    """Bit rot on the newest checkpoint: restore skips it and resumes from
    the previous one, still on the uninterrupted trajectory."""
    tcfg = GanTrainerConfig(global_batch=2, ckpt_every=2)
    ref = _reference(tcfg, steps=6)

    tr1 = _trainer(tcfg, ckpt_dir=tmp_path)
    tr1.run(_init(tr1), steps=4)
    assert checkpoint_steps(tmp_path) == [2, 4]
    corrupt_checkpoint(tmp_path, 4, mode=mode)

    tr2 = _trainer(tcfg, ckpt_dir=tmp_path)
    _, hist2 = tr2.run(_init(tr2), steps=6)
    assert tr2.resumed_step == 2
    assert [h["step"] for h in hist2] == [2, 3, 4, 5]
    assert trajectories_equal(ref, hist2)


def test_stray_tmp_never_shadows_and_is_swept(tmp_path):
    """Pre-existing crash residue: a half-written ``*.tmp`` is not taken for
    a checkpoint, does not break resume, and is swept by the first
    successful save's gc pass."""
    write_stray_tmp(tmp_path)
    assert latest_step(tmp_path) is None

    tcfg = GanTrainerConfig(global_batch=2, ckpt_every=2)
    tr = _trainer(tcfg, ckpt_dir=tmp_path)
    _, hist = tr.run(_init(tr), steps=2)
    assert tr.resumed_step is None          # nothing valid to resume from
    assert [h["step"] for h in hist] == [0, 1]
    assert not glob.glob(os.path.join(tmp_path, "*.tmp"))


def test_combined_faults_one_run(tmp_path):
    """A bad-node NaN batch and a later hard kill in one run: the NaN step
    is skipped (and the skip count survives the crash in the checkpoint),
    the kill resumes bit-exact."""
    tcfg = GanTrainerConfig(global_batch=2, ckpt_every=2)

    ref_inj = FaultInjector(FaultPlan(nan_at_steps=(1,)))
    ref_tr = _trainer(tcfg, inj=ref_inj)
    _, ref = ref_tr.run(_init(ref_tr), steps=6)
    assert ref_tr.skipped_steps == 1

    inj = FaultInjector(FaultPlan(nan_at_steps=(1,), kill_at_step=3))
    tr1 = _trainer(tcfg, ckpt_dir=tmp_path, inj=inj)
    with pytest.raises(SimulatedCrash):
        tr1.run(_init(tr1), steps=6)

    inj2 = FaultInjector(FaultPlan(nan_at_steps=(1,)))  # same data faults
    tr2 = _trainer(tcfg, ckpt_dir=tmp_path, inj=inj2)
    _, hist2 = tr2.run(_init(tr2), steps=6)
    assert tr2.resumed_step == 2
    assert tr2.skipped_steps == 1   # restored from the checkpoint
    assert trajectories_equal(ref, hist2)


# ------------------------------------------------ the harness's own pieces

def test_nan_injection_data_poisons_chosen_steps_only():
    data = NaNInjectionData(_data(GanTrainerConfig(global_batch=2)), (1,),
                            accum=2)
    assert torch.isfinite(data.batch(1)).all()      # step 0, micro 1
    assert torch.isnan(data.batch(2)).all()         # step 1, micro 0
    assert torch.isnan(data.batch(3)).all()         # step 1, micro 1
    assert torch.isfinite(data.batch(4)).all()


def test_crash_before_publish_is_one_shot(tmp_path):
    disarm = arm_crash_before_publish()
    try:
        with pytest.raises(SimulatedCrash):
            ckpt.save_checkpoint(tmp_path, 1, {"w": torch.ones(2)}, {})
        assert checkpoint_steps(tmp_path) == []
        ckpt.save_checkpoint(tmp_path, 2, {"w": torch.ones(2)}, {})
        assert checkpoint_steps(tmp_path) == [2]
    finally:
        disarm()
    assert ckpt._REPLACE is os.replace


def test_injector_fires_as_the_reference_injector_does():
    plan = dict(kill_at_step=4, nan_at_steps=(1,), kill_mid_save_at_step=2)
    port, ref = FaultInjector(FaultPlan(**plan)), jfi.FaultInjector(
        jfi.FaultPlan(**plan))
    try:
        for inj, crash in ((port, SimulatedCrash), (ref, jfi.SimulatedCrash)):
            for step in range(6):
                try:
                    inj.on_step_start(step)
                except crash:
                    break
    finally:
        port.cleanup()
        ref.cleanup()
    assert port.fired == ref.fired == [("arm_mid_save", 2), ("kill", 4)]


@pytest.mark.parametrize("b", [
    [{"step": 1, "g_loss": 0.5, "d_loss": 1.25}],
    [{"step": 1, "g_loss": 0.5 + 1e-9, "d_loss": 1.25}],   # same float32
    [{"step": 1, "g_loss": 0.5 + 1e-6, "d_loss": 1.25}],   # another float32
    [{"step": 2, "g_loss": 0.5, "d_loss": 1.25}],          # no overlap
])
def test_trajectories_equal_decides_as_the_reference(b):
    a = [{"step": 0, "g_loss": 0.25, "d_loss": 1.0},
         {"step": 1, "g_loss": 0.5, "d_loss": 1.25}]
    assert trajectories_equal(a, b) == jfi.trajectories_equal(a, b)
