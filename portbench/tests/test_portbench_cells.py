"""The harness driven on the CPU at a reduced width: each cell runs and
comes out correct, its control comes out over the cell's limits, and each
fault the cell can have, planted in the timed path, makes ``correct``
false. The look for a card is the run script's alone, so it is skipped."""
import pytest
import torch

import portbench_cpu_cells as cpu
from portbench import bench, controls

SERVE = ["dcgan.serve.poisson"]
TRAIN = ["dcgan.train.b128"]


def _run(name, **kw):
    c = cpu.cell(name, **kw)
    out = bench.run(c)
    correct, checks = bench.judge(c, out.numbers)
    return c, out, correct, checks


@pytest.mark.parametrize("trace", [False, True])
def test_serving_cell_runs_correct(trace):
    c, out, correct, checks = _run("dcgan.serve.poisson", trace=trace)
    assert correct, checks
    assert out.ctx.attempted == round(c.mix["rate_rps"] * c.seconds)
    assert out.diagnostics["checked_requests"] >= 1
    for m in c.metrics:
        value = bench.reader(m["name"])(out.ctx)
        if m["source"] in ("program_span", "program_counter") or m["name"].startswith("serve_p"):
            assert value is not None and value >= 0, m["name"]
    if trace:
        assert out.breakdown is not None


def test_training_cell_runs_correct():
    c, out, correct, checks = _run("dcgan.train.b128", trace=True, seconds=0.5)
    assert correct, checks
    assert bench.reader("train_samples_per_s")(out.ctx) > 0
    assert bench.reader("train_batch_ms")(out.ctx) > 0
    assert bench.reader("train_mfu")(out.ctx) > 0


def _altered(orig):
    def apply(*a, **k):
        out = orig(*a, **k).clone()
        out[:, 0, 0, 0] += 0.5
        return out
    return apply


def _half_rows(orig):
    def apply(*a, **k):
        out = orig(*a, **k).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return apply


@pytest.mark.parametrize("fault", [_altered, _half_rows])
def test_serving_faults_are_not_correct(monkeypatch, fault):
    from repro_torch.serve import gan_engine

    monkeypatch.setattr(gan_engine, "generator_apply", fault(gan_engine.generator_apply))
    _, _, correct, checks = _run("dcgan.serve.poisson")
    assert not correct and checks["served_gap"]["value"] > checks["served_gap"]["limit"]


def _unchanged(orig):
    def step(self, state, reals, zs):
        _, stats = orig(self, state, reals, zs)
        return state, stats
    return step


def _half_batch(orig):
    def step(self, state, reals, zs):
        b = reals.shape[1] // 2
        return orig(self, state, reals[:, :b], zs[:, :b])
    return step


def _run_unchanged(orig):
    """``GanTrainer.run`` trains and hands back the state it was given."""
    def run(self, state, *, steps):
        _, history = orig(self, state, steps=steps)
        return state, history
    return run


def _feed_half(orig):
    """The feed ``run`` draws its batches from leaves out half of each."""
    def batches(self, step):
        reals, zs = orig(self, step)
        b = reals.shape[1] // 2
        return reals[:, :b], zs[:, :b]
    return batches


def _feed_reused(orig):
    """The feed hands ``run`` step 0's batch at every step."""
    def batches(self, step):
        return orig(self, 0)
    return batches


def _run_short(orig):
    """``GanTrainer.run`` stops one step early."""
    def run(self, state, *, steps):
        return orig(self, state, steps=steps - 1)
    return run


@pytest.mark.parametrize("where,fault", [
    ("_step_eager", _unchanged), ("_step_eager", _half_batch),
    ("run", _run_unchanged), ("run", _run_short),
    ("_batches", _feed_half), ("_batches", _feed_reused)])
def test_training_faults_are_not_correct(monkeypatch, where, fault):
    """A fault in the step, in the window's entry ``run`` or in the feed it
    draws from makes the checked steps, which go through ``run``, come out
    not correct."""
    from repro_torch.train.gan_trainer import GanTrainer

    monkeypatch.setattr(GanTrainer, where, fault(getattr(GanTrainer, where)))
    _, _, correct, checks = _run("dcgan.train.b128", seconds=0.0)
    assert not correct, checks


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_control_is_not_correct(name):
    """The reference in TF32 in the program's place fails one of the
    cell's numbers (and, for training, so does half a batch)."""
    c = cpu.cell(name)
    fn = controls.serve_control if name in SERVE else controls.train_control
    readings = fn(c, c.seed, torch.device("cpu"))
    for kind, numbers in readings.items():
        assert any(numbers[k] > c.limits[k]["limit"] for k in numbers), (kind, numbers)
