"""The energy cell (``ebgan.train.b64``) driven on the CPU at a sixteenth of
its widths: it runs and comes out correct, each fault planted in the
program's energy step makes ``correct`` false, so does the TF32 control;
the frozen arithmetic of ``work_energy.py`` pins the paper's numbers; and
the cell's new metrics read nothing outside it."""
import ast
import json
import math

import pytest
import torch

import ebgan_cpu_cells as ecpu
import portbench_cpu_cells as cpu
from portbench import bench, controls_energy, devtrace, inputs_energy, work, work_energy
from portbench.drivers import common
from portbench.reference import ebgan as ref

NEW_METRICS = ["tconv_fwd_roofline.energy", "tconv_bwd_roofline.energy",
               "d_conv_roofline.energy", "rgb_head_roofline"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several workers on the
    machine's cores, and these tests' 256x256 maps ran some 20 times
    slower where every worker's ops spread over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(**kw):
    c = ecpu.cell(**kw)
    out = bench.run(c)
    correct, checks = bench.judge(c, out.numbers)
    return c, out, correct, checks


@pytest.mark.parametrize("trace", [False, True])
def test_energy_cell_runs_correct(trace):
    c, out, correct, checks = _run(trace=trace, seconds=0.5)
    assert correct, checks
    assert set(checks) == {"loss_gap", "grad_gap", "change_gap", "skipped_steps"}
    assert out.ctx.steps >= 1 and out.ctx.failed == 0
    assert bench.reader("train_samples_per_s")(out.ctx) > 0
    assert bench.reader("train_mfu")(out.ctx) > 0
    d = out.diagnostics
    assert len(d["check_stats"]) == 4 and d["stats_names"][2] == "margin_active"
    # the program's read-back follows the reference's, hinge share exactly
    for got, want in zip(d["check_stats"], d["reference_stats"]):
        assert got[2] == want[2]
        assert got == pytest.approx(want, rel=1e-3)
    if trace:
        assert bench.reader("train_batch_ms")(out.ctx) > 0


def _no_pt(orig):
    """The generator's loss without the pulling-away term."""
    def loss(self, gp, dp, z):
        from repro_torch.models import gan

        fake = self._generate(gp, z)
        e, code = gan.energy(dp, self.dec_cfg, fake, plan=self.dec_plans[1])
        return e.mean(), gan.pulling_away(code).detach()[None]
    return loss


def _no_hinge(orig):
    """The discriminator's loss without the margin's hinge."""
    def loss(self, dp, gp, real, z):
        l, aux = orig(self, dp, gp, real, z)
        from repro_torch.models import gan

        e, _ = gan.energy(dp, self.dec_cfg, real, plan=self.dec_plans[1])
        return e.mean(), aux
    return loss


def _decoder_dw_skipped(orig):
    """The decoder's weight gradients dropped in the discriminator's phase
    (the phase whose parameters hold it)."""
    def accumulate(loss_fn, params, reals, zs):
        loss, grads, aux = orig(loss_fn, params, reals, zs)
        if "dec" in grads:
            grads = dict(grads, dec={k: {n: torch.zeros_like(t) for n, t in v.items()}
                                     for k, v in grads["dec"].items()})
        return loss, grads, aux
    return staticmethod(accumulate)


def _batch_mean_hinge(orig):
    """The margin's hinge taken once on the batch's mean fake energy,
    ``max(0, m - mean D(G(z)))``, not on each row: the same loss and
    gradient wherever the hinge is live on every fake row or on none."""
    def loss(self, dp, gp, real, z):
        from repro_torch.models import gan

        with torch.no_grad():
            fake = self._generate(gp, z)
        e, _ = gan.energy(dp, self.dec_cfg, torch.cat([real, fake]), plan=self.dec_plans[0])
        e_real, e_fake = e[: real.shape[0]], e[real.shape[0]:]
        m = self.tcfg.margin
        aux = torch.stack([e_real.mean(), e_fake.mean(), (e_fake < m).float().mean()])
        return e_real.mean() + torch.relu(m - e_fake.mean()), aux.detach()
    return loss


@pytest.mark.parametrize("where,fault", [("_g_loss_energy", _no_pt),
                                         ("_d_loss_energy", _no_hinge),
                                         ("_accumulate", _decoder_dw_skipped),
                                         ("_d_loss_energy", _batch_mean_hinge)],
                         ids=["pt_dropped", "hinge_dropped", "decoder_dw_skipped",
                              "hinge_on_the_batch_mean"])
def test_energy_faults_are_not_correct(monkeypatch, where, fault):
    """Each fault reads incorrect. At this seed the hinge is live on one of
    the two fake rows in the first two checked steps (``margin_active``
    0.5), which a hinge taken on the batch's mean needs to show."""
    from repro_torch.train.gan_trainer import GanTrainer

    orig = GanTrainer.__dict__[where]
    orig = orig.__func__ if isinstance(orig, staticmethod) else orig
    monkeypatch.setattr(GanTrainer, where, fault(orig))
    _, out, correct, checks = _run(seconds=0.0)
    assert not correct, checks
    assert any(0 < s[2] < 1 for s in out.diagnostics["reference_stats"])


def test_energy_control_is_not_correct():
    """The reference in TF32 in the program's place fails one of the
    cell's numbers, and so does half a batch."""
    c = ecpu.cell()
    readings = controls_energy.train_control(c, c.seed, torch.device("cpu"))
    for kind in ("tf32", "half_batch"):
        numbers = readings[kind]
        assert any(numbers[k] > c.limits[k]["limit"] for k in c.limits), (kind, numbers)


def test_frozen_energy_arithmetic_pins_the_papers_numbers():
    cfg = json.loads((cpu.ROOT / "portbench" / "configs" / "ebgan.json").read_text())
    g = work_energy.EnergyGan(cfg)
    assert round(g.tconv_flops() / 1e9, 2) == 7.52
    assert g.memory_savings_bytes() == 35_534_592
    assert round(g.generator_flops() / 1e9, 2) == 7.55
    assert g.train_step_flops(1) == 83_133_988_864
    assert g.train_step_flops(64) == 64 * g.train_step_flops(1)
    # the encoder and the decoder mirror each other's useful work
    assert g.encoder_flops() == g.decoder_flops()
    # the auto-encoder's share of a step: about 64%
    ae = 8 * g.decoder_flops() + (8 * g.encoder_flops() - 4 * work_energy.conv_macs(*g.enc[0]))
    assert 0.63 < ae / g.train_step_flops(1) < 0.65
    for least in (g.tconv_fwd_least_s, g.tconv_bwd_least_s, g.d_conv_least_s,
                  g.rgb_head_least_s):
        assert 0 < least(1) < least(64)
    # every weight the reference takes is drawn, as many as the file states
    assert sum(math.prod(shape) for *_, shape, _ in inputs_energy.shapes(cfg)) \
        == cfg["parameters"]


def _ctx(gan, kind="train"):
    p = devtrace.Profile()
    p.t0, p.t1 = 0.0, 1.0
    p.ops = [("void (anonymous namespace)::fused_kernel<1, 2>(float const*)", 0.0, 0.2),
             ("void (anonymous namespace)::dx_kernel<1>(float const*)", 0.2, 0.4),
             ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw", 0.4, 0.5),
             ("void (anonymous namespace)::rgb_head_kernel<2>(float const*)", 0.5, 0.6)]
    return common.Ctx(kind=kind, gan=gan, setup_s=1.0, window_s=1.0, peak_bytes=0,
                      attempted=1, failed=0, batch=64, steps=2, samples=128,
                      profile=p, profiled=2)


def test_new_metrics_read_only_in_the_energy_cell():
    """Each new metric reads a share in an energy run's profile, and None in
    a classifier training run's or a serving run's, whatever it traced."""
    ecfg = json.loads((cpu.ROOT / "portbench" / "configs" / "ebgan.json").read_text())
    dcfg = json.loads((cpu.ROOT / "portbench" / "configs" / "dcgan.json").read_text())
    for name in NEW_METRICS:
        read = bench.reader(name)
        assert read(_ctx(work_energy.EnergyGan(ecfg))) > 0, name
        assert read(_ctx(work.Gan(dcfg))) is None, name
        assert read(_ctx(work.Gan(dcfg), kind="serve")) is None, name
    spec = json.loads((cpu.ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in NEW_METRICS:
            assert m["workloads"] == [ecpu.NAME]


def test_kernel_families_do_not_overlap():
    """No kernel of the port's transpose convs, its RGB head or cuDNN's convs
    counts in two families."""
    names = ["(anonymous namespace)::rgb_head_dx_kernel<2>", "(anonymous namespace)::dx_kernel<1>",
             "(anonymous namespace)::rgb_head_dw_kernel<2>", "(anonymous namespace)::dw_kernel<256, 64, 1>",
             "(anonymous namespace)::rgb_head_sum_kernel", "tconv::(anonymous namespace)::sum_splits_kernel",
             "cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>",
             "wgrad_alg0_engine_NHWC<float, 128, 5, 5, 3, 3, 3, false, 512>",
             "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw",
             "(anonymous namespace)::project_relu_kernel", "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n"]
    fams = {f: devtrace.kernel_patterns(f) for f in ("tconv_fwd", "tconv_bwd", "d_conv", "rgb_head")}
    hits = [[f for f, pats in fams.items() if any(p.search(n) for p in pats)] for n in names]
    assert hits == [["rgb_head"], ["tconv_bwd"], ["rgb_head"], ["tconv_bwd"], ["rgb_head"],
                    ["tconv_bwd"], ["d_conv"], ["d_conv"], ["d_conv"], [], []]


def test_reference_imports_nothing_of_the_program():
    """The reference, which the CPU tests hold the program to as well,
    imports neither JAX nor the JAX package nor the port."""
    tree = ast.parse((cpu.ROOT / "portbench" / "reference" / "ebgan.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names == {"__future__", "torch", "torch.nn.functional"}
    assert ref.round_tf32 is not None
