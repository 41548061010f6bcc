"""The plain reference against the port's CPU path at a reduced width: the
generator, the synthetic inputs and the checked training steps."""
import json

import pytest
import torch

import portbench_cpu_cells as cpu
from portbench import inputs, work
from portbench.drivers import common, train
from portbench.reference import gan as ref

CONFIGS = ["dcgan", "ebgan"]


def _cfg(name):
    cfg = json.loads((cpu.ROOT / "portbench" / "configs" / "dcgan.json").read_text())
    if name == "ebgan":
        cfg = dict(cfg, name="ebgan", layers=cpu.EBGAN_LAYERS)
    return cpu.reduced(cfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_generator_matches_the_ports(name):
    from repro_torch.models.gan import generator_apply, generator_plan

    cfg = _cfg(name)
    gcfg = common.gan_config(cfg)
    gp, _ = inputs.weights(cfg, 3, "cpu")
    z = torch.randn(3, cfg["z_dim"], generator=torch.Generator().manual_seed(1))
    got = generator_apply(gp, gcfg, z, plan=generator_plan(gcfg, 3), device="cpu")
    want = ref.generator(gp, cfg, z)
    g = work.Gan(cfg)
    assert got.shape == want.shape == (3, g.out_hw, g.out_hw, g.out_c)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # the TF32 control departs from both
    low = ref.generator(gp, cfg, z, tf32=True)
    assert (low - want).abs().max() > 1e-5 * want.abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_inputs_are_the_programs(name):
    from repro_torch.data.pipeline import SyntheticImages, step_generator

    cfg = _cfg(name)
    g = work.Gan(cfg)
    data = SyntheticImages(g.out_hw, g.out_c, 2, seed=2 ** 31 + 3, device="cpu")
    for step in (0, 5):
        got = data.batch(step)
        want = ref.images(2 ** 31 + 3, step, 2, g.out_hw, g.out_c, "cpu")
        assert (got - want).abs().max() <= 1e-6
        z = torch.randn((2, g.z_dim), generator=step_generator(7, step, "cpu"))
        assert torch.equal(z, ref.latents(7, step, 2, g.z_dim, "cpu"))


def test_reference_training_follows_the_trainer():
    """The checked steps of the program's trainer on the CPU, compared as a
    training cell compares them, read within the cell's limits."""
    c = cpu.cell("dcgan.train.b128")
    c.seconds = 0.0
    out = train.run(c)
    for name, value in out.numbers.items():
        assert value <= c.limits[name]["limit"], (name, value)
    assert out.ctx.steps >= 1 and out.ctx.failed == 0
