"""Port of ``tests/test_plan_registry.py`` (repro_torch.kernels.plan_registry
and the engine's warm start): exact round trips of per-layer and
pair-fused plans, version pinning, a reference registry's foreign methods
refused, and ``GanEngine.save_plans`` followed by a warm start that adopts
the saved plans without compiling, on the CPU."""
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import plan as planlib
from repro_torch.kernels import plan_registry as reg
from repro_torch.models import gan
from repro_torch.serve import BucketPolicy, GanEngine
from repro_torch.serve import gan_engine


def _plans():
    cfg = gan.reduced_config(gan.DCGAN)
    epis = gan.generator_epilogues(cfg)
    fused = planlib.compile_plan(cfg, 2, epilogues=epis, fuse="force")
    unfused = planlib.compile_plan(cfg, 2, epilogues=epis, fuse="off")
    assert any(isinstance(e, planlib.FusedPairPlan) for e in fused.entries)
    return fused, unfused


# ----------------------------------------------------------- round trips

def test_plan_dict_round_trip_exact():
    fused, unfused = _plans()
    phase = planlib.compile_plan(gan.reduced_config(gan.DCGAN), 2,
                                 method="phase", bwd="autograd")
    for p in (fused, unfused, phase):
        p2 = reg.plan_from_dict(json.loads(json.dumps(reg.plan_to_dict(p))))
        assert p2 == p          # frozen dataclasses: field-exact equality
        assert tuple(p2) == tuple(p)
        assert [type(e) for e in p2.entries] == [type(e) for e in p.entries]


def test_save_load_registry_round_trip(tmp_path):
    fused, unfused = _plans()
    path = tmp_path / "plans.json"
    reg.save_plan_registry({"dcgan:2": fused, "dcgan-flat:2": unfused}, path)
    loaded = reg.load_plan_registry(path)
    assert set(loaded) == {"dcgan:2", "dcgan-flat:2"}
    assert loaded["dcgan:2"] == fused
    assert loaded["dcgan-flat:2"] == unfused
    assert [e["kind"] for e in json.loads(path.read_text())["plans"]
            ["dcgan:2"]["entries"]] == ["pair", "pair"]
    assert not list(tmp_path.glob("*.tmp"))     # the write was atomic


def test_foreign_version_raises(tmp_path):
    path = tmp_path / "plans.json"
    path.write_text(json.dumps({"version": 99, "plans": {}}))
    with pytest.raises(ValueError, match="version"):
        reg.load_plan_registry(path)


def test_method_outside_the_port_raises(tmp_path):
    """A plan the port cannot run (the reference's ``pallas_fused``, say)
    is refused on load, never adopted."""
    _, unfused = _plans()
    blob = reg.plan_to_dict(unfused)
    blob["entries"][1]["method"] = "pallas_fused"
    path = tmp_path / "plans.json"
    path.write_text(json.dumps({"version": 1, "plans": {"dcgan:2": blob}}))
    with pytest.raises(ValueError, match="pallas_fused"):
        reg.load_plan_registry(path)


# ------------------------------------------------------ engine warm start

def _engine(tiny, params, fuse="off"):
    eng = GanEngine(BucketPolicy(buckets=(1, 2), max_wait_s=0.01),
                    device="cpu", fuse=fuse)
    eng.register(tiny, params, name="dcgan")
    return eng


@pytest.mark.parametrize("fuse", ["off", "force"])
def test_engine_save_plans_then_warm_start(tmp_path, monkeypatch, fuse):
    tiny = gan.reduced_config(gan.DCGAN)
    params = gan.generator_init(torch.Generator().manual_seed(0), tiny,
                                device="cpu")
    path = tmp_path / "plans.json"

    cold = _engine(tiny, params, fuse)
    cold.warmup()
    cold.save_plans(path)
    blob = json.loads(path.read_text())
    assert set(blob["plans"]) == {"dcgan:1", "dcgan:2"}

    # the warm engine must never compile a plan
    def boom(*a, **kw):
        raise AssertionError("warm start compiled a plan")

    monkeypatch.setattr(gan_engine, "compile_plan_buckets", boom)
    monkeypatch.setattr(planlib, "compile_plan_buckets", boom)
    monkeypatch.setattr(planlib, "fuse_pairs", boom)

    warm = _engine(tiny, params, fuse)
    warm.warmup(registry_path=path)
    for bucket in (1, 2):
        assert warm.registry["dcgan"].plans[bucket] == \
            cold.registry["dcgan"].plans[bucket]
    assert (fuse == "force") == any(
        isinstance(e, planlib.FusedPairPlan)
        for e in warm.registry["dcgan"].plans[2].entries)

    # adopted plans serve bitwise-identically to generator_apply
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, tiny.z_dim)).astype(np.float32))
    got = warm._executable("dcgan", 2)(params, z)
    want = gan.generator_apply(params, tiny, z, device="cpu",
                               plan=cold.registry["dcgan"].plans[2])
    assert torch.equal(got, want)


@pytest.mark.parametrize("saved,adopted", [("force", "off"), ("off", "force")])
def test_warm_start_refuses_plans_fused_otherwise(tmp_path, saved, adopted):
    """A registry written under one ``fuse`` is refused by an engine built
    with the other, never served under the wrong pair pass."""
    tiny = gan.reduced_config(gan.DCGAN)
    params = gan.generator_init(torch.Generator().manual_seed(0), tiny,
                                device="cpu")
    path = tmp_path / "plans.json"
    cold = _engine(tiny, params, saved)
    cold.warmup()
    cold.save_plans(path)
    warm = _engine(tiny, params, adopted)
    with pytest.raises(ValueError, match="was not fused as"):
        warm.warmup(registry_path=path)


def test_warm_start_with_partial_registry_compiles_the_rest(tmp_path):
    tiny = gan.reduced_config(gan.DCGAN)
    params = gan.generator_init(torch.Generator().manual_seed(0), tiny,
                                device="cpu")
    path = tmp_path / "plans.json"

    cold = _engine(tiny, params)
    cold.warmup()
    reg.save_plan_registry({"dcgan:1": cold.registry["dcgan"].plans[1]}, path)
    warm = _engine(tiny, params)
    warm.warmup(registry_path=path)   # bucket 2 compiles the normal way
    assert set(warm.registry["dcgan"].plans) == {1, 2}
    assert warm.registry["dcgan"].plans[1] == cold.registry["dcgan"].plans[1]

    z = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, tiny.z_dim)).astype(np.float32))
    got = warm._executable("dcgan", 2)(params, z)
    ref = cold._executable("dcgan", 2)(params, z)
    assert torch.equal(got, ref)
