"""The port's sharding rules (``repro_torch/distributed/sharding.py``) against
the reference's: ``tests/test_sharding.py`` and the three spec tests of
``tests/test_parallelism_modes.py`` ported, then ``param_specs`` path for
path against the reference's on every registry config, under the
production meshes' axes (as abstract meshes), in both parallelism modes and
with ``fsdp`` off and on. The rules read names and sizes only: no process
group is made here."""
import functools

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.models.lm import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.models.lm import build_model

MESHES = {"single-pod": ((16, 16), ("data", "model")),
          "multi-pod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture
def fake_mesh(monkeypatch):
    """A 16x16 production mesh visible to the port's rule engine (names and
    sizes only), as the reference's tests patch theirs."""
    mesh = sh.abstract_mesh((16, 16), ("data", "model"))
    monkeypatch.setattr(sh, "get_abstract_mesh", lambda: mesh)
    yield mesh
    sh.set_parallelism("tp")


# ------------------------------------------------ tests/test_sharding.py

def test_constrain_noop_without_mesh():
    x = torch.ones((4, 4))
    assert sh.constrain(x, "data", None) is x
    assert sh.shard_batch(x) is x


def test_param_specs_llama3(fake_mesh):
    cfg = get_config("llama3-8b")
    specs = sh.param_specs(build_model(cfg).abstract_params(), cfg.fsdp)
    # embedding vocab-parallel with stacked-layer-free rank
    assert specs["embed"]["w"] == P("model", None)
    l0 = specs["layers"][0]
    # stacked (n_periods, d, H*hd): leading None + column-parallel
    assert l0["mixer"]["attn"]["wq"]["w"] == P(None, None, "model")
    assert l0["mixer"]["attn"]["wo"]["w"] == P(None, "model", None)
    assert l0["ffn"]["w_gate"]["w"] == P(None, None, "model")
    assert l0["ffn"]["w_down"]["w"] == P(None, "model", None)
    # norms replicated
    assert l0["mixer_norm"]["scale"] in (P(), P(None))


def test_param_specs_drop_nondivisible(fake_mesh):
    cfg = get_config("xlstm-125m")
    specs = sh.param_specs(build_model(cfg).abstract_params(), False)
    # w_if: (periods, d, 2*nh) = (..., 8): 8 % 16 != 0 -> axis dropped
    assert specs["layers"][0]["mixer"]["mlstm"]["w_if"] in (P(), P(None, None, None))


def test_fsdp_adds_data_axis(fake_mesh):
    cfg = get_config("dbrx-132b")
    specs = sh.param_specs(build_model(cfg).abstract_params(), True)
    assert specs["layers"][0]["ffn"]["experts"]["w_gate"] == P(None, "model", "data", None)


def test_filter_divisibility(fake_mesh):
    assert sh._filter(P("model"), (32,)) == P("model")
    assert sh._filter(P("model"), (8,)) is None
    assert sh._filter(P(("data", "model")), (256,)) == P(("data", "model"))
    assert sh._filter(P("nope", "model"), (4, 32)) == P(None, "model")


# -------------------------------- tests/test_parallelism_modes.py (specs)

def test_fsdp_mode_param_specs(fake_mesh):
    sh.set_parallelism("fsdp")
    cfg = get_config("llama3-8b")
    specs = sh.param_specs(build_model(cfg).abstract_params(), False)
    # every big matrix sharded over (data, model); no TP axis anywhere
    assert specs["embed"]["w"] == P(("data", "model"), None)
    assert specs["layers"][0]["mixer"]["attn"]["wq"]["w"] == P(None, ("data", "model"), None)
    for _, s in sh._leaf_paths(specs):
        assert "model" not in [e for e in s if isinstance(e, str)], s


def test_fsdp_mode_widens_batch_and_drops_tp(fake_mesh):
    sh.set_parallelism("fsdp")
    # BATCH entries widen to include model; bare MODEL entries drop
    assert sh._filter(P(sh.BATCH, None, sh.MODEL), (256, 4, 64)) == P(
        ("data", "model"), None, None)


def test_tp_mode_default(fake_mesh):
    assert sh.get_parallelism() == "tp"
    assert sh.batch_axes() == sh.BATCH
    assert sh._filter(P(sh.BATCH, None, sh.MODEL), (256, 4, 64)) == P(
        ("data",), None, "model")


# ------------------------------------ every registry config, path for path

@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """Both packages' parameter trees of ``arch``: the reference's as shape
    structs, the port's on the meta device."""
    jp = jbuild_model(jget_config(arch)).abstract_params()
    tp = build_model(get_config(arch)).abstract_params()
    return jp, tp


def _ref_specs(jp, fsdp):
    specs = jsh.param_specs(jp, fsdp)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    out = {}
    for keypath, spec in flat:
        path = "/".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in keypath)
        out[path] = tuple(spec)
    return out


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, mesh, mode, fsdp, monkeypatch):
    """The port's trees carry the reference's paths and ranks (a one-period
    model keeps its stacked leaf), so each leaf gets the reference's spec."""
    sizes, names = MESHES[mesh]
    jp, tp = _abstract(arch)
    jmesh = jsh.abstract_mesh(sizes, names)
    monkeypatch.setattr(jax.sharding, "get_abstract_mesh", lambda: jmesh, raising=False)
    monkeypatch.setattr(sh, "get_abstract_mesh", lambda: sh.abstract_mesh(sizes, names))
    jsh.set_parallelism(mode)
    sh.set_parallelism(mode)
    try:
        want = _ref_specs(jp, fsdp)
        got = {path: tuple(s) for path, s in sh._leaf_paths(sh.param_specs(tp, fsdp))}
    finally:
        jsh.set_parallelism("tp")
        sh.set_parallelism("tp")
    assert sorted(got) == sorted(want)
    shapes = dict(sh._leaf_paths(tp))
    for path in want:
        assert got[path] == want[path], (path, tuple(shapes[path].shape))


def test_named_shardings_place_split_dims_on_both_mesh_dims():
    """``named_shardings`` turns each spec into DTensor placements over the
    mesh's dimensions: an entry over ``("data", "model")`` is ``Shard(i)``
    on both (the row-major split the reference's entry means), a dimension
    no entry names is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = sh.abstract_mesh((2, 2), ("data", "model"))
    params = {"embed": {"w": torch.empty((8, 4), device="meta")},
              "norm": {"scale": torch.empty((3,), device="meta")}}
    assert sh.named_shardings(params, mesh) == {
        "embed": {"w": (Replicate(), Shard(0))},
        "norm": {"scale": (Replicate(), Replicate())}}
    assert sh.placements(P(("data", "model"), None), mesh) == (Shard(0), Shard(0))
    assert sh.placements(P(None, "data"), mesh) == (Shard(1), Replicate())


def test_use_mesh_is_ambient_and_scoped():
    """``use_mesh`` sets the ambient mesh for its block only; an abstract
    mesh is no concrete one, so ``shard_plan_apply`` runs unsharded under
    it, as the reference's does."""
    mesh = sh.abstract_mesh((2, 2), ("pod", "data"))
    assert sh.get_abstract_mesh() is None
    with sh.use_mesh(mesh):
        assert sh.get_abstract_mesh() is mesh
        assert sh.get_concrete_mesh() is None
        assert sh.mesh_axis_sizes(sh.get_abstract_mesh()) == {"pod": 2, "data": 2}
        seen = []
        out = sh.shard_plan_apply(lambda p, z, plan: seen.append(z.shape) or z * p,
                                  2.0, torch.ones(4, 3), None)
        assert seen == [(4, 3)] and torch.equal(out, torch.full((4, 3), 2.0))
    assert sh.get_abstract_mesh() is None


def test_parallelism_mode_is_checked():
    with pytest.raises(ValueError, match="tp"):
        sh.set_parallelism("dp")
    assert sh.get_parallelism() == "tp"

