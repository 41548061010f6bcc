"""The production-mesh dry run (``repro_torch/launch/dryrun.py``), its
op-level counts (``launch/op_analysis.py``) and attribution
(``launch/attribution.py``), in this one process on a fake 256- or
512-rank world, against the reference's dry-run arithmetic.

The reference's ``repro/launch/dryrun.py`` sets a 512-device XLA flag on
import for its own process; JAX's backend is brought up here first, so the
flag changes nothing in this one, and the variable is restored.

The cells: Qwen2-0.5B ``train_4k`` at the full config (its per-rank
argument bytes, parameters and moments against the reference's spec
arithmetic, and against its recorded cell), a full-config decode cell,
the local shard shape of every parameter, moment and cache leaf of every
arch's full config on both production meshes against the reference's
``param_specs``, ``opt_specs_from`` and ``cache_specs``, the recurrent and
encoder-decoder families' full-config decode cells,
reduced configs across both meshes, the op counter's FLOPs and bytes, and
the attribution of a collective.
"""
import dataclasses
import json
import os

import jax

jax.devices()   # the backend is up before the reference's dry-run module loads
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models.lm import build_model as jbuild_model  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import SHAPES, ShapeSpec, get_config, reduced  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import attribution, dryrun, op_analysis  # noqa: E402
from repro_torch.launch.mesh import fake_production_mesh  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
PLACED = ["llama3-8b", "qwen2-0.5b", "yi-9b", "codeqwen1.5-7b", "llava-next-mistral-7b",
          "dbrx-132b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b", "xlstm-125m",
          "whisper-large-v3"]
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
REPORT_KEYS = {"arch", "shape", "mesh", "chips", "flops", "bytes_accessed", "collectives",
               "memory", "roofline"}


@pytest.fixture(autouse=True)
def _no_world():
    """Each test starts and ends with no process group (the fake world is
    made and destroyed inside), and in the ``tp`` mode."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()
    sh.set_parallelism("tp")


def _ref_specs(arch, shape, multi_pod, mode):
    """The reference's specs of the cell's state, on the production mesh's
    axes: ``(params, moments or None, cache or None)`` leaf lists of
    ``(shape, spec, itemsize)``."""
    jcfg = jget_config(arch)
    jm = jbuild_model(jcfg)
    sizes, names = MESHES[multi_pod]
    jmesh = jsh.abstract_mesh(sizes, names)
    prev = jax.sharding.get_abstract_mesh
    jax.sharding.get_abstract_mesh = lambda: jmesh
    jsh.set_parallelism(mode)
    try:
        tc = jts.TrainConfig(optimizer=JAdamWConfig(moment_dtype=dryrun.moment_dtype(arch, jcfg)))
        jp, jo = jts.abstract_train_state(jm, tc)
        p_specs = jsh.param_specs(jp, jcfg.fsdp)
        is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa: E731
        flat = lambda tree, specs: list(zip(  # noqa: E731
            jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(specs, is_leaf=is_spec)))
        params = flat(jp, p_specs)
        moments = cache = None
        if shape.kind == "train":
            o_specs = jdry.opt_specs_from(p_specs, jo)
            moments = flat(jo["m"], o_specs["m"]) + flat(jo["v"], o_specs["v"])
        if shape.kind == "decode":
            jc = jm.init_cache(shape.global_batch, shape.seq_len, abstract=True)
            cache = flat(jc, jdry.cache_specs(jcfg, jc, shape))
    finally:
        jax.sharding.get_abstract_mesh = prev
        jsh.set_parallelism("tp")
    return params, moments, cache


def _shard(leaf, spec, multi_pod):
    sizes = dict(zip(MESHES[multi_pod][1], MESHES[multi_pod][0]))
    out = []
    for i, n in enumerate(leaf.shape):
        e = spec[i] if i < len(spec) else None
        axes = e if isinstance(e, tuple) else ((e,) if e else ())
        out.append(n // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


def _ref_bytes(leaves, multi_pod):
    return sum(int(np.prod(_shard(leaf, spec, multi_pod))) * leaf.dtype.itemsize
               for leaf, spec in leaves)


# --------------------------------------------------------- full cells

def test_qwen_train_cell_has_the_references_per_rank_bytes():
    """``dryrun_cell("qwen2-0.5b", "train_4k")`` at the full config on the
    256-rank mesh: the reference's report keys; per-rank parameter and
    optimizer bytes equal to the reference's spec arithmetic exactly; the
    argument bytes equal to that plus the split batch, and to the
    reference's recorded cell, as are its FLOPs a rank."""
    rep = dryrun.dryrun_cell("qwen2-0.5b", "train_4k", multi_pod=False, verbose=False)
    assert REPORT_KEYS <= set(rep)
    assert rep["mesh"] == "16x16" and rep["chips"] == 256 and rep["mode"] == "fsdp"
    assert set(rep["collectives"]) == set(op_analysis.COLLECTIVES) | {"count", "total"}
    assert {"compute_s", "memory_s", "collective_s", "dominant"} <= set(rep["roofline"])
    params, moments, _ = _ref_specs("qwen2-0.5b", SHAPES["train_4k"], False, "fsdp")
    mem = rep["memory"]
    assert mem["parameter_size_in_bytes"] == _ref_bytes(params, False)
    assert mem["optimizer_size_in_bytes"] == _ref_bytes(moments, False) + 4   # + count
    batch = 2 * 4096 * 4   # tokens and targets of one sequence, int32
    assert mem["argument_size_in_bytes"] == (mem["parameter_size_in_bytes"]
                                             + mem["optimizer_size_in_bytes"] + batch)
    with open(os.path.join(ROOT, "experiments", "dryrun", "qwen2-0.5b_train_4k_256.json")) as f:
        recorded = json.load(f)
    assert mem["argument_size_in_bytes"] == recorded["memory"]["argument_size_in_bytes"]
    assert rep["flops"] == recorded["flops"]
    assert rep["collectives"]["count"] > 0 and rep["collectives"]["all-gather"] > 0


def test_llama_decode_cell_places_the_cache_by_sequence():
    """A full-config decode cell: Llama-3-8B ``decode_32k`` on the 256-rank
    mesh in its serving mode; its cache bytes a rank are the reference's
    ``cache_specs`` arithmetic (batch over data, sequence over model) and
    the combine's collectives are counted."""
    rep = dryrun.dryrun_cell("llama3-8b", "decode_32k", multi_pod=False, verbose=False)
    assert REPORT_KEYS <= set(rep) and rep["mode"] == "tp"
    params, _, cache = _ref_specs("llama3-8b", SHAPES["decode_32k"], False, "tp")
    assert rep["memory"]["cache_size_in_bytes"] == _ref_bytes(cache, False)
    assert rep["memory"]["parameter_size_in_bytes"] == _ref_bytes(params, False)
    assert rep["collectives"]["all-reduce"] > 0 and rep["flops"] > 0


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m", "whisper-large-v3"])
def test_recurrent_and_encoder_decoder_families_are_traced(arch):
    """Jamba's, xLSTM's and Whisper's full-config decode cells are traced
    placed (their mixers and the encoder-decoder run on the mesh), their
    cache bytes a rank the reference's ``cache_specs`` arithmetic; a
    full-attention arch's ``long_500k`` is still skipped."""
    rep = dryrun.dryrun_cell(arch, "decode_32k", multi_pod=False, verbose=False)
    assert "skipped" not in rep and REPORT_KEYS <= set(rep) and rep["mode"] == "tp"
    _, _, cache = _ref_specs(arch, SHAPES["decode_32k"], False, "tp")
    assert rep["memory"]["cache_size_in_bytes"] == _ref_bytes(cache, False)
    assert rep["flops"] > 0 and rep["collectives"]["all-reduce"] > 0
    rep = dryrun.dryrun_cell("llama3-8b", "long_500k", multi_pod=False, verbose=False)
    assert "sub-quadratic" in rep["skipped"]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", PLACED)
def test_full_config_shard_shapes_are_the_references(arch, multi_pod):
    """Every parameter, moment (``train_4k``'s mode) and cache
    (``decode_32k``'s) leaf of the full config, placed on the fake
    production mesh: this rank's local shape is the reference's shard
    shape."""
    cfg = get_config(arch)
    for name in ("train_4k", "decode_32k"):
        shape = SHAPES[name]
        with fake_production_mesh(multi_pod=multi_pod) as mesh, torch.device("meta"):
            with sh.use_mesh(mesh):
                mode, params, opt, cache, _ = dryrun.placed_state(cfg, shape, mesh, arch)
            got_p = sh.local_shapes(params)
            got_o = sh.local_shapes(opt["m"]) + sh.local_shapes(opt["v"]) if opt else None
            got_c = sh.local_shapes(cache) if cache is not None else None
        sh.set_parallelism("tp")
        ref_p, ref_o, ref_c = _ref_specs(arch, shape, multi_pod, mode)
        assert got_p == [_shard(leaf, s, multi_pod) for leaf, s in ref_p], (name, mode)
        if ref_o is not None:
            assert got_o == [_shard(leaf, s, multi_pod) for leaf, s in ref_o], (name, mode)
        if ref_c is not None:
            assert got_c == [_shard(leaf, s, multi_pod) for leaf, s in ref_c], (name, mode)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", PLACED)
def test_reduced_configs_run_on_both_meshes(arch, multi_pod):
    """A reduced config's train and decode cells on each production mesh
    (widths the meshes do not divide stay whole): the step traces and the
    report is whole."""
    cfg = reduced(get_config(arch))
    for shape in (ShapeSpec("train_small", 64, 256, "train"),
                  ShapeSpec("decode_small", 256, 128, "decode")):
        rep = dryrun.dryrun_cell(arch, shape.name, multi_pod=multi_pod, verbose=False,
                                 cfg=cfg, shape=shape)
        assert REPORT_KEYS <= set(rep) and rep["chips"] == (512 if multi_pod else 256)
        assert rep["flops"] > 0 and rep["memory"]["argument_size_in_bytes"] > 0


# ------------------------------------------------------------ op counts

def test_matmul_and_conv_flops():
    """tests/test_hlo_analysis.py's idea: a dot's FLOPs are 2 M N K, a
    convolution's 2 x output elements x its kernel's taps x input channels
    a group."""
    a, b = torch.zeros(8, 32), torch.zeros(32, 16)
    assert op_analysis.analyze(torch.matmul, a, b)["flops"] == 2 * 8 * 16 * 32
    x, w = torch.zeros(2, 6, 10, 10), torch.zeros(4, 3, 3, 3)
    rep = op_analysis.analyze(lambda: torch.nn.functional.conv2d(x, w, groups=2))
    assert rep["flops"] == 2 * (2 * 4 * 8 * 8) * (3 * 3 * 3)


def test_a_looped_attention_counts_the_sum_of_its_tiles():
    """The chunked attention walks its 4 x 4 tiles in Python: the count is
    the sum over tiles, the direct attention's QK and PV FLOPs (the
    reference resolves its scan's trip counts to the same sum)."""
    from repro_torch.models.layers import _chunked_attention, _direct_attention

    B, S, H, hd = 1, 64, 2, 8
    q = k = v = torch.zeros(B, S, H, hd)
    pos = torch.arange(S)
    want = 2 * (2 * B * H * S * S * hd)
    chunked = op_analysis.analyze(_chunked_attention, q, k, v, causal=True,
                                  q_positions=pos, chunk=16)
    direct = op_analysis.analyze(_direct_attention, q, k, v, causal=True, q_positions=pos)
    assert chunked["flops"] == direct["flops"] == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bytes_are_operands_plus_result_a_dtype(dtype):
    """An elementwise op moves its two operands and its result; a view
    moves nothing."""
    a, b = torch.zeros(4, 8, dtype=dtype), torch.zeros(4, 8, dtype=dtype)
    assert op_analysis.analyze(torch.add, a, b)["bytes"] == 3 * 32 * a.element_size()
    assert op_analysis.analyze(lambda: a.reshape(8, 4).t())["bytes"] == 0


def test_attribution_parses_collectives():
    """tests/test_parallelism_modes.py::test_attribution_parses_collectives:
    one all-reduce of f32[16, 16] is one site of 16 * 16 * 4 * 2 wire bytes,
    seen once, named by the function that issued it."""
    import torch.distributed._functional_collectives as funcol

    def psum(x, group):
        return funcol.all_reduce(x, "sum", group)

    with fake_production_mesh() as mesh:
        with op_analysis.OpCounter() as counter:
            funcol.wait_tensor(psum(torch.zeros(16, 16), mesh.get_group("model")))
    items = attribution.collective_items(counter)
    assert len(items) == 1
    bytes_, op, _, mult, name = items[0]
    assert op == "all-reduce" and bytes_ == 16 * 16 * 4 * 2 and mult == 1
    assert counter.report()["collectives"]["all-reduce"] == bytes_
    assert "test_torch_dryrun" not in name   # a frame of the package, or none
    assert "GB" in attribution.report(counter)


def test_dry_run_cli_writes_a_report(tmp_path, capsys):
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k", "--out", str(tmp_path)])
    rep = json.loads((tmp_path / "qwen2-0.5b_long_500k_256.json").read_text())
    assert "sub-quadratic" in rep["skipped"]
    assert "all requested dry-run cells passed" in capsys.readouterr().out


def test_reduced_config_through_cfg_and_extra_flags():
    cfg = reduced(get_config("qwen2-0.5b"))
    shape = ShapeSpec("prefill_small", 64, 32, "prefill")
    rep = dryrun.dryrun_cell("qwen2-0.5b", shape.name, multi_pod=False, verbose=False,
                             cfg=dataclasses.replace(cfg, n_layers=1), shape=shape)
    assert rep["mode"] == "tp" and rep["flops"] > 0


def test_mesh_groups_are_cached_per_mesh_object():
    """Two fake worlds in turn give meshes of one layout, which compare
    equal: each mesh's cached groups must be its own world's (a group of
    the destroyed world is not registered in the next one)."""
    with fake_production_mesh() as first:
        old, _ = sh.mesh_group(first, ("data", "model"))
    with fake_production_mesh() as second:
        assert second == first
        group, rank = sh.mesh_group(second, ("data", "model"))
        assert group is not old and dist.get_rank(group) == rank == 0
