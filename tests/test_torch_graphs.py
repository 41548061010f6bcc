"""CUDA graphs of the port (repro_torch.graphs), on the CPU: the launch
accounting on fake counters, the refusal to build a graph anywhere but on
a card, the check that a graph is called over the objects it captured, the
list of the fourteen kernel wrappers, and the engines' and the trainer's CPU
paths, which stay eager. The card's side -- graph replays bitwise equal to
eager calls, counters counting replays, buffer lifetimes, a failed capture
raising -- is in tests/test_torch_cuda.py.

    PYTHONPATH=src python -m pytest -q tests/test_torch_graphs.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import graphs
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticImages
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import project as proj
from repro_torch.kernels import rgb_head as head
from repro_torch.kernels import transpose_conv2d as tcf
from repro_torch.kernels import transpose_conv2d_bwd as bw
from repro_torch.kernels import transpose_conv2d_gemm as tcg
from repro_torch.kernels import transpose_conv2d_pair as tcp
from repro_torch.kernels import wrappers
from repro_torch.models import gan
from repro_torch.models.lm import build_model
from repro_torch.serve import BucketPolicy, GanEngine, ServeEngine
from repro_torch.serve.gan_engine import generator_executable, sequential_executables
from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
from repro_torch.tree import tree_leaves, tree_map

TINY = gan.reduced_config(gan.DCGAN, 32)


def _fake_wrapper(launches, reduce_launches=None, per_call=(1, 1)):
    """A stand-in for a kernel wrapper: each call adds ``per_call`` to its
    counters, as a wrapper does when it launches."""
    def fn():
        fn.launches += per_call[0]
        if hasattr(fn, "reduce_launches"):
            fn.reduce_launches += per_call[1]
    fn.launches = launches
    if reduce_launches is not None:
        fn.reduce_launches = reduce_launches
    return fn


def test_launch_counters_take_back_the_capture_and_add_it_per_replay():
    split = _fake_wrapper(5, 2)
    pair = _fake_wrapper(7, per_call=(2, 0))
    idle = _fake_wrapper(3, 0)
    counters = graphs.LaunchCounters([split, pair, idle])
    assert counters.read() == [5, 2, 7, 3, 0]

    def capture():   # a step that calls two wrappers, one of them twice
        split()
        pair()
        split()
        return "outputs"

    delta, out = counters.uncounted(capture)
    assert out == "outputs"
    assert delta == [2, 2, 2, 0, 0]
    assert counters.read() == [5, 2, 7, 3, 0]   # the capture launched nothing
    for _ in range(3):                          # three replays
        counters.add(delta)
    assert counters.read() == [11, 8, 13, 3, 0]
    split()                                     # an eager call still counts
    assert (split.launches, split.reduce_launches) == (12, 9)


def test_launch_counters_count_from_a_reset():
    fn = _fake_wrapper(0, 0)
    counters = graphs.LaunchCounters([fn])
    delta, _ = counters.uncounted(fn)
    fn.launches = fn.reduce_launches = 0        # a caller resets the counts
    counters.add(delta)
    counters.add(delta)
    assert counters.read() == [2, 2]


def test_wrapper_list_names_the_eight_kernels_and_their_counters():
    got = wrappers()
    assert got == {
        "fused": tcf.transpose_conv2d_fused, "gemm": tcg.transpose_conv2d_gemm,
        "pair": tcp.transpose_conv2d_pair, "phase": tcf.transpose_conv2d_phase,
        "epilogue_grad": bw.epilogue_grad, "dx": bw.transpose_conv2d_dx,
        "dw": bw.transpose_conv2d_dw, "decode_attention": da.decode_attention,
        "project": proj.project_relu_fwd, "project_dw": proj.project_relu_dw,
        "project_dz": proj.project_relu_dz, "rgb_head": head.rgb_head_fwd,
        "rgb_head_dx": head.rgb_head_dx, "rgb_head_dw": head.rgb_head_dw,
    }
    with_reduce = {name for name, fn in got.items() if hasattr(fn, "reduce_launches")}
    assert with_reduce == {"fused", "gemm", "phase", "dx", "dw", "decode_attention",
                           "rgb_head_dw"}
    slots = graphs.kernel_counters().slots
    # fourteen launch counts, seven reduce counts, and the epilogue-grad
    # launches folded into dx and dw
    assert len(slots) == 14 + 7 + 1
    assert (bw.epilogue_grad, "folded_launches") in slots
    assert all(isinstance(getattr(fn, name), int) for fn, name in slots)


@pytest.mark.parametrize("inputs", [
    (torch.zeros(3),),
    ({"a": torch.zeros(2), "b": [torch.ones(1)]}, torch.zeros(4)),
    (),
], ids=["tensor", "tree", "none"])
def test_cuda_graph_refuses_the_cpu_without_running(inputs):
    calls = []
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.CudaGraph(lambda *a: calls.append(a), *inputs)
    assert calls == []


def test_require_captured_takes_only_the_captured_object():
    params = gan.generator_init(torch.Generator().manual_seed(0), TINY, device="cpu")
    graphs.require_captured(params, params, "params")
    same_tensors = dict(params)
    with pytest.raises(ValueError, match="captured over its own params"):
        graphs.require_captured(same_tensors, params, "params")
    with pytest.raises(ValueError, match="KV cache"):
        graphs.require_captured([], params, "KV cache")


def test_cpu_generator_executables_stay_eager():
    params = gan.generator_init(torch.Generator().manual_seed(0), TINY, device="cpu")
    other = gan.generator_init(torch.Generator().manual_seed(1), TINY, device="cpu")
    plan = gan.generator_plan(TINY, 2)
    fn = generator_executable(params, TINY, plan, 2, torch.device("cpu"))
    assert not hasattr(fn, "graph")
    z = np.random.default_rng(0).standard_normal((2, TINY.z_dim)).astype(np.float32)
    for p in (params, other):   # the CPU path takes any parameters, as before
        want = gan.generator_apply(p, TINY, z, plan=plan, device="cpu")
        assert torch.equal(fn(p, z), want)
    seq = sequential_executables(TINY, params, [1, 3], device="cpu")
    assert not any(hasattr(f, "graph") for f in seq.values())

    eng = GanEngine(BucketPolicy(buckets=(1, 2)), device="cpu")
    eng.register(TINY, params)
    eng.warmup()
    slot = eng.registry[TINY.name]
    assert slot.pool is None
    assert not any(hasattr(f, "graph") for f in slot.apply.values())
    assert eng.metrics.recompiles == 2


def test_cpu_decode_step_stays_eager():
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")), dtype="float32",
                              remat=False)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(model, params, slots=2, max_len=16, device="cpu")
    assert eng._decode == model.decode_step


def _trainer(cfg=TINY, batch=2):
    tcfg = GanTrainerConfig(global_batch=batch)
    data = SyntheticImages(hw=cfg.out_hw(cfg.layers[-1][0]),
                           channels=cfg.layers[-1][2], global_batch=batch,
                           device="cpu")
    return GanTrainer(cfg, tcfg, data, log_fn=lambda *a: None, device="cpu")


def test_cpu_trainer_step_is_the_eager_step_behind_the_guard():
    tr = _trainer()
    state = tr.init_state(torch.Generator().manual_seed(1))
    before = tree_map(torch.clone, state)
    reals, zs = tr._batches(0)
    want, stats = tr._step_eager(state, reals, zs)
    assert stats.shape == (4,) and stats.device.type == "cpu"
    got, metrics = tr._step_fn(state, reals, zs)
    assert [metrics[k] for k in ("g_loss", "d_loss", "g_gnorm", "d_gnorm")] \
        == stats.tolist()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    # the step wrote into neither its input state nor any buffer of its own
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), tree_leaves(before)))
    assert tr._graph is None
