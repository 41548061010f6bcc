"""Guards of the port: it imports no JAX and nothing of the JAX package, and
its entry points run on the card unless told otherwise."""
import os
import pkgutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticImages, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.launch.train import main as train_main
from repro_torch.models import gan
from repro_torch.models.lm import build_model
from repro_torch.serve import GanEngine, Replica, ReplicaSupervisor, ServeEngine
from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
from repro_torch.train.train_step import TrainConfig, init_train_state
from repro_torch.tree import tree_map
from repro_torch.weights import from_jax_lm_params, from_jax_params, from_jax_state

ROOT = os.path.join(os.path.dirname(__file__), "..")
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
EXAMPLES = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                  if f.startswith("torch_") and f.endswith(".py"))


def test_port_imports_without_jax_or_reference():
    """Every port module, chip_smoke.py and the port's examples import with
    ``jax`` and ``ml_dtypes`` blocked and load no ``repro`` module (the
    distribution and launch modules among them)."""
    assert {"repro_torch.distributed.collectives", "repro_torch.distributed.sharding",
            "repro_torch.launch.mesh", "repro_torch.launch.roofline",
            "repro_torch.launch.dryrun", "repro_torch.launch.op_analysis",
            "repro_torch.launch.attribution"} <= set(MODULES)
    code = (
        "import importlib, importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"for name in {MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        f"for name in {EXAMPLES!r}:\n"
        "    spec = importlib.util.spec_from_file_location(name[:-3], 'examples/' + name)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_examples_import_neither_jax_nor_the_reference():
    """The port's examples import what they run inside ``main``: no line
    of theirs imports ``jax`` or a ``repro`` module."""
    import re

    assert EXAMPLES == ["torch_quickstart.py", "torch_serve_gan.py",
                        "torch_serve_lm.py", "torch_train_dcgan.py",
                        "torch_train_lm.py"]
    for name in EXAMPLES:
        with open(os.path.join(ROOT, "examples", name)) as f:
            text = f.read()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|repro)\b",
                             text, re.M), name
        assert "repro_torch" in text and "def main(argv=None)" in text, name


def test_cuda_sources_use_no_atomics():
    """No hand-written kernel calls an atomic: every sum runs in an order
    fixed by the layer's shape, which the bitwise served-output and resume
    checks rely on."""
    import re
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    sources = sorted(f for f in os.listdir(csrc) if f.endswith((".cu", ".cuh")))
    assert len(sources) >= 7
    for name in sources:
        text = open(os.path.join(csrc, name)).read()
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
        assert not re.search(r"\batomic\w*\s*\(|\bred\.\w+", code), name


def test_module_list_covers_the_slice():
    for name in ("core.segregation", "core.transpose_conv", "kernels.ref",
                 "kernels.epilogue", "kernels._build", "kernels.plan",
                 "kernels.transpose_conv2d", "kernels.transpose_conv2d_gemm",
                 "kernels.transpose_conv2d_bwd", "kernels.ops",
                 "kernels.transpose_conv2d_pair", "kernels.plan_registry",
                 "kernels.project",
                 "models.layers", "models.gan", "serve.batching",
                 "serve.metrics", "serve.gan_engine", "timing", "weights",
                 "tree", "optim.adamw", "optim.compression", "data.pipeline",
                 "distributed.fault_tolerance", "train.checkpoint",
                 "train.gan_trainer", "configs.base", "configs.registry",
                 "configs.llama3_8b", "configs.qwen2_0_5b", "configs.yi_9b",
                 "configs.codeqwen1_5_7b", "kernels.decode_attention",
                 "models.lm", "serve.engine", "obs", "obs.trace",
                 "obs.timeline", "obs.export", "obs.flight_recorder",
                 "obs.audit", "obs.__main__", "serve.replica",
                 "serve.supervisor", "serve.fault_injection",
                 "train.fault_injection", "kernels.autotune",
                 "optim.schedule", "train.train_step", "train.trainer", "launch",
                 "launch.train", "launch.dryrun", "launch.op_analysis",
                 "launch.attribution", "models.ssm", "models.xlstm", "models.encdec",
                 "configs.dbrx_132b", "configs.jamba_1_5_large_398b",
                 "configs.kimi_k2_1t_a32b", "configs.xlstm_125m",
                 "configs.whisper_large_v3", "configs.llava_next_mistral_7b"):
        assert f"repro_torch.{name}" in MODULES


def _example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry_points(cfg, params_cpu):
    z = np.zeros((1, cfg.z_dim), np.float32)
    np_params = {k: {n: t.numpy() for n, t in v.items()}
                 for k, v in params_cpu.items()}
    data = SyntheticImages(64, cfg.layers[-1][2], 1, device="cpu")
    lm_cfg = reduced(get_config("llama3-8b"))
    lm = build_model(lm_cfg)
    lm_cpu = lm.init(torch.Generator().manual_seed(0), device="cpu")
    lm_np = tree_map(lambda t: t.float().numpy(), lm_cpu)
    encdec = build_model(reduced(get_config("whisper-large-v3")))
    return {
        "resolve_device": lambda: resolve_device(None),
        "GanEngine": lambda: GanEngine(),
        "Replica": lambda: Replica("r0"),
        # the replica on the card where there is one; the supervisor's own
        # device is its default
        "ReplicaSupervisor": lambda: ReplicaSupervisor([Replica(
            "r0", device="cuda" if torch.cuda.is_available() else "cpu")]),
        "generator_init": lambda: gan.generator_init(
            torch.Generator().manual_seed(0), cfg),
        "generator_apply": lambda: gan.generator_apply(params_cpu, cfg, z),
        "from_jax_params": lambda: from_jax_params(np_params, cfg, None),
        "discriminator_init": lambda: gan.discriminator_init(
            torch.Generator().manual_seed(0), 64, 3),
        "SyntheticImages": lambda: SyntheticImages(64, 3, 1),
        "GanTrainer": lambda: GanTrainer(cfg, GanTrainerConfig(global_batch=1),
                                         data),
        "from_jax_state": lambda: from_jax_state(
            {"g_params": np_params, "d_params": {}, "g_opt": {}, "d_opt": {}},
            cfg, None),
        "LM.init": lambda: lm.init(torch.Generator().manual_seed(0)),
        "LM.init_cache": lambda: lm.init_cache(2, 8),
        "EncDecLM.init": lambda: encdec.init(torch.Generator().manual_seed(0)),
        "EncDecLM.init_cache": lambda: encdec.init_cache(2, 8),
        "torch_train_lm": lambda: _example("torch_train_lm").main(
            ["--steps", "1", "--batch", "1", "--seq", "8",
             "--ckpt-dir", tempfile.mkdtemp()]),
        "ServeEngine": lambda: ServeEngine(lm, lm_cpu),
        "from_jax_lm_params": lambda: from_jax_lm_params(lm_np, lm_cfg, None),
        "SyntheticTokens": lambda: SyntheticTokens(8, 4, 1),
        "init_train_state": lambda: init_train_state(
            lm, torch.Generator().manual_seed(0), TrainConfig()),
        "launch.train": lambda: train_main(["--arch", "qwen2-0.5b", "--reduced",
                                            "--steps", "1", "--batch", "1",
                                            "--seq", "8"]),
        "tune_layer": lambda: autotune.tune_layer(1, 4, 4, 8, 6, 2, repeats=1,
                                                  persist=False),
        "tune_pair": lambda: autotune.tune_pair(
            1, 4, 4, 8, 6, 4, 2, repeats=1, persist=False,
            epilogue1=Epilogue(bias=True, act="relu"),
            epilogue2=Epilogue(bias=True, act="tanh")),
    }


@pytest.mark.parametrize("entry", ["resolve_device", "GanEngine", "Replica",
                                   "ReplicaSupervisor",
                                   "generator_init", "generator_apply",
                                   "from_jax_params", "discriminator_init",
                                   "SyntheticImages", "GanTrainer",
                                   "from_jax_state", "LM.init", "LM.init_cache",
                                   "EncDecLM.init", "EncDecLM.init_cache",
                                   "torch_train_lm", "ServeEngine",
                                   "from_jax_lm_params", "tune_layer",
                                   "tune_pair", "SyntheticTokens",
                                   "init_train_state", "launch.train"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=`` an entry point runs on the card; with no card it
    raises instead of falling back to the CPU."""
    cfg = gan.reduced_config(gan.DCGAN, 16)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    fn = _entry_points(cfg, params)[entry]
    if torch.cuda.is_available():
        if entry in ("generator_apply", "ServeEngine"):   # CPU params, card by default
            with pytest.raises(ValueError, match="params live on"):
                fn()
        else:
            fn()
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_the_dry_run_runs_on_no_device(monkeypatch):
    """The dry run is exempt from "on the card unless asked": it places
    and traces meta tensors on a fake world in this process, so it runs on
    no device at all: it names the meta device where it builds a tensor and
    never asks for the default one (the card)."""
    import torch.distributed as dist

    from repro_torch import device as device_mod
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models import lm

    resolve = device_mod.resolve_device

    def refuse(device=None):
        if device is None:
            raise AssertionError("the dry run asked for the default device")
        return resolve(device)

    monkeypatch.setattr(device_mod, "resolve_device", refuse)
    monkeypatch.setattr(lm, "resolve_device", refuse)
    shape = ShapeSpec("decode_small", 128, 16, "decode")
    rep = dryrun.dryrun_cell("llama3-8b", shape.name, multi_pod=False, verbose=False,
                             cfg=reduced(get_config("llama3-8b")), shape=shape)
    assert rep["chips"] == 256 and rep["flops"] > 0
    assert not dist.is_initialized()


def test_timing_refuses_cpu_tensors():
    from repro_torch.timing import time_cuda

    with pytest.raises(ValueError, match="card"):
        time_cuda(torch.relu, torch.zeros(2))


def test_build_raises_without_nvcc(monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line when CUDA
    is absent, and likewise when it stands alone without the repository."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for script in (os.path.join(ROOT, "chip_smoke.py"), str(alone)):
        res = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=120, cwd=os.path.dirname(script))
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def _c_entry_points(source: str) -> dict:
    """``{name: [ctypes type, ...]}`` of the ``extern "C"`` functions of a
    CUDA source, from their parameter lists."""
    import ctypes
    import re

    text = re.sub(r"//[^\n]*", "", source)
    kinds = {"float": ctypes.c_float, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    out = {}
    for m in re.finditer(r"\bint\s+((?:tconv|decode|project|rgb)_\w+)\s*\(([^)]*)\)\s*\{", text):
        params = [p.strip() for p in m.group(2).split(",")]
        out[m.group(1)] = [
            ctypes.c_void_p if "*" in p
            else kinds[" ".join(p.replace("const ", "").split()[:-1])]
            for p in params]
    return out


def test_ctypes_argtypes_match_the_c_signatures(monkeypatch):
    """Every kernel library's ``argtypes`` list the C parameters one for one
    (a missing int shifts every later argument; a pointer passed as an int
    is cut to 32 bits)."""
    import importlib
    import types

    from repro_torch.kernels import _build

    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    signatures = {}
    for name in os.listdir(csrc):
        if name.endswith(".cu"):
            with open(os.path.join(csrc, name)) as f:
                signatures.update(_c_entry_points(f.read()))

    class FakeLib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, types.SimpleNamespace())

    libs = []

    def load(name):
        libs.append(FakeLib())
        return libs[-1]

    monkeypatch.setattr(_build, "load", load)
    for mod, loaders in (("transpose_conv2d", ("_lib", "_phase_lib")),
                         ("transpose_conv2d_gemm", ("_lib",)),
                         ("transpose_conv2d_bwd", ("_lib",)),
                         ("transpose_conv2d_pair", ("_lib",)),
                         ("decode_attention", ("_lib",)),
                         ("project", ("_lib",)),
                         ("rgb_head", ("_lib",))):
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        for loader in loaders:
            fn = getattr(m, loader)
            fn.cache_clear()
            try:
                fn()
            finally:
                fn.cache_clear()
    bound = {name: list(f.argtypes) for lib in libs for name, f in lib.fns.items()}
    assert set(bound) == set(signatures)
    for name, want in signatures.items():
        assert bound[name] == want, name
