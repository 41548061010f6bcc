"""Guards of the port: it imports no JAX and nothing of the JAX package, and
its entry points run on the card unless told otherwise."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.data import SyntheticImages
from repro_torch.device import resolve_device
from repro_torch.models import gan
from repro_torch.serve import GanEngine
from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
from repro_torch.weights import from_jax_params, from_jax_state

ROOT = os.path.join(os.path.dirname(__file__), "..")
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))


def test_port_imports_without_jax_or_reference():
    """Every port module, and chip_smoke.py, imports with ``jax`` and
    ``ml_dtypes`` blocked and loads no ``repro`` module."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"for name in {MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
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


def test_module_list_covers_the_slice():
    for name in ("core.segregation", "core.transpose_conv", "kernels.ref",
                 "kernels.epilogue", "kernels._build", "kernels.plan",
                 "kernels.transpose_conv2d", "kernels.transpose_conv2d_gemm",
                 "kernels.transpose_conv2d_bwd", "kernels.ops",
                 "models.layers", "models.gan", "serve.batching",
                 "serve.metrics", "serve.gan_engine", "timing", "weights",
                 "tree", "optim.adamw", "optim.compression", "data.pipeline",
                 "distributed.fault_tolerance", "train.checkpoint",
                 "train.gan_trainer"):
        assert f"repro_torch.{name}" in MODULES


def _entry_points(cfg, params_cpu):
    z = np.zeros((1, cfg.z_dim), np.float32)
    np_params = {k: {n: t.numpy() for n, t in v.items()}
                 for k, v in params_cpu.items()}
    data = SyntheticImages(64, cfg.layers[-1][2], 1, device="cpu")
    return {
        "resolve_device": lambda: resolve_device(None),
        "GanEngine": lambda: GanEngine(),
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
    }


@pytest.mark.parametrize("entry", ["resolve_device", "GanEngine",
                                   "generator_init", "generator_apply",
                                   "from_jax_params", "discriminator_init",
                                   "SyntheticImages", "GanTrainer",
                                   "from_jax_state"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=`` an entry point runs on the card; with no card it
    raises instead of falling back to the CPU."""
    cfg = gan.reduced_config(gan.DCGAN, 16)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    fn = _entry_points(cfg, params)[entry]
    if torch.cuda.is_available():
        if entry == "generator_apply":   # CPU params, card by default
            with pytest.raises(ValueError, match="params live on"):
                fn()
        else:
            fn()
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


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
