"""Port of the autotuner (repro_torch.kernels.autotune) and its tuned
``auto`` dispatch, on the CPU.

The tests of ``tests/test_autotune.py`` through the port's API: the cache's
round trip, v1-v3 migration, prune, foreign versions and set-aside
records, a corrupt file, the key formats, ``tune_layer`` with and without
``train``, ``auto`` following the cache, a retune resolving the memoized
plan again, the proxies, the pair direction and the CLI. On the CPU the
kernels run their plain versions and race by proxy only; the tests that
drive a kernel's race (the reference's two that fail on ``pl.unblocked``
among them) turn the card's race on with ``_times_kernels`` and hold the
kernel to its plain version.

Then the bucket rule (a serving consult reads no batch; it weights the
recorded batches by the cache's bucket histogram, or sums them and keeps
the cold method where the sum winner loses the largest batch; a
batch-variant candidate, checked at batch 1 on a stacked batch, never wins
the forward), ``fuse="auto"``, ``bwd="auto"`` and ``fused+postops`` (raced,
never dispatched); and the port against the reference: keys equal but for
the backend field, a shared file serving neither package the other's
records, the same winners resolving the same plans, and one CPU race's
records having the same fields.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.kernels.epilogue import Epilogue as JEpilogue
from repro.models import gan as jgan
from repro_torch.core import transpose_conv as tc
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import plan as planlib
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.kernels.ref import conventional_ref
from repro_torch.kernels.transpose_conv2d import (
    fused_geometry,
    transpose_conv2d_fused_plain,
)
from repro_torch.kernels.transpose_conv2d_gemm import gemm_geometry
from repro_torch.models import gan
from repro_torch.serve import BucketPolicy, GanEngine, GenRequest
from repro_torch.weights import from_jax_params

BASELINES = autotune.LAX_CANDIDATES


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path, monkeypatch):
    """Every test gets its own cache file (both packages read the same
    variable) and empty in-memory views."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.clear_cache(memory_only=True)
    jat.clear_cache(memory_only=True)
    yield
    autotune.clear_cache(memory_only=True)
    jat.clear_cache(memory_only=True)


def _xk(b=1, n=6, cin=2, cout=3):
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(b, n, n, cin)),
                        dtype=torch.float32)
    k = torch.as_tensor(np.random.default_rng(1).normal(size=(4, 4, cin, cout)),
                        dtype=torch.float32)
    return x, k


def _kernels_race(monkeypatch):
    """Race the kernels as on the card (their plain versions here)."""
    monkeypatch.setattr(autotune, "_times_kernels", lambda device: True)


# ------------------------------------------------------------ cache (v4)

def test_cache_roundtrip_persists_to_disk():
    key = autotune.layer_key(1, 8, 4, 16, 8, 2)
    assert key.startswith("torch_cpu|") and key.endswith("|e:none")
    autotune.record(key, {"method": "unified_reshape", "time_s": 1e-4,
                          "source": "measured"})
    autotune._STATE.update(mtime=-1.0, entries={})   # reload from the file
    entry = autotune.lookup(key)
    assert entry is not None and entry["fwd"]["method"] == "unified_reshape"
    assert autotune.best_method(1, 8, 4, 16, 8, 2)["method"] == "unified_reshape"
    blob = json.loads(autotune.cache_path().read_text())
    assert blob["version"] == 4 and key in blob["entries"]


def test_v1_cache_file_migrates_on_load():
    v1key = "torch_cpu|b1|n8|k4|ci16|co8|p2|float32"   # pre-epilogue key
    autotune.cache_path().parent.mkdir(parents=True, exist_ok=True)
    autotune.cache_path().write_text(json.dumps({
        "version": 1,
        "entries": {v1key: {"method": "unified_matmul", "time_s": 2e-4,
                            "source": "measured"}},
    }))
    assert autotune.best_method(1, 8, 4, 16, 8, 2)["method"] == "unified_matmul"
    assert autotune.best_bwd(1, 8, 4, 16, 8, 2) is None
    key = autotune.layer_key(1, 8, 4, 16, 8, 2)
    autotune.record(key, {"method": "autograd", "time_s": 1e-4,
                          "source": "measured"}, direction="bwd")
    blob = json.loads(autotune.cache_path().read_text())
    assert blob["version"] == 4
    assert blob["entries"][key]["fwd"]["method"] == "unified_matmul"
    assert blob["entries"][key]["bwd"]["method"] == "autograd"


def test_v2_cache_file_migrates_forward_keeping_tiles():
    """A v2 record's fields (tiles, or the port's summation_order) ride
    through the migration and the rewrite."""
    v2key = "torch_cpu|b1|n8|k4|ci16|co8|p2|float32"
    autotune.cache_path().parent.mkdir(parents=True, exist_ok=True)
    autotune.cache_path().write_text(json.dumps({
        "version": 2,
        "entries": {v2key: {
            "fwd": {"method": "fused", "time_s": 2e-4, "source": "measured",
                    "tile_h": 16, "summation_order": ["rich", 2, 1, 16, 1, 1]},
            "bwd": {"method": "segregated", "time_s": 1e-4,
                    "source": "measured", "tile_w": 64},
        }},
    }))
    rec = autotune.best_entry(1, 8, 4, 16, 8, 2)
    assert rec["fwd"]["tile_h"] == 16 and rec["fwd"]["summation_order"][0] == "rich"
    assert autotune.best_method(1, 8, 4, 16, 8, 2)["method"] == "fused"
    assert autotune.best_bwd(1, 8, 4, 16, 8, 2)["method"] == "segregated"
    autotune.record(autotune.layer_key(9, 9, 9, 9, 9, 9),
                    {"method": "conventional", "time_s": 1.0, "source": "t"})
    blob = json.loads(autotune.cache_path().read_text())
    assert blob["version"] == 4
    migrated = blob["entries"][autotune.layer_key(1, 8, 4, 16, 8, 2)]
    assert migrated["fwd"]["tile_h"] == 16
    assert migrated["bwd"]["tile_w"] == 64


def test_layer_key_includes_epilogue_signature():
    k_none = autotune.layer_key(1, 8, 4, 16, 8, 2)
    k_relu = autotune.layer_key(1, 8, 4, 16, 8, 2,
                                epilogue=Epilogue(bias=True, act="relu"))
    k_tanh = autotune.layer_key(1, 8, 4, 16, 8, 2,
                                epilogue=Epilogue(bias=True, act="tanh"))
    assert len({k_none, k_relu, k_tanh}) == 3
    assert k_relu.endswith("|e:b+relu") and k_tanh.endswith("|e:b+tanh")
    assert autotune.layer_key(1, 8, 4, 16, 8, 2, epilogue=Epilogue()) == k_none


def test_prune_drops_unparsable_keys_only():
    good = autotune.layer_key(1, 8, 4, 16, 8, 2)
    autotune.record(good, {"method": "unified_reshape", "time_s": 1e-4,
                           "source": "measured"})
    autotune.record("totally|not|a|layer", {"method": "conventional",
                                            "time_s": 0.0, "source": "t"})
    assert autotune.prune_cache() == ["totally|not|a|layer"]
    assert autotune.lookup(good) is not None
    assert autotune.lookup("totally|not|a|layer") is None
    blob = json.loads(autotune.cache_path().read_text())
    assert "totally|not|a|layer" not in blob["entries"]
    assert autotune.prune_cache() == []


def test_layer_key_includes_backend_and_dtype():
    k1 = autotune.layer_key(1, 8, 4, 16, 8, 2, "float32", backend="torch_cpu")
    k2 = autotune.layer_key(1, 8, 4, 16, 8, 2, torch.bfloat16, backend="torch_cpu")
    k3 = autotune.layer_key(1, 8, 4, 16, 8, 2, "float32", backend="torch_cuda")
    assert len({k1, k2, k3}) == 3
    assert "|bfloat16|" in k2
    assert autotune.backend_of("cpu") == "torch_cpu"
    assert autotune.backend_of("cuda") == "torch_cuda"


def test_foreign_cache_version_resets_in_memory_view():
    key = autotune.layer_key(1, 8, 4, 16, 8, 2)
    autotune.record(key, {"method": "unified_reshape", "time_s": 1e-4,
                          "source": "measured"})
    autotune.cache_path().write_text(json.dumps({"version": 99, "entries": {
        key: {"method": "conventional"}}}))
    assert autotune.lookup(key) is None


def test_foreign_cache_version_is_preserved_on_save():
    key = autotune.layer_key(1, 8, 4, 16, 8, 2)
    foreign = {"version": 99, "entries": {key: {"method": "conventional"}}}
    autotune.cache_path().parent.mkdir(parents=True, exist_ok=True)
    autotune.cache_path().write_text(json.dumps(foreign))
    autotune.record(key, {"method": "unified_reshape", "time_s": 1e-4,
                          "source": "measured"})
    assert json.loads(autotune.cache_path().read_text())["version"] == 4
    bak = autotune.cache_path().with_name(autotune.cache_path().name + ".v99.bak")
    assert json.loads(bak.read_text()) == foreign


def test_corrupt_cache_degrades_to_fallback():
    autotune.cache_path().parent.mkdir(parents=True, exist_ok=True)
    autotune.cache_path().write_text("{not json")
    assert autotune.best_method(1, 6, 4, 2, 3, 2) is None
    x, k = torch.ones((1, 6, 6, 2)), torch.ones((4, 4, 2, 3))
    lp = planlib.plan_layer(1, 6, 4, 2, 3, 2)
    assert (lp.method, lp.source) == (planlib.cold_method(6, 4, 2), "cold")
    np.testing.assert_allclose(tc.transpose_conv_auto(x, k, 2).numpy(),
                               conventional_ref(x, k, 2).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_unknown_winner_method_set_aside_not_clobbered():
    alien_key = autotune.layer_key(1, 4, 4, 8, 8, 2)
    good_key = autotune.layer_key(1, 8, 4, 16, 8, 2)
    alien_rec = {"fwd": {"method": "hyperwarp", "time_s": 1e-9,
                         "source": "measured", "warp_factor": 9}}
    autotune.cache_path().parent.mkdir(parents=True, exist_ok=True)
    autotune.cache_path().write_text(json.dumps({"version": 3, "entries": {
        alien_key: alien_rec,
        good_key: {"fwd": {"method": "unified_reshape", "time_s": 1e-4,
                           "source": "measured"}},
    }}))
    assert autotune.lookup(alien_key) is None
    assert autotune.best_method(1, 4, 4, 8, 8, 2) is None
    assert autotune.best_method(1, 8, 4, 16, 8, 2)["method"] == "unified_reshape"
    x, k = torch.ones((1, 4, 4, 8)), torch.ones((4, 4, 8, 8))
    np.testing.assert_allclose(tc.transpose_conv_auto(x, k, 2).numpy(),
                               conventional_ref(x, k, 2).numpy(),
                               rtol=1e-4, atol=1e-4)
    autotune.record(good_key, {"method": "conventional", "time_s": 2e-4,
                               "source": "measured"})
    blob = json.loads(autotune.cache_path().read_text())
    assert blob["entries"][alien_key] == alien_rec
    assert blob["entries"][good_key]["fwd"]["method"] == "conventional"


def test_retuned_key_overrides_alien_record():
    key = autotune.layer_key(1, 8, 4, 16, 8, 2)
    autotune.cache_path().parent.mkdir(parents=True, exist_ok=True)
    autotune.cache_path().write_text(json.dumps({"version": 3, "entries": {
        key: {"fwd": {"method": "hyperwarp", "time_s": 1e-9,
                      "source": "measured"}}}}))
    assert autotune.lookup(key) is None
    autotune.record(key, {"method": "unified_reshape", "time_s": 1e-4,
                          "source": "measured"})
    assert autotune.best_method(1, 8, 4, 16, 8, 2)["method"] == "unified_reshape"
    blob = json.loads(autotune.cache_path().read_text())
    assert blob["entries"][key]["fwd"]["method"] == "unified_reshape"


# ------------------------------------------------------------------ races

def test_tune_layer_records_measured_winner():
    rec = autotune.tune_layer(1, 6, 4, 4, 4, 2, repeats=2, warmup=1,
                              device="cpu")
    entry = rec["fwd"]
    assert entry["method"] in entry["candidates"] and entry["method"] in BASELINES
    assert entry["time_s"] == min(entry["candidates"].values()) > 0
    # the kernels run their plain versions here: reported by proxy only
    assert set(entry["candidates"]) == set(BASELINES)
    assert set(entry["proxy"]) == {"fused", "phase", "gemm"}
    assert "bwd" not in rec and "step" not in rec
    assert autotune.best_method(1, 6, 4, 4, 4, 2)["method"] == entry["method"]


def test_tune_layer_train_records_bwd_and_step():
    rec = autotune.tune_layer(1, 6, 4, 4, 4, 2, repeats=2, warmup=1,
                              train=True, device="cpu")
    bwd = rec["bwd"]
    assert bwd["method"] == "autograd"
    assert set(bwd["proxy"]) == {"segregated", "autograd"}
    assert bwd["time_s"] == min(bwd["candidates"].values()) > 0
    step = rec["step"]
    assert step["method"] in step["candidates"]
    assert step["time_s"] == min(step["candidates"].values()) > 0
    assert autotune.best_bwd(1, 6, 4, 4, 4, 2)["method"] == "autograd"
    assert autotune.best_entry(1, 6, 4, 4, 4, 2)["step"] == step


def test_tune_layer_pallas_only_on_cpu_raises_clearly():
    """Only kernels on the CPU: nothing to time, a clear error."""
    with pytest.raises(ValueError, match="plain"):
        autotune.tune_layer(1, 6, 4, 4, 4, 2, methods=("pallas_fused",),
                            device="cpu")


def test_step_race_measures_pallas_fused_at_recorded_tiles(monkeypatch):
    """The step race runs the fused kernel (its plain version here, which
    the kernel is held to) through the backward just raced, and a fused
    winner records the summation order it ran."""
    _kernels_race(monkeypatch)
    seen = []
    orig = ops.transpose_conv2d_fused

    def spy(x, k, padding=0, *, epilogue=None, bias=None):
        seen.append(tuple(x.shape))
        y = orig(x, k, padding, epilogue=epilogue, bias=bias)
        want = transpose_conv2d_fused_plain(x, k, padding, epilogue=epilogue,
                                            bias=bias)
        assert torch.equal(y, want)
        return y

    monkeypatch.setattr(ops, "transpose_conv2d_fused", spy)
    rec = autotune.tune_layer(1, 6, 4, 2, 2, 2, repeats=1, warmup=0,
                              methods=("unified_reshape", "pallas_fused"),
                              train=True, device="cpu")
    step = rec["step"]
    assert set(step["candidates"]) == {"unified_reshape", "fused"}
    # the batch-1 forward race checks invariance on a stacked batch
    assert seen and set(seen) == {(1, 6, 6, 2),
                                  (autotune.INVARIANCE_BATCH, 6, 6, 2)}
    if step["method"] == "fused":
        assert step["summation_order"] == list(
            fused_geometry(1, 6, 4, 2, 2, 2).summation_order)
    assert set(rec["bwd"]["candidates"]) == {"segregated", "autograd"}


def test_gemm_winner_recorded_and_dispatched(monkeypatch):
    """A GEMM kernel win is recorded with its summation order and
    ``method="auto"`` then runs the GEMM kernel: tune -> cache -> dispatch."""
    _kernels_race(monkeypatch)
    times = iter([1.0, 1e-4])   # unified_reshape, then gemm
    monkeypatch.setattr(autotune, "_time", lambda fn, *a, **kw: next(times))
    rec = autotune.tune_layer(1, 4, 4, 32, 16, 2, device="cpu",
                              methods=("unified_reshape", "pallas_gemm"))
    entry = rec["fwd"]
    assert entry["method"] == "gemm" and entry["candidates"]["gemm"] == 1e-4
    assert entry["summation_order"] == list(
        gemm_geometry(1, 4, 4, 2, 32, 16).summation_order)
    seen = []
    orig = ops.transpose_conv2d_gemm

    def spy(x, k, padding=0, *, epilogue=None, bias=None):
        seen.append(tuple(x.shape))
        return orig(x, k, padding, epilogue=epilogue, bias=bias)

    monkeypatch.setattr(ops, "transpose_conv2d_gemm", spy)
    x, k = _xk(1, 4, 32, 16)
    got = tc.transpose_conv2d(x, k, 2, method="auto")
    assert seen == [(1, 4, 4, 32)]
    np.testing.assert_allclose(got.numpy(), conventional_ref(x, k, 2).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_kernel_that_fails_makes_the_race_raise(monkeypatch):
    """No hidden fallback: a kernel candidate that fails to launch raises
    out of the race and records nothing in its place."""
    _kernels_race(monkeypatch)

    def broken(*a, **kw):
        raise RuntimeError("transpose_conv2d_gemm launch failed: CUDA error 1")

    monkeypatch.setattr(ops, "transpose_conv2d_gemm", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.tune_layer(1, 4, 4, 32, 16, 2, repeats=1, warmup=0,
                            methods=("unified_reshape", "gemm"), device="cpu")
    assert autotune.lookup(autotune.layer_key(1, 4, 4, 32, 16, 2)) is None


# --------------------------------------------------------------- dispatch

def test_train_dispatch_prefers_step_winner(monkeypatch):
    key = autotune.layer_key(1, 6, 4, 2, 3, 2)
    autotune.record(key, {
        "fwd": {"method": "conventional", "time_s": 1e-4, "source": "test"},
        "step": {"method": "unified_matmul", "time_s": 2e-4, "source": "test"},
    })
    calls = []
    orig = tc.METHODS["unified_matmul"]

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setitem(tc.METHODS, "unified_matmul", spy)
    x, k = _xk()
    got = tc.transpose_conv2d(x, k, 2, method="auto", train=True)
    assert calls, "train dispatch must pick the step winner"
    np.testing.assert_allclose(got.numpy(), conventional_ref(x, k, 2).numpy(),
                               rtol=1e-4, atol=1e-4)
    calls.clear()
    tc.transpose_conv2d(x, k, 2, method="auto")
    assert not calls
    assert planlib.plan_layer(1, 6, 4, 2, 3, 2, train=True).source == "tuned"


def test_auto_dispatch_consults_cache(monkeypatch):
    calls = []
    orig = autotune.best_method

    def spy(*a, **kw):
        calls.append(a)
        return orig(*a, **kw)

    monkeypatch.setattr(autotune, "best_method", spy)
    x, k = _xk()
    got = tc.transpose_conv_auto(x, k, 2)   # cold cache: the cold rule
    assert calls, "transpose_conv_auto must consult the autotune cache"
    np.testing.assert_allclose(got.numpy(), conventional_ref(x, k, 2).numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", [
    "conventional", "unified_matmul", "pallas_fused", "pallas_phase",
])
def test_auto_dispatch_follows_cached_winner(method, monkeypatch):
    """The cache's winner runs; a kernel winner (the reference's spelling
    mapped to the port's method) is held to its plain version."""
    x, k = _xk()
    winner = tc.KERNEL_METHODS.get(method, method)
    autotune.record(autotune.layer_key(1, 6, 4, 2, 3, 2),
                    {"method": winner, "time_s": 0.0, "source": "test"})
    lp = planlib.plan_layer_cached(1, 6, 4, 2, 3, 2)
    assert (lp.method, lp.source) == (winner, "tuned")
    got = tc.transpose_conv_auto(x, k, 2)
    np.testing.assert_allclose(got.numpy(), conventional_ref(x, k, 2).numpy(),
                               rtol=1e-4, atol=1e-4)
    if winner == "fused":
        assert torch.equal(got, transpose_conv2d_fused_plain(x, k, 2))


def test_in_process_retuning_invalidates_auto_trace(monkeypatch):
    """record() bumps the generation, the memo key of the cached plans: a
    new winner takes effect without a restart."""
    calls = []
    orig = autotune.best_method

    def spy(*a, **kw):
        calls.append(a)
        return orig(*a, **kw)

    monkeypatch.setattr(autotune, "best_method", spy)
    x, k = _xk()
    tc.transpose_conv2d(x, k, 2, method="auto")
    n1 = len(calls)
    assert n1 >= 1
    tc.transpose_conv2d(x, k, 2, method="auto")   # same generation: memoized
    assert len(calls) == n1
    autotune.record(autotune.layer_key(1, 6, 4, 2, 3, 2),
                    {"method": "unified_matmul", "time_s": 0.0, "source": "test"})
    got = tc.transpose_conv2d(x, k, 2, method="auto")
    assert len(calls) > n1
    assert planlib.plan_layer_cached(1, 6, 4, 2, 3, 2).method == "unified_matmul"
    np.testing.assert_allclose(got.numpy(), conventional_ref(x, k, 2).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_bwd_auto_follows_the_cache_at_its_batch():
    """``bwd="auto"`` is a training consult: it reads the batch."""
    autotune.record(autotune.layer_key(2, 6, 4, 2, 3, 2), {
        "method": "autograd", "time_s": 1e-4, "source": "test"}, direction="bwd")
    assert planlib.resolve_bwd(2, 6, 4, 2, 3, 2) == "autograd"
    assert planlib.resolve_bwd(1, 6, 4, 2, 3, 2) == "segregated"
    assert planlib.plan_layer(2, 6, 4, 2, 3, 2).bwd_method == "autograd"
    assert planlib.plan_layer(1, 6, 4, 2, 3, 2).bwd_method == "segregated"
    assert planlib.plan_layer(2, 6, 4, 2, 3, 2, bwd="segregated").bwd_method == \
        "segregated"


def test_fused_postops_is_raced_but_never_wins(monkeypatch):
    """``fused+postops`` (the fused kernel bare, the epilogue composed after
    it) is timed and kept among the candidates, but neither the race nor
    the serving choice picks it: no plan dispatches it."""
    epi = Epilogue(bias=True, act="relu")
    x, k = _xk()
    b = torch.linspace(-0.5, 0.5, 3)
    got = autotune._layer_fn(2, autotune.POSTOPS, epi)(x, k, b)
    assert torch.equal(got, epi.apply(transpose_conv2d_fused_plain(x, k, 2), b))
    _kernels_race(monkeypatch)
    times = iter([1.0, 2e-4, 1e-4])   # unified_reshape, fused, fused+postops
    monkeypatch.setattr(autotune, "_time", lambda fn, *a, **kw: next(times))
    fwd = autotune.tune_layer(1, 6, 4, 2, 3, 2, epilogue=epi, device="cpu",
                              methods=("unified_reshape", "fused"))["fwd"]
    assert fwd["candidates"] == {"unified_reshape": 1.0, "fused": 2e-4,
                                 autotune.POSTOPS: 1e-4}
    assert (fwd["method"], fwd["time_s"]) == ("fused", 2e-4)
    served = autotune.best_method(1, 6, 4, 2, 3, 2, epilogue=epi)
    assert served["method"] == "fused"
    assert autotune.POSTOPS not in served["candidates"]
    lp = planlib.plan_layer(1, 6, 4, 2, 3, 2, epilogue=epi)
    assert (lp.method, lp.source) == ("fused", "tuned")
    assert lp.describe().endswith("epi=b+relu (tuned)")


# ---------------------------------------------------------------- proxies

def test_roofline_fused_beats_phase_on_gan_layers():
    """Same MACs, and the per-phase kernel splits Cin at least as often:
    the proxy never prefers it over the fused kernel on a Table-4 layer."""
    for cfg in gan.GAN_ZOO.values():
        for hw, cin, cout in cfg.layers:
            for b in (1, 8):
                fused = autotune.roofline_proxy("fused", b, hw, cfg.kernel, cin,
                                                cout, cfg.padding)
                phase = autotune.roofline_proxy("phase", b, hw, cfg.kernel, cin,
                                                cout, cfg.padding)
                assert 0 < fused <= phase, (cfg.name, hw, b, fused, phase)


def test_bwd_roofline_pallas_beats_lax_on_gan_layers():
    """At the channel-deep head layers (Hp = 4) autograd's phase
    convolutions over-compute into the zero frame by (5/4)^2 and
    materialise per-phase planes: the segregated backward's proxy is below
    theirs on every Table-4 L0 and on every layer of no split."""
    for cfg in gan.GAN_ZOO.values():
        for i, (hw, cin, cout) in enumerate(cfg.layers):
            seg_s = autotune.bwd_roofline_proxy("segregated", 1, hw, cfg.kernel,
                                                cin, cout, cfg.padding)
            aut_s = autotune.bwd_roofline_proxy("autograd", 1, hw, cfg.kernel,
                                                cin, cout, cfg.padding)
            g = autotune.bwdlib.bwd_geometry(1, hw, cfg.kernel, cfg.padding,
                                             cin, cout)
            if i == 0 or g.dx_splits == g.dw_splits == 1:
                assert seg_s < aut_s, (cfg.name, hw, seg_s, aut_s)


def test_pair_roofline_geomean_beats_back_to_back_on_zoo():
    """The pair keeps its interface on chip: its proxy is never above the
    two layers' back to back, and below it in geometric mean, over every
    pair the plan pass would fuse."""
    ratios = []
    for cfg in gan.GAN_ZOO.values():
        plan = planlib.compile_plan(cfg, 8, epilogues=gan.generator_epilogues(cfg),
                                    fuse="force")
        for e in plan.entries:
            if isinstance(e, planlib.FusedPairPlan):
                a, z = e.first, e.second
                sig = (8, a.n_in, a.n_k, a.cin, a.cout, z.cout, a.padding)
                kw = dict(epilogue1=a.epilogue, epilogue2=z.epilogue)
                pair = autotune.pair_roofline_proxy(*sig, **kw)
                b2b = autotune.back_to_back_proxy(*sig, **kw)
                assert pair <= b2b * (1 + 1e-12)   # equal where both are
                ratios.append(b2b / pair)           # bound by operations
    assert len(ratios) == 8   # EB-GAN's tail pair is over the budget
    assert float(np.exp(np.mean(np.log(ratios)))) > 1.0


# ------------------------------------------------------------------ pairs

def _epis():
    return Epilogue(bias=True, act="relu"), Epilogue(bias=True, act="tanh")


def test_pair_key_format_and_roundtrip():
    e1, e2 = _epis()
    key = autotune.pair_key(1, 4, 4, 8, 6, 4, 2, epilogue1=e1, epilogue2=e2)
    assert "|pair|" in key and key.startswith("torch_cpu|")
    assert key.endswith("|e1:b+relu|e2:b+tanh")
    assert "ci8" in key and "mid6" in key and "co4" in key
    autotune.record(key, {"method": "pair", "time_s": 1e-6, "source": "measured",
                          "candidates": {"pair": 1e-6, "back_to_back": 2e-6}},
                    direction="pair")
    autotune._STATE.update(mtime=-1.0, entries={})
    rec = autotune.best_pair(1, 4, 4, 8, 6, 4, 2, epilogue1=e1, epilogue2=e2)
    assert rec["method"] == "pair" and rec["batches"] == [1]
    blob = json.loads(autotune.cache_path().read_text())
    assert blob["version"] == 4 and key in blob["entries"]


def test_prune_keeps_pair_keys():
    e1, e2 = _epis()
    key = autotune.pair_key(1, 4, 4, 8, 6, 4, 2, epilogue1=e1, epilogue2=e2)
    autotune.record(key, {"method": "back_to_back", "time_s": 1e-6,
                          "source": "proxy"}, direction="pair")
    assert autotune.prune_cache() == []
    assert autotune.lookup(key) is not None


def test_v3_cache_loads_as_passthrough_and_rewrites_v4():
    key = autotune.layer_key(1, 8, 4, 16, 8, 2)
    autotune.cache_path().parent.mkdir(parents=True, exist_ok=True)
    autotune.cache_path().write_text(json.dumps({"version": 3, "entries": {
        key: {"fwd": {"method": "unified_reshape", "time_s": 1e-4,
                      "source": "measured"}}}}))
    assert autotune.best_method(1, 8, 4, 16, 8, 2)["method"] == "unified_reshape"
    autotune.record(autotune.layer_key(9, 9, 9, 9, 9, 9),
                    {"method": "conventional", "time_s": 1.0, "source": "t"})
    blob = json.loads(autotune.cache_path().read_text())
    assert blob["version"] == 4
    assert blob["entries"][key]["fwd"]["method"] == "unified_reshape"


def test_alien_pair_winner_set_aside():
    e1, e2 = _epis()
    key = autotune.pair_key(1, 4, 4, 8, 6, 4, 2, epilogue1=e1, epilogue2=e2)
    alien = {"pair": {"method": "pallas_trio", "time_s": 1e-9,
                      "source": "measured"}}
    autotune.cache_path().parent.mkdir(parents=True, exist_ok=True)
    autotune.cache_path().write_text(json.dumps({"version": 4,
                                                 "entries": {key: alien}}))
    assert autotune.lookup(key) is None
    assert autotune.best_pair(1, 4, 4, 8, 6, 4, 2, epilogue1=e1,
                              epilogue2=e2) is None
    autotune.record(autotune.layer_key(9, 9, 9, 9, 9, 9),
                    {"method": "conventional", "time_s": 1.0, "source": "t"})
    assert json.loads(autotune.cache_path().read_text())["entries"][key] == alien


def test_tune_pair_cpu_records_back_to_back_proxy():
    e1, e2 = _epis()
    rec = autotune.tune_pair(1, 4, 4, 8, 6, 4, 2, epilogue1=e1, epilogue2=e2,
                             device="cpu")["pair"]
    assert (rec["method"], rec["source"]) == ("back_to_back", "proxy")
    assert set(rec["proxy"]) == {"pair", "back_to_back"}
    assert autotune.best_pair(1, 4, 4, 8, 6, 4, 2, epilogue1=e1,
                              epilogue2=e2)["method"] == "back_to_back"
    with pytest.raises(ValueError, match="cannot fuse"):   # no bias epilogues
        autotune.tune_pair(1, 4, 4, 8, 6, 4, 2, device="cpu")


def test_tune_pair_races_both_candidates_on_the_card_path(monkeypatch):
    """With the card's race on (plain versions here), both candidates are
    timed and each checked for batch invariance at b > 1."""
    _kernels_race(monkeypatch)
    e1, e2 = _epis()
    rec = autotune.tune_pair(2, 4, 4, 8, 6, 4, 2, epilogue1=e1, epilogue2=e2,
                             repeats=1, warmup=0, device="cpu")["pair"]
    assert rec["source"] == "measured"
    assert set(rec["candidates"]) == {"pair", "back_to_back"}
    assert rec["method"] not in rec.get("batch_variant", ())


# -------------------------------------------------------------------- CLI

def test_cli_methods_filter_rejects_unknown_names(capsys):
    with pytest.raises(SystemExit) as exc:
        autotune.main(["--layer", "1", "4", "4", "2", "2", "2",
                       "--methods", "unified_reshape,pallas_warp"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "pallas_warp" in err
    for valid in autotune.DEFAULT_CANDIDATES:
        assert valid in err


def test_cli_methods_filter_accepts_known_names(capsys):
    autotune.main(["--layer", "1", "4", "4", "2", "2", "2",
                   "--methods", "unified_reshape,conventional", "--repeats", "1"])
    out = capsys.readouterr().out
    assert "fwd=" in out and "# device: cpu" in out
    entry = autotune.best_method(1, 4, 4, 2, 2, 2)
    assert entry["method"] in ("unified_reshape", "conventional")
    assert set(entry["candidates"]) == {"unified_reshape", "conventional"}


def test_cli_methods_accepts_pair_candidates(capsys):
    with pytest.raises(SystemExit) as exc:
        autotune.main(["--pair", "1", "4", "4", "8", "6", "4", "2",
                       "--methods", "pallas_pair,back_to_warp"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "back_to_warp" in err
    for valid in autotune.PAIR_CANDIDATES:
        assert valid in err


def test_cli_pair_smoke(capsys):
    autotune.main(["--pair", "1", "4", "4", "8", "6", "4", "2", "--repeats", "1"])
    assert "pair=" in capsys.readouterr().out
    e1, e2 = _epis()
    assert autotune.best_pair(1, 4, 4, 8, 6, 4, 2, epilogue1=e1,
                              epilogue2=e2) is not None


# -------------------------------------------------------------- bucket rule

def _record_fwd(cfg, batch, times_of):
    for i, ((hw, cin, cout), epi) in enumerate(
            zip(cfg.layers, gan.generator_epilogues(cfg))):
        cands = times_of(i)
        autotune.record(
            autotune.layer_key(batch, hw, cfg.kernel, cin, cout, cfg.padding,
                               epilogue=epi),
            {"method": min(cands, key=cands.get), "time_s": min(cands.values()),
             "source": "test", "candidates": cands}, direction="fwd")


def test_compile_plan_gives_one_method_per_layer_across_batches():
    """The reference's per-batch key would serve conventional at batch 1
    and unified_matmul at batch 8; the bucket rule serves the least sum,
    unified_matmul, at every batch under one generation."""
    cfg = gan.reduced_config(gan.DCGAN)
    _record_fwd(cfg, 1, lambda i: {"conventional": 1.0, "unified_matmul": 2.0})
    _record_fwd(cfg, 8, lambda i: {"conventional": 5.0, "unified_matmul": 3.0})
    gen = autotune.generation()
    plans = {b: gan.generator_plan(cfg, b) for b in (1, 3, 8)}
    assert autotune.generation() == gen
    for plan in plans.values():
        assert [lp.method for lp in plan] == ["unified_matmul"] * 4
        assert {lp.source for lp in plan} == {"tuned"}
    buckets = planlib.compile_plan_buckets(cfg, (1, 3, 8),
                                           epilogues=gan.generator_epilogues(cfg))
    assert {lp.method for p in buckets.values() for lp in p} == {"unified_matmul"}
    hw, cin, cout = cfg.layers[0]
    per_batch = autotune.best_entry(1, hw, cfg.kernel, cin, cout, cfg.padding,
                                    epilogue=gan.generator_epilogues(cfg)[0])
    assert per_batch["fwd"]["method"] == "conventional"


def test_batch_variant_candidate_never_wins_fwd(monkeypatch):
    """A candidate whose batched sample differs from its batch-1 call is
    flagged inside the race, stays among the candidates, and wins neither
    that batch nor the serving sum."""
    x = torch.arange(8.0).reshape(2, 4)
    assert autotune._batch_variant(lambda t: t * t.shape[0], x)
    assert not autotune._batch_variant(lambda t: t * 2, x)

    times = iter([1e-6, 1.0])                 # conventional, unified_reshape
    flags = iter([True, False])
    monkeypatch.setattr(autotune, "_time", lambda fn, *a, **kw: next(times))
    monkeypatch.setattr(autotune, "_batch_variant", lambda fn, *a: next(flags))
    rec = autotune.tune_layer(2, 6, 4, 2, 3, 2, device="cpu",
                              methods=("conventional", "unified_reshape"))
    fwd = rec["fwd"]
    assert fwd["method"] == "unified_reshape"
    assert fwd["batch_variant"] == ["conventional"]
    assert set(fwd["candidates"]) == {"conventional", "unified_reshape"}
    # batch 1 (never flagged) prefers conventional; the sum may not
    autotune.record(autotune.layer_key(1, 6, 4, 2, 3, 2), {
        "method": "conventional", "time_s": 1e-6, "source": "test",
        "candidates": {"conventional": 1e-6, "unified_reshape": 1.0}},
        direction="fwd")
    served = autotune.best_method(8, 6, 4, 2, 3, 2)
    assert served["method"] == "unified_reshape" and served["batches"] == [1, 2]
    assert served["batch_variant"] == ["conventional"]
    assert planlib.plan_layer(1, 6, 4, 2, 3, 2).method == "unified_reshape"


def test_batch_one_race_checks_invariance_on_a_stacked_batch(monkeypatch):
    """A race at batch 1 checks each candidate on a batch of
    INVARIANCE_BATCH samples drawn for it, so a cache tuned at batch 1 only
    never serves a batch-variant winner at a larger bucket."""
    checked = []

    def flag(fn, xc, *rest):
        checked.append(xc.shape[0])
        return len(checked) == 1          # the first candidate fails

    monkeypatch.setattr(autotune, "_batch_variant", flag)
    times = iter([1e-6, 1.0])             # conventional, unified_reshape
    monkeypatch.setattr(autotune, "_time", lambda fn, *a, **kw: next(times))
    fwd = autotune.tune_layer(1, 6, 4, 2, 3, 2, device="cpu",
                              methods=("conventional", "unified_reshape"))["fwd"]
    assert checked == [autotune.INVARIANCE_BATCH] * 2
    assert fwd["method"] == "unified_reshape"
    assert fwd["batch_variant"] == ["conventional"]
    assert autotune.best_method(8, 6, 4, 2, 3, 2)["method"] == "unified_reshape"
    # the check itself: a sample of the stacked batch against its own call
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 6, 6, 2)),
                        dtype=torch.float32)
    _, k = _xk()
    assert not autotune._batch_variant(
        autotune._layer_fn(2, "unified_reshape", None), x, k)


# per-batch graph µs of DCGAN L1 on the H100 (PERF.md section 6): gemm wins
# the unweighted sum but loses bucket 8 to the cold rule's fused kernel
_L1 = {1: {"gemm": 22.0, "fused": 65.8, "phase": 52.1},
       2: {"gemm": 39.3, "fused": 66.2, "phase": 52.9},
       4: {"gemm": 59.5, "fused": 66.9, "phase": 52.6},
       8: {"gemm": 115.5, "fused": 70.0, "phase": 81.6}}


def _record_l1(n_in=8):
    for b, cands in _L1.items():
        autotune.record(autotune.layer_key(b, n_in, 4, 16, 8, 2), {
            "method": min(cands, key=cands.get), "time_s": min(cands.values()),
            "source": "test", "candidates": cands}, direction="fwd")


def test_serving_sum_keeps_the_cold_method_that_wins_the_largest_batch():
    """Without a bucket histogram, a sum winner slower than the cold
    rule's method at the largest recorded batch does not replace it."""
    assert planlib.cold_method(8, 4, 2) == "fused"
    _record_l1()
    served = autotune.best_method(1, 8, 4, 16, 8, 2)
    assert (served["method"], served["rule"]) == ("fused", "cold_guard")
    assert served["batches"] == [1, 2, 4, 8]
    assert served["candidates"]["gemm"] < served["candidates"]["fused"]
    assert {planlib.plan_layer(b, 8, 4, 16, 8, 2).method for b in (1, 8)} == \
        {"fused"}
    # the same times where the cold rule picks gemm: the sum stands
    _record_l1(n_in=6)
    assert planlib.cold_method(6, 4, 2) == "gemm"
    served = autotune.best_method(1, 6, 4, 16, 8, 2)
    assert (served["method"], served["rule"]) == ("gemm", "sum")


def test_serving_choice_weights_by_the_recorded_traffic():
    """With a bucket histogram the choice is the least time of that
    traffic; the histogram persists in the file, reloads, and a new one
    resolves the plans again."""
    _record_l1()
    autotune.record_traffic({1: 90, 2: 5, 8: 5})
    served = autotune.best_method(4, 8, 4, 16, 8, 2)
    assert (served["method"], served["rule"]) == ("gemm", "traffic")
    assert served["weights"] == {1: 90, 2: 5, 4: 0, 8: 5}
    assert served["time_s"] == pytest.approx(90 * 22.0 + 5 * 39.3 + 5 * 115.5)
    assert planlib.plan_layer_cached(8, 8, 4, 16, 8, 2).method == "gemm"
    blob = json.loads(autotune.cache_path().read_text())
    assert blob["traffic"] == {"torch_cpu": {"1": 90, "2": 5, "8": 5}}
    autotune.clear_cache(memory_only=True)
    assert autotune.traffic() == {1: 90, 2: 5, 8: 5}
    autotune.record_traffic({1: 3, 4: 10, 8: 60})
    assert planlib.plan_layer_cached(8, 8, 4, 16, 8, 2).method == "fused"
    assert autotune.best_method(1, 8, 4, 16, 8, 2)["rule"] == "traffic"
    # another backend's histogram weighs nothing here
    autotune.record_traffic({}, backend="torch_cpu")
    autotune.record_traffic({1: 100}, backend="torch_cuda")
    assert autotune.traffic() == {}
    assert autotune.best_method(1, 8, 4, 16, 8, 2)["rule"] == "cold_guard"


def test_engine_bucket_histogram_feeds_the_serving_choice():
    """The histogram a serving window's ServeMetrics counts is what
    record_traffic stores."""
    cfg = gan.reduced_config(gan.DCGAN)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    eng = GanEngine(BucketPolicy(buckets=(1, 2, 4)), device="cpu")
    eng.register(cfg, params)
    eng.warmup()
    rng = np.random.default_rng(0)
    eng.serve([GenRequest(cfg.name, rng.standard_normal((n, cfg.z_dim)).astype(
        np.float32)) for n in (1, 2, 4, 1, 3)])
    hist = eng.metrics.summary()["bucket_batches"]
    assert sum(hist.values()) == eng.metrics.batches and set(hist) <= {1, 2, 4}
    autotune.record_traffic(eng.metrics.bucket_batches)
    assert autotune.traffic() == hist


@pytest.mark.parametrize("name", sorted(gan.GAN_ZOO))
def test_cold_fuse_auto_plan_equals_fuse_off(name):
    cfg = gan.reduced_config(gan.GAN_ZOO[name])
    for b in (1, 2, 8):
        auto = gan.generator_plan(cfg, b)
        off = gan.generator_plan(cfg, b, fuse="off", bwd="segregated")
        assert auto == off and auto.describe() == off.describe()
        assert [lp.method for lp in auto] == [
            planlib.cold_method(hw, cfg.kernel, cfg.padding)
            for hw, _, _ in cfg.layers]


def _record_pairs(cfg, batches, pair_s, b2b_s):
    epis = gan.generator_epilogues(cfg)
    for b in batches:
        plan = planlib.compile_plan(cfg, b, epilogues=epis, fuse="force")
        for e in plan.entries:
            if isinstance(e, planlib.FusedPairPlan):
                a, z = e.first, e.second
                autotune.record(
                    autotune.pair_key(b, a.n_in, a.n_k, a.cin, a.cout, z.cout,
                                      a.padding, epilogue1=a.epilogue,
                                      epilogue2=z.epilogue),
                    {"method": "pair" if pair_s < b2b_s else "back_to_back",
                     "time_s": min(pair_s, b2b_s), "source": "test",
                     "candidates": {"pair": pair_s, "back_to_back": b2b_s}},
                    direction="pair")


def test_fuse_auto_follows_the_pair_race():
    cfg = gan.reduced_config(gan.DCGAN)
    _record_pairs(cfg, (1, 2), pair_s=1.0, b2b_s=2.0)
    for b in (1, 2, 5):
        plan = gan.generator_plan(cfg, b)
        pairs = [e for e in plan.entries if isinstance(e, planlib.FusedPairPlan)]
        assert len(pairs) == 2 and {p.source for p in pairs} == {"tuned"}
        assert planlib.plan_follows_fuse(plan, "auto")
        assert not planlib.plan_follows_fuse(plan, "off")
    # train-mode plans stay unfused
    assert not any(isinstance(e, planlib.FusedPairPlan)
                   for e in gan.generator_plan(cfg, 2, train=True).entries)
    # the batch-2 race now says back to back by more than batch 1's margin
    _record_pairs(cfg, (2,), pair_s=5.0, b2b_s=2.0)
    plan = gan.generator_plan(cfg, 1)
    assert not any(isinstance(e, planlib.FusedPairPlan) for e in plan.entries)


def test_engine_fuse_auto_serves_tuned_pairs_and_checks_registries(tmp_path):
    cfg = gan.reduced_config(gan.DCGAN)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    _record_pairs(cfg, (1, 2), pair_s=1.0, b2b_s=2.0)
    eng = GanEngine(BucketPolicy(buckets=(1, 2)), device="cpu")
    assert eng.fuse == "auto"
    eng.register(cfg, params)
    eng.warmup()
    assert all(isinstance(e, planlib.FusedPairPlan)
               for p in eng.registry[cfg.name].plans.values() for e in p.entries)
    eng.save_plans(tmp_path / "reg.json")
    again = GanEngine(BucketPolicy(buckets=(1, 2)), device="cpu")
    again.register(cfg, params)
    again.warmup(registry_path=tmp_path / "reg.json")
    assert again.registry[cfg.name].plans == eng.registry[cfg.name].plans
    off = GanEngine(BucketPolicy(buckets=(1, 2)), device="cpu", fuse="off")
    off.register(cfg, params)
    with pytest.raises(ValueError, match="was not fused"):
        off.warmup(registry_path=tmp_path / "reg.json")


# --------------------------------------------------- against the reference

def test_keys_equal_the_references_but_for_the_backend():
    je, pe = JEpilogue(bias=True, act="relu"), Epilogue(bias=True, act="relu")
    jt, pt = JEpilogue(bias=True, act="tanh"), Epilogue(bias=True, act="tanh")
    for sig in ((1, 8, 4, 16, 8, 2), (8, 4, 4, 1024, 512, 2), (3, 5, 3, 7, 9, 1)):
        for jepi, pepi in ((None, None), (je, pe), (jt, pt)):
            for be in ("cpu", "torch_cuda"):
                assert autotune.layer_key(*sig, "float32", be, epilogue=pepi) == \
                    jat.layer_key(*sig, "float32", be, epilogue=jepi)
        assert autotune.layer_key(*sig).split("|", 1)[1] == \
            jat.layer_key(*sig).split("|", 1)[1]
        assert autotune.layer_key(*sig).split("|")[0] == "torch_cpu"
        assert jat.layer_key(*sig).split("|")[0] == "cpu"
    psig = (2, 4, 4, 64, 32, 16, 2)
    assert autotune.pair_key(*psig, "float32", "x", epilogue1=pe, epilogue2=pt) == \
        jat.pair_key(*psig, "float32", "x", epilogue1=je, epilogue2=jt)


def test_a_shared_file_serves_neither_package_the_others_records():
    sig = (1, 8, 4, 16, 8, 2)
    jat.record(jat.layer_key(*sig), {"method": "unified_matmul", "time_s": 1e-4,
                                     "source": "measured"})
    jat.record(jat.layer_key(2, *sig[1:]), {"method": "pallas_fused",
                                            "time_s": 1e-4, "source": "measured"})
    assert autotune.best_method(*sig) is None
    assert autotune.best_entry(*sig) is None
    autotune.record(autotune.layer_key(*sig), {"method": "fused", "time_s": 2e-4,
                                               "source": "measured"})
    jat.clear_cache(memory_only=True)
    assert jat.best_method(*sig)["method"] == "unified_matmul"
    assert jat.best_method(2, *sig[1:])["method"] == "pallas_fused"
    jat.record(jat.layer_key(9, 9, 9, 9, 9, 9),
               {"method": "conventional", "time_s": 1.0, "source": "t"})
    autotune.clear_cache(memory_only=True)
    assert autotune.best_method(*sig)["method"] == "fused"
    autotune.record(autotune.layer_key(9, 9, 9, 9, 9, 9),
                    {"method": "conventional", "time_s": 1.0, "source": "t"})
    entries = json.loads(autotune.cache_path().read_text())["entries"]
    assert entries[jat.layer_key(*sig)]["fwd"]["method"] == "unified_matmul"
    assert entries[jat.layer_key(2, *sig[1:])]["fwd"]["method"] == "pallas_fused"
    assert entries[jat.layer_key(9, 9, 9, 9, 9, 9)]["fwd"]["method"] == "conventional"
    assert entries[autotune.layer_key(*sig)]["fwd"]["method"] == "fused"


@pytest.mark.parametrize("name", sorted(gan.GAN_ZOO))
def test_same_winners_resolve_the_same_plans(name):
    """Both packages record the same winners in their own spellings; both
    compile_plans resolve the same method per layer at batches 1 and 2,
    and the generators agree within 1e-5 under the tuned plans."""
    cfg = gan.reduced_config(gan.GAN_ZOO[name], 16)
    cfg_j = jgan.reduced_config(jgan.GAN_ZOO[name], 16)
    offset = sorted(gan.GAN_ZOO).index(name)
    winners = [BASELINES[(i + offset) % len(BASELINES)]
               for i in range(len(cfg.layers))]
    for b in (1, 2):
        for (hw, cin, cout), epi, jepi, m in zip(
                cfg.layers, gan.generator_epilogues(cfg),
                jgan.generator_epilogues(cfg_j), winners):
            sig = (b, hw, cfg.kernel, cin, cout, cfg.padding)
            entry = {"method": m, "time_s": 1e-4, "source": "test"}
            autotune.record(autotune.layer_key(*sig, epilogue=epi), entry,
                            direction="fwd")
            jat.record(jat.layer_key(*sig, epilogue=jepi), entry, direction="fwd")
    rng = np.random.default_rng(0)
    params_np = jax.tree.map(np.asarray,
                             jgan.generator_init(jax.random.key(0), cfg_j))
    for i in range(len(cfg.layers)):
        bias = params_np[f"tconv{i}"]["b"]
        params_np[f"tconv{i}"]["b"] = (0.1 * rng.standard_normal(bias.shape)
                                       ).astype(np.float32)
    params = from_jax_params(params_np, cfg, "cpu")
    for b in (1, 2):
        jplan = jgan.generator_plan(cfg_j, b)
        plan = gan.generator_plan(cfg, b)
        assert [lp.method for lp in plan] == [lp.method for lp in jplan] == winners
        assert {lp.source for lp in plan} == {lp.source for lp in jplan} == {"tuned"}
        z = rng.standard_normal((b, cfg.z_dim)).astype(np.float32)
        want = np.asarray(jgan.generator_apply(params_np, cfg_j, z, plan=jplan))
        got = gan.generator_apply(params, cfg, z, plan=plan, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_a_cpu_race_records_the_same_fields_in_both():
    sig = (1, 6, 4, 4, 4, 2)
    jrec = jat.tune_layer(*sig, repeats=1, warmup=0, persist=False)["fwd"]
    rec = autotune.tune_layer(*sig, repeats=1, warmup=0, persist=False,
                              device="cpu")["fwd"]
    assert set(rec) == set(jrec)
    assert set(rec["candidates"]) == set(jrec["candidates"]) == set(BASELINES)
    assert {tc.KERNEL_METHODS[f"pallas_{m}"] for m in ("fused", "phase", "gemm")} \
        == set(rec["proxy"])
    assert set(jrec["proxy"]) == {"pallas_fused", "pallas_phase", "pallas_gemm"}
    assert rec["method"] in BASELINES and jrec["method"] in BASELINES
    assert rec["source"] == jrec["source"] == "measured"
