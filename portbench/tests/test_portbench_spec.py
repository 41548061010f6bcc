"""The benchmark's files: BENCHMARK.json against the contract it is held to,
the data files, the readers, the frozen arithmetic and the imports."""
import ast
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import portbench_cpu_cells  # noqa: F401  (puts the repo on sys.path)
from portbench import bench, devtrace, inputs, work
from portbench.drivers import common
from portbench.reference import gan as ref

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_follows_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_every_named_file_exists_and_parses():
    for w in SPEC["workloads"]:
        mix = json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())
        assert (PB / "drivers" / f"{mix['driver']}.py").is_file()
        limits = json.loads((PB / "limits" / f"{w['name']}.json").read_text())
        assert all(math.isfinite(v["limit"]) for v in limits.values())
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for f in PB.rglob("*.json"):
        json.loads(f.read_text())
    for family in ("tconv_fwd", "tconv_bwd"):
        assert devtrace.kernel_patterns(family)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_what_its_metrics_move(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if bench.reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"] if bench.reports(m, cell)]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for f in PB.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & set(bench.FORBIDDEN), f
    for f in (PB / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"repro_torch", "portbench"}, f


def test_frozen_arithmetic_pins_the_papers_numbers():
    cfg = json.loads((PB / "configs" / "dcgan.json").read_text())
    dcgan = work.Gan(cfg)
    ebgan = work.Gan(dict(cfg, layers=portbench_cpu_cells.EBGAN_LAYERS))
    assert round(dcgan.tconv_flops() / 1e9, 3) == 0.818
    assert round(ebgan.tconv_flops() / 1e9, 2) == 7.52
    assert ebgan.memory_savings_bytes() == 35_534_592
    # a layer's useful taps are a quarter of the conventional count
    assert work.tconv_macs(8, 4, 512, 256, 2) * 4 == 16 * 16 * 16 * 512 * 256
    assert dcgan.train_step_flops(2) == 2 * dcgan.train_step_flops(1)


def test_open_loop_offers_the_same_work_to_every_seed():
    mix = {"arrivals": "poisson", "rate_rps": 200.0, "sizes": [1, 4, 16],
           "probabilities": [0.5, 0.3, 0.2], "check_requests": 64}
    a_sizes, a_arr = inputs.open_loop(mix, 1, 10.0)
    b_sizes, b_arr = inputs.open_loop(mix, 2 ** 31 + 9, 10.0)
    assert sorted(a_sizes) == sorted(b_sizes) and a_sizes != b_sizes
    ga, gb = np.diff([0.0] + a_arr), np.diff([0.0] + b_arr)
    assert np.allclose(np.sort(ga), np.sort(gb))
    assert a_arr[-1] == pytest.approx(10.0) and len(a_sizes) == round(mix["rate_rps"] * 10)
    picked = inputs.check_sample(a_sizes, mix["check_requests"], 3)
    assert len(picked) == mix["check_requests"]
    assert {a_sizes[i] for i in picked} == set(mix["sizes"])


def test_weights_are_a_function_of_the_seed():
    cfg = portbench_cpu_cells.reduced(json.loads((PB / "configs" / "dcgan.json").read_text()))
    g1, d1 = inputs.weights(cfg, 5, "cpu", discriminator=True)
    g2, d2 = inputs.weights(cfg, 5, "cpu", discriminator=True)
    g3, _ = inputs.weights(cfg, 6, "cpu")
    assert torch.equal(g1["tconv1"]["w"], g2["tconv1"]["w"])
    assert torch.equal(d1["head"]["w"], d2["head"]["w"])
    assert not torch.equal(g1["tconv1"]["w"], g3["tconv1"]["w"])
    assert g1["tconv0"]["w"].shape == (4, 4, *cfg["layers"][0][1:])


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest_even():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -10, -1 - 3 * 2 ** -12])
    got = ref.round_tf32(x)
    want = torch.tensor([1.0, 1.0, 1 + 2 ** -9, 1 + 2 ** -10, -1 - 2 ** -10])
    assert torch.equal(got, want)
    y = torch.randn(1000)
    r = ref.round_tf32(y)
    assert ((r - y).abs() <= y.abs() * 2 ** -11).all()
    assert torch.equal(ref.round_tf32(r), r)


def test_profile_reduction_on_synthetic_ops():
    p = devtrace.Profile()
    p.t0, p.t1 = 0.0, 10.0
    p.ops = [("void (anonymous namespace)::fused_kernel<1, 2>(float const*, int)", 1.0, 2.0),
             ("void tconv::(anonymous namespace)::reduce_splits_kernel(float*)", 1.5, 3.0),
             ("Memcpy DtoH (Device -> Pageable)", 6.0, 7.0)]
    assert p.busy_s() == pytest.approx(3.0)
    assert p.kernel_seconds(devtrace.kernel_patterns("tconv_fwd")) == pytest.approx(2.5)
    # an operation that runs past the sub-window counts only its part inside
    p.t1 = 1.75
    assert p.kernel_seconds(devtrace.kernel_patterns("tconv_fwd")) == pytest.approx(1.0)
    p.t1 = 10.0
    assert devtrace.short_name(p.ops[0][0]) == "(anonymous namespace)::fused_kernel<1, 2>"
    host = [("serve.dispatch", 0.5, 1.5), ("replay.sleep", 3.0, 5.0)]
    gaps = dict(p.idle_by_host(host))
    assert gaps["serve.dispatch"] == pytest.approx(0.5)
    assert gaps["replay.sleep"] == pytest.approx(2.0)
    assert sum(gaps.values()) == pytest.approx(7.0)


def test_nearest_rank_ranks_unserved_requests_last():
    lat = [0.001 * i for i in range(1, 20)] + [float("inf")]
    assert bench.nearest_rank(lat, 0.95) == pytest.approx(0.019)
    assert bench.nearest_rank(lat + [float("inf")], 0.95) == float("inf")


def test_run_fails_plainly_without_a_card(tmp_path):
    r = subprocess.run([sys.executable, str(PB / "run.py"), "--workload",
                        "dcgan.serve.poisson", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr
    # a checkout that holds only the benchmark fails too: the program is missing
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "dcgan.serve.poisson", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_listed_metric_that_reads_nothing_raises():
    """A traced run whose profile holds no transpose-conv kernel (one
    renamed outside kernel_names/, say) fails instead of leaving the
    roofline out of the line."""
    cell = bench.load_cell("dcgan.serve.poisson", trace=True)
    cell.metrics = [m for m in cell.metrics if m["name"] == "tconv_fwd_roofline.serve"]
    p = devtrace.Profile()
    p.t0, p.t1, p.ops = 0.0, 1.0, [("renamed_kernel", 0.1, 0.5)]
    ctx = common.Ctx(kind="serve", gan=work.Gan(cell.cfg), setup_s=1.0, window_s=1.0,
                     peak_bytes=0, attempted=1, failed=0, profile=p, profiled=[64])
    with pytest.raises(RuntimeError, match="tconv_fwd_roofline.serve"):
        bench.read_metrics(cell, common.Outcome(ctx=ctx, numbers={}))
    p.ops = [("void fused_kernel<1, 2>(float const*)", 0.1, 0.5)]
    got = bench.read_metrics(cell, common.Outcome(ctx=ctx, numbers={}))
    assert got["tconv_fwd_roofline.serve"]["value"] > 0
