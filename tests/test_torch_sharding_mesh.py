"""Sharded execution on a real four-rank world: ``tests/test_sharding_mesh.py``
ported from a 2x2 mesh of fake CPU devices to four gloo processes on the
CPU, with the port's other sharded paths.

A module fixture spawns the world once (``tests/torch_mesh_worker.py``, one
process a rank, with a timeout of its own) and hands back every rank's
results; the unsharded and reference sides are computed here. On a
``(pod, data)`` 2x2 mesh the generator's forward is held **bitwise** to the
unsharded call: the CPU plain versions of the kernels give a row the same
bits at any batch (the reference checks these at atol 1e-6). Gradients
through the region, summed over the ranks by gloo, are held within fp32
tolerance. On a ``(data, model)`` 2x2 mesh: two data-parallel GanTrainer
ranks against one, ``Replica(shard=True)`` against unsharded serving, and
the MoE's expert-parallel path against the reference's ``moe`` with its
data-parallel groups. Then the rules that need no world: ``_dp_groups``
under an abstract mesh, ``roofline``, ``shard_owner`` and the production
mesh's refusal on one rank.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.distributed.fault_tolerance import shard_owner as jshard_owner
from repro.launch import roofline as jroofline
from repro.models import layers as JL
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.fault_tolerance import shard_owner
from repro_torch.kernels.plan import FusedPairPlan
from repro_torch.launch import roofline
from repro_torch.models import gan
from repro_torch.models import layers as L
from repro_torch.serve import Replica
from repro_torch.tree import tree_leaves, tree_map

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 4
SPAWN_TIMEOUT_S = 300
REL, ABS = 1e-5, 1e-6        # fp32 against the reference
GRAD_REL, GRAD_ABS = 1e-5, 1e-6   # fp32 gradients summed by gloo in another order


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one spawn of the world."""
    out = tmp_path_factory.mktemp("world")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    worker = os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py")
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(WORLD), str(port),
                               str(out)], env=env, cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD}-rank world did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = {}
    for r, p in enumerate(procs):
        if p.returncode != 0:
            err = out / f"rank{r}.err"
            failed[r] = (err if err.exists() else out / f"rank{r}.log").read_text()[-3000:]
    if failed:
        pytest.fail(f"ranks failed: {failed}")
    return [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_thread():
    """The unsharded side with the ranks' one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL, abs_=ABS, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want.detach().float() if isinstance(want, torch.Tensor) else want,
                      np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, tol = np.abs(got - want).max(), rel * np.abs(want).max() + abs_
    assert err <= tol, (what, err, tol)


# ---------------------------------------- tests/test_sharding_mesh.py, ported

def test_mesh_is_really_2x2(ranks):
    assert [r["sizes"] for r in ranks] == [{"pod": 2, "data": 2}] * WORLD
    assert [r["coordinate"] for r in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]


def test_sharded_parity_per_layer_plan(ranks, one_thread):
    params, plan, z, apply_fn = W.gan_setup("off")
    assert not any(isinstance(e, FusedPairPlan) for e in plan.entries)
    ref = apply_fn(params, z, plan)
    for r in ranks:
        assert torch.equal(r["gen_off"], ref)


def test_sharded_parity_fused_plan(ranks, one_thread):
    params, plan, z, apply_fn = W.gan_setup("force")
    assert any(isinstance(e, FusedPairPlan) for e in plan.entries)
    ref = apply_fn(params, z, plan)
    for r in ranks:
        assert torch.equal(r["gen_force"], ref)


def test_batch_is_actually_partitioned(ranks):
    """Rank ``r`` (its place in the flattened ``(pod, data)`` group,
    row-major as the reference's ``P(("pod", "data"))`` splits) ran the
    generator on row ``r`` alone, and every rank got the whole batch back."""
    _, _, z, _ = W.gan_setup("force")
    for i, r in enumerate(ranks):
        assert len(r["seen_force"]) == 1
        assert torch.equal(r["seen_force"][0], z[i:i + 1])
        assert r["gen_force"].shape[0] == W.GEN_BATCH


def test_active_mesh_is_picked_up(ranks, one_thread):
    params, plan, z, apply_fn = W.gan_setup("off")
    ref = apply_fn(params, z, plan)
    for r in ranks:
        assert torch.equal(r["ambient"], ref)


def test_nondivisible_batch_degrades_unsharded(ranks):
    for r in ranks:
        assert r["odd_seen"] == [3]   # ran once, unsharded (3 % 4 != 0)
        assert r["odd"].shape[0] == 3


def test_sharded_matches_jnp_reference_composition(ranks, one_thread):
    """The sharded fused plan agrees with the unfused plan too (a different
    summation order: tolerance, not bits)."""
    params, plan, z, apply_fn = W.gan_setup("off")
    out_u = apply_fn(params, z, plan)
    for r in ranks:
        np.testing.assert_allclose(r["gen_force"].numpy(), out_u.numpy(),
                                   rtol=1e-5, atol=1e-5)


# ----------------------------------------------------- the port's own paths

def test_sharded_gradients_are_summed_over_the_ranks(ranks, one_thread):
    """``enter``'s all-reduce gives every rank the whole gradient of each
    parameter: the sum of the four ranks' partial gradients."""
    params, plan, z, apply_fn = W.gan_setup("off")
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    y = apply_fn(live, z, plan)
    want = torch.autograd.grad((y * W.gen_weights(y.shape)).sum(), tree_leaves(live))
    for r in ranks:
        for i, (g, w) in enumerate(zip(r["gen_grads"], want)):
            _close(g, w, GRAD_REL, GRAD_ABS, what=f"leaf {i}")
    for r in ranks[1:]:   # the same bits on every rank
        assert all(torch.equal(a, b) for a, b in zip(r["gen_grads"], ranks[0]["gen_grads"]))


def test_two_data_parallel_trainer_ranks_match_one(ranks, one_thread):
    """``GanTrainer(data_parallel=True)`` on two data-parallel ranks against
    one rank, three steps: the trainer tests' tolerances (losses and grad
    norms within 1e-4; each parameter's change within lr/100, leaving out
    the entries whose gradient is within 1e-4 of its leaf's largest at some
    step, where Adam's step takes the sign of the rounding; moments within
    1e-4 of their largest). Every rank holds the same state, bit for bit."""
    tr, state = W.trainer_setup()
    start = tree_map(torch.clone, state)
    metrics, states = W.trainer_steps(tr, state)
    opt = tr.tcfg.opt
    for r in ranks:
        for step, (got, want) in enumerate(zip(r["train_metrics"], metrics)):
            assert got["skipped"] == want["skipped"] == 0
            for key in ("g_loss", "d_loss", "g_gnorm", "d_gnorm"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                           err_msg=f"{key} at step {step}")
        got = r["train_states"][-1]
        for part, opt_part in (("g_params", "g_opt"), ("d_params", "d_opt")):
            moments = [tree_leaves(start[opt_part]["m"])] + [
                tree_leaves(s[opt_part]["m"]) for s in states]
            for i, (p0, pw, pg) in enumerate(zip(tree_leaves(start[part]),
                                                 tree_leaves(states[-1][part]),
                                                 tree_leaves(got[part]))):
                grads = torch.stack([(moments[t + 1][i] - opt.b1 * moments[t][i])
                                     / (1 - opt.b1) for t in range(len(states))])
                decided = (grads.abs() > 1e-4 * grads.abs().max()).all(0)
                assert decided.any(), f"{part} leaf {i}: no entry compared"
                np.testing.assert_allclose((pg - p0)[decided].numpy(),
                                           (pw - p0)[decided].numpy(), rtol=0,
                                           atol=opt.lr / 100, err_msg=f"{part} leaf {i}")
            for moment in ("m", "v"):
                for a, b in zip(tree_leaves(got[opt_part][moment]),
                                tree_leaves(states[-1][opt_part][moment])):
                    _close(a, b, 0, 1e-4 * float(b.abs().max()), what=f"{opt_part}.{moment}")
    for r in ranks:   # each generator call ran on its rank's half of the batch
        assert r["train_seen"] and set(r["train_seen"]) == {W.TRAIN_BATCH // 2}
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(r["train_states"]), tree_leaves(ranks[0]["train_states"])))


def test_sharded_replica_serves_the_unsharded_output(ranks, one_thread):
    """``Replica(shard=True)`` on two data-parallel ranks serves every rank
    the unsharded replica's output, bit for bit, from one executable."""
    params, _, z, _ = W.gan_setup("off")
    rep = Replica("r0", device="cpu", fuse="off")
    name = rep.register(gan.reduced_config(gan.DCGAN, scale=16), params)
    want = rep.execute(name, z, W.GEN_BATCH)
    for r in ranks:
        assert torch.equal(r["replica"], want)
        assert r["replica_seen"] == [W.GEN_BATCH // 2]
        assert r["replica_recompiles"] == 1


def test_a_gloo_mesh_is_not_capturable(ranks):
    """``check_capturable`` refuses a mesh over gloo groups, naming NCCL:
    a CUDA trainer or replica under such a mesh raises at construction."""
    for r in ranks:
        assert "NCCL" in r["capturable"] and "gloo" in r["capturable"]


def _ref_moe_grouped(cfg, p, x, groups, monkeypatch):
    """The reference's ``moe`` with ``groups`` data-parallel groups: its
    abstract mesh patched in, its sharding hints (which never change a
    value, and need a device mesh to run) patched out."""
    from repro.configs import reduced as jreduced

    base = jreduced(jget_config("dbrx-132b"))
    jcfg = dataclasses.replace(base, dtype="float32", fsdp=cfg.fsdp, moe=dataclasses.replace(
        base.moe, capacity_factor=cfg.moe.capacity_factor))
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)
    with monkeypatch.context() as mp:
        mesh = jsh.abstract_mesh((groups,), ("data",))
        mp.setattr(jax.sharding, "get_abstract_mesh", lambda: mesh, raising=False)
        mp.setattr(JL, "constrain", lambda t, *a: t)
        assert JL._dp_groups(x.shape[0]) == groups
        return JL.moe(jp, jcfg, jnp.asarray(x.numpy()))


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("fsdp", [False, True])
def test_expert_parallel_moe_matches_the_reference(ranks, fsdp, cf, monkeypatch):
    """The MoE's expert-parallel path on ``(data, model)`` 2x2 (two experts
    a model rank, half the tokens a data rank, the capacity of the local
    tokens) against the reference's ``moe`` with two data-parallel groups,
    at the config's capacity and at 0.5 (tokens dropped); under ``fsdp``
    the expert slices go through the gather over ``data``. Its gradients
    (the tokens, router and experts through ``enter``, ``reduce`` and
    ``gather``) against the port's grouped path under the same abstract
    mesh."""
    cfg, p, x, w = W.moe_setup(fsdp, cf)
    ref_out, ref_aux = _ref_moe_grouped(cfg, p, x, 2, monkeypatch)
    with monkeypatch.context() as mp:
        mesh = sh.abstract_mesh((2,), ("data",))
        mp.setattr(sh, "get_abstract_mesh", lambda: mesh)
        out, aux, grads = W.moe_grads(cfg, p, x, w)
    _close(out, ref_out, what="grouped out")
    for r in ranks:
        assert r[f"moe_ep_{fsdp}_{cf}"]
        got_out, got_aux, got_grads = r[f"moe_{fsdp}_{cf}"]
        _close(got_out, ref_out, what="out")
        np.testing.assert_allclose(float(got_aux), float(ref_aux), rtol=REL)
        for i, (g, want) in enumerate(zip(got_grads, grads)):
            _close(g, want, GRAD_REL, GRAD_ABS, what=f"grad {i}")


def test_lm_forward_through_the_expert_parallel_path(ranks, one_thread):
    """Reduced DBRX's logits under the ``(data, model)`` mesh equal the
    no-mesh forward's (capacity for every token, so the data-parallel
    groups drop nothing)."""
    model, params, batch = W.lm_setup()
    want = model.apply(params, batch)[0]
    for r in ranks:
        _close(r["lm_logits"], want, what="logits")


# --------------------------------------------------- no world needed

def test_dp_groups_capacity_and_drops_follow_the_reference(monkeypatch):
    """Under an abstract mesh with ``data = 2`` the grouped path splits the
    tokens into two groups, each with its own capacity, and drops what the
    reference drops; at a batch the groups do not divide, one group."""
    cfg, p, x, _ = W.moe_setup(False, 0.5)
    ref_out, ref_aux = _ref_moe_grouped(cfg, p, x, 2, monkeypatch)
    mesh = sh.abstract_mesh((2,), ("data",))
    monkeypatch.setattr(sh, "get_abstract_mesh", lambda: mesh)
    assert L._dp_groups(4) == 2 and L._dp_groups(3) == 1
    assert not L._moe_supported_by_shard_map(cfg, 4)   # no ranks to split over
    out, aux = L.moe(p, cfg, x)
    _close(out, ref_out)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=REL)
    monkeypatch.setattr(sh, "get_abstract_mesh", lambda: None)
    one, _ = L.moe(p, cfg, x)
    assert not torch.allclose(one, out, atol=1e-3)   # the groups' drops differ


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_matches_the_reference(arch, shape, monkeypatch):
    """``model_flops`` equals the reference's; ``roofline_report`` of one
    report dict equals the reference's run at the port's card constants."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert roofline.model_flops(cfg, SHAPES[shape]) == jroofline.model_flops(
        jcfg, JSHAPES[shape])
    report = {"chips": 256, "flops": 3.1e15, "bytes_accessed": 7.7e12,
              "collectives": {"total": 2.2e11},
              "memory": {"argument_size_in_bytes": 1.5e10,
                         "output_size_in_bytes": 1.1e10, "temp_size_in_bytes": 2.5e10}}
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroofline, name, getattr(roofline, name))
    assert roofline.roofline_report(report, cfg, SHAPES[shape]) == \
        jroofline.roofline_report(report, jcfg, JSHAPES[shape])


def test_roofline_constants_are_the_data_sheet_s():
    from repro_torch.kernels import autotune

    assert (roofline.PEAK_FP32_FLOPS, roofline.PEAK_BF16_FLOPS, roofline.HBM_BW) == (
        67e12, 989e12, 3.35e12)
    assert roofline.PEAK_FLOPS == roofline.PEAK_BF16_FLOPS
    assert roofline.CARD == "NVIDIA H100 80GB HBM3, 700 W"
    assert (autotune.PEAK_FLOPS, autotune.PEAK_BW) == (67e12, 3.35e12)


@pytest.mark.parametrize("hosts", [1, 3, 8])
def test_shard_owner_rotates_as_the_reference(hosts):
    for step in range(5):
        owners = [shard_owner(step, s, hosts) for s in range(hosts)]
        assert owners == [jshard_owner(step, s, hosts) for s in range(hosts)]
        assert sorted(owners) == list(range(hosts))


@pytest.mark.parametrize("multi_pod,ranks_needed", [(False, 256), (True, 512)])
def test_production_mesh_refuses_another_world(multi_pod, ranks_needed):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(ValueError, match=f"needs a torchrun world of {ranks_needed} ranks"):
        make_production_mesh(multi_pod=multi_pod)
    assert not dist.is_initialized()
