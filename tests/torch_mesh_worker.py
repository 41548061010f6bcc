"""One rank of the four-rank gloo world that
``tests/test_torch_sharding_mesh.py`` spawns on the CPU:

    PYTHONPATH=src python tests/torch_mesh_worker.py RANK WORLD PORT OUT_DIR

It joins the world at ``tcp://localhost:PORT``, runs every case under the
port's meshes (a ``(pod, data)`` 2x2 one and a ``(data, model)`` 2x2 one)
and saves ``{case: result}`` to ``OUT_DIR/rank{RANK}.pt``; on a failure it
writes the traceback to ``OUT_DIR/rank{RANK}.err`` and exits 1. The setup
functions are shared with the test module, which computes the unsharded
and reference sides. It imports torch and the port only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import sys
import traceback

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import gan
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves, tree_map

GEN_BATCH = 4
MOE_SHAPE = (4, 8)   # batch, tokens
TRAIN_BATCH = 4
TRAIN_STEPS = 3


def gan_setup(fuse, batch=GEN_BATCH):
    """Channel-reduced DCGAN: ``(params, plan, z, apply_fn)`` from seeds."""
    cfg = gan.reduced_config(gan.DCGAN, scale=16)
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    plan = gan.generator_plan(cfg, GEN_BATCH, fuse=fuse)
    z = torch.from_numpy(np.random.default_rng(1).normal(size=(batch, cfg.z_dim))
                         .astype(np.float32))

    def apply_fn(p, zz, pl):
        return gan.generator_apply(p, cfg, zz, plan=pl, device="cpu")

    return params, plan, z, apply_fn


def gen_weights(shape):
    """The fixed cotangent of the generator's gradient case."""
    return torch.from_numpy(np.random.default_rng(5).normal(size=shape).astype(np.float32))


def moe_setup(fsdp: bool, capacity_factor=None):
    """Reduced DBRX (4 experts, top 2) in fp32: ``(cfg, params, x, w)``,
    ``w`` the cotangent of the output."""
    cfg = dataclasses.replace(reduced(get_config("dbrx-132b")), dtype="float32", fsdp=fsdp)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.normal(size=MOE_SHAPE + (cfg.d_model,)) * 0.5)
                         .astype(np.float32))
    w = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    return cfg, p, x, w


def moe_grads(cfg, p, x, w):
    """``moe``'s output and aux, and the gradients of ``sum(out * w) +
    aux`` in every parameter (tree-leaf order) and ``x``."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), p)
    xl = x.detach().requires_grad_(True)
    y, aux = L.moe(live, cfg, xl)
    grads = torch.autograd.grad((y * w).sum() + aux, tree_leaves(live) + [xl])
    return y.detach(), aux.detach(), list(grads)


def trainer_setup():
    from repro_torch.data import SyntheticImages
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

    cfg = gan.reduced_config(gan.DCGAN, 16)
    tr = GanTrainer(cfg, GanTrainerConfig(global_batch=TRAIN_BATCH),
                    SyntheticImages(64, cfg.layers[-1][2], TRAIN_BATCH, device="cpu"),
                    log_fn=lambda *a: None, device="cpu")
    return tr, tr.init_state(torch.Generator().manual_seed(0))


def trainer_steps(tr, state, steps=TRAIN_STEPS):
    """``steps`` steps through the trainer's step: the metrics and a clone
    of the state after each."""
    metrics, states = [], []
    for step in range(steps):
        reals, zs = tr._batches(step)
        state, m = tr._step_fn(state, reals, zs)
        metrics.append(m)
        states.append(tree_map(torch.clone, state))
    return metrics, states


def lm_setup():
    """Reduced DBRX, fp32, with capacity for every token: ``(model,
    params, batch)``."""
    from repro_torch.models.lm import build_model

    cfg = dataclasses.replace(reduced(get_config("dbrx-132b")), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 16)).astype(np.int64)
    return model, params, {"tokens": torch.from_numpy(toks)}


@contextlib.contextmanager
def _batches_seen(module):
    """``module.generator_apply`` recording the batch of each call."""
    orig, seen = module.generator_apply, []

    def recording(p, cfg, z, **kw):
        seen.append(int(z.shape[0]))
        return orig(p, cfg, z, **kw)

    module.generator_apply = recording
    try:
        yield seen
    finally:
        module.generator_apply = orig


def run_cases() -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as sh
    from repro_torch.serve import Replica

    pod_data = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    data_model = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {"sizes": sh.mesh_axis_sizes(pod_data),
           "coordinate": list(pod_data.get_coordinate())}

    for fuse in ("off", "force"):
        params, plan, z, apply_fn = gan_setup(fuse)
        seen = []

        def spy(p, zz, pl, apply_fn=apply_fn, seen=seen):
            seen.append(zz.clone())
            return apply_fn(p, zz, pl)

        out[f"gen_{fuse}"] = sh.shard_plan_apply(spy, params, z, plan, mesh=pod_data)
        out[f"seen_{fuse}"] = seen

    params, plan, z, apply_fn = gan_setup("off")
    with sh.use_mesh(pod_data):
        out["ambient"] = sh.shard_plan_apply(apply_fn, params, z, plan)
    _, _, z3, _ = gan_setup("off", batch=3)
    seen = []
    out["odd"] = sh.shard_plan_apply(
        lambda p, zz, pl: seen.append(zz.shape[0]) or apply_fn(p, zz, pl),
        params, z3, plan, mesh=pod_data)
    out["odd_seen"] = seen

    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    y = sh.shard_plan_apply(apply_fn, live, z, plan, mesh=pod_data)
    out["gen_grads"] = list(torch.autograd.grad((y * gen_weights(y.shape)).sum(),
                                                tree_leaves(live)))

    # two data-parallel ranks (data = 2; the model ranks repeat the work),
    # with the batch each generator call was given
    from repro_torch.serve import gan_engine

    with sh.use_mesh(data_model), _batches_seen(gan) as seen:
        tr, state = trainer_setup()
        out["train_metrics"], out["train_states"] = trainer_steps(tr, state)
    out["train_seen"] = seen
    with _batches_seen(gan_engine) as seen:
        rep = Replica("r0", device="cpu", fuse="off", shard=True, mesh=data_model)
        name = rep.register(gan.reduced_config(gan.DCGAN, scale=16), params)
        out["replica"] = rep.execute(name, z, GEN_BATCH)
    out["replica_seen"] = seen
    out["replica_recompiles"] = rep.recompiles

    try:   # a graph captures NCCL collectives only
        sh.check_capturable(data_model, torch.device("cpu"))
        out["capturable"] = ""
    except ValueError as e:
        out["capturable"] = str(e)

    # the expert-parallel MoE: experts over model, tokens over data
    with sh.use_mesh(data_model):
        for fsdp in (False, True):
            for cf in (None, 0.5):
                cfg, p, x, w = moe_setup(fsdp, cf)
                out[f"moe_ep_{fsdp}_{cf}"] = L._moe_supported_by_shard_map(cfg, x.shape[0])
                out[f"moe_{fsdp}_{cf}"] = moe_grads(cfg, p, x, w)
        model, lp, batch = lm_setup()
        out["lm_logits"] = model.apply(lp, batch)[0].detach()
    return out


def main(argv) -> int:
    rank, world, port, out_dir = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(run_cases(), os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
