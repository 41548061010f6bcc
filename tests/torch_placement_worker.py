"""One rank of the four-rank gloo world that ``tests/test_torch_placement.py``
spawns on the CPU:

    PYTHONPATH=src python tests/torch_placement_worker.py RANK WORLD PORT DIR

It joins the world at ``tcp://localhost:PORT``, reads the reference's
weights and batches from ``DIR/inputs.pt`` (numpy, written by the test
module), places the port's state on a ``(data 2, model 2)`` mesh, runs
every case and saves ``{case: result}`` (whole tensors) to
``DIR/rank{RANK}.pt``; on a failure it writes the traceback to
``DIR/rank{RANK}.err`` and exits 1. It imports torch and the port only.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import traceback

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.tree import tree_leaves, tree_map

MESH = (2, 2)
SERVE_BATCH, PROMPT, MAX_LEN, DECODE_STEPS = 4, 14, 32, 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 16, 3
COUNT_LAYERS = (2, 4)


def configs() -> dict:
    """The reduced fp32 configs of the cases, by name: ``(arch, overrides,
    parallelism mode)``; the test module builds the reference's alike."""
    return {
        "llama": ("llama3-8b", {}, "tp"),
        "qwen": ("qwen2-0.5b", {"remat": True}, "fsdp"),
        "dbrx": ("dbrx-132b", {"fsdp": True, "n_layers": 2}, "tp"),
    }


def port_config(name):
    arch, kw, _ = configs()[name]
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32", **kw)
    if cfg.moe.n_experts:   # capacity for every token: the data ranks' groups drop none
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _whole(tree):
    return [_full(t).detach().clone() for t in tree_leaves(tree)]


def _local_shapes(tree):
    from repro_torch.distributed import sharding as sh

    return sh.local_shapes(tree)


def _counts(comm) -> dict:
    return {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}


def serve_case(mesh, inputs, out):
    """Reduced Llama-3-8B placed in its serving mode: the prefill's logits,
    the forward collectives at two depths, and decode steps over the
    sequence-sharded cache the prefill filled (``kv_len`` per rank
    recorded)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed import sharding as sh
    from repro_torch.models import layers as L
    from repro_torch.models.lm import build_model
    from repro_torch.weights import from_jax_lm_params

    cfg = port_config("llama")
    model = build_model(cfg)
    sh.set_parallelism("tp")
    params = sh.distribute_params(from_jax_lm_params(inputs["llama"]["params"], cfg, "cpu"),
                                  mesh, cfg.fsdp)
    out["llama_local_shapes"] = _local_shapes(params)
    tokens = torch.from_numpy(inputs["llama"]["tokens"])
    logits, caches = model.prefill(params, {"tokens": tokens})
    out["llama_prefill"] = _full(logits)
    for n in COUNT_LAYERS:   # the forward's collectives, by kind
        c = dataclasses.replace(cfg, n_layers=n)
        m = build_model(c)
        p = sh.distribute_params(m.init(torch.Generator().manual_seed(0), device="cpu"),
                                 mesh, c.fsdp)
        with CommDebugMode() as comm:
            m.apply(p, {"tokens": tokens}, mode="prefill")
        out[f"counts_{n}"] = _counts(comm)

    # the decode cache: the prefill's K/V in the first PROMPT rows, placed
    whole = model.init_cache(SERVE_BATCH, MAX_LEN, device="cpu")
    for w, c in zip(whole, caches):
        w.k[:, :, :PROMPT] = _full(c.k)
        w.v[:, :, :PROMPT] = _full(c.v)
    shape = type("S", (), {"global_batch": SERVE_BATCH})
    with sh.use_mesh(mesh):
        specs = sh.cache_specs(cfg, whole, shape)
    cache = sh.place_tree(whole, mesh, specs)
    out["cache_placements"] = [str(p) for p in cache[0].k.placements]
    seen, orig = [], L.decode_attention

    def spy(q, k, v, kv_len, **kw):
        seen.append(kv_len.clone())
        return orig(q, k, v, kv_len, **kw)

    L.decode_attention = spy
    try:
        steps = []
        for i in range(DECODE_STEPS):
            batch = {"tokens": torch.from_numpy(inputs["llama"]["decode_tokens"][i]),
                     "pos": torch.full((SERVE_BATCH,), PROMPT + i, dtype=torch.int64)}
            lg, cache = model.decode_step(params, cache, batch)
            steps.append(_full(lg))
    finally:
        L.decode_attention = orig
    out["llama_decode"] = steps
    out["decode_kv_len"] = seen


def train_case(name, mesh, inputs, out, ckpt_dir=None):
    """``LM.loss`` and its gradients, then TRAIN_STEPS train steps, of the
    placed state; the placed checkpoint's round trip after them."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, make_train_step, place_train_state
    from repro_torch.weights import from_jax_lm_params

    cfg = port_config(name)
    model = build_model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, eps=inputs[name]["eps"]), warmup_steps=2,
                     total_steps=30)
    whole = from_jax_lm_params(inputs[name]["params"], cfg, "cpu")
    params, opt = place_train_state(model, whole, tc, mesh, TRAIN_BATCH)
    out[f"{name}_mode"] = sh.get_parallelism()
    out[f"{name}_local_shapes"] = _local_shapes(params)
    out[f"{name}_moment_shapes"] = _local_shapes(opt["m"]) + _local_shapes(opt["v"])
    b = {k: torch.from_numpy(v) for k, v in inputs[name]["loss_batch"].items()}
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, met = model.loss(live, b)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    out[f"{name}_loss"] = (float(loss), float(met["ce"]), float(met["aux"]))
    out[f"{name}_grads"] = [_full(g) for g in grads]
    step = make_train_step(model, tc)
    metrics = []
    for i in range(TRAIN_STEPS):
        bi = {k: torch.from_numpy(v) for k, v in inputs[name]["batches"][i].items()}
        params, opt, met = step(params, opt, bi)
        metrics.append({k: float(v) for k, v in met.items()})
    out[f"{name}_metrics"] = metrics
    out[f"{name}_params"] = _whole(params)
    out[f"{name}_m"], out[f"{name}_v"] = _whole(opt["m"]), _whole(opt["v"])
    if ckpt_dir is not None:
        out["ckpt"] = checkpoint_case(model, step, params, opt, inputs[name]["batches"][0],
                                      ckpt_dir)


def checkpoint_case(model, step, params, opt, batch, ckpt_dir) -> dict:
    """Rank 0 saves the gathered state; every rank restores and places it
    again: the local shards and one more step from each, bitwise."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.train.checkpoint import place_like, restore_checkpoint, save_checkpoint

    full_p, full_o = sh.full_tree(params), sh.full_tree(opt)
    if sh.is_writer():
        save_checkpoint(ckpt_dir, 7, full_p, full_o)
    dist.barrier()
    got, rp, ro, _ = restore_checkpoint(ckpt_dir)
    rp, ro = place_like(rp, params), place_like(ro, opt)
    local = lambda t: t.to_local() if hasattr(t, "to_local") else t  # noqa: E731
    same = all(torch.equal(local(a), local(b)) and type(a) is type(b)
               and getattr(a, "placements", None) == getattr(b, "placements", None)
               for a, b in zip(tree_leaves([rp, ro]), tree_leaves([params, opt])))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    p1, _, _ = step(params, opt, b)
    p2, _, _ = step(rp, ro, b)
    resumed = all(torch.equal(local(a), local(b)) for a, b in zip(tree_leaves(p1),
                                                                  tree_leaves(p2)))
    return {"step": got, "placed_again": same, "resume_bitwise": resumed}


def run_cases(out_dir) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    out = {}
    serve_case(mesh, inputs, out)
    train_case("qwen", mesh, inputs, out, ckpt_dir=os.path.join(out_dir, "ckpt"))
    train_case("dbrx", mesh, inputs, out)
    return out


def main(argv) -> int:
    rank, world, port, out_dir = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(run_cases(out_dir), os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
