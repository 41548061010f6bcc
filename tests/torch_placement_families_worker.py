"""One rank of the four-rank gloo world that
``tests/test_torch_placement_families.py`` spawns on the CPU:

    PYTHONPATH=src python tests/torch_placement_families_worker.py RANK WORLD PORT DIR

It joins the world at ``tcp://localhost:PORT``, reads the reference's
weights, batches and requests from ``DIR/inputs.pt`` (numpy, written by the
test module), places the port's state on a ``(data 2, model 2)`` mesh, runs
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
SERVE_BATCH, PROMPT, MAX_LEN, DECODE_STEPS = 4, 14, 32, 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 16, 3
ENGINE_SLOTS, ENGINE_MAX_LEN = 2, 24
MIXER_SCALE = 0.5   # the mixers' own inputs: mLSTM is well conditioned there


def configs() -> dict:
    """The reduced fp32 configs of the cases, by name: ``(arch, overrides)``;
    the test module builds the reference's alike. Jamba is one period
    (7 Mamba layers, 1 attention, 4 MoE) under ``fsdp``; ``whisper3`` has
    3 heads, which a 2-way ``model`` does not divide while its 48 columns
    divide, and trains in Megatron's mode (Whisper's own is ZeRO-3)."""
    return {
        "jamba": ("jamba-1.5-large-398b", {"fsdp": True, "n_layers": 8}),
        "xlstm": ("xlstm-125m", {}),
        "whisper": ("whisper-large-v3", {}),
        "whisper3": ("whisper-large-v3", {"d_model": 48, "n_heads": 3, "n_kv_heads": 3,
                                          "train_parallelism": "tp"}),
    }


def port_config(name):
    arch, kw = configs()[name]
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32", **kw)
    if cfg.moe.n_experts:   # capacity for every token: the data ranks' groups drop none
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _whole(tree):
    from repro_torch.distributed import sharding as sh

    return [_full(t).detach().clone() for t in sh.state_leaves(tree)]


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def fill_cache(cache, prefill):
    """``cache``'s leaves (whole) from a prefill's: a leaf of the same shape
    copied, a longer one (an attention cache) in its first rows."""
    from repro_torch.distributed import sharding as sh

    for full, part in zip(sh.state_leaves(cache), sh.state_leaves(prefill)):
        part = _full(part)
        if tuple(full.shape) == tuple(part.shape):
            full.copy_(part)
        else:
            full[:, :, :part.shape[2]] = part


def serve_case(name, mesh, inputs, out):
    """The placed prefill's logits, decode steps over a placed cache holding
    its states, the cache's local shapes, and the engine's tokens through a
    recycled slot."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.lm import build_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.weights import from_jax_lm_params

    cfg = port_config(name)
    model = build_model(cfg)
    sh.set_parallelism(cfg.parallelism)
    params = sh.distribute_params(from_jax_lm_params(inputs[name]["params"], cfg, "cpu"),
                                  mesh, cfg.fsdp)
    out[f"{name}_local_shapes"] = sh.local_shapes(params)
    batch = _batch(inputs[name]["prompt"])
    logits, caches = model.prefill(params, batch)
    out[f"{name}_prefill"] = _full(logits)
    whole = model.init_cache(SERVE_BATCH, MAX_LEN, device="cpu")
    fill_cache(whole, caches)
    shape = type("S", (), {"global_batch": SERVE_BATCH})
    with sh.use_mesh(mesh):
        specs = sh.cache_specs(cfg, whole, shape)
    cache = sh.place_tree(whole, mesh, specs)
    out[f"{name}_cache_shapes"] = sh.local_shapes(cache)
    steps = []
    for i in range(DECODE_STEPS):
        step = {"tokens": torch.from_numpy(inputs[name]["decode_tokens"][i]),
                "pos": torch.full((SERVE_BATCH,), PROMPT + i, dtype=torch.int64)}
        lg, cache = model.decode_step(params, cache, step)
        steps.append(_full(lg))
    out[f"{name}_decode"] = steps
    out[f"{name}_decode_cache"] = _whole(cache)
    reqs = [Request(prompt=list(p), max_new_tokens=k) for p, k in inputs["requests"]]
    eng = ServeEngine(model, params, slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, device="cpu")
    eng.run(reqs)
    out[f"{name}_served"] = [r.output for r in reqs]
    if any(isinstance(e, dict) for e in eng.cache):
        out[f"{name}_zeroing"] = zeroing_case(eng)


def zeroing_case(eng) -> list:
    """Every state leaf's local rows set to ones, then slot 1 admitted:
    ``[(slot rows a rank holds, zeros there after), ...]`` a leaf."""
    from repro_torch.distributed import sharding as sh

    res = []
    leaves = [t for e in eng.cache if isinstance(e, dict) for t in e.values()]
    for t in leaves:
        t.to_local().fill_(1.0)
    eng._reset_state(1)
    for t in leaves:
        local = t.to_local()
        _, r = sh.split_group(t, 1)
        b = local.shape[1]
        held = [r * b + j for j in range(b)]
        zeros = [j for j in range(b) if bool((local[:, j] == 0).all())]
        res.append((held, [held[j] for j in zeros], int((local == 0).sum())))
    return res


def train_case(name, mesh, inputs, out, ckpt_dir=None):
    """``loss`` and its gradients, then TRAIN_STEPS train steps, of the
    placed state; the placed checkpoint's round trip after them."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, make_train_step, place_train_state
    from repro_torch.weights import from_jax_lm_params

    cfg = port_config(name)
    model = build_model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, eps=inputs[name]["eps"]),
                     warmup_steps=2, total_steps=30)
    whole = from_jax_lm_params(inputs[name]["params"], cfg, "cpu")
    params, opt = place_train_state(model, whole, tc, mesh, TRAIN_BATCH)
    out[f"{name}_mode"] = sh.get_parallelism()
    out[f"{name}_train_shapes"] = sh.local_shapes(params)
    out[f"{name}_moment_shapes"] = sh.local_shapes(opt["m"]) + sh.local_shapes(opt["v"])
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, met = model.loss(live, _batch(inputs[name]["loss_batch"]))
    grads = torch.autograd.grad(loss, tree_leaves(live))
    out[f"{name}_loss"] = (float(loss), float(met["ce"]), float(met["aux"]))
    out[f"{name}_grads"] = [_full(g) for g in grads]
    step = make_train_step(model, tc)
    metrics = []
    for i in range(TRAIN_STEPS):
        params, opt, m = step(params, opt, _batch(inputs[name]["batches"][i]))
        metrics.append({k: float(v) for k, v in m.items()})
    out[f"{name}_metrics"] = metrics
    out[f"{name}_params"] = _whole(params)
    out[f"{name}_m"], out[f"{name}_v"] = _whole(opt["m"]), _whole(opt["v"])
    if ckpt_dir is not None:
        out[f"{name}_ckpt"] = checkpoint_case(step, params, opt,
                                              _batch(inputs[name]["batches"][0]), ckpt_dir)
    sh.set_parallelism("tp")


def checkpoint_case(step, params, opt, batch, ckpt_dir) -> dict:
    """Rank 0 saves the gathered state; every rank restores and places it
    again: the local shards and one more step from each, bitwise."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.train.checkpoint import place_like, restore_checkpoint, save_checkpoint

    full_p, full_o = sh.full_tree(params), sh.full_tree(opt)
    if sh.is_writer():
        save_checkpoint(ckpt_dir, 5, full_p, full_o)
    dist.barrier()
    got, rp, ro, _ = restore_checkpoint(ckpt_dir)
    rp, ro = place_like(rp, params), place_like(ro, opt)
    local = lambda t: t.to_local() if hasattr(t, "to_local") else t  # noqa: E731
    same = all(torch.equal(local(a), local(b)) and type(a) is type(b)
               and getattr(a, "placements", None) == getattr(b, "placements", None)
               for a, b in zip(tree_leaves([rp, ro]), tree_leaves([params, opt])))
    p1, _, _ = step(params, opt, batch)
    p2, _, _ = step(rp, ro, batch)
    resumed = all(torch.equal(local(a), local(b)) for a, b in zip(tree_leaves(p1),
                                                                  tree_leaves(p2)))
    return {"step": got, "placed_again": same, "resume_bitwise": resumed}


def counts_case(mesh, out):
    """The collectives of one placed block's forward, by kind, for each
    mixer: Jamba's Mamba (``fsdp`` off, so no parameter is gathered),
    xLSTM's two blocks with their heads over ``model`` and with 3 heads,
    which stay whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed import sharding as sh
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.lm import _layer_leaf, build_model

    sh.set_parallelism("tp")
    cases = (("mamba", "jamba", {"fsdp": False}, 0, ssm.mamba),
             ("mlstm", "xlstm", {}, 0, xlstm.mlstm),
             ("slstm", "xlstm", {}, 1, xlstm.slstm),
             ("mlstm_whole_heads", "xlstm", {"d_model": 48, "n_heads": 3, "n_kv_heads": 3}, 0,
              xlstm.mlstm),
             ("slstm_whole_heads", "xlstm", {"d_model": 48, "n_heads": 3, "n_kv_heads": 3}, 1,
              xlstm.slstm))
    for tag, name, kw, pos, fn in cases:
        cfg = dataclasses.replace(port_config(name), **kw)
        model = build_model(cfg)
        params = sh.distribute_params(model.init(torch.Generator().manual_seed(2), device="cpu"),
                                      mesh, cfg.fsdp)
        pp = tree_map(lambda t: _layer_leaf(t, 0), params["layers"][pos])["mixer"]
        g = torch.Generator().manual_seed(3)
        x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=g) * MIXER_SCALE
        xp = distribute_tensor(x, mesh, [Shard(0), Replicate()], src_data_rank=None)
        with CommDebugMode() as comm:
            fn(pp, cfg, xp)
        out[f"counts_{tag}"] = {str(k).split(".")[-1]: v
                                for k, v in comm.get_comm_counts().items()}


def run_cases(out_dir) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    out = {}
    counts_case(mesh, out)
    for name in configs():
        serve_case(name, mesh, inputs, out)
        train_case(name, mesh, inputs, out,
                   ckpt_dir=os.path.join(out_dir, "ckpt") if name == "jamba" else None)
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
