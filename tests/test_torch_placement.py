"""The LM state placed over a mesh, on a real four-rank world: a ``(data 2,
model 2)`` mesh of four gloo processes on the CPU, against the reference's
unsharded programs.

A module fixture draws the reference's weights and batches (numpy), spawns
the world once (``tests/torch_placement_worker.py``, one process a rank,
with a timeout of its own) and hands back every rank's results; the
reference's side is computed here. The cases: reduced Llama-3-8B placed in
its serving mode (Megatron TP), its prefill's logits and four decode steps
over a cache whose sequence is split over ``model`` (the first two with no
valid key on the second model rank); reduced Qwen2-0.5B in its training
mode (ZeRO-3 over all four ranks) and reduced DBRX (TP with ``fsdp``):
``LM.loss`` and its gradients against ``jax.grad``, three train steps
against the reference's jitted step, with the tolerances and Adam eps of
the unplaced parity tests; the placed checkpoint's round trip, bitwise;
every rank's local shard shapes against the reference's ``param_specs``
on the same mesh; the forward's collectives a layer, counted by kind; and
the decode combine across slices on one process.
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

import torch_placement_worker as W
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.distributed import sharding as jsh
from repro.models.lm import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from torch.distributed.tensor import Shard

from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 4
SPAWN_TIMEOUT_S = 300
REL, ABS = 1e-5, 1e-6          # fp32: max |port - ref| <= REL * max|ref| + ABS
EPS = {"qwen": 1e-6, "dbrx": 1e-4}   # Adam's eps, as the unplaced parity tests


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jcfg(name):
    arch, kw, _ = W.configs()[name]
    cfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="float32", **kw)
    if cfg.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(vocab, seed, b=W.TRAIN_BATCH, s=W.TRAIN_SEQ):
    """Uniform tokens and targets, the first three targets masked."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, vocab, (b, s)).astype(np.int64) for k in ("tokens", "targets")}
    out["targets"][0, :3] = -1
    return out


def _train_batch(vocab, step):
    """The reference's synthetic token batch of ``step``, as the unplaced
    train-step parity tests take theirs: at Adam's eps of 1e-6 an update
    moves with slope lr / eps in a near-zero gradient, and uniform tokens
    over a 512-token vocabulary leave many such gradients, whose fp32 sums
    in two orders already part the unplaced port from the reference by
    1.07e-5 after one step."""
    return {k: np.array(v, np.int64) for k, v in
            JSyntheticTokens(vocab, W.TRAIN_SEQ, W.TRAIN_BATCH).batch(step).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``(inputs, [every rank's results])`` from one spawn of the world."""
    out = tmp_path_factory.mktemp("placed")
    inputs = {}
    for seed, name in enumerate(("llama", "qwen", "dbrx")):
        jm = jbuild_model(_jcfg(name))
        jp = jm.init(jax.random.key(seed))
        vocab = _jcfg(name).vocab_size
        inputs[name] = {"params": _np(jp), "eps": EPS.get(name),
                        "loss_batch": _batch(vocab, 100 + seed),
                        "batches": [_train_batch(vocab, i) for i in range(W.TRAIN_STEPS)]}
    rng = np.random.default_rng(7)
    vocab = _jcfg("llama").vocab_size
    inputs["llama"]["tokens"] = rng.integers(0, vocab, (W.SERVE_BATCH, W.PROMPT))
    inputs["llama"]["decode_tokens"] = rng.integers(0, vocab, (W.DECODE_STEPS, W.SERVE_BATCH, 1))
    torch.save(inputs, out / "inputs.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    worker = os.path.join(os.path.dirname(__file__), "torch_placement_worker.py")
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
    return inputs, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _close(got, want, rel=REL, abs_=ABS, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, tol = np.abs(got - want).max(), rel * np.abs(want).max() + abs_
    assert err <= tol, (what, err, tol)


# ------------------------------------------------------------- serving (tp)

def _ref_serve(inputs):
    """The reference's unsharded prefill, then its decode steps over a
    cache holding the prefill's K/V."""
    jm = jbuild_model(_jcfg("llama"))
    jp = jax.tree_util.tree_map(jnp.asarray, inputs["llama"]["params"])
    logits, caches = jm.prefill(jp, {"tokens": jnp.asarray(inputs["llama"]["tokens"],
                                                           jnp.int32)})
    cache = jm.init_cache(W.SERVE_BATCH, W.MAX_LEN)
    cache = [type(c)(c.k.at[:, :, :W.PROMPT].set(p.k), c.v.at[:, :, :W.PROMPT].set(p.v))
             for c, p in zip(cache, caches)]
    steps = []
    for i in range(W.DECODE_STEPS):
        batch = {"tokens": jnp.asarray(inputs["llama"]["decode_tokens"][i], jnp.int32),
                 "pos": jnp.full((W.SERVE_BATCH,), W.PROMPT + i, jnp.int32)}
        lg, cache = jm.decode_step(jp, cache, batch)
        steps.append(np.asarray(lg))
    return np.asarray(logits), steps


def test_placed_prefill_and_decode_match_the_reference(world):
    """Prefill logits, then four decode steps over the sequence-sharded
    cache (positions 14-17 across the two model slices of 16 rows), on
    every rank, against the reference's unsharded steps."""
    inputs, ranks = world
    want_prefill, want_steps = _ref_serve(inputs)
    for r, res in enumerate(ranks):
        # batch rows over data, the sequence over model
        assert res["cache_placements"] == [str(Shard(1)), str(Shard(2))]
        _close(res["llama_prefill"], want_prefill, what=("prefill", r))
        for i, (got, want) in enumerate(zip(res["llama_decode"], want_steps)):
            _close(got, want, what=("decode", r, i))


def test_decode_runs_on_each_ranks_slice_with_kv_len_clipped(world):
    """Each model rank's kernel call sees its own slice's ``kv_len``: the
    second slice holds no valid key in the first two steps (0 on every row)
    and the positions past its start after them; every rank calls the
    kernel (and the combine's collectives) at every step and layer."""
    _, ranks = world
    layers = W.port_config("llama").n_layers
    for r, res in enumerate(ranks):
        seen = res["decode_kv_len"]
        assert len(seen) == W.DECODE_STEPS * layers
        model_rank = r % W.MESH[1]
        for i in range(W.DECODE_STEPS):
            pos = W.PROMPT + i
            want = min(max(pos + 1 - model_rank * W.MAX_LEN // 2, 0), W.MAX_LEN // 2)
            for kv in seen[i * layers:(i + 1) * layers]:
                assert kv.tolist() == [want] * (W.SERVE_BATCH // W.MESH[0]), (r, i)
    assert any(kv.sum() == 0 for kv in ranks[1]["decode_kv_len"])


def test_forward_collectives_follow_the_megatron_layout(world):
    """A TP forward issues exactly one all-reduce after each row-parallel
    projection (attention's ``wo``, the MLP's ``w_down``) and one for the
    vocab-parallel embedding: two a layer, one more in all, and no
    all-gather or reduce-scatter."""
    _, ranks = world
    lo, hi = W.COUNT_LAYERS

    def kinds(counts):   # DTensor's functional all_reduce, and c10d's allreduce_
        out = {}
        for name, n in counts.items():
            kind = "all-reduce" if name in ("all_reduce", "allreduce_") else name
            out[kind] = out.get(kind, 0) + n
        return out

    for res in ranks:
        a, b = kinds(res[f"counts_{lo}"]), kinds(res[f"counts_{hi}"])
        assert set(a) == set(b) == {"all-reduce"}, (a, b)
        assert (b["all-reduce"] - a["all-reduce"]) / (hi - lo) == 2
        assert a["all-reduce"] == 2 * lo + 1


# ----------------------------------------------------------- training

def _ref_loss_and_grads(name, inputs):
    jm = jbuild_model(_jcfg(name))
    jp = jax.tree_util.tree_map(jnp.asarray, inputs[name]["params"])
    b = {k: jnp.asarray(v, jnp.int32) for k, v in inputs[name]["loss_batch"].items()}
    (loss, met), grads = jax.value_and_grad(jm.loss, has_aux=True)(jp, b)
    return float(loss), met, jax.tree_util.tree_leaves(grads)


@pytest.mark.parametrize("name", ["qwen", "dbrx"])
def test_placed_loss_and_grads_match_the_reference(world, name):
    inputs, ranks = world
    loss, met, grads = _ref_loss_and_grads(name, inputs)
    for r, res in enumerate(ranks):
        assert res[f"{name}_mode"] == W.configs()[name][2]
        got_loss, got_ce, got_aux = res[f"{name}_loss"]
        assert abs(got_loss - loss) <= 1e-5 and abs(got_ce - float(met["ce"])) <= 1e-5
        assert abs(got_aux - float(met["aux"])) <= 1e-5
        assert len(res[f"{name}_grads"]) == len(grads)
        for i, (g, w) in enumerate(zip(res[f"{name}_grads"], grads)):
            _close(g, w, what=(name, r, i))


@pytest.mark.parametrize("name", ["qwen", "dbrx"])
def test_three_placed_train_steps_match_the_reference(world, name):
    """Three steps from one placed state on the same batches: the metrics
    within 1e-5, params within 1e-5, the first moments within 1e-5 of each
    leaf's largest and the second within 2e-5."""
    inputs, ranks = world
    jcfg = _jcfg(name)
    jm = jbuild_model(jcfg)
    jtc = jts.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-3, eps=EPS[name]),
                          warmup_steps=2, total_steps=30)
    jp = jax.tree_util.tree_map(jnp.asarray, inputs[name]["params"])
    jo = jadamw.adamw_init(jp, jtc.optimizer)
    jstep = jax.jit(jts.make_train_step(jm, jtc))
    jmets = []
    for i in range(W.TRAIN_STEPS):
        b = {k: jnp.asarray(v, jnp.int32) for k, v in inputs[name]["batches"][i].items()}
        jp, jo, jmet = jstep(jp, jo, b)
        jmets.append({k: float(v) for k, v in jmet.items()})
    for r, res in enumerate(ranks):
        for got, want in zip(res[f"{name}_metrics"], jmets):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                           err_msg=(name, r, k))
        for got, want in zip(res[f"{name}_params"], jax.tree_util.tree_leaves(jp)):
            _close(got, want, rel=0.0, abs_=1e-5, what=(name, r, "param"))
        for key, rel in (("m", 1e-5), ("v", 2e-5)):
            for got, want in zip(res[f"{name}_{key}"], jax.tree_util.tree_leaves(jo[key])):
                _close(got, want, rel=rel, abs_=0.0, what=(name, r, key))


def test_placed_checkpoint_round_trip_is_bitwise(world):
    """Rank 0 writes the gathered state in the unplaced file format; every
    rank restores it, places it again with the same placements and the same
    bits, and a step from it equals a step from the live state bitwise."""
    _, ranks = world
    for res in ranks:
        assert res["ckpt"] == {"step": 7, "placed_again": True, "resume_bitwise": True}


# ------------------------------------------------------- shard shapes

def _ref_shard_shapes(name, fsdp, mode):
    """The reference's ``param_specs`` of the reduced config on a (data 2,
    model 2) abstract mesh, as each rank's shard shapes (tree-leaf order)."""
    jp = jbuild_model(_jcfg(name)).abstract_params()
    jmesh = jsh.abstract_mesh(W.MESH, ("data", "model"))
    prev = jax.sharding.get_abstract_mesh
    jax.sharding.get_abstract_mesh = lambda: jmesh
    jsh.set_parallelism(mode)
    try:
        specs = jsh.param_specs(jp, fsdp)
    finally:
        jax.sharding.get_abstract_mesh = prev
        jsh.set_parallelism("tp")
    sizes = {"data": W.MESH[0], "model": W.MESH[1]}
    flat_s = jax.tree_util.tree_leaves(specs, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))
    out = []
    for leaf, spec in zip(jax.tree_util.tree_leaves(jp), flat_s):
        shape = []
        for i, n in enumerate(leaf.shape):
            e = spec[i] if i < len(spec) else None
            axes = e if isinstance(e, tuple) else ((e,) if e else ())
            shape.append(n // int(np.prod([sizes[a] for a in axes])))
        out.append(tuple(shape))
    return out


@pytest.mark.parametrize("name", ["llama", "qwen", "dbrx"])
def test_local_shard_shapes_are_the_references(world, name):
    _, ranks = world
    arch, kw, mode = W.configs()[name]
    want = _ref_shard_shapes(name, W.port_config(name).fsdp, mode)
    for res in ranks:
        assert [tuple(s) for s in res[f"{name}_local_shapes"]] == want
        if name != "llama":   # the moments beside their parameters
            assert [tuple(s) for s in res[f"{name}_moment_shapes"]] == want + want


# --------------------------------------------------- the decode combine

@pytest.mark.parametrize("lens", [[20, 5, 31], [40, 33, 60], [32, 1, 64]])
def test_decode_combine_across_slices_equals_the_whole_cache(lens):
    """The kernel's plain version on two halves of a cache, ``kv_len``
    clipped to each, combined by their log-sum-exp, equals the whole
    cache's output; a half with no valid key has ``lse = -inf``, output 0
    and weight 0 (the first lengths leave the second half empty on every
    row, the last on some)."""
    rng = np.random.default_rng(3)
    B, KV, G, hd, S = 3, 2, 4, 16, 64
    q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, KV, hd)).astype(np.float32))
    kv_len = torch.tensor(lens, dtype=torch.int32)
    want = decode_attention_ref(q, k, v, kv_len)
    outs, lses = [], []
    for h in range(2):
        part = slice(h * S // 2, (h + 1) * S // 2)
        clip = (kv_len - h * S // 2).clamp(0, S // 2).to(torch.int32)
        o, lse = decode_attention(q, k[:, part].contiguous(), v[:, part].contiguous(), clip,
                                  return_lse=True)
        outs.append(o)
        lses.append(lse)
    empty = torch.tensor(lens) <= S // 2
    assert torch.all(lses[1][empty] == -torch.inf) and torch.all(outs[1][empty] == 0)
    lse = torch.stack(lses)
    m = lse.amax(0)
    w = torch.exp(lse - m)
    got = (torch.stack(outs) * w[..., None]).sum(0) / w.sum(0)[..., None]
    _close(got, want.numpy(), what=lens)
    whole = torch.logsumexp(torch.where(
        torch.arange(S)[None, None, None] < kv_len[:, None, None, None],
        torch.einsum("bkgh,btkh->bkgt", q, k) * hd ** -0.5, -torch.inf), dim=-1)
    _close(torch.logaddexp(lses[0], lses[1]), whole.numpy())
