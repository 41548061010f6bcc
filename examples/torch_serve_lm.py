"""Serving example of the PyTorch + CUDA port: batched prefill + decode
with the KV-cache runtime. Mirrors ``examples/serve_lm.py``.

Builds a small Qwen2-family LM from a seed, then serves a batch of
requests: prefill all prompts at once, decode the new tokens greedily with
per-sequence positions. On the card every decode step's attention over
the cache runs the hand-written flash-decode kernel; on the CPU its plain
PyTorch version.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import dataclasses
import time

import torch

BATCH, PROMPT, GEN = 4, 24, 16


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.device import resolve_device
    from repro_torch.models.layers import KVCache
    from repro_torch.models.lm import build_model

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b"),
        d_model=256, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=4_096, remat=False, attn_chunk=64,
    )
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"[serve] {cfg.name}-reduced {cfg.param_count() / 1e6:.1f}M params; "
          f"batch={BATCH} prompt={PROMPT} gen={GEN} on {dev}")

    prompts = SyntheticTokens(cfg.vocab_size, PROMPT, BATCH, device=dev).batch(0)["tokens"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        t0 = time.time()
        logits, cache = model.prefill(params, {"tokens": prompts})
        # extend the cache to hold the generated tokens
        cache = [KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, GEN)) for t in c))
                 for c in cache]
        sync()
        t_prefill = time.time() - t0

        tok = logits[:, -1].argmax(-1)[:, None]
        out = [tok]
        t0 = time.time()
        for t in range(PROMPT, PROMPT + GEN - 1):
            logits, cache = model.decode_step(
                params, cache, {"tokens": tok, "pos": torch.full((BATCH,), t, device=dev)})
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
        sync()
        t_decode = time.time() - t0

    gen = torch.cat(out, dim=1).cpu()
    if int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab_size:
        raise SystemExit("[serve] a generated token is outside the vocabulary")
    print("generated token ids (greedy):")
    for i in range(BATCH):
        print(f"  seq{i}: {gen[i].tolist()}")
    print(f"[serve] prefill {t_prefill * 1e3:.1f} ms ({BATCH * PROMPT} tokens), "
          f"decode {t_decode / (GEN - 1) * 1e3:.1f} ms/token (first calls included)")
    return gen


if __name__ == "__main__":
    main()
