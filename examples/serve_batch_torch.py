"""Batched serving demo on the PyTorch port: KV-cache decode with any
assigned architecture (reduced config) — the port's counterpart of
``examples/serve_batch.py``. Greedy-decodes a batch of prompts and
reports tokens/s + per-family cache footprint.

The weights are drawn on the CPU from seed 0 and moved to the device,
and the prompt is ``dummy_batch``'s (a CPU generator), so every device
decodes the same tokens.

Run:  PYTHONPATH=src python examples/serve_batch_torch.py \\
          --arch rwkv6-1.6b [--device cpu]  # --device cuda is the default
"""
import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves, tree_map


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    m = build_model(args.arch, smoke=True)
    cfg = m.cfg
    params = tree_map(lambda x: x.to(device), m.init(0, device="cpu"))
    max_len = args.prompt_len + args.gen

    batch = m.dummy_batch(0, batch=args.batch, seq=args.prompt_len,
                          device=device)
    print(f"arch={args.arch} (reduced) batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} on {device}")

    t0 = time.time()
    logits, cache = m.prefill(params, batch, max_len=max_len)
    sync()
    prefill_s = time.time() - t0
    cache_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(cache))
    print(f"prefill: {prefill_s:.2f}s | cache {cache_bytes/1e6:.2f}MB "
          f"({'O(1) state' if cfg.family == 'ssm' else 'KV'})")

    with torch.no_grad():
        tok = torch.argmax(logits, dim=-1)
        out = [tok]
        t0 = time.time()
        for i in range(args.gen):
            logits, cache = m.decode_step(params, cache, tok,
                                          args.prompt_len + i)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        sync()
    dt = time.time() - t0
    toks = args.gen * args.batch
    print(f"decode: {toks} tokens in {dt:.2f}s -> {toks/dt:.1f} tok/s")
    gen = np.stack([t.cpu().numpy() for t in out], axis=1)
    print("sample token ids:", gen[0][:16].tolist())
    return {"tokens": gen, "prefill_s": prefill_s, "decode_s": dt,
            "tokens_per_s": toks / dt, "cache_bytes": cache_bytes}


if __name__ == "__main__":
    main()
