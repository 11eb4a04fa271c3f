"""Serving launcher: greedy decoding of a request queue over batch slots
(the port's copy of ``repro/launch/serve.py`` on one device). Each slot
takes a request, prefills its prompt through one full-sequence forward
(every "R" layer's recurrence through the ``linear_scan`` kernel on the
card; an encoder-decoder's frames through its encoder first) and decodes
it one token a step until it is done; freed slots are refilled from the
queue. A request's batch is ``dummy_batch`` of ``prompt_len``: for a
VLM that is ``prompt_len - vis_tokens`` text tokens (the prefill, as the
reference's, ignores the patches) and decoding starts at index
``prompt_len``, as in the reference's launcher.

  python -m repro_torch.launch.serve --arch gemma2-2b --smoke \\
      --device cpu --requests 8 --gen 16
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model, as_dtype, build_model


@dataclass
class Request:
    rid: int
    prompt_len: int
    max_new: int
    generated: List[int] = field(default_factory=list)
    done: bool = False
    prefill_s: float = 0.0        # host clock around prefill + first token


@dataclass
class ServeResult:
    requests: List[Request]       # in the order they finished
    n_params: int                 # weights held (tensor sizes)
    init_s: float
    decode_steps: int
    decode_s: float               # host clock over all decode steps
    finite: bool                  # every prefill and decode logit finite

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_steps / self.decode_s if self.decode_s else 0.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str = "gemma2-2b", *, smoke: bool = False,
          batch: int = 4, requests: int = 8, prompt_len: int = 16,
          gen: int = 16, device: DeviceLike = "cuda",
          dtype="float32", seed: int = 0,
          prompts: Optional[Sequence[torch.Tensor]] = None) -> ServeResult:
    """Serve ``requests`` requests of ``prompt_len`` + ``gen`` tokens over
    ``batch`` slots with weights from ``seed``. Request ``i``'s batch is
    ``model.dummy_batch(i, 1, prompt_len)`` (drawn from a CPU
    ``torch.Generator`` seeded with ``i``), its tokens replaced by
    ``prompts[i]`` (1-D token ids, ``prompt_len - vis_tokens`` of them)
    when given; its first decode step is at index ``prompt_len``. Raises
    on ``device="cuda"`` without a GPU, and on prompts of another length."""
    dev = resolve_device(device)
    model: Model = build_model(arch, smoke=smoke)
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init(seed, device=dev, dtype=as_dtype(dtype))
    _sync(dev)
    init_s = time.perf_counter() - t0
    if prompts is not None and len(prompts) < requests:
        raise ValueError(f"{len(prompts)} prompts for {requests} requests")
    text_len = prompt_len - cfg.vis_tokens
    if prompts is not None and any(p.numel() != text_len
                                   for p in prompts[:requests]):
        raise ValueError(f"every prompt must hold {text_len} tokens "
                         f"(prompt_len - vis_tokens)")
    max_len = prompt_len + gen

    def batch_of(rid: int) -> dict:
        b = model.dummy_batch(rid, 1, prompt_len, device=dev)
        if prompts is not None:
            b["tokens"] = prompts[rid].reshape(1, -1).to(dev)
        return b

    queue = [Request(i, prompt_len, gen) for i in range(requests)]
    slots: List[Optional[Request]] = [None] * batch
    caches: List[Optional[dict]] = [None] * batch
    toks = [0] * batch
    pos = [0] * batch
    finite = torch.ones((), dtype=torch.bool, device=dev)
    finished: List[Request] = []
    steps, decode_s = 0, 0.0
    while queue or any(s is not None for s in slots):
        for j in range(batch):
            if slots[j] is None and queue:
                r = slots[j] = queue.pop(0)
                t1 = time.perf_counter()
                logits, caches[j] = model.prefill(params, batch_of(r.rid),
                                                  max_len)
                finite &= torch.isfinite(logits).all()
                toks[j] = int(torch.argmax(logits, dim=-1)[0])
                r.prefill_s = time.perf_counter() - t1
                pos[j] = prompt_len
        t1 = time.perf_counter()
        for j in range(batch):
            r = slots[j]
            if r is None:
                continue
            token = torch.tensor([toks[j]], device=dev)
            logits, caches[j] = tfm.decode_step(params, cfg, caches[j], token,
                                                pos[j])
            finite &= torch.isfinite(logits).all()
            toks[j] = int(torch.argmax(logits, dim=-1)[0])
            r.generated.append(toks[j])
            pos[j] += 1
            steps += 1
            if len(r.generated) >= r.max_new:
                r.done = True
                finished.append(r)
                slots[j] = caches[j] = None
        decode_s += time.perf_counter() - t1
    return ServeResult(requests=finished, n_params=tfm.param_count(params),
                       init_s=init_s, decode_steps=steps, decode_s=decode_s,
                       finite=bool(finite))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    res = serve(args.arch, smoke=args.smoke, batch=args.batch,
                requests=args.requests, prompt_len=args.prompt_len,
                gen=args.gen, device=args.device, dtype=args.dtype)
    for r in res.requests:
        print(f"request {r.rid}: {len(r.generated)} tokens "
              f"-> {r.generated[:8]}...")
    print(f"served {len(res.requests)} requests, {res.decode_steps} decode "
          f"steps in {res.decode_s:.1f}s ({res.decode_tokens_per_s:.1f} "
          f"tok/s)")


if __name__ == "__main__":
    main()
