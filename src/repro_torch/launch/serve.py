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

With ``--debug-mesh`` the slots are served over the reference's small
mesh of the ranks that exist (``launch.mesh.make_debug_mesh``): weights
stored by ``param_specs`` as they are drawn, each slot's prompt
prefilled over the mesh and decoded through ``serve.make_serve_step``
(a slot's batch of 1: the cache's sequence, a recurrent state's
channels or heads and an encoder-decoder's cross-attention frames cut
over the data axes; the heads, the RG-LRU's channels, d_ff, experts and
vocabulary over ``model``; every arch, the recurrent and
encoder-decoder ones too). Under ``torchrun``
it joins torchrun's group (gloo on the CPU; NCCL and gloo on the card, a
card a rank); alone it is the (1, 1) mesh, whose tokens are the plain
run's.

  python -m repro_torch.launch.serve --arch gemma2-2b --smoke \\
      --device cpu --requests 8 --gen 16
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --smoke \\
      --debug-mesh --device cpu [--arch recurrentgemma-2b]
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

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
          prompts: Optional[Sequence[torch.Tensor]] = None,
          mesh=None) -> ServeResult:
    """Serve ``requests`` requests of ``prompt_len`` + ``gen`` tokens over
    ``batch`` slots with weights from ``seed``. Request ``i``'s batch is
    ``model.dummy_batch(i, 1, prompt_len)`` (drawn from a CPU
    ``torch.Generator`` seeded with ``i``), its tokens replaced by
    ``prompts[i]`` (1-D token ids, ``prompt_len - vis_tokens`` of them)
    when given; its first decode step is at index ``prompt_len``. With
    ``mesh`` (a live ``DeviceMesh`` on ``device``), over it: every rank of
    the mesh calls this, and each slot's steps run through
    ``make_serve_step(model, mesh, batch=1, ...)``. Raises on
    ``device="cuda"`` without a GPU, and on prompts of another length."""
    dev = resolve_device(device)
    model: Model = build_model(arch, smoke=smoke)
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init(seed, device=dev, dtype=as_dtype(dtype), mesh=mesh)
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
    if mesh is None:
        def step(params, cache, token, index):
            return tfm.decode_step(params, cfg, cache, token, index)
    else:
        from repro_torch.serve.decode import make_serve_step
        step, _ = make_serve_step(model, mesh, batch=1, max_len=max_len)

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
                logits = _whole(logits)
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
            logits, caches[j] = step(params, caches[j], token, pos[j])
            logits = _whole(logits)
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


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (the logits of a mesh step), else ``x``."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def main(argv: Optional[Sequence[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="serve over the small mesh of the ranks that "
                         "exist (under torchrun: torchrun's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    device, mesh, started = args.device, None, False
    if args.debug_mesh:
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.launch.train import _torchrun_group
        joined = _torchrun_group(args.device)
        started = joined is not None or not dist.is_initialized()
        device = resolve_device(joined or args.device)
        mesh = make_debug_mesh(device=device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    try:
        res = serve(args.arch, smoke=args.smoke, batch=args.batch,
                    requests=args.requests, prompt_len=args.prompt_len,
                    gen=args.gen, device=device, dtype=args.dtype, mesh=mesh)
    finally:
        if started:
            dist.destroy_process_group()
    if lead:
        if mesh is not None:
            print(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        for r in res.requests:
            print(f"request {r.rid}: {len(r.generated)} tokens "
                  f"-> {r.generated[:8]}...")
        print(f"served {len(res.requests)} requests, {res.decode_steps} "
              f"decode steps in {res.decode_s:.1f}s "
              f"({res.decode_tokens_per_s:.1f} tok/s)")
    return res


if __name__ == "__main__":
    main()
