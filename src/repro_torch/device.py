"""The port's device contract: entry points default to the GPU and refuse
to run without one, unless the caller asks for the CPU explicitly."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present (the port never falls back to the CPU on its
    own), and sets the card's numerics contract: full-fp32 convolutions
    and matmuls, and cuDNN restricted to its deterministic algorithms, so
    two runs of one seed give the same bits (the reference's promise)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but no CUDA device is available; "
                "pass device='cpu' to run the port on the CPU")
        # TF32 keeps ~3 decimal digits; the port holds fp32 parity with
        # the reference, so both convolutions and matmuls run in fp32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        # cuDNN's default algorithms (and its autotuner's choice) are not
        # deterministic: two LocalTrains of one client would differ
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; "
                         "use 'cuda' or 'cpu'")
    return dev
