"""Provenance stamps: make every artifact traceable to a commit, a host
and a card. Drivers attach :func:`stamp` to ``run_start`` events, so a
number in an artifact can be tied to (code version, machine, runtime,
device and its power limit)."""
from __future__ import annotations

import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

_REPO_ROOT = Path(__file__).resolve().parents[3]


def _run(cmd: List[str], cwd: Optional[Path] = None) -> Optional[str]:
    """stdout of ``cmd``, or None when it cannot run or fails."""
    try:
        out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                             timeout=10)
        return out.stdout.strip() if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def _power_limit() -> Optional[str]:
    """The first card's power limit as ``nvidia-smi`` prints it (e.g.
    ``"700.00 W"``), or None without ``nvidia-smi`` or a card."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    if not out:
        return None
    return out.splitlines()[0].rsplit(",", 1)[-1].strip()


def stamp() -> Dict[str, Any]:
    """Commit + host + runtime provenance (every field best-effort:
    outside a git checkout the git keys are null, and without a card the
    device keys are, never an exception)."""
    sha = _run(["git", "rev-parse", "HEAD"], _REPO_ROOT)
    status = _run(["git", "status", "--porcelain"], _REPO_ROOT)
    cuda = torch.cuda.is_available()
    return {
        "git_sha": sha,
        "git_dirty": bool(status) if status is not None else None,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "machine": platform.machine(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "device_kind": torch.cuda.get_device_name(0) if cuda else None,
        "power_limit": _power_limit() if cuda else None,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
