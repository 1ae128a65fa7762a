"""The ``--platform`` flag of the port's command-line entry points."""
from __future__ import annotations

import torch


def resolve_device(platform: str) -> torch.device:
    """``torch.device(platform)``; exits with a message when ``platform`` is
    ``cuda`` and no CUDA device is present (the kernels run only there)."""
    if platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--platform cuda: no CUDA device (use --platform cpu for a CPU run)")
    return torch.device(platform)
