"""Train-state checkpoints: parameters, optimizer state and step count.

Counterpart of rwkv_lm_ext_tpu/checkpoint/orbax_io.py (``save_checkpoint``,
``load_checkpoint``), which writes the JAX TrainState with Orbax. Orbax is
not involved here: the port's train state is a dict of tensors and Python
scalars (``train.optim.Optimizer.state_dict``), written with ``torch.save``
and read back with ``torch.load(weights_only=True)``, so a resumed run
continues bit for bit. The .pth files of the model and the adapters stay the
interchange format; this file is for exact resume only
(``--save-train-state`` / ``--resume-train-state``).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write ``tree`` to ``path``, through a temporary file renamed into
    place, so that an interrupted save leaves the previous state whole."""
    tmp = f"{path}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The tree that ``save_checkpoint`` wrote, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
