"""Train-state checkpoints: parameters, optimizer state and step count.

Counterpart of rwkv_lm_ext_tpu/checkpoint/orbax_io.py (``save_checkpoint``,
``load_checkpoint``), which writes the JAX TrainState with Orbax. Orbax is
not involved here: the port's train state is a dict of tensors and Python
scalars (``train.optim.Optimizer.state_dict``), written with ``torch.save``
and read back with ``torch.load(weights_only=True)``, so a resumed run
continues bit for bit. The .pth files of the model and the adapters stay the
interchange format; this file is for exact resume only
(``--save-train-state`` / ``--resume-train-state``).

A multi-process run (train/optim.py ``ShardedOptimizer``: each rank holds
its own moments, and under tp or pp its own parameters) writes one file a
rank, ``<path>.rank{r}``, and rank 0 writes ``<path>`` itself as a manifest
({"sharded": {"world": n, "files": [...]}}); ``load_rank_checkpoint`` reads a
rank's file through the manifest and refuses another number of ranks (the
state resumes at the same dp / tp / pp, which the optimizer checks).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch
import torch.distributed as dist


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write ``tree`` to ``path``, through a temporary file renamed into
    place, so that an interrupted save leaves the previous state whole."""
    tmp = f"{path}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The tree that ``save_checkpoint`` wrote, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_rank_checkpoint(path: str, tree: Dict[str, Any], rank: int, world: int) -> None:
    """Every rank writes its ``tree`` to ``<path>.rank{rank}``; when all
    have (a barrier), rank 0 writes the manifest at ``path``. Every rank
    calls it."""
    save_checkpoint(f"{path}.rank{rank}", tree)
    if world > 1:
        dist.barrier()
    if rank == 0:
        files = [f"{os.path.basename(path)}.rank{r}" for r in range(world)]
        save_checkpoint(path, {"sharded": {"world": world, "files": files}})


def load_rank_checkpoint(path: str, rank: int = 0, world: int = 1) -> Dict[str, Any]:
    """The tree of ``rank`` (of ``world``) from a manifest that
    ``save_rank_checkpoint`` wrote, or the single tree of a one-process
    ``save_checkpoint``."""
    tree = load_checkpoint(path)
    manifest = tree.get("sharded") if isinstance(tree, dict) else None
    if manifest is None:
        if world != 1:
            raise ValueError(f"{path} is a one-process train state; this run has {world} ranks")
        return tree
    if manifest["world"] != world:
        raise ValueError(f"{path} holds the train state of {manifest['world']} ranks; this run "
                         f"has {world}: resume with the same dp / tp / pp")
    return load_checkpoint(os.path.join(os.path.dirname(path), manifest["files"][rank]))
