"""Training callbacks: metrics logging, checkpoints and LISA's schedule.

Counterpart of rwkv_lm_ext_tpu/train/callbacks.py:28-165: ``MetricsLogger``
(it/s, Kt/s, ``train_log.txt`` lines), ``save_lora_checkpoint``,
``save_states_checkpoint`` and ``LisaSchedule``; and of the JAX trainers' own save functions
(train/cli.py): ``save_score_head`` (``score-step{N}.pth``, ``score.weight``
(n, C)) and ``save_model_checkpoint``, the base checkpoint's layout with the
heads attached to the model beside it (``score.weight``, or ``dense.*`` and
``ln_dense.*``) and without the RetroMAE decoder, as ``params_to_state_dict``
plus the heads writes it. The JAX logger takes Kt/s as ctx_len *
micro_bsz tokens over the time since its previous log; the bucket sampler's
batch holds micro_bsz * 64 // bucket rows of the bucket's length, and a log
every N steps spans N steps, so both rates were off (ROADMAP.md C.8). This
one divides the steps and tokens actually trained since the previous log by
the time they took. The files
are plain {key: fp32 tensor} dicts written with torch.save, so the JAX
package's torch-free ``load_torch_pth`` reads them. The logger has no wandb
(``--wandb-project`` needs a network service, so the CLI refuses it).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.adapters.lora import adapter_state_dict, lora_state_dict


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._t_last = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    def on_step(self, step: int, metrics: Dict[str, Any], lr: float, *,
                steps: int, tokens: int) -> Dict:
        """The step's metrics and lr, with it/s and Kt/s over the `steps`
        steps and `tokens` tokens trained since the previous call (none at
        the first call)."""
        now = time.time()
        out = {k: float(v) for k, v in metrics.items()}
        out["lr"] = float(lr)
        if self._t_last is not None:
            dt = now - self._t_last
            out["it/s"] = steps / dt if dt > 0 else float("inf")
            out["Kt/s"] = tokens / dt / 1000.0 if dt > 0 else float("inf")
        self._t_last = now
        return out

    def on_epoch_end(self, epoch: int, epoch_loss: float, lr: float) -> None:
        if not self.log_dir:
            return
        with open(os.path.join(self.log_dir, "train_log.txt"), "a") as f:
            f.write(
                f"{epoch} {epoch_loss:.6f} {math.exp(epoch_loss):.4f} "
                f"{lr:.8f} {time.strftime('%Y-%m-%d %H:%M:%S')}\n"
            )


def save_lora_checkpoint(model, path: str) -> None:
    """``<path>.lora_A`` (r, in) and ``.lora_B`` (out, r), fp32."""
    torch.save(lora_state_dict(model), path)


def save_states_checkpoint(model, path: str) -> None:
    """``blocks.{i}.att.time_state`` (H, N, N) fp32 only."""
    torch.save({
        f"blocks.{i}.att.time_state": block.att.time_state.detach().float().contiguous().cpu()
        for i, block in enumerate(model.blocks) if block.att.time_state is not None
    }, path)


def save_score_head(score, path: str) -> None:
    """``score.weight`` (num_labels, C) fp32."""
    torch.save({"score.weight": score.weight.detach().float().contiguous().cpu()}, path)


def save_model_checkpoint(model, path: str) -> None:
    """Every weight of the model and of the heads attached to it, fp32, in
    the base checkpoint's flat layout; the RetroMAE decoder stays out."""
    torch.save({k: v.detach().float().contiguous().cpu() for k, v in model.state_dict().items()
                if not k.startswith("onelayer_decoder.")}, path)


def gather_model_state(model, mesh) -> Optional[Dict[str, torch.Tensor]]:
    """The whole model's parameters on the CPU, on rank 0 of a tp or pp run
    (None on the others; every rank calls it): tp slices gathered over the
    tp ranks (parallel.tp.whole_state_dict), pipeline stages sent to the
    first stage of dp index 0."""
    import torch.distributed as dist

    from rwkv_lm_ext_tpu_torch.parallel.tp import whole_state_dict

    if getattr(mesh, "pp", 1) == 1:
        return whole_state_dict(model, mesh)
    if mesh.dp_rank != 0:
        return None
    mine = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    parts = [None] * mesh.pp if mesh.stage == 0 else None
    dist.gather_object(mine, parts, dst=0, group=mesh.pp_group)
    if mesh.stage != 0:
        return None
    return {k: v for part in parts for k, v in part.items()}


def save_model_state(state: Dict[str, torch.Tensor], path: str) -> None:
    """``save_model_checkpoint`` of a gathered state dict."""
    torch.save({k: v.float().contiguous() for k, v in state.items()
                if not k.startswith("onelayer_decoder.")}, path)


def save_lora_state(state: Dict[str, torch.Tensor], path: str) -> None:
    """``save_lora_checkpoint`` of a gathered state dict: its
    ``<path>.lora_A`` (in, r) / ``.lora_B`` (r, out) pairs in the reference
    layout."""
    paths = [k[:-len(".lora_A")] for k in state if k.endswith(".lora_A")]
    torch.save(adapter_state_dict({p: {"A": state[f"{p}.lora_A"], "B": state[f"{p}.lora_B"]}
                                   for p in paths}), path)


@dataclasses.dataclass
class LisaSchedule:
    """LISA layerwise sampling: every ``interval`` steps ``k`` random blocks
    train, drawn from ``np.random.default_rng(seed + step // interval)`` as
    the JAX schedule draws them; the parameters outside the blocks (emb,
    ln_out, head) follow ``train_head``."""

    n_layer: int
    k: int = 2
    interval: int = 20
    train_head: bool = True
    seed: int = 0

    def active_layers(self, step: int) -> List[int]:
        rng = np.random.default_rng(self.seed + step // self.interval)
        return sorted(rng.choice(self.n_layer, size=min(self.k, self.n_layer),
                                 replace=False).tolist())

    def trainable_mask(self, names, step: int) -> Dict[str, bool]:
        """{name: trains at this step} of parameter names in the BlinkDL
        layout (``blocks.{i}.…``, ``emb.weight``, ``ln_out.*``, ``head.weight``)."""
        active = set(self.active_layers(step))
        return {n: int(n.split(".")[1]) in active if n.startswith("blocks.") else self.train_head
                for n in names}
