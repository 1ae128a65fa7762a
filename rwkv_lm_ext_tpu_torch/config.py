"""Model and training configuration of the PyTorch port.

Counterpart of rwkv_lm_ext_tpu/config.py (ModelConfig, TrainConfig,
rwkv6_1b6 and the special token ids). The JAX ModelConfig also carries TPU kernel knobs
(fused_chunk, fused_prologue, packed_decode, fused_decode, wkv_exact) and
their RWKV_* environment overrides. They pick between Pallas code paths that
the port does not have: its WKV kernel is a sequential recurrence that is
exact at any decay, so there is no chunk length or factoring to choose.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of an RWKV-5/6 model, as sniffed from a
    checkpoint (checkpoint.pth.sniff_model_config)."""

    n_layer: int
    n_embd: int
    vocab_size: int
    dim_att: int = 0          # defaults to n_embd
    dim_ffn: int = 0          # defaults to 3.5*n_embd rounded down to /32
    head_size: int = 64
    head_size_divisor: int = 8
    version: float = 6.0
    # activations and weights; WKV state, norm statistics and the decay
    # low-rank stay fp32
    dtype: str = "bfloat16"
    # what the parameters are stored in. "" = the same as dtype, which is
    # what serving and the adapter trainers hold; the full-parameter encoder
    # trainers hold "float32" master weights and cast to dtype at each use,
    # as the JAX package does everywhere (its param_dtype, config.py:47)
    param_dtype: str = ""

    def __post_init__(self):
        if not self.param_dtype:
            object.__setattr__(self, "param_dtype", self.dtype)
        if self.dim_att == 0:
            object.__setattr__(self, "dim_att", self.n_embd)
        if self.dim_ffn == 0:
            object.__setattr__(
                self, "dim_ffn", int((self.n_embd * 3.5) // 32 * 32)
            )
        if self.dim_att % self.head_size != 0:
            raise ValueError(
                f"dim_att {self.dim_att} is not a multiple of head_size "
                f"{self.head_size}"
            )

    @property
    def n_head(self) -> int:
        return self.dim_att // self.head_size

    @property
    def ln_x_eps(self) -> float:
        return 1e-5 * (self.head_size_divisor ** 2)

    @property
    def time_mix_extra_dim(self) -> int:
        return 64 if self.n_embd == 4096 else 32

    @property
    def time_decay_extra_dim(self) -> int:
        return 128 if self.n_embd == 4096 else 64

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer and schedule settings, the JAX TrainConfig's fields and
    defaults (rwkv_lm_ext_tpu/config.py:117-140). ``dp``/``tp`` and
    ``shard_opt_state`` are kept for parity; the port trains on one device
    so far. ``grad_checkpoint`` is on/off only (no ``dots`` policies)."""

    lr_init: float = 3e-4
    lr_final: float = 1e-5
    warmup_steps: int = 50
    beta1: float = 0.9
    beta2: float = 0.99
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    lr_schedule: str = "cosine"   # cosine | exp | linear | constant
    total_steps: int = 10000
    micro_bsz: int = 8
    accumulate_grad_batches: int = 1
    layerwise_lr: bool = True
    grad_checkpoint: bool = True
    chunk_ctx: int = 0
    dp: int = 1
    tp: int = 1
    shard_opt_state: bool = True
    seed: int = 0


def rwkv6_1b6(**overrides) -> ModelConfig:
    """RWKV-6-World-1B6 geometry: 24 layers, C=2048, H=32, N=64, F=7168."""
    kw = dict(n_layer=24, n_embd=2048, vocab_size=65536, head_size=64)
    kw.update(overrides)
    return ModelConfig(**kw)


# Special token ids of the RWKV world vocabulary
PAD_ID = 0
EOS_ID = 1
EMB_ID = 1
CLS_ID = 1
SEP_ID = 2
MASK_ID = 3
