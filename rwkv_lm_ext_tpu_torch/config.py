"""Model and training configuration of the PyTorch port.

Counterpart of rwkv_lm_ext_tpu/config.py (ModelConfig, TrainConfig,
rwkv6_1b6 and the special token ids); ``rwkv5_1b5`` and ``rwkv4_1b5`` are
the geometries of RWKV-5-World-1B5 and RWKV-4-World-1.5B. The JAX ModelConfig also carries TPU kernel knobs
(fused_chunk, fused_prologue, packed_decode, fused_decode, wkv_exact) and
their RWKV_* environment overrides. They pick between Pallas code paths that
the port does not have: its WKV kernel is a sequential recurrence that is
exact at any decay, so there is no chunk length or factoring to choose.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch


VERSIONS = (4.0, 5.0, 5.1, 5.2, 6.0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of an RWKV-4/5/6 model, as sniffed from a
    checkpoint (checkpoint.pth.sniff_model_config). ``version`` is 4.0, 5.0,
    5.1, 5.2 or 6.0. ``dropout`` and the legacy RWKV-LM options below
    (``tiny_att_dim``/``tiny_att_layer``, ``head_qk``, ``pre_ffn``,
    ``my_pos_emb``, ``ffn_type="mishglu"``) are the JAX fields of the same
    names and defaults (rwkv_lm_ext_tpu/config.py:36-43). As in JAX the
    forward drops only when it is handed a ``models.rwkv.Dropout``, which
    ``simcse --dropout-noise`` alone does."""

    n_layer: int
    n_embd: int
    vocab_size: int
    dim_att: int = 0          # defaults to n_embd
    dim_ffn: int = 0          # defaults to 3.5*n_embd rounded down to /32
    head_size: int = 64
    head_size_divisor: int = 8
    version: float = 6.0
    dropout: float = 0.0
    tiny_att_dim: int = 0        # tiny attention after layer tiny_att_layer's channel mix
    tiny_att_layer: int = -1
    head_qk: int = 0             # the copy mechanism on the logits
    pre_ffn: int = 0             # layer 0's attention replaced by a channel mix
    my_pos_emb: int = 0          # additive 2D positional embedding after ln0
    ffn_type: str = "relu_sq"    # "relu_sq" | "mishglu"
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
        if self.version not in VERSIONS:
            raise ValueError(f"version {self.version} is not one of {VERSIONS}")
        if self.ffn_type not in ("relu_sq", "mishglu"):
            raise ValueError(f"ffn_type {self.ffn_type!r} is not relu_sq or mishglu")
        if self.dim_att % self.head_size != 0:
            raise ValueError(
                f"dim_att {self.dim_att} is not a multiple of head_size "
                f"{self.head_size}"
            )

    @property
    def n_head(self) -> int:
        return self.dim_att // self.head_size

    @property
    def legacy_options(self) -> tuple:
        """The names of the legacy options this model turns on."""
        return tuple(name for name, on in (
            ("tiny_att_dim", self.tiny_att_dim > 0), ("head_qk", self.head_qk > 0),
            ("pre_ffn", self.pre_ffn > 0), ("my_pos_emb", self.my_pos_emb > 0),
            ("ffn_type=mishglu", self.ffn_type == "mishglu")) if on)

    @property
    def chunk_dependent_options(self) -> tuple:
        """The options on whose output the cutting of a prompt into calls
        shows (tiny attention and head_qk attend over the call's tokens only,
        my_pos_emb restarts its positions each call: ROADMAP C.21)."""
        return tuple(name for name in self.legacy_options
                     if name in ("tiny_att_dim", "head_qk", "my_pos_emb"))

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
    ``shard_opt_state`` are kept for parity: the port's multi-process
    training takes its ranks from the mesh (train/loop.py) and always
    shards the moments over dp. ``grad_checkpoint`` is a utils.remat spec (False, True, "dots"
    or "dots_nobatch"); ``chunk_ctx`` > 0 makes TBPTT the default loss."""

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
    grad_checkpoint: Union[bool, str] = True
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


def rwkv5_1b5(**overrides) -> ModelConfig:
    """RWKV-5-World-1B5 (v5.2) geometry: 24 layers, C=2048, H=32, N=64,
    F=7168."""
    kw = dict(n_layer=24, n_embd=2048, vocab_size=65536, head_size=64, version=5.2)
    kw.update(overrides)
    return ModelConfig(**kw)


def rwkv4_1b5(**overrides) -> ModelConfig:
    """RWKV-4-World-1.5B geometry: 24 layers, C=2048, F=8192 (no heads: the
    sniffed head size is C)."""
    kw = dict(n_layer=24, n_embd=2048, vocab_size=65536, head_size=2048, dim_ffn=8192,
              version=4.0)
    kw.update(overrides)
    return ModelConfig(**kw)


# Special token ids of the RWKV world vocabulary
PAD_ID = 0
EOS_ID = 1
EMB_ID = 1
CLS_ID = 1
SEP_ID = 2
MASK_ID = 3
