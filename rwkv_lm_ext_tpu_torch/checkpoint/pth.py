"""Architecture sniffing and key-prefix handling for BlinkDL ``.pth`` dicts.

Counterpart of rwkv_lm_ext_tpu/checkpoint/pth.py:208-257
(sniff_model_config, strip_prefix). The JAX package parses the ``.pth`` zip
itself to stay torch-free; the port reads and writes it with
``torch.load(..., weights_only=True)`` and ``torch.save``.
"""
from __future__ import annotations

from typing import Dict

from rwkv_lm_ext_tpu_torch.config import ModelConfig


def sniff_model_config(state_dict: Dict, **overrides) -> ModelConfig:
    """Infer a ModelConfig from state-dict shapes (values may be tensors or
    numpy arrays); `overrides` are ModelConfig fields such as dtype."""
    sd = strip_prefix(state_dict)
    n_embd = sd["emb.weight"].shape[1]
    vocab_size = sd["emb.weight"].shape[0]
    dim_att = sd["blocks.0.att.key.weight"].shape[0]
    dim_ffn = sd["blocks.0.ffn.key.weight"].shape[0]
    n_layer, version, n_head = 0, 4.0, 64
    for key in sd:
        if key.startswith("blocks."):
            n_layer = max(n_layer, int(key.split(".")[1]) + 1)
        if "ln_x" in key:
            version = max(5.0, version)
        if "gate.weight" in key:
            version = max(5.1, version)
        if int(version) == 5 and "att.time_decay" in key:
            n_head = sd[key].shape[0]
            if len(sd[key].shape) > 1 and sd[key].shape[1] > 1:
                version = max(5.2, version)
        if "time_maa" in key:
            version = max(6.0, version)
        if int(version) == 6 and "time_faaaa" in key:
            n_head = sd[key].shape[0]
    if version < 5:
        n_head = 1
    kwargs = dict(
        n_layer=n_layer,
        n_embd=n_embd,
        vocab_size=vocab_size,
        dim_att=dim_att,
        dim_ffn=dim_ffn,
        head_size=dim_att // n_head,
        version=version,
    )
    kwargs.update(overrides)
    return ModelConfig(**kwargs)


def strip_prefix(state_dict: Dict, prefix: str = "rwkvModel.") -> Dict:
    """Drop the wrapper prefix written by task-model checkpoints."""
    return {
        (k[len(prefix):] if k.startswith(prefix) else k): v
        for k, v in state_dict.items()
    }
