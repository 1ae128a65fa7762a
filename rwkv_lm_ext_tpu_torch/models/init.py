"""Seeded synthetic RWKV-6 weights in the BlinkDL flat schema.

Counterpart of rwkv_lm_ext_tpu/models/init.py:142-261
(init_rwkv_params with fast_init=True): the same deterministic time-mix,
decay, bonus and ln_x schedules, scaled-normal projections (std
gain/sqrt(fan_in)) and zero att.output / ffn.value / ffn.receptance. The
random values are drawn from a torch.Generator and are not JAX's; tests carry
JAX's own weights over with checkpoint.convert instead.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _draws(generator: torch.Generator, device):
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(*shape, lim):
        return (torch.rand(*shape, generator=generator, **f32) * 2 - 1) * lim

    def proj(n_in, n_out, gain=1.0):
        # (out, in) torch layout
        std = gain / np.sqrt(n_in)
        return torch.randn(n_out, n_in, generator=generator, **f32) * std

    return uniform, proj


def init_block_params(
    cfg, i: int, *, generator: torch.Generator, device
) -> Dict[str, torch.Tensor]:
    """Layer i's parameters as {key without the ``blocks.{i}.`` prefix: fp32
    tensor on `device`}; ln0 only for layer 0."""
    C, A, F = cfg.n_embd, cfg.dim_att, cfg.dim_ffn
    H, N, L = cfg.n_head, cfg.head_size, cfg.n_layer
    Dm, Dd = cfg.time_mix_extra_dim, cfg.time_decay_extra_dim
    f32 = dict(dtype=torch.float32, device=device)
    uniform, proj = _draws(generator, device)

    def const(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    ddd = np.arange(C, dtype=np.float64) / C
    sd: Dict[str, torch.Tensor] = {}
    r01 = i / max(L - 1, 1)
    r10 = 1.0 - i / L
    for ln in ("ln0", "ln1", "ln2") if i == 0 else ("ln1", "ln2"):
        sd[ln + ".weight"], sd[ln + ".bias"] = torch.ones(C, **f32), torch.zeros(C, **f32)

    def maa(e):
        return const(1.0 - np.power(ddd, e)).reshape(1, 1, C)

    sd["att.time_maa_x"] = maa(r10)
    sd["att.time_maa_w"] = maa(r10)
    sd["att.time_maa_k"] = maa(r10)
    sd["att.time_maa_v"] = const(1.0 - (np.power(ddd, r10) + 0.3 * r01)).reshape(1, 1, C)
    sd["att.time_maa_r"] = maa(0.5 * r10)
    sd["att.time_maa_g"] = maa(0.5 * r10)
    sd["att.time_maa_w1"] = uniform(C, 5 * Dm, lim=1e-4)
    sd["att.time_maa_w2"] = uniform(5, Dm, C, lim=1e-4)
    n = np.arange(A)
    decay = -6 + 5 * (n / max(A - 1, 1)) ** (0.7 + 1.3 * r01)
    sd["att.time_decay"] = const(decay).reshape(1, 1, A)
    sd["att.time_decay_w1"] = uniform(C, Dd, lim=1e-4)
    sd["att.time_decay_w2"] = uniform(Dd, A, lim=1e-4)
    zigzag = ((n + 1) % 3 - 1) * 0.1
    sd["att.time_faaaa"] = const(r01 * (1 - n / max(A - 1, 1)) + zigzag).reshape(H, N)
    gain = float(np.sqrt(A / C)) if A > C else 1.0
    for name in ("receptance", "key", "value", "gate"):
        sd[f"att.{name}.weight"] = proj(C, A, gain)
    sd["att.output.weight"] = torch.zeros(C, A, **f32)
    sd["att.ln_x.weight"] = torch.full((A,), ((1 + i) / L) ** 0.7, **f32)
    sd["att.ln_x.bias"] = torch.zeros(A, **f32)

    sd["ffn.time_maa_k"] = maa(r10)
    sd["ffn.time_maa_r"] = maa(r10)
    sd["ffn.key.weight"] = proj(C, F, float(np.sqrt(F / C)) if F > C else 1.0)
    sd["ffn.receptance.weight"] = torch.zeros(C, C, **f32)
    sd["ffn.value.weight"] = torch.zeros(C, F, **f32)
    return sd


def init_head(cfg, *, generator: torch.Generator, device) -> torch.Tensor:
    """A (V, C) output head, scaled normal with gain 0.5."""
    _, proj = _draws(generator, device)
    return proj(cfg.n_embd, cfg.vocab_size, 0.5)


def init_rwkv_params(
    cfg,
    *,
    generator: torch.Generator,
    device,
) -> Dict[str, torch.Tensor]:
    """Fresh RWKV-6 parameters as {BlinkDL key: fp32 tensor on `device`};
    `generator` must live on `device`."""
    C = cfg.n_embd
    f32 = dict(dtype=torch.float32, device=device)
    uniform, _ = _draws(generator, device)
    sd: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_layer):
        block = init_block_params(cfg, i, generator=generator, device=device)
        sd.update({f"blocks.{i}.{key}": value for key, value in block.items()})
    sd["emb.weight"] = uniform(cfg.vocab_size, C, lim=1e-4)
    sd["ln_out.weight"], sd["ln_out.bias"] = torch.ones(C, **f32), torch.zeros(C, **f32)
    sd["head.weight"] = init_head(cfg, generator=generator, device=device)
    return sd
