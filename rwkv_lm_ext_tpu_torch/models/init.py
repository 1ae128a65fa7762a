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


def init_rwkv_params(
    cfg,
    *,
    generator: torch.Generator,
    device,
) -> Dict[str, torch.Tensor]:
    """Fresh RWKV-6 parameters as {BlinkDL key: fp32 tensor on `device`};
    `generator` must live on `device`."""
    C, A, F = cfg.n_embd, cfg.dim_att, cfg.dim_ffn
    H, N, L = cfg.n_head, cfg.head_size, cfg.n_layer
    Dm, Dd = cfg.time_mix_extra_dim, cfg.time_decay_extra_dim
    f32 = dict(dtype=torch.float32, device=device)

    def const(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def uniform(*shape, lim):
        return (torch.rand(*shape, generator=generator, **f32) * 2 - 1) * lim

    def proj(n_in, n_out, gain=1.0):
        # (out, in) torch layout
        std = gain / np.sqrt(n_in)
        return torch.randn(n_out, n_in, generator=generator, **f32) * std

    ddd = np.arange(C, dtype=np.float64) / C
    sd: Dict[str, torch.Tensor] = {}
    for i in range(L):
        b = f"blocks.{i}."
        r01 = i / max(L - 1, 1)
        r10 = 1.0 - i / L
        if i == 0:
            sd[b + "ln0.weight"], sd[b + "ln0.bias"] = torch.ones(C, **f32), torch.zeros(C, **f32)
        for ln in ("ln1", "ln2"):
            sd[b + ln + ".weight"], sd[b + ln + ".bias"] = torch.ones(C, **f32), torch.zeros(C, **f32)

        def maa(e):
            return const(1.0 - np.power(ddd, e)).reshape(1, 1, C)

        sd[b + "att.time_maa_x"] = maa(r10)
        sd[b + "att.time_maa_w"] = maa(r10)
        sd[b + "att.time_maa_k"] = maa(r10)
        sd[b + "att.time_maa_v"] = const(1.0 - (np.power(ddd, r10) + 0.3 * r01)).reshape(1, 1, C)
        sd[b + "att.time_maa_r"] = maa(0.5 * r10)
        sd[b + "att.time_maa_g"] = maa(0.5 * r10)
        sd[b + "att.time_maa_w1"] = uniform(C, 5 * Dm, lim=1e-4)
        sd[b + "att.time_maa_w2"] = uniform(5, Dm, C, lim=1e-4)
        n = np.arange(A)
        decay = -6 + 5 * (n / max(A - 1, 1)) ** (0.7 + 1.3 * r01)
        sd[b + "att.time_decay"] = const(decay).reshape(1, 1, A)
        sd[b + "att.time_decay_w1"] = uniform(C, Dd, lim=1e-4)
        sd[b + "att.time_decay_w2"] = uniform(Dd, A, lim=1e-4)
        zigzag = ((n + 1) % 3 - 1) * 0.1
        sd[b + "att.time_faaaa"] = const(r01 * (1 - n / max(A - 1, 1)) + zigzag).reshape(H, N)
        gain = float(np.sqrt(A / C)) if A > C else 1.0
        for name in ("receptance", "key", "value", "gate"):
            sd[b + f"att.{name}.weight"] = proj(C, A, gain)
        sd[b + "att.output.weight"] = torch.zeros(C, A, **f32)
        sd[b + "att.ln_x.weight"] = torch.full((A,), ((1 + i) / L) ** 0.7, **f32)
        sd[b + "att.ln_x.bias"] = torch.zeros(A, **f32)

        sd[b + "ffn.time_maa_k"] = maa(r10)
        sd[b + "ffn.time_maa_r"] = maa(r10)
        sd[b + "ffn.key.weight"] = proj(C, F, float(np.sqrt(F / C)) if F > C else 1.0)
        sd[b + "ffn.receptance.weight"] = torch.zeros(C, C, **f32)
        sd[b + "ffn.value.weight"] = torch.zeros(C, F, **f32)

    sd["emb.weight"] = uniform(cfg.vocab_size, C, lim=1e-4)
    sd["ln_out.weight"], sd["ln_out.bias"] = torch.ones(C, **f32), torch.zeros(C, **f32)
    sd["head.weight"] = proj(C, cfg.vocab_size, 0.5)
    return sd
