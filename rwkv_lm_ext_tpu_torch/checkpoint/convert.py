"""BlinkDL flat state dicts <-> the port's RWKV module.

Counterpart of rwkv_lm_ext_tpu/checkpoint/convert.py:34-198. The JAX package
converts the flat dict into its own parameter tree (transposed kernels,
flattened vectors); the port's module already uses the flat keys and
shapes, so loading is a checked copy. The flat dict of fp32 numpy arrays
(what the JAX ``params_to_state_dict`` emits) is also how weights are
carried between the two packages; ``lora_tree_from_jax`` carries a LoRA
adapter the same way and ``one_layer_decoder_from_jax`` the RetroMAE
decoder's parameter tree.

The JAX loader also runs ``apply_wkv_dispatch``; the port's WKV kernel is
exact at any decay, so there is nothing to dispatch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.adapters.quant import quantize_model
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config, strip_prefix
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.models.bidirectional import OneLayerDecoder
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV


def load_state_dict_into(model, state_dict: Dict):
    """Copy a flat BlinkDL dict ({key: numpy array or tensor}, prefix
    already stripped) into `model` (an RWKV, or any module with flat keys),
    casting to the parameters' dtype and device.
    Vectors stored flat, e.g. (C,) for a (1, 1, C) time_maa, are reshaped.
    Raises on missing or unknown keys and on a size mismatch."""
    params = model.state_dict()
    missing = sorted(params.keys() - state_dict.keys())
    unknown = sorted(state_dict.keys() - params.keys())
    if missing or unknown:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, unknown {unknown[:8]}")
    with torch.no_grad():
        for key, p in params.items():
            src = state_dict[key]
            if not isinstance(src, torch.Tensor):
                src = torch.tensor(np.asarray(src))
            if src.numel() != p.numel():
                raise ValueError(f"{key}: {tuple(src.shape)} does not fit {tuple(p.shape)}")
            p.copy_(src.reshape(p.shape))
    return model


def params_to_state_dict(model: RWKV) -> Dict[str, np.ndarray]:
    """The model's weights as a flat BlinkDL dict of fp32 numpy arrays."""
    return {
        k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()
    }


def lora_tree_from_jax(adapter: Dict, *, device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX adapter tree ({"blocks.{i}.{att|ffn}.{name}": {"A": (in, r),
    "B": (r, out)}}, arrays) -> the port's adapter dict (adapters.lora),
    fp32 tensors on `device`: the keys and layouts are the same."""
    return {
        key: {ab: torch.tensor(np.asarray(ab_arr, np.float32), device=device)
              for ab, ab_arr in entry.items()}
        for key, entry in adapter.items()
    }


def one_layer_decoder_from_jax(tree: Dict, cfg: ModelConfig, *, device="cpu") -> OneLayerDecoder:
    """The JAX package's ``onelayer_decoder`` parameter tree (arrays:
    ``ln1``/``ln2``/``ln_out`` {scale, bias}, ``att`` and ``ffn`` with
    (in, out) kernels and flat vectors, ``head`` (C, V)) -> the port's
    OneLayerDecoder on `device`."""
    def arr(x):
        return np.asarray(x, np.float32)

    sd = {}
    for ln in ("ln1", "ln2", "ln_out"):
        sd[f"{ln}.weight"], sd[f"{ln}.bias"] = arr(tree[ln]["scale"]), arr(tree[ln]["bias"])
    for part, linears in (("att", ("receptance", "key", "value", "gate", "output")),
                          ("ffn", ("key", "value", "receptance"))):
        for name, value in tree[part].items():
            if name == "ln_x":
                sd["att.ln_x.weight"], sd["att.ln_x.bias"] = arr(value["scale"]), arr(value["bias"])
            elif name in linears:
                sd[f"{part}.{name}.weight"] = arr(value).T
            else:
                sd[f"{part}.{name}"] = arr(value)
    sd["head.weight"] = arr(tree["head"]).T
    return load_state_dict_into(OneLayerDecoder(cfg, device=device), sd)


def save_rwkv_checkpoint(model: RWKV, path: str) -> None:
    """Write the model as a BlinkDL .pth: a plain {key: tensor} dict (no
    OrderedDict metadata, which torch-free readers such as the JAX
    package's load_torch_pth do not take)."""
    torch.save({k: v.detach() for k, v in model.state_dict().items()}, path)


def load_rwkv_checkpoint(
    path: str, *, device, quant: Optional[str] = None, **cfg_overrides
) -> Tuple[RWKV, ModelConfig]:
    """.pth -> (RWKV module on `device`, ModelConfig). cfg_overrides are
    ModelConfig fields, e.g. dtype="float32", or param_dtype="float32" for
    fp32 master weights under the default bf16 compute. ``quant``
    ("int8" or "int8c") quantizes the block projections from the
    checkpoint's own values upcast to fp32, before any cast to cfg.dtype,
    as the JAX loader hands fp32 params to quantize_tree."""
    sd = strip_prefix(torch.load(path, map_location="cpu", weights_only=True))
    cfg = sniff_model_config(sd, **cfg_overrides)
    model = load_state_dict_into(RWKV(cfg, device=device), sd)
    if quant is not None:
        quantize_model(model, quant, weights=sd)
    return model, cfg
