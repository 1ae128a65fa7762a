"""BlinkDL flat state dicts <-> the port's RWKV module.

Counterpart of rwkv_lm_ext_tpu/checkpoint/convert.py:34-198. The JAX package
converts the flat dict into its own parameter tree (transposed kernels,
flattened vectors); the port's module already uses the flat keys and
shapes, so loading is a checked copy. The flat dict of fp32 numpy arrays
(what the JAX ``params_to_state_dict`` emits) is also how weights are
carried between the two packages; ``lora_tree_from_jax`` carries a LoRA
adapter the same way, ``one_layer_decoder_from_jax`` the RetroMAE
decoder's parameter tree, and ``score_head_from_jax``,
``embedding_head_from_jax`` and ``instructor_head_from_jax`` the task heads'
trees (``{"kernel": (C, n)}``, ``{"dense": {kernel, bias}}`` and
``{"dense": ..., "ln": {scale, bias}}``) as the port's head modules in the
reference's layout: ``score.weight`` (n, C) (JAX serve/cli.py:124-131
``_load_head`` reads it back transposed), ``dense.weight`` (out, C) and
``dense.bias``, ``ln_dense.weight`` and ``ln_dense.bias`` (JAX
train/cli.py:1258-1276). ``score_head_from_state_dict`` reads the score
head of a checkpoint or adapter file.

RWKV-5.x and RWKV-4 dicts load the same way (JAX :69-92). A v5.0/5.1 per-head
decay (H,) is broadcast to the (H, N) parameter and a v5 ``att.time_first``
is read as ``att.time_faaaa``, as the JAX converter does; ``checkpoint_config``
is ``sniff_model_config`` plus one rule the JAX forward applies per block (its
``has_gate``, models/rwkv.py:524): a v5 dict without a gate is v5.0, whatever
the shape of its decay (the JAX converter writes every v5 decay as (H, N)).

``state_dict_from_jax_tree`` carries a whole JAX parameter tree, the legacy
options' weights included, into the port's flat keys. The JAX flat dict
cannot carry those (ROADMAP C.22): ``params_to_state_dict`` drops
``head_q``/``head_k``, ``tiny_*``, ``pos_emb_*`` and ``ffn_pre`` and writes
MishGLU's ``ffn.aa``/``ffn.bb`` (C, F) matrices as (1, 1, C*F) vectors, and
``state_dict_to_params`` reads none of them.

The JAX loader also runs ``apply_wkv_dispatch``; the port's WKV kernel is
exact at any decay, so there is nothing to dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rwkv_lm_ext_tpu_torch.adapters.quant import quantize_model
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config, strip_prefix
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.models.bidirectional import OneLayerDecoder
from rwkv_lm_ext_tpu_torch.models.heads import DenseHead, ScoreHead, init_layer_norm
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV, Norm


def load_state_dict_into(model, state_dict: Dict):
    """Copy a flat BlinkDL dict ({key: numpy array or tensor}, prefix
    already stripped) into `model` (an RWKV, or any module with flat keys),
    casting to the parameters' dtype and device.
    Vectors stored flat, e.g. (C,) for a (1, 1, C) time_maa, are reshaped,
    and a per-head (H,) ``att.time_decay`` (RWKV-5.0/5.1) is broadcast to
    the (H, N) parameter. Raises on missing or unknown keys and on a size
    mismatch."""
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
            if key.endswith("att.time_decay") and p.dim() == 2 and src.numel() == p.shape[0]:
                src = src.reshape(-1, 1).expand(p.shape)
            if src.numel() != p.numel():
                raise ValueError(f"{key}: {tuple(src.shape)} does not fit {tuple(p.shape)}")
            p.copy_(src.reshape(p.shape))
    return model


def params_to_state_dict(model: RWKV) -> Dict[str, np.ndarray]:
    """The model's weights as a flat BlinkDL dict of fp32 numpy arrays."""
    return {
        k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()
    }


# the JAX tree's (in, out) kernels: their flat keys end in ".weight", (out, in)
_JAX_KERNELS = {"receptance", "key", "value", "gate", "output", "aa", "bb", "tiny_q", "tiny_k",
                "tiny_v", "head", "head_q", "head_k"}
# JAX tree names whose flat key differs (the reference's attribute names)
_JAX_RENAMES = {"ffn_pre": "ffnPre", "emb": "emb.weight"}


def state_dict_from_jax_tree(params: Dict, cfg) -> Dict[str, np.ndarray]:
    """A JAX parameter tree (arrays; ``{emb, blocks: [...], ln_out, head,
    head_q, head_k}``) -> the port's flat dict of fp32 numpy arrays, for
    ``load_state_dict_into``: kernels transposed to (out, in), {scale, bias}
    pairs as ``.weight``/``.bias``, ``ffn_pre`` as ``ffnPre``, vectors as
    they are (the loader reshapes them). Under ``cfg.pre_ffn`` layer 0's
    ``att``, which the JAX forward skips and the port's layer 0 does not
    have, is left out."""
    sd: Dict[str, np.ndarray] = {}

    def walk(prefix: str, tree: Dict) -> None:
        for name, value in tree.items():
            key = prefix + _JAX_RENAMES.get(name, name)
            if isinstance(value, dict):
                if set(value) == {"scale", "bias"}:
                    sd[key + ".weight"] = np.asarray(value["scale"], np.float32)
                    sd[key + ".bias"] = np.asarray(value["bias"], np.float32)
                else:
                    walk(key + ".", value)
            elif name in _JAX_KERNELS:
                sd[key + ".weight"] = np.asarray(value, np.float32).T
            else:
                sd[key] = np.asarray(value, np.float32)

    walk("", {k: v for k, v in params.items() if k != "blocks"})
    for i, block in enumerate(params["blocks"]):
        if i == 0 and cfg.pre_ffn > 0:
            block = {k: v for k, v in block.items() if k != "att"}
        walk(f"blocks.{i}.", block)
    return sd


def checkpoint_config(state_dict: Dict, **overrides) -> ModelConfig:
    """``sniff_model_config``, then a v5 dict with no ``att.gate`` is v5.0
    (see the module docstring) unless ``version`` is overridden."""
    cfg = sniff_model_config(state_dict, **overrides)
    if (5 <= cfg.version < 6 and "version" not in overrides
            and not any(k.endswith("att.gate.weight") for k in strip_prefix(state_dict))):
        cfg = dataclasses.replace(cfg, version=5.0)
    return cfg


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


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def score_head_from_jax(tree: Dict, *, device="cpu") -> ScoreHead:
    """{"kernel": (C, n)} -> ScoreHead with weight (n, C)."""
    kernel = _f32(tree["kernel"], device)
    head = ScoreHead(kernel.shape[0], kernel.shape[1], device=device)
    with torch.no_grad():
        head.weight.copy_(kernel.T)
    return head


def embedding_head_from_jax(tree: Dict, *, device="cpu") -> DenseHead:
    """{"dense": {"kernel": (C, out), "bias": (out,)}} -> DenseHead."""
    kernel = _f32(tree["dense"]["kernel"], device)
    head = DenseHead(kernel.shape[0], kernel.shape[1], device=device)
    with torch.no_grad():
        head.weight.copy_(kernel.T)
        head.bias.copy_(_f32(tree["dense"]["bias"], device))
    return head


def instructor_head_from_jax(tree: Dict, *, device="cpu") -> Tuple[DenseHead, Norm]:
    """{"dense": {kernel, bias}, "ln": {scale, bias}} -> (dense, ln_dense)."""
    dense = embedding_head_from_jax(tree, device=device)
    ln = init_layer_norm(dense.weight.shape[0], device=device)
    with torch.no_grad():
        ln.weight.copy_(_f32(tree["ln"]["scale"], device))
        ln.bias.copy_(_f32(tree["ln"]["bias"], device))
    return dense, ln


def score_head_from_state_dict(sd: Dict, *, device="cpu") -> Optional[ScoreHead]:
    """The ScoreHead of a file's ``score.weight`` (n, C), or None without
    one."""
    if "score.weight" not in sd:
        return None
    w = sd["score.weight"]
    w = w.detach().float() if isinstance(w, torch.Tensor) else torch.from_numpy(
        np.asarray(w, np.float32))
    head = ScoreHead(w.shape[1], w.shape[0], device=device)
    with torch.no_grad():
        head.weight.copy_(w)
    return head


def save_rwkv_checkpoint(model: RWKV, path: str) -> None:
    """Write the model as a BlinkDL .pth: a plain {key: tensor} dict (no
    OrderedDict metadata, which torch-free readers such as the JAX
    package's load_torch_pth do not take)."""
    torch.save({k: v.detach() for k, v in model.state_dict().items()}, path)


def load_rwkv_checkpoint(
    path: str, *, device, quant: Optional[str] = None, **cfg_overrides
) -> Tuple[RWKV, ModelConfig]:
    """.pth (RWKV-4, 5.x or 6) -> (RWKV module on `device`, ModelConfig,
    from ``checkpoint_config``). cfg_overrides are
    ModelConfig fields, e.g. dtype="float32", or param_dtype="float32" for
    fp32 master weights under the default bf16 compute. ``quant``
    ("int8" or "int8c") quantizes the block projections from the
    checkpoint's own values upcast to fp32, before any cast to cfg.dtype,
    as the JAX loader hands fp32 params to quantize_tree."""
    sd = strip_prefix(torch.load(path, map_location="cpu", weights_only=True))
    cfg = checkpoint_config(sd, **cfg_overrides)
    if 5 <= cfg.version < 6:
        sd = {(k[:-len("time_first")] + "time_faaaa" if k.endswith("att.time_first") else k): v
              for k, v in sd.items()}
    model = load_state_dict_into(RWKV(cfg, device=device), sd)
    if quant is not None:
        quantize_model(model, quant, weights=sd)
    return model, cfg
