"""Shared set-up of the serving-stack parity tests (tests/test_torch_*.py):
a small RWKV-6 built by the JAX package and carried into the port with
checkpoint.convert, both in fp32, so the two run the same weights."""
import jax
import jax.numpy as jnp
import numpy as np

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV

# greedy without penalties or stops, as both packages spell it
GREEDY = dict(temperature=0.0, top_p=1.0, alpha_presence=0.0, alpha_frequency=0.0,
              token_stop=())


def jax_params(seed: int = 0, *, n_layer: int = 2, n_embd: int = 128, vocab_size: int = 1000):
    """(params, cfg) of a JAX model whose zero-initialised projections get
    seeded values (else every block is a no-op)."""
    cfg = JaxModelConfig(n_layer=n_layer, n_embd=n_embd, vocab_size=vocab_size, head_size=64,
                         dtype="float32", param_dtype="float32")
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    return params, cfg


def torch_model(params, cfg):
    """The port's model on the same weights, fp32, on the CPU."""
    sd = jax_params_to_state_dict(params, cfg)
    return load_state_dict_into(RWKV(sniff_model_config(sd, dtype="float32"), device="cpu"), sd)
