"""The lockstep multi-process server's op stream (infer.continuous
LockstepBatcherDriver) on two CPU ranks over gloo: three concurrent /generate
submits, an /embed and a /rerank call through rank 0's driver give the
single-process batcher's, bi-encoder's and cross-encoder's answers, and rank 1's batcher, replaying the
stream, finishes the same requests with the same tokens. A 200 KB call fails
alone (PayloadTooLarge, a 400 at the server) and the next call is answered;
both ranks leave at shutdown (tests/torch_tp_ranks.py ``run_pair`` fails on a
rank that does not exit with 0 in time). The single-process batcher is held
against the JAX package's in tests/test_torch_continuous.py."""
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.infer.continuous import MAX_REQUEST_BYTES
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from torch_tp_ranks import run_pair

torch.set_num_threads(1)  # tier-1 runs several pytest workers


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """A world-vocabulary RWKV-6 (2 layers, C=64, H=4) so that text prompts
    and /embed texts tokenize."""
    d = tmp_path_factory.mktemp("tp_lockstep")
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=16, dtype="float32")
    gen = torch.Generator().manual_seed(8)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen) * (0.5 / sd[key].shape[1] ** 0.5)
    torch.save({"sd": sd}, d / "inputs.pt")
    return run_pair("lockstep", d)


def test_submits_and_calls_give_the_single_process_answers(ranks):
    r0 = ranks[0]
    assert r0["answers"] == r0["single_answers"]
    assert all(len(a) == 6 for a in r0["answers"])
    np.testing.assert_allclose(r0["embed"], r0["single_embed"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(r0["embed"], axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(r0["rerank"], r0["single_rerank"], rtol=1e-5, atol=1e-5)


def test_the_worker_replays_the_stream(ranks):
    finished = {rid: ids for rid, ids in ranks[0]["finished"].items()}
    assert len(finished) == 3 and ranks[1]["finished"] == finished
    assert sorted(finished.values()) == sorted(ranks[0]["answers"])


def test_an_oversized_call_fails_alone(ranks):
    r0 = ranks[0]
    assert r0["oversized"] is not None and str(MAX_REQUEST_BYTES) in r0["oversized"]
    assert np.allclose(r0["after"], [[1.0]], atol=1e-5)     # the next call is answered
