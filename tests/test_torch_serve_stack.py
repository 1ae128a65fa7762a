"""The port's serving stack over HTTP on the CPU: /generate through the
continuous batcher and under slot-LoRA adapters, /process_text from a named
state loaded from a .pth, GET / (the web UI) and /stats, and the serving
CLI building each flag's object. Greedy answers are token-equal to the
engine's own generation (fp32); the states registry stacks the same
time_state as the JAX package's."""
import copy
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.infer.states_registry import extract_time_states as jax_extract_time_states
from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    apply_lora,
    init_lora_params,
    lora_state_dict,
    merge_lora,
)
from rwkv_lm_ext_tpu_torch.adapters.slot_lora import SlotLoraLinear, build_slot_lora
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into, save_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.continuous import ContinuousBatcher
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.infer.state_cache import PrefixStateCache
from rwkv_lm_ext_tpu_torch.infer.states_registry import StatesRegistry, extract_time_states
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.serve import cli
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http

torch.set_num_threads(1)  # tier-1 runs several pytest workers

GREEDY = dict(temperature=0.0, top_p=1.0, alpha_presence=0.0, alpha_frequency=0.0,
              token_stop=())
LC = LoraConfig(r=4, alpha=8.0)
PROMPT = "北京是 the capital"


def _world_model():
    """2 layers over the whole world vocabulary (ids up to 65535)."""
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=32, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen) * 0.5 / sd[key].shape[1] ** 0.5
    return load_state_dict_into(RWKV(cfg, device="cpu"), sd)


def _lora_model(model, seed):
    """A copy of the model under a random LoRA, as the trainer holds it."""
    return apply_lora(copy.deepcopy(model), LC,
                      _random_adapter(model, torch.Generator().manual_seed(seed)))


def _random_adapter(model, gen):
    ad = init_lora_params(model, LC, gen)
    for ab in ad.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=gen) * 0.3
    return ad


def _time_states(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return {f"blocks.{i}.att.time_state": 0.5 * torch.randn(cfg.n_head, cfg.head_size,
                                                             cfg.head_size, generator=gen)
            for i in range(cfg.n_layer)}


@pytest.fixture(scope="module")
def world():
    return _world_model(), WorldTokenizer()


def _post(url, payload, raw=False):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            return resp.status, (body if raw else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


class _Served:
    def __init__(self, service):
        self.service = service
        self.server = serve_http(service, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        self.service.close()
        assert not self.thread.is_alive()


def test_states_registry_round_trip_and_process_text(world, tmp_path):
    model, tok = world
    sd = _time_states(model.cfg, 1)
    torch.save(sd, tmp_path / "s.pth")
    reg = StatesRegistry(model.cfg, device="cpu")
    reg.register_pth("sum", str(tmp_path / "s.pth"), template="sum: {input}")
    want_stack = np.asarray(jax_extract_time_states({k: v.numpy() for k, v in sd.items()}, 2))
    np.testing.assert_array_equal(extract_time_states(sd, 2).numpy(), want_stack)
    st = reg.initial_state("sum")
    np.testing.assert_array_equal(st["wkv"][:, 0].numpy(), want_stack)
    assert st["att_shift"].abs().sum() == 0 and reg.build_prompt("sum", "x") == "sum: x"
    engine = GenerationEngine(model, tok)
    want = engine.generate("sum: " + PROMPT, state=reg.initial_state("sum"))
    assert want != engine.generate("sum: " + PROMPT)
    with _Served(ServingService(engine=engine, states_registry=reg, tokenizer=tok)) as base:
        code, body = _post(base + "/process_text", {"text": PROMPT, "action": "sum"})
        assert code == 200 and body == {"action": "sum", "output": want}
        assert _post(base + "/process_text", {"text": PROMPT, "action": "nope"})[0] == 400
        code, kind, page = _get(base + "/")
        assert code == 200 and kind.startswith("text/html") and b"/process_text" in page
        code, _, stats = _get(base + "/stats")
        assert code == 200 and json.loads(stats)["requests"]["/process_text"] == 2


def test_generate_through_the_batcher_with_adapters(world):
    model, tok = world
    base_model = copy.deepcopy(model)
    adapter = _random_adapter(model, torch.Generator().manual_seed(2))
    slot, ids = build_slot_lora(copy.deepcopy(model), {"a": adapter}, LC)
    engine = GenerationEngine(slot, tok, adapter_ids=ids, state_cache=PrefixStateCache(4))
    sp = SamplingParams(**GREEDY)
    want_base = GenerationEngine(base_model, tok).generate(PROMPT, max_tokens=6, sampling=sp)
    merged = merge_lora(apply_lora(copy.deepcopy(base_model), LC, adapter))
    want_a = GenerationEngine(merged, tok).generate(PROMPT, max_tokens=6, sampling=sp)
    assert want_a != want_base
    batcher = ContinuousBatcher(engine, n_slots=2, sampling=sp, block_size=4)
    service = ServingService(engine=engine, tokenizer=tok, batcher=batcher)
    with _Served(service) as base:
        answers = {}

        def ask(name, adapter):
            payload = {"prompt": PROMPT, "max_tokens": 6, **GREEDY}
            if adapter:
                payload["adapter"] = adapter
            answers[name] = _post(base + "/generate", payload)

        threads = [threading.Thread(target=ask, args=(f"{a}{i}", a))
                   for i in range(2) for a in ("", "a")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for name, (code, body) in answers.items():
            assert code == 200 and body["backend"] == "batcher", name
            assert body["output"] == (want_a if name.startswith("a") else want_base), name
        code, raw = _post(base + "/generate", {"prompt": PROMPT, "max_tokens": 6, "stream": True,
                                               "adapter": "a", **GREEDY}, raw=True)
        events = [json.loads(e[len(b"data: "):]) for e in raw.split(b"\n\n") if e]
        assert code == 200 and events[-1]["done"] and events[-1]["output"] == want_a
        assert "".join(e["token"] for e in events[:-1]) == want_a
        code, body = _post(base + "/generate", {"prompt": PROMPT, "adapter": "nope"})
        assert code == 400 and "unknown adapter" in body["error"]
        assert _post(base + "/generate", {"prompt": PROMPT, "adapter": ["a"]})[0] == 400
        code, body = _post(base + "/generate", {"prompt": PROMPT, "max_tokens": 3,
                                                "temperature": 0.9, "top_p": 0.8})
        assert code == 200 and body["backend"] == "batcher"
        code, stats = _post(base + "/stats", {})
    assert code == 200
    lat = stats["generate_latency_ms"]["batcher"]
    assert lat["count"] == 6 and 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    assert stats["batcher"]["n_slots"] == 2 and stats["batcher"]["emitted"] >= 30
    assert stats["adapters"] == ["a", "base"] and stats["prefix_cache"]["capacity"] == 4


def test_cli_builds_each_flags_object(world, tmp_path):
    model, _ = world
    path = str(tmp_path / "m.pth")
    save_rwkv_checkpoint(model, path)
    for name, seed in (("chat", 3), ("a", 4), ("b", 5)):
        torch.save(lora_state_dict(_lora_model(model, seed)), tmp_path / f"{name}.pth")
    torch.save(_time_states(model.cfg, 6), tmp_path / "s.pth")
    (tmp_path / "states.json").write_text(json.dumps(
        {"sum": {"path": str(tmp_path / "s.pth"), "template": "sum: {input}"}}))
    args = cli.parse_args([
        "--model", path, "--platform", "cpu", "--dtype", "float32", "--port", "0",
        "--chat-adapter", str(tmp_path / "chat.pth"), "--lora-r", "4", "--lora-alpha", "8",
        "--slot-adapter", f"a={tmp_path / 'a.pth'}", "--slot-adapter", f"b={tmp_path / 'b.pth'}",
        "--states-config", str(tmp_path / "states.json"), "--batcher-slots", "3",
        "--batcher-block", "8", "--batcher-adaptive", "--prefix-cache", "5",
    ])
    service = cli.build_service(args)
    engine = service.engine
    assert engine.adapter_ids == {"base": 0, "a": 1, "b": 2}
    key = engine.model.blocks[0].att.key
    assert isinstance(key, SlotLoraLinear) and key.A.shape == (3, 64, 4)
    # the chat adapter is merged into the base under the slot stacks
    assert not torch.equal(key.base.weight, model.blocks[0].att.key.weight)
    assert engine.state_cache.capacity == 5
    assert service.states.names() == ["sum"] and "/process_text" in service.routes
    assert (service.batcher.n_slots, service.batcher.block_size) == (3, 8)
    assert service.batcher._block_sizes == [8]
    result = service.handle("/generate", {"prompt": "hello", "max_tokens": 3, "adapter": "b",
                                          **GREEDY})
    assert result["backend"] == "engine" and isinstance(result["output"], str)
    with pytest.raises(SystemExit, match="NAME=PATH"):
        cli.build_service(cli.parse_args(["--model", path, "--platform", "cpu",
                                          "--slot-adapter", "nameless"]))
