"""HF ``tokenizers``-format tokenizer (tokenizer.json).

Counterpart of rwkv_lm_ext_tpu/data/tokenizer_json.py:1-67, copied so that
the port imports nothing of the JAX package. RWKV-4 Pile and Raven
checkpoints pair with the GPT-NeoX ``20B_tokenizer.json``; any HF
tokenizer.json works. Same surface as data.tokenizer.WorldTokenizer
(encode, decode, streaming_decoder), so the engines and the serving CLI
(``--tokenizer-json``) take either. ``tokenizers`` is imported when a
tokenizer is built, so the module imports without it.
"""
from __future__ import annotations

from typing import List


class JsonTokenizer:
    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self._tk = Tokenizer.from_file(path)

    @property
    def vocab_size(self) -> int:
        return self._tk.get_vocab_size()

    def encode(self, text: str) -> List[int]:
        return self._tk.encode(text).ids

    def decode(self, ids: List[int]) -> str:
        return self._tk.decode(list(ids))

    def streaming_decoder(self):
        return _StreamingDecoder(self._tk)


class _StreamingDecoder:
    """Incremental decode for byte-level BPEs: emit the stable prefix of
    decode(all ids). A token can complete a multi-byte character or a
    byte-level merge, so only the trailing run of U+FFFD is held back (the
    next token's bytes may complete it); an interior U+FFFD is permanent and
    is emitted."""

    def __init__(self, tk):
        self._tk = tk
        self._ids: List[int] = []
        self._emitted = 0

    def push(self, token_id: int) -> str:
        self._ids.append(int(token_id))
        text = self._tk.decode(self._ids)
        stable_end = len(text)
        while stable_end > 0 and text[stable_end - 1] == "�":
            stable_end -= 1
        stable_end = max(stable_end, self._emitted)  # never rewind
        piece = text[self._emitted:stable_end]
        self._emitted = stable_end
        return piece

    def flush(self) -> str:
        text = self._tk.decode(self._ids)
        piece = text[self._emitted:]
        self._ids, self._emitted = [], 0
        return piece
