"""RWKV "world" tokenizer: greedy longest match over a byte trie.

Counterpart of rwkv_lm_ext_tpu/data/tokenizer.py:81-176 (WorldTokenizer,
pure-Python trie path only, and StreamingDecoder). The vocabulary is the JAX package's data file,
read by path: rwkv_lm_ext_tpu/data/assets/rwkv_vocab_v20230424.txt. Lines
are ``<id> <python-literal str|bytes> <byte length>``.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional

DEFAULT_VOCAB = (
    Path(__file__).resolve().parents[2]
    / "rwkv_lm_ext_tpu" / "data" / "assets" / "rwkv_vocab_v20230424.txt"
)


class WorldTokenizer:
    def __init__(self, vocab_path: Optional[str] = None):
        path = Path(vocab_path) if vocab_path else DEFAULT_VOCAB
        if not path.is_file():
            raise FileNotFoundError(
                f"RWKV world vocabulary not found at {path}; pass vocab_path= "
                "or run from a checkout that holds rwkv_lm_ext_tpu/data/assets/"
            )
        self.idx_to_token: Dict[int, bytes] = {}
        trie: Dict = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                idx = int(line[: line.index(" ")])
                tok = ast.literal_eval(line[line.index(" "): line.rindex(" ")].strip())
                if isinstance(tok, str):
                    tok = tok.encode("utf-8")
                if not isinstance(tok, bytes) or len(tok) != int(line[line.rindex(" "):]):
                    raise ValueError(f"malformed vocabulary line: {line!r}")
                self.idx_to_token[idx] = tok
                node = trie
                for byte in tok:
                    node = node.setdefault(byte, {})
                node[-1] = idx  # terminal marker
        self._trie = trie
        self.vocab_size = max(self.idx_to_token) + 1

    def encode_bytes(self, data: bytes) -> List[int]:
        out: List[int] = []
        i, n = 0, len(data)
        while i < n:
            node = self._trie.get(data[i])
            if node is None:
                raise ValueError(f"byte {data[i]:#x} at {i} not in vocabulary")
            best_id, best_end = node.get(-1), i + 1
            j = i + 1
            while j < n:
                node = node.get(data[j])
                if node is None:
                    break
                j += 1
                if -1 in node:
                    best_id, best_end = node[-1], j
            if best_id is None:
                raise ValueError(f"no token match at byte {i}")
            out.append(best_id)
            i = best_end
        return out

    def encode(self, text: str) -> List[int]:
        return self.encode_bytes(text.encode("utf-8"))

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(self.idx_to_token[i] for i in ids if i in self.idx_to_token)

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def streaming_decoder(self) -> "StreamingDecoder":
        return StreamingDecoder(self)


class StreamingDecoder:
    """Incremental decoder that emits only complete UTF-8 sequences, so a
    character split across tokens (CJK, emoji) streams as one piece."""

    def __init__(self, tok: WorldTokenizer):
        self._tok = tok
        self._pending = b""

    def push(self, token_id: int) -> str:
        self._pending += self._tok.idx_to_token.get(token_id, b"")
        # the longest prefix that is valid UTF-8 (an incomplete sequence at
        # the end is at most 3 bytes)
        for cut in range(len(self._pending), max(len(self._pending) - 4, -1), -1):
            try:
                text = self._pending[:cut].decode("utf-8")
            except UnicodeDecodeError:
                continue
            self._pending = self._pending[cut:]
            return text
        return ""

    def flush(self) -> str:
        text = self._pending.decode("utf-8", errors="replace")
        self._pending = b""
        return text
