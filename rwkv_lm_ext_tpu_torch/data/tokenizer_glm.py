"""ChatGLM4 tokenizer wrapper (the vocabulary of the MLM/MAE encoders).

A jax-free copy of rwkv_lm_ext_tpu/data/tokenizer_glm.py:37-84
(GlmTokenizer). The reference's bidirectional encoders train on the glm4
vocabulary (tokenizer/tokenization_chatglm.py; special ids per
tests/test_mlm.py:27-29: emb=151329, mask=151330, pad=151334). glm4 ships a
tiktoken-format `tokenizer.model` (base64 token + rank per line); this
wrapper builds a tiktoken Encoding from it with the cl100k-style split
pattern the model was trained with, exposing encode/decode. A directory-style
tokenizer goes through transformers' AutoTokenizer. tiktoken and
transformers are imported when a tokenizer is built, never at import.
"""
from __future__ import annotations

import base64
from typing import Iterable, List

GLM_EMB_ID = 151329   # <|endoftext|> doubles as the sequence-embedding slot
GLM_MASK_ID = 151330
GLM_SOP_ID = 151333
GLM_PAD_ID = 151334

# the byte-level BPE split regex glm4 tokenizes with (cl100k-family)
_PAT = (
    "(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+"
    "|\\p{N}{1,3}| ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+"
    "|\\s+(?!\\S)|\\s+"
)

_SPECIALS = [
    "<|endoftext|>", "[MASK]", "[gMASK]", "[sMASK]", "<sop>", "<eop>",
    "<|system|>", "<|user|>", "<|assistant|>", "<|observation|>",
    "<|begin_of_image|>", "<|end_of_image|>",
    "<|begin_of_video|>", "<|end_of_video|>",
]


class GlmTokenizer:
    def __init__(self, model_path: str):
        if model_path.endswith(".model"):
            import tiktoken

            ranks = {}
            with open(model_path, "rb") as f:
                for line in f:
                    if not line.strip():
                        continue
                    token, rank = line.split()
                    ranks[base64.b64decode(token)] = int(rank)
            n = len(ranks)
            special = {tok: n + i for i, tok in enumerate(_SPECIALS)}
            self._enc = tiktoken.Encoding(
                name="glm4",
                pat_str=_PAT,
                mergeable_ranks=ranks,
                special_tokens=special,
            )
            self._hf = None
            self._n_vocab = n + len(special)
        else:
            from transformers import AutoTokenizer

            self._hf = AutoTokenizer.from_pretrained(
                model_path, trust_remote_code=True
            )
            self._enc = None
            self._n_vocab = len(self._hf)
        self.emb_id = GLM_EMB_ID
        self.mask_id = GLM_MASK_ID
        self.pad_id = GLM_PAD_ID

    @property
    def vocab_size(self) -> int:
        return max(self._n_vocab, GLM_PAD_ID + 1)

    def encode(self, text: str) -> List[int]:
        if self._enc is not None:
            return self._enc.encode(text, disallowed_special=())
        return self._hf.encode(text, add_special_tokens=False)

    def decode(self, ids: Iterable[int]) -> str:
        ids = [i for i in ids if i < GLM_EMB_ID]  # strip specials
        if self._enc is not None:
            return self._enc.decode(list(ids))
        return self._hf.decode(list(ids))
