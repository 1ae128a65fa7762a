"""Optional `mteb` / C-MTEB package adapter.

A jax-free copy of rwkv_lm_ext_tpu/eval/mteb_adapter.py:22-111
(MtebBiEncoder, run_mteb) over the port's
:class:`rwkv_lm_ext_tpu_torch.infer.encoders.BiEncoder`. The reference
evaluates with the mteb pip harness through a model class exposing
``encode(sentences, batch_size=..., **kw)`` (tests/test_cmteb.py:71-94);
``encode_queries`` / ``encode_corpus`` are the pair mteb's retrieval
evaluators (DRES protocol) call. mteb is imported by ``run_mteb`` only, and
raises a clear ImportError there when the package is absent.

For dependency-free evaluation of the same task dumps, use
``eval.tasks.RetrievalTask`` (the file-format-compatible runner).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np


class MtebBiEncoder:
    """mteb-protocol model over a BiEncoder.

    >>> model = MtebBiEncoder(BiEncoder(model, tokenizer))
    >>> import mteb
    >>> mteb.MTEB(tasks=["MMarcoRetrieval"]).run(model)
    """

    def __init__(
        self,
        bi_encoder,
        *,
        batch_size: int = 32,
        query_instruction: str = "",
        corpus_instruction: str = "",
    ):
        self.bi = bi_encoder
        self.batch_size = batch_size
        # instruction prefixes (instructor-style checkpoints); plain
        # bi-encoders leave them empty
        self.query_instruction = query_instruction
        self.corpus_instruction = corpus_instruction

    # --- the protocol mteb>=1.x calls -----------------------------------
    def encode(
        self, sentences: Sequence[str], batch_size: Optional[int] = None,
        **kwargs,
    ) -> np.ndarray:
        return self.bi.encode_texts(
            list(sentences), batch_size=batch_size or self.batch_size
        )

    def encode_queries(
        self, queries: Sequence[str], batch_size: Optional[int] = None,
        **kwargs,
    ) -> np.ndarray:
        return self.encode(
            [self.query_instruction + q for q in queries],
            batch_size=batch_size, **kwargs,
        )

    def encode_corpus(
        self,
        corpus: Sequence[Union[str, dict]],
        batch_size: Optional[int] = None,
        **kwargs,
    ) -> np.ndarray:
        # retrieval tasks pass rows as {"title": ..., "text": ...}
        texts = [
            (
                ((d.get("title") or "") + " " + d["text"]).strip()
                if isinstance(d, dict)
                else d
            )
            for d in corpus
        ]
        return self.encode(
            [self.corpus_instruction + t for t in texts],
            batch_size=batch_size, **kwargs,
        )


def run_mteb(
    model: MtebBiEncoder,
    tasks: List[str],
    *,
    output_folder: Optional[str] = None,
    verbosity: int = 1,
    **mteb_kwargs,
):
    """`MTEB(tasks=...).run(model)` with the import gated here so callers
    get one actionable error when the package is absent (the reference
    pulls in C_MTEB the same way, tests/test_cmteb.py:48-49)."""
    try:
        from mteb import MTEB
    except ImportError as e:
        raise ImportError(
            "the `mteb` package is not installed; install it to run the "
            "pip harness, or use rwkv_lm_ext_tpu_torch.eval.tasks.RetrievalTask "
            "on a task dump for dependency-free evaluation"
        ) from e
    try:  # C-MTEB registers the Chinese tasks as a side effect
        import C_MTEB  # noqa: F401
    except ImportError:
        pass
    evaluation = MTEB(tasks=tasks, **mteb_kwargs)
    return evaluation.run(
        model, verbosity=verbosity, output_folder=output_folder
    )
