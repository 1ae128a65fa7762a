"""Evaluation harnesses of the PyTorch port: STS correlation, retrieval,
reranking, the C-MTEB-style task runner and the ``eval.cli`` commands.

Counterpart of rwkv_lm_ext_tpu/eval/__init__.py:9-13, with its exports.
"""
from rwkv_lm_ext_tpu_torch.eval.retrieval import rerank_metrics, retrieval_metrics  # noqa: F401
from rwkv_lm_ext_tpu_torch.eval.sts import SimilarityEvaluator  # noqa: F401
