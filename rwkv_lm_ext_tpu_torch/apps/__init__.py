"""Demo applications of the PyTorch port: knowledge-graph extraction
(``apps.kg``) and retrieval-augmented chat (``apps.rag``).

Counterpart of rwkv_lm_ext_tpu/apps/__init__.py, with its exports.
"""
from rwkv_lm_ext_tpu_torch.apps.kg import (  # noqa: F401
    KGExtractor,
    build_graph,
    cluster_graph,
    normalize_units,
)
