"""Knowledge-graph extraction pipeline.

A jax-free copy of rwkv_lm_ext_tpu/apps/kg.py:11-162 (normalize_units,
_extract_json, KGExtractor, build_graph, cluster_graph), the reference's KG
demo apps (infer/create_kg.py:1-85, create_graph.py:1-205,
cluster_graph.py:1-68, kg_schema.py): a state-tuned model extracts typed
entities/relations from raw text as JSON, generating through a named state
of the port's ``infer.states_registry.StatesRegistry`` on its
``GenerationEngine``; records accumulate into a networkx graph with unit
normalization; connected components cluster the graph. networkx is imported
by ``build_graph`` and ``cluster_graph`` only. The reference's Chinese
power-domain schema dict is user data — supply your own via `schema`; the
default shows the expected structure.
"""
from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional

DEFAULT_SCHEMA = {
    "entities": ["person", "organization", "location", "product", "quantity"],
    "relations": [
        {"type": "works_for", "head": "person", "tail": "organization"},
        {"type": "located_in", "head": "organization", "tail": "location"},
        {"type": "produces", "head": "organization", "tail": "product"},
        {"type": "measures", "head": "product", "tail": "quantity"},
    ],
}

_UNIT_FACTORS = {
    # unit normalization table (create_graph.py's unit_extractor role):
    # canonicalize magnitudes so "3 km" and "3000 m" merge
    "km": ("m", 1000.0),
    "cm": ("m", 0.01),
    "mm": ("m", 0.001),
    "t": ("kg", 1000.0),
    "g": ("kg", 0.001),
    "mg": ("kg", 1e-6),
    "kw": ("w", 1000.0),
    "mw": ("w", 1e6),
    "gwh": ("kwh", 1e6),
    "mwh": ("kwh", 1e3),
    "万": ("", 1e4),
    "亿": ("", 1e8),
}

_NUM_UNIT = re.compile(r"^\s*([-+]?\d+(?:\.\d+)?)\s*([^\d\s]+)?\s*$")


def normalize_units(value: str) -> str:
    """'3 km' -> '3000.0 m'; unknown units pass through unchanged."""
    m = _NUM_UNIT.match(value)
    if not m:
        return value
    num, unit = float(m.group(1)), (m.group(2) or "").lower()
    if unit in _UNIT_FACTORS:
        base, factor = _UNIT_FACTORS[unit]
        return f"{num * factor:g} {base}".strip()
    return value


def _extract_json(text: str) -> Optional[Dict]:
    """Best-effort JSON recovery from model output (the reference parses
    generation output as JSON and skips failures, create_kg.py:60-80)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    start = text.find("{")
    while start != -1:
        depth = 0
        for i in range(start, len(text)):
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    try:
                        return json.loads(text[start : i + 1])
                    except json.JSONDecodeError:
                        break
        start = text.find("{", start + 1)
    return None


class KGExtractor:
    """Extract entities/relations from text with a state-tuned model.

    engine + states_registry: generation through a named tuned state whose
    template asks for JSON {"entities": [{"name","type"}...],
    "relations": [{"head","type","tail"}...]}."""

    def __init__(
        self,
        engine,
        states_registry,
        *,
        action: str = "kg_extract",
        schema: Optional[Dict] = None,
        max_tokens: int = 512,
    ):
        self.engine = engine
        self.states = states_registry
        self.action = action
        self.schema = schema or DEFAULT_SCHEMA
        self.max_tokens = max_tokens

    def extract(self, text: str, **gen_kw) -> Dict:
        out = self.states.generate(
            self.engine, self.action, text,
            max_tokens=self.max_tokens, **gen_kw,
        )
        parsed = _extract_json(out if isinstance(out, str) else "")
        if not parsed:
            return {"entities": [], "relations": []}
        ents = [
            e for e in parsed.get("entities", [])
            if isinstance(e, dict) and "name" in e
        ]
        rels = [
            r for r in parsed.get("relations", [])
            if isinstance(r, dict) and "head" in r and "tail" in r
        ]
        return {"entities": ents, "relations": rels}

    def extract_corpus(self, texts: Iterable[str], **gen_kw) -> List[Dict]:
        return [self.extract(t, **gen_kw) for t in texts]


def build_graph(records: Iterable[Dict], *, normalize: bool = True):
    """Accumulate extraction records into a directed graph
    (create_graph.py behavior: nodes keyed by normalized name, edge data
    keeps the relation type and source count)."""
    import networkx as nx

    g = nx.DiGraph()
    for rec in records:
        for ent in rec.get("entities", []):
            name = ent["name"]
            if normalize:
                name = normalize_units(name)
            if g.has_node(name):
                g.nodes[name]["count"] += 1
            else:
                g.add_node(name, type=ent.get("type", ""), count=1)
        for rel in rec.get("relations", []):
            h, t = rel["head"], rel["tail"]
            if normalize:
                h, t = normalize_units(h), normalize_units(t)
            for node in (h, t):
                if not g.has_node(node):
                    g.add_node(node, type="", count=0)
            if g.has_edge(h, t):
                g[h][t]["count"] += 1
            else:
                g.add_edge(h, t, type=rel.get("type", ""), count=1)
    return g


def cluster_graph(g) -> List[List[str]]:
    """Weakly-connected components, largest first (cluster_graph.py)."""
    import networkx as nx

    comps = [sorted(c) for c in nx.weakly_connected_components(g)]
    return sorted(comps, key=len, reverse=True)
