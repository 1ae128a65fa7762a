"""SFT preprocessing: instruction jsonl -> length-bucketed token examples.

A jax-free copy of rwkv_lm_ext_tpu/data/sft.py (encode_sft_example,
load_sft_jsonl): prompt template '🐱:{instruction}\\n{input}\\n🤖:', labels
-100 over the prompt, output + eos supervised.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from rwkv_lm_ext_tpu_torch.config import EOS_ID
from rwkv_lm_ext_tpu_torch.data.buckets import DEFAULT_BUCKETS, LengthBucketedDataset

PROMPT_TEMPLATE = "🐱:{instruction}\n{input}\n🤖:"


def encode_sft_example(
    tokenizer, instruction: str, input_text: str, output: str, *, eos_id: int = EOS_ID
) -> Dict[str, List[int]]:
    prompt_ids = tokenizer.encode(PROMPT_TEMPLATE.format(instruction=instruction, input=input_text))
    output_ids = tokenizer.encode(output) + [eos_id]
    return {"input_ids": prompt_ids + output_ids,
            "labels": [-100] * len(prompt_ids) + list(output_ids)}


def load_sft_jsonl(
    path: str, tokenizer, *, buckets: Sequence[int] = DEFAULT_BUCKETS,
    max_examples: Optional[int] = None,
) -> LengthBucketedDataset:
    """jsonl rows {"instruction", "input", "output"} -> bucketed dataset;
    examples longer than the largest bucket are dropped. A row's "task"
    (multi-task SFT, slot-LoRA) is kept on its example as a string."""
    ds = LengthBucketedDataset(buckets)
    with open(path, "r", encoding="utf-8") as f:
        for n, line in enumerate(f):
            if max_examples is not None and n >= max_examples:
                break
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            ex = encode_sft_example(tokenizer, row.get("instruction", ""),
                                    row.get("input", ""), row.get("output", ""))
            if "task" in row:
                ex["task"] = str(row["task"])
            ds.add(ex, len(ex["input_ids"]))
    return ds
