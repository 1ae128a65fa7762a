"""Corpus-specific SFT converters: COIG-PC, DRCD, IEPile, MediaWiki dumps.

A jax-free copy of rwkv_lm_ext_tpu/data/converters.py:35-278: thin adapters
producing the instruction-jsonl format ({"input", "instruction", "output"}
per line, what data.sft consumes), covering the reference's per-corpus
scripts:
- data/convert_coig.py  (COIG-PC parquet, task-type filtered)
- data/convert_drcd.py  (DRCD SQuAD-style QA json)
- data/convert_iepile.py (IEPile information-extraction jsonl)
- data/wikipedia.py     (a MediaWiki XML dump, .xml or .xml.bz2, to
  {"title", "text"} rows)

stdlib json everywhere; parquet input needs pyarrow, imported when such a
file is read. The converters are generators over records so they compose
with any sink; the CLI writes jsonl, line for line the JAX CLI's.

CLI:
  python -m rwkv_lm_ext_tpu_torch.data.converters coig --input x.parquet \
      --output out.jsonl [--task-type 阅读理解]
  python -m rwkv_lm_ext_tpu_torch.data.converters drcd --input DRCD.json \
      --output out.jsonl
  python -m rwkv_lm_ext_tpu_torch.data.converters iepile --input dev.jsonl \
      --output out.jsonl [--task NER]
  python -m rwkv_lm_ext_tpu_torch.data.converters wiki --input dump.xml.bz2 \
      --output out.jsonl [--min-chars 64]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Iterable, Iterator

# convert_iepile.py's fallback instruction for bare input/output records
IE_DEFAULT_INSTRUCTION = (
    "你是专门进行关系抽取的专家。请从input中抽取关系三元组，"
    "不存在的关系返回空列表。请按照JSON字符串的格式回答。"
)


def convert_coig_records(
    rows: Iterable[Dict], task_type: str = "阅读理解"
) -> Iterator[Dict]:
    """COIG-PC rows -> instruction records, keeping only rows whose
    task_type major/minor contains `task_type` (convert_coig.py:9-45).

    Each row: {"input", "instruction", "output",
               "task_type": {"major": [...], "minor": [...]}}.
    """
    for row in rows:
        tt = row.get("task_type") or {}
        major = tt.get("major") or []
        minor = tt.get("minor") or []
        if isinstance(major, str):
            major = [major]
        if isinstance(minor, str):
            minor = [minor]
        if not (
            any(task_type in str(m) for m in major)
            or any(task_type in str(m) for m in minor)
        ):
            continue
        yield {
            "input": row.get("input", ""),
            "instruction": row.get("instruction", ""),
            "output": row.get("output", ""),
        }


def convert_drcd(data: Dict) -> Iterator[Dict]:
    """DRCD (SQuAD-layout) -> one record per (context, question, answer)
    with the reference's reading-comprehension instruction template
    (convert_drcd.py:6-18)."""
    for item in data.get("data", []):
        for paragraph in item.get("paragraphs", []):
            context = paragraph.get("context", "")
            for qa in paragraph.get("qas", []):
                question = qa.get("question", "")
                for answer in qa.get("answers", []):
                    yield {
                        "input": context,
                        "instruction": f"根据给定短文，回答以下问题：{question}",
                        "output": answer.get("text", ""),
                    }


def convert_iepile_records(
    rows: Iterable[Dict], task: str = "NER"
) -> Iterator[Dict]:
    """IEPile rows -> instruction records (convert_iepile.py:6-36).

    Two layouts:
    - {"task", "instruction": <json str with instruction/input/schema>,
       "output"}: kept when task matches; the inner input+schema are
      re-serialized as the record input.
    - {"input", "output"}: wrapped with the default relation-extraction
      instruction.
    """
    for row in rows:
        if "instruction" in row and "output" in row:
            if row.get("task") != task:
                continue
            inner = row["instruction"]
            if isinstance(inner, str):
                inner = json.loads(inner)
            yield {
                "input": json.dumps(
                    {"input": inner.get("input", ""),
                     "schema": inner.get("schema", [])},
                    ensure_ascii=False,
                ),
                "instruction": inner.get("instruction", ""),
                "output": row["output"],
            }
        elif "input" in row and "output" in row:
            yield {
                "input": row["input"],
                "instruction": IE_DEFAULT_INSTRUCTION,
                "output": row["output"],
            }
        else:
            raise ValueError(
                "IEPile record needs instruction+output or input+output: "
                f"{sorted(row)}"
            )


# ---------------------------------------------------------------------------
# IO helpers + CLI
# ---------------------------------------------------------------------------


def _iter_parquet(path: str) -> Iterator[Dict]:
    import pyarrow.parquet as pq

    table = pq.read_table(path)
    for batch in table.to_batches():
        yield from batch.to_pylist()


def _iter_jsonl(path: str) -> Iterator[Dict]:
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def convert_wiki_dump(
    path: str, *, min_chars: int = 64, skip_redirects: bool = True
) -> Iterator[Dict]:
    """MediaWiki XML dump (.xml or .xml.bz2) -> {"title", "text"} rows.

    Clean-room lightweight replacement for the reference's 1145-LoC HF
    datasets script (data/wikipedia.py): stdlib iterparse over the dump
    + regex wikitext cleanup (templates, tables, refs, links, markup).
    The output jsonl feeds the generic corpus pipeline
    (data.preprocess.build_binidx / MLM-MAE preprocessing) — the
    training-format side that script existed for.
    """
    import bz2
    import re
    import xml.etree.ElementTree as ET

    opener = bz2.open if path.endswith(".bz2") else open
    # strip namespace from tags as we go ({http://...}page -> page)
    strip = re.compile(r"\{.*\}")

    re_comment = re.compile(r"<!--.*?-->", re.S)
    re_ref = re.compile(r"<ref[^>/]*/>|<ref[^>]*>.*?</ref>", re.S)
    re_tag = re.compile(r"<[^>]+>")
    re_table = re.compile(r"\{\|.*?\|\}", re.S)
    re_file = re.compile(
        r"\[\[(?:File|Image|文件|圖像|图像):[^\[\]]*(?:\[\[[^\[\]]*\]\][^\[\]]*)*\]\]"
    )
    re_link = re.compile(r"\[\[(?:[^|\]]*\|)?([^\]]+)\]\]")
    re_extlink = re.compile(r"\[https?://[^\s\]]+\s?([^\]]*)\]")
    re_bold = re.compile(r"'{2,5}")
    re_heading = re.compile(r"^=+\s*(.*?)\s*=+\s*$", re.M)
    re_listmark = re.compile(r"^[\*#:;]+\s*", re.M)
    re_blank = re.compile(r"\n{3,}")

    def strip_templates(s: str) -> str:
        # innermost-out removal of {{...}} (templates nest)
        prev = None
        pat = re.compile(r"\{\{[^{}]*\}\}", re.S)
        while prev != s:
            prev = s
            s = pat.sub("", s)
        return s

    def clean(s: str) -> str:
        s = re_comment.sub("", s)
        s = strip_templates(s)
        s = re_table.sub("", s)
        s = re_ref.sub("", s)
        s = re_file.sub("", s)
        s = re_link.sub(r"\1", s)
        s = re_extlink.sub(r"\1", s)
        s = re_tag.sub("", s)
        s = re_bold.sub("", s)
        s = re_heading.sub(r"\1", s)
        s = re_listmark.sub("", s)
        s = re_blank.sub("\n\n", s)
        return s.strip()

    with opener(path, "rb") as f:
        title, ns, redirect, text = None, "0", False, None
        for event, elem in ET.iterparse(f, events=("end",)):
            tag = strip.sub("", elem.tag)
            if tag == "title":
                title = elem.text or ""
            elif tag == "ns":
                ns = elem.text or "0"
            elif tag == "redirect":
                redirect = True
            elif tag == "text":
                # itertext: robust to stray unescaped markup parsed as
                # child elements
                text = "".join(elem.itertext())
            elif tag == "page":
                if (
                    ns == "0"
                    and not (skip_redirects and redirect)
                    and text
                ):
                    body = clean(text)
                    if len(body) >= min_chars:
                        yield {"title": title, "text": body}
                title, ns, redirect, text = None, "0", False, None
                elem.clear()


def _write_jsonl(records: Iterator[Dict], path: str) -> int:
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(prog="rwkv_lm_ext_tpu_torch.data.converters")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("coig", "drcd", "iepile", "wiki"):
        s = sub.add_parser(name)
        s.add_argument("--input", required=True)
        s.add_argument("--output", required=True)
        if name == "coig":
            s.add_argument("--task-type", default="阅读理解")
        if name == "iepile":
            s.add_argument("--task", default="NER")
        if name == "wiki":
            s.add_argument("--min-chars", type=int, default=64)
    args = p.parse_args(argv)
    if args.cmd == "wiki":
        n = _write_jsonl(
            convert_wiki_dump(args.input, min_chars=args.min_chars),
            args.output,
        )
        print(f"wrote {n} records to {args.output}")
        return
    if args.cmd == "coig":
        rows = (
            _iter_parquet(args.input)
            if args.input.endswith(".parquet")
            else _iter_jsonl(args.input)
        )
        n = _write_jsonl(convert_coig_records(rows, args.task_type), args.output)
    elif args.cmd == "drcd":
        with open(args.input, "r", encoding="utf-8") as f:
            data = json.load(f)
        n = _write_jsonl(convert_drcd(data), args.output)
    else:
        n = _write_jsonl(
            convert_iepile_records(_iter_jsonl(args.input), args.task),
            args.output,
        )
    print(f"wrote {n} records to {args.output}")


if __name__ == "__main__":
    main()
