"""Compact JSON helpers matching the reference byte format.

The reference writes all contract JSON with ``separators=(",", ":")``,
no indent, and (for most files) one trailing newline
(cf. reference facerec/extract.py:77-78, merge_shards.py:67-79,
cluster.py:219-223).  ``predictions.json`` is the deliberate exception:
it uses default separators and no trailing newline
(classify_knn.py:251-256).
"""
from __future__ import annotations

import json
from typing import Any, IO, Iterator


def dumps_compact(obj: Any) -> str:
    return json.dumps(obj, indent=None, separators=(",", ":"))


def dump_compact(obj: Any, fp: IO[str], newline: bool = True) -> None:
    fp.write(dumps_compact(obj))
    if newline:
        fp.write("\n")


def dump_default(obj: Any, fp: IO[str]) -> None:
    """Default-format dump (used only by predictions.json)."""
    json.dump(obj, fp)


def write_jsonl_line(fp: IO[str], obj: Any) -> None:
    dump_compact(obj, fp, newline=True)


def read_jsonl(path: str) -> Iterator[dict]:
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def read_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)
