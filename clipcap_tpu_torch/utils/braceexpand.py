"""Minimal bash-style brace expansion for webdataset shard URIs.

The port's own copy of ``clipcap_tpu/utils/braceexpand.py``:

* numeric ranges with zero-padding: ``shard-{0000..0099}.tar``
* comma lists: ``{train,val}`` and nesting of both.
"""
from __future__ import annotations

import re
from typing import Iterator, List

_RANGE = re.compile(r"^(\d+)\.\.(\d+)$")


def braceexpand(pattern: str) -> Iterator[str]:
    i = pattern.find("{")
    if i == -1:
        yield pattern
        return
    # find matching close brace
    depth = 0
    for j in range(i, len(pattern)):
        if pattern[j] == "{":
            depth += 1
        elif pattern[j] == "}":
            depth -= 1
            if depth == 0:
                break
    else:
        yield pattern  # unbalanced: literal
        return

    head, body, tail = pattern[:i], pattern[i + 1 : j], pattern[j + 1 :]
    for option in _split_options(body):
        m = _RANGE.match(option)
        if m:
            lo, hi = m.group(1), m.group(2)
            width = len(lo) if (lo.startswith("0") and len(lo) > 1) else 0
            for n in range(int(lo), int(hi) + 1):
                s = str(n).zfill(width) if width else str(n)
                yield from braceexpand(head + s + tail)
        else:
            yield from braceexpand(head + option + tail)


def _split_options(body: str) -> List[str]:
    options, depth, cur = [], 0, []
    for ch in body:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            options.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    options.append("".join(cur))
    return options
