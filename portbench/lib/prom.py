"""The program's /metrics (Prometheus text) read around the window."""
from __future__ import annotations

import re
import urllib.request

_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str) -> dict:
    """{(sample name, ((label, value), ...)): value}."""
    out = {}
    for line in text.splitlines():
        m = _LINE.match(line)
        if m is None or line.startswith("#"):
            continue
        labels = tuple(sorted(_LABEL.findall(m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def scrape(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as r:
        return parse(r.read().decode())


def delta(before: dict, after: dict, sample: str, **labels) -> float:
    """The window's increase of every sample ``sample`` whose labels
    include ``labels``, summed."""
    want = set(labels.items())
    return sum(v - before.get(k, 0.0) for k, v in after.items()
               if k[0] == sample and want <= set(k[1]))


def hist_mean(scrapes: list, family: str, **labels):
    """Mean of a histogram's observations in the window, over every
    process's (before, after) scrape; None where it observed nothing."""
    s = sum(delta(b, a, family + "_sum", **labels) for b, a in scrapes)
    n = sum(delta(b, a, family + "_count", **labels) for b, a in scrapes)
    return s / n if n > 0 else None
