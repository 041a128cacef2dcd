"""Alignment readers/writers: FASTA, NEXUS, Phylip with format auto-detection.

Functional rebuild of the reference's sequence I/O (reference:
src/phyc/sequenceio.c:1-527, src/phyc/sequence.c). Alignments are plain
``dict[name -> str]`` preserving insertion order.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict


def read_fasta(text: str) -> "OrderedDict[str, str]":
    seqs: OrderedDict[str, str] = OrderedDict()
    name = None
    chunks: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                seqs[name] = "".join(chunks)
            name = line[1:].strip()
            chunks = []
        else:
            chunks.append(line.replace(" ", ""))
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs


def _strip_nexus_comments(text: str) -> str:
    out = []
    depth = 0
    for ch in text:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out)


def _unquote(tok: str) -> str:
    if len(tok) >= 2 and tok[0] == "'" and tok[-1] == "'":
        return tok[1:-1].replace("''", "'")
    return tok


def read_nexus_alignment(text: str) -> "OrderedDict[str, str]":
    """Parse the data/characters block of a NEXUS file (interleaved or not)."""
    clean = _strip_nexus_comments(text)
    m = re.search(r"begin\s+(?:data|characters)\s*;(.*?)end\s*;", clean,
                  re.IGNORECASE | re.DOTALL)
    if not m:
        raise ValueError("no data/characters block in NEXUS file")
    block = m.group(1)
    mm = re.search(r"matrix(.*?);", block, re.IGNORECASE | re.DOTALL)
    if not mm:
        raise ValueError("no matrix command in NEXUS data block")
    seqs: OrderedDict[str, list] = OrderedDict()
    for line in mm.group(1).splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("'"):
            end = line.index("'", 1)
            name, rest = line[: end + 1], line[end + 1 :]
        else:
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            name, rest = parts
        name = _unquote(name)
        seqs.setdefault(name, []).append(rest.replace(" ", ""))
    return OrderedDict((k, "".join(v)) for k, v in seqs.items())


def read_phylip(text: str) -> "OrderedDict[str, str]":
    lines = [ln for ln in text.splitlines() if ln.strip()]
    ntax, nchar = (int(x) for x in lines[0].split()[:2])
    seqs: OrderedDict[str, list] = OrderedDict()
    body = lines[1:]
    # sequential or interleaved: first ntax lines carry names
    for ln in body[:ntax]:
        parts = ln.split(None, 1)
        name = parts[0]
        rest = parts[1].replace(" ", "") if len(parts) > 1 else ""
        seqs[name] = [rest]
    names = list(seqs)
    i = 0
    for ln in body[ntax:]:
        seqs[names[i % ntax]].append(ln.replace(" ", ""))
        i += 1
    out = OrderedDict((k, "".join(v)) for k, v in seqs.items())
    for k, v in out.items():
        if len(v) != nchar:
            raise ValueError(f"sequence {k}: length {len(v)} != {nchar}")
    return out


def read_alignment(path_or_text: str) -> "OrderedDict[str, str]":
    """Auto-detecting reader (reference: src/phyc/sequenceio.c readSequences)."""
    if os.path.exists(path_or_text):
        with open(path_or_text) as fh:
            text = fh.read()
    else:
        text = path_or_text
    stripped = text.lstrip()
    if stripped.startswith(">"):
        return read_fasta(text)
    if stripped[:6].lower() == "#nexus":
        return read_nexus_alignment(text)
    return read_phylip(text)


def write_fasta(seqs: dict, path: str | None = None) -> str:
    out = "".join(f">{k}\n{v}\n" for k, v in seqs.items())
    if path:
        with open(path, "w") as fh:
            fh.write(out)
    return out


def write_phylip(seqs: dict, path: str | None = None) -> str:
    n = len(seqs)
    L = len(next(iter(seqs.values()))) if n else 0
    out = [f" {n} {L}"]
    for k, v in seqs.items():
        out.append(f"{k}  {v}")
    text = "\n".join(out) + "\n"
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    return text


def write_nexus_alignment(seqs: dict, path: str | None = None,
                          datatype: str = "dna") -> str:
    n = len(seqs)
    L = len(next(iter(seqs.values()))) if n else 0
    lines = [
        "#NEXUS",
        "begin data;",
        f"\tdimensions ntax={n} nchar={L};",
        f"\tformat datatype={datatype} gap=-;",
        "\tmatrix",
    ]
    for k, v in seqs.items():
        name = f"'{k}'" if re.search(r"[\s()\[\]{}/\\,;:=*'\"`+<>-]", k) else k
        lines.append(f"{name}  {v}")
    lines += [";", "end;", ""]
    text = "\n".join(lines)
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    return text
