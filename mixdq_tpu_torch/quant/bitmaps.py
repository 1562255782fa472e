"""Readers of the repo's flat mixed-precision files (port of
``load_final_config`` and ``load_act_protect`` in
``mixdq_tpu/mixed_precision/reference_data.py``), without a YAML library.

The files under ``configs/mp/`` that a deploy reads hold one of two flat
forms: a bit map, one ``layer.name: bits`` per line, or a layer list, one
``- layer.name`` per line; ``#`` comment lines and blank lines are
skipped. A leading ``model.`` (the reference's module prefix) is stripped
from each name. Any other line raises ``ValueError``: nested files (the
sensitivity logs, ``validation.yaml``) belong to the bit-width search.
An act-protect list may also be the reference's torch-saved ``.pt`` list
of names (``load_act_protect_pt``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_NAME = r"[A-Za-z0-9_.]+"
_MAP_LINE = re.compile(rf"({_NAME}):\s*(-?\d+)\s*")
_LIST_LINE = re.compile(rf"-\s+({_NAME})\s*")


def _strip(name: str) -> str:
    return name[len("model."):] if name.startswith("model.") else name


def _entries(path: str) -> Tuple[str, List[Tuple[str, ...]]]:
    """(form, entries) of a flat file: ``'map'`` with (name, bits) pairs
    or ``'list'`` with (name,) tuples."""
    form, out = None, []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            s = line.rstrip("\n")
            if not s.strip() or s.lstrip().startswith("#"):
                continue
            m = _MAP_LINE.fullmatch(s)
            kind = "map"
            if m is None:
                m, kind = _LIST_LINE.fullmatch(s), "list"
            if m is None or form not in (None, kind):
                raise ValueError(f"{path}:{i}: not a flat bit map or layer "
                                 f"list line: {s!r}")
            form = kind
            out.append(m.groups())
    return form, out


def load_bit_map(path: str) -> Dict[str, int]:
    """A per-layer bit map ``{layer: bits}``."""
    form, entries = _entries(path)
    if form == "list":
        raise ValueError(f"{path}: a layer list, not a bit map")
    out = {}
    for name, bits in entries:
        name = _strip(name)
        if name in out:
            raise ValueError(f"{path}: {name} appears twice")
        out[name] = int(bits)
    return out


def load_layer_list(path: str) -> List[str]:
    """An act-protect list: a layer list, or a bit map whose names count
    (as ``load_act_protect`` accepts either), or the reference's
    torch-saved ``.pt`` list of names (``act_sensitivie_a8_1%.pt``), read
    with ``weights_only=True``: a list of strings needs nothing more."""
    if path.endswith(".pt"):
        import torch

        names = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(names, (list, tuple)) or not all(
                isinstance(n, str) for n in names):
            raise ValueError(f"{path}: {type(names).__name__}, not a list "
                             "of layer names")
        return [_strip(n) for n in names]
    _, entries = _entries(path)
    return [_strip(e[0]) for e in entries]
