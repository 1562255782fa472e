"""Model architecture dump and compare (port of
``mixdq_tpu/analysis/model_arch.py``): the quantizable-layer name space
with weight shapes as text, one ``name: shape`` line a layer, and the
diff of two dumps. Shapes are the JAX package's (dense ``[K, N]``, conv
HWIO), so the two packages' dumps of one model compare equal."""

from __future__ import annotations

from typing import Dict, List

from ..quant.state import quantizable_layers


def dump_structure(model) -> str:
    """One line per quantizable layer, sorted: ``name: (shape)``. Reads
    shapes only: a model built on the meta device serves."""
    layers = quantizable_layers(model)
    return "".join(f"{n}: {tuple(layers[n].weight.shape)}\n"
                   for n in sorted(layers))


def compare_structures(a: str, b: str) -> Dict[str, List[str]]:
    """Diff two dumps -> {'only_a', 'only_b', 'shape_mismatch'}."""
    def parse(s):
        out = {}
        for line in s.strip().splitlines():
            if ":" in line:
                name, shape = line.split(":", 1)
                out[name.strip()] = shape.strip()
        return out

    da, db = parse(a), parse(b)
    return {
        "only_a": sorted(set(da) - set(db)),
        "only_b": sorted(set(db) - set(da)),
        "shape_mismatch": sorted(
            n for n in set(da) & set(db) if da[n] != db[n]),
    }
