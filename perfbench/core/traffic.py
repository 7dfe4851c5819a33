"""The one generator of every traffic mix.

A mix (``perfbench/traffic/<name>.json``) holds ``params`` (numbers the
driver reads: batch, image size, steps...) and ``draws``: the tensors each
request or step gets, each with a distribution and a shape whose entries
are numbers or names of sizes (the mix's params, the configuration's sizes
and the sizes a driver derives from them).  Unit ``i`` of a run with seed
``s`` draws every tensor from its own generator on the card, seeded from
(s, i, the tensor's name): every seed gives the same sizes, the same seed
the same values, and the reference can draw any unit again.

Distributions: ``normal`` (times ``scale``, default 1), ``uint8``
(uniform 0..255), ``sigmoid_normal`` (sigmoid of a standard normal: the
flow-matching timestep) and ``bernoulli`` (True with probability ``p``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from perfbench.core.weights import generator


def shape_of(spec, sizes: Mapping[str, int]):
    return tuple(int(sizes[d]) if isinstance(d, str) else int(d)
                 for d in spec["shape"])


def draw(mix: Dict[str, Any], sizes: Mapping[str, int], seed: int,
         unit: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Every tensor of unit ``unit`` (-1 is the warm-up's)."""
    out = {}
    for name, spec in mix["draws"].items():
        shape = shape_of(spec, sizes)
        gen = generator(seed, "traffic", unit, name, device=device)
        dist = spec["dist"]
        if dist == "uint8":
            t = torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                              generator=gen)
        elif dist in ("normal", "sigmoid_normal"):
            t = torch.randn(shape, device=device, generator=gen)
            t = torch.sigmoid(t) if dist == "sigmoid_normal" else \
                t * float(spec.get("scale", 1.0))
        elif dist == "bernoulli":
            t = torch.rand(shape, device=device, generator=gen) < float(
                spec["p"])
        else:
            raise ValueError(f"draw {name!r}: unknown distribution {dist!r}")
        out[name] = t
    return out
