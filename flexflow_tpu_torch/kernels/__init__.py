"""Hand-written Hopper kernels of the port, each beside its plain version.

decode.py: decode attention (C = 1 and the multi-query chunk entry);
norm.py: LayerNorm, RMSNorm and softmax, forward and backward;
flash_attention.py: flash attention forward and backward, on packed
heads and head-separated (blhd, bhld); reduction.py: the scalar sum /
mean / max and the inclusive scan (cumsum); optimizer.py: the Adam and
SGD update over a list of weight tensors. `_build.py` compiles
csrc/ into one library at first use; registry.py selects, per op family,
between these kernels and the ops' reference lowerings.
"""
from __future__ import annotations

from typing import Dict

from . import decode, flash_attention, norm, optimizer, reduction

_COUNTS = (decode.LAUNCHES, decode.ROUTES, flash_attention.LAUNCHES,
           flash_attention.ROUTES, norm.LAUNCHES, norm.ROUTES,
           reduction.LAUNCHES, reduction.ROUTES, optimizer.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset, and the planned
    wrappers' calls per route ("decode_attention/tc", "flash_fwd/tc",
    "softmax_fwd/rows", "softmax_bwd/cluster", "reduce/cta",
    "cumsum/split", ...)."""
    return {name: n for counts in _COUNTS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0
