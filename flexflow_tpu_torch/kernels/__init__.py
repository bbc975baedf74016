"""Hand-written Hopper kernels of the port, each beside its plain version.

decode.py: decode attention (C = 1 and the multi-query chunk entry);
norm.py: LayerNorm forward and softmax forward. `_build.py` compiles
csrc/ into one library at first use.
"""
from __future__ import annotations

from typing import Dict

from . import decode, norm


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {**decode.LAUNCHES, **norm.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (decode.LAUNCHES, norm.LAUNCHES):
        for name in counts:
            counts[name] = 0
