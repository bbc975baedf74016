"""Sequence preprocessing. reference parity:
python/flexflow/keras/preprocessing/sequence.py (pad_sequences)."""
from __future__ import annotations

import numpy as np


def pad_sequences(sequences, maxlen=None, dtype="int32", padding="pre",
                  truncating="pre", value=0.0):
    lengths = [len(s) for s in sequences]
    if maxlen is None:
        maxlen = max(lengths) if lengths else 0
    out = np.full((len(sequences), maxlen), value, dtype=dtype)
    for i, s in enumerate(sequences):
        if not len(s):
            continue
        s = np.asarray(s)
        if len(s) > maxlen:
            s = s[-maxlen:] if truncating == "pre" else s[:maxlen]
        if padding == "pre":
            out[i, -len(s):] = s
        else:
            out[i, : len(s)] = s
    return out
