"""The sampling policy core (counterpart of flexflow_tpu/serving/generate.py
`sampling_logits`). GenerativeSession, the lockstep one-shot path, needs
full-sequence attention and comes with the flash-attention slice."""
from __future__ import annotations

import torch


def sampling_logits(probs: torch.Tensor, temperature: float, top_k):
    """Log-probs at `temperature`, optionally truncated to the top_k most
    likely tokens via a kth-largest threshold. Works on (V,) rows and
    (b, V) batches alike."""
    logits = torch.log(probs.float() + 1e-9) / temperature
    if top_k is not None:
        kk = int(top_k)
        if kk < 1:
            raise ValueError(f"top_k={top_k}: must be >= 1")
        kk = min(kk, logits.shape[-1])
        kth = torch.topk(logits, kk, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, float("-inf")))
    return logits
