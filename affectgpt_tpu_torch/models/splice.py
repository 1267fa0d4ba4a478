"""Multimodal embedding splice, in PyTorch.

Port of affectgpt_tpu/models/splice.py: modality token blocks are written
into the prompt embeddings at per-sample offsets found on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def splice_embeddings(inputs_embeds: torch.Tensor, modality_embeds: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """Write modality_embeds [b, q, d] into a copy of inputs_embeds
    [b, t, d] at per-sample start positions offsets [b] (-1 = modality
    absent → row left untouched). One batched index write; the start is
    clamped into [0, t - q] as JAX's dynamic_update_slice clamps it."""
    b, t, _ = inputs_embeds.shape
    q = modality_embeds.shape[1]
    offsets = offsets.to(inputs_embeds.device)
    start = offsets.clamp(0, t - q)
    cols = start[:, None] + torch.arange(q, device=inputs_embeds.device)[None, :]  # [b, q]
    rows = torch.arange(b, device=inputs_embeds.device)[:, None]
    out = inputs_embeds.clone()
    present = (offsets >= 0)[:, None, None]
    out[rows, cols] = torch.where(present, modality_embeds.to(out.dtype), out[rows, cols])
    return out


def find_patch_run(input_ids, patch_token_id: int, num_query_tokens: int) -> int:
    """Host-side: locate the patch-token run for one sample, enforcing the
    reference's count/consecutiveness invariants. Returns start offset or
    -1 when the token does not appear."""
    ids = np.asarray(input_ids)
    positions = np.where(ids == patch_token_id)[0]
    if positions.size == 0:
        return -1
    if positions.size != num_query_tokens:
        raise ValueError(
            f"Patch token {patch_token_id} appears {positions.size} times, "
            f"expected {num_query_tokens}"
        )
    if not np.array_equal(positions, np.arange(positions[0], positions[0] + num_query_tokens)):
        raise ValueError(f"Patch tokens for {patch_token_id} are not consecutive")
    return int(positions[0])
