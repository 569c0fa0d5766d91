"""The serve step (port of `repro.launch.steps.make_serve_step`)."""

from __future__ import annotations

import torch


def make_serve_step(model):
    """-> serve_step(token (B, 1), cache, index, image_embeds=None) ->
    (next_token (B, 1) int32, cache): one greedy decode step.  The model
    holds its weights, so there is no params argument; the cache is
    updated in place.  `image_embeds` reaches the model for the vlm
    family only, as in the reference."""
    vlm = model.config.family == "vlm"

    def serve_step(token, cache, index: int, image_embeds=None):
        kw = {"image_embeds": image_embeds} if vlm else {}
        logits = model.decode_step(token, cache, index, **kw)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, cache

    return serve_step
