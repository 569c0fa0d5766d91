"""Step functions of the launchers (port of `repro.launch.steps`: the
train step, the prefill step and the serve step), for every family: the
model (`DecoderLM` or whisper's `Whisper`) holds its weights, and its
`forward` / `decode_step` take the family's inputs (whisper's prefill
batch carries `frames`)."""

from __future__ import annotations

import torch

from ..models.layers import logits_last
from ..optim.adamw import make_train_step

__all__ = ["make_prefill_step", "make_serve_step", "make_train_step"]


def make_prefill_step(model):
    """-> prefill_step(batch) -> (B, V) float32 logits at the last
    position of the prompt (the next token's), from `model.forward`
    (whisper: the decoder over the encoded `frames`)."""

    @torch.no_grad()
    def prefill_step(batch):
        h = model.forward(batch)
        return logits_last(h[:, -1], model.embed.to(h.dtype))

    return prefill_step


def make_serve_step(model):
    """-> serve_step(token (B, 1), cache, index, image_embeds=None) ->
    (next_token (B, 1) int32, cache): one greedy decode step.  The model
    holds its weights, so there is no params argument; the cache is
    updated in place.  `image_embeds` reaches the model for the vlm
    family only, as in the reference; whisper's step attends the cross
    K/V its cache holds."""
    vlm = model.config.family == "vlm"

    def serve_step(token, cache, index: int, image_embeds=None):
        kw = {"image_embeds": image_embeds} if vlm else {}
        logits = model.decode_step(token, cache, index, **kw)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, cache

    return serve_step
