"""Model API of the dense decoder LM, ported from `repro/models/api.py`.

The JAX package's four entry points, with the parameters as the port's
`Decoder` module in place of the JAX pytree:

    init(seed)                      -> params
    loss_fn(params, batch)          -> (loss, metrics)
    prefill_fn(params, batch)       -> {"logits", "cache"}
    decode_fn(params, cache, batch) -> (new_cache, logits)

A batch holds "tokens" (and "labels" for the loss) as numpy arrays or
tensors. The model runs on `device`, "cuda" by default; without a card it
raises unless the caller asks for "cpu". Prefill and decode run under
torch.no_grad(); loss_fn leaves autograd to the caller and is
differentiable on the card as on the CPU: the flash kernel's backward is a
kernel too (`kernels/ops.py::FlashAttention`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import ModelConfig


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


# ---------------------------------------------------------------------------
# Decoder-family model (dense)
# ---------------------------------------------------------------------------
def _positions_for(batch: int, seq: int, device: torch.device, offset: Any = 0
                   ) -> torch.Tensor:
    pos = offset + torch.arange(seq, dtype=torch.int32, device=device)
    return pos.expand(batch, seq)


class DecoderModel:
    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family} is not ported to repro_torch yet; see "
                f"ROADMAP.md (queue 1, item 12)")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> tfm.Decoder:
        """Parameters drawn on the model's device from a torch.Generator
        seeded with `seed`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return tfm.init_decoder(self.cfg, generator=gen, device=self.device)

    def _ids(self, x: Any) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def loss_fn(self, params: tfm.Decoder, batch: dict) -> tuple[torch.Tensor, dict]:
        """(mean next-token loss, metrics); differentiable, through the flash
        backward kernel on the card. The head takes HEAD_CHUNK rows at a
        time with grad or without (`tfm.head_loss`)."""
        tokens = self._ids(batch["tokens"])
        b, s = tokens.shape
        h, _ = tfm.decoder_hidden(params, self.cfg, tokens,
                                  positions=_positions_for(b, s, self.device))
        # the JAX loss adds 0.01 * the MoE aux loss, which is 0 for a dense model
        return tfm.head_loss(params, self.cfg, h, self._ids(batch["labels"]))

    def init_cache(self, batch: int, max_len: int) -> dict:
        return tfm.init_decode_cache(self.cfg, batch, max_len, device=self.device)

    @torch.no_grad()
    def prefill_fn(self, params: tfm.Decoder, batch: dict, *, headroom: int = 64) -> dict:
        tokens = self._ids(batch["tokens"])
        b, s = tokens.shape
        # headroom: decode steps append past the prompt; a cache sized
        # exactly S would clamp the first decode write onto slot S-1
        caches = self.init_cache(b, s + headroom)
        logits, caches = tfm.decoder_forward(params, self.cfg, tokens,
                                             positions=_positions_for(b, s, self.device),
                                             caches=caches)
        return {"logits": logits[:, -1], "cache": caches}

    @torch.no_grad()
    def decode_fn(self, params: tfm.Decoder, cache: dict, batch: dict
                  ) -> tuple[dict, torch.Tensor]:
        """One token a row at the cache's position. The cache's K/V buffers
        are updated in place; use the returned cache from here on."""
        tokens = self._ids(batch["tokens"])                      # (B, 1)
        pos = _positions_for(tokens.shape[0], 1, self.device, offset=cache["pos"][0])
        logits, cache = tfm.decoder_forward(params, self.cfg, tokens, positions=pos,
                                            caches=cache)
        return cache, logits[:, -1]


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda") -> DecoderModel:
    """The model of a config's family; only the dense decoder is ported."""
    return DecoderModel(cfg, device=device)
