"""Model API of the LMs, ported from `repro/models/api.py`: the decoders
(dense and MoE), the xLSTM (ssm) and the Zamba2 hybrid.

The JAX package's four entry points, with the parameters as the port's
modules (`Decoder`, `XLSTM`, `Zamba`) in place of the JAX pytree:

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
from repro_torch.models import ssm as xl
from repro_torch.models import transformer as tfm
from repro_torch.models import zamba as zb
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
# Decoder-family model (dense and MoE)
# ---------------------------------------------------------------------------
def _positions_for(batch: int, seq: int, device: torch.device, offset: Any = 0
                   ) -> torch.Tensor:
    pos = offset + torch.arange(seq, dtype=torch.int32, device=device)
    return pos.expand(batch, seq)


#: the families DecoderModel runs; the SSM and hybrid families are
#: XLSTMModel's and ZambaModel's (`build_model`), and the audio and VLM
#: ones are ROADMAP.md's queue 1, item 12.3
FAMILIES = ("dense", "moe")


class _LM:
    """What the models share: the config, the device (raising without a
    card unless "cpu" is asked for), the parameters from a seed and token
    ids on the device. A model names its families, the constructor of its
    parameter module (`make_params(cfg, *, generator, device)`, left empty
    when generator is None) and whether its decode cache grows: a K/V
    buffer sized at prefill for the decode steps, whose `prefill_fn` takes
    `headroom`."""

    family: tuple[str, ...] = ()
    make_params: Any = None
    cache_grows = True

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.family not in self.family:
            raise NotImplementedError(
                f"{type(self).__name__} runs the families {self.family}, not "
                f"{cfg.family}: build_model(cfg) gives the model of each ported family "
                "(dense and moe: DecoderModel, ssm: XLSTMModel, hybrid: ZambaModel); "
                "the audio and VLM families are not ported yet, see ROADMAP.md "
                "(queue 1, item 12)")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> torch.nn.Module:
        """Parameters drawn on the model's device from a torch.Generator
        seeded with `seed`."""
        return self.make_params(self.cfg, generator=self._generator(seed),
                                device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _ids(self, x: Any) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)


class DecoderModel(_LM):
    family = FAMILIES
    make_params = staticmethod(tfm.init_decoder)

    def loss_fn(self, params: tfm.Decoder, batch: dict) -> tuple[torch.Tensor, dict]:
        """(mean next-token loss + 0.01 * the layers' MoE aux loss, metrics
        with "ce", "tokens" and "aux"); differentiable, through the flash
        backward kernel on the card. The head takes HEAD_CHUNK rows at a
        time with grad or without (`tfm.head_loss`)."""
        tokens = self._ids(batch["tokens"])
        b, s = tokens.shape
        h, _, aux = tfm.decoder_hidden(params, self.cfg, tokens,
                                       positions=_positions_for(b, s, self.device))
        loss, metrics = tfm.head_loss(params, self.cfg, h, self._ids(batch["labels"]))
        metrics["aux"] = aux
        return loss + 0.01 * aux, metrics

    def init_cache(self, batch: int, max_len: int) -> dict:
        return tfm.init_decode_cache(self.cfg, batch, max_len, device=self.device)

    @torch.no_grad()
    def prefill_fn(self, params: tfm.Decoder, batch: dict, *, headroom: int = 64) -> dict:
        tokens = self._ids(batch["tokens"])
        b, s = tokens.shape
        # headroom: decode steps append past the prompt; a cache sized
        # exactly S would clamp the first decode write onto slot S-1
        caches = self.init_cache(b, s + headroom)
        logits, caches, _ = tfm.decoder_forward(params, self.cfg, tokens,
                                                positions=_positions_for(b, s, self.device),
                                                caches=caches)
        # a copy: the view logits[:, -1] would keep the whole (B, S, V) fp32
        # logits alive (8.4 GB for gemma2-2b at 4 x 2,048)
        return {"logits": logits[:, -1].clone(), "cache": caches}

    @torch.no_grad()
    def decode_fn(self, params: tfm.Decoder, cache: dict, batch: dict
                  ) -> tuple[dict, torch.Tensor]:
        """One token a row at the cache's position. The cache's K/V buffers
        are updated in place; use the returned cache from here on."""
        tokens = self._ids(batch["tokens"])                      # (B, 1)
        pos = _positions_for(tokens.shape[0], 1, self.device, offset=cache["pos"][0])
        logits, cache, _ = tfm.decoder_forward(params, self.cfg, tokens, positions=pos,
                                               caches=cache)
        return cache, logits[:, -1]


# ---------------------------------------------------------------------------
# xLSTM (ssm)
# ---------------------------------------------------------------------------
class XLSTMModel(_LM):
    """The xLSTM's entry points, as `repro.models.api.XLSTMModel`'s. Its
    states are of a fixed size, so `prefill_fn` takes no headroom. No
    kernel of the port runs in it (`models/ssm.py`)."""

    family = ("ssm",)
    make_params = staticmethod(xl.init_xlstm)
    cache_grows = False

    def loss_fn(self, params: xl.XLSTM, batch: dict) -> tuple[torch.Tensor, dict]:
        """(mean next-token loss, metrics with "ce" and "tokens") of the
        cache-free forward."""
        logits, _ = xl.xlstm_forward(params, self.cfg, self._ids(batch["tokens"]))
        return tfm.cross_entropy(logits, self._ids(batch["labels"]))

    def init_cache(self, batch: int, max_len: int = 0) -> dict:
        return xl.xlstm_init_states(self.cfg, batch, device=self.device)

    @torch.no_grad()
    def prefill_fn(self, params: xl.XLSTM, batch: dict) -> dict:
        """The prompt through the forward from zero states: the chunked
        mLSTM and the sLSTM scan, whose final states are the cache."""
        tokens = self._ids(batch["tokens"])
        states = self.init_cache(tokens.shape[0])
        logits, states = xl.xlstm_forward(params, self.cfg, tokens, states)
        return {"logits": logits[:, -1].clone(), "cache": states}

    @torch.no_grad()
    def decode_fn(self, params: xl.XLSTM, cache: dict, batch: dict
                  ) -> tuple[dict, torch.Tensor]:
        """One token a row; the states are updated in place."""
        logits, cache = xl.xlstm_forward(params, self.cfg, self._ids(batch["tokens"]), cache)
        return cache, logits[:, -1]


# ---------------------------------------------------------------------------
# Zamba2 (hybrid)
# ---------------------------------------------------------------------------
class ZambaModel(_LM):
    """The hybrid's entry points, as `repro.models.api.ZambaModel`'s. The
    cache-free forward of a long sequence runs the flash kernel once an
    application of the shared block; prefill and decode take the direct
    attention path."""

    family = ("hybrid",)
    make_params = staticmethod(zb.init_zamba)

    def loss_fn(self, params: zb.Zamba, batch: dict) -> tuple[torch.Tensor, dict]:
        """(mean next-token loss, metrics with "ce" and "tokens") of the
        cache-free forward."""
        tokens = self._ids(batch["tokens"])
        logits, _ = zb.zamba_forward(params, self.cfg, tokens,
                                     positions=_positions_for(*tokens.shape, self.device))
        return tfm.cross_entropy(logits, self._ids(batch["labels"]))

    def init_cache(self, batch: int, max_len: int) -> dict:
        return zb.zamba_init_states(self.cfg, batch, max_len, device=self.device)

    @torch.no_grad()
    def prefill_fn(self, params: zb.Zamba, batch: dict, *, headroom: int = 64) -> dict:
        tokens = self._ids(batch["tokens"])
        b, s = tokens.shape
        states = self.init_cache(b, s + headroom)
        logits, states = zb.zamba_forward(params, self.cfg, tokens,
                                          positions=_positions_for(b, s, self.device),
                                          states=states)
        return {"logits": logits[:, -1].clone(), "cache": states}

    @torch.no_grad()
    def decode_fn(self, params: zb.Zamba, cache: dict, batch: dict
                  ) -> tuple[dict, torch.Tensor]:
        """One token a row at the first group's position; the caches and
        states are updated in place."""
        tokens = self._ids(batch["tokens"])
        pos = _positions_for(tokens.shape[0], 1, self.device, offset=cache["attn_pos"][0])
        logits, cache = zb.zamba_forward(params, self.cfg, tokens, positions=pos,
                                         states=cache)
        return cache, logits[:, -1]


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda"):
    """The model of a config's family: DecoderModel (dense, moe),
    XLSTMModel (ssm) or ZambaModel (hybrid); any other family raises
    NotImplementedError, naming ROADMAP.md."""
    if cfg.family == "ssm":
        return XLSTMModel(cfg, device=device)
    if cfg.family == "hybrid":
        return ZambaModel(cfg, device=device)
    return DecoderModel(cfg, device=device)


def params_from_numpy(tree: dict, cfg: ModelConfig, *,
                      device: str | torch.device = "cuda") -> torch.nn.Module:
    """A JAX model's parameter tree (numpy arrays, stacked layers on their
    leading axes) as the parameter module of `cfg.family`'s model on
    `device`: `Decoder` (dense and MoE; layers stacked (L, ...)), `XLSTM`
    (ssm; `mlstm` (G, n_m, ...), `slstm` (G, ...)) or `Zamba` (hybrid;
    `mamba` (G, n_per, ...), one unstacked `shared` block). What it
    refuses: `models/transformer.py::load_numpy`."""
    model = build_model(cfg, device=device)
    return tfm.load_numpy(model.make_params(cfg, generator=None, device=model.device), tree)
