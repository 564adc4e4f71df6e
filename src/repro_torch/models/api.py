"""Model API of the LMs, ported from `repro/models/api.py`: the decoders
(dense, MoE and the VLM), whisper's encoder-decoder (audio), the xLSTM
(ssm) and the Zamba2 hybrid.

The JAX package's four entry points, with the parameters as the port's
modules (`Decoder`, `EncDec`, `XLSTM`, `Zamba`) in place of the JAX pytree:

    init(seed)                      -> params
    loss_fn(params, batch)          -> (loss, metrics)
    prefill_fn(params, batch)       -> {"logits", "cache"}
    decode_fn(params, cache, batch) -> (new_cache, logits)

`shape_by_name`, `supported_shapes`, `count_params`, `model_flops_per_step`
and `input_specs` are the JAX package's, for the dry-run
(`launch/dryrun.py`), which builds a model on the meta device.

A batch holds "tokens" (and "labels" for the loss) as numpy arrays or
tensors, and the modality stubs' inputs as `data.tokens.TokenStream` makes
them: whisper's "frames" (B, encoder_seq, D); the VLM's "patch_embeds"
(B, n_patches, D), put before the text, and its M-RoPE "positions"
(B, 3, S) at prefill and (B, 3, 1) at each decode step, which the caller
gives (the decode cache's index is no M-RoPE position). The model runs on
`device`, "cuda" by default; without a card it raises unless the caller
asks for "cpu". Prefill and decode run under torch.no_grad(); loss_fn
leaves autograd to the caller and is differentiable on the card as on the
CPU: the flash kernel's backward is a kernel too
(`kernels/ops.py::FlashAttention`). It takes S_q == S_k, so whisper's
loss_fn raises under grad once its cross-attention takes the flash route
(more than `attn_chunk` frames at `chunked_attn_min_len` tokens or more).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import ssm as xl
from repro_torch.models import transformer as tfm
from repro_torch.models import zamba as zb
from repro_torch.models.layers import ModelConfig

#: the JAX package's EncDecModel default: rows of whisper's decoder
#: position table
MAX_DEC_LEN = 32_768


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


def shape_by_name(name: str) -> ShapeSpec:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def supported_shapes(cfg: ModelConfig) -> list[ShapeSpec]:
    """LM_SHAPES, long_500k only for the sub-quadratic (ssm, hybrid)
    families, as the JAX package's."""
    return [s for s in LM_SHAPES
            if s.name != "long_500k" or cfg.family in ("ssm", "hybrid")]


# ---------------------------------------------------------------------------
# Decoder-family model (dense, MoE and VLM)
# ---------------------------------------------------------------------------
def _positions_for(batch: int, seq: int, device: torch.device, offset: Any = 0
                   ) -> torch.Tensor:
    pos = offset + torch.arange(seq, dtype=torch.int32, device=device)
    return pos.expand(batch, seq)


#: the families DecoderModel runs; the audio, SSM and hybrid families are
#: EncDecModel's, XLSTMModel's and ZambaModel's (`build_model`)
FAMILIES = ("dense", "moe", "vlm")


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
                "(dense, moe and vlm: DecoderModel, audio: EncDecModel, ssm: XLSTMModel, "
                "hybrid: ZambaModel); ROADMAP.md (queue 1) lists what is left to port")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> torch.nn.Module:
        """Parameters drawn on the model's device from a torch.Generator
        seeded with `seed`; on the meta device (the dry-run) parameters of
        the right shapes and dtypes, drawn from nothing and holding nothing."""
        meta = self.device.type == "meta"
        return self.make_params(self.cfg, generator=None if meta else self._generator(seed),
                                device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _ids(self, x: Any) -> torch.Tensor:
        """A batch entry (numpy or a tensor) on the model's device: ids,
        positions or the stubs' fp32 embeddings."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)


class DecoderModel(_LM):
    family = FAMILIES
    make_params = staticmethod(tfm.init_decoder)

    def _embeds_and_positions(self, params: tfm.Decoder, batch: dict
                              ) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor | None]:
        """(embeds or None, positions, tokens or None): for the VLM the
        patch embeddings before the text's embeddings and the batch's
        (B, 3, S) positions; otherwise the tokens and positions 0..S-1."""
        tokens = self._ids(batch["tokens"])
        if self.cfg.family == "vlm":
            cfg = self.cfg
            patches = self._ids(batch["patch_embeds"]).to(cfg.dtype)
            embeds = torch.cat([patches, params.embed.to(cfg.dtype)[tokens]], dim=1)
            return embeds, self._ids(batch["positions"]), None
        return None, _positions_for(*tokens.shape, self.device), tokens

    def loss_fn(self, params: tfm.Decoder, batch: dict) -> tuple[torch.Tensor, dict]:
        """(mean next-token loss + 0.01 * the layers' MoE aux loss, metrics
        with "ce", "tokens" and "aux"); differentiable, through the flash
        backward kernel on the card. The head takes HEAD_CHUNK rows at a
        time with grad or without (`tfm.head_loss`). A VLM batch's labels
        cover its patches too (-1 there, not counted)."""
        embeds, positions, tokens = self._embeds_and_positions(params, batch)
        h, _, aux = tfm.decoder_hidden(params, self.cfg, tokens, positions=positions,
                                       embeds=embeds)
        loss, metrics = tfm.head_loss(params, self.cfg, h, self._ids(batch["labels"]))
        metrics["aux"] = aux
        return loss + 0.01 * aux, metrics

    def init_cache(self, batch: int, max_len: int) -> dict:
        return tfm.init_decode_cache(self.cfg, batch, max_len, device=self.device)

    @torch.no_grad()
    def prefill_fn(self, params: tfm.Decoder, batch: dict, *, headroom: int = 64) -> dict:
        embeds, positions, tokens = self._embeds_and_positions(params, batch)
        b, s = positions.shape[0], positions.shape[-1]
        # headroom: decode steps append past the prompt; a cache sized
        # exactly S would clamp the first decode write onto slot S-1
        caches = self.init_cache(b, s + headroom)
        logits, caches, _ = tfm.decoder_forward(params, self.cfg, tokens, positions=positions,
                                                embeds=embeds, caches=caches)
        # a copy: the view logits[:, -1] would keep the whole (B, S, V) fp32
        # logits alive (8.4 GB for gemma2-2b at 4 x 2,048)
        return {"logits": logits[:, -1].clone(), "cache": caches}

    @torch.no_grad()
    def decode_fn(self, params: tfm.Decoder, cache: dict, batch: dict
                  ) -> tuple[dict, torch.Tensor]:
        """One token a row, written at the cache's index. The rotary
        positions are the cache's index too, except for the VLM, whose
        (B, 3, 1) M-RoPE positions come from batch["positions"]. The
        cache's K/V buffers are updated in place; use the returned cache
        from here on."""
        tokens = self._ids(batch["tokens"])                      # (B, 1)
        if self.cfg.family == "vlm":
            embeds = params.embed.to(self.cfg.dtype)[tokens]
            logits, cache, _ = tfm.decoder_forward(
                params, self.cfg, None, positions=self._ids(batch["positions"]),
                embeds=embeds, caches=cache)
            return cache, logits[:, -1]
        pos = _positions_for(tokens.shape[0], 1, self.device, offset=cache["pos"][0])
        logits, cache, _ = tfm.decoder_forward(params, self.cfg, tokens, positions=pos,
                                               caches=cache)
        return cache, logits[:, -1]


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper)
# ---------------------------------------------------------------------------
class EncDecModel(_LM):
    """Whisper's entry points, as `repro.models.api.EncDecModel`'s. The
    cache-free decoder of a long sequence runs the flash kernel twice a
    layer: its causal self-attention and its non-causal cross-attention
    over the encoder's frames (a ragged S_k of 1,500 at full width).
    Prefill and decode take the direct path, the cross-attention over the
    static K/V of `tfm.init_cross_cache`."""

    family = ("audio",)

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 max_dec_len: int = MAX_DEC_LEN):
        super().__init__(cfg, device)
        self.max_dec_len = max_dec_len
        self.make_params = functools.partial(tfm.init_encdec, max_dec_len=max_dec_len)

    def loss_fn(self, params: tfm.EncDec, batch: dict) -> tuple[torch.Tensor, dict]:
        """(mean next-token loss, metrics with "ce" and "tokens") of the
        encoder and the cache-free decoder; the head takes HEAD_CHUNK rows
        at a time (`tfm.head_loss`)."""
        enc = tfm.encoder_forward(params, self.cfg, self._ids(batch["frames"]))
        h, _ = tfm.encdec_hidden(params, self.cfg, self._ids(batch["tokens"]), enc)
        return tfm.head_loss(params, self.cfg, h, self._ids(batch["labels"]))

    def init_cache(self, batch: int, max_len: int) -> dict:
        """{"k", "v": (L, B, max_len, Hk, hd), "pos": (L,) int32, "ck", "cv":
        (L, B, encoder_seq, Hk, hd)}, zeros, as the JAX package lays it out."""
        cfg = self.cfg
        cache = tfm.init_decode_cache(cfg, batch, max_len, device=self.device)
        xshape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
        cache["ck"] = torch.zeros(xshape, dtype=cfg.dtype, device=self.device)
        cache["cv"] = torch.zeros(xshape, dtype=cfg.dtype, device=self.device)
        return cache

    @torch.no_grad()
    def prefill_fn(self, params: tfm.EncDec, batch: dict, *, headroom: int = 64) -> dict:
        """The frames through the encoder, every layer's cross-attention K/V
        of its output, then the prompt through the decoder from position
        0, writing the self-attention cache."""
        tokens = self._ids(batch["tokens"])
        b, s = tokens.shape
        enc = tfm.encoder_forward(params, self.cfg, self._ids(batch["frames"]))
        ck, cv = tfm.init_cross_cache(params, self.cfg, enc)
        caches = dict(tfm.init_decode_cache(self.cfg, b, s + headroom, device=self.device),
                      ck=ck, cv=cv)
        logits, caches = tfm.encdec_forward(params, self.cfg, tokens, enc, pos_offset=0,
                                            caches=caches)
        return {"logits": logits[:, -1].clone(), "cache": caches}

    @torch.no_grad()
    def decode_fn(self, params: tfm.EncDec, cache: dict, batch: dict
                  ) -> tuple[dict, torch.Tensor]:
        """One token a row at the cache's position; the self-attention
        cache is updated in place."""
        logits, cache = tfm.encdec_forward(params, self.cfg, self._ids(batch["tokens"]), None,
                                           pos_offset=cache["pos"][0], caches=cache)
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
    """The model of a config's family: DecoderModel (dense, moe, vlm),
    EncDecModel (audio), XLSTMModel (ssm) or ZambaModel (hybrid); any
    other family raises NotImplementedError, naming ROADMAP.md."""
    if cfg.family == "audio":
        return EncDecModel(cfg, device=device)
    if cfg.family == "ssm":
        return XLSTMModel(cfg, device=device)
    if cfg.family == "hybrid":
        return ZambaModel(cfg, device=device)
    return DecoderModel(cfg, device=device)


def params_from_numpy(tree: dict, cfg: ModelConfig, *,
                      device: str | torch.device = "cuda") -> torch.nn.Module:
    """A JAX model's parameter tree (numpy arrays, stacked layers on their
    leading axes) as the parameter module of `cfg.family`'s model on
    `device`: `Decoder` (dense, MoE and VLM; layers stacked (L, ...)),
    `EncDec` (audio; `enc_layers` and `dec_layers` stacked (L, ...), a
    `dec_pos` table of as many rows as the tree's), `XLSTM` (ssm; `mlstm`
    (G, n_m, ...), `slstm` (G, ...)) or `Zamba` (hybrid; `mamba` (G, n_per,
    ...), one unstacked `shared` block). What it refuses:
    `models/transformer.py::load_numpy`."""
    if cfg.family == "audio" and "dec_pos" in tree:
        model = EncDecModel(cfg, device=device, max_dec_len=int(np.shape(tree["dec_pos"])[0]))
    else:
        model = build_model(cfg, device=device)
    return tfm.load_numpy(model.make_params(cfg, generator=None, device=model.device), tree)


# ---------------------------------------------------------------------------
# Parameter counts, model FLOPs and input specs (the JAX package's)
# ---------------------------------------------------------------------------
def jax_leaf_shapes(params: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    """The JAX parameter tree's leaves, by the port's names with each layer
    index as "*" ("layers.*.moe.w_gate"), and their shapes: the stacked
    axes (one a layer index of the names: its count) before the per-layer
    shape, `param_leaf`'s layout."""
    lead: dict[str, list[int]] = {}
    shape: dict[str, tuple[int, ...]] = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        key = ".".join("*" if q.isdigit() else q for q in parts)
        idx = [int(q) for q in parts if q.isdigit()]
        lead[key] = [max(a, i + 1) for a, i in zip(lead.get(key, [0] * len(idx)), idx)]
        shape[key] = tuple(p.shape)
    return {key: tuple(lead[key]) + shape[key] for key in shape}


@functools.lru_cache(maxsize=None)
def count_params(cfg: ModelConfig) -> tuple[float, float]:
    """(total, active) parameter counts from the parameter shapes, built on
    the meta device (nothing allocated). Active: an MoE expert leaf (a leaf
    under "moe" with an axis of n_experts_pad) scaled by top-k / E_pad, so
    the pad experts, never routed to, count toward neither, as the JAX
    package's `count_params`."""
    params = build_model(cfg, device="meta").init()
    e_pad = cfg.n_experts_pad or cfg.n_experts
    total = active = 0.0
    for key, shape in jax_leaf_shapes(params).items():
        n = float(np.prod(shape))
        total += n
        if cfg.is_moe and "moe" in key and e_pad and e_pad in shape:
            active += n * (cfg.n_experts_active / e_pad)
        else:
            active += n
    return total, active


def tokens_per_step(shape: ShapeSpec) -> int:
    """Tokens a step takes: B S, or B for a decode step."""
    return shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)


def model_flops_per_step(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6 N_active tokens (train) or 2 N_active tokens (a forward), the JAX
    package's definition: the dense products of the parameters alone,
    attention's scores and P V left out."""
    _, active = count_params(cfg)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens_per_step(shape)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                device: str | torch.device = "meta") -> dict[str, torch.Tensor]:
    """Every model input of a cell as an empty tensor of the JAX package's
    shape and dtype (int32 ids and positions, fp32 stub embeddings), on the
    meta device by default: the counterpart of its ShapeDtypeStructs."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32

    def t(shp, dt):
        return torch.empty(shp, dtype=dt, device=device)

    if shape.kind == "decode":
        batch = {"tokens": t((b, 1), i32)}
        if cfg.family == "vlm":
            batch["positions"] = t((b, 3, 1), i32)
        return batch
    batch = {"tokens": t((b, s), i32)}
    if shape.kind == "train":
        batch["labels"] = t((b, s), i32)
    if cfg.family == "vlm":
        batch["tokens"] = t((b, s - cfg.n_patches), i32)
        batch["patch_embeds"] = t((b, cfg.n_patches, cfg.d_model), f32)
        batch["positions"] = t((b, 3, s), i32)
    if cfg.family == "audio":
        batch["frames"] = t((b, cfg.encoder_seq, cfg.d_model), f32)
    return batch
