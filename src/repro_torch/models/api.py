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
(`launch/dryrun.py`), which builds a model on the meta device. So are the
sharding rules (`param_pspecs`, `train_state_pspecs`, `batch_axes_for`,
`input_pspecs`, `cache_pspecs`): a spec is a tuple with one entry a
tensor dim, an axis name, a tuple of names or None, as a JAX PartitionSpec
lists them, and `placements` turns one into a DeviceMesh's DTensor
placements.

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
import math
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.device import resolve_device
from repro_torch.models import ssm as xl
from repro_torch.models import transformer as tfm
from repro_torch.models import zamba as zb
from repro_torch.models import layers as ly
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


def _positions_like(tokens: torch.Tensor, device: torch.device, offset: Any = 0
                    ) -> torch.Tensor:
    """The positions offset .. offset + S - 1 of (B, S) tokens, placed as
    the tokens under a mesh (each rank's slice of them)."""
    if isinstance(offset, ly.DTensor):
        offset = offset.to_local()
    pos = _positions_for(*tokens.shape, device, offset=offset)
    return ly.shard_like(pos.contiguous(), tokens) if ly.in_region(tokens) else pos


def _cache_rows(t: int, batch: int) -> int:
    """Cache rows for t positions of `batch` rows: under a mesh a multiple of
    the axes that shard the cache's sequence (`cache_pspecs`: "model", or
    ("data", "model") where no batch axis divides the batch), so that it
    shards over them."""
    mesh = ly.get_active_mesh()
    if mesh is None:
        return t
    axes = mesh_axes(mesh)
    seq = ("model",) if batch_axes_for(axes, batch) else ("data", "model")
    m = math.prod(axes.get(a, 1) for a in seq)
    return -(-t // m) * m


def _last_row(logits: torch.Tensor) -> torch.Tensor:
    """A copy of logits[:, -1]; under a mesh, the sequence's last row from
    the rank that holds it, summed over the sequence axis (one row moves,
    not the logits)."""
    if not ly.in_region(logits):
        return logits[:, -1].clone()

    def fn(_, x):
        sh = ly.seq_shard()
        row = x[:, -1].clone()
        if not sh.seq or sh.size == 1:
            return row
        if sh.index != sh.size - 1:
            row = torch.zeros_like(row)
        return ly.all_reduce_axes(row, (ly.SEQ_AXIS,))

    pl = tuple(ly.Replicate() if q == ly.Shard(1) else q for q in logits.placements)
    return ly.region(fn, None, (logits,), pl)


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

    def init_cache(self, batch: int, max_len: int = 0) -> Any:
        """The family's decode cache (`empty_cache`: zeros), placed by
        `cache_pspecs` under an active mesh."""
        return _placed(self.cfg, self.empty_cache, batch, max_len, self.device)

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
            patches = self._ids(batch["patch_embeds"])
            positions = self._ids(batch["positions"])
            if ly.in_region(tokens):
                embeds = _vlm_embeds_sharded(params, cfg, patches, tokens, positions)
            else:
                embeds = torch.cat([patches.to(cfg.dtype), params.embed.to(cfg.dtype)[tokens]],
                                   dim=1)
            return embeds, positions, None
        return None, _positions_like(tokens, self.device), tokens

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

    def empty_cache(self, batch: int, max_len: int, device: Any = None) -> dict:
        return tfm.init_decode_cache(self.cfg, batch, max_len, device=device or self.device)

    @torch.no_grad()
    def prefill_fn(self, params: tfm.Decoder, batch: dict, *, headroom: int = 64) -> dict:
        embeds, positions, tokens = self._embeds_and_positions(params, batch)
        b, s = positions.shape[0], positions.shape[-1]
        # headroom: decode steps append past the prompt; a cache sized
        # exactly S would clamp the first decode write onto slot S-1
        caches = self.init_cache(b, _cache_rows(s + headroom, b))
        logits, caches, _ = tfm.decoder_forward(params, self.cfg, tokens, positions=positions,
                                                embeds=embeds, caches=caches)
        # a copy: the view logits[:, -1] would keep the whole (B, S, V) fp32
        # logits alive (8.4 GB for gemma2-2b at 4 x 2,048)
        return {"logits": _last_row(logits), "cache": caches}

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
            positions = self._ids(batch["positions"])
            if ly.in_region(tokens):
                embeds = ly.region(functools.partial(tfm._embed_tokens, cfg=self.cfg), None,
                                   (tokens,), tuple(tokens.placements), whole=(params.embed,))
            else:
                embeds = params.embed.to(self.cfg.dtype)[tokens]
            logits, cache, _ = tfm.decoder_forward(
                params, self.cfg, None, positions=positions, embeds=embeds, caches=cache)
            return cache, logits[:, -1]
        pos = _positions_like(tokens, self.device, offset=cache["pos"][0])
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

    def empty_cache(self, batch: int, max_len: int, device: Any = None) -> dict:
        """{"k", "v": (L, B, max_len, Hk, hd), "pos": (L,) int32, "ck", "cv":
        (L, B, encoder_seq, Hk, hd)}, zeros, as the JAX package lays it out."""
        cfg, device = self.cfg, device or self.device
        cache = tfm.init_decode_cache(cfg, batch, max_len, device=device)
        xshape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
        cache["ck"] = torch.zeros(xshape, dtype=cfg.dtype, device=device)
        cache["cv"] = torch.zeros(xshape, dtype=cfg.dtype, device=device)
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
        rows = _cache_rows(s + headroom, b)
        def self_cache(batch_: int, rows_: int, device: Any) -> dict:
            return tfm.init_decode_cache(self.cfg, batch_, rows_, device=device)

        caches = dict(_placed(self.cfg, self_cache, b, rows, self.device), ck=ck, cv=cv)
        logits, caches = tfm.encdec_forward(params, self.cfg, tokens, enc, pos_offset=0,
                                            caches=caches)
        return {"logits": _last_row(logits), "cache": _as_cache(self.cfg, caches, b)}

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

    def empty_cache(self, batch: int, max_len: int = 0, device: Any = None) -> dict:
        return xl.xlstm_init_states(self.cfg, batch, device=device or self.device)

    @torch.no_grad()
    def prefill_fn(self, params: xl.XLSTM, batch: dict) -> dict:
        """The prompt through the forward from zero states: the chunked
        mLSTM and the sLSTM scan, whose final states are the cache."""
        tokens = self._ids(batch["tokens"])
        b = tokens.shape[0]
        states = self.init_cache(b)
        logits, states = xl.xlstm_forward(params, self.cfg, tokens, states, prefill=True)
        return {"logits": _last_row(logits), "cache": _as_cache(self.cfg, states, b)}

    @torch.no_grad()
    def decode_fn(self, params: xl.XLSTM, cache: dict, batch: dict
                  ) -> tuple[dict, torch.Tensor]:
        """One token a row; the states are updated in place. Under a mesh
        the tokens come placed by `input_pspecs` and the states by
        `cache_pspecs` (`prefill_fn`'s are)."""
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
                                     positions=_positions_like(tokens, self.device))
        return tfm.cross_entropy(logits, self._ids(batch["labels"]))

    def empty_cache(self, batch: int, max_len: int, device: Any = None) -> dict:
        return zb.zamba_init_states(self.cfg, batch, max_len, device=device or self.device)

    @torch.no_grad()
    def prefill_fn(self, params: zb.Zamba, batch: dict, *, headroom: int = 64) -> dict:
        tokens = self._ids(batch["tokens"])
        b, s = tokens.shape
        states = self.init_cache(b, _cache_rows(s + headroom, b))
        logits, states = zb.zamba_forward(params, self.cfg, tokens,
                                          positions=_positions_like(tokens, self.device),
                                          states=states, prefill=True)
        return {"logits": _last_row(logits), "cache": _as_cache(self.cfg, states, b)}

    @torch.no_grad()
    def decode_fn(self, params: zb.Zamba, cache: dict, batch: dict
                  ) -> tuple[dict, torch.Tensor]:
        """One token a row at the first group's position; the caches and
        states are updated in place. Under a mesh the tokens come placed
        by `input_pspecs` and the cache by `cache_pspecs` (`prefill_fn`'s
        is), and the positions are placed as the tokens."""
        tokens = self._ids(batch["tokens"])
        pos = _positions_like(tokens, self.device, offset=cache["attn_pos"][0])
        logits, cache = zb.zamba_forward(params, self.cfg, tokens, positions=pos,
                                         states=cache)
        return cache, logits[:, -1]


def _placed(cfg: ModelConfig, empty: Any, batch: int, max_len: int,
            device: torch.device) -> Any:
    """The cache that `empty(batch, max_len, device)` makes, placed by
    `cache_pspecs` under an active mesh: each rank allocates only its
    shards, filled as the whole cache's entries are (every leaf of a cache
    is one value: zeros, or the sLSTM's stabilizer); `empty` itself
    without a mesh."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.launch.cost import uncounted

    mesh = ly.get_active_mesh()
    if mesh is None:
        return empty(batch, max_len, device)
    specs = cache_pspecs(cfg, ShapeSpec("cache", max_len, batch, "decode"), mesh)
    with uncounted():
        shapes = empty(batch, max_len, torch.device("meta"))
    fills = empty(1, 1, torch.device("cpu"))

    def leaf(t, fill, spec):
        value = fill.reshape(-1)[:1]
        if not bool((fill == value).all()):
            raise ValueError("a cache leaf that is not one value cannot be made shard by shard")
        pl = ly.spec_placements(spec, mesh)
        shape, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        local = torch.full(shape, value.item(), dtype=t.dtype, device=device)
        return ly.DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                     stride=t.stride())

    def walk(tree, fill, spec):
        if isinstance(tree, dict):
            return {key: walk(tree[key], fill[key], spec[key]) for key in tree}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(*x) for x in zip(tree, fill, spec))
        return leaf(tree, fill, spec)

    return walk(shapes, fills, specs)


def _as_cache(cfg: ModelConfig, cache: Any, batch: int) -> Any:
    """A prefill's cache of `batch` rows with the leaves that its regions
    left placed as the tokens (the recurrent states: batch over the batch
    axes) redistributed to `cache_pspecs`' placements, where a decode step
    takes them; the cache itself without a mesh. The K/V caches, written
    in place, are placed so already (a cache's length changes none of
    their placements' axes: `_cache_rows` makes it divide them)."""
    mesh = ly.get_active_mesh()
    if mesh is None:
        return cache
    specs = cache_pspecs(cfg, ShapeSpec("cache", 0, batch, "decode"), mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {key: walk(tree[key], spec[key]) for key in tree}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(*x) for x in zip(tree, spec))
        want = ly.spec_placements(spec, mesh)
        return tree if tuple(tree.placements) == want else tree.redistribute(mesh, want)

    return walk(cache, specs)


def _vlm_embeds_sharded(params: tfm.Decoder, cfg: ModelConfig, patches: torch.Tensor,
                        tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The VLM's (B, S, D) embeddings under a mesh, placed as its positions'
    sequence: the patches and the text's embeddings joined on each rank
    (the text gathered over the sequence axis), then the rank's slice."""
    seq_sharded = positions.placements  # (B, 3, S): the sequence is dim 2
    out = tuple(ly.Shard(1) if q == ly.Shard(2) else q for q in seq_sharded)

    def fn(_, toks, pt, embed):
        sh = ly.seq_shard()
        if any(q == ly.Shard(1) for q in tokens.placements):
            toks = ly.gather_axes(toks, 1, (ly.SEQ_AXIS,))
        full = torch.cat([pt.to(cfg.dtype), embed.to(cfg.dtype)[toks]], dim=1)
        seq = any(q == ly.Shard(2) for q in seq_sharded)
        return ly.seq_chunk(full, 1) if seq and sh.size > 1 else full

    return ly.region(fn, None, (tokens, patches), out, whole=(params.embed,))


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


# ---------------------------------------------------------------------------
# Sharding rules (FSDP + expert parallelism), the JAX package's
# ---------------------------------------------------------------------------
#: the JAX leaves stacked on one and on two leading axes (the port's
#: parameters are per layer: the integer parts of a name index those axes)
STACKED1 = ("layers", "enc_layers", "dec_layers", "slstm")
STACKED2 = ("mlstm", "mamba")

Spec = tuple   # one entry a dim: an axis name, a tuple of names, or None


def mesh_axes(mesh: Any) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of such a dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def stacked_axes(name: str) -> int:
    """The stacked axes of the JAX leaf of the port's parameter `name`
    (JAX's STACKED rule on its path): the integer parts of the name."""
    path = "/".join(q for q in name.split(".") if not q.isdigit())
    if any(k in path for k in STACKED2) and "shared" not in path:
        return 2
    return 1 if any(k in path for k in STACKED1) else 0


def _param_spec(name: str, shape: tuple[int, ...], axes: dict[str, int],
                fsdp_pod: bool) -> Spec:
    """`repro.models.api.param_pspecs`'s rule on the leaf's body dims, which
    are the port tensor's own: vectors replicate; an MoE expert tensor's
    expert dim shards over "model"; the largest remaining dim that the FSDP
    extent divides shards over it ("data", or ("pod", "data") with
    `fsdp_pod` on a mesh with a pod axis), else, with both FSDP axes, the
    largest that "data" divides over "data"."""
    if stacked_axes(name) != sum(q.isdigit() for q in name.split(".")):
        raise ValueError(f"{name}: its stacked axes and its layer indices disagree")
    dsize, msize = axes.get("data", 1), axes.get("model", 1)
    fsdp = ("pod", "data") if fsdp_pod and "pod" in axes else ("data",)
    fsdp_size = int(np.prod([axes[a] for a in fsdp if a in axes]))
    names: list = [None] * len(shape)
    body = list(range(len(shape)))
    if len(body) < 2:
        return tuple(names)
    if "moe" in name.split(".") and len(body) == 3 and msize > 1 and shape[0] % msize == 0:
        names[0] = "model"
        body = body[1:]
    for i in sorted(body, key=lambda i: -shape[i]):
        if shape[i] % fsdp_size == 0 and fsdp_size > 1:
            names[i] = fsdp if len(fsdp) > 1 else fsdp[0]
            break
        if len(fsdp) > 1 and shape[i] % dsize == 0 and dsize > 1:
            names[i] = "data"
            break
    return tuple(names)


def param_pspecs(cfg: ModelConfig, params: torch.nn.Module | dict, mesh: Any
                 ) -> dict[str, Spec]:
    """{parameter name: spec} (`_param_spec`) of a parameter module or of a
    {name: tensor} dict (an AdamW moment)."""
    axes = mesh_axes(mesh)
    named = params.named_parameters() if isinstance(params, torch.nn.Module) \
        else params.items()
    return {n: _param_spec(n, tuple(t.shape), axes, cfg.fsdp_pod) for n, t in named}


def train_state_pspecs(cfg: ModelConfig, state: Any, mesh: Any) -> Any:
    """The train state's specs, as the state (`launch/train.py::TrainState`):
    the AdamW moments shard as their parameters, the steps replicate."""
    from repro_torch.optim import AdamWState

    return type(state)(
        params=param_pspecs(cfg, state.params, mesh),
        opt=AdamWState(m=param_pspecs(cfg, state.opt.m, mesh),
                       v=param_pspecs(cfg, state.opt.v, mesh), step=()),
        step=())


def batch_axes_for(mesh: Any, batch: int) -> tuple[str, ...]:
    """The largest prefix of (pod, data) whose product divides the batch."""
    axes = mesh_axes(mesh)
    use, div = [], 1
    for a in ("pod", "data"):
        if axes.get(a, 1) > 1 and batch % (div * axes[a]) == 0:
            use.append(a)
            div *= axes[a]
    return tuple(use)


def input_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh: Any) -> dict[str, Spec]:
    """Each input's spec: batch over `batch_axes_for`, a train or prefill
    sequence over "model" where "model" divides it (the frames' too)."""
    axes = mesh_axes(mesh)
    baxes = batch_axes_for(axes, shape.global_batch)
    bspec = baxes if baxes else None
    msize = axes.get("model", 1)

    def seq_spec(n):
        return "model" if shape.kind != "decode" and n % msize == 0 else None

    out: dict[str, Spec] = {}
    for name, t in input_specs(cfg, shape).items():
        if name in ("tokens", "labels"):
            seq = None if t.shape[-1] == 1 or shape.kind == "decode" else seq_spec(t.shape[-1])
            out[name] = (bspec, seq)
        elif name == "patch_embeds":
            out[name] = (bspec, None, None)
        elif name == "positions":
            out[name] = (bspec, None, seq_spec(t.shape[-1]) if t.shape[-1] > 1 else None)
        elif name == "frames":
            out[name] = (bspec, seq_spec(t.shape[1]), None)
    return out


def cache_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh: Any) -> dict:
    """The decode cache's specs, as the cache (`init_cache` on the meta
    device): a K/V cache (L or G, B, S, Hk, hd) shards its batch over
    `batch_axes_for` and its sequence over "model" (over ("data", "model")
    when no batch axis divides the batch: one long sequence); positions
    replicate; a recurrent state shards its first dim after the leading
    one that "model" divides (its heads)."""
    axes = mesh_axes(mesh)
    baxes = batch_axes_for(axes, shape.global_batch)
    bspec = baxes if baxes else None
    seq_axes = ("model",) if baxes else tuple(a for a in ("data", "model") if a in axes)
    seq = seq_axes if len(seq_axes) > 1 else seq_axes[0]
    msize = axes.get("model", 1)
    from repro_torch.launch.cost import uncounted

    with uncounted():
        cache = build_model(cfg, device="meta").empty_cache(shape.global_batch, shape.seq_len)

    def divisible(n, ax) -> bool:
        ax = (ax,) if isinstance(ax, str) else ax
        return n % int(np.prod([axes.get(a, 1) for a in ax])) == 0

    def spec_for(key: str, t: torch.Tensor) -> Spec:
        names: list = [None] * t.dim()
        if key in ("k", "v", "ck", "cv", "attn_k", "attn_v"):
            names[1] = bspec
            names[2] = seq if divisible(t.shape[2], seq) else None
        elif key not in ("pos", "attn_pos"):
            for i, d in enumerate(t.shape):
                if i >= 1 and d % msize == 0 and d >= msize and msize > 1:
                    names[i] = "model"
                    break
        return tuple(names)

    def walk(tree: Any, key: str) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, str(i)) for i, v in enumerate(tree))
        return spec_for(key, tree)

    return walk(cache, "")


def placements(spec: Spec, mesh: Any) -> tuple:
    """A spec as the DTensor placements of `mesh` (a DeviceMesh): each mesh
    axis a dim's entry names shards that dim (Shard), in the entry's order
    of names where it lists several (JAX's major-to-minor order), and every
    other mesh axis replicates."""
    out = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)
