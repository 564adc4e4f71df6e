"""The dense decoder LM (gemma2-2b), ported from `repro/models/`.

  layers.py       ModelConfig, norms, RoPE, attention (direct path and the
                  flash kernel), MLP
  transformer.py  decoder layer and stack, decode caches, cross-entropy,
                  params_from_numpy (a JAX parameter tree as the port's)
  api.py          ShapeSpec, LM_SHAPES, DecoderModel (init, loss_fn,
                  prefill_fn, decode_fn), build_model
"""
from repro_torch.models.api import LM_SHAPES, DecoderModel, ShapeSpec, build_model
from repro_torch.models.layers import ModelConfig
from repro_torch.models.transformer import params_from_numpy

__all__ = ["LM_SHAPES", "DecoderModel", "ModelConfig", "ShapeSpec", "build_model",
           "params_from_numpy"]
