"""The LMs, ported from `repro/models/`: the decoders (the dense configs, the
MoE and the VLM), whisper's encoder-decoder, the xLSTM and the Zamba2
hybrid.

  layers.py       ModelConfig, norms, RoPE and M-RoPE, attention (direct
                  path and the flash kernel; causal, non-causal and cross),
                  MLP, MoE (sort-based capacity dispatch)
  transformer.py  decoder layer and stack, whisper's encoder and
                  cross-decoder, decode and cross caches, cross-entropy,
                  load_numpy (a JAX parameter tree into the port's module)
  ssm.py          xLSTM: chunked and sequential mLSTM, causal conv, sLSTM
  mamba.py        Mamba2: chunked SSD scan and its recurrent step
  zamba.py        the hybrid: Mamba2 groups and one shared attention block
  api.py          ShapeSpec, LM_SHAPES, DecoderModel, EncDecModel,
                  XLSTMModel, ZambaModel (init, loss_fn, prefill_fn, decode_fn),
                  build_model, params_from_numpy; shape_by_name,
                  supported_shapes, count_params, model_flops_per_step,
                  input_specs (the dry-run's)
"""
from repro_torch.models.api import (
    LM_SHAPES,
    DecoderModel,
    EncDecModel,
    ShapeSpec,
    XLSTMModel,
    ZambaModel,
    build_model,
    count_params,
    input_specs,
    model_flops_per_step,
    params_from_numpy,
    shape_by_name,
    supported_shapes,
)
from repro_torch.models.layers import ModelConfig

__all__ = ["LM_SHAPES", "DecoderModel", "EncDecModel", "ModelConfig", "ShapeSpec",
           "XLSTMModel", "ZambaModel", "build_model", "count_params", "input_specs",
           "model_flops_per_step", "params_from_numpy", "shape_by_name", "supported_shapes"]
