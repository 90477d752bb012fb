"""The decoders (dense and MoE) in PyTorch: parameters, layers, the MoE
layer, the model and its registry, with decode over the First-Fit paged KV
cache."""

from .params import Spec, init_params, params_from_numpy
from .registry import build_model
from .transformer import DecoderLM, pad_vocab

__all__ = ["Spec", "init_params", "params_from_numpy", "build_model",
           "DecoderLM", "pad_vocab"]
