"""The models in PyTorch: parameters, layers, the MoE layer, the Mamba and
xLSTM blocks, the decoders and the encoder-decoder, and the registry, with
decode over the First-Fit paged KV cache."""

from .encdec import EncDecLM
from .params import Spec, init_params, params_from_numpy
from .registry import build_model, make_batch
from .transformer import DecoderLM, pad_vocab

__all__ = ["Spec", "init_params", "params_from_numpy", "build_model", "make_batch",
           "DecoderLM", "EncDecLM", "pad_vocab"]
