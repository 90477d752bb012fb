"""The models in PyTorch: parameters, layers, the MoE layer, the Mamba and
xLSTM blocks, the decoders and the encoder-decoder, and the registry, with
decode over the First-Fit paged KV cache."""

from .encdec import EncDecLM
from .params import Spec, abstract_params, init_params, params_from_numpy, tree_bytes
from .registry import build_model, cache_specs, input_specs, make_batch
from .transformer import DecoderLM, pad_vocab

__all__ = ["Spec", "abstract_params", "init_params", "params_from_numpy", "tree_bytes",
           "build_model", "cache_specs", "input_specs", "make_batch", "DecoderLM",
           "EncDecLM", "pad_vocab"]
