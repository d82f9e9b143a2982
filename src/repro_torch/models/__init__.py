"""repro_torch.models — the ported architectures: the dense and MoE decoder,
the Mamba2 hybrid, the xLSTM stack, the encoder-decoder and the vision-prefix
model (all ten of the JAX package's ids)."""

from .config import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
                     ArchConfig, ShapeSpec, shapes_for)
from .registry import ARCH_IDS, build_model, get_config, input_specs, reduced
from .transformer import VLM, BaseLM, DecoderLM, EncDecLM, HybridLM, XLSTMLM, cross_entropy
