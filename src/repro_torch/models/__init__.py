"""repro_torch.models — the ported architectures (the dense and MoE decoder,
the Mamba2 hybrid and the xLSTM stack)."""

from .config import ArchConfig, ShapeSpec
from .registry import ARCH_IDS, build_model, get_config, reduced
from .transformer import BaseLM, DecoderLM, HybridLM, XLSTMLM, cross_entropy
