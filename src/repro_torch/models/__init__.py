"""repro_torch.models — the ported architectures (the dense and MoE decoder)."""

from .config import ArchConfig, ShapeSpec
from .registry import ARCH_IDS, build_model, get_config, reduced
from .transformer import DecoderLM, cross_entropy
