"""repro_torch.core — the port's copy of the paper's contribution: interval-split
table-based function approximation (spacing rule, three splitting algorithms,
packed tables, resource models, design flow), with the f32 / quantized /
polynomial / sharded pack layouts, entry quantization and the design-space
planner.

The JAX package's ``repro.core`` imports no JAX either, but the port imports
nothing of that package, so it keeps the modules it needs here.  The tests
hold both copies to identical arrays.  The resource models are the paper's
BRAM18 counts and, in place of the reference's TPU VMEM residency, the
kernels' shared-memory staging images (``smem_cost`` for a table,
``smem_cost_pack`` and the layouts' ``smem()`` for a pack)."""

from .functions import FunctionSpec, get as get_function, names as function_names
from .spacing import SecondDerivMax, delta_for, footprint, reference_spacing
from .splitting import (
    ALGORITHMS,
    SplitResult,
    binary_split,
    hierarchical_split,
    sequential_split,
    split,
)
from .table import TableSpec, build_table
from .flow import FlowReport, cached_table, run_flow
from .bram import (SmemCost, SmemPackCost, bram_count, bram_count_packed, smem_cost,
                   smem_cost_pack)
from .packing import (
    PackLayout,
    PolyPackLayout,
    QuantPackLayout,
    ShardedPackLayout,
    pack_layout,
    poly_pack_layout,
    quant_pack_layout,
    shard_pack_layout,
)
from .design import (
    DesignCandidate,
    PackPlan,
    PolyMember,
    build_poly_member,
    deriv_probe,
    enumerate_candidates,
    interp_error_const,
    pareto_front,
    plan,
    poly_cell_width,
    poly_member,
)
from .quantize import (
    FixedPointFormat,
    PAPER_FORMATS,
    QUANT_INT_BITS,
    QuantMember,
    chord_residual_ranges,
    plan_quant_member,
    quantize_spec,
    refine_for_quantization,
)
from .stats import TTestResult, outperforms, t_cdf, ttest2

__all__ = [
    "ALGORITHMS",
    "DesignCandidate",
    "FixedPointFormat",
    "FlowReport",
    "FunctionSpec",
    "PackLayout",
    "PackPlan",
    "PAPER_FORMATS",
    "PolyMember",
    "PolyPackLayout",
    "QUANT_INT_BITS",
    "QuantMember",
    "QuantPackLayout",
    "SecondDerivMax",
    "ShardedPackLayout",
    "SmemCost",
    "SmemPackCost",
    "SplitResult",
    "TTestResult",
    "TableSpec",
    "binary_split",
    "bram_count",
    "bram_count_packed",
    "build_poly_member",
    "build_table",
    "cached_table",
    "chord_residual_ranges",
    "delta_for",
    "deriv_probe",
    "enumerate_candidates",
    "footprint",
    "function_names",
    "get_function",
    "hierarchical_split",
    "interp_error_const",
    "outperforms",
    "pack_layout",
    "pareto_front",
    "plan",
    "plan_quant_member",
    "poly_cell_width",
    "poly_member",
    "poly_pack_layout",
    "quant_pack_layout",
    "quantize_spec",
    "refine_for_quantization",
    "reference_spacing",
    "run_flow",
    "sequential_split",
    "shard_pack_layout",
    "smem_cost",
    "smem_cost_pack",
    "split",
    "t_cdf",
    "ttest2",
]
