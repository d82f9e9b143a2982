"""repro_torch.core — the port's copy of the paper's f64 numpy design flow
(spacing rule, three splitting algorithms, packed tables, the f32 /
quantized / polynomial / sharded pack layouts, entry quantization and the
design-space planner).

The JAX package's ``repro.core`` imports no JAX either, but the port imports
nothing of that package, so it keeps the modules it needs here.  The tests
hold both copies to identical arrays."""

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
from .flow import cached_table
from .packing import (PackLayout, PolyPackLayout, QuantPackLayout,
                      ShardedPackLayout, pack_layout, poly_pack_layout,
                      quant_pack_layout, shard_pack_layout)

__all__ = [
    "ALGORITHMS",
    "FunctionSpec",
    "PackLayout",
    "PolyPackLayout",
    "QuantPackLayout",
    "SecondDerivMax",
    "ShardedPackLayout",
    "SplitResult",
    "TableSpec",
    "binary_split",
    "build_table",
    "cached_table",
    "delta_for",
    "footprint",
    "function_names",
    "get_function",
    "hierarchical_split",
    "pack_layout",
    "poly_pack_layout",
    "quant_pack_layout",
    "reference_spacing",
    "sequential_split",
    "shard_pack_layout",
    "split",
]
