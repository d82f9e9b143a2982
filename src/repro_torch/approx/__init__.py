"""repro_torch.approx — the paper's table approximators as PyTorch runtimes:
per-function tables, the f32, quantized and polynomial multi-function packs
(each also per-row routed), RangeFold's full-range sin/cos/exp/log over the
f32 pack, and the ``ApproxConfig`` backend that routes a model's
nonlinearities through them."""

from .activations import (
    DEFAULT_PACK_FUNCTIONS,
    NOT_PORTED,
    PACK_MODES,
    POLY_PACK_MODES,
    QUANT_PACK_MODES,
    ROUTED_MODES,
    TABLE_MODES,
    ApproxConfig,
    odd_extension,
)
from .range_fold import (
    FOLDABLE,
    FOLDED_CORE_MEMBERS,
    FOLDED_MODES,
    eval_folded_ref,
    eval_folded_routed,
    eval_folded_slope,
    make_folded_fn,
    make_folded_routed_unary_fn,
)
from .table_pack import (
    PolyTablePack,
    QuantTablePack,
    TablePack,
    build_pack,
    build_poly_pack,
    build_quant_pack,
    eval_pack_ref,
    eval_pack_slope,
    eval_poly_pack_ref,
    eval_poly_pack_slope,
    eval_quant_pack_ref,
    eval_quant_pack_slope,
    eval_routed_poly_ref,
    eval_routed_poly_slope,
    eval_routed_quant_ref,
    eval_routed_quant_slope,
    eval_routed_ref,
    eval_routed_slope,
    from_layout,
    from_poly_layout,
    from_quant_layout,
    make_attn_exp_fn,
    make_pack_fn,
    make_poly_pack_fn,
    make_quant_pack_fn,
    make_routed_fn,
    make_routed_unary_fn,
    member_domain,
    pack_specs,
    resolve_fn_ids,
    routed_extr_flags,
)
from .torch_table import (
    TorchTable,
    eval_table_ref,
    eval_table_slope,
    from_spec,
    make_table_fn,
    select_interval,
)
