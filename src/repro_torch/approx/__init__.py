"""repro_torch.approx — the paper's table approximators as PyTorch runtimes:
per-function tables, the f32 multi-function pack, and the ``ApproxConfig``
backend that routes a model's nonlinearities through them."""

from .activations import (
    DEFAULT_PACK_FUNCTIONS,
    NOT_PORTED,
    PACK_MODES,
    TABLE_MODES,
    ApproxConfig,
    odd_extension,
)
from .table_pack import (
    TablePack,
    build_pack,
    eval_pack_ref,
    eval_pack_slope,
    from_layout,
    make_attn_exp_fn,
    make_pack_fn,
    member_domain,
    pack_specs,
)
from .torch_table import (
    TorchTable,
    eval_table_ref,
    eval_table_slope,
    from_spec,
    make_table_fn,
    select_interval,
)
