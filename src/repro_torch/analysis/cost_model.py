"""Analytic per-cell cost model: FLOPs, HBM bytes and collective bytes a
device — the JAX package's ``benchmarks/cost_model.py`` in the port's own
modules.  Its terms are arithmetic on the configuration, so they equal the
reference's term for term (tests/test_torch_dryrun.py).

WHY ANALYTIC.  The reference's compiled cost counts a scanned body once, so
it itemizes the step instead.  The port's dry run (``launch.dryrun``) counts
every operator of an eager step, so its ``flops_per_device`` is a whole-step
cross-check of ``flops_dev`` here; its MemTracker peak, not this model, is
the fits-check.

Conventions and assumptions (stated once, applied uniformly):
  * matmul flops = 2*m*n*k; backward = 2x forward; per-layer remat adds 1x
    forward recompute => train = 4x forward matmul flops (vs the classic
    6*N*D = 3x forward; the 4/3 shows up in the useful-FLOPs ratio).
  * attention context: causal global layers average (S-1)/2 keys; local
    layers min(W, (S-1)/2) (+ ring-buffer decode reads min(pos, W) keys).
  * flash attention reads K/V once per layer traversal and never writes the
    score matrix: the port's flash runs q blocks of 512 against K/V chunks of
    1024 with an online softmax, so the scores stay one chunk wide.  (As
    plain PyTorch ops it does write each chunk's scores; that traffic is not
    in this model.)
  * params are stored f32 and cast per traversal (3 reads in train: fwd,
    remat, bwd); the port casts per use as well (``linear``'s
    ``p["w"].to(x.dtype)``, the ``bfloat16_copy`` of PERF.md §5).  AdamW
    state f32 (m, v read+write); grads f32 write+read.
  * padding/capacity waste (attention head padding h_eff/h_log, MoE capacity
    factor, vocab padding) multiplies the relevant flops terms — this is
    what makes the useful-FLOPs ratio informative.
  * collectives (per device):
      - fwd/bwd activation all-reduces: row-parallel output projections
        (attention out, MLP down, MoE combine) all-reduce (B,S,d) bf16 per
        layer per traversal;
      - gradient all-reduce: ring over the data (x pod) axis of the
        model-sharded grad shard: ~2 * 4B * N / model_shards;
      - MoE dispatch: all-to-all of dispatch+combine slot buffers;
      - decode: per-layer all-reduces only (the cache is head-sharded).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ArchConfig, ShapeSpec

BF16 = 2
F32 = 4


@dataclass
class Costs:
    flops_dev: float
    hbm_bytes_dev: float
    coll_bytes_dev: float
    ideal_flops_dev: float  # useful-work floor (6/2 * N_active * tokens)
    ideal_bytes_dev: float  # decode floor: params + cache read once
    notes: str = ""

    def as_dict(self):
        return {
            "flops_dev": self.flops_dev,
            "hbm_bytes_dev": self.hbm_bytes_dev,
            "coll_bytes_dev": self.coll_bytes_dev,
            "ideal_flops_dev": self.ideal_flops_dev,
            "ideal_bytes_dev": self.ideal_bytes_dev,
        }


def _avg_ctx(S: int, window: int) -> float:
    half = (S - 1) / 2
    return min(window, half) if window > 0 else half


def _attn_flops_fwd(cfg: ArchConfig, tok: float, S: int) -> float:
    """Projections + scores/AV for the whole stack, padding waste included."""
    g = cfg.attn_geom
    d, Dh = cfg.d_model, cfg.head_dim
    period = max(1, cfg.attn.global_every)
    n_glob = cfg.n_layers // period
    n_loc = cfg.n_layers - n_glob
    proj = 2 * tok * d * (g.h_eff * Dh) + 2 * 2 * tok * d * (g.g_log * Dh) \
        + 2 * tok * (g.h_eff * Dh) * d
    heads_eff = g.g_eff * g.q_per_group
    sc_glob = 4 * tok * _avg_ctx(S, 0) * heads_eff * Dh
    sc_loc = 4 * tok * _avg_ctx(S, 1024) * heads_eff * Dh
    return cfg.n_layers * proj + n_glob * sc_glob + n_loc * sc_loc


def _ffn_flops_fwd(cfg: ArchConfig, tok: float) -> float:
    d = cfg.d_model
    if cfg.family == "moe":
        slots = tok * cfg.moe.top_k * cfg.moe.capacity_factor
        routed = 2 * slots * d * cfg.d_ff * 3
        shared = 2 * tok * d * (cfg.moe.n_shared * cfg.d_ff) * 3
        router = 2 * tok * d * cfg.moe.n_experts
        return cfg.n_layers * (routed + shared + router)
    mats = 3 if cfg.mlp_kind == "glu" else 2
    return cfg.n_layers * 2 * tok * d * cfg.d_ff * mats


def _ssm_flops_fwd(cfg: ArchConfig, tok: float) -> float:
    s = cfg.ssm
    d = cfg.d_model
    inner = s.expand * d
    H, P, N, L = inner // s.head_dim, s.head_dim, s.state_dim, s.chunk
    proj = 2 * tok * d * (2 * inner + 2 * N + H) + 2 * tok * inner * d
    conv = 2 * tok * (inner + 2 * N) * s.conv_width
    core = tok * H * (2 * L * (N + P) + 6 * N * P)
    return proj + conv + core


def _xlstm_flops_fwd(cfg: ArchConfig, tok: float) -> float:
    d = cfg.d_model
    H = cfg.n_heads
    D = d // H
    L = 128
    n_m = n_s = cfg.n_layers // 2
    m_proj = 2 * tok * d * d * 5 + 2 * tok * d * 2 * H
    m_core = tok * H * (4 * L * D + 8 * D * D)
    s_mats = 2 * tok * d * d * 8
    return n_m * (m_proj + m_core) + n_s * s_mats


def _unembed_flops_fwd(cfg: ArchConfig, tok: float) -> float:
    return 2 * tok * cfg.d_model * cfg.vocab_pad


def forward_flops(cfg: ArchConfig, tok: float, S: int) -> float:
    if cfg.family == "xlstm":
        core = _xlstm_flops_fwd(cfg, tok)
    elif cfg.family == "hybrid":
        # n_layers Mamba2 blocks + one shared attn+GLU block applied every k layers
        n_shared = (cfg.n_layers // cfg.shared_attn_every
                    if cfg.shared_attn_every else 0)
        core = cfg.n_layers * _ssm_per_layer(cfg, tok)
        one_attn_layer = cfg.replace(n_layers=1)
        core += n_shared * (_attn_flops_fwd(one_attn_layer, tok, S)
                            + 2 * tok * cfg.d_model * cfg.d_ff * 3)
    elif cfg.family == "encdec":
        enc_tok = tok / S * cfg.enc_len
        enc_cfg = cfg.replace(n_layers=cfg.n_enc_layers)
        core = (_attn_flops_fwd(enc_cfg, enc_tok, cfg.enc_len)
                + _ffn_flops_fwd(enc_cfg, enc_tok))
        dec_self = _attn_flops_fwd(cfg, tok, S)
        # cross attention: q over enc_len keys + kv proj of memory per layer
        g = cfg.attn_geom
        dec_cross = cfg.n_layers * (
            4 * tok * cfg.enc_len * g.g_eff * g.q_per_group * cfg.head_dim
            + 2 * tok * cfg.d_model * (g.h_eff * cfg.head_dim)
            + 2 * 2 * enc_tok * cfg.d_model * (g.g_log * cfg.head_dim))
        core += dec_self + dec_cross + _ffn_flops_fwd(cfg, tok)
    else:  # dense / moe / vlm
        core = _attn_flops_fwd(cfg, tok, S) + _ffn_flops_fwd(cfg, tok)
    return core + _unembed_flops_fwd(cfg, tok)


def _ssm_per_layer(cfg: ArchConfig, tok: float) -> float:
    return _ssm_flops_fwd(cfg, tok)


def decode_attn_read_bytes(cfg: ArchConfig, B_dev: float, pos: int) -> float:
    """KV-cache bytes read for ONE decode step (ring windows cap local layers)."""
    g = cfg.attn_geom
    Dh = cfg.head_dim
    period = max(1, cfg.attn.global_every)
    n_glob = cfg.n_layers // period
    n_loc = cfg.n_layers - n_glob
    glob = n_glob * min(pos, pos) * g.g_eff * Dh * 2 * BF16
    loc = n_loc * min(pos, 1024) * g.g_eff * Dh * 2 * BF16
    if cfg.family == "hybrid":
        n_shared = (cfg.n_layers // cfg.shared_attn_every
                    if cfg.shared_attn_every else 0)
        glob = n_shared * pos * g.g_eff * Dh * 2 * BF16
        loc = 0
        # ssm state read/write
        s = cfg.ssm
        inner = s.expand * cfg.d_model
        glob += cfg.n_layers * (inner // s.head_dim) * s.head_dim * s.state_dim \
            * F32 * 2
    if cfg.family == "xlstm":
        d = cfg.d_model
        D = d // cfg.n_heads
        glob = (cfg.n_layers // 2) * cfg.n_heads * D * D * F32 * 2
        loc = 0
    if cfg.family == "encdec":
        glob = cfg.n_layers * pos * g.g_eff * Dh * 2 * BF16
        glob += cfg.n_layers * cfg.enc_len * g.g_eff * Dh * 2 * BF16  # cross kv
        loc = 0
    return B_dev * (glob + loc)  # per device (batch-sharded)


def moe_a2a_bytes(cfg: ArchConfig, B_dev: float, S: int, variant: str = "base") -> float:
    """The reference's ``a2a_v``: one MoE layer's dispatch (or combine) bytes
    a device and traversal, every slot of its B_dev x S tokens at the
    capacity factor, bf16; ``limit4`` (device-limited routing with dedup
    transport) one row a (token, destination), at most 4 destinations."""
    if variant == "limit4":
        return B_dev * S * 4 * cfg.d_model * BF16
    return B_dev * S * cfg.moe.top_k * cfg.moe.capacity_factor * cfg.d_model * BF16


def cell_costs(cfg: ArchConfig, shape: ShapeSpec, n_chips: int = 256,
               data_shards: int = 16, model_shards: int = 16,
               pods: int = 1, variant: str = "base") -> Costs:
    """Collective accounting is TRANSIT bytes per chip on the bottleneck link:
    all-reduce of result V => 2V;  all-gather receiving V / reduce-scatter of V
    => V;  all-to-all sending V => V.

    Variants:
      base   -- TP=16 (+FSDP second-dim sharding of >32MB/dev leaves, which adds
                the weight all-gather term), ZeRO-1 moments.
      fsdp   -- ZeRO-3 over the flat mesh: no TP psums, params gathered per use
                (3 traversals), grads reduce-scattered; batch over all chips.
      cf10   -- MoE capacity factor 1.0 (vs 1.25).
      accumN -- N gradient-accumulation microbatches (activation memory / N; no
                change to per-step flops; collective bytes unchanged).
    """
    if variant in ("cf10", "limit4") and cfg.family == "moe":
        import dataclasses

        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    N = cfg.param_count()
    N_act = cfg.active_param_count()
    dsize = data_shards * pods
    full = n_chips
    fsdp = variant in ("fsdp", "ddp")
    B_dev = (B / full if fsdp and B % full == 0 else
             B / dsize if B % dsize == 0 else B)
    n_layers_eff = cfg.n_layers + (cfg.n_enc_layers or 0)
    # 'base' leaves bigger than 32MB/dev after TP get a second data-axis shard
    big_model = N * F32 / model_shards > 8e9

    if shape.kind == "train":
        tok = float(B * S)
        fwd = forward_flops(cfg, tok, S)
        flops_global = 4.0 * fwd  # fwd + remat + 2x bwd
        flops_dev = flops_global / n_chips
        ideal_flops_dev = 6.0 * N_act * tok / n_chips

        N_dev = N / (full if (fsdp and variant != "ddp") or big_model
                     else (1 if variant == "ddp" else model_shards))
        param_traffic = 40.0 * (N / full if variant == "ddp" else N_dev)
        if variant == "ddp":
            param_traffic += 3 * N * BF16  # replicated reads (bf16 cast)
        if big_model and not fsdp:
            param_traffic += 3 * N / model_shards * BF16  # gathered copies
        if fsdp and variant != "ddp":
            param_traffic += 3 * N * BF16  # gathered copies traverse HBM
        act_per_layer = B_dev * S * d * BF16
        act_traffic = n_layers_eff * act_per_layer * 10
        if cfg.family == "moe":
            slots = B_dev * S * cfg.moe.top_k * cfg.moe.capacity_factor
            act_traffic += cfg.n_layers * slots * d * BF16 * 6
        logits = B_dev * S * cfg.vocab_pad / (1 if fsdp else model_shards) * F32 * 2
        hbm = param_traffic + act_traffic + logits

        if variant == "ddp":
            # replicated params: one bf16 grad all-reduce (2V transit)
            coll = 2 * N * BF16
        elif fsdp:
            # 3x param all-gather (fwd, remat, bwd) + grad reduce-scatter
            coll = 3 * N * BF16 + N * F32
        else:
            psum = n_layers_eff * 2 * 3 * (B_dev * S * d * BF16) * 2  # AR = 2V
            grad_ar = 2.0 * F32 * N / model_shards
            weight_ag = 3 * N * BF16 / model_shards if big_model else 0.0
            coll = psum + grad_ar + weight_ag
            if cfg.family == "moe":
                a2a_v = moe_a2a_bytes(cfg, B_dev, S, variant)
                coll += cfg.n_layers * 2 * 3 * a2a_v  # dispatch+combine x3 trav
        if pods > 1:
            coll *= 1.0 + 1.0 / 8  # hierarchical cross-pod reduction surcharge
        return Costs(flops_dev, hbm, coll, ideal_flops_dev, ideal_bytes_dev=0.0)

    if shape.kind == "prefill":
        tok = float(B * S)
        fwd = forward_flops(cfg, tok, S)
        flops_dev = fwd / n_chips
        ideal_flops_dev = 2.0 * N_act * tok / n_chips
        N_dev = N / (full if (fsdp or big_model) else model_shards)
        act = n_layers_eff * B_dev * S * d * BF16 * 4
        kv_write = decode_attn_read_bytes(cfg, B_dev, S)
        hbm = N_dev * F32 + act + kv_write
        if big_model and not fsdp:
            hbm += N * BF16 / model_shards
        coll = n_layers_eff * 2 * (B_dev * S * d * BF16) * 2
        if big_model and not fsdp:
            coll += N * BF16 / model_shards
        if cfg.family == "moe":
            coll += cfg.n_layers * 2 * moe_a2a_bytes(cfg, B_dev, S)
        return Costs(flops_dev, hbm, coll, ideal_flops_dev, 0.0)

    # decode: one token against a cache of length S
    tok = float(B)
    fwd = forward_flops(cfg, tok, 1)
    attn_read = decode_attn_read_bytes(cfg, B_dev, S)
    flops_attn = attn_read / BF16 * 2
    flops_dev = (fwd / n_chips) + flops_attn
    N_dev = N / model_shards
    hbm = N_dev * F32 + attn_read + B_dev * 1 * d * BF16 * n_layers_eff * 4
    coll = n_layers_eff * 2 * (B_dev * 1 * d * BF16) * 2
    if cfg.family == "moe":
        coll += cfg.n_layers * 2 * moe_a2a_bytes(cfg, B_dev, 1)
    ideal_flops_dev = 2.0 * N_act * tok / n_chips
    ideal_bytes_dev = N_dev * BF16 + attn_read
    return Costs(flops_dev, hbm, coll, ideal_flops_dev, ideal_bytes_dev)
