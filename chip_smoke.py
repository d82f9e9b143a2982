#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device: the card's name and ``nvidia-smi`` name / power limit;
2. build: every ``csrc/*.cu`` with nvcc for sm_90a (all started together),
   printing the build seconds and the ``-Xptxas -v`` register/shared lines;
3. kernels: each kernel against its plain PyTorch version on the card, BITWISE
   (NaN positions matched), for every pack member, extrapolation on and off,
   bf16 and f32, at the main path's shapes, a ragged size and edge inputs
   (every boundary and its neighbours, +-inf, NaN, -2e38, lo, +-0);
4. main path: full-width, full-depth stablelm-3b (random weights from seed 0)
   serving the launcher's default traffic (8 requests, batch 4, cache 256,
   16 new tokens) through ContinuousEngine in ``table_pack`` with TableFlash;
   both kernels must have launched, and the same queue served through the
   plain versions (``table_pack_ref``) must give identical tokens;
5. reference: a reduced stablelm in float32 on the card against the same
   model on the CPU (logits within 1e-4, identical greedy tokens);
6. times: each kernel, its plain version and the one PyTorch call computing
   the same function, at the main path's decode shape, by CUDA events around
   a CUDA graph of repeated calls (device time, no host launch cost).

The line before the last is one JSON object listing the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout of
the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MEM_BPS = 3.35e12  # H100 SXM HBM3, bytes/s
F32_OPS = 67e12  # H100 SXM f32 outside the tensor cores, op/s
BATCH, CACHE_LEN, N_REQ, MAX_NEW = 4, 256, 8, 16  # the launcher's defaults
TIMING_REPS = 100


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------------------
# 1-2. device and build
# --------------------------------------------------------------------------------------


def device_info():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    return name, smi_line


def build_kernels():
    from repro_torch.kernels import _build

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    log(f"build: {sources} in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for s in sources:
        for line in _build.build_log(s).splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas[{s}]: {line.strip()}")


# --------------------------------------------------------------------------------------
# 3. kernel vs plain, bitwise
# --------------------------------------------------------------------------------------


def _bits(t):
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def bitwise_diff(a, b):
    """(mismatches, max |a-b| over finite pairs) with NaN positions matched."""
    import torch

    both_nan = torch.isnan(a) & torch.isnan(b)
    bad = (_bits(a) != _bits(b)) & ~both_nan
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = (a.float() - b.float()).abs()[fin]
    return int(bad.sum()), float(err.max()) if err.numel() else 0.0


def edge_values(pack, fid):
    import numpy as np

    row = pack.boundaries[fid, : pack.n_intervals[fid] + 1].cpu().numpy()
    lo, _ = pack.domains[fid]
    up = np.nextafter(row, np.float32(np.inf))
    down = np.nextafter(row, np.float32(-np.inf))
    special = np.asarray([np.inf, -np.inf, np.nan, -2e38, 2e38, lo, 0.0, -0.0],
                         np.float32)
    return np.concatenate([row, up, down, special]).astype(np.float32)


def make_input(shape, lo, hi, edges, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, generator=g, device="cuda") * (hi - lo + 8.0) + (lo - 4.0)
    flat = x.view(-1)
    k = min(flat.numel(), edges.size)
    flat[:k] = torch.as_tensor(edges[:k], device="cuda")
    return x.to(dtype)


def kernel_phase(pack, s0):
    import torch

    from repro_torch.kernels import table_pack_lookup as K

    gate_shapes = [(BATCH, s0, 6912), (BATCH, 1, 6912), (12345,), (1,)]
    flash_shapes = [(BATCH, 1, 32, 1, CACHE_LEN), (BATCH, s0, 32, 1, s0),
                    (12345,), (1,)]
    worst = {"table_pack_lookup": 0.0, "tableflash_exp": 0.0}
    cases = 0
    for fid, name in enumerate(pack.names):
        lo, hi = pack.domains[fid]
        edges = edge_values(pack, fid)
        for dtype in (torch.bfloat16, torch.float32):
            for shape in gate_shapes:
                x = make_input(shape, lo, hi, edges, dtype, seed=fid)
                for ex in (False, True):
                    got = K.table_pack_lookup(pack, fid, x, extrapolate=ex)
                    want = K.table_pack_lookup_plain(pack, fid, x, extrapolate=ex)
                    torch.cuda.synchronize()
                    check(got.shape == x.shape and got.dtype == x.dtype,
                          f"pack {name} {shape}: shape/dtype")
                    bad, err = bitwise_diff(got, want)
                    check(bad == 0, f"table_pack_lookup {name} {dtype} {shape} "
                          f"extrapolate={ex}: {bad} mismatches (max err {err})")
                    worst["table_pack_lookup"] = max(worst["table_pack_lookup"], err)
                    cases += 1
            if name != "exp_neg":
                continue
            for shape in flash_shapes:
                x = make_input(shape, -40.0, 0.0, edges, dtype, seed=99)
                got = K.tableflash_exp(pack, x)
                want = K.tableflash_exp_plain(pack, x)
                torch.cuda.synchronize()
                bad, err = bitwise_diff(got, want)
                check(bad == 0, f"tableflash_exp {dtype} {shape}: {bad} "
                      f"mismatches (max err {err})")
                check(bool((got[x < lo] == 0).all()), "tableflash zero tail")
                worst["tableflash_exp"] = max(worst["tableflash_exp"], err)
                cases += 1
    log(f"kernels: {cases} kernel-vs-plain cases bitwise equal "
        f"(members {pack.names}, bf16+f32, extrapolate on/off, edges)")
    return worst


# --------------------------------------------------------------------------------------
# 4-5. main path and reference
# --------------------------------------------------------------------------------------


def main_path(smi_line):
    import torch

    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model, get_config
    from repro_torch.serving.engine import ContinuousEngine

    base = get_config("stablelm-3b")
    cfg = base.replace(approx=dataclasses.replace(
        base.approx, mode="table_pack", attn_table=True))
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"main: {cfg.name} {cfg.n_layers}L d={cfg.d_model} {cfg.n_heads}H x "
        f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab} (padded "
        f"{cfg.vocab_pad}), {cfg.param_count() / 1e9:.2f}B params "
        f"{cfg.param_dtype}, init {time.perf_counter() - t0:.1f}s")
    reqs = make_requests(cfg.vocab, N_REQ, MAX_NEW)

    engine = ContinuousEngine(model, params, BATCH, CACHE_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    out = engine.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(K.launches)
    tokens = sum(r.steps for r in out)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"main: served {len(out)} requests, {tokens} tokens in {dt:.3f}s = "
        f"{tokens / dt:.1f} tok/s, peak memory {peak:.2f} GiB, "
        f"{engine.prefills} prefills, {engine.batch_steps} rounds "
        f"[{smi_line}]")
    log(f"main: kernel launches {counts}")
    for k, n in counts.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    check(all(r.steps == MAX_NEW for r in out), "every request gets its budget")

    ref_cfg = cfg.replace(approx=dataclasses.replace(cfg.approx,
                                                     mode="table_pack_ref"))
    ref_model = build_model(ref_cfg, "cuda")
    K.reset_launches()
    ref_out = ContinuousEngine(ref_model, params, BATCH, CACHE_LEN).serve(reqs)
    check(all(v == 0 for v in K.launches.values()), "table_pack_ref launched a kernel")
    for i, (a, b) in enumerate(zip(out, ref_out)):
        check((a.tokens == b.tokens).all(), f"request {i}: kernel tokens "
              f"{a.tokens.tolist()} != plain {b.tokens.tolist()}")

    s0 = max(len(r.prompt) for r in reqs)
    rows = torch.zeros((BATCH, s0), dtype=torch.int64, device="cuda")
    for j, r in enumerate(reqs[:BATCH]):
        rows[j, s0 - len(r.prompt):] = torch.as_tensor(r.prompt, device="cuda")
    with torch.inference_mode():
        lk, ck = model.prefill(params, {"tokens": rows}, model.init_cache(BATCH, CACHE_LEN))
        lr, cr = ref_model.prefill(params, {"tokens": rows},
                                   ref_model.init_cache(BATCH, CACHE_LEN))
        tok = torch.argmax(lk, -1)[:, None]
        pos = torch.full((BATCH,), s0, dtype=torch.int32, device="cuda")
        dk, _ = model.decode_step(params, tok, pos, ck)
        dr, _ = ref_model.decode_step(params, tok, pos, cr)
    check(lk.shape == (BATCH, cfg.vocab_pad) and bool(torch.isfinite(lk[:, :cfg.vocab]).all()),
          "prefill logits finite, (B, vocab_pad)")
    diff = max(float((lk - lr).abs().max()), float((dk - dr).abs().max()))
    log(f"main: {len(out)} requests token-identical to table_pack_ref (plain "
        f"versions on the card); max |logit diff| prefill+decode = {diff}")
    exact = build_model(cfg.replace(approx=dataclasses.replace(cfg.approx,
                                                               mode="exact")), "cuda")
    step_breakdown({"table_pack": model, "table_pack_ref": ref_model, "exact": exact},
                   params, rows, ck, smi_line)
    del params, engine
    torch.cuda.empty_cache()
    return counts


def _mean_ms(fn, reps):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def step_breakdown(models, params, rows, cache, smi_line):
    """Host-clock ms of one prefill (B, S0) and one decode step (B, cache 256)
    per approx mode, in two alternating rounds after a warm-up; then a
    profiler view of the table_pack decode step: device busy share of the
    wall time and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pos = torch.full((rows.shape[0],), rows.shape[1], dtype=torch.int32,
                     device="cuda")
    tok = rows[:, -1:]
    step_ms = {}
    with torch.inference_mode():
        for rnd in range(2):
            order = list(models.items()) if rnd == 0 else list(models.items())[::-1]
            for mode, m in order:
                fresh = m.init_cache(rows.shape[0], CACHE_LEN)
                _mean_ms(lambda: m.decode_step(params, tok, pos, cache), 2)
                dec = _mean_ms(lambda: m.decode_step(params, tok, pos, cache), 10)
                pre = _mean_ms(lambda: m.prefill(params, {"tokens": rows}, fresh), 3)
                step_ms[mode] = dec
                log(f"step: round {rnd} {mode}: decode {dec:.3f} ms, prefill "
                    f"(S0={rows.shape[1]}) {pre:.3f} ms [{smi_line}]")
        m = models["table_pack"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                m.decode_step(params, tok, pos, cache)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # kernel rows only: an operator row repeats the device time of its kernels
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in evs)
    if not evs:
        log("profile: no device time in key_averages(): not measured")
        return
    busy_ms = busy_us / 5e3
    log(f"profile: table_pack decode x5: wall {wall_us / 5e3:.3f} ms/step under the "
        f"profiler, device busy {busy_ms:.3f} ms/step; idle share "
        f"{1 - busy_ms / step_ms['table_pack']:.3f} of the unprofiled "
        f"{step_ms['table_pack']:.3f} ms step")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile:   {e.self_device_time_total / 5e3:8.3f} ms/step "
            f"{e.count // 5:5d} calls/step  {e.key[:90]}")


def reference_check():
    """Reduced stablelm in f32: the card against the CPU (plain versions)."""
    import torch

    from repro_torch.approx import ApproxConfig
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model, reduced
    from repro_torch.serving.engine import ContinuousEngine

    cfg = reduced("stablelm-3b").replace(
        compute_dtype="float32",
        approx=ApproxConfig(mode="table_pack", e_a=1e-4, omega=0.2, attn_table=True))
    cpu_model = build_model(cfg, "cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    gpu_model = build_model(cfg, "cuda")

    def to_cuda(t):
        if isinstance(t, dict):
            return {k: to_cuda(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cuda(v) for v in t]
        return t.to("cuda")

    gpu_params = to_cuda(cpu_params)
    reqs = make_requests(cfg.vocab, 6, 8, seed=3)
    s0 = max(len(r.prompt) for r in reqs)
    rows = torch.zeros((2, s0), dtype=torch.int64)
    for j, r in enumerate(reqs[:2]):
        rows[j, s0 - len(r.prompt):] = torch.as_tensor(r.prompt)
    with torch.inference_mode():
        lc, _ = cpu_model.prefill(cpu_params, {"tokens": rows}, cpu_model.init_cache(2, 64))
        lg, _ = gpu_model.prefill(gpu_params, {"tokens": rows.cuda()},
                                  gpu_model.init_cache(2, 64))
    err = float((lc - lg.cpu()).abs()[:, :cfg.vocab].max())
    check(err <= 1e-4, f"reduced f32 logits card vs CPU: {err} > 1e-4")
    a = ContinuousEngine(cpu_model, cpu_params, 2, 64).serve(reqs)
    b = ContinuousEngine(gpu_model, gpu_params, 2, 64).serve(reqs)
    for i, (x, y) in enumerate(zip(a, b)):
        check((x.tokens == y.tokens).all(), f"reduced request {i}: card tokens "
              f"differ from CPU")
    log(f"reference: reduced stablelm f32 table_pack+TableFlash, card vs CPU: "
        f"max |logit diff| {err:.3e} (<= 1e-4), {len(a)} requests token-identical")


# --------------------------------------------------------------------------------------
# 6. times
# --------------------------------------------------------------------------------------


def graph_ms(fn, reps=TIMING_REPS):
    """Device ms per call: CUDA events around one replay of a CUDA graph that
    holds ``reps`` calls (warmed up first, so no build or allocation inside)."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(5):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()  # warm replay
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pack_bytes(pack):
    return 4 * (pack.boundaries.numel() + pack.inv_delta.numel() + pack.base.numel()
                + pack.seg_count.numel() + pack.values.numel())


def bound(n, elem_bytes, pack, ops_per_elem):
    """(bound_ms, bound_by): bytes N*(in+out) + the pack read once at the
    memory rate, against N*ops f32 operations at the f32 rate."""
    t_bytes = (n * 2 * elem_bytes + pack_bytes(pack)) / MEM_BPS * 1e3
    t_ops = n * ops_per_elem / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing_phase(pack, smi_line):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import table_pack_lookup as K

    g = torch.Generator(device="cuda").manual_seed(7)
    silu = pack.fn_id("silu")
    # per element: n_max compares + ~14 address/lerp operations (+2 for the tail)
    ops = pack.n_max + 14
    gate = (torch.randn((BATCH, 1, 6912), generator=g, device="cuda") * 2).to(torch.bfloat16)
    z = -30.0 * torch.rand((BATCH, 1, 32, 1, CACHE_LEN), generator=g, device="cuda")
    rows = {}
    for name, x, elem, kern, plain, lib, extra_ops in (
        ("table_pack_lookup", gate, 2,
         lambda: K.table_pack_lookup(pack, silu, gate, extrapolate=True),
         lambda: K.table_pack_lookup_plain(pack, silu, gate, extrapolate=True),
         lambda: F.silu(gate), 0),
        ("tableflash_exp", z, 4,
         lambda: K.tableflash_exp(pack, z),
         lambda: K.tableflash_exp_plain(pack, z),
         lambda: torch.exp(z), 2),
    ):
        ms, plain_ms, lib_ms = graph_ms(kern), graph_ms(plain), graph_ms(lib)
        b_ms, b_by = bound(x.numel(), elem, pack, ops + extra_ops)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by)
        log(f"time: {name} {tuple(x.shape)} {x.dtype}: kernel {ms * 1e3:.2f} us, "
            f"plain {plain_ms * 1e3:.2f} us, library {lib_ms * 1e3:.2f} us, "
            f"bound {b_ms * 1e3:.3f} us ({b_by}) [{smi_line}]")
    return rows


# --------------------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        name, smi_line = device_info()
        build_kernels()
        from repro_torch.launch.serve import make_requests
        from repro_torch.models import get_config

        cfg = get_config("stablelm-3b")
        # the pack stablelm-3b's own approx settings build (e_a 1e-4, omega 0.2)
        pack = dataclasses.replace(cfg.approx, mode="table_pack").pack("cuda")
        s0 = max(len(r.prompt) for r in make_requests(cfg.vocab, N_REQ, MAX_NEW))
        log(f"pack: {pack.names}, {pack.footprint} f32 entries, n_max {pack.n_max}, "
            f"intervals {pack.n_intervals}; main-path prefill width S0={s0}")
        worst = kernel_phase(pack, s0)
        counts = main_path(smi_line)
        reference_check()
        times = timing_phase(pack, smi_line)
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for kname, line in (("table_pack_lookup", 43), ("tableflash_exp", 188)):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/csrc/table_pack_lookup.cu",
            "replaces": f"src/repro/kernels/table_pack_lookup.py:{line}",
            "launches": counts[kname], "max_abs_err": worst[kname],
            **times[kname]})
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
