"""Batched serving example of the PyTorch/CUDA port: prefill + decode over a
request queue with the KV cache on the card, table-backend activations, and a
throughput report (``examples/serve_decode.py`` through ``repro_torch``).

Run on the card (the kernels are built on first use):
    PYTHONPATH=src python examples/serve_decode_torch.py --requests 6 --max-new 12
and on the CPU, where every kernel wrapper runs its plain PyTorch version:
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu

``--scheduler continuous`` (the default) serves the queue through the
ContinuousEngine: freed slots are refilled mid-stream from the admission
queue, so decode batches stay full; ``--scheduler static`` is the
fixed-group baseline.  Throughput counts only the tokens each request
actually kept (per-request EOS/budget trimming), and the wasted-slot-step
fraction shows what the scheduler left on the table.

``--obs`` builds the model with the device telemetry on (out-of-domain
clamps, quant saturation, routed dispatch, counted on the device) and prints
the metric summary; ``--trace PATH`` writes a Chrome trace of the serve
(render it with ``tools/torch_obs_report.py``).

``--routed-demo`` instead demonstrates RoutedPack: a different activation per
expert slot evaluated in ONE call (dynamic fn_id dispatch: the routing is a
device operand, so re-routing the slots reuses the same kernel).
"""

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.approx import TABLE_MODES, ApproxConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import _lib
from repro_torch.models import build_model, get_config
from repro_torch.models.common import routed_activation
from repro_torch.serving.engine import (ContinuousEngine, DecodeEngine, Request,
                                        serve_static)

MODES = ["exact", *TABLE_MODES]


def routed_demo(mode: str, dev: torch.device, n_slots: int = 6, d: int = 256) -> None:
    """Different activation per expert slot, one dispatch, one kernel."""
    cfg = ApproxConfig(mode=mode, e_a=1e-4, omega=0.2)
    slots = tuple(("gelu", "silu", "tanh", "sigmoid", "softplus", "exp")[i % 6]
                  for i in range(n_slots))
    f = routed_activation(cfg, slots, dev)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 2, (n_slots, d))
                         .astype(np.float32)).to(dev)
    _lib.reset_launches()
    y = f(x)
    launched = {k: v for k, v in _lib.launches.items() if v}
    # parity: each slot must match its own static single-function dispatch
    worst = 0.0
    for i, name in enumerate(slots):
        ys = cfg.unary(name, dev)(x[i])
        worst = max(worst, float((y[i] - ys).abs().max()))
    print(f"mode={mode} on {dev}: routed {n_slots} slots x {d} features "
          f"({','.join(slots)}) in one call (launches {launched}); "
          f"max |routed - static| = {worst:g}")
    if worst != 0.0:
        raise SystemExit("routed dispatch must match static dispatch bitwise")
    print("routed_demo OK")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--mode", default="table_ref", choices=MODES)
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "static"],
                    help="continuous = admission queue + mid-stream slot "
                         "refill (full decode batches); static = fixed-group "
                         "baseline")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--attn-table", action="store_true",
                    help="TableFlash: serve flash attention's softmax exponent"
                         " from the pack's exp_neg member (table modes only)")
    ap.add_argument("--routed-demo", action="store_true",
                    help="run the per-slot routed-activation demo and exit")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a ScopeKit Chrome-trace JSON of the serve "
                         "(open in Perfetto)")
    ap.add_argument("--obs", action="store_true",
                    help="enable device-side approximation telemetry and "
                         "print the metric summary")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.routed_demo:
        routed_demo(args.mode, dev)
        return

    obs.configure(enabled=True, device_telemetry=args.obs, trace_path=args.trace)
    obs.reset_tracer()

    cfg = get_config("gemma3-12b").replace(
        n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, d_head=32, d_ff=256,
        vocab=1024, remat=False,
        approx=ApproxConfig(mode=args.mode, e_a=1e-4, omega=0.2,
                            attn_table=args.attn_table),
    )  # a local:global sliding-window model end to end
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    rng = np.random.default_rng(0)
    # staggered budgets: short and long requests mixed, so the static
    # scheduler visibly wastes decode steps that the continuous one refills
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32),
                    max_new_tokens=args.max_new if i % 2 == 0
                    else max(1, args.max_new // 4))
            for i, n in enumerate(rng.integers(5, 24, args.requests))]

    if args.scheduler == "continuous":
        engine = ContinuousEngine(model, params, args.batch, cache_len=128,
                                  temperature=args.temperature)
        t0 = time.time()
        results = engine.serve(reqs)
    else:
        engine = DecodeEngine(model, params, args.batch, cache_len=128,
                              temperature=args.temperature)
        t0 = time.time()
        results = serve_static(model, params, reqs, batch_size=args.batch,
                               cache_len=128, engine=engine)
    dt = time.time() - t0
    # throughput over tokens each request actually generated (Result.steps ==
    # len(tokens), trimmed at that request's own EOS/budget)
    total = sum(r.steps for r in results)
    steady = max(dt - engine.compile_time_s, 1e-9)
    print(f"mode={args.mode}/{args.scheduler} on {dev}: served {len(results)} "
          f"requests / {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s wall, "
          f"{total / steady:.1f} tok/s steady after {engine.compile_time_s:.2f}s "
          f"kernel build); {engine.batch_steps} batch rounds, wasted slot-step "
          f"fraction {engine.wasted_fraction:.2f}; builds "
          f"{engine.compile_counts()}")
    for i, r in enumerate(results[:3]):
        print(f"  req{i}: prompt={r.prompt_len} toks -> {r.tokens.tolist()}")
    if args.obs:
        print(json.dumps({"metrics": obs.get_registry().summary(),
                          "engine_metrics": engine.metrics.summary()},
                         indent=1, default=str))
    if args.trace:
        obs.get_tracer().save(args.trace, metadata={
            "metrics": {
                "histograms": engine.metrics.summary()["histograms"],
                "counters": obs.get_registry().summary()["counters"],
            }})
        print(f"trace written to {args.trace}")
    print("serve_decode OK")


if __name__ == "__main__":
    main()
