"""Serving launcher of the port: batched prefill+decode over a synthetic
request queue, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
      --reduced --device cpu --approx-mode table_pack --attn-table

The flags are the JAX launcher's (``repro.launch.serve``), ``--pack-shards``
and the sharded modes included (off the mesh: the shards are summed on one
device), plus ``--device``.  ``--scheduler continuous`` (default) serves
through the ContinuousEngine; ``--scheduler static`` keeps the fixed-group
baseline.  ``--trace PATH`` writes a Perfetto-loadable Chrome trace of the
run with the engine's metrics and the global counters in its metadata
(validate it with ``tools/check_trace.py``, render it with
``tools/torch_obs_report.py``); ``--obs`` also builds the model with the
device telemetry on (out-of-domain clamps, quant saturation, routed
dispatch, counted on the device with no host sync) and prints the metric
summary as JSON.  Throughput is reported wall-clock and steady-state (the
one-time CUDA kernel build excluded).  Weights are random, drawn from seed
0, and so is the traffic, as in the JAX launcher.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.approx import TABLE_MODES
from repro_torch.device import resolve_device
from repro_torch.models import build_model, get_config, reduced
from repro_torch.serving.engine import (ContinuousEngine, DecodeEngine, Request,
                                        serve_static)


def make_requests(vocab: int, n: int, max_new: int, seed: int = 0):
    """The launcher's default traffic: ``n`` prompts of 4..31 random tokens."""
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, (int(m),)).astype(np.int32),
                    max_new_tokens=max_new)
            for m in rng.integers(4, 32, n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "static"],
                    help="continuous = admission queue + mid-stream slot "
                         "refill; static = fixed request groups")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--approx-mode", choices=["exact", *TABLE_MODES],
                    default=None,
                    help="nonlinearity backend; table_pack = one fused "
                         "multi-function pack + CUDA kernels for the whole "
                         "network, table_pallas = per-function tables through "
                         "the CUDA table kernels, quant_pack = the pack with "
                         "int8/int16 codes dequantized on read, poly_pack = "
                         "the planner's degree-1..3 pack (see --pack-budget), "
                         "routed_* = the same packs with dynamic per-row "
                         "fn_id dispatch (one kernel for every member), "
                         "sharded_pack = the f32 pack's values cut into "
                         "--pack-shards slices, each shard's masked "
                         "contribution summed on one device, "
                         "folded_* = full-range sin/cos/exp/log by range "
                         "reduction over the f32 pack, "
                         "*_ref = their plain PyTorch versions")
    ap.add_argument("--approx-ea", type=float, default=None,
                    help="override the config's error budget E_a")
    ap.add_argument("--pack-shards", type=int, default=None,
                    help="sharded_pack modes: split the pack values this many "
                         "ways (sub-interval granularity, per-shard base "
                         "rebasing; the shards are summed on one device)")
    ap.add_argument("--pack-budget", type=int, default=None,
                    help="poly_pack modes: total-bytes budget for the design-"
                         "space planner (greedy member downgrade until the "
                         "pack fits; an infeasible budget is an error; default "
                         "takes each function's cheapest candidate)")
    ap.add_argument("--rope-table", action="store_true",
                    help="serve RoPE's sin/cos from the pack's folded trig "
                         "members (any table mode)")
    ap.add_argument("--attn-table", action="store_true",
                    help="TableFlash: serve flash attention's softmax exponent"
                         " from the pack's exp_neg member (any table mode)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the run (open in "
                         "Perfetto; validate with tools/check_trace.py)")
    ap.add_argument("--obs", action="store_true",
                    help="enable device-side approximation telemetry "
                         "(out-of-domain clamps, quant saturation, routed "
                         "dispatch) and print the metric summary")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # host-side spans are always on for the launcher (they never touch the
    # device computation), so throughput can exclude the kernel build; device
    # telemetry only with --obs, and only then is the model built with
    # instrumented activation closures
    obs.configure(enabled=True, device_telemetry=args.obs, trace_path=args.trace)
    obs.reset_tracer()

    cfg = reduced(args.arch) if args.reduced else get_config(args.arch)
    kw = {}
    if args.approx_mode is not None:
        kw["mode"] = args.approx_mode
    if args.approx_ea is not None:
        kw["e_a"] = args.approx_ea
    if args.pack_shards is not None:
        kw["pack_shards"] = args.pack_shards
    if args.pack_budget is not None:
        kw["pack_budget"] = args.pack_budget
    if args.rope_table:
        kw["rope_table"] = True
    if args.attn_table:
        kw["attn_table"] = True
    if kw:
        cfg = cfg.replace(approx=dataclasses.replace(cfg.approx, **kw))
    model = build_model(cfg, device)
    if model.extra_inputs:
        ap.error(f"{args.arch}'s prefill needs {list(model.extra_inputs)} besides "
                 "the prompt tokens, which this launcher's synthetic traffic does "
                 "not carry: serve it through DecodeEngine.generate_batch(..., "
                 "extra_inputs=...)")
    params = model.init(torch.Generator(device=device).manual_seed(0))

    reqs = make_requests(cfg.vocab, args.requests, args.max_new)
    if args.scheduler == "continuous":
        engine = ContinuousEngine(model, params, args.batch, args.cache_len,
                                  temperature=args.temperature)
        t0 = time.time()
        results = engine.serve(reqs)
    else:
        engine = DecodeEngine(model, params, args.batch, args.cache_len,
                              temperature=args.temperature)
        t0 = time.time()
        results = serve_static(model, params, reqs, batch_size=args.batch,
                               cache_len=args.cache_len, engine=engine)
    dt = time.time() - t0
    total_new = sum(r.steps for r in results)  # per-request trimmed counts
    steady = max(dt - engine.compile_time_s, 1e-9)
    print(f"served {len(results)} requests, {total_new} tokens on {device} "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s wall, "
          f"{total_new / steady:.1f} tok/s steady after "
          f"{engine.compile_time_s:.2f}s kernel build, {args.scheduler}); "
          f"{engine.batch_steps} batch rounds, wasted slot-step fraction "
          f"{engine.wasted_fraction:.2f}")
    for i, r in enumerate(results[:4]):
        print(f"  req{i}: prompt_len={r.prompt_len} steps={r.steps} "
              f"-> {r.tokens[:8].tolist()}...")
    if args.obs:
        print(json.dumps({"metrics": obs.get_registry().summary(),
                          "engine_metrics": engine.metrics.summary()},
                         indent=1, default=str))
    if args.trace:
        summary = {"requests": len(results), "tokens": total_new,
                   "wall_s": dt, "compile_time_s": engine.compile_time_s,
                   "tok_s_wall": total_new / dt,
                   "tok_s_steady": total_new / steady,
                   "scheduler": args.scheduler, "device": str(device)}
        obs.get_tracer().save(args.trace, metadata={
            "summary": summary,
            "metrics": {
                # the engine's latency histograms and the global (device
                # telemetry) counters, merged for the report CLI
                "histograms": engine.metrics.summary()["histograms"],
                "counters": obs.get_registry().summary()["counters"],
            }})
        print(f"trace written to {args.trace}")
    return results


if __name__ == "__main__":
    main()
