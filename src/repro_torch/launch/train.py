"""Training launcher of the port, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --reduced --device cpu --steps 4 --batch 4 --seq 16 --accum 2 \\
      --approx-mode table_pack

The flags are the JAX launcher's (``repro.launch.train``) for every approx
mode (``--pack-budget``, ``--pack-shards`` and ``--rope-table`` included),
plus ``--device``.  ``--mesh debug|prod|multipod`` trains over a
``DeviceMesh`` (weight-update sharding and ZeRO-1; ``train.loop``): start one
process a rank with ``torchrun``, e.g. 4 ranks on the CPU,

  PYTHONPATH=src torchrun --standalone --nproc_per_node 4 \
      -m repro_torch.launch.train --arch stablelm-3b --reduced --device cpu \
      --mesh debug --approx-mode sharded_pack --pack-shards 2 --steps 2

where ``debug`` is the reference's (max(1, n//2), min(2, n)) ('data',
'model') mesh over the n ranks; run alone it is a 1 x 1 mesh (NCCL on the
card, gloo on the CPU), as the reference's launcher is on one device.
``prod`` and ``multipod`` need 256 and 512 ranks.  ``--obs`` builds the model with the device telemetry on
(out-of-domain clamps and quant saturation, counted on the device; a
checkpointed layer's activations are counted again in its recompute, as
the reference's remat counts them) and prints the metric summary as JSON;
``--trace PATH`` writes a Chrome trace of the run with that summary in its
metadata.  Weights are random, drawn from seed 0, and the data is the
counter-addressed synthetic stream, as in the JAX launcher.  The summary
line reports the one-time nvcc kernel build in place of the reference's
compile time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch import obs
from repro_torch.approx import TABLE_MODES
from repro_torch.device import resolve_device
from repro_torch.models import ShapeSpec, build_model, get_config, reduced
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainConfig, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt in "
                         "the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving shrink for CPU-scale runs")
    ap.add_argument("--approx-mode", choices=["exact", *TABLE_MODES], default=None,
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
                    help="write a Chrome-trace JSON of the run (train.step / "
                         "train.ckpt spans; open in Perfetto, validate with "
                         "tools/check_trace.py)")
    ap.add_argument("--obs", action="store_true",
                    help="enable device-side approximation telemetry and "
                         "print the metric summary")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    ap.add_argument("--mesh", choices=["none", "debug", "prod", "multipod"],
                    default="none",
                    help="train over a DeviceMesh of the torchrun ranks (one "
                         "process a rank: torchrun --nproc_per_node N -m "
                         "repro_torch.launch.train ...); debug = (max(1, n//2),"
                         " min(2, n)) ('data', 'model'), a 1 x 1 mesh run "
                         "alone; prod / multipod = the (16, 16) / (2, 16, 16) "
                         "meshes")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    obs.configure(enabled=True, device_telemetry=args.obs, trace_path=args.trace)
    obs.reset_tracer()
    obs.reset_registry()

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
    mesh = None
    if args.mesh == "debug":
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_process_group, make_debug_mesh

        init_process_group(device)
        n = dist.get_world_size()
        mesh = make_debug_mesh(max(1, n // 2), min(2, n), device)
    elif args.mesh in ("prod", "multipod"):
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh(multi_pod=args.mesh == "multipod", device=device)
    # mesh before model: build_model places a sharded pack over it, so the
    # activation closures hold one values slice a rank
    model = build_model(cfg, mesh=mesh) if mesh is not None else build_model(cfg, device)

    shape = ShapeSpec("cli", seq_len=args.seq, global_batch=args.batch, kind="train")
    tc = TrainConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, accum=args.accum,
        opt=adamw.AdamWConfig(lr=args.lr, warmup_steps=max(1, args.steps // 20),
                              total_steps=args.steps),
    )
    if args.ckpt_dir is not None:
        tc.ckpt_dir = args.ckpt_dir
    t0 = time.perf_counter()
    out = run(model, shape, tc, mesh=mesh)
    wall = time.perf_counter() - t0
    steps_done = len(out["losses"])
    if steps_done == 0:
        print(f"done: step={out['final_step']} (nothing to run: the checkpoint "
              f"in {tc.ckpt_dir} is at or past --steps)")
        return out
    steady = max(wall - out["build_time_s"], 1e-9)
    print(f"done: step={out['final_step']} "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"stragglers={out['stragglers']} preempted={out['preempted']}; "
          f"{steps_done / wall:.2f} step/s wall, {steps_done / steady:.2f} "
          f"step/s steady after {out['build_time_s']:.2f}s kernel build "
          f"on {device}")
    if args.obs:
        print(json.dumps(obs.get_registry().summary(), indent=1, default=str))
    if args.trace:
        obs.get_tracer().save(args.trace, metadata={
            "summary": {"steps": steps_done, "wall_s": wall,
                        "build_time_s": out["build_time_s"],
                        "device": str(device)},
            "metrics": obs.get_registry().summary()})
        print(f"trace written to {args.trace}")
    return out


if __name__ == "__main__":
    main()
