"""Roofline of the dry run's cells on the H100 (the JAX package's
``benchmarks/roofline.py``, with the card's peaks in place of the TPU's).

Terms per (arch x shape x mesh) cell, in SECONDS of one step on one card:

    compute    = FLOPs_per_device / PEAK_FLOPS     (dense bf16)
    memory     = HBM_bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / link rate of the mesh

The peaks are the NVIDIA H100 SXM5 80GB (HBM3, 700 W) datasheet's, not
measurements: 989.4e12 dense bf16 FLOP/s, 3.35e12 B/s HBM3.  The cluster
layout is one node of 8 cards joined by NVLink 4 (450e9 B/s a direction a
card) and one 400 Gb/s NDR InfiniBand link a card across nodes (50e9 B/s).
A collective over a mesh axis wider than 8 crosses nodes, so it takes the NDR
rate; both production meshes, (16, 16) and (2, 16, 16), have such axes.

FLOPs and bytes come from ``analysis.cost_model`` (the itemized analytic
model, the reference's terms).  The dry run's traced FLOPs a device
(``launch.dryrun``) stand beside them as a whole-step cross-check, and its
MemTracker peak (the arguments included) is the fits-check against the
card's memory.

Reported per cell:
  * the three terms and the dominant bound;
  * MODEL_FLOPS (6*N_active*D train / 2*N_active*D serve) and the useful
    ratio MODEL_FLOPS / analytic FLOPs (remat + padding + capacity waste);
  * roofline fraction = t_ideal / t_bound, where t_ideal is the useful-FLOPs
    time (train/prefill) or the minimal-traffic time (decode: bf16 params +
    cache read once);
  * a one-line note on what moves the dominant term.

Usage: ``PYTHONPATH=src python -m repro_torch.analysis.roofline
[--results build/dryrun_torch.json] [--mesh 16x16] [--variant base]``.
"""

from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.launch.dryrun import RESULTS_PATH
from repro_torch.models import get_config, shapes_for

from .cost_model import cell_costs

PEAK_FLOPS = 989.4e12  # dense bf16 a card (datasheet)
HBM_BW = 3.35e12  # HBM3 (datasheet)
NVLINK_BW = 450e9  # NVLink 4, a direction a card, within a node of 8
NDR_BW = 50e9  # one 400 Gb/s NDR link a card, across nodes
NODE_CARDS = 8
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit, as chip_smoke.py phase 45 prints it
CARD_MEMORY_BYTES = 85_017_493_504


def link_bw(mesh: str) -> float:
    """The link rate of a mesh's collectives: NDR when an axis is wider
    than a node."""
    widest = max(int(s) for s in mesh.split("x"))
    return NDR_BW if widest > NODE_CARDS else NVLINK_BW


def analyze(arch: str, shape_name: str, mesh: str, variant: str = "base") -> Dict:
    cfg = get_config(arch)
    shape = {s.name: s for s in shapes_for(cfg)}[shape_name]
    pods = 2 if mesh == "2x16x16" else 1
    c = cell_costs(cfg, shape, n_chips=256 * pods, data_shards=16,
                   model_shards=16, pods=pods, variant=variant)
    t_compute = c.flops_dev / PEAK_FLOPS
    t_memory = c.hbm_bytes_dev / HBM_BW
    t_coll = c.coll_bytes_dev / link_bw(mesh)
    t_bound = max(t_compute, t_memory, t_coll)
    dominant = ("compute" if t_bound == t_compute
                else "memory" if t_bound == t_memory else "collective")
    if shape.kind == "decode":
        t_ideal = c.ideal_bytes_dev / HBM_BW
    else:
        t_ideal = c.ideal_flops_dev / PEAK_FLOPS
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_bound_s": t_bound,
        "dominant": dominant,
        "useful_ratio": (c.ideal_flops_dev / c.flops_dev
                         if c.flops_dev > 0 else 0.0),
        "roofline_fraction": t_ideal / t_bound if t_bound > 0 else 0.0,
        "model_flops_global": c.ideal_flops_dev * 256 * pods,
        "flops_per_dev": c.flops_dev,
        "hbm_gb_per_dev": c.hbm_bytes_dev / 1e9,
        "coll_gb_per_dev": c.coll_bytes_dev / 1e9,
        "kind": shape.kind,
    }


def suggest(a: Dict) -> str:
    if a["dominant"] == "collective":
        return ("collective-bound: overlap the grad all-reduce with the backward, "
                "compress cross-node traffic to bf16, or reshard the all-reduce-heavy "
                "projections")
    if a["dominant"] == "memory":
        if a["kind"] == "decode":
            return ("HBM-bound decode: quantize KV/params, raise batch, or split "
                    "cache reads across cards (flash-decoding)")
        if a["useful_ratio"] < 0.5:
            return "HBM-bound, low useful ratio: cut remat traffic / fuse temps"
        return "HBM-bound: bf16 master cast once, fuse elementwise, bigger tiles"
    if a["useful_ratio"] < 0.5:
        return (f"compute-bound, useful={a['useful_ratio']:.2f}: cut remat/"
                "padding/capacity waste")
    return "compute-bound at high useful ratio: near roofline"


def load(path: str = RESULTS_PATH) -> Dict[str, Dict]:
    with open(path) as f:
        return json.load(f)


def report(mesh_filter: str = "16x16", variant: str = "base",
           path: str = RESULTS_PATH) -> List[Dict]:
    """A row for every ``ok`` cell of the dry run's results file on
    ``mesh_filter`` in ``variant``."""
    rows = []
    for key, rec in sorted(load(path).items()):
        arch, shape, mesh, var = key.split("|")
        if rec.get("status") != "ok" or mesh != mesh_filter or var != variant:
            continue
        a = analyze(arch, shape, mesh, var)
        mem = rec["memory"]
        rows.append({
            "arch": arch, "shape": shape, "mesh": mesh, **a,
            "note": suggest(a), "compile_s": rec["compile_s"],
            "arg_gb": mem["argument_size_in_bytes"] / 1e9,
            "peak_gb": mem["peak_size_in_bytes"] / 1e9,
            "fits": bool(mem["peak_size_in_bytes"] <= CARD_MEMORY_BYTES),
            "traced_flops_per_dev": rec.get("flops_per_device", -1),
            "collectives": rec.get("collectives", {}),
        })
    return rows


def to_markdown(rows: List[Dict]) -> str:
    """Each cell's per-device argument and peak GiB, traced TFLOPs and
    collective GB by type (the dry run's), the three roofline terms in ms,
    the dominant one and whether the peak fits the card."""
    hdr = ("| arch | shape | mesh | arg GiB | peak GiB | traced TFLOP | AG GB | AR GB | "
           "RS GB | A2A GB | compute ms | memory ms | collective ms | bound | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    body = ""
    gib, gb = 2 ** 30, 1e9
    for r in rows:
        c = r["collectives"]
        body += (f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['arg_gb'] * 1e9 / gib:.2f} | "
                 f"{r['peak_gb'] * 1e9 / gib:.2f} | {r['traced_flops_per_dev'] / 1e12:.3f} | "
                 f"{c['all-gather'] / gb:.2f} | {c['all-reduce'] / gb:.2f} | "
                 f"{c['reduce-scatter'] / gb:.2f} | {c['all-to-all'] / gb:.2f} | "
                 f"{r['t_compute_s'] * 1e3:.1f} | {r['t_memory_s'] * 1e3:.1f} | "
                 f"{r['t_collective_s'] * 1e3:.1f} | {r['dominant']} | "
                 f"{'Y' if r['fits'] else 'N'} |\n")
    return hdr + body


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="the dry run's cells on the H100 roofline")
    ap.add_argument("--results", default=RESULTS_PATH)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--variant", default="base")
    args = ap.parse_args(argv)
    rows = report(args.mesh, args.variant, args.results)
    print(to_markdown(rows))
    print(f"({len(rows)} cells of {args.results})")
    return rows


if __name__ == "__main__":
    main()
