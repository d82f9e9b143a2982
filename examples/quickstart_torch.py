"""Quickstart of the PyTorch/CUDA port: the paper's design flow end to end, on
its own worked example, with the tables served by the hand-written kernels.

1. Reference (even-spacing) table for log(x) on [0.625, 15.625)  (paper Fig. 3)
2. The three interval-splitting algorithms                       (paper Sec. 5)
3. Resource models: BRAM18 counts (paper Sec. 7) and the table kernel's
   shared-memory staging image against a block's 48 KB
4. The runtime: the table kernel (``table_lookup``) against its plain PyTorch
   version and against exact log, and the differentiable activation wrapper.
5. QuantPack: the error budget split between interpolation and int8/int16
   code rounding, with the dequantize-on-read kernel still inside Ea.
6. Routed and sharded dispatch: RoutedPack (a member a row, one launch for a
   mixed batch, docs/routedpack.md) and ShardedPack off the mesh (the pack's
   values cut into slices summed on one device, equal to the replicated
   pack, docs/sharding.md).
7. The design-space planner: degree-1..3 Horner cells x f32/int16/int8 codes
   searched as ONE space, with byte-budgeted plans (docs/planner.md).

Run on the card (the kernels are built on first use):
    PYTHONPATH=src python examples/quickstart_torch.py
and on the CPU, where every kernel wrapper runs its plain PyTorch version:
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.approx import ApproxConfig, build_quant_pack, from_spec
from repro_torch.core import (
    binary_split,
    bram_count,
    build_table,
    get_function,
    hierarchical_split,
    plan,
    reference_spacing,
    run_flow,
    sequential_split,
    smem_cost,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import _lib
from repro_torch.kernels.table_lookup import table_lookup, table_lookup_plain

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (the kernels) or cpu (their plain versions)")
dev = resolve_device(ap.parse_args().device)
_lib.reset_launches()

EA = 1.22e-4
LO, HI = 0.625, 15.625


def exact(name, x):
    """f in f64 on the f32 inputs, as a numpy array."""
    return np.asarray(get_function(name).f(x.detach().double().cpu().numpy()))


def max_err(y, want):
    return float(np.max(np.abs(y.detach().double().cpu().numpy() - want)))


print(f"device: {dev}")
print("=== 1. Reference approach (paper Fig. 3) ===")
fn = get_function("log")
ref = reference_spacing(fn, EA, LO, HI)
print(f"delta = {ref.delta:.5f}, M_F = {ref.footprint} entries "
      f"(paper: delta~0.019, M_F~770)")

print("\n=== 2. Interval splitting (paper Sec. 5, omega = 0.3) ===")
for name, sr in [
    ("binary      ", binary_split("log", EA, LO, HI, 0.3)),
    ("hierarchical", hierarchical_split("log", EA, LO, HI, 0.3, epsilon=0.015)),
    ("sequential  ", sequential_split("log", EA, LO, HI, 0.3, epsilon=0.3)),
]:
    red = 100 * (ref.footprint - sr.footprint) / ref.footprint
    print(f"{name}: P = {np.round(sr.partition, 3).tolist()}")
    print(f"              M_F = {sr.footprint} (-{red:.0f}%), "
          f"{sr.n_intervals} sub-intervals")

print("\n=== 3. Resource models (paper Sec. 7) ===")
report = run_flow("log", EA, LO, HI, algorithm="hierarchical", omega=0.3,
                  verify_error=True)
print(report.summary())
print(f"BRAM18s: reference {bram_count(ref.footprint)} -> "
      f"{bram_count(report.footprint)}")
sm = smem_cost(report.footprint, report.n_intervals)
print(f"staging image of the table kernel: {sm.image_bytes} bytes "
      f"({sm.fraction * 100:.2f}% of a block's {sm.budget_bytes} B: "
      f"{'staged in one round trip' if sm.fits else 'past the budget'})")
print(f"measured max |table - f| = {report.measured_max_error:.3e} <= Ea = {EA}")
assert report.measured_max_error <= EA

print("\n=== 4. Runtime: the table kernel, its plain version, the activation ===")
spec = build_table("log", EA, LO, HI, algorithm="hierarchical", omega=0.3)
jt = from_spec(spec, dev)
assert 4 * jt.image.numel() == sm.image_bytes
x = torch.from_numpy(
    np.random.default_rng(0).uniform(LO, HI, 8192).astype(np.float32)).to(dev)
y_plain = table_lookup_plain(jt, x)
y_kern = table_lookup(jt, x)  # tp_table_lookup on a CUDA tensor
kdiff = float((y_kern - y_plain).abs().max())
lerr = max_err(y_kern, exact("log", x))
print(f"table_lookup vs its plain version max diff: {kdiff:.1e} "
      f"({_lib.launches['table_lookup']} kernel launches)")
print(f"vs exact log(x) max err:   {lerr:.2e} (Ea = {EA})")
assert kdiff == 0.0 and lerr <= EA

cfg = ApproxConfig(mode="table_pallas", e_a=1e-4)
gelu = cfg.unary("gelu", dev)
xg = torch.linspace(-3, 3, 16, device=dev, requires_grad=True)
gelu(xg).sum().backward()
print(f"table-GELU gradient via the slope rule: "
      f"{np.round(xg.grad[:4].double().cpu().numpy(), 3).tolist()} ...")

print("\n=== 5. QuantPack: error-budgeted int8/int16 entries ===")
QNAMES = ("gelu", "tanh", "sigmoid_sym")
QEA = 1e-4
qpack = build_quant_pack(QNAMES, QEA, device=dev)  # interp 0.9*Ea, rounding 0.1*Ea
f32_bytes = 4 * sum(build_table(n, QEA, algorithm="hierarchical",
                                omega=0.3).footprint for n in QNAMES)
print(f"per-function width from the budget split: "
      f"{dict(zip(qpack.names, qpack.entry_bits))}")
print(f"entry storage: {qpack.footprint_bytes} B quantized vs {f32_bytes} B "
      f"f32 ({f32_bytes / qpack.footprint_bytes:.1f}x smaller)")
qcfg = ApproxConfig(mode="quant_pack", e_a=QEA)
for name in QNAMES:
    lo, hi = get_function(name).interval
    xs = torch.from_numpy(np.linspace(lo, hi, 4001)[:-1].astype(np.float32)).to(dev)
    err = max_err(qcfg.unary(name, dev)(xs), exact(name, xs))
    print(f"  {name:12s} dequantize-on-read max err = {err:.2e} <= Ea = {QEA}")
    assert err <= QEA * (1 + 1e-3)

print("\n=== 6. Routed + sharded dispatch: one launch a mixed batch, a pack in slices ===")
# Routed: the member ids are a device operand, so one kernel serves any
# per-row mix of members and re-routing builds nothing new.
rcfg = ApproxConfig(mode="routed_pack", e_a=QEA)
routed = rcfg.routed_fn(("gelu", "tanh", "sigmoid"), dev)  # row i -> function i
xr = torch.from_numpy(
    np.random.default_rng(1).normal(0, 2, (3, 256)).astype(np.float32)).to(dev)
tcfg = ApproxConfig(mode="table_pack", e_a=QEA)
static = torch.stack([tcfg.unary(n, dev)(xr[i]) for i, n in
                      enumerate(("gelu", "tanh", "sigmoid"))])
rdiff = float((routed(xr) - static).abs().max())
print(f"routed vs per-row static dispatch max diff: {rdiff:.1e} (bit-identical)")
assert rdiff == 0.0

# Sharded: the pack's values vector cut pack_shards ways (sub-interval
# granularity, per-shard base rebasing), every shard's contribution summed on
# this device in one launch; the mesh path is not ported.
scfg = ApproxConfig(mode="sharded_pack", e_a=QEA, pack_shards=2)
spack = scfg.sharded_pack(dev)
repl = tcfg.pack(dev)
sdiff = float((scfg.unary("gelu", dev)(xr) - tcfg.unary("gelu", dev)(xr)).abs().max())
print(f"sharded vs replicated pack max diff:        {sdiff:.1e} (equal values)")
assert sdiff == 0.0
print(f"per-shard values entries: {repl.footprint} replicated -> "
      f"{spack.footprint_per_shard} per shard ({spack.n_shards} shards)")

print("\n=== 7. The design-space planner: degree x width under a byte budget ===")
# plan() picks one (degree, dtype) candidate per function from its verified
# Pareto menu: degree-2+ cells shrink ENTRIES (the remainder bound scales as
# h^(d+1)), narrow codes shrink BYTES — one search subsumes both passes.
PNAMES = ("gelu", "tanh", "exp_neg", "sigmoid_sym")
free = plan(PNAMES, QEA)                      # cheapest per function
tight = plan(PNAMES, QEA, budget_bytes=2048)  # greedy downgrade until it fits
for label, p in (("auto  ", free), ("2048 B", tight)):
    picks = ", ".join(f"{c.name}=d{c.degree}/{c.dtype}" for c in p.chosen)
    print(f"plan[{label}]: {p.total_entries} entries, {p.total_bytes} B -- {picks}")
for m in free.members:  # every member still meets the paper's Ea contract
    assert m.max_error_on_grid(n=4001) <= QEA * (1 + 1e-6)
name = free.chosen[0].name
print(f"measured max |{name} - member| = "
      f"{free.members[0].max_error_on_grid(n=4001):.2e} <= Ea = {QEA}")

# The runtime artifact: one pack mixing degrees/widths, served by the fused
# Horner kernel through the same one-knob config (budget included; the
# default pack carries 6 functions, so its floor is higher than PNAMES')
pcfg = ApproxConfig(mode="poly_pack", e_a=QEA, pack_budget=4096)
ppack = pcfg.poly_pack(dev)
xs = torch.linspace(-4, 4, 2049, device=dev)[:-1]
perr = max_err(pcfg.unary("gelu", dev)(xs), exact("gelu", xs))
print(f"poly_pack(budget=4096 B): {ppack.footprint_bytes} B stored, "
      f"gelu kernel max err = {perr:.2e} <= ~Ea")
ran = {k: v for k, v in _lib.launches.items() if v}
print(f"kernel launches: {ran}")
if dev.type == "cuda":  # every section above went through its kernel
    for k in ("table_lookup", "table_lookup_grad", "quant_pack_lookup",
              "routed_pack_lookup", "table_pack_lookup", "sharded_pack_lookup",
              "poly_pack_lookup"):
        assert ran.get(k, 0) > 0, k
print("\nquickstart OK")
