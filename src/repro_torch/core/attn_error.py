"""TableFlash error contract: a provable row-wise bound on the attention output
when flash attention's running softmax serves ``exp`` from the pack's
``exp_neg`` member instead of the transcendental.

The port's copy of ``repro.core.attn_error``; the argument below holds for
the port's ``models/attention.py::flash_attention`` with ``exp_fn`` set to the
``tableflash_exp`` kernel or its plain version, whose chunked scan and
running max are the reference's.

Setting.  ``flash_attention`` scans the (padded) key axis in C chunks keeping a
running max m_c, and the two exp calls per chunk —

    p     = exp(s - m_c)          (per-key probability numerator)
    alpha = exp(m_{c-1} - m_c)    (carry rescale)

— both have non-positive arguments by construction, so they land on
``exp_neg``'s canonical domain [lo, 0] (lo = -16 in the registry) with an
underflow-to-zero tail below lo: the lookup returns exactly 0.0 there,
matching f32 exp's own underflow for the masked-slot arguments.  The
running max itself uses NO exp, so both the exact and the table path compute
*identical* m_c sequences; the approximation error enters only through the
lookup factors.

Per-lookup error.  The table guarantees |table(z) - exp(z)| <= Ea on
[lo, 0].  Below lo the zero tail leaves |0 - exp(z)| < exp(lo).  Uniformly:

    delta = Ea + exp(lo)                                       (lookup_delta)

Per-key weight error.  After the scan, the exact weight of key i telescopes
to exp(s_i - m_final) = exp(s_i - m_{c(i)}) * prod_c exp(m_{c-1} - m_c):
one p factor and at most C-1 alpha factors, every factor in [0, 1].  The
table path evaluates the SAME factor product with each factor off by at most
delta and bounded by 1 + delta (arguments are <= 0, so table values are at
most table(0) <= 1 + Ea).  A product of F factors with per-factor error
delta differs from the exact product by at most F * delta * (1+delta)^(F-1),
and F <= C:

    eps_w = C * delta * (1 + delta)^(C-1)                      (weight_error)

Output bound.  With Tp = C * kv_chunk padded keys, |v| <= Vmax, exact
weights w_i >= 0 summing to l >= 1 (the running max makes the maximal key's
weight exactly 1), approx weights summing to l_hat >= l - Tp*eps_w (masked
and pad keys have weight exactly 0 in BOTH paths — exact exp underflows to
+0.0 in f32 and the zero tail reproduces it — so they contribute no error;
keeping them under the same per-key eps_w is conservative):

    |o_hat - o| <= |sum (w_hat-w) v| / l_hat + |sum w v| * |1/l_hat - 1/l|
                <= Tp*eps_w*Vmax / l_hat + Vmax * Tp*eps_w / l_hat
                <= 2 * Tp * Vmax * eps_w / (1 - Tp*eps_w)      (flash_abs_bound)

valid whenever Tp * eps_w < 1.  Rows with NO valid key are excluded from the
contract (both paths renormalize garbage identically; callers mask them).

The bound is mathematical (infinite-precision factor arithmetic); the
empirical checks (tests/test_torch_paper.py on the CPU, chip_smoke.py phase
30 on the card) add a tiny f32-accumulation slop on top.  See
docs/table_flash.md for the worked derivation.
"""

from __future__ import annotations

import math

# exp_neg's canonical domain low edge (the core.functions registry): below
# it the TableFlash lookup underflows to exactly 0 while exp(z) < exp(-16)
# ~ 1.1e-7, so the tail error is bounded by exp(lo).
EXP_NEG_LO = -16.0


def lookup_delta(e_a: float, lo: float = EXP_NEG_LO) -> float:
    """Uniform per-lookup error bound over z <= 0: Ea on [lo, 0], exp(lo)
    on the underflow-to-zero tail below lo."""
    return float(e_a) + math.exp(lo)


def weight_error(n_chunks: int, delta: float) -> float:
    """Per-key weight error after C chunks: C * delta * (1+delta)^(C-1)."""
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    try:
        return n_chunks * delta * (1.0 + delta) ** (n_chunks - 1)
    except OverflowError:
        # (1+delta)^(C-1) past float range: the bound is degenerate anyway
        return math.inf


def flash_abs_bound(e_a: float, n_keys: int, kv_chunk: int, v_max: float,
                    lo: float = EXP_NEG_LO) -> float:
    """Row-wise |table_flash - exact_flash| bound on the attention output.

    ``n_keys`` is the TRUE key count T; the chunked scan pads it to
    Tp = ceil(T / kv_chunk) * kv_chunk and every padded key enters the bound
    (its table weight is at most eps_w, its exact weight exactly 0).
    Returns ``math.inf`` when Tp * eps_w >= 1 — the contract degenerates and
    the caller should tighten Ea or the chunking before relying on it.
    """
    if n_keys < 1 or kv_chunk < 1:
        raise ValueError(
            f"need n_keys >= 1 and kv_chunk >= 1, got {n_keys}, {kv_chunk}")
    kv_chunk = min(kv_chunk, n_keys)
    n_chunks = -(-n_keys // kv_chunk)
    tp = n_chunks * kv_chunk
    eps_w = weight_error(n_chunks, lookup_delta(e_a, lo))
    if tp * eps_w >= 1.0:
        return math.inf
    return 2.0 * tp * float(v_max) * eps_w / (1.0 - tp * eps_w)
