"""Memory-packing cost models: Xilinx BRAM18 (the paper's) and the table
kernel's shared-memory staging (the port's).

The paper (Sec. 7.2.1) counts BRAM18 primitives for 32-bit entries as

    #BRAM = 2^(ceil(log2 M_F) - 10)            [address-space allocation, depth 1024]

i.e. the synthesized address decoder allocates a power-of-two address space.
``bram_count`` reproduces that formula exactly and ``bram_count_packed`` is the
generic width-aware variant for the paper's other configurations (16384x1 ...
512x36).  Both are the port's copies of ``repro.core.bram``'s and do not
depend on the hardware the tables run on.

The card-side analogue (``smem_cost``) reports the bytes of one table's
staging image (``TorchTable.image``): what a block of the table kernels
(``tp_table_lookup`` / ``tp_table_grad``) copies into shared memory in one
round trip, against the 48 KB a block stages (``kSmemBytes`` in
``csrc/table_pack_lookup.cu``).  Past the budget the kernel stages only the
metadata row and reads the values from global memory.  The residency of a
multi-function pack, the reference's ``vmem_cost_pack``, is not carried over
(ROADMAP queue 1, item 15).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# BRAM18 capacity by entry width (Xilinx 7-series, UG473): width -> depth
BRAM18_DEPTH = {1: 16384, 2: 8192, 4: 4096, 9: 2048, 18: 1024, 36: 512}

# The paper treats 32-bit entries as depth-1024 (width rounded up to 36 would give 512;
# the text explicitly states 1024 entries of 32 bits and uses the 2^(ceil..-10) formula).
PAPER_DEPTH_32BIT = 1024

SMEM_BYTES = 48 * 1024  # a block's staging budget (kSmemBytes)
IMAGE_ALIGN_WORDS = 4  # the image is zero-padded to 16 bytes


def bram_count(footprint: int, width_bits: int = 32) -> int:
    """Paper formula: power-of-two address-space allocation at depth 1024 (32-bit)."""
    if footprint <= 0:
        raise ValueError("footprint must be positive")
    if width_bits != 32:
        return bram_count_packed(footprint, width_bits)
    addr_bits = max(10, math.ceil(math.log2(footprint)))
    return 2 ** (addr_bits - 10)


def bram_count_packed(footprint: int, width_bits: int) -> int:
    """Generic ceil-packing across BRAM18 width configurations (no address rounding)."""
    if footprint <= 0:
        raise ValueError("footprint must be positive")
    widths = sorted(BRAM18_DEPTH)
    for w in widths:
        if width_bits <= w:
            return math.ceil(footprint / BRAM18_DEPTH[w])
    # wider than 36 bits: split into 36-bit slices
    slices = math.ceil(width_bits / 36)
    return slices * math.ceil(footprint / BRAM18_DEPTH[36])


@dataclass(frozen=True)
class SmemCost:
    table_bytes: int  # the M_F f32 values
    meta_bytes: int  # n + 1 boundaries, then n inv_delta, base and seg_count
    image_bytes: int  # both, zero-padded to 16 bytes: what a block stages
    budget_bytes: int

    @property
    def fits(self) -> bool:
        """True where the table kernels stage the whole image; past the
        budget they stage the row and read the values from global memory."""
        return self.image_bytes <= self.budget_bytes

    @property
    def fraction(self) -> float:
        return self.image_bytes / self.budget_bytes


def smem_cost(footprint: int, n_intervals: int,
              budget_bytes: int = SMEM_BYTES) -> SmemCost:
    """The staging image of a single table of ``footprint`` f32 values over
    ``n_intervals`` sub-intervals: ``4 * TorchTable(spec).image.numel()``."""
    if footprint <= 0 or n_intervals <= 0:
        raise ValueError("footprint and n_intervals must be positive")
    meta_words = 4 * n_intervals + 1
    words = meta_words + footprint
    padded = -(-words // IMAGE_ALIGN_WORDS) * IMAGE_ALIGN_WORDS
    return SmemCost(4 * footprint, 4 * meta_words, 4 * padded, budget_bytes)
