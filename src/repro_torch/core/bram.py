"""Memory-packing cost models: Xilinx BRAM18 (the paper's) and the table
kernel's shared-memory staging (the port's).

The paper (Sec. 7.2.1) counts BRAM18 primitives for 32-bit entries as

    #BRAM = 2^(ceil(log2 M_F) - 10)            [address-space allocation, depth 1024]

i.e. the synthesized address decoder allocates a power-of-two address space.
``bram_count`` reproduces that formula exactly and ``bram_count_packed`` is the
generic width-aware variant for the paper's other configurations (16384x1 ...
512x36).  Both are the port's copies of ``repro.core.bram``'s and do not
depend on the hardware the tables run on.

The card-side analogue of the reference's VMEM residency is a block's
shared memory.  ``smem_cost`` reports the bytes of one table's staging image
(``TorchTable.image``): what a block of the table kernels (``tp_table_lookup``
/ ``tp_table_grad``) copies into shared memory in one round trip, against the
48 KB a block stages (``kSmemBytes`` in ``csrc/table_pack_lookup.cu``).  Past
the budget the kernel stages only the metadata row and reads the values from
global memory.  ``smem_cost_pack`` (the reference's ``vmem_cost_pack``) does
the same for a multi-function pack, in each of its flavors' word layouts:
``member_image_layout`` (the f32 pack's ``TablePack.image``, TableFlash's
``flash_image`` and RangeFold's ``fold_images``), ``quant_image_layout``,
``poly_image_layout`` and ``sharded_image_layout``.  These are the one
definition of those layouts: ``approx.table_pack`` builds the images by them,
and the layouts' and plan's ``smem()`` methods report by them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

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


# --------------------------------------------------------------------------------------
# The packs' staging images: their word layouts and shared-memory residency
# --------------------------------------------------------------------------------------


def _up4(words: int) -> int:
    return -(-words // IMAGE_ALIGN_WORDS) * IMAGE_ALIGN_WORDS


def member_image_layout(n_intervals: Sequence[int]) -> Tuple[Tuple[int, ...], int]:
    """Where a member staging image over rows of ``n_intervals``
    sub-intervals keeps them, in f32 words: the start of each member's row
    (its ``n + 1`` boundaries, then its ``n`` inv_delta, base and
    seg_count) and the start of the values behind the rows.  The image is
    the values' span behind that, zero-padded to 16 bytes.  The kernels
    that stage such images (``csrc/table_pack_lookup.cu``,
    ``image_values_at``) lay it out the same."""
    starts, at = [], 0
    for n in n_intervals:
        starts.append(at)
        at += 4 * n + 1
    return tuple(starts), at


def _image_starts(sections, words) -> Tuple[Dict[str, int], int]:
    """Each section's start in 32-bit words, back to back, and the end."""
    starts, at = {}, 0
    for name, w in zip(sections, words):
        starts[name] = at
        at += w
    return starts, at


# the sections of a quantized pack's staging image, in order
QUANT_IMAGE_SECTIONS = ("n_intervals", "bounds_offsets", "lane_offsets", "entry_bits",
                        "boundaries", "inv_delta", "base", "seg_count", "scale",
                        "zero", "ramp", "codes16", "codes8")


def quant_image_layout(n_functions: int, n_sub: int, m8: int,
                       m16: int) -> Tuple[Dict[str, int], int]:
    """Where a quantized pack's staging image keeps each of
    ``QUANT_IMAGE_SECTIONS``, in 32-bit words, and the image's length: the
    four routing operands (``n_functions`` each), the ``n_sub +
    n_functions`` boundaries, the ``n_sub`` inv_delta / base / seg_count /
    scale / zero / ramp, then the ``m16`` int16 and ``m8`` int8 codes.  The
    kernels (``csrc/table_pack_lookup.cu``, ``quant_image``) lay it out the
    same."""
    return _image_starts(QUANT_IMAGE_SECTIONS, (
        (n_functions,) * 4 + (n_sub + n_functions,) + (n_sub,) * 6
        + ((m16 + 1) // 2, (m8 + 3) // 4)))


# the sections of a polynomial pack's staging image, in order
POLY_IMAGE_SECTIONS = ("n_intervals", "bounds_offsets", "lane_offsets", "entry_bits",
                       "strides", "boundaries", "inv_delta", "base", "seg_count",
                       "zero", "ramp", "scale", "codes32", "codes16", "codes8")


def poly_image_layout(n_functions: int, n_sub: int, lanes: int, m8: int, m16: int,
                      m32: int) -> Tuple[Dict[str, int], int]:
    """Where a polynomial pack's staging image keeps each of
    ``POLY_IMAGE_SECTIONS``, in 32-bit words, and the image's length: the
    five routing operands (``n_functions`` each), the ``n_sub +
    n_functions`` boundaries, the ``n_sub`` inv_delta / base / seg_count,
    the ``n_sub * lanes`` zero / ramp / scale, then the ``m32`` f32, ``m16``
    int16 and ``m8`` int8 codes.  The kernels
    (``csrc/table_pack_lookup.cu``, ``poly_image``) lay it out the same."""
    return _image_starts(POLY_IMAGE_SECTIONS, (
        (n_functions,) * 5 + (n_sub + n_functions, n_sub, n_sub, n_sub)
        + (n_sub * lanes,) * 3 + (m32, (m16 + 1) // 2, (m8 + 3) // 4)))


def sharded_image_layout(n_intervals: Sequence[int], n_shards: int,
                         m: int) -> Tuple[Tuple[int, ...], int, int]:
    """Where a sharded pack's staging image keeps its parts, in f32 words:
    a header of each member's row start and sub-interval count (words 2f
    and 2f + 1); each member's row from its start, over its real
    sub-intervals: one quad (inv_delta, owner-rebased base, seg_count,
    owner) for each sub-interval, then its ``n + 1`` boundaries; and the
    ``n_shards`` padded values slices of ``m`` entries, back to back, from
    the values start.  Every part starts at a multiple of 4 words, so that a
    quad is one 16-byte shared-memory read.  Returns (row starts, values
    start, the image's words).  The kernels that stage it
    (``csrc/table_pack_lookup.cu``, ``spack_image_kernel``) read it so."""
    starts, at = [], _up4(2 * len(n_intervals))
    for n in n_intervals:
        starts.append(at)
        at += _up4(5 * n + 1)
    return tuple(starts), at, _up4(at + n_shards * m)


def staging_for(meta_bytes: int, value_bytes: int,
                budget_bytes: int = SMEM_BYTES) -> str:
    """What a block stages past the image's budget (the kernels'
    ``staging_for``): the row and the values if both fit, else the row if
    it fits, else nothing."""
    if meta_bytes + value_bytes <= budget_bytes:
        return "row_and_values"
    return "meta" if meta_bytes <= budget_bytes else "none"


@dataclass(frozen=True)
class SmemPackCost:
    """A pack's shared-memory residency on the card (the reference's
    pack-level ``VmemCost``): its staging image, what the launches stage,
    against a block's budget.

    ``image_bytes`` is the flavor's staging image as the pack builds it
    (``TablePack.image``, ``flash_image``, ``fold_images``,
    ``QuantTablePack.image``, ``PolyTablePack.image``,
    ``ShardedTablePack.image``): ``meta_bytes`` of rows, lanes and routing
    operands (alignment padding included) and ``table_bytes`` of values or
    codes.  A launch stages the whole image in one round trip where it fits
    the budget (``staging == "image"``); past it the launch stages
    ``fallback`` (the kernels' Stage: ``"row_and_values"``, ``"meta"`` or
    ``"none"``), ``fallback_bytes`` of the widest member's row and the
    values, and reads the rest from global memory.  The sharded
    value kernels never stage the image: they always take the fallback, the
    member's rows and the range's values slab."""

    image_bytes: int
    meta_bytes: int
    table_bytes: int
    budget_bytes: int
    fallback: str
    fallback_bytes: int

    @property
    def fits(self) -> bool:
        return self.image_bytes <= self.budget_bytes

    @property
    def staging(self) -> str:
        """What a launch of the flavor's image kernels stages."""
        return "image" if self.fits else self.fallback


def smem_cost_pack(image_words: int, table_bytes: int, fallback_meta_bytes: int,
                   fallback_value_bytes: int,
                   budget_bytes: int = SMEM_BYTES) -> SmemPackCost:
    """The residency of a staging image of ``image_words`` 32-bit words
    (one of the layouts above), ``table_bytes`` of them values or codes,
    whose launches past the budget stage ``fallback_meta_bytes`` of row and
    ``fallback_value_bytes`` of values as :func:`staging_for` allows."""
    if image_words <= 0 or table_bytes <= 0:
        raise ValueError("an image holds rows and values")
    image = 4 * image_words
    fallback = staging_for(fallback_meta_bytes, fallback_value_bytes, budget_bytes)
    taken = {"row_and_values": fallback_meta_bytes + fallback_value_bytes,
             "meta": fallback_meta_bytes, "none": 0}[fallback]
    return SmemPackCost(image, image - table_bytes, table_bytes, budget_bytes,
                        fallback, taken)
