// Hopper kernels over the port's packed tables: the f32 TablePack (values +
// (F, n_max) metadata planes) or a single table (one metadata row, F = 1),
// the ShardedTablePack (the replicated f32 planes, the owner and
// owner-rebased-base planes and the shards' values slices), the quantized
// QuantTablePack
// and the polynomial PolyTablePack (ragged flat metadata lanes + int8 / int16
// / f32 code groups).
//
//   tp_pack_lookup     replaces the TPU kernel _pack_kernel
//                      (src/repro/kernels/table_pack_lookup.py:43): one pack
//                      member's lerp, with optional linear extrapolation,
//                      over the pack's staging image where it fits.
//   tp_tableflash_exp  replaces the TPU kernel _tableflash_kernel
//                      (src/repro/kernels/table_pack_lookup.py:188): the exp_neg
//                      lookup at max(z, lo), t clamped, exactly 0 where z < lo.
//   tp_pack_grad       replaces the TPU kernel _pack_grad_kernel
//                      (src/repro/kernels/table_pack_lookup.py:66): value and
//                      slope of one pack member from one selector pass.
//   tp_table_lookup    replaces the TPU kernel _table_kernel
//                      (src/repro/kernels/table_lookup.py:66): one table's
//                      lerp, over the table's staging image where it fits.
//   tp_table_grad      replaces the TPU kernel _table_grad_kernel
//                      (src/repro/kernels/table_grad.py:28): one table's value
//                      and slope from one selector pass.
//   tp_quant_lookup    replaces the TPU kernel _quant_kernel
//                      (src/repro/kernels/table_pack_lookup.py:283): one
//                      quantized member, codes dequantized on read, over the
//                      pack's staging image where it fits.
//   tp_quant_grad      replaces _quant_grad_kernel (:309): its value and slope.
//   tp_poly_lookup     replaces _poly_kernel (:503): one polynomial member,
//                      per-lane dequantization and Horner.
//   tp_poly_grad       replaces _poly_grad_kernel (:524): its value and slope.
//   tp_routed_lookup   replaces the TPU kernel _routed_kernel
//                      (src/repro/kernels/routed_pack_lookup.py:101): row i of x
//                      through f32-pack member fn_ids[i], the ids a device
//                      operand.
//   tp_routed_grad     replaces _routed_grad_kernel (:126): its value and slope.
//   tp_routed_quant_lookup  replaces _routed_quant_kernel (:300): the same over
//                      the quantized pack (ragged offsets, code width per row).
//   tp_routed_quant_grad    replaces _routed_quant_grad_kernel (:329).
//   tp_routed_poly_lookup   replaces _routed_poly_kernel (:641): the same over
//                      the polynomial pack (code width and stride per row).
//   tp_routed_poly_grad     replaces _routed_poly_grad_kernel (:670).
//   tp_folded_lookup   replaces the TPU kernel _folded_kernel
//                      (src/repro/kernels/table_pack_lookup.py:943): full-f32-range
//                      sin / cos / exp / log (RangeFold): the fold prologue, one
//                      or two core-member lookups (never extrapolating), the
//                      reconstruction and edge epilogue (range_reduce.cuh).
//   tp_folded_grad     replaces _folded_grad_kernel (:953): its value and the
//                      chain-ruled slope from the same selector passes.
//   tp_spack_lookup    replaces the TPU kernel _spack_kernel
//                      (src/repro/kernels/table_pack_lookup.py:663) and the sum
//                      over its per-shard outputs (_sharded_sum_pallas, :803):
//                      a sharded-pack member's masked lerps (or, in its slope
//                      mode, masked slopes) over a range of shards, summed in
//                      shard order, in one launch.
//   tp_spack_grad      replaces _spack_grad_kernel (:697) and the sum over its
//                      per-shard outputs: the masked value and slope over all
//                      the shards, summed, from one selector pass in one
//                      launch, over the pack's staging image where it fits.
//   tp_sharded_routed_lookup  replaces _sharded_routed_kernel
//                      (src/repro/kernels/routed_pack_lookup.py:451) and its
//                      shard sum (_sharded_routed_sum, :529): the routed f32
//                      kernel over a range of shards, masked and summed.
//   tp_sharded_routed_grad    replaces _sharded_routed_grad_kernel (:480) and
//                      its shard sum: the routed value and slope over all the
//                      shards in one launch, as tp_spack_grad.
//
// What bounds them on the card: bytes.  Each element is read once and its
// output(s) written once, N * (in_bytes + n_out * out_bytes) at 3.35 TB/s; the
// compare/gather/lerp operations per element (n compares plus ~15-40 others)
// are far below the card's rate at the packs' interval counts.  At decode
// shapes they are launch-bound: the GLU silu gate at B=4 is 4 * 6912 = 27,648
// bf16 elements, about 110 KB in and out, some 33 ns of memory time against a
// few microseconds of launch.  The training gate (4, 128, 6912) bf16 is 3.5 M
// elements, 21 MB through a grad kernel.
//
// Design.  The TPU kernels tiled x into (rows, 512) blocks and pinned the pack
// in VMEM.  Here a grid-stride loop walks the flat element count (ragged tail
// masked by the loop bound, no padding), and each block stages what its
// member reads in dynamic shared memory — the counterpart of the VMEM/BRAM
// pinning — so the data-dependent gathers hit shared memory.  At the decode
// gate (108 blocks of 256 threads, one element a thread) the chain of
// dependent global-memory round trips before a block's first x load sets a
// kernel's time.  So where a staging image built with the pack (or table)
// fits kSmemBytes, a block stages that image in ONE round trip (one
// register-batched loop), with each thread's first x load already in
// flight, and the grid-stride loop loads the next x before this one's
// arithmetic: the f32 pack's TablePack.image and a single table's
// TorchTable.image (pack_image_kernel), the quantized pack's
// QuantTablePack.image (quant_image_kernel), the polynomial pack's
// PolyTablePack.image (poly_image_kernel), exp_neg's and the folds' member
// images (below).  Past the budget the launch sizes the staging: the
// member's metadata and the values (or code group) when both fit
// kSmemBytes, the metadata alone when only it fits, nothing otherwise;
// whatever is not staged is read from global memory (L2) by the same kernel
// (pack_kernel, quant_kernel, poly_kernel).  So no interval count or pack
// size is refused.  Member offsets, interval counts, code width, degree and
// extrapolate are runtime arguments: one compiled kernel per (input dtype,
// code type, mode) serves every member and every single table (a table is a
// pack of one row, n_max = n_intervals).  The grad mode writes the slope to a
// second output in the same pass.  Input and outputs are f32 or bf16 (the GLU
// gate arrives in bf16, the flash exponent in f32); the body computes in f32
// and stores with round to nearest even.  Built with -fmad=false:
// bit-identical to the plain PyTorch versions.
//
// TableFlash.  At the decode exponent (4 * 32 * 256 f32, one element a
// thread) the staging sets the kernel's time, and the exp_neg member reads
// 25 row floats and 118 of the pack's 894 values.  So where exp_neg's
// staging image fits kSmemBytes, a block stages only that: the image
// (TablePack.flash_image, built with the pack: the member's row over its
// real sub-intervals, its base rebased, its values span; 576 bytes in
// stablelm's pack) in ONE round trip (one register-batched loop), while each
// thread's first x load is already in flight (flash_image_kernel).  Past the budget it stages the
// member's row and the pack's values as above (pack_kernel).
//
// PolyPack.  The static poly kernels are launch-bound at the decode gate the
// same way, and their member reads its lanes and a span of its width group.
// Where the pack's staging image (PolyTablePack.image, the routed poly
// kernels' own: 2,216 bytes in stablelm's pack) fits kSmemBytes, a block
// stages it in ONE round trip with each thread's first x in flight and
// addresses the member's sections from the launch's offsets
// (poly_image_kernel); past the budget it stages the member's lanes and its
// code group as the budget allows (poly_kernel).
//
// Routed dispatch.  The TPU kernels scalar-prefetched the per-row fn_ids and
// let them steer each grid row's metadata DMA.  Here the ids, the members'
// interval counts and extrapolate flags (and, for the quantized pack, their
// ragged offsets and code widths) are int32 device vectors: a block reads its
// row's id, clamps it to [0, F-1] and gathers that member's scalars, so the
// routing is never read on the host and one compiled kernel serves every
// routing.  The work is (row, column tile) items, each block walking one
// contiguous run of them; a block restages the member's metadata row only
// where its run enters a row of another member.  Staging is sized for the
// largest member (the f32 pack's rows are all n_max long; the quant pack's
// widest member plus its larger width group) and falls back to global memory
// past kSmemBytes like the static kernels.  The per-element bodies are the
// static kernels' own (table_lookup.cuh) with the member's values read at run
// time, so row i is bit-identical to the static launch of member fn_ids[i].
// Each row of the polynomial pack runs the static poly kernel's Horner body
// at its member's own degree (the reference's uniform lmax-lane Horner gives
// the same bits: a padded lane dequantizes to exactly 0.0).  At the decode
// gate a block does one work item, so the dependent round trips before its
// first x load (the id, the member's scalars, its lanes, its code group)
// set its time.  So where the whole pack fits kSmemBytes (stablelm's is
// 2.2 KB) a block stages all of it once: the pack's staging image
// (PolyTablePack.image: routing scalars, every metadata lane, the three
// code groups, built with the pack) by one register-batched loop, with the
// call's extrapolate flags, its first id and its first x in flight at the
// same time; a row of another member then only points at other sections
// (routed_poly_pack_kernel).  The quantized pack does the same with its own
// image (QuantTablePack.image: routing scalars, the seven metadata lanes,
// both code groups; 4.6 KB in stablelm's pack, one batch of 8 loads a
// thread) (routed_quant_pack_kernel), and the f32 pack its own
// (TablePack.image: every member's row over its real sub-intervals, then the
// values; 4,080 bytes in stablelm's pack, one batch of 4 loads a thread),
// the members' interval counts, row starts and flags loaded beside it
// (routed_pack_image_kernel).
// Past the budget a block stages the widest member's lanes and the largest
// code group, restaging both per member (routed_poly_kernel,
// routed_quant_kernel), or the f32 member's row at n_max and the values
// (routed_kernel).
//
// RangeFold.  The folded kernels are the static pack body (tl::lookup /
// lookup_grad, extrapolation off) between the fold prologue and the
// reconstruction epilogue of range_reduce.cuh, over the flat element count.
// Trig reads two core rows (sin_core, cos_core), exp and log one.  A block
// stages only what its kind reads, in one round trip: the kind's staging
// image (TablePack.fold_images, built with the pack: the core rows over
// their real sub-intervals, their bases rebased into the image, and the
// cores' values span, 464 bytes for trig in stablelm's pack against the
// ~4.3 KB of rows and whole values vector staged before), by one TMA bulk
// copy on an uncapped grid or one register-batched loop, while each
// thread's first x load is already in flight (folded_image_kernel).  A pack
// whose image is past kSmemBytes stages both rows and the values as the
// budget allows (folded_kernel).  The fold adds ~40 integer and float
// operations an element for Payne-Hanek (|x| >= 2048) and ~10 for the other
// folds; a warp none of whose lanes needs Payne-Hanek skips it (a vote; the
// rotary angles never need it).  At the rotary shapes (4 * 27 * 40 angles)
// the kernels are launch-bound.  The kind (sin, cos, exp, log) is a launch
// argument, uniform over the grid.
//
// ShardedPack.  The reference runs one Pallas kernel a shard (on the mesh a
// shard is a device) and sums the outputs outside its kernels.  On one card
// the shards are slices of one buffer, so the kernels (spack_kernel,
// routed_kernel<..., true>) take a RANGE of shards and sum inside.  The pack
// carries, besides the reference's per-shard planes, an owner plane (the one
// shard that owns each sub-interval, -1 on padding) and each sub-interval's
// base rebased into its owner's slice, (F, n_max) each.  A block stages the
// member's bounds / invd / rebased-base / segs / owner rows (five rows, as
// many as one shard's launch staged before) and the range's values slices
// (one contiguous slab) when they fit kSmemBytes.  Each element runs the
// comparator plane and the cell index once, gathers o = owner[j] and its
// base, and, if o lies in the range, o's pair from o's slice and the lerp:
// since one shard owns j, the S contributions rounded to x's dtype and added
// in shard order in x's dtype have a closed form (tl::sharded_sum), bit for
// bit the S single-shard outputs added.
//
// Bound: bytes, as the replicated kernel's (x read once, the output written
// once, the member's rows and the range's slices), and at the decode gate the
// launch: one launch a call replaces S launches and S - 1 elementwise adds,
// and j is computed once instead of S times.  Two Hopper steps, each kept
// where tools/torch_kernel_ab.py timed it faster: on an uncapped grid (the
// decode gate) the values slab is staged by one 1-D TMA bulk copy
// (cp.async.bulk, completion on an mbarrier) where its address and size are
// 16-byte multiples, instead of the register-batched loop, whose round trips
// bound the staging (on a capped grid the loop was faster); once the grid is
// capped (the training gate, prefill) x and the outputs move in 16-byte
// vectors (8 bf16 or 4 f32 a thread), a scalar tail after.
//
// The sharded grads.  They run at the training gate (3.5 M bf16 elements,
// the grid capped at kBlocksPerSM blocks a multiprocessor, ~26 elements a
// thread), so a thread's instructions an element and the bytes it keeps in
// flight set their pace, not the staging.  Over all the shards (what their
// wrappers launch: one launch a call, where S single-shard launches and
// S - 1 adds of each output moved ~10x the bytes) the static and the routed grad
// stage the pack's staging image (ShardedTablePack.image: a header of row
// starts, each member's row of (invd, owner-rebased base, segs, owner)
// quads over its real sub-intervals and its boundaries, then the S values
// slices; 5,584 bytes in stablelm's 4-shard pack) in one round trip of
// 16-byte loads with each thread's first x in flight, move x, y and the
// slope in 16-byte chunks, scan each boundary once for a chunk's
// elements, read the
// four gathers after the selector in one 16-byte shared access and round
// each output once (spack_image_kernel; a routed row of another member is
// another row of the image).  Past the budget the grads run spack_kernel
// and routed_kernel<..., true> over the range, as the value kernels do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "range_reduce.cuh"
#include "table_lookup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // dynamic shared memory without opt-in
constexpr int kBlocksPerSM = 4;

enum Mode { kValue = 0, kFlash = 1, kGrad = 2, kSlope = 3 };
// what a block stages in shared memory (chosen by the launch)
enum Stage { kStageNone = 0, kStageMeta = 1, kStageAll = 2 };

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Staging is latency-bound: a block waits one global-memory (L2) round trip
// for each batch of loads, before the stores that consume them.  So
// both helpers load a whole batch into registers first and store after, and
// the metadata row is staged by one loop over all its segments together.
constexpr int kStageUnroll = 4;  // entries a thread loads per batch

// Copy `count` entries from global `src` into shared `dst` (all threads of the
// block, kUnroll loads in flight per thread); returns dst, or src itself
// when `stage` is false.
template <typename E, int kUnroll = kStageUnroll>
__device__ __forceinline__ const E* stage_copy(E* dst, const E* src, int count,
                                               bool stage) {
  if (!stage) return src;
  for (int k0 = threadIdx.x; k0 < count; k0 += kUnroll * blockDim.x) {
    E v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * blockDim.x;
      v[u] = k < count ? src[k] : E();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < count) dst[k] = v[u];
    }
  }
  return dst;
}

// Stage the kSeg f32 segments of one member's metadata row back to back at
// `dst`, one loop over the longest, and point `seg` at the staged copies.
// Left at their global sources when `stage` is false.
template <int kSeg>
__device__ __forceinline__ void stage_row(float* dst, const float* (&seg)[kSeg],
                                          const int (&count)[kSeg], bool stage) {
  if (!stage) return;
  float* to[kSeg];
  int longest = 0;
  long long off = 0;
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    to[q] = dst + off;
    off += count[q];
    longest = count[q] > longest ? count[q] : longest;
  }
  for (int k = threadIdx.x; k < longest; k += blockDim.x) {
    float v[kSeg];
#pragma unroll
    for (int q = 0; q < kSeg; ++q) v[q] = k < count[q] ? seg[q][k] : 0.0f;
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      if (k < count[q]) to[q][k] = v[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kSeg; ++q) seg[q] = to[q];
}

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// ---- f32 pack / single table ------------------------------------------------

// `slope` is written only in kGrad mode (nullptr otherwise).
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
            long long n, const float* __restrict__ bounds,
            const float* __restrict__ invd, const float* __restrict__ base,
            const float* __restrict__ segs, const float* __restrict__ values,
            int fn_id, int n_max, int n_intervals, int m, int extrapolate,
            int stage) {
  extern __shared__ float smem[];
  const long long row = static_cast<long long>(fn_id) * n_max;
  const float* seg[4] = {bounds + static_cast<long long>(fn_id) * (n_max + 1),
                         invd + row, base + row, segs + row};
  const int count[4] = {n_max + 1, n_max, n_max, n_max};
  stage_row(smem, seg, count, stage >= kStageMeta);
  const float* vals = stage_copy(smem + 4 * n_max + 1, values, m, stage == kStageAll);
  __syncthreads();
  const tl::Row r{seg[0], seg[1], seg[2], seg[3], n_max, n_intervals};

  for (long long idx = first_index(); idx < n; idx += grid_stride()) {
    const float xv = load_f32(x, idx);
    if (kMode == kGrad) {
      float d;
      const float y = tl::lookup_grad(xv, r, vals, m, extrapolate != 0, &d);
      store_f32(out, idx, y);
      store_f32(slope, idx, d);
    } else {
      const float y = kMode == kFlash ? tl::tableflash(xv, r, vals, m)
                                      : tl::lookup(xv, r, vals, m, extrapolate != 0);
      store_f32(out, idx, y);
    }
  }
}

// ---- sharded pack: a range of shards, summed -------------------------------

// Rounds an f32 to the output dtype T and back (the sum's rounding after every
// add, tl::sharded_sum).
template <typename T>
struct RoundTo {
  __host__ __device__ float operator()(float v) const { return v; }
};
template <>
struct RoundTo<__nv_bfloat16> {
  __host__ __device__ float operator()(float v) const {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// Floats of a member's staged sharded rows: bounds (n_max + 1), invd, the
// owner-rebased base, segs and the owner row (n_max each), rounded up to a
// 16-byte multiple so that the values slab behind them is 16-byte aligned.
__host__ __device__ __forceinline__ long long shard_meta_floats(int n_max) {
  return (5LL * n_max + 1 + 3) / 4 * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage the S values slices, one contiguous slab of `count` f32, at `dst`:
// with `allow_bulk`, thread 0 starts ONE 1-D TMA bulk copy (cp.async.bulk
// into shared memory, completion counted in bytes on the mbarrier `bar`) when
// the source, the destination and the byte count are 16-byte multiples;
// otherwise the block runs stage_copy's register-batched loop.  Returns
// whether a bulk copy is in flight (the same answer in every thread): the
// block must then pass a __syncthreads (which publishes the barrier's init)
// and slab_wait before it reads the slab.
__device__ __forceinline__ bool slab_start(float* dst, const float* src, int count,
                                           bool allow_bulk, uint64_t* bar) {
  const uint32_t bytes = 4u * static_cast<uint32_t>(count);
  const bool bulk = allow_bulk && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                    bytes % 16 == 0 && smem_addr(dst) % 16 == 0;
  if (!bulk) {
    stage_copy(dst, src, count, true);
    return false;
  }
  if (threadIdx.x == 0) {
    const uint32_t b = smem_addr(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(b)
        : "memory");
  }
  return true;
}

// Wait for phase 0 of `bar`: the bulk copy's bytes have all landed.
__device__ __forceinline__ void slab_wait(uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  } while (!done);
}

// 16 bytes of x or an output as four 32-bit words: element k (of 4 f32 or 8
// bf16) as f32, and its store with round to nearest even.
__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}
__device__ __forceinline__ void set_word(uint4& w, int i, uint32_t v) {
  if (i == 0) w.x = v;
  else if (i == 1) w.y = v;
  else if (i == 2) w.z = v;
  else w.w = v;
}
template <typename T>
__device__ __forceinline__ float vec_get(const uint4& w, int k) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(w, k));
  } else {
    const uint32_t u = word(w, k / 2);
    return __uint_as_float(k % 2 ? u & 0xffff0000u : u << 16);
  }
}
template <typename T>
__device__ __forceinline__ void vec_put(uint4& w, int k, float v) {
  if constexpr (sizeof(T) == 4) {
    set_word(w, k, __float_as_uint(v));
  } else {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    const uint32_t u = word(w, k / 2);
    set_word(w, k / 2, k % 2 ? (u & 0xffffu) | (h << 16) : (u & 0xffff0000u) | h);
  }
}

// Replaces _spack_kernel and _spack_grad_kernel
// (src/repro/kernels/table_pack_lookup.py:663, :697) and the sum over their
// per-shard outputs (_sharded_sum_pallas, :803).  Bound: bytes, and the
// launch at the decode gate; one launch sums the range (see ShardedPack
// above).
// Shards [s_begin, s_begin + n_shards) of member fn_id: `obase` / `owner`
// are the pack's (F, n_max) owner-rebased-base and owner planes, `values`
// points at shard s_begin's padded slice of m entries, the next shard's m
// on.  kValue writes the summed lerp, kSlope the summed slope (the value
// kernel's slope mode), kGrad both (launched over one shard).  `vec`: x and
// the outputs are 16-byte aligned and move in 16-byte vectors; `bulk`: the
// values slab may be staged by a TMA bulk copy.  kSum: the range is longer
// than one shard (chosen by the launch, so a range of one carries no
// rounding).
template <typename T, int kMode, bool kSum>
__global__ void __launch_bounds__(kThreads)
spack_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
             long long n, const float* __restrict__ bounds,
             const float* __restrict__ invd, const float* __restrict__ obase,
             const float* __restrict__ segs, const float* __restrict__ owner,
             const float* __restrict__ values, int fn_id, int n_max, int n_intervals,
             int m, int s_begin, int n_shards, int extrapolate, int stage, int vec,
             int bulk) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  const long long row = static_cast<long long>(fn_id) * n_max;
  const long long meta = shard_meta_floats(n_max);
  const bool in_flight = stage == kStageAll &&
                         slab_start(smem + meta, values, n_shards * m, bulk, &bar);
  const float* seg[5] = {bounds + static_cast<long long>(fn_id) * (n_max + 1),
                         invd + row, obase + row, segs + row, owner + row};
  const int count[5] = {n_max + 1, n_max, n_max, n_max, n_max};
  stage_row(smem, seg, count, stage >= kStageMeta);
  __syncthreads();
  if (in_flight) slab_wait(&bar);
  const tl::Row r{seg[0], seg[1], seg[2], seg[3], n_max, n_intervals};
  const tl::ShardRows sh{seg[4], stage == kStageAll ? smem + meta : values, s_begin,
                         n_shards, m};
  const bool ex = extrapolate != 0;
  const RoundTo<T> round;

  // one element's summed value (kValue, kGrad) or slope (kSlope); kGrad's
  // slope into *d
  auto eval = [&](float xv, float* d) {
    if (kMode == kValue) return tl::sharded_sum<kSum>(xv, r, sh, ex, round, nullptr);
    const float y = tl::sharded_sum<kSum>(xv, r, sh, ex, round, d);
    return kMode == kGrad ? y : *d;
  };
  long long first = 0;
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const long long nv = n / kVec;
    for (long long q = first_index(); q < nv; q += grid_stride()) {
      const uint4 xw = reinterpret_cast<const uint4*>(x)[q];
      uint4 yw = make_uint4(0, 0, 0, 0), dw = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        float d = 0.0f;
        vec_put<T>(yw, k, eval(vec_get<T>(xw, k), &d));
        if (kMode == kGrad) vec_put<T>(dw, k, d);
      }
      reinterpret_cast<uint4*>(out)[q] = yw;
      if (kMode == kGrad) reinterpret_cast<uint4*>(slope)[q] = dw;
    }
    first = nv * kVec;
  }
  for (long long idx = first + first_index(); idx < n; idx += grid_stride()) {
    float d = 0.0f;
    store_f32(out, idx, eval(load_f32(x, idx), &d));
    if (kMode == kGrad) store_f32(slope, idx, d);
  }
}

// ---- quantized pack -----------------------------------------------------------

template <typename T, typename C, int kMode>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
             long long n, const float* __restrict__ bounds,
             const float* __restrict__ invd, const float* __restrict__ base,
             const float* __restrict__ segs, const float* __restrict__ scale,
             const float* __restrict__ zero, const float* __restrict__ ramp,
             const C* __restrict__ codes, int bo, int lo, int n_intervals, int m,
             int extrapolate, int stage) {
  extern __shared__ float smem[];
  const int nn = n_intervals;
  const float* seg[7] = {bounds + bo, invd + lo, base + lo, segs + lo,
                         scale + lo, zero + lo, ramp + lo};
  const int count[7] = {nn + 1, nn, nn, nn, nn, nn, nn};
  stage_row(smem, seg, count, stage >= kStageMeta);
  const C* cd = stage_copy(reinterpret_cast<C*>(smem + 7 * nn + 1), codes, m,
                           stage == kStageAll);
  __syncthreads();
  const tl::QuantRow r{seg[0], seg[1], seg[2], seg[3], seg[4], seg[5], seg[6], nn};

  for (long long idx = first_index(); idx < n; idx += grid_stride()) {
    const float xv = load_f32(x, idx);
    if (kMode == kGrad) {
      float d;
      store_f32(out, idx, tl::quant_lookup(xv, r, cd, m, extrapolate != 0, &d));
      store_f32(slope, idx, d);
    } else {
      store_f32(out, idx, tl::quant_lookup(xv, r, cd, m, extrapolate != 0,
                                           static_cast<float*>(nullptr)));
    }
  }
}

// ---- polynomial pack ----------------------------------------------------------

template <typename T, typename C, int kMode>
__global__ void __launch_bounds__(kThreads)
poly_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
            long long n, const float* __restrict__ bounds,
            const float* __restrict__ invd, const float* __restrict__ base,
            const float* __restrict__ segs, const float* __restrict__ zero,
            const float* __restrict__ ramp, const float* __restrict__ scale,
            const C* __restrict__ codes, int bo, int lo, int n_intervals,
            int lmax, int degree, int m, int extrapolate, int stage) {
  extern __shared__ float smem[];
  const int nn = n_intervals;
  const int nl = nn * lmax;
  const long long lane0 = static_cast<long long>(lo) * lmax;
  const float* seg[7] = {bounds + bo, invd + lo, base + lo, segs + lo,
                         zero + lane0, ramp + lane0, scale + lane0};
  const int count[7] = {nn + 1, nn, nn, nn, nl, nl, nl};
  stage_row(smem, seg, count, stage >= kStageMeta);
  const C* cd = stage_copy(reinterpret_cast<C*>(smem + 4 * nn + 1 + 3 * nl), codes, m,
                           stage == kStageAll);
  __syncthreads();
  const tl::PolyRow r{seg[0], seg[1], seg[2], seg[3], seg[4], seg[5], seg[6],
                      nn, lmax, degree};

  for (long long idx = first_index(); idx < n; idx += grid_stride()) {
    const float xv = load_f32(x, idx);
    if (kMode == kGrad) {
      float d;
      store_f32(out, idx, tl::poly_lookup(xv, r, cd, m, extrapolate != 0, &d));
      store_f32(slope, idx, d);
    } else {
      store_f32(out, idx, tl::poly_lookup(xv, r, cd, m, extrapolate != 0,
                                          static_cast<float*>(nullptr)));
    }
  }
}

// ---- routed dispatch ----------------------------------------------------------

constexpr int kRoutedTile = kThreads;  // columns of one work item

// A block's share of the (row, column tile) work items.
struct RoutedWork {
  long long cols;   // columns of a row (x's trailing axes, flattened)
  long long tiles;  // column tiles of a row
  long long per;    // work items of one block (a contiguous run)
  long long items;  // rows * tiles
};

__device__ __forceinline__ int routed_fid(const int* ids, long long r, int n_fn) {
  const int f = ids[r];
  return f < 0 ? 0 : (f > n_fn - 1 ? n_fn - 1 : f);
}

// Walk this block's run of work items row by row: `restage(fid)` runs between
// two barriers where the run enters a row of another member (the id is read
// by every thread of the block, so the branch is uniform), `body(r, c0, c1)`
// over the run's columns [c0, c1) of row r.  One division a block and one id
// load a row: the per-element loop carries no dispatch work.
template <typename Restage, typename Body>
__device__ __forceinline__ void routed_walk(const RoutedWork& w, const int* ids,
                                            int n_fn, Restage restage, Body body) {
  const long long w0 = static_cast<long long>(blockIdx.x) * w.per;
  long long left = w0 + w.per < w.items ? w.per : w.items - w0;  // tiles to do
  long long r = w0 / w.tiles;
  long long t = w0 - r * w.tiles;  // first tile within row r
  int staged = -1;
  while (left > 0) {
    const int fid = routed_fid(ids, r, n_fn);
    if (fid != staged) {
      __syncthreads();  // every thread is done with the previous member's row
      restage(fid);
      __syncthreads();
      staged = fid;
    }
    const long long n = w.tiles - t < left ? w.tiles - t : left;
    const long long c0 = t * kRoutedTile;
    const long long c1 = c0 + n * kRoutedTile;
    body(r, c0, c1 < w.cols ? c1 : w.cols);
    left -= n;
    ++r;
    t = 0;
  }
}

// Replaces _routed_kernel / _routed_grad_kernel
// (src/repro/kernels/routed_pack_lookup.py:101, :126) and, kSharded,
// _sharded_routed_kernel / _sharded_routed_grad_kernel (:451, :480) with the
// sum over their per-shard outputs (_sharded_routed_sum, :529).  Bound:
// bytes, and the launch at the decode gate.
// kSharded: shards [s_begin, s_begin + n_shards) of the sharded pack,
// summed.  `base` is then the owner-rebased-base plane, `owner` the owner
// plane (a fifth metadata row, restaged with the member's) and `values`
// points at shard s_begin's padded slice of m entries, the next shard's m
// on; the range's slices are staged once a block and the body is
// tl::sharded_sum, kSum telling a range longer than one shard (chosen by the
// launch).  Otherwise `owner` is unused (nullptr), s_begin is 0 and
// n_shards 1.
template <typename T, int kMode, bool kSharded, bool kSum = false>
__global__ void __launch_bounds__(kThreads)
routed_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
              RoutedWork w, const int* __restrict__ ids,
              const int* __restrict__ n_arr, const int* __restrict__ extr,
              const float* __restrict__ bounds, const float* __restrict__ invd,
              const float* __restrict__ base, const float* __restrict__ segs,
              const float* __restrict__ values, const float* __restrict__ owner,
              int n_fn, int n_max, int m, int s_begin, int n_shards, int stage,
              int bulk) {
  constexpr int kSeg = kSharded ? 5 : 4;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  const long long meta = kSharded ? shard_meta_floats(n_max) : 4LL * n_max + 1;
  // the values are every member's: staged once (the sharded slab by a bulk
  // copy where it can, awaited in the first restage, behind the metadata;
  // otherwise the first restage's barrier publishes them)
  const float* vals = values;
  bool in_flight = false;
  if constexpr (kSharded) {
    if (stage == kStageAll) {
      vals = smem + meta;
      in_flight = slab_start(smem + meta, values, n_shards * m, bulk, &bar);
    }
  } else {
    vals = stage_copy(smem + meta, values, m, stage == kStageAll);
  }
  const float* seg[kSeg];
  int count[kSeg];
#pragma unroll
  for (int q = 0; q < kSeg; ++q) count[q] = q == 0 ? n_max + 1 : n_max;
  int nf = 0;  // the member's interval count and extrapolate flag, loaded
  bool ex = false;  // in the same round trip as its metadata row
  auto restage = [&](int fid) {
    nf = n_arr[fid];
    ex = extr[fid] != 0;
    const long long row = static_cast<long long>(fid) * n_max;
    seg[0] = bounds + static_cast<long long>(fid) * (n_max + 1);
    seg[1] = invd + row;
    seg[2] = base + row;
    seg[3] = segs + row;
    if constexpr (kSharded) seg[4] = owner + row;
    stage_row(smem, seg, count, stage >= kStageMeta);
    if (in_flight) {  // the first restage: the barrier before it published the init
      slab_wait(&bar);
      in_flight = false;
    }
  };
  const RoundTo<T> round;
  auto body = [&](long long r, long long c0, long long c1) {
    const tl::Row rw{seg[0], seg[1], seg[2], seg[3], n_max, nf};
    for (long long c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
      const long long idx = r * w.cols + c;
      const float xv = load_f32(x, idx);
      if constexpr (kSharded) {
        const tl::ShardRows sh{seg[kSeg - 1], vals, s_begin, n_shards, m};
        float d;
        store_f32(out, idx, tl::sharded_sum<kSum>(xv, rw, sh, ex, round,
                                                  kMode == kGrad ? &d : nullptr));
        if (kMode == kGrad) store_f32(slope, idx, d);
      } else if (kMode == kGrad) {
        float d;
        store_f32(out, idx, tl::lookup_grad(xv, rw, vals, m, ex, &d));
        store_f32(slope, idx, d);
      } else {
        store_f32(out, idx, tl::lookup(xv, rw, vals, m, ex));
      }
    }
  };
  routed_walk(w, ids, n_fn, restage, body);
}

// Columns [c0, c1) of one routed quant row; with `preloaded`, x0 is this
// thread's first x of them, already loaded (the whole-pack kernel issues
// that load before its staging).
template <typename T, typename C, int kMode>
__device__ __forceinline__ void routed_quant_run(const T* x, T* out, T* slope,
                                                 long long row0, long long c0,
                                                 long long c1, const tl::QuantRow& qr,
                                                 const C* cd, int m, bool ex,
                                                 bool preloaded, float x0) {
  for (long long c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    const long long idx = row0 + c;
    const float xv = preloaded ? x0 : load_f32(x, idx);
    preloaded = false;
    if (kMode == kGrad) {
      float d;
      store_f32(out, idx, tl::quant_lookup(xv, qr, cd, m, ex, &d));
      store_f32(slope, idx, d);
    } else {
      store_f32(out, idx, tl::quant_lookup(xv, qr, cd, m, ex,
                                           static_cast<float*>(nullptr)));
    }
  }
}

template <typename T, typename C, int kMode>
__device__ __forceinline__ void routed_quant_cols(const T* x, T* out, T* slope,
                                                  long long row0, long long c0,
                                                  long long c1, const tl::QuantRow& qr,
                                                  const C* cd, int m, bool ex) {
  routed_quant_run<T, C, kMode>(x, out, slope, row0, c0, c1, qr, cd, m, ex, false, 0.0f);
}

// `codes8` / `codes16` are the two width groups (m8 / m16 entries); a row
// reads only its member's group (bits_arr[fid] = 8 or 16), never the other.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
routed_quant_kernel(const T* __restrict__ x, T* __restrict__ out,
                    T* __restrict__ slope, RoutedWork w, const int* __restrict__ ids,
                    const int* __restrict__ n_arr, const int* __restrict__ extr,
                    const int* __restrict__ bo_arr, const int* __restrict__ lo_arr,
                    const int* __restrict__ bits_arr, const float* __restrict__ bounds,
                    const float* __restrict__ invd, const float* __restrict__ base,
                    const float* __restrict__ segs, const float* __restrict__ scale,
                    const float* __restrict__ zero, const float* __restrict__ ramp,
                    const int8_t* __restrict__ codes8,
                    const int16_t* __restrict__ codes16, int n_fn, int max_n, int m8,
                    int m16, int stage) {
  extern __shared__ float smem[];
  float* code_smem = smem + 7 * max_n + 1;
  const float* seg[7];
  int nn = 0, bits = 0;
  bool ex = false;
  const void* cd = nullptr;
  auto restage = [&](int fid) {
    nn = n_arr[fid];
    ex = extr[fid] != 0;
    const int bo = bo_arr[fid], lo = lo_arr[fid];
    seg[0] = bounds + bo;
    seg[1] = invd + lo;
    seg[2] = base + lo;
    seg[3] = segs + lo;
    seg[4] = scale + lo;
    seg[5] = zero + lo;
    seg[6] = ramp + lo;
    const int count[7] = {nn + 1, nn, nn, nn, nn, nn, nn};
    stage_row(smem, seg, count, stage >= kStageMeta);
    const int b = bits_arr[fid] == 8 ? 8 : 16;
    if (b != bits) {  // another width group: stage it in place of the last
      bits = b;
      if (b == 8) {
        cd = stage_copy(reinterpret_cast<int8_t*>(code_smem), codes8, m8,
                        stage == kStageAll);
      } else {
        cd = stage_copy(reinterpret_cast<int16_t*>(code_smem), codes16, m16,
                        stage == kStageAll);
      }
    }
  };
  auto body = [&](long long r, long long c0, long long c1) {
    const tl::QuantRow qr{seg[0], seg[1], seg[2], seg[3], seg[4], seg[5], seg[6], nn};
    if (bits == 8) {
      routed_quant_cols<T, int8_t, kMode>(x, out, slope, r * w.cols, c0, c1, qr,
                                          static_cast<const int8_t*>(cd), m8, ex);
    } else {
      routed_quant_cols<T, int16_t, kMode>(x, out, slope, r * w.cols, c0, c1, qr,
                                           static_cast<const int16_t*>(cd), m16, ex);
    }
  };
  routed_walk(w, ids, n_fn, restage, body);
}

// Columns [c0, c1) of one routed poly row; with `preloaded`, x0 is this
// thread's first x of them, already loaded (the whole-pack kernel issues
// that load before its staging).
template <typename T, typename C, int kMode>
__device__ __forceinline__ void routed_poly_run(const T* x, T* out, T* slope,
                                                long long row0, long long c0,
                                                long long c1, const tl::PolyRow& pr,
                                                const C* cd, int m, bool ex,
                                                bool preloaded, float x0) {
  for (long long c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    const long long idx = row0 + c;
    const float xv = preloaded ? x0 : load_f32(x, idx);
    preloaded = false;
    if (kMode == kGrad) {
      float d;
      store_f32(out, idx, tl::poly_lookup(xv, pr, cd, m, ex, &d));
      store_f32(slope, idx, d);
    } else {
      store_f32(out, idx, tl::poly_lookup(xv, pr, cd, m, ex,
                                          static_cast<float*>(nullptr)));
    }
  }
}

template <typename T, typename C, int kMode>
__device__ __forceinline__ void routed_poly_cols(const T* x, T* out, T* slope,
                                                 long long row0, long long c0,
                                                 long long c1, const tl::PolyRow& pr,
                                                 const C* cd, int m, bool ex) {
  routed_poly_run<T, C, kMode>(x, out, slope, row0, c0, c1, pr, cd, m, ex, false, 0.0f);
}

// `codes8` / `codes16` / `codes32` are the three width groups (m8 / m16 / m32
// entries); a row reads only its member's group (bits_arr[fid] = 8, 16 or 32)
// at its member's stride (stride_arr[fid] = degree + 1).
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
routed_poly_kernel(const T* __restrict__ x, T* __restrict__ out,
                   T* __restrict__ slope, RoutedWork w, const int* __restrict__ ids,
                   const int* __restrict__ n_arr, const int* __restrict__ extr,
                   const int* __restrict__ bo_arr, const int* __restrict__ lo_arr,
                   const int* __restrict__ bits_arr, const int* __restrict__ stride_arr,
                   const float* __restrict__ bounds, const float* __restrict__ invd,
                   const float* __restrict__ base, const float* __restrict__ segs,
                   const float* __restrict__ zero, const float* __restrict__ ramp,
                   const float* __restrict__ scale, const int8_t* __restrict__ codes8,
                   const int16_t* __restrict__ codes16,
                   const float* __restrict__ codes32, int n_fn, int max_n, int lmax,
                   int m8, int m16, int m32, int stage) {
  extern __shared__ float smem[];
  float* code_smem = smem + 4 * max_n + 1 + 3 * max_n * lmax;
  const float* seg[7];
  int nn = 0, bits = 0, degree = 1;
  bool ex = false;
  const void* cd = nullptr;
  auto restage = [&](int fid) {
    nn = n_arr[fid];
    ex = extr[fid] != 0;
    degree = stride_arr[fid] - 1;
    const int bo = bo_arr[fid], lo = lo_arr[fid];
    const long long lane0 = static_cast<long long>(lo) * lmax;
    seg[0] = bounds + bo;
    seg[1] = invd + lo;
    seg[2] = base + lo;
    seg[3] = segs + lo;
    seg[4] = zero + lane0;
    seg[5] = ramp + lane0;
    seg[6] = scale + lane0;
    const int nl = nn * lmax;
    const int count[7] = {nn + 1, nn, nn, nn, nl, nl, nl};
    stage_row(smem, seg, count, stage >= kStageMeta);
    const int b = bits_arr[fid] == 8 ? 8 : (bits_arr[fid] == 16 ? 16 : 32);
    if (b != bits) {  // another width group: stage it in place of the last
      bits = b;
      if (b == 8) {
        cd = stage_copy(reinterpret_cast<int8_t*>(code_smem), codes8, m8,
                        stage == kStageAll);
      } else if (b == 16) {
        cd = stage_copy(reinterpret_cast<int16_t*>(code_smem), codes16, m16,
                        stage == kStageAll);
      } else {
        cd = stage_copy(code_smem, codes32, m32, stage == kStageAll);
      }
    }
  };
  auto body = [&](long long r, long long c0, long long c1) {
    const tl::PolyRow pr{seg[0], seg[1], seg[2], seg[3], seg[4], seg[5], seg[6],
                         nn, lmax, degree};
    if (bits == 8) {
      routed_poly_cols<T, int8_t, kMode>(x, out, slope, r * w.cols, c0, c1, pr,
                                         static_cast<const int8_t*>(cd), m8, ex);
    } else if (bits == 16) {
      routed_poly_cols<T, int16_t, kMode>(x, out, slope, r * w.cols, c0, c1, pr,
                                          static_cast<const int16_t*>(cd), m16, ex);
    } else {
      routed_poly_cols<T, float, kMode>(x, out, slope, r * w.cols, c0, c1, pr,
                                        static_cast<const float*>(cd), m32, ex);
    }
  };
  routed_walk(w, ids, n_fn, restage, body);
}

// Sections of a polynomial pack's staging image (PolyTablePack.image, laid
// out by approx/table_pack.py poly_image_layout), in 32-bit words from its
// start: the routing operands, the metadata lanes and the three code groups;
// `words` is the image's length.
struct PolyImage {
  long long n_arr, bo, lo, bits, strides, bounds, invd, base, segs, zero, ramp, scale,
      c32, c16, c8, words;
};

__host__ __device__ __forceinline__ long long image_take(long long* at, long long words) {
  const long long start = *at;
  *at += words;
  return start;
}

// n_sub: the pack's sub-intervals (every member's); lmax its lanes; m8 /
// m16 / m32 its code groups' entries.
__host__ __device__ __forceinline__ PolyImage poly_image(int n_fn, int n_sub, int lmax,
                                                         int m8, int m16, int m32) {
  PolyImage p;
  long long at = 0;
  const long long nl = static_cast<long long>(n_sub) * lmax;
  p.n_arr = image_take(&at, n_fn);
  p.bo = image_take(&at, n_fn);
  p.lo = image_take(&at, n_fn);
  p.bits = image_take(&at, n_fn);
  p.strides = image_take(&at, n_fn);
  p.bounds = image_take(&at, static_cast<long long>(n_sub) + n_fn);
  p.invd = image_take(&at, n_sub);
  p.base = image_take(&at, n_sub);
  p.segs = image_take(&at, n_sub);
  p.zero = image_take(&at, nl);
  p.ramp = image_take(&at, nl);
  p.scale = image_take(&at, nl);
  p.c32 = image_take(&at, m32);
  p.c16 = image_take(&at, (m16 + 1LL) / 2);
  p.c8 = image_take(&at, (m8 + 3LL) / 4);
  p.words = at;
  return p;
}

// The routed poly kernel where the whole pack fits kSmemBytes (the launch
// decides): every block stages the pack's staging image (one register-batched
// loop: tools/torch_kernel_ab.py timed it 0.13 us faster at the decode gate
// than one TMA bulk copy of stablelm's 2.2 KB) and the call's per-member
// extrapolate flags, with this block's first id and each thread's first x
// already in flight; entering another member's row then only points at
// other sections of shared memory (no loads, no barrier), and the next row's
// id is loaded while this row runs.  The per-element body is
// routed_poly_kernel's, at the member's own degree.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
routed_poly_pack_kernel(const T* __restrict__ x, T* __restrict__ out,
                        T* __restrict__ slope, RoutedWork w, const int* __restrict__ ids,
                        const int* __restrict__ extr, const int* __restrict__ image,
                        PolyImage im, int n_fn, int lmax, int m8, int m16, int m32) {
  extern __shared__ __align__(16) float smem[];
  const int* si = reinterpret_cast<const int*>(smem);
  int* sflags = reinterpret_cast<int*>(smem + im.words);
  const long long w0 = static_cast<long long>(blockIdx.x) * w.per;
  long long left = w0 + w.per < w.items ? w.per : w.items - w0;  // tiles to do
  long long r = w0 / w.tiles;
  long long t = w0 - r * w.tiles;  // first tile within row r
  // in flight while the image lands: the first row's id, this thread's first
  // x and the flags
  int id = ids[r];
  const long long c_first = t * kRoutedTile + threadIdx.x;
  const float x_first = c_first < w.cols ? load_f32(x, r * w.cols + c_first) : 0.0f;
  const int flag = threadIdx.x < n_fn ? extr[threadIdx.x] : 0;
  stage_copy(smem, reinterpret_cast<const float*>(image), static_cast<int>(im.words),
             true);
  if (threadIdx.x < n_fn) sflags[threadIdx.x] = flag;
  for (int k = threadIdx.x + blockDim.x; k < n_fn; k += blockDim.x) sflags[k] = extr[k];
  __syncthreads();
  bool first = true;
  while (left > 0) {
    const int fid = id < 0 ? 0 : (id > n_fn - 1 ? n_fn - 1 : id);
    const long long nt = w.tiles - t < left ? w.tiles - t : left;
    if (left > nt) id = ids[r + 1];  // the next row's, loaded while this row runs
    const int nn = si[im.n_arr + fid];
    const int bo = si[im.bo + fid], lo = si[im.lo + fid];
    const bool ex = sflags[fid] != 0;
    const long long lane0 = static_cast<long long>(lo) * lmax;
    const tl::PolyRow pr{smem + im.bounds + bo, smem + im.invd + lo, smem + im.base + lo,
                         smem + im.segs + lo, smem + im.zero + lane0,
                         smem + im.ramp + lane0, smem + im.scale + lane0,
                         nn, lmax, si[im.strides + fid] - 1};
    const long long c0 = t * kRoutedTile;
    const long long c1 = c0 + nt * kRoutedTile < w.cols ? c0 + nt * kRoutedTile : w.cols;
    const int bits = si[im.bits + fid];
    if (bits == 8) {
      routed_poly_run<T, int8_t, kMode>(x, out, slope, r * w.cols, c0, c1, pr,
                                        reinterpret_cast<const int8_t*>(smem + im.c8),
                                        m8, ex, first, x_first);
    } else if (bits == 16) {
      routed_poly_run<T, int16_t, kMode>(x, out, slope, r * w.cols, c0, c1, pr,
                                         reinterpret_cast<const int16_t*>(smem + im.c16),
                                         m16, ex, first, x_first);
    } else {
      routed_poly_run<T, float, kMode>(x, out, slope, r * w.cols, c0, c1, pr,
                                       smem + im.c32, m32, ex, first, x_first);
    }
    first = false;
    left -= nt;
    ++r;
    t = 0;
  }
}

// Sections of a quantized pack's staging image (QuantTablePack.image, laid
// out by approx/table_pack.py quant_image_layout), in 32-bit words from its
// start: the routing operands, the metadata lanes and the two code groups;
// `words` is the image's length.
struct QuantImage {
  long long n_arr, bo, lo, bits, bounds, invd, base, segs, scale, zero, ramp, c16, c8,
      words;
};

// n_sub: the pack's sub-intervals (every member's); m8 / m16 its code
// groups' entries.
__host__ __device__ __forceinline__ QuantImage quant_image(int n_fn, int n_sub, int m8,
                                                           int m16) {
  QuantImage q;
  long long at = 0;
  q.n_arr = image_take(&at, n_fn);
  q.bo = image_take(&at, n_fn);
  q.lo = image_take(&at, n_fn);
  q.bits = image_take(&at, n_fn);
  q.bounds = image_take(&at, static_cast<long long>(n_sub) + n_fn);
  q.invd = image_take(&at, n_sub);
  q.base = image_take(&at, n_sub);
  q.segs = image_take(&at, n_sub);
  q.scale = image_take(&at, n_sub);
  q.zero = image_take(&at, n_sub);
  q.ramp = image_take(&at, n_sub);
  q.c16 = image_take(&at, (m16 + 1LL) / 2);
  q.c8 = image_take(&at, (m8 + 3LL) / 4);
  q.words = at;
  return q;
}

// Image words a thread loads in one batch: stablelm's quant image (1,161
// words) lands in one round trip of 8 loads a thread, where the 4 of
// stage_copy's default take two (tools/torch_kernel_ab.py: 0.26 us faster
// at the decode gate, and 0.17 us faster than one TMA bulk copy).
constexpr int kQuantImageUnroll = 8;

// The routed quant kernel where the whole pack fits kSmemBytes (the launch
// decides), as routed_poly_pack_kernel: every block stages the pack's
// staging image (one register-batched loop of kQuantImageUnroll loads a
// thread) and the call's per-member extrapolate flags, with this block's
// first id and each thread's first x already in flight; entering another
// member's row then only points at other sections of shared memory (no
// loads, no barrier), and the next row's id is loaded while this row runs.
// The per-element body is routed_quant_kernel's.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
routed_quant_pack_kernel(const T* __restrict__ x, T* __restrict__ out,
                         T* __restrict__ slope, RoutedWork w, const int* __restrict__ ids,
                         const int* __restrict__ extr, const int* __restrict__ image,
                         QuantImage im, int n_fn, int m8, int m16) {
  extern __shared__ __align__(16) float smem[];
  const int* si = reinterpret_cast<const int*>(smem);
  int* sflags = reinterpret_cast<int*>(smem + im.words);
  const long long w0 = static_cast<long long>(blockIdx.x) * w.per;
  long long left = w0 + w.per < w.items ? w.per : w.items - w0;  // tiles to do
  long long r = w0 / w.tiles;
  long long t = w0 - r * w.tiles;  // first tile within row r
  // in flight while the image lands: the first row's id, this thread's first
  // x and the flags
  int id = ids[r];
  const long long c_first = t * kRoutedTile + threadIdx.x;
  const float x_first = c_first < w.cols ? load_f32(x, r * w.cols + c_first) : 0.0f;
  const int flag = threadIdx.x < n_fn ? extr[threadIdx.x] : 0;
  stage_copy<int, kQuantImageUnroll>(reinterpret_cast<int*>(smem), image,
                                     static_cast<int>(im.words), true);
  if (threadIdx.x < n_fn) sflags[threadIdx.x] = flag;
  for (int k = threadIdx.x + blockDim.x; k < n_fn; k += blockDim.x) sflags[k] = extr[k];
  __syncthreads();
  bool first = true;
  while (left > 0) {
    const int fid = id < 0 ? 0 : (id > n_fn - 1 ? n_fn - 1 : id);
    const long long nt = w.tiles - t < left ? w.tiles - t : left;
    if (left > nt) id = ids[r + 1];  // the next row's, loaded while this row runs
    const int bo = si[im.bo + fid], lo = si[im.lo + fid];
    const tl::QuantRow qr{smem + im.bounds + bo, smem + im.invd + lo, smem + im.base + lo,
                          smem + im.segs + lo,   smem + im.scale + lo, smem + im.zero + lo,
                          smem + im.ramp + lo,   si[im.n_arr + fid]};
    const bool ex = sflags[fid] != 0;
    const long long c0 = t * kRoutedTile;
    const long long c1 = c0 + nt * kRoutedTile < w.cols ? c0 + nt * kRoutedTile : w.cols;
    if (si[im.bits + fid] == 8) {
      routed_quant_run<T, int8_t, kMode>(x, out, slope, r * w.cols, c0, c1, qr,
                                         reinterpret_cast<const int8_t*>(smem + im.c8),
                                         m8, ex, first, x_first);
    } else {
      routed_quant_run<T, int16_t, kMode>(x, out, slope, r * w.cols, c0, c1, qr,
                                          reinterpret_cast<const int16_t*>(smem + im.c16),
                                          m16, ex, first, x_first);
    }
    first = false;
    left -= nt;
    ++r;
    t = 0;
  }
}

// The static quant kernels where the pack's staging image
// (QuantTablePack.image, the one the routed quant kernels stage: 1,161
// words in stablelm's pack, one batch of kQuantImageUnroll loads a thread)
// fits kSmemBytes (the launch decides), as poly_image_kernel: each thread's
// first x load is issued before the staging, which is ONE round trip, where
// quant_kernel took two dependent ones (the member's seven lanes, then its
// whole width group) before its first x load.  The member's lanes are
// addressed from the launch's offsets (bo, lo) into the image's planes, its
// codes in its width group's section (C: int8_t or int16_t), every address
// global into the group as in quant_kernel; the grid-stride loop loads the
// next x before this one's arithmetic.  The body is quant_kernel's over the
// same numbers at other addresses: the same bits.
template <typename T, typename C, int kMode>
__global__ void __launch_bounds__(kThreads)
quant_image_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
                   long long n, const int* __restrict__ image, QuantImage im, int bo,
                   int lo, int n_intervals, int m, int extrapolate) {
  extern __shared__ __align__(16) float smem[];
  long long idx = first_index();
  float xv = idx < n ? load_f32(x, idx) : 0.0f;  // in flight while the image lands
  stage_copy<int, kQuantImageUnroll>(reinterpret_cast<int*>(smem), image,
                                     static_cast<int>(im.words), true);
  __syncthreads();
  const tl::QuantRow r{smem + im.bounds + bo, smem + im.invd + lo, smem + im.base + lo,
                       smem + im.segs + lo,   smem + im.scale + lo, smem + im.zero + lo,
                       smem + im.ramp + lo,   n_intervals};
  const C* cd = reinterpret_cast<const C*>(smem + (sizeof(C) == 1 ? im.c8 : im.c16));
  const bool ex = extrapolate != 0;
  const long long stride = grid_stride();
  for (; idx < n; idx += stride) {
    const float xn = idx + stride < n ? load_f32(x, idx + stride) : 0.0f;
    if (kMode == kGrad) {
      float d;
      store_f32(out, idx, tl::quant_lookup(xv, r, cd, m, ex, &d));
      store_f32(slope, idx, d);
    } else {
      store_f32(out, idx, tl::quant_lookup(xv, r, cd, m, ex,
                                           static_cast<float*>(nullptr)));
    }
    xv = xn;
  }
}

// ---- RangeFold ----------------------------------------------------------------

// The f32 pack's core rows fid_a and fid_b (equal for exp and log) are staged
// back to back, then the values.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
folded_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
              long long n, const float* __restrict__ bounds,
              const float* __restrict__ invd, const float* __restrict__ base,
              const float* __restrict__ segs, const float* __restrict__ values,
              int fid_a, int fid_b, int n_max, int n_a, int n_b, int m, int kind,
              int stage) {
  extern __shared__ float smem[];
  const int row_floats = 4 * n_max + 1;
  const int count[4] = {n_max + 1, n_max, n_max, n_max};
  const long long ra = static_cast<long long>(fid_a) * n_max;
  const long long rb = static_cast<long long>(fid_b) * n_max;
  const float* sa[4] = {bounds + static_cast<long long>(fid_a) * (n_max + 1),
                        invd + ra, base + ra, segs + ra};
  const float* sb[4] = {bounds + static_cast<long long>(fid_b) * (n_max + 1),
                        invd + rb, base + rb, segs + rb};
  stage_row(smem, sa, count, stage >= kStageMeta);
  if (fid_b != fid_a) {
    stage_row(smem + row_floats, sb, count, stage >= kStageMeta);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) sb[q] = sa[q];
  }
  const float* vals = stage_copy(smem + 2 * row_floats, values, m, stage == kStageAll);
  __syncthreads();
  const tl::Row a{sa[0], sa[1], sa[2], sa[3], n_max, n_a};
  const tl::Row b{sb[0], sb[1], sb[2], sb[3], n_max, n_b};

  for (long long idx = first_index(); idx < n; idx += grid_stride()) {
    const float xv = load_f32(x, idx);
    if (kMode == kGrad) {
      float d;
      store_f32(out, idx, rr::folded(kind, xv, a, b, vals, m, &d));
      store_f32(slope, idx, d);
    } else {
      store_f32(out, idx, rr::folded(kind, xv, a, b, vals, m,
                                     static_cast<float*>(nullptr)));
    }
  }
}

// A member staging image (TablePack.fold_images or flash_image, laid out by
// approx/table_pack.py member_image_layout): member row a (n_a + 1
// boundaries, then n_a inv_delta, base rebased into the image and
// seg_count), member row b of n_b when the image holds two (the trig
// cores), then the members' values, padded to a 16-byte multiple.  Where
// the values start, and the image's f32 words:
__host__ __device__ __forceinline__ int image_values_at(int n_a, int n_b, bool two) {
  return 4 * n_a + 1 + (two ? 4 * n_b + 1 : 0);
}
__host__ __device__ __forceinline__ long long image_floats(int n_a, int n_b, bool two,
                                                           int m_img) {
  return (image_values_at(n_a, n_b, two) + static_cast<long long>(m_img) + 3) / 4 * 4;
}

// One core row of n sub-intervals at `p` in a staging image.
__device__ __forceinline__ tl::Row image_row(const float* p, int n) {
  return tl::Row{p, p + n + 1, p + 2 * n + 1, p + 3 * n + 1, n, n};
}

// The folded kernels where the kind's staging image fits kSmemBytes (the
// launch decides).  Each thread's first x load is issued before the
// staging, which is ONE round trip for the image (a TMA bulk copy where
// `bulk` and the image is 16-byte aligned, else one register-batched loop);
// the grid-stride loop loads the next x before this one's arithmetic.  The
// loop runs warp by warp (its bound is the warp's first index), so that a
// warp with no lane at |x| >= 2048 skips Payne-Hanek (a vote over all 32
// lanes; the ragged tail's lanes past n vote false).  The image's rows scan
// only their real sub-intervals: the +inf padding of a pack row never moves
// the selector, so the bits are the pack rows'.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
folded_image_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
                    long long n, const float* __restrict__ image, int n_a, int n_b,
                    int m_img, int kind, int bulk) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  const bool trig = kind == rr::kSin || kind == rr::kCos;
  long long idx = first_index();
  float xv = idx < n ? load_f32(x, idx) : 0.0f;  // in flight while the image lands
  const bool in_flight =
      slab_start(smem, image, static_cast<int>(image_floats(n_a, n_b, trig, m_img)),
                 bulk != 0, &bar);
  __syncthreads();
  if (in_flight) slab_wait(&bar);
  const tl::Row a = image_row(smem, n_a);
  const tl::Row b = trig ? image_row(smem + 4 * n_a + 1, n_b) : a;
  const float* vals = smem + image_values_at(n_a, n_b, trig);
  const long long stride = grid_stride();
  for (; idx - threadIdx.x % 32 < n; idx += stride) {
    const bool live = idx < n;
    const float xn = idx + stride < n ? load_f32(x, idx + stride) : 0.0f;
    const bool ph =
        trig && __any_sync(0xffffffffu, live && fabsf(xv) >= rr::kTrigCwMax);
    if (live) {
      if (kMode == kGrad) {
        float d;
        store_f32(out, idx, rr::folded(kind, xv, a, b, vals, m_img, &d, ph));
        store_f32(slope, idx, d);
      } else {
        store_f32(out, idx, rr::folded(kind, xv, a, b, vals, m_img,
                                       static_cast<float*>(nullptr), ph));
      }
    }
    xv = xn;
  }
}

// TableFlash where exp_neg's staging image (TablePack.flash_image: its row
// over its n real sub-intervals, its base rebased into the image, and its
// m_img values) fits kSmemBytes (the launch decides), as folded_image_kernel:
// each thread's first x load is issued before the staging, which is ONE
// round trip (one register-batched loop: tools/torch_kernel_ab.py timed it
// 0.1 us faster than one TMA bulk copy at the decode exponent and 0.4 us at
// prefill), and the grid-stride loop loads the next x before this one's
// arithmetic.  The body is pack_kernel's kFlash one over the image's row and
// values: the same bits (a NaN z's address 0 reads another value than the
// pack's first, and its output is NaN either way).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_image_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                   const float* __restrict__ image, int n_img, int m_img) {
  extern __shared__ __align__(16) float smem[];
  long long idx = first_index();
  float xv = idx < n ? load_f32(x, idx) : 0.0f;  // in flight while the image lands
  stage_copy(smem, image, static_cast<int>(image_floats(n_img, 0, false, m_img)), true);
  __syncthreads();
  const tl::Row r = image_row(smem, n_img);
  const float* vals = smem + image_values_at(n_img, 0, false);
  const long long stride = grid_stride();
  for (; idx < n; idx += stride) {
    const float xn = idx + stride < n ? load_f32(x, idx + stride) : 0.0f;
    store_f32(out, idx, tl::tableflash(xv, r, vals, m_img));
    xv = xn;
  }
}

// ---- staging images: the static f32 pack and table, the static poly pack, the
// routed f32 pack --------------------------------------------------------------

// The static f32 pack and single-table kernels (kValue, kGrad) where the
// staging image fits kSmemBytes (the launch decides), as flash_image_kernel:
// each thread's first x load is issued before the staging, which is ONE
// round trip (one register-batched loop: stablelm's whole-pack image,
// TablePack.image, is 1,020 words, one batch of kStageUnroll loads a
// thread), where pack_kernel took two dependent ones (the member's row at
// n_max, then all the pack's values) before its first x load; the
// grid-stride loop loads the next x before this one's arithmetic.  The
// image is the pack's (every member's row over its real sub-intervals from
// word row_at of its member, then m_img values from word v_at) or a
// table's (its row, then its values).  Its values start at the pack's
// first entry and its bases are the pack's, so every address reads the
// pack's own entry, a NaN x's address 0 too (its extrapolated slope is
// (values[1] - values[0]) * invd[0]); an in-domain or clamped address
// never passes base + segs, inside the image's values.  The row scans only
// its real sub-intervals: the +inf padding of a pack row never moves the
// selector.  So the bits are pack_kernel's.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
pack_image_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
                  long long n, const float* __restrict__ image, int words, int row_at,
                  int v_at, int n_intervals, int m_img, int extrapolate) {
  extern __shared__ __align__(16) float smem[];
  long long idx = first_index();
  float xv = idx < n ? load_f32(x, idx) : 0.0f;  // in flight while the image lands
  stage_copy(smem, image, words, true);
  __syncthreads();
  const tl::Row r = image_row(smem + row_at, n_intervals);
  const float* vals = smem + v_at;
  const bool ex = extrapolate != 0;
  const long long stride = grid_stride();
  for (; idx < n; idx += stride) {
    const float xn = idx + stride < n ? load_f32(x, idx + stride) : 0.0f;
    if (kMode == kGrad) {
      float d;
      store_f32(out, idx, tl::lookup_grad(xv, r, vals, m_img, ex, &d));
      store_f32(slope, idx, d);
    } else {
      store_f32(out, idx, tl::lookup(xv, r, vals, m_img, ex));
    }
    xv = xn;
  }
}

// The static poly kernels where the pack's staging image (PolyTablePack.image,
// the one the routed poly kernels stage: 2,216 bytes in stablelm's pack)
// fits kSmemBytes (the launch decides), as flash_image_kernel: each thread's
// first x load is issued before the staging, which is ONE round trip (one
// register-batched loop), where poly_kernel took two dependent ones (the
// member's seven metadata segments, then its whole code group) before its
// first x load.  The member's sections are addressed from the launch's
// offsets (bo, lo) into the image's planes and its width group's section
// (C: int8_t, int16_t or float); the grid-stride loop loads the next x
// before this one's arithmetic.  The body is poly_kernel's over the same
// numbers at other addresses: the same bits.
template <typename T, typename C, int kMode>
__global__ void __launch_bounds__(kThreads)
poly_image_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
                  long long n, const int* __restrict__ image, PolyImage im, int bo,
                  int lo, int n_intervals, int lmax, int degree, int m,
                  int extrapolate) {
  extern __shared__ __align__(16) float smem[];
  long long idx = first_index();
  float xv = idx < n ? load_f32(x, idx) : 0.0f;  // in flight while the image lands
  stage_copy(reinterpret_cast<int*>(smem), image, static_cast<int>(im.words), true);
  __syncthreads();
  const long long lane0 = static_cast<long long>(lo) * lmax;
  const tl::PolyRow r{smem + im.bounds + bo, smem + im.invd + lo, smem + im.base + lo,
                      smem + im.segs + lo,   smem + im.zero + lane0,
                      smem + im.ramp + lane0, smem + im.scale + lane0,
                      n_intervals, lmax, degree};
  const C* cd = reinterpret_cast<const C*>(
      smem + (sizeof(C) == 1 ? im.c8 : sizeof(C) == 2 ? im.c16 : im.c32));
  const bool ex = extrapolate != 0;
  const long long stride = grid_stride();
  for (; idx < n; idx += stride) {
    const float xn = idx + stride < n ? load_f32(x, idx + stride) : 0.0f;
    if (kMode == kGrad) {
      float d;
      store_f32(out, idx, tl::poly_lookup(xv, r, cd, m, ex, &d));
      store_f32(slope, idx, d);
    } else {
      store_f32(out, idx, tl::poly_lookup(xv, r, cd, m, ex,
                                          static_cast<float*>(nullptr)));
    }
    xv = xn;
  }
}

// Columns [c0, c1) of one routed f32 row; with `preloaded`, x0 is this
// thread's first x of them, already loaded (issued before the staging).
template <typename T, int kMode>
__device__ __forceinline__ void routed_pack_run(const T* x, T* out, T* slope,
                                                long long row0, long long c0,
                                                long long c1, const tl::Row& rw,
                                                const float* vals, int m, bool ex,
                                                bool preloaded, float x0) {
  for (long long c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
    const long long idx = row0 + c;
    const float xv = preloaded ? x0 : load_f32(x, idx);
    preloaded = false;
    if (kMode == kGrad) {
      float d;
      store_f32(out, idx, tl::lookup_grad(xv, rw, vals, m, ex, &d));
      store_f32(slope, idx, d);
    } else {
      store_f32(out, idx, tl::lookup(xv, rw, vals, m, ex));
    }
  }
}

// The routed f32 kernels where the pack's staging image (TablePack.image:
// every member's row over its real sub-intervals, the bases rebased into
// the image, then the values; 4,080 bytes in stablelm's pack) and the
// per-member scalars fit kSmemBytes (the launch decides), as
// routed_quant_pack_kernel: every block stages the image (one
// register-batched loop: stablelm's 1,020 words are one batch of
// kStageUnroll loads a thread) with this block's first id, each thread's
// first x and the members' interval counts, row starts and extrapolate
// flags (one each for the first n_fn threads) already in flight, the
// latter stored behind the image; entering another member's row then only
// points at another row of shared memory (no loads, no barrier), and the
// next row's id is loaded while this row runs.  The image's rows scan only
// their real sub-intervals (the +inf padding of a pack row never moves the
// selector), so every row has routed_kernel's bits.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
routed_pack_image_kernel(const T* __restrict__ x, T* __restrict__ out,
                         T* __restrict__ slope, RoutedWork w, const int* __restrict__ ids,
                         const int* __restrict__ n_arr, const int* __restrict__ starts,
                         const int* __restrict__ extr, const float* __restrict__ image,
                         int words, int v_at, int m_img, int n_fn) {
  extern __shared__ __align__(16) float smem[];
  int* s_n = reinterpret_cast<int*>(smem + words);
  int* s_at = s_n + n_fn;
  int* s_ex = s_at + n_fn;
  const long long w0 = static_cast<long long>(blockIdx.x) * w.per;
  long long left = w0 + w.per < w.items ? w.per : w.items - w0;  // tiles to do
  long long r = w0 / w.tiles;
  long long t = w0 - r * w.tiles;  // first tile within row r
  // in flight while the image lands: the first row's id, this thread's first
  // x and the per-member scalars
  int id = ids[r];
  const long long c_first = t * kRoutedTile + threadIdx.x;
  const float x_first = c_first < w.cols ? load_f32(x, r * w.cols + c_first) : 0.0f;
  const bool mine = threadIdx.x < n_fn;
  const int n0 = mine ? n_arr[threadIdx.x] : 0;
  const int at0 = mine ? starts[threadIdx.x] : 0;
  const int ex0 = mine ? extr[threadIdx.x] : 0;
  stage_copy(smem, image, words, true);
  if (mine) {
    s_n[threadIdx.x] = n0;
    s_at[threadIdx.x] = at0;
    s_ex[threadIdx.x] = ex0;
  }
  for (int k = threadIdx.x + blockDim.x; k < n_fn; k += blockDim.x) {
    s_n[k] = n_arr[k];
    s_at[k] = starts[k];
    s_ex[k] = extr[k];
  }
  __syncthreads();
  const float* vals = smem + v_at;
  bool first = true;
  while (left > 0) {
    const int fid = id < 0 ? 0 : (id > n_fn - 1 ? n_fn - 1 : id);
    const long long nt = w.tiles - t < left ? w.tiles - t : left;
    if (left > nt) id = ids[r + 1];  // the next row's, loaded while this row runs
    const long long c0 = t * kRoutedTile;
    const long long c1 = c0 + nt * kRoutedTile < w.cols ? c0 + nt * kRoutedTile : w.cols;
    routed_pack_run<T, kMode>(x, out, slope, r * w.cols, c0, c1,
                              image_row(smem + s_at[fid], s_n[fid]), vals, m_img,
                              s_ex[fid] != 0, first, x_first);
    first = false;
    left -= nt;
    ++r;
    t = 0;
  }
}

// ---- the sharded pack's staging image: the grads over all the shards ---------

// One member's row in the sharded pack's staging image (ShardedTablePack.image,
// laid out by approx/table_pack.py sharded_image_layout): quad j holds
// sub-interval j's (invd, owner-rebased base, segs, owner), so the four
// gathers after the selector are one 16-byte shared-memory read; the n + 1
// boundaries follow the quads.  The image's header holds each member's row
// start and sub-interval count (words 2f, 2f + 1), exact in f32.
struct ShardRow {
  const float4* quad;
  const float* bounds;
  int n;
  bool ex;
};

__device__ __forceinline__ ShardRow shard_row(const float* img, int fid, bool ex) {
  const int at = static_cast<int>(img[2 * fid]);
  const int n = static_cast<int>(img[2 * fid + 1]);
  return ShardRow{reinterpret_cast<const float4*>(img + at), img + at + 4 * n, n, ex};
}

// kE elements of one member, value and slope over all the shards before
// the sum's +0.0 (spack_put adds it): tl::sharded_sum over the range [0, S),
// op for op.  Every real sub-interval's owner lies in that range, so there
// is no owner test: the owner's slice answers.  The selector counts
// b_1 .. b_{n-1}, each boundary read once for the kE elements: the row
// ascends, so this is tl::select's min(#(x >= b_k, 1 <= k <= n_max), n - 1)
// (x >= b_n puts j at n - 1 either way, and the +inf padding never counts).
template <int kE>
__device__ __forceinline__ void spack_elems(const float (&x)[kE], const ShardRow& r,
                                            const float* slab, int m, float (&y)[kE],
                                            float (&d)[kE]) {
  int j[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) j[e] = 0;
  for (int k = 1; k < r.n; ++k) {
    const float b = r.bounds[k];
#pragma unroll
    for (int e = 0; e < kE; ++e) j[e] += x[e] >= b ? 1 : 0;
  }
  const float lo = r.bounds[0];
  const float hi = r.bounds[r.n];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const float4 q = r.quad[j[e]];  // invd, owner-rebased base, segs, owner
    const float u = (x[e] - r.bounds[j[e]]) * q.x;
    const float i = tl::clamp_cell(u, q.z);
    const int a = tl::address(q.y + i);
    const float* v = slab + static_cast<int>(q.w) * m;
    const float y0 = v[tl::clip_address(a, m)];
    const float y1 = v[tl::clip_address(a + 1, m)];
    float t = u - i;
    float s = (y1 - y0) * q.x;
    if (!r.ex) {
      t = tl::clamp_hi(tl::clamp_lo(t, 0.0f), 1.0f);
      s = s * ((x[e] >= lo && x[e] < hi) ? 1.0f : 0.0f);
    }
    y[e] = y0 + t * (y1 - y0);
    d[e] = s;
  }
}

// tl::sharded_sum's round(y) + 0.0f on the rounded bits of a bf16 pair: a
// half that is -0.0 becomes +0.0 (bit 15 of (h & 0x7fff) + 0x7fff is set
// unless the half is +-0; no carry crosses the halves).  A tiny negative y
// that rounds to -0.0 becomes +0.0 too, which y + 0.0f before the rounding
// would not give.
__device__ __forceinline__ uint32_t plus_zero2(uint32_t w) {
  return w & (((w & 0x7fff7fffu) + 0x7fff7fffu) | 0x7fff7fffu);
}

// One chunk of x: a 16-byte vector of kE = 16 / sizeof(T) elements, or one
// element (kE = 1), and its outputs' store: each rounded to T once and, with
// kSum (a range longer than one shard), -0.0 turned +0.0.
template <typename T, int kE>
struct Chunk {
  uint4 w;
  static __device__ __forceinline__ Chunk load(const T* p, long long q) {
    return Chunk{reinterpret_cast<const uint4*>(p)[q]};
  }
  __device__ __forceinline__ float get(int e) const { return vec_get<T>(w, e); }
};
template <typename T>
struct Chunk<T, 1> {
  float v;
  static __device__ __forceinline__ Chunk load(const T* p, long long q) {
    return Chunk{load_f32(p, q)};
  }
  __device__ __forceinline__ float get(int) const { return v; }
};

template <typename T, bool kSum, int kE>
__device__ __forceinline__ void spack_put(T* p, long long q, const float (&v)[kE]) {
  if constexpr (sizeof(T) == 4) {
    float o[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) o[e] = kSum ? v[e] + 0.0f : v[e];
    if constexpr (kE == 1) {
      p[q] = o[0];
    } else {
      reinterpret_cast<uint4*>(p)[q] = make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                                                  __float_as_uint(o[2]), __float_as_uint(o[3]));
    }
  } else if constexpr (kE == 1) {
    uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
    if (kSum) h = plus_zero2(h);
    reinterpret_cast<unsigned short*>(p)[q] = static_cast<unsigned short>(h);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
      if (kSum) w[k] = plus_zero2(w[k]);
    }
    reinterpret_cast<uint4*>(p)[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// What spack_image_kernel walks: `rows` rows of `cols` elements (the static
// grad's is one row), in chunks of kE elements that never straddle a row;
// block b takes chunks [b * per, min((b + 1) * per, chunks)).  A static
// walk in 16-byte chunks leaves the n % kE elements past the last chunk to
// the last block.
struct SpackWork {
  long long cols;    // elements of a row
  long long cpr;     // chunks of a row
  long long chunks;  // chunks of all the rows
  long long per;     // chunks of one block
};

template <typename T, bool kRouted, bool kSum, int kE>
__device__ __forceinline__ void spack_walk(const T* x, T* out, T* slope,
                                           const SpackWork& w, const int* ids,
                                           const int* extr, int fid, int extrapolate,
                                           const float* image, int words, int v_at, int m,
                                           int n_fn, float* smem) {
  const long long c0 = static_cast<long long>(blockIdx.x) * w.per;
  const long long c1 = c0 + w.per < w.chunks ? c0 + w.per : w.chunks;
  long long r = kRouted ? c0 / w.cpr : 0;
  // in flight while the image lands: this thread's first chunk, the first
  // row's id and the members' extrapolate flags (one each for the first
  // n_fn threads)
  const long long first = c0 + threadIdx.x;
  Chunk<T, kE> pre{};
  if (first < c1) pre = Chunk<T, kE>::load(x, first);
  int id = kRouted ? (c0 < c1 ? ids[r] : 0) : fid;
  const bool mine = kRouted && threadIdx.x < n_fn;
  const int ex0 = mine ? extr[threadIdx.x] : 0;
  stage_copy(reinterpret_cast<float4*>(smem), reinterpret_cast<const float4*>(image),
             words / 4, true);
  int* s_ex = reinterpret_cast<int*>(smem + words);
  if (kRouted) {
    if (mine) s_ex[threadIdx.x] = ex0;
    for (int k = threadIdx.x + blockDim.x; k < n_fn; k += blockDim.x) s_ex[k] = extr[k];
  }
  __syncthreads();
  const float* slab = smem + v_at;
  for (long long c = c0; c < c1; ++r) {
    const long long re = kRouted && (r + 1) * w.cpr < c1 ? (r + 1) * w.cpr : c1;
    const int f = kRouted ? (id < 0 ? 0 : (id > n_fn - 1 ? n_fn - 1 : id)) : fid;
    if (kRouted && re < c1) id = ids[r + 1];  // the next row's, loaded while this row runs
    const ShardRow row = shard_row(smem, f, kRouted ? s_ex[f] != 0 : extrapolate != 0);
    for (long long q = c + threadIdx.x; q < re; q += kThreads) {
      const Chunk<T, kE> cur = q == first ? pre : Chunk<T, kE>::load(x, q);
      float xv[kE], y[kE], d[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) xv[e] = cur.get(e);
      spack_elems<kE>(xv, row, slab, m, y, d);
      spack_put<T, kSum, kE>(out, q, y);
      spack_put<T, kSum, kE>(slope, q, d);
    }
    c = re;
  }
  if (!kRouted && kE > 1 && blockIdx.x == gridDim.x - 1) {
    const long long e = w.chunks * kE + threadIdx.x;
    if (e < w.cols) {
      const float xv[1] = {load_f32(x, e)};
      float y[1], d[1];
      spack_elems<1>(xv, shard_row(smem, fid, extrapolate != 0), slab, m, y, d);
      spack_put<T, kSum, 1>(out, e, y);
      spack_put<T, kSum, 1>(slope, e, d);
    }
  }
}

// Replaces _spack_grad_kernel (src/repro/kernels/table_pack_lookup.py:697)
// and, kRouted, _sharded_routed_grad_kernel
// (src/repro/kernels/routed_pack_lookup.py:480), with the sum over their
// per-shard outputs (_sharded_sum_pallas, :803; _sharded_routed_sum, :529):
// value and slope of member fid (kRouted: row r through member ids[r],
// clamped, its flag extr[...]) over ALL the shards in one launch, where the
// pack's staging image fits kSmemBytes (the launch decides).  Bound: bytes
// (x read once, y and the slope written once: 6.34 us at the training gate);
// the S launches and S - 1 adds of each output it replaces moved ~10x that.
// At the training gate the grid is capped (kBlocksPerSM blocks of kThreads
// a multiprocessor, ~26 elements a thread), so what a thread issues an
// element and the bytes it keeps in flight set the pace.  So: each thread's
// first x is in flight while the image lands, in ONE round trip (16-byte
// loads, one batch; stablelm's 4-shard image is 1,396 words); a row of
// another member is another row of shared memory (no loads, no barrier);
// where the grid is capped, x, y and the slope move in 16-byte chunks
// (8 bf16 or 4 f32 elements, kE); the selector scans the member's real
// sub-intervals once for the chunk's kE elements; the four gathers after
// it are one 16-byte shared read; each output is rounded to T once.  Each
// was kept where tools/torch_kernel_ab.py timed it faster; loading the
// next chunk before this one's arithmetic did not time faster (its 16 KB
// an SM already cover Little's law) and went.  kSum: S > 1.
// The bits are spack_kernel's and routed_kernel<..., true>'s over [0, S).
template <typename T, bool kRouted, bool kSum>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
spack_image_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
                   SpackWork w, const int* __restrict__ ids, const int* __restrict__ extr,
                   int fid, int extrapolate, const float* __restrict__ image, int words,
                   int v_at, int m, int n_fn, int vec) {
  extern __shared__ __align__(16) float smem[];
  if (vec) {
    spack_walk<T, kRouted, kSum, 16 / sizeof(T)>(x, out, slope, w, ids, extr, fid,
                                                 extrapolate, image, words, v_at, m,
                                                 n_fn, smem);
  } else {
    spack_walk<T, kRouted, kSum, 1>(x, out, slope, w, ids, extr, fid, extrapolate,
                                    image, words, v_at, m, n_fn, smem);
  }
}

// ---- launches -----------------------------------------------------------------

int sm_count() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_sm <= 0) n_sm = 1;
  }
  return n_sm;
}

int grid_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSM;
  return static_cast<int>(want < cap ? want : cap);
}

// The work items of `rows` rows of n / rows columns, and the blocks that
// walk them: at most kBlocksPerSM a multiprocessor, each one contiguous run.
RoutedWork routed_work(long long n, int rows, int* blocks) {
  RoutedWork w;
  w.cols = n / rows;
  w.tiles = (w.cols + kRoutedTile - 1) / kRoutedTile;
  w.items = w.tiles * rows;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSM;
  const long long b = w.items < cap ? w.items : cap;
  w.per = (w.items + b - 1) / b;
  *blocks = static_cast<int>((w.items + w.per - 1) / w.per);
  return w;
}

// The staging of a block and its dynamic shared bytes: the metadata and the
// values (or codes) if both fit kSmemBytes, else the metadata if it fits,
// else nothing.
struct Staging {
  int stage;
  size_t bytes;
};

Staging staging_for(long long meta_floats, long long value_bytes) {
  const long long meta_bytes = 4 * meta_floats;
  if (meta_bytes + value_bytes <= kSmemBytes) {
    return {kStageAll, static_cast<size_t>(meta_bytes + value_bytes)};
  }
  if (meta_bytes <= kSmemBytes) return {kStageMeta, static_cast<size_t>(meta_bytes)};
  return {kStageNone, 0};
}

// Expand KERNEL(T, ...) with T = float or __nv_bfloat16 by dtype (0 = float32,
// 1 = bfloat16); an unknown dtype returns cudaErrorInvalidValue.
#define TP_DISPATCH_DTYPE(dtype, KERNEL, ...)                                          \
  do {                                                                                 \
    if ((dtype) == 0) {                                                                \
      KERNEL(float, __VA_ARGS__);                                                      \
    } else if ((dtype) == 1) {                                                         \
      KERNEL(__nv_bfloat16, __VA_ARGS__);                                              \
    } else {                                                                           \
      return cudaErrorInvalidValue;                                                    \
    }                                                                                  \
  } while (0)

// An empty or inconsistent row, or a values vector of fewer than two entries.
bool pack_refused(long long n, int fn_id, int n_max, int n_intervals, int m) {
  return n_max < 1 || n_intervals < 1 || n_intervals > n_max || fn_id < 0 || m < 2 ||
         n < 0;
}

// `image` (nullptr for none) is the member's staging image: the pack's
// (TablePack.image) or the table's (TorchTable.image), laid out by
// member_image_layout, the member's row of n_intervals sub-intervals from
// word row_at and m_img of the pack's values, from its first entry, at word
// v_at.  Where it fits kSmemBytes, pack_image_kernel stages it; otherwise
// (and for kFlash, which passes none) pack_kernel stages the member's row at
// n_max and the pack's values as the budget allows.  Refuses
// (cudaErrorInvalidValue, no launch) what pack_refused names, an unknown
// dtype and an image whose row or values cannot be the member's.
template <int kMode>
cudaError_t launch_pack(const void* x, void* out, void* slope, long long n, int dtype,
                        const float* bounds, const float* invd, const float* base,
                        const float* segs, const float* values, const float* image,
                        int fn_id, int n_max, int n_intervals, int m, int extrapolate,
                        int row_at, int v_at, int m_img, cudaStream_t stream) {
  if (pack_refused(n, fn_id, n_max, n_intervals, m) || (kMode == kGrad && !slope) ||
      (image && (row_at < 0 || v_at < row_at + 4LL * n_intervals + 1 || m_img < 2 ||
                 m_img > m))) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const int blocks = grid_for(n);
  if constexpr (kMode != kFlash) {
    const long long words = (static_cast<long long>(v_at) + m_img + 3) / 4 * 4;
    if (image && 4 * words <= kSmemBytes) {
#define TP_PACK_IMAGE(T, ...)                                                          \
  pack_image_kernel<T, kMode><<<blocks, kThreads, 4 * words, stream>>>(                \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), n,       \
      image, static_cast<int>(words), row_at, v_at, n_intervals, m_img, extrapolate)
      TP_DISPATCH_DTYPE(dtype, TP_PACK_IMAGE, 0);
#undef TP_PACK_IMAGE
      return cudaGetLastError();
    }
  }
  const Staging st = staging_for(4LL * n_max + 1, 4LL * m);
#define TP_PACK(T, ...)                                                                \
  pack_kernel<T, kMode><<<blocks, kThreads, st.bytes, stream>>>(                       \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), n,       \
      bounds, invd, base, segs, values, fn_id, n_max, n_intervals, m, extrapolate,     \
      st.stage)
  TP_DISPATCH_DTYPE(dtype, TP_PACK, 0);
#undef TP_PACK
  return cudaGetLastError();
}

// TableFlash over member fn_id (exp_neg) of m_img values in its staging
// image.  Where the image fits kSmemBytes, flash_image_kernel stages it;
// otherwise pack_kernel<T, kFlash> stages the member's row and the pack's
// values as the budget allows.  Refuses what launch_pack refuses and an
// image of fewer than two values or more than the pack's.
cudaError_t launch_flash(const void* x, void* out, long long n, int dtype,
                         const float* bounds, const float* invd, const float* base,
                         const float* segs, const float* values, const float* image,
                         int fn_id, int n_max, int n_intervals, int m, int m_img,
                         cudaStream_t stream) {
  if (pack_refused(n, fn_id, n_max, n_intervals, m) || m_img < 2 || m_img > m) {
    return cudaErrorInvalidValue;
  }
  const long long image_bytes = 4 * image_floats(n_intervals, 0, false, m_img);
  if (image_bytes > kSmemBytes) {
    return launch_pack<kFlash>(x, out, nullptr, n, dtype, bounds, invd, base, segs,
                               values, nullptr, fn_id, n_max, n_intervals, m, 0, 0, 0,
                               0, stream);
  }
  if (n == 0) return cudaSuccess;
#define TP_FLASH_IMAGE(T, ...)                                                         \
  flash_image_kernel<T><<<grid_for(n), kThreads, image_bytes, stream>>>(               \
      static_cast<const T*>(x), static_cast<T*>(out), n, image, n_intervals, m_img)
  TP_DISPATCH_DTYPE(dtype, TP_FLASH_IMAGE, 0);
#undef TP_FLASH_IMAGE
  return cudaGetLastError();
}

// The sharded pack's staging image (ShardedTablePack.image): its header
// holds n_fn members' rows and its values slices start at word v_at, a
// multiple of 4 past the header.
bool spack_image_sane(int n_fn, int v_at) {
  return n_fn >= 1 && v_at >= 2LL * n_fn && v_at % 4 == 0;
}

long long spack_image_words(int v_at, int m, int n_shards) {
  return (v_at + static_cast<long long>(n_shards) * m + 3) / 4 * 4;
}

// Whether a grad launch over shards [s_begin, s_end) takes
// spack_image_kernel: the range is all the shards and the image (16-byte
// aligned), with a routed launch's n_fn flags, fits kSmemBytes.
bool spack_image_fits(const float* image, int v_at, int m, int n_shards, int s_begin,
                      int s_end, int n_flags) {
  return image && reinterpret_cast<uintptr_t>(image) % 16 == 0 && s_begin == 0 &&
         s_end == n_shards &&
         4 * (spack_image_words(v_at, m, n_shards) + n_flags) <= kSmemBytes;
}

// spack_image_kernel over `rows` rows of n / rows elements (the static
// grad: one row, member fid, flag extrapolate; routed: ids and extr).  Where
// the scalar grid would be capped and x, y and the slope are 16-byte
// aligned (and a row holds whole 16-byte chunks), the walk moves 16-byte
// chunks; otherwise one element a chunk.
template <bool kRouted>
cudaError_t launch_spack_image(const void* x, void* y, void* slope, long long n,
                               int dtype, int rows, const int* ids, const int* extr,
                               int fid, int extrapolate, const float* image, int v_at,
                               int m, int n_shards, int n_fn, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSM;
  const int elem_vec = dtype == 1 ? 8 : 4;
  SpackWork w;
  w.cols = n / rows;
  const int vec = (n + kThreads - 1) / kThreads > cap && aligned(x) && aligned(y) &&
                  aligned(slope) && (!kRouted || w.cols % elem_vec == 0) &&
                  n >= elem_vec;
  const int ke = vec ? elem_vec : 1;
  w.cpr = w.cols / ke;
  w.chunks = kRouted ? w.cpr * rows : n / ke;
  long long b = (w.chunks + kThreads - 1) / kThreads;
  b = b < cap ? b : cap;
  w.per = (w.chunks + b - 1) / b;
  const int blocks = static_cast<int>((w.chunks + w.per - 1) / w.per);
  const long long words = spack_image_words(v_at, m, n_shards);
  const size_t bytes = 4 * (words + (kRouted ? n_fn : 0));
#define TP_SPACK_IMAGE(T, SUM)                                                         \
  spack_image_kernel<T, kRouted, SUM><<<blocks, kThreads, bytes, stream>>>(            \
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(slope), w, ids,    \
      extr, fid, extrapolate, image, static_cast<int>(words), v_at, m, n_fn, vec)
  if (n_shards > 1) {
    TP_DISPATCH_DTYPE(dtype, TP_SPACK_IMAGE, true);
  } else {
    TP_DISPATCH_DTYPE(dtype, TP_SPACK_IMAGE, false);
  }
#undef TP_SPACK_IMAGE
  return cudaGetLastError();
}

// Shards [s_begin, s_end) of the S-shard pack, summed (see spack_kernel);
// refuses what launch_pack refuses and a shard range that is empty or leaves
// [0, S).  Where the scalar grid would be capped (the card already full: the
// training gate, prefill) x and the outputs move in 16-byte vectors (if
// 16-byte aligned); where it is not (the decode gate) the values slab may be
// staged by a TMA bulk copy.  Each was kept where tools/torch_kernel_ab.py
// timed it faster.
template <int kMode>
cudaError_t launch_spack(const void* x, void* out, void* slope, long long n, int dtype,
                         const float* bounds, const float* invd, const float* obase,
                         const float* segs, const float* owner, const float* values,
                         int fn_id, int n_max, int n_intervals, int m, int n_shards,
                         int s_begin, int s_end, int extrapolate, cudaStream_t stream,
                         const float* image = nullptr, int n_fn = 0, int v_at = 0) {
  if (n_max < 1 || n_intervals < 1 || n_intervals > n_max || fn_id < 0 || m < 2 ||
      s_begin < 0 || s_end <= s_begin || s_end > n_shards || n < 0 ||
      (kMode == kGrad && !slope) ||
      (image && (fn_id >= n_fn || !spack_image_sane(n_fn, v_at)))) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  if (kMode == kGrad && spack_image_fits(image, v_at, m, n_shards, s_begin, s_end, 0)) {
    return launch_spack_image<false>(x, out, slope, n, dtype, 1, nullptr, nullptr, fn_id,
                                     extrapolate, image, v_at, m, n_shards, 0, stream);
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSM;
  const bool capped = (n + kThreads - 1) / kThreads > cap;
  const int vec =
      capped && aligned(x) && aligned(out) && (kMode != kGrad || aligned(slope));
  const int elem = dtype == 1 ? 2 : 4;
  const int blocks = grid_for(vec ? (n * elem + 15) / 16 : n);
  const int range = s_end - s_begin;
  const Staging st = staging_for(shard_meta_floats(n_max), 4LL * m * range);
#define TP_SPACK(T, SUM)                                                               \
  spack_kernel<T, kMode, SUM><<<blocks, kThreads, st.bytes, stream>>>(                 \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), n,       \
      bounds, invd, obase, segs, owner, values + static_cast<long long>(s_begin) * m,  \
      fn_id, n_max, n_intervals, m, s_begin, range, extrapolate, st.stage, vec,        \
      !capped)
  if (range > 1) {
    TP_DISPATCH_DTYPE(dtype, TP_SPACK, true);
  } else {
    TP_DISPATCH_DTYPE(dtype, TP_SPACK, false);
  }
#undef TP_SPACK
  return cudaGetLastError();
}

template <typename T, typename C, int kMode>
void quant_go(int blocks, Staging st, cudaStream_t stream, const void* x, void* out,
              void* slope, long long n, const float* const* p, const void* codes,
              int bo, int lo, int n_intervals, int m, int extrapolate) {
  quant_kernel<T, C, kMode><<<blocks, kThreads, st.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), n, p[0],
      p[1], p[2], p[3], p[4], p[5], p[6], static_cast<const C*>(codes), bo, lo,
      n_intervals, m, extrapolate, st.stage);
}

template <typename T, typename C, int kMode>
void quant_image_go(int blocks, long long bytes, cudaStream_t stream, const void* x,
                    void* out, void* slope, long long n, const void* image,
                    const QuantImage& im, int bo, int lo, int n_intervals, int m,
                    int extrapolate) {
  quant_image_kernel<T, C, kMode><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), n,
      static_cast<const int*>(image), im, bo, lo, n_intervals, m, extrapolate);
}

// code_bits: 8 (int8) or 16 (int16); `image` the pack's staging image,
// laid out by n_fn, n_sub (the pack's sub-intervals) and m8 / m16 (its code
// groups' entries, m the member's group's).  Where the image fits
// kSmemBytes, quant_image_kernel stages it; otherwise quant_kernel stages
// the member's lanes and its code group as the budget allows.  Refuses an
// empty row, negative offsets, an empty code group, another code width, an
// unknown dtype and a member whose lanes or group leave the image's.
template <int kMode>
cudaError_t launch_quant(const void* x, void* out, void* slope, long long n, int dtype,
                         const float* const* planes, const void* codes,
                         const void* image, int bo, int lo, int n_intervals, int m,
                         int code_bits, int extrapolate, int n_fn, int n_sub, int m8,
                         int m16, cudaStream_t stream) {
  if (n_intervals < 1 || bo < 0 || lo < 0 || m < 1 || n < 0 ||
      (code_bits != 8 && code_bits != 16) || m != (code_bits == 8 ? m8 : m16) ||
      n_fn < 1 || m8 < 0 || m16 < 0 || lo + n_intervals > n_sub ||
      bo + n_intervals + 1 > n_sub + n_fn || (kMode == kGrad && !slope)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const int blocks = grid_for(n);
  const QuantImage im = quant_image(n_fn, n_sub, m8, m16);
  if (4 * im.words <= kSmemBytes) {
#define TP_QUANT_IMAGE(T, C)                                                           \
  quant_image_go<T, C, kMode>(blocks, 4 * im.words, stream, x, out, slope, n, image,   \
                              im, bo, lo, n_intervals, m, extrapolate)
    if (code_bits == 8) {
      TP_DISPATCH_DTYPE(dtype, TP_QUANT_IMAGE, int8_t);
    } else {
      TP_DISPATCH_DTYPE(dtype, TP_QUANT_IMAGE, int16_t);
    }
#undef TP_QUANT_IMAGE
    return cudaGetLastError();
  }
  const Staging st = staging_for(7LL * n_intervals + 1, static_cast<long long>(m) *
                                                            (code_bits / 8));
#define TP_QUANT(T, C)                                                                 \
  quant_go<T, C, kMode>(blocks, st, stream, x, out, slope, n, planes, codes, bo, lo,   \
                        n_intervals, m, extrapolate)
  if (code_bits == 8) {
    TP_DISPATCH_DTYPE(dtype, TP_QUANT, int8_t);
  } else {
    TP_DISPATCH_DTYPE(dtype, TP_QUANT, int16_t);
  }
#undef TP_QUANT
  return cudaGetLastError();
}

template <typename T, typename C, int kMode>
void poly_go(int blocks, Staging st, cudaStream_t stream, const void* x, void* out,
             void* slope, long long n, const float* const* p, const void* codes,
             int bo, int lo, int n_intervals, int lmax, int degree, int m,
             int extrapolate) {
  poly_kernel<T, C, kMode><<<blocks, kThreads, st.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), n, p[0],
      p[1], p[2], p[3], p[4], p[5], p[6], static_cast<const C*>(codes), bo, lo,
      n_intervals, lmax, degree, m, extrapolate, st.stage);
}

template <typename T, typename C, int kMode>
void poly_image_go(int blocks, long long bytes, cudaStream_t stream, const void* x,
                   void* out, void* slope, long long n, const void* image,
                   const PolyImage& im, int bo, int lo, int n_intervals, int lmax,
                   int degree, int m, int extrapolate) {
  poly_image_kernel<T, C, kMode><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), n,
      static_cast<const int*>(image), im, bo, lo, n_intervals, lmax, degree, m,
      extrapolate);
}

// code_bits: 8, 16 or 32 (raw f32 coefficients); degree 1..3 and
// degree + 1 <= lmax <= 4; `image` the pack's staging image, laid out by
// n_fn, n_sub (the pack's sub-intervals) and m8 / m16 / m32 (its code
// groups' entries, m the member's group's).  Where the image fits
// kSmemBytes, poly_image_kernel stages it; otherwise poly_kernel stages the
// member's lanes and its code group as the budget allows.  Refuses anything
// else, as launch_quant does, and a member whose lanes leave the image's.
template <int kMode>
cudaError_t launch_poly(const void* x, void* out, void* slope, long long n, int dtype,
                        const float* const* planes, const void* codes,
                        const void* image, int bo, int lo, int n_intervals, int lmax,
                        int degree, int m, int code_bits, int extrapolate, int n_fn,
                        int n_sub, int m8, int m16, int m32, cudaStream_t stream) {
  if (n_intervals < 1 || bo < 0 || lo < 0 || m < 1 || n < 0 || degree < 1 ||
      degree >= tl::kMaxLanes || lmax < degree + 1 || lmax > tl::kMaxLanes ||
      (code_bits != 8 && code_bits != 16 && code_bits != 32) ||
      m != (code_bits == 8 ? m8 : code_bits == 16 ? m16 : m32) || n_fn < 1 ||
      m8 < 0 || m16 < 0 || m32 < 0 || lo + n_intervals > n_sub ||
      bo + n_intervals + 1 > n_sub + n_fn || (kMode == kGrad && !slope)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const int blocks = grid_for(n);
  const PolyImage im = poly_image(n_fn, n_sub, lmax, m8, m16, m32);
  if (4 * im.words <= kSmemBytes) {
#define TP_POLY_IMAGE(T, C)                                                            \
  poly_image_go<T, C, kMode>(blocks, 4 * im.words, stream, x, out, slope, n, image,    \
                             im, bo, lo, n_intervals, lmax, degree, m, extrapolate)
    if (code_bits == 8) {
      TP_DISPATCH_DTYPE(dtype, TP_POLY_IMAGE, int8_t);
    } else if (code_bits == 16) {
      TP_DISPATCH_DTYPE(dtype, TP_POLY_IMAGE, int16_t);
    } else {
      TP_DISPATCH_DTYPE(dtype, TP_POLY_IMAGE, float);
    }
#undef TP_POLY_IMAGE
    return cudaGetLastError();
  }
  const Staging st = staging_for(
      4LL * n_intervals + 1 + 3LL * n_intervals * lmax,
      static_cast<long long>(m) * (code_bits / 8));
#define TP_POLY(T, C)                                                                  \
  poly_go<T, C, kMode>(blocks, st, stream, x, out, slope, n, planes, codes, bo, lo,    \
                       n_intervals, lmax, degree, m, extrapolate)
  if (code_bits == 8) {
    TP_DISPATCH_DTYPE(dtype, TP_POLY, int8_t);
  } else if (code_bits == 16) {
    TP_DISPATCH_DTYPE(dtype, TP_POLY, int16_t);
  } else {
    TP_DISPATCH_DTYPE(dtype, TP_POLY, float);
  }
#undef TP_POLY
  return cudaGetLastError();
}

// Refuses (cudaErrorInvalidValue, no launch) an empty pack, a values vector
// of fewer than two entries, a row count that does not divide n and an
// unknown dtype.
// kSharded: shards [s_begin, s_end) of the S-shard pack summed; `base` is
// the owner-rebased-base plane, `owner` (non-null) the owner plane, `values`
// the (S, m) padded slices; the range's slab may be staged by a TMA bulk copy
// where the work items do not outnumber the grid's cap (the decode gate).
// Also refuses a shard range that is empty or leaves [0, S).  Otherwise the
// range is [0, 1) of 1.
template <int kMode, bool kSharded>
cudaError_t launch_routed(const void* x, void* out, void* slope, long long n, int dtype,
                          const int* ids, const int* n_arr, const int* extr,
                          const float* bounds, const float* invd, const float* base,
                          const float* segs, const float* values, const float* owner,
                          int n_fn, int n_max, int m, int n_shards, int s_begin,
                          int s_end, int rows, cudaStream_t stream,
                          const float* image = nullptr, int v_at = 0) {
  if (n_fn < 1 || n_max < 1 || m < 2 || rows < 1 || n < 0 || n % rows != 0 ||
      s_begin < 0 || s_end <= s_begin || s_end > n_shards ||
      (kMode == kGrad && !slope) || (kSharded && !owner) ||
      (image && !spack_image_sane(n_fn, v_at))) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  if (kMode == kGrad && kSharded &&
      spack_image_fits(image, v_at, m, n_shards, s_begin, s_end, n_fn)) {
    return launch_spack_image<true>(x, out, slope, n, dtype, rows, ids, extr, 0, 0, image,
                                    v_at, m, n_shards, n_fn, stream);
  }
  int blocks = 0;
  const RoutedWork w = routed_work(n, rows, &blocks);
  const int range = s_end - s_begin;
  const Staging st = kSharded ? staging_for(shard_meta_floats(n_max), 4LL * m * range)
                              : staging_for(4LL * n_max + 1, 4LL * m);
#define TP_ROUTED(T, SUM)                                                              \
  routed_kernel<T, kMode, kSharded, SUM><<<blocks, kThreads, st.bytes, stream>>>(      \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), w, ids,  \
      n_arr, extr, bounds, invd, base, segs,                                           \
      values + static_cast<long long>(s_begin) * m, owner, n_fn, n_max, m, s_begin,    \
      range, st.stage, w.items <= static_cast<long long>(sm_count()) * kBlocksPerSM)
  if (kSharded && range > 1) {
    TP_DISPATCH_DTYPE(dtype, TP_ROUTED, kSharded);
  } else {
    TP_DISPATCH_DTYPE(dtype, TP_ROUTED, false);
  }
#undef TP_ROUTED
  return cudaGetLastError();
}

// The routed f32 pack with its staging image (TablePack.image): n_sub the
// pack's sub-intervals (every member's), m_img the values the image holds,
// `starts` each member's row start in it.  Where the image and the
// per-member scalars fit kSmemBytes, routed_pack_image_kernel stages the
// whole pack; otherwise routed_kernel stages a row at n_max and the values
// as the budget allows, restaging the row per member.  Refuses what
// launch_routed refuses and an image whose values or rows cannot be the
// pack's.
template <int kMode>
cudaError_t launch_routed_image(const void* x, void* out, void* slope, long long n,
                                int dtype, const int* ids, const int* n_arr,
                                const int* starts, const int* extr,
                                const float* bounds, const float* invd,
                                const float* base, const float* segs,
                                const float* values, const float* image, int n_fn,
                                int n_max, int m, int n_sub, int m_img, int rows,
                                cudaStream_t stream) {
  if (n_fn < 1 || n_max < 1 || m < 2 || n_sub < n_fn ||
      n_sub > static_cast<long long>(n_fn) * n_max || m_img < 2 || m_img > m ||
      rows < 1 || n < 0 || n % rows != 0 || (kMode == kGrad && !slope)) {
    return cudaErrorInvalidValue;
  }
  const long long v_at = 4LL * n_sub + n_fn;
  const long long words = (v_at + m_img + 3) / 4 * 4;
  const long long whole = 4 * (words + 3LL * n_fn);
  if (whole > kSmemBytes) {
    return launch_routed<kMode, false>(x, out, slope, n, dtype, ids, n_arr, extr,
                                       bounds, invd, base, segs, values, nullptr, n_fn,
                                       n_max, m, 1, 0, 1, rows, stream);
  }
  if (n == 0) return cudaSuccess;
  int blocks = 0;
  const RoutedWork w = routed_work(n, rows, &blocks);
#define TP_ROUTED_IMAGE(T, ...)                                                        \
  routed_pack_image_kernel<T, kMode><<<blocks, kThreads, whole, stream>>>(             \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), w, ids,  \
      n_arr, starts, extr, image, static_cast<int>(words), static_cast<int>(v_at),     \
      m_img, n_fn)
  TP_DISPATCH_DTYPE(dtype, TP_ROUTED_IMAGE, 0);
#undef TP_ROUTED_IMAGE
  return cudaGetLastError();
}

// max_n: the widest member's interval count; m8 / m16: the two code groups'
// sizes; n_sub: the pack's sub-intervals.  Where the staging image and the
// flags fit kSmemBytes, a block stages the whole pack
// (routed_quant_pack_kernel); otherwise routed_quant_kernel's staging holds
// the widest member's seven lanes and the larger group, restaged per
// member.  Refuses what launch_routed refuses, an empty code group and a
// sub-interval count below the widest member's.
template <int kMode>
cudaError_t launch_routed_quant(const void* x, void* out, void* slope, long long n,
                                int dtype, const int* const* routing,
                                const float* const* planes, const void* codes8,
                                const void* codes16, const void* image, int n_fn,
                                int max_n, int m8, int m16, int n_sub, int rows,
                                cudaStream_t stream) {
  if (n_fn < 1 || max_n < 1 || m8 < 1 || m16 < 1 || n_sub < max_n || rows < 1 ||
      n < 0 || n % rows != 0 || (kMode == kGrad && !slope)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  int blocks = 0;
  const RoutedWork w = routed_work(n, rows, &blocks);
  const QuantImage im = quant_image(n_fn, n_sub, m8, m16);
  const long long whole = 4 * (im.words + n_fn);
  if (whole <= kSmemBytes) {
#define TP_ROUTED_QUANT_PACK(T, ...)                                                   \
  routed_quant_pack_kernel<T, kMode><<<blocks, kThreads, whole, stream>>>(             \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), w,       \
      routing[0], routing[2], static_cast<const int*>(image), im, n_fn, m8, m16)
    TP_DISPATCH_DTYPE(dtype, TP_ROUTED_QUANT_PACK, 0);
#undef TP_ROUTED_QUANT_PACK
    return cudaGetLastError();
  }
  const long long code_bytes = m8 > 2LL * m16 ? m8 : 2LL * m16;
  const Staging st = staging_for(7LL * max_n + 1, code_bytes);
#define TP_ROUTED_QUANT(T, ...)                                                        \
  routed_quant_kernel<T, kMode><<<blocks, kThreads, st.bytes, stream>>>(               \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), w,       \
      routing[0], routing[1], routing[2], routing[3], routing[4], routing[5],          \
      planes[0], planes[1], planes[2], planes[3], planes[4], planes[5], planes[6],     \
      static_cast<const int8_t*>(codes8), static_cast<const int16_t*>(codes16), n_fn,  \
      max_n, m8, m16, st.stage)
  TP_DISPATCH_DTYPE(dtype, TP_ROUTED_QUANT, 0);
#undef TP_ROUTED_QUANT
  return cudaGetLastError();
}

// lmax: the pack's lanes (max degree + 1); max_n: the widest member's interval
// count; m8 / m16 / m32: the three code groups' sizes; n_sub: the pack's
// sub-intervals.  Where the staging image and the flags fit kSmemBytes, a
// block stages the whole pack (routed_poly_pack_kernel); otherwise
// routed_poly_kernel's staging holds the widest member's seven lanes and the
// largest group, restaged per member.  Refuses what launch_routed refuses,
// an empty code group, lmax outside [1, 4] and a sub-interval count below
// the widest member's.
template <int kMode>
cudaError_t launch_routed_poly(const void* x, void* out, void* slope, long long n,
                               int dtype, const int* const* routing,
                               const float* const* planes, const void* codes8,
                               const void* codes16, const void* codes32,
                               const void* image, int n_fn, int max_n, int lmax, int m8,
                               int m16, int m32, int n_sub, int rows,
                               cudaStream_t stream) {
  if (n_fn < 1 || max_n < 1 || lmax < 1 || lmax > tl::kMaxLanes || m8 < 1 ||
      m16 < 1 || m32 < 1 || n_sub < max_n || rows < 1 || n < 0 || n % rows != 0 ||
      (kMode == kGrad && !slope)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  int blocks = 0;
  const RoutedWork w = routed_work(n, rows, &blocks);
  const PolyImage im = poly_image(n_fn, n_sub, lmax, m8, m16, m32);
  const long long whole = 4 * (im.words + n_fn);
  if (whole <= kSmemBytes) {
#define TP_ROUTED_POLY_PACK(T, ...)                                                    \
  routed_poly_pack_kernel<T, kMode><<<blocks, kThreads, whole, stream>>>(              \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), w,       \
      routing[0], routing[2], static_cast<const int*>(image), im, n_fn, lmax, m8, m16, \
      m32)
    TP_DISPATCH_DTYPE(dtype, TP_ROUTED_POLY_PACK, 0);
#undef TP_ROUTED_POLY_PACK
    return cudaGetLastError();
  }
  long long code_bytes = m8 > 2LL * m16 ? m8 : 2LL * m16;
  code_bytes = code_bytes > 4LL * m32 ? code_bytes : 4LL * m32;
  const Staging st = staging_for(4LL * max_n + 1 + 3LL * max_n * lmax, code_bytes);
#define TP_ROUTED_POLY(T, ...)                                                         \
  routed_poly_kernel<T, kMode><<<blocks, kThreads, st.bytes, stream>>>(                \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), w,       \
      routing[0], routing[1], routing[2], routing[3], routing[4], routing[5],          \
      routing[6], planes[0], planes[1], planes[2], planes[3], planes[4], planes[5],    \
      planes[6], static_cast<const int8_t*>(codes8),                                   \
      static_cast<const int16_t*>(codes16), static_cast<const float*>(codes32), n_fn,  \
      max_n, lmax, m8, m16, m32, st.stage)
  TP_DISPATCH_DTYPE(dtype, TP_ROUTED_POLY, 0);
#undef TP_ROUTED_POLY
  return cudaGetLastError();
}

// kind: rr::Kind (0 sin, 1 cos, 2 exp, 3 log); m_img: the values in the
// kind's staging image.  Where the image fits kSmemBytes, folded_image_kernel
// stages it (by a TMA bulk copy where the scalar grid is not capped, as
// launch_spack's slab); otherwise folded_kernel stages the two core rows and
// the values as the budget allows.  Refuses an empty or inconsistent core
// row, a values vector (or image) of fewer than two entries, an unknown kind
// and an unknown dtype.
template <int kMode>
cudaError_t launch_folded(const void* x, void* out, void* slope, long long n,
                          int dtype, const float* bounds, const float* invd,
                          const float* base, const float* segs, const float* values,
                          const float* image, int fid_a, int fid_b, int n_max, int n_a,
                          int n_b, int m, int kind, int m_img, cudaStream_t stream) {
  if (n_max < 1 || n_a < 1 || n_a > n_max || n_b < 1 || n_b > n_max || fid_a < 0 ||
      fid_b < 0 || m < 2 || m_img < 2 || m_img > m || kind < rr::kSin ||
      kind > rr::kLog || n < 0 || (kMode == kGrad && !slope)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const int blocks = grid_for(n);
  const bool trig = kind == rr::kSin || kind == rr::kCos;
  const long long image_bytes = 4 * image_floats(n_a, n_b, trig, m_img);
  if (image_bytes <= kSmemBytes) {
    const bool capped = (n + kThreads - 1) / kThreads >
                        static_cast<long long>(sm_count()) * kBlocksPerSM;
#define TP_FOLDED_IMAGE(T, ...)                                                        \
  folded_image_kernel<T, kMode><<<blocks, kThreads, image_bytes, stream>>>(            \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), n,       \
      image, n_a, n_b, m_img, kind, !capped)
    TP_DISPATCH_DTYPE(dtype, TP_FOLDED_IMAGE, 0);
#undef TP_FOLDED_IMAGE
    return cudaGetLastError();
  }
  const Staging st = staging_for(2LL * (4LL * n_max + 1), 4LL * m);
#define TP_FOLDED(T, ...)                                                              \
  folded_kernel<T, kMode><<<blocks, kThreads, st.bytes, stream>>>(                     \
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(slope), n,       \
      bounds, invd, base, segs, values, fid_a, fid_b, n_max, n_a, n_b, m, kind,        \
      st.stage)
  TP_DISPATCH_DTYPE(dtype, TP_FOLDED, 0);
#undef TP_FOLDED
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All pointers are device pointers; the
// launch is asynchronous on `stream`, allocates nothing, and returns the
// launch's own error (cudaGetLastError), which the Python wrapper raises on.
// `image` is the pack's staging image (TablePack.image): member fn_id's row
// from word row_at, m_img of the values from word v_at.
extern "C" cudaError_t tp_pack_lookup(const void* x, void* out, long long n, int dtype,
                                      const float* bounds, const float* invd,
                                      const float* base, const float* segs,
                                      const float* values, const float* image,
                                      int fn_id, int n_max, int n_intervals, int m,
                                      int extrapolate, int row_at, int v_at, int m_img,
                                      void* stream) {
  return launch_pack<kValue>(x, out, nullptr, n, dtype, bounds, invd, base, segs,
                             values, image, fn_id, n_max, n_intervals, m, extrapolate,
                             row_at, v_at, m_img, static_cast<cudaStream_t>(stream));
}

// `image` is exp_neg's staging image (TablePack.flash_image), holding m_img
// of the values.
extern "C" cudaError_t tp_tableflash_exp(const void* x, void* out, long long n,
                                         int dtype, const float* bounds,
                                         const float* invd, const float* base,
                                         const float* segs, const float* values,
                                         const float* image, int fn_id, int n_max,
                                         int n_intervals, int m, int m_img,
                                         void* stream) {
  return launch_flash(x, out, n, dtype, bounds, invd, base, segs, values, image, fn_id,
                      n_max, n_intervals, m, m_img, static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_pack_grad(const void* x, void* y, void* slope, long long n,
                                    int dtype, const float* bounds, const float* invd,
                                    const float* base, const float* segs,
                                    const float* values, const float* image, int fn_id,
                                    int n_max, int n_intervals, int m, int extrapolate,
                                    int row_at, int v_at, int m_img, void* stream) {
  return launch_pack<kGrad>(x, y, slope, n, dtype, bounds, invd, base, segs, values,
                            image, fn_id, n_max, n_intervals, m, extrapolate, row_at,
                            v_at, m_img, static_cast<cudaStream_t>(stream));
}

// A single table: bounds (n+1,), invd/base/segs (n,), values (m,), and its
// staging image (TorchTable.image): the row, then the m values.
extern "C" cudaError_t tp_table_lookup(const void* x, void* out, long long n, int dtype,
                                       const float* bounds, const float* invd,
                                       const float* base, const float* segs,
                                       const float* values, const float* image,
                                       int n_intervals, int m, int extrapolate,
                                       void* stream) {
  return launch_pack<kValue>(x, out, nullptr, n, dtype, bounds, invd, base, segs,
                             values, image, 0, n_intervals, n_intervals, m, extrapolate,
                             0, 4 * n_intervals + 1, m,
                             static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_table_grad(const void* x, void* y, void* slope, long long n,
                                     int dtype, const float* bounds, const float* invd,
                                     const float* base, const float* segs,
                                     const float* values, const float* image,
                                     int n_intervals, int m, int extrapolate,
                                     void* stream) {
  return launch_pack<kGrad>(x, y, slope, n, dtype, bounds, invd, base, segs, values,
                            image, 0, n_intervals, n_intervals, m, extrapolate, 0,
                            4 * n_intervals + 1, m, static_cast<cudaStream_t>(stream));
}

// The quantized pack: member fid's boundaries start at bo in the flat
// boundary lane, its other lanes at lo; `codes` is its width group of m
// entries (code_bits 8 or 16).  Plane order: bounds, invd, base, segs, scale,
// zero, ramp.  `image` is the pack's staging image (QuantTablePack.image),
// laid out by n_fn, n_sub (the pack's sub-interval count) and m8 / m16 (its
// code groups' entries).
extern "C" cudaError_t tp_quant_lookup(const void* x, void* out, long long n, int dtype,
                                       const float* bounds, const float* invd,
                                       const float* base, const float* segs,
                                       const float* scale, const float* zero,
                                       const float* ramp, const void* codes,
                                       const void* image, int bo, int lo,
                                       int n_intervals, int m, int code_bits,
                                       int extrapolate, int n_fn, int n_sub, int m8,
                                       int m16, void* stream) {
  const float* planes[7] = {bounds, invd, base, segs, scale, zero, ramp};
  return launch_quant<kValue>(x, out, nullptr, n, dtype, planes, codes, image, bo, lo,
                              n_intervals, m, code_bits, extrapolate, n_fn, n_sub, m8,
                              m16, static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_quant_grad(const void* x, void* y, void* slope, long long n,
                                     int dtype, const float* bounds, const float* invd,
                                     const float* base, const float* segs,
                                     const float* scale, const float* zero,
                                     const float* ramp, const void* codes,
                                     const void* image, int bo, int lo,
                                     int n_intervals, int m, int code_bits,
                                     int extrapolate, int n_fn, int n_sub, int m8,
                                     int m16, void* stream) {
  const float* planes[7] = {bounds, invd, base, segs, scale, zero, ramp};
  return launch_quant<kGrad>(x, y, slope, n, dtype, planes, codes, image, bo, lo,
                             n_intervals, m, code_bits, extrapolate, n_fn, n_sub, m8,
                             m16, static_cast<cudaStream_t>(stream));
}

// The polynomial pack: as the quantized one, with lane-padded dequant planes
// (lmax lanes per sub-interval, lane offset lo * lmax), the member's degree,
// and code_bits 8, 16 or 32 (raw f32 coefficients).  Plane order: bounds,
// invd, base, segs, zero, ramp, scale.  `image` is the pack's staging image
// (PolyTablePack.image), laid out by n_fn, n_sub (the pack's sub-interval
// count) and m8 / m16 / m32 (its code groups' entries).
extern "C" cudaError_t tp_poly_lookup(const void* x, void* out, long long n, int dtype,
                                      const float* bounds, const float* invd,
                                      const float* base, const float* segs,
                                      const float* zero, const float* ramp,
                                      const float* scale, const void* codes,
                                      const void* image, int bo, int lo,
                                      int n_intervals, int lmax, int degree, int m,
                                      int code_bits, int extrapolate, int n_fn,
                                      int n_sub, int m8, int m16, int m32,
                                      void* stream) {
  const float* planes[7] = {bounds, invd, base, segs, zero, ramp, scale};
  return launch_poly<kValue>(x, out, nullptr, n, dtype, planes, codes, image, bo, lo,
                             n_intervals, lmax, degree, m, code_bits, extrapolate,
                             n_fn, n_sub, m8, m16, m32,
                             static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_poly_grad(const void* x, void* y, void* slope, long long n,
                                    int dtype, const float* bounds, const float* invd,
                                    const float* base, const float* segs,
                                    const float* zero, const float* ramp,
                                    const float* scale, const void* codes,
                                    const void* image, int bo, int lo,
                                    int n_intervals, int lmax, int degree, int m,
                                    int code_bits, int extrapolate, int n_fn,
                                    int n_sub, int m8, int m16, int m32,
                                    void* stream) {
  const float* planes[7] = {bounds, invd, base, segs, zero, ramp, scale};
  return launch_poly<kGrad>(x, y, slope, n, dtype, planes, codes, image, bo, lo,
                            n_intervals, lmax, degree, m, code_bits, extrapolate, n_fn,
                            n_sub, m8, m16, m32, static_cast<cudaStream_t>(stream));
}

// Routed f32 pack: x holds `rows` rows of n / rows columns; row r goes
// through member ids[r] (clamped to [0, n_fn - 1]).  ids, n_arr (interval
// counts), starts (each member's row start in the staging image) and extr
// (extrapolate flags) are int32 device vectors, ids of `rows` entries, the
// others of n_fn.  `image` is the pack's staging image (TablePack.image),
// holding m_img of the values after the rows of the pack's n_sub
// sub-intervals.
extern "C" cudaError_t tp_routed_lookup(const void* x, void* out, long long n,
                                        int dtype, const int* ids, const int* n_arr,
                                        const int* starts, const int* extr,
                                        const float* bounds, const float* invd,
                                        const float* base, const float* segs,
                                        const float* values, const float* image,
                                        int n_fn, int n_max, int m, int n_sub,
                                        int m_img, int rows, void* stream) {
  return launch_routed_image<kValue>(x, out, nullptr, n, dtype, ids, n_arr, starts,
                                     extr, bounds, invd, base, segs, values, image,
                                     n_fn, n_max, m, n_sub, m_img, rows,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_routed_grad(const void* x, void* y, void* slope, long long n,
                                      int dtype, const int* ids, const int* n_arr,
                                      const int* starts, const int* extr,
                                      const float* bounds, const float* invd,
                                      const float* base, const float* segs,
                                      const float* values, const float* image,
                                      int n_fn, int n_max, int m, int n_sub, int m_img,
                                      int rows, void* stream) {
  return launch_routed_image<kGrad>(x, y, slope, n, dtype, ids, n_arr, starts, extr,
                                    bounds, invd, base, segs, values, image, n_fn,
                                    n_max, m, n_sub, m_img, rows,
                                    static_cast<cudaStream_t>(stream));
}

// Routed quantized pack: as tp_routed_lookup, with bo / lo (each member's
// boundary and lane offsets) and bits (its code width, 8 or 16) gathered by
// fn_id too, and both width groups passed (codes8 of m8 entries, codes16 of
// m16).  Plane order: bounds, invd, base, segs, scale, zero, ramp.  `image`
// is the pack's staging image (QuantTablePack.image) and n_sub its
// sub-interval count.
extern "C" cudaError_t tp_routed_quant_lookup(
    const void* x, void* out, long long n, int dtype, const int* ids,
    const int* n_arr, const int* extr, const int* bo, const int* lo, const int* bits,
    const float* bounds, const float* invd, const float* base, const float* segs,
    const float* scale, const float* zero, const float* ramp, const void* codes8,
    const void* codes16, const void* image, int n_fn, int max_n, int m8, int m16,
    int n_sub, int rows, void* stream) {
  const int* routing[6] = {ids, n_arr, extr, bo, lo, bits};
  const float* planes[7] = {bounds, invd, base, segs, scale, zero, ramp};
  return launch_routed_quant<kValue>(x, out, nullptr, n, dtype, routing, planes,
                                     codes8, codes16, image, n_fn, max_n, m8, m16,
                                     n_sub, rows, static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_routed_quant_grad(
    const void* x, void* y, void* slope, long long n, int dtype, const int* ids,
    const int* n_arr, const int* extr, const int* bo, const int* lo, const int* bits,
    const float* bounds, const float* invd, const float* base, const float* segs,
    const float* scale, const float* zero, const float* ramp, const void* codes8,
    const void* codes16, const void* image, int n_fn, int max_n, int m8, int m16,
    int n_sub, int rows, void* stream) {
  const int* routing[6] = {ids, n_arr, extr, bo, lo, bits};
  const float* planes[7] = {bounds, invd, base, segs, scale, zero, ramp};
  return launch_routed_quant<kGrad>(x, y, slope, n, dtype, routing, planes, codes8,
                                    codes16, image, n_fn, max_n, m8, m16, n_sub, rows,
                                    static_cast<cudaStream_t>(stream));
}

// Routed polynomial pack: as tp_routed_quant_lookup, with strides (each
// member's degree + 1) gathered by fn_id too, bits 8, 16 or 32, and the three
// width groups passed (codes8 of m8 entries, codes16 of m16, codes32 of m32
// raw f32 coefficients); lmax is the pack's lane count.  Plane order: bounds,
// invd, base, segs, zero, ramp, scale (the dequant planes lane-padded).
// `image` is the pack's staging image (PolyTablePack.image) and n_sub its
// sub-interval count.
extern "C" cudaError_t tp_routed_poly_lookup(
    const void* x, void* out, long long n, int dtype, const int* ids,
    const int* n_arr, const int* extr, const int* bo, const int* lo, const int* bits,
    const int* strides, const float* bounds, const float* invd, const float* base,
    const float* segs, const float* zero, const float* ramp, const float* scale,
    const void* codes8, const void* codes16, const void* codes32, const void* image,
    int n_fn, int max_n, int lmax, int m8, int m16, int m32, int n_sub, int rows,
    void* stream) {
  const int* routing[7] = {ids, n_arr, extr, bo, lo, bits, strides};
  const float* planes[7] = {bounds, invd, base, segs, zero, ramp, scale};
  return launch_routed_poly<kValue>(x, out, nullptr, n, dtype, routing, planes,
                                    codes8, codes16, codes32, image, n_fn, max_n, lmax,
                                    m8, m16, m32, n_sub, rows,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_routed_poly_grad(
    const void* x, void* y, void* slope, long long n, int dtype, const int* ids,
    const int* n_arr, const int* extr, const int* bo, const int* lo, const int* bits,
    const int* strides, const float* bounds, const float* invd, const float* base,
    const float* segs, const float* zero, const float* ramp, const float* scale,
    const void* codes8, const void* codes16, const void* codes32, const void* image,
    int n_fn, int max_n, int lmax, int m8, int m16, int m32, int n_sub, int rows,
    void* stream) {
  const int* routing[7] = {ids, n_arr, extr, bo, lo, bits, strides};
  const float* planes[7] = {bounds, invd, base, segs, zero, ramp, scale};
  return launch_routed_poly<kGrad>(x, y, slope, n, dtype, routing, planes, codes8,
                                   codes16, codes32, image, n_fn, max_n, lmax, m8, m16,
                                   m32, n_sub, rows, static_cast<cudaStream_t>(stream));
}

// RangeFold over the f32 pack: member rows fid_a / fid_b are the core members
// (sin_core and cos_core for kind sin or cos; fid_b = fid_a = exp_core or
// log_core for exp or log) with n_a / n_b real sub-intervals; values has m
// entries; `image` is the kind's staging image (TablePack.fold_images),
// holding m_img of the values.
extern "C" cudaError_t tp_folded_lookup(const void* x, void* out, long long n,
                                        int dtype, const float* bounds,
                                        const float* invd, const float* base,
                                        const float* segs, const float* values,
                                        const float* image, int fid_a, int fid_b,
                                        int n_max, int n_a, int n_b, int m, int kind,
                                        int m_img, void* stream) {
  return launch_folded<kValue>(x, out, nullptr, n, dtype, bounds, invd, base, segs,
                               values, image, fid_a, fid_b, n_max, n_a, n_b, m, kind,
                               m_img, static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_folded_grad(const void* x, void* y, void* slope, long long n,
                                      int dtype, const float* bounds, const float* invd,
                                      const float* base, const float* segs,
                                      const float* values, const float* image,
                                      int fid_a, int fid_b, int n_max, int n_a, int n_b,
                                      int m, int kind, int m_img, void* stream) {
  return launch_folded<kGrad>(x, y, slope, n, dtype, bounds, invd, base, segs, values,
                              image, fid_a, fid_b, n_max, n_a, n_b, m, kind, m_img,
                              static_cast<cudaStream_t>(stream));
}

// The sharded pack of S = n_shards shards, member fn_id, shards [s_begin,
// s_end) summed in shard order: bounds / invd / segs are the replicated
// (F, n_max[+1]) planes, obase / owner the (F, n_max) owner-rebased-base and
// owner planes, values the (S, m) padded slices.  slope = 0: the masked
// lerps; 1: the masked slopes (the value kernel's slope mode).
extern "C" cudaError_t tp_spack_lookup(const void* x, void* out, long long n, int dtype,
                                       const float* bounds, const float* invd,
                                       const float* obase, const float* segs,
                                       const float* owner, const float* values,
                                       int fn_id, int n_max, int n_intervals, int m,
                                       int n_shards, int s_begin, int s_end,
                                       int extrapolate, int slope, void* stream) {
  if (slope) {
    return launch_spack<kSlope>(x, out, nullptr, n, dtype, bounds, invd, obase, segs,
                                owner, values, fn_id, n_max, n_intervals, m, n_shards,
                                s_begin, s_end, extrapolate,
                                static_cast<cudaStream_t>(stream));
  }
  return launch_spack<kValue>(x, out, nullptr, n, dtype, bounds, invd, obase, segs,
                              owner, values, fn_id, n_max, n_intervals, m, n_shards,
                              s_begin, s_end, extrapolate,
                              static_cast<cudaStream_t>(stream));
}

// Value and slope of shards [s_begin, s_end), planes as tp_spack_lookup's,
// then the pack's staging image (ShardedTablePack.image; nullptr for none)
// with its member count n_fn and values start v_at: over all the shards
// (what the wrapper passes) spack_image_kernel stages it where it fits;
// otherwise spack_kernel stages the member's rows and the range's slices as
// the budget allows.
extern "C" cudaError_t tp_spack_grad(const void* x, void* y, void* slope, long long n,
                                     int dtype, const float* bounds, const float* invd,
                                     const float* obase, const float* segs,
                                     const float* owner, const float* values,
                                     const float* image, int fn_id, int n_max,
                                     int n_intervals, int m, int n_shards, int s_begin,
                                     int s_end, int extrapolate, int n_fn, int v_at,
                                     void* stream) {
  return launch_spack<kGrad>(x, y, slope, n, dtype, bounds, invd, obase, segs, owner,
                             values, fn_id, n_max, n_intervals, m, n_shards, s_begin,
                             s_end, extrapolate, static_cast<cudaStream_t>(stream), image,
                             n_fn, v_at);
}

// Routed over the S-shard pack, shards [s_begin, s_end) summed: as
// tp_routed_lookup, with the owner-rebased-base plane in place of base, the
// owner plane and the (S, m) padded values slices.
extern "C" cudaError_t tp_sharded_routed_lookup(
    const void* x, void* out, long long n, int dtype, const int* ids,
    const int* n_arr, const int* extr, const float* bounds, const float* invd,
    const float* obase, const float* segs, const float* owner, const float* values,
    int n_fn, int n_max, int m, int n_shards, int s_begin, int s_end, int rows,
    void* stream) {
  return launch_routed<kValue, true>(x, out, nullptr, n, dtype, ids, n_arr, extr,
                                     bounds, invd, obase, segs, values, owner, n_fn,
                                     n_max, m, n_shards, s_begin, s_end, rows,
                                     static_cast<cudaStream_t>(stream));
}

// Value and slope, planes as tp_sharded_routed_lookup's, then the pack's
// staging image (ShardedTablePack.image; nullptr for none) and its values
// start v_at: over all the shards (what the wrapper passes)
// spack_image_kernel stages it where it and the flags fit; otherwise
// routed_kernel restages the member's rows per member.
extern "C" cudaError_t tp_sharded_routed_grad(
    const void* x, void* y, void* slope, long long n, int dtype, const int* ids,
    const int* n_arr, const int* extr, const float* bounds, const float* invd,
    const float* obase, const float* segs, const float* owner, const float* values,
    const float* image, int n_fn, int n_max, int m, int n_shards, int s_begin,
    int s_end, int rows, int v_at, void* stream) {
  return launch_routed<kGrad, true>(x, y, slope, n, dtype, ids, n_arr, extr, bounds,
                                    invd, obase, segs, values, owner, n_fn, n_max, m,
                                    n_shards, s_begin, s_end, rows,
                                    static_cast<cudaStream_t>(stream), image, v_at);
}

extern "C" const char* tp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
