// Hopper kernels over a TablePack (f32 values + (F, n_max) metadata planes)
// or a single table (one metadata row: the same layout with F = 1).
//
//   tp_pack_lookup     replaces the TPU kernel _pack_kernel
//                      (src/repro/kernels/table_pack_lookup.py:43): one pack
//                      member's lerp, with optional linear extrapolation.
//   tp_tableflash_exp  replaces the TPU kernel _tableflash_kernel
//                      (src/repro/kernels/table_pack_lookup.py:188): the exp_neg
//                      lookup at max(z, lo), t clamped, exactly 0 where z < lo.
//   tp_pack_grad       replaces the TPU kernel _pack_grad_kernel
//                      (src/repro/kernels/table_pack_lookup.py:66): value and
//                      slope of one pack member from one selector pass.
//   tp_table_lookup    replaces the TPU kernel _table_kernel
//                      (src/repro/kernels/table_lookup.py:66): one table's lerp.
//   tp_table_grad      replaces the TPU kernel _table_grad_kernel
//                      (src/repro/kernels/table_grad.py:28): one table's value
//                      and slope from one selector pass.
//
// What bounds them on the card: bytes.  Each element is read once and its
// output(s) written once, N * (in_bytes + n_out * out_bytes) at 3.35 TB/s; the
// ~40 compare/gather/lerp operations per element are far below the card's
// rate.  At decode shapes they are launch-bound: the GLU silu gate at B=4 is
// 4 * 6912 = 27,648 bf16 elements, about 110 KB in and out, some 33 ns of
// memory time against a few microseconds of launch.  The training gate
// (4, 128, 6912) bf16 is 3.5 M elements, 21 MB through the grad kernel.
//
// Design.  The TPU kernels tiled x into (rows, 512) blocks and pinned the pack
// in VMEM.  Here a grid-stride loop walks the flat element count (ragged tail
// masked by the loop bound, no padding), and each block stages the member's
// metadata row and the values vector in shared memory — the counterpart of the
// VMEM/BRAM pinning — so the two data-dependent gathers hit shared memory.  A
// pack larger than the static shared budget is read from global memory (L2)
// instead; both paths are in the one kernel.  fn_id, n_intervals, n_max and
// extrapolate are runtime arguments: one compiled kernel per dtype and mode
// serves every member and every single table (a table is a pack of one row,
// n_max = n_intervals).  The grad mode writes the slope to a second output in
// the same pass.  Input and outputs are f32 or bf16 (the GLU gate arrives in
// bf16, the flash exponent in f32); the body computes in f32 and stores with
// round to nearest even.  Built with -fmad=false: bit-identical to the plain
// PyTorch versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "table_lookup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxIntervals = 64;       // n_max limit of the staged metadata row
constexpr int kSmemValues = 10240;      // 40 KB of staged values (static budget)
constexpr int kBlocksPerSM = 4;

enum Mode { kValue = 0, kFlash = 1, kGrad = 2 };

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// `slope` is written only in kGrad mode (nullptr otherwise).
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ slope,
            long long n, const float* __restrict__ bounds,
            const float* __restrict__ invd, const float* __restrict__ base,
            const float* __restrict__ segs, const float* __restrict__ values,
            int fn_id, int n_max, int n_intervals, int m, int extrapolate) {
  __shared__ float s_bounds[kMaxIntervals + 1];
  __shared__ float s_invd[kMaxIntervals];
  __shared__ float s_base[kMaxIntervals];
  __shared__ float s_segs[kMaxIntervals];
  __shared__ float s_values[kSmemValues];

  const float* row_b = bounds + static_cast<long long>(fn_id) * (n_max + 1);
  const long long row = static_cast<long long>(fn_id) * n_max;
  for (int k = threadIdx.x; k <= n_max; k += blockDim.x) s_bounds[k] = row_b[k];
  for (int k = threadIdx.x; k < n_max; k += blockDim.x) {
    s_invd[k] = invd[row + k];
    s_base[k] = base[row + k];
    s_segs[k] = segs[row + k];
  }
  const bool staged = m <= kSmemValues;
  if (staged) {
    for (int k = threadIdx.x; k < m; k += blockDim.x) s_values[k] = values[k];
  }
  __syncthreads();

  const tl::Row r{s_bounds, s_invd, s_base, s_segs, n_max, n_intervals};
  const float* vals = staged ? s_values : values;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < n; idx += stride) {
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

int grid_for(long long n) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_sm <= 0) n_sm = 1;
  }
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(n_sm) * kBlocksPerSM;
  return static_cast<int>(want < cap ? want : cap);
}

// Refuses (cudaErrorInvalidValue, no launch) a metadata row longer than the
// staged one (n_max > 64), an empty or inconsistent row, a values vector of
// fewer than two entries, and an unknown dtype.
template <int kMode>
cudaError_t launch(const void* x, void* out, void* slope, long long n, int dtype,
                   const float* bounds, const float* invd, const float* base,
                   const float* segs, const float* values, int fn_id, int n_max,
                   int n_intervals, int m, int extrapolate, cudaStream_t stream) {
  if (n_max < 1 || n_max > kMaxIntervals || n_intervals < 1 ||
      n_intervals > n_max || m < 2 || n < 0 || (kMode == kGrad && !slope)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const int blocks = grid_for(n);
  if (dtype == 0) {
    pack_kernel<float, kMode><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(out),
        static_cast<float*>(slope), n, bounds, invd, base, segs, values, fn_id,
        n_max, n_intervals, m, extrapolate);
  } else if (dtype == 1) {
    pack_kernel<__nv_bfloat16, kMode><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(slope), n, bounds, invd, base, segs, values,
        fn_id, n_max, n_intervals, m, extrapolate);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All pointers are device pointers; the
// launch is asynchronous on `stream`, allocates nothing, and returns the
// launch's own error (cudaGetLastError), which the Python wrapper raises on.
extern "C" cudaError_t tp_pack_lookup(const void* x, void* out, long long n, int dtype,
                              const float* bounds, const float* invd,
                              const float* base, const float* segs,
                              const float* values, int fn_id, int n_max,
                              int n_intervals, int m, int extrapolate,
                              void* stream) {
  return launch<kValue>(x, out, nullptr, n, dtype, bounds, invd, base, segs,
                        values, fn_id, n_max, n_intervals, m, extrapolate,
                        static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_tableflash_exp(const void* x, void* out, long long n, int dtype,
                                 const float* bounds, const float* invd,
                                 const float* base, const float* segs,
                                 const float* values, int fn_id, int n_max,
                                 int n_intervals, int m, void* stream) {
  return launch<kFlash>(x, out, nullptr, n, dtype, bounds, invd, base, segs,
                        values, fn_id, n_max, n_intervals, m, 0,
                        static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_pack_grad(const void* x, void* y, void* slope, long long n,
                            int dtype, const float* bounds, const float* invd,
                            const float* base, const float* segs,
                            const float* values, int fn_id, int n_max,
                            int n_intervals, int m, int extrapolate,
                            void* stream) {
  return launch<kGrad>(x, y, slope, n, dtype, bounds, invd, base, segs, values,
                       fn_id, n_max, n_intervals, m, extrapolate,
                       static_cast<cudaStream_t>(stream));
}

// A single table: bounds (n+1,), invd/base/segs (n,), values (m,).
extern "C" cudaError_t tp_table_lookup(const void* x, void* out, long long n, int dtype,
                               const float* bounds, const float* invd,
                               const float* base, const float* segs,
                               const float* values, int n_intervals, int m,
                               int extrapolate, void* stream) {
  return launch<kValue>(x, out, nullptr, n, dtype, bounds, invd, base, segs,
                        values, 0, n_intervals, n_intervals, m, extrapolate,
                        static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t tp_table_grad(const void* x, void* y, void* slope, long long n,
                             int dtype, const float* bounds, const float* invd,
                             const float* base, const float* segs,
                             const float* values, int n_intervals, int m,
                             int extrapolate, void* stream) {
  return launch<kGrad>(x, y, slope, n, dtype, bounds, invd, base, segs, values,
                       0, n_intervals, n_intervals, m, extrapolate,
                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* tp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
