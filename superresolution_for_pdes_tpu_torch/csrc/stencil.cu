// Hand-written Hopper (sm_90a) kernels for the truncated 5-point stencil of
// the physics loss (K1) and the Galerkin V-cycle's finest level (K2, K3).
//
//   L u = (S(u) - 4 u) / h^2,   S(u) = u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1],
//
// with every value outside the n x n grid taken as zero. A launch covers a
// batch of (n, n) float32 slabs. S is summed in the order written above and
// every division by h^2 is a true division, as the plain PyTorch twins
// (ops/stencil_kernels.py) compute them.
//
// K1  replaces superresolution_for_pdes_tpu/ops/pallas_stencil.py
//     pallas_apply_operator (_apply_op_kernel), theta * (S(u) - 4u) / h^2, and
//     carries the physics loss, in three kernels on one band template:
//       pde_operator_kernel      out = theta * L u (theta a field or a scalar);
//       pde_loss_forward_kernel  u = pred * u_std + u_mean as the tile is staged,
//                                r = (theta * L u - f) / f_std, a partial sum
//                                of r^2 per block and, when a gradient is
//                                wanted, the backward's seed s = theta * r / f_std
//                                (pde_loss_forward_sum_kernel then gives the
//                                loss sum(r^2) / N);
//       pde_loss_backward_kernel grad_pred = u_std * L((2 g / N) * s), which is
//                                the gradient because the truncated L is
//                                symmetric.
//     u_mean, u_std and f_std are one value for the batch or one per slab.
//     The loss kernels take pred, theta and f as float32 or bfloat16 (the
//     element type T of the band template; the bf16 instantiations serve
//     training with --dtype bfloat16): every value is widened to float32 as
//     it is read, the statistics arrive as float32 (the wrapper widens bf16
//     ones exactly), all arithmetic, the seed s, the partial sums and the
//     loss are float32, in the same order for both types, and the backward
//     writes the gradient in T, rounded to nearest even once at the store.
//     A bf16 launch reads half the bytes of pred, theta and f.
//     Design: a block owns a band of whole rows of one slab and stages it with
//     one halo row above and below in shared memory. The band plus its halo
//     is one contiguous run of the slab, so the load is a flat copy (float4
//     when n % 4 == 0 and the pointers are 16-byte aligned) in which only the
//     halo rows outside the grid are padding. The band height is chosen so
//     that a launch has about 132 blocks (one per SM) or, for a large batch,
//     one band per slab; a thread handles 1 or 4 consecutive points per step
//     and tracks its column with a counter, so no loop divides by n; the
//     divisions by h^2 and f_std are exact reciprocal multiplies (div_rn).
//     The loss is reduced deterministically and without state kept between
//     calls: each block writes its partial sum (fixed warp-shuffle tree) to
//     the call's scratch, and a second one-block launch on the same stream
//     (pde_loss_forward_sum_kernel) adds the partials in a fixed order. No
//     float atomics and no counters, so the same inputs give the same bits on
//     every run, on any stream and in a captured CUDA graph.
//     Bound on an H100 (3.35 TB/s): bytes. At the training batch (32, 40, 40)
//     the forward reads pred, theta, f and writes s (819 KB, 0.24 us) and the
//     backward reads s and writes the gradient (410 KB, 0.12 us): the launch
//     latency dominates, which is why the loss's elementwise tail is fused in.
//     In bf16 at the r7bf16 batch (256, 40, 40) the forward reads 2.46 MB and
//     writes the float32 seed (1.64 MB), the backward reads the seed and
//     writes a bf16 gradient (2.46 MB).
//
// K3  srpde_jacobi -- replaces superresolution_for_pdes_tpu/ops/pallas_stencil.py
//     pallas_jacobi_smooth (_jacobi_kernel): `iters` weighted-Jacobi sweeps
//     u <- u + (omega h^2 / 4) (b + (S(u) - 4u) / h^2) for (-L) u = b, every
//     point from the previous iterate, with the points outside the grid
//     rewritten as exact zeros in every sweep (the truncated stencil's
//     padding). One launch runs up to kMaxFusedIters sweeps (the wrapper
//     chains launches beyond that).
//     Design (temporal blocking in registers): a block is 32 lanes wide and
//     stages 128 columns (120 outputs plus a 4-column halo each side, one
//     float4 per lane) by blockDim.y * 2 rows (the outputs plus an iters-row
//     halo above and below). A thread keeps a 2 x 4 patch of u and of b in
//     registers: u and b are read once, as float4 where n % 4 == 0. In each
//     sweep, horizontal neighbours come from the next lanes by warp shuffle
//     and vertical ones from the thread's own patch or, at its top and bottom
//     rows, from its neighbours through a small shared exchange (ping-pong,
//     one __syncthreads() a sweep). Every sweep updates the whole staged tile;
//     a neighbour beyond the staged tile reads as zero, which corrupts one more
//     ring of the halo per sweep, so after `iters` <= 4 sweeps the outputs are
//     exact. The division by h^2 is a reciprocal multiply with one FMA
//     correction (div_rn), which gives the division's bits at a third of its
//     instructions: with the IEEE division the sweeps were bound by issue, not
//     by memory. blockDim.y is the one with the fewest threads per SM
//     (launch_jacobi); batch 1 at 640^2 runs 324 blocks of 256 threads, all
//     resident at once. No loop divides by n.
//     Bound on an H100: bytes. It reads u and b and writes out once for all
//     sweeps, 12 bytes a point: 4.9 MB, 1.5 us at 640^2.
//
// K2  srpde_residual -- replaces superresolution_for_pdes_tpu/ops/pallas_stencil.py
//     pallas_residual (_residual_kernel): r = f - theta * (S(u) - 4u) / h^2,
//     and, fused with K3, the V-cycle's finest-level pre-smooth followed by
//     its residual (superresolution_for_pdes_tpu/solver/multigrid.py:112-113):
//     `iters` sweeps as K3, then r = b - theta * L u of the result.
//     The same template as K3 (sweep_body; entry points jacobi_kernel for K3,
//     smooth_residual_kernel for K2 and the fused step) with a residual
//     epilogue: after its sweeps (iters = 0 is plain K2) the block makes one
//     more pass over its patch (shuffles and the shared exchange, as a sweep)
//     that forms L u in
//     registers, and the store writes r = f - theta * L u and, when iters > 0,
//     the smoothed u. The residual needs one more exact ring than the sweeps,
//     so the halo is iters + 1 rows and columns: at most 3 sweeps before the
//     epilogue in the 4-column halo (the wrapper runs K3 launches before it
//     for more). theta is a field, or a scalar when the theta pointer is null:
//     the V-cycle's theta == -1 reads no theta field, and a theta field is
//     read only at the outputs. Sums in the twins' order: up + dn + l + r - 4c,
//     then f - theta * lap.
//     Bound on an H100: bytes. K2 with scalar theta reads u and f and writes
//     r, 12 bytes a point: 4.9 MB, 1.5 us at 640^2; the fused pre-smooth and
//     residual read u and b and write u and r, 16 bytes a point: 6.6 MB,
//     1.96 us at 640^2, where K3 and K2 as two launches move 24.
//
// Build (ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 --fmad=false
//        -shared -Xcompiler -fPIC -o libstencil.so stencil.cu
// --fmad=false keeps every product and sum rounded on its own, the way the
// plain PyTorch twins compute them.
//
// Each C entry point launches on the given stream, allocates nothing and
// returns a cudaError_t as int (cudaGetLastError() after the launch) so the
// Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

// ---------------------------------------------------------- vector helpers
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = p[j];
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = x[j];
  }
}

// bfloat16 rows: V values widened to float32 as they are read (8 bytes for V =
// 4, so 8-byte alignment), and rounded to nearest even as they are stored.
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = __bfloat162float(p[j]);
  }
}

template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned int*>(&lo);
    t.y = *reinterpret_cast<const unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = __float2bfloat16_rn(x[j]);
  }
}

// x / d, correctly rounded, given inv_d = RN(1 / d). q = RN(x inv_d) is within
// an ulp of x / d, x - q d is exact in one FMA, and q + (x - q d) inv_d
// rounded once is RN(x / d) (Markstein's theorem; no overflow or underflow at
// these magnitudes): the bits of the division, in a multiply and two FMAs
// instead of the division's reciprocal, iterations and range checks.
__device__ __forceinline__ float div_rn(float x, float d, float inv_d) {
  const float q = __fmul_rn(x, inv_d);
  return __fmaf_rn(__fmaf_rn(-q, d, x), inv_d, q);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the sum, in a fixed order
}

// ------------------------------------------------------------------ K1
constexpr int kBandThreads = 256;        // most threads per band block
constexpr int kNumSMs = 132;             // SMs of an H100: the launches aim at one block each
constexpr int kBandMaxSmem = 48 * 1024;  // the staged band, without opting in to more

enum Mode { kOperator, kLossForward, kLossBackward };

// The fields' element type T is float, or __nv_bfloat16 for the loss kernels;
// the band template casts the pointers.
struct BandArgs {
  const void* u;         // kOperator: u (float); kLossForward: pred_norm (T);
                         // kLossBackward: seed s (float)
  const void* theta;     // T: a field of u's shape, or null for theta_scalar
  float theta_scalar;
  const void* f;         // T
  const float* u_mean;   // the stats: [slab * stride], stride 0 (one value) or 1
  const float* u_std;
  const float* f_std;
  int u_mean_stride, u_std_stride, f_std_stride;
  const float* g_out;    // kLossBackward: the incoming 0-d gradient
  void* out;             // theta L u (float); the seed s (float; null: none);
                         // grad_pred (T)
  float* partial;        // kLossForward: one sum per block
  float count;           // N = batch n n
  int n, rows, bands;    // rows per band, bands per slab
  float h2;
};

// One band of rows [r0, r0 + rows) of one slab: stage it with a one-row halo,
// then every output point, V consecutive points (one row) per step. T is the
// element type of pred, theta and f (forward) or of the gradient (backward);
// the staged band and all arithmetic are float32.
template <int kMode, int V, typename T>
__device__ __forceinline__ void band_body(const BandArgs& a) {
  using In = std::conditional_t<kMode == kLossBackward, float, T>;    // the staged field
  using Out = std::conditional_t<kMode == kLossForward, float, T>;    // what is stored
  const In* u_in = static_cast<const In*>(a.u);
  const T* theta_in = static_cast<const T*>(a.theta);
  const T* f_in = static_cast<const T*>(a.f);
  Out* out = static_cast<Out*>(a.out);
  extern __shared__ float4 band_smem[];  // (rows + 2) x n floats, 16-byte aligned
  float* band = reinterpret_cast<float*>(band_smem);
  __shared__ float warp_sums[kBandThreads / 32];
  const int n = a.n;
  const int slab = blockIdx.x / a.bands;
  const int r0 = (blockIdx.x - slab * a.bands) * a.rows;
  const int rows = min(a.rows, n - r0);
  const long long slab_base = static_cast<long long>(slab) * n * n;

  // The staged value is u * scale + shift (forward: the denormalized
  // prediction) or scale * u (backward: (2 g / N) s); out_scale is u_std.
  float scale = 1.0f, shift = 0.0f, fs = 1.0f, out_scale = 1.0f;
  if constexpr (kMode == kLossForward) {
    scale = a.u_std[slab * a.u_std_stride];
    shift = a.u_mean[slab * a.u_mean_stride];
    fs = a.f_std[slab * a.f_std_stride];
  } else if constexpr (kMode == kLossBackward) {
    scale = (2.0f * a.g_out[0]) / a.count;
    out_scale = a.u_std[slab * a.u_std_stride];
  }
  const float inv_h2 = 1.0f / a.h2, inv_fs = 1.0f / fs;

  // theta (and f) of a step are loaded a step ahead, the first before the
  // staging barrier, so that their latency overlaps the band's load.
  const int points = rows * n;
  const long long out0 = slab_base + static_cast<long long>(r0) * n;
  const int stride = blockDim.x * V;
  auto load_fields = [&](int k, float (&th)[V], float (&fv)[V]) {
    if (k >= points) return;
    if constexpr (kMode == kOperator) {
      if (theta_in != nullptr) {
        load_v<V>(theta_in + (out0 + k), th);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) th[j] = a.theta_scalar;
      }
    } else if constexpr (kMode == kLossForward) {
      load_v<V>(theta_in + (out0 + k), th);
      load_v<V>(f_in + (out0 + k), fv);
    }
  };
  float th[V] = {}, fv[V] = {};
  load_fields(threadIdx.x * V, th, fv);

  // Rows r0 - 1 .. r0 + rows are one contiguous run; the rows outside the
  // grid (k < lo, k >= hi) are the zero padding.
  const long long g0 = slab_base + static_cast<long long>(r0 - 1) * n;
  const int staged = (rows + 2) * n;
  const int lo = r0 == 0 ? n : 0;
  const int hi = min(staged, (n - r0 + 1) * n);
  for (int k = threadIdx.x * V; k < staged; k += blockDim.x * V) {
    float x[V];
    if (k >= lo && k < hi) {
      load_v<V>(u_in + (g0 + k), x);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (kMode == kLossForward) x[j] = x[j] * scale + shift;
        if constexpr (kMode == kLossBackward) x[j] = scale * x[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = 0.0f;
    }
    store_v<V>(band + k, x);
  }
  __syncthreads();

  const int step = stride % n;           // once per thread, outside the loop
  int col = (threadIdx.x * V) % n;
  float acc = 0.0f;
  for (int k = threadIdx.x * V; k < points; k += stride) {
    float th_next[V] = {}, fv_next[V] = {};
    load_fields(k + stride, th_next, fv_next);
    const float* c = band + n + k;
    float cen[V], up[V], dn[V], lap[V], res[V];
    load_v<V>(c, cen);
    load_v<V>(c - n, up);
    load_v<V>(c + n, dn);
    const float left = col > 0 ? c[-1] : 0.0f;
    const float right = col + V < n ? c[V] : 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float l = j == 0 ? left : cen[j - 1];
      const float r = j == V - 1 ? right : cen[j + 1];
      lap[j] = div_rn(up[j] + dn[j] + l + r - 4.0f * cen[j], a.h2, inv_h2);
    }
    const long long g = out0 + k;
    if constexpr (kMode == kOperator) {
#pragma unroll
      for (int j = 0; j < V; ++j) res[j] = th[j] * lap[j];
      store_v<V>(out + g, res);
    } else if constexpr (kMode == kLossForward) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float r = div_rn(th[j] * lap[j] - fv[j], fs, inv_fs);
        acc = acc + r * r;
        res[j] = div_rn(th[j] * r, fs, inv_fs);
      }
      if (out != nullptr) store_v<V>(out + g, res);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) res[j] = out_scale * lap[j];
      store_v<V>(out + g, res);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      th[j] = th_next[j];
      fv[j] = fv_next[j];
    }
    col += step;
    if (col >= n) col -= n;
  }

  if constexpr (kMode == kLossForward) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    acc = warp_sum(acc);
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int w = 0; w < warps; ++w) s += warp_sums[w];
      a.partial[blockIdx.x] = s;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kBandThreads) pde_operator_kernel(const BandArgs a) {
  band_body<kOperator, V, float>(a);
}

template <int V, typename T>
__global__ void __launch_bounds__(kBandThreads) pde_loss_forward_kernel(const BandArgs a) {
  band_body<kLossForward, V, T>(a);
}

template <int V, typename T>
__global__ void __launch_bounds__(kBandThreads) pde_loss_backward_kernel(const BandArgs a) {
  band_body<kLossBackward, V, T>(a);
}

// The loss forward's second launch, one block: the forward blocks' partial
// sums added in a fixed order (a strided sum per thread, then the warp-shuffle
// tree), divided by N.
__global__ void __launch_bounds__(kBandThreads)
pde_loss_forward_sum_kernel(const float* __restrict__ partial, int blocks, float count,
                            float* __restrict__ loss) {
  __shared__ float warp_sums[kBandThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s = 0.0f;
  for (int i = threadIdx.x; i < blocks; i += kBandThreads) s += partial[i];
  s = warp_sum(s);
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kBandThreads / 32; ++w) total += warp_sums[w];
    *loss = total / count;
  }
}

// Band height, bands per slab and threads for a batch of n x n slabs; false
// when one row and its halo do not fit in the shared memory.
bool band_plan(BandArgs& a, int batch, int n, int vec, dim3& grid, dim3& block, size_t& smem) {
  const int max_rows = kBandMaxSmem / static_cast<int>(sizeof(float) * n) - 2;
  if (max_rows < 1) return false;
  const int want_bands = std::min(n, (kNumSMs + batch - 1) / batch);
  const int rows = std::min(max_rows, (n + want_bands - 1) / want_bands);
  a.n = n;
  a.rows = rows;
  a.bands = (n + rows - 1) / rows;
  const int items = (rows * n + (vec ? 3 : 0)) / (vec ? 4 : 1);
  const int threads = std::min(kBandThreads, std::max(32, (items + 31) / 32 * 32));
  grid = dim3(static_cast<unsigned>(batch) * a.bands);
  block = dim3(threads);
  smem = static_cast<size_t>(rows + 2) * n * sizeof(float);
  a.count = static_cast<float>(static_cast<long long>(batch) * n * n);
  return true;
}

// kLossForward also sums the partials into `loss` in a second launch. T is the
// loss kernels' element type (kOperator is float only).
template <typename T>
int launch_band(int mode, BandArgs a, int batch, int n, int vec, void* stream,
                float* loss = nullptr) {
  dim3 grid, block;
  size_t smem;
  if (!band_plan(a, batch, n, vec, grid, block, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kOperator) {
    if (vec) pde_operator_kernel<4><<<grid, block, smem, s>>>(a);
    else pde_operator_kernel<1><<<grid, block, smem, s>>>(a);
  } else if (mode == kLossForward) {
    if (vec) pde_loss_forward_kernel<4, T><<<grid, block, smem, s>>>(a);
    else pde_loss_forward_kernel<1, T><<<grid, block, smem, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    pde_loss_forward_sum_kernel<<<1, kBandThreads, 0, s>>>(a.partial, static_cast<int>(grid.x),
                                                           a.count, loss);
  } else {
    if (vec) pde_loss_backward_kernel<4, T><<<grid, block, smem, s>>>(a);
    else pde_loss_backward_kernel<1, T><<<grid, block, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ K3 and K2
constexpr int kMaxFusedIters = 4;   // sweeps per launch = the 4-column halo
constexpr int kLanes = 32;          // float4 columns per block: 128 staged columns
constexpr int kPatch = 2;           // rows per thread (1 and 4 measured slower)
constexpr int kOutW = 4 * kLanes - 8;  // 120 output columns per block
constexpr int kMaxTy = 16;          // at most 512 threads

// The host's bundle of a launch's arguments.
struct SweepArgs {
  const float* u;
  const float* b;        // the right-hand side: K3's b; K2's f
  const float* theta;    // kResidual: a field of u's shape, or null for theta_scalar
  float theta_scalar;
  float* out;            // the smoothed u (K > 0)
  float* r_out;          // kResidual: r = b - theta L u of the smoothed u
  int n;
  float h2, scale;       // scale = omega h^2 / 4
};

// One block of K3 and K2: K sweeps over the staged tile; with kResidual one
// more pass forms L u of the result, and the store writes r = b - theta L u
// beside the smoothed u.
template <int K, bool kResidual, bool kVec>
__device__ __forceinline__ void sweep_body(const float* __restrict__ u,
                                           const float* __restrict__ b,
                                           const float* __restrict__ theta, float theta_scalar,
                                           float* __restrict__ out, float* __restrict__ r_out,
                                           int n, float h2, float scale) {
  constexpr int kHalo = kResidual ? K + 1 : K;  // rows (and at most 4 columns) of halo
  // [pass parity][top, bottom row][ty][lane]: what the rows above and below read
  __shared__ float4 edge[2][2][kMaxTy][kLanes];
  const int lane = threadIdx.x, ty = threadIdx.y, tys = blockDim.y;
  const int out_rows = tys * kPatch - 2 * kHalo;
  const int gx = static_cast<int>(blockIdx.x) * kOutW - 4 + 4 * lane;  // first column
  const int gy = static_cast<int>(blockIdx.y) * out_rows - kHalo + ty * kPatch;  // first row
  const long long base = static_cast<long long>(blockIdx.z) * n * n;
  const float inv_h2 = 1.0f / h2;

  bool col_in[4], row_in[kPatch];
#pragma unroll
  for (int j = 0; j < 4; ++j) col_in[j] = gx + j >= 0 && gx + j < n;
  float c[kPatch][4], rhs[kPatch][4];
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const int row = gy + i;
    row_in[i] = row >= 0 && row < n;
    const long long g = base + static_cast<long long>(row) * n + gx;
    if constexpr (kVec) {  // n % 4 == 0: a float4 is all inside the grid or all outside
      if (row_in[i] && col_in[0]) {
        const float4 tu = *reinterpret_cast<const float4*>(u + g);
        const float4 tb = *reinterpret_cast<const float4*>(b + g);
        c[i][0] = tu.x; c[i][1] = tu.y; c[i][2] = tu.z; c[i][3] = tu.w;
        rhs[i][0] = tb.x; rhs[i][1] = tb.y; rhs[i][2] = tb.z; rhs[i][3] = tb.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = rhs[i][j] = 0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = row_in[i] && col_in[j];
        c[i][j] = in ? u[g + j] : 0.0f;
        rhs[i][j] = in ? b[g + j] : 0.0f;
      }
    }
  }

  float lap_u[kPatch][4];  // kResidual: L u of the smoothed u
#pragma unroll
  for (int s = 0; s < kHalo; ++s) {
    const bool residual_pass = kResidual && s == K;  // known at compile time
    float4* top = &edge[s & 1][0][0][0];
    float4* bottom = &edge[s & 1][1][0][0];
    top[ty * kLanes + lane] = make_float4(c[0][0], c[0][1], c[0][2], c[0][3]);
    bottom[ty * kLanes + lane] =
        make_float4(c[kPatch - 1][0], c[kPatch - 1][1], c[kPatch - 1][2], c[kPatch - 1][3]);
    __syncthreads();
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 a4 = ty > 0 ? bottom[(ty - 1) * kLanes + lane] : zero;
    const float4 b4 = ty < tys - 1 ? top[(ty + 1) * kLanes + lane] : zero;
    const float above[4] = {a4.x, a4.y, a4.z, a4.w};
    const float below[4] = {b4.x, b4.y, b4.z, b4.w};
    float next[kPatch][4];
#pragma unroll
    for (int i = 0; i < kPatch; ++i) {
      float left = __shfl_up_sync(0xffffffffu, c[i][3], 1);
      float right = __shfl_down_sync(0xffffffffu, c[i][0], 1);
      if (lane == 0) left = 0.0f;
      if (lane == kLanes - 1) right = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float up = i == 0 ? above[j] : c[i - 1][j];
        const float dn = i == kPatch - 1 ? below[j] : c[i + 1][j];
        const float l = j == 0 ? left : c[i][j - 1];
        const float r = j == 3 ? right : c[i][j + 1];
        const float lap = div_rn(up + dn + l + r - 4.0f * c[i][j], h2, inv_h2);
        if (residual_pass) {
          lap_u[i][j] = lap;
        } else {
          const float v = c[i][j] + scale * (rhs[i][j] + lap);
          next[i][j] = row_in[i] && col_in[j] ? v : 0.0f;  // zero padding, never updated
        }
      }
    }
    if (!residual_pass) {
#pragma unroll
      for (int i = 0; i < kPatch; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = next[i][j];
      }
    }
  }

  if (lane == 0 || lane == kLanes - 1) return;  // the column halo
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const int local = ty * kPatch + i;
    if (local < kHalo || local >= kHalo + out_rows || !row_in[i]) continue;
    const long long g = base + static_cast<long long>(gy + i) * n + gx;
    if constexpr (kVec) {
      if (!col_in[0]) continue;
      if constexpr (K > 0) {
        *reinterpret_cast<float4*>(out + g) = make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
      }
      if constexpr (kResidual) {
        float th[4], res[4];
        if (theta != nullptr) {
          load_v<4>(theta + g, th);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) th[j] = theta_scalar;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) res[j] = rhs[i][j] - th[j] * lap_u[i][j];
        store_v<4>(r_out + g, res);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!col_in[j]) continue;
        if constexpr (K > 0) out[g + j] = c[i][j];
        if constexpr (kResidual) {
          const float th = theta != nullptr ? theta[g + j] : theta_scalar;
          r_out[g + j] = rhs[i][j] - th * lap_u[i][j];
        }
      }
    }
  }
}

// The two entry points take only the parameters they read, in the order a
// block reads them: while K3's parameter block also held K2's, its launches
// took longer by a constant with the same instructions, and this order
// shortened the fused launches.

// K3: K sweeps.
template <int K, bool kVec>
__global__ void __launch_bounds__(kLanes * kMaxTy)
jacobi_kernel(const float* __restrict__ u, const float* __restrict__ b,
              float* __restrict__ out, int n, float h2, float scale) {
  sweep_body<K, false, kVec>(u, b, nullptr, 0.0f, out, nullptr, n, h2, scale);
}

// K2 (K = 0), or K sweeps and then the residual (the fused pre-smooth).
template <int K, bool kVec>
__global__ void __launch_bounds__(kLanes * kMaxTy)
smooth_residual_kernel(const float* __restrict__ u, const float* __restrict__ f, int n,
                       float h2, float scale, float theta_scalar,
                       const float* __restrict__ theta, float* __restrict__ u_out,
                       float* __restrict__ r_out) {
  sweep_body<K, true, kVec>(u, f, theta, theta_scalar, u_out, r_out, n, h2, scale);
}

template <int K, bool kResidual>
int launch_jacobi(const SweepArgs& a, int batch, int vec, cudaStream_t stream) {
  // Block height: a block's time grows with its threads, and an SM runs the
  // blocks it gets one after another, so take the height with the fewest
  // threads per SM, ceil(blocks / 132) * tys (the taller on a tie: less
  // halo), among those that keep half of the staged rows as outputs.
  constexpr int kHalo = kResidual ? K + 1 : K;
  const int n = a.n;
  const int tiles_x = (n + kOutW - 1) / kOutW;
  int tys = 0;
  long long best = 0;
  for (int t = kMaxTy; t * kPatch >= 4 * kHalo; t /= 2) {
    const int rows = t * kPatch - 2 * kHalo;
    const long long blocks = static_cast<long long>(tiles_x) * ((n + rows - 1) / rows) * batch;
    const long long cost = (blocks + kNumSMs - 1) / kNumSMs * t;
    if (tys == 0 || cost < best) {
      tys = t;
      best = cost;
    }
  }
  const int rows = tys * kPatch - 2 * kHalo;
  const dim3 grid(tiles_x, (n + rows - 1) / rows, batch);
  const dim3 block(kLanes, tys);
  if constexpr (kResidual) {
    if (vec) {
      smooth_residual_kernel<K, true><<<grid, block, 0, stream>>>(
          a.u, a.b, n, a.h2, a.scale, a.theta_scalar, a.theta, a.out, a.r_out);
    } else {
      smooth_residual_kernel<K, false><<<grid, block, 0, stream>>>(
          a.u, a.b, n, a.h2, a.scale, a.theta_scalar, a.theta, a.out, a.r_out);
    }
  } else if (vec) {
    jacobi_kernel<K, true><<<grid, block, 0, stream>>>(a.u, a.b, a.out, n, a.h2, a.scale);
  } else {
    jacobi_kernel<K, false><<<grid, block, 0, stream>>>(a.u, a.b, a.out, n, a.h2, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int srpde_max_fused_iters() { return kMaxFusedIters; }

extern "C" int srpde_apply_operator(const float* theta, float theta_scalar, const float* u,
                                    float* out, int batch, int n, float h2, int vec,
                                    void* stream) {
  BandArgs a{};
  a.u = u;
  a.theta = theta;
  a.theta_scalar = theta_scalar;
  a.out = out;
  a.h2 = h2;
  return launch_band<float>(kOperator, a, batch, n, vec, stream);
}

// The loss forward: pred, theta and f are float32 (bf16 = 0) or bfloat16
// (bf16 = 1); the statistics, the seed and the loss are float32.
extern "C" int srpde_pde_loss_forward(const void* pred, const void* theta, const void* f,
                                      const float* u_mean, int u_mean_stride,
                                      const float* u_std, int u_std_stride,
                                      const float* f_std, int f_std_stride, float* seed,
                                      float* partial, float* loss, int batch, int n, float h2,
                                      int vec, int bf16, void* stream) {
  BandArgs a{};
  a.u = pred;
  a.theta = theta;
  a.f = f;
  a.u_mean = u_mean;
  a.u_std = u_std;
  a.f_std = f_std;
  a.u_mean_stride = u_mean_stride;
  a.u_std_stride = u_std_stride;
  a.f_std_stride = f_std_stride;
  a.out = seed;
  a.partial = partial;
  a.h2 = h2;
  return bf16 ? launch_band<__nv_bfloat16>(kLossForward, a, batch, n, vec, stream, loss)
              : launch_band<float>(kLossForward, a, batch, n, vec, stream, loss);
}

// The loss backward: the seed and u_std are float32; the gradient is written
// as float32 (bf16 = 0) or bfloat16 (bf16 = 1).
extern "C" int srpde_pde_loss_backward(const float* seed, const float* u_std, int u_std_stride,
                                       const float* g_out, void* grad, int batch, int n,
                                       float h2, int vec, int bf16, void* stream) {
  BandArgs a{};
  a.u = seed;
  a.u_std = u_std;
  a.u_std_stride = u_std_stride;
  a.g_out = g_out;
  a.out = grad;
  a.h2 = h2;
  return bf16 ? launch_band<__nv_bfloat16>(kLossBackward, a, batch, n, vec, stream)
              : launch_band<float>(kLossBackward, a, batch, n, vec, stream);
}

// K2 (iters = 0) or `iters` <= 3 K3 sweeps fused with it: r_out = f - theta
// L u of the smoothed u, which goes to u_out (unused when iters = 0).
extern "C" int srpde_residual(const float* theta, float theta_scalar, const float* u,
                              const float* f, float* u_out, float* r_out, int batch, int n,
                              float h2, float scale, int iters, int vec, void* stream) {
  const SweepArgs a{u, f, theta, theta_scalar, u_out, r_out, n, h2, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (iters) {
    case 0: return launch_jacobi<0, true>(a, batch, vec, s);
    case 1: return launch_jacobi<1, true>(a, batch, vec, s);
    case 2: return launch_jacobi<2, true>(a, batch, vec, s);
    case 3: return launch_jacobi<3, true>(a, batch, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int srpde_jacobi(const float* u, const float* b, float* out, int batch, int n,
                            float h2, float scale, int iters, int vec, void* stream) {
  const SweepArgs a{u, b, nullptr, 0.0f, out, nullptr, n, h2, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (iters) {
    case 1: return launch_jacobi<1, false>(a, batch, vec, s);
    case 2: return launch_jacobi<2, false>(a, batch, vec, s);
    case 3: return launch_jacobi<3, false>(a, batch, vec, s);
    case 4: return launch_jacobi<4, false>(a, batch, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
