// Hand-written Hopper (sm_90a) kernels for the truncated 5-point stencil of
// the physics loss (K1) and the Galerkin V-cycle's finest level (K2, K3).
//
//   L u = (S(u) - 4 u) / h^2,   S(u) = u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1],
//
// with every value outside the n x n grid taken as zero. A launch covers a
// batch of (n, n) float32 slabs: a 2-D grid of blocks tiles each slab and the
// batch index is blockIdx.z. Each block stages its tile plus a halo in shared
// memory and masks the grid edge and the ragged last tiles itself.
//
// K1  srpde_apply_operator -- replaces superresolution_for_pdes_tpu/ops/pallas_stencil.py
//     pallas_apply_operator (_apply_op_kernel): out = theta * (S(u) - 4u) / h^2.
//     theta is a field, or a scalar when the theta pointer is null. It is the
//     physics loss's operator; its gradient L(theta * g) is K1 again with
//     scalar theta = 1 (the truncated L is symmetric).
//     Bound on an H100: bytes. With a theta field it reads u and theta and
//     writes out, 12 bytes a point: 614 KB, 0.18 us for the training batch
//     (32, 40, 40), so at the loss's shapes the launch latency dominates. It
//     shares K2's tile, halo and masking (one template, stencil_kernel).
//
// K2  srpde_residual -- replaces superresolution_for_pdes_tpu/ops/pallas_stencil.py
//     pallas_residual (_residual_kernel): out = f - theta * (S(u) - 4u) / h^2.
//     theta is a field, or a scalar when the theta pointer is null: the
//     V-cycle's theta == -1 call then reads no theta field.
//     Bound on an H100 (3.35 TB/s): bytes. With scalar theta it must read u
//     and f and write out, 12 bytes a point: 4.9 MB, 1.5 us at 640^2. The
//     shared tile makes each u value come from device memory once per block
//     (plus a 1-point halo), so the kernel moves close to that minimum; at the
//     path's shapes (batch 1, 160^2 to 640^2) the launch latency dominates.
//
// K3  srpde_jacobi -- replaces superresolution_for_pdes_tpu/ops/pallas_stencil.py
//     pallas_jacobi_smooth (_jacobi_kernel): `iters` weighted-Jacobi sweeps
//     u <- u + (omega h^2 / 4) (b + (S(u) - 4u) / h^2) for (-L) u = b.
//     Design (a): one launch runs all sweeps (up to kMaxFusedIters; the
//     wrapper chains launches beyond that). The shared tile carries an
//     iters-wide halo of u and b; sweep s updates the tile shrunk by s points
//     on each side, ping-ponging two shared buffers with __syncthreads(), so
//     after `iters` sweeps the block's own tile is exact. Every point updates
//     from the previous iterate (Jacobi, not Gauss-Seidel). Halo points
//     outside the n x n grid are the truncated stencil's zero padding: they
//     are written as exactly 0 in every sweep.
//     Bound on an H100: bytes. It reads u and b and writes out once for all
//     sweeps, 12 bytes a point: 4.9 MB, 1.5 us at 640^2; the sweeps' reuse
//     stays in shared memory, bought with the halo's recomputed border.
//
// Build (ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 --fmad=false
//        -shared -Xcompiler -fPIC -o libstencil.so stencil.cu
// --fmad=false keeps every product and sum rounded on its own, the way the
// plain PyTorch twins (ops/stencil_kernels.py) compute them.
//
// Each C entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;          // outputs per block in x (= threads in x)
constexpr int kTileH = 16;          // outputs per block in y (= threads in y)
constexpr int kThreads = kTileW * kTileH;
constexpr int kMaxFusedIters = 4;   // sweeps per K3 launch

__device__ __forceinline__ bool in_grid(int y, int x, int n) {
  return y >= 0 && y < n && x >= 0 && x < n;
}

// K1 (kResidual = false): out = theta * lap. K2 (kResidual = true):
// out = f - theta * lap. f is read only by K2.
template <bool kResidual>
__global__ void __launch_bounds__(kThreads)
stencil_kernel(const float* __restrict__ theta, float theta_scalar,
               const float* __restrict__ u, const float* __restrict__ f,
               float* __restrict__ out, int n, float h2) {
  __shared__ float tile[kTileH + 2][kTileW + 2];
  const size_t slab = static_cast<size_t>(n) * n;
  const size_t base = static_cast<size_t>(blockIdx.z) * slab;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  for (int i = tid; i < (kTileH + 2) * (kTileW + 2); i += kThreads) {
    const int ly = i / (kTileW + 2);
    const int lx = i % (kTileW + 2);
    const int gy = y0 + ly - 1;
    const int gx = x0 + lx - 1;
    tile[ly][lx] = in_grid(gy, gx, n) ? u[base + static_cast<size_t>(gy) * n + gx] : 0.0f;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x;
  const int gy = y0 + threadIdx.y;
  if (gx >= n || gy >= n) return;
  const int lx = threadIdx.x + 1;
  const int ly = threadIdx.y + 1;
  const float c = tile[ly][lx];
  const float s = tile[ly - 1][lx] + tile[ly + 1][lx] + tile[ly][lx - 1] + tile[ly][lx + 1];
  const float lap = (s - 4.0f * c) / h2;
  const size_t idx = base + static_cast<size_t>(gy) * n + gx;
  const float th = theta != nullptr ? theta[idx] : theta_scalar;
  if constexpr (kResidual) {
    out[idx] = f[idx] - th * lap;
  } else {
    out[idx] = th * lap;
  }
}

__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const float* __restrict__ u, const float* __restrict__ b,
              float* __restrict__ out, int n, float h2, float scale, int iters) {
  extern __shared__ float smem[];
  const int w = kTileW + 2 * iters;
  const int h = kTileH + 2 * iters;
  float* src = smem;
  float* dst = smem + w * h;
  float* bs = smem + 2 * w * h;

  const size_t slab = static_cast<size_t>(n) * n;
  const size_t base = static_cast<size_t>(blockIdx.z) * slab;
  const int x0 = blockIdx.x * kTileW - iters;  // global coords of smem (0, 0)
  const int y0 = blockIdx.y * kTileH - iters;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  for (int i = tid; i < w * h; i += kThreads) {
    const int gy = y0 + i / w;
    const int gx = x0 + i % w;
    const bool inside = in_grid(gy, gx, n);
    const size_t g = base + static_cast<size_t>(gy) * n + gx;
    src[i] = inside ? u[g] : 0.0f;
    bs[i] = inside ? b[g] : 0.0f;
  }
  __syncthreads();

  for (int s = 1; s <= iters; ++s) {
    // Sweep s is exact on the tile shrunk by s points per side.
    const int rw = w - 2 * s;
    const int rh = h - 2 * s;
    for (int i = tid; i < rw * rh; i += kThreads) {
      const int ly = s + i / rw;
      const int lx = s + i % rw;
      const int k = ly * w + lx;
      float v = 0.0f;  // outside the grid: zero padding, never updated
      if (in_grid(y0 + ly, x0 + lx, n)) {
        const float c = src[k];
        const float sum = src[k - w] + src[k + w] + src[k - 1] + src[k + 1];
        const float lap = (sum - 4.0f * c) / h2;
        const float r = bs[k] + lap;
        v = c + scale * r;
      }
      dst[k] = v;
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  const int gx = blockIdx.x * kTileW + threadIdx.x;
  const int gy = blockIdx.y * kTileH + threadIdx.y;
  if (gx < n && gy < n) {
    out[base + static_cast<size_t>(gy) * n + gx] =
        src[(threadIdx.y + iters) * w + threadIdx.x + iters];
  }
}

dim3 grid_for(int n, int batch) {
  return dim3((n + kTileW - 1) / kTileW, (n + kTileH - 1) / kTileH, batch);
}

}  // namespace

extern "C" int srpde_max_fused_iters() { return kMaxFusedIters; }

extern "C" int srpde_apply_operator(const float* theta, float theta_scalar, const float* u,
                                    float* out, int batch, int n, float h2, void* stream) {
  stencil_kernel<false><<<grid_for(n, batch), dim3(kTileW, kTileH), 0,
                          static_cast<cudaStream_t>(stream)>>>(theta, theta_scalar, u, nullptr,
                                                               out, n, h2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srpde_residual(const float* theta, float theta_scalar, const float* u,
                              const float* f, float* out, int batch, int n, float h2,
                              void* stream) {
  stencil_kernel<true><<<grid_for(n, batch), dim3(kTileW, kTileH), 0,
                         static_cast<cudaStream_t>(stream)>>>(theta, theta_scalar, u, f, out, n, h2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srpde_jacobi(const float* u, const float* b, float* out, int batch, int n,
                            float h2, float scale, int iters, void* stream) {
  if (iters < 1 || iters > kMaxFusedIters) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * static_cast<size_t>(kTileW + 2 * iters) * (kTileH + 2 * iters) *
                      sizeof(float);
  jacobi_kernel<<<grid_for(n, batch), dim3(kTileW, kTileH), smem,
                  static_cast<cudaStream_t>(stream)>>>(u, b, out, n, h2, scale, iters);
  return static_cast<int>(cudaGetLastError());
}
