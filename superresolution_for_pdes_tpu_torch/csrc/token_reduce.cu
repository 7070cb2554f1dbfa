// Hand-written Hopper (sm_90a) column reductions over the token axis for
// SwinIR's backward (models/swinir.py, ops/token_reduce.py): the linears'
// bias gradients and the LayerNorms' weight and bias gradients. They replace
// no TPU kernel: the JAX package has no SwinIR. They replace ATen's sum of a
// linear's output gradient (reduce_kernel, launched by AddmmBackward0's
// sum_to) and LayerNorm's GammaBetaBackward kernel, which ran at 13-19% of
// the bytes bound below at the training shape.
//
// What a launch computes, for a row-major (M, C) gradient g of M tokens:
//
//   bias      out[c]     = sum_r g[r, c]
//   norm      dweight[c] = sum_r g[r, c] (x[r, c] - mean[r]) rstd[r]
//             dbias[c]   = sum_r g[r, c]
//
// with x the LayerNorm's input, mean and rstd its forward's per-token
// statistics (float32). g and x are float32 or bfloat16 (SwinIR's linears
// under bf16 autocast); every value is widened to float32 as it is read, and
// all sums and the output are float32.
//
// Bound on an H100 (3.35 TB/s): bytes read. The sums do 1 (bias) or 4 (norm)
// operations a value read, far below the card's ~20 FLOP a byte. At the
// training shape (M = 32 x 40^2 = 51,200 tokens, C = 180, 360, 540) a bias
// sum reads 4 M C bytes (36.9 to 110.6 MB: 11 to 33 us), a LayerNorm's
// weight gradient 8 M C + 8 M (74.1 MB: 22 us); a train step's 144 bias
// sums and 74 LayerNorms read 9.29 and 5.48 GB (2.77 and 1.64 ms).
//
// Design: a block streams a contiguous range of whole rows, which is one
// contiguous run of g (and of x), in 16-byte float32 loads (8-byte for
// bfloat16) of 4 columns: the block is (C / 4) x ry threads, thread (cx, ty)
// owning columns 4 cx ... 4 cx + 3 of the rows ty, ty + ry, ..., so that
// consecutive threads read consecutive 16 bytes and one pass of the block
// reads ry whole rows. Each thread issues 4 row loads before it adds them, so
// that the SM keeps ~100 KB of loads in flight. The grid is one wave: as
// many blocks as the SMs hold at once (occupancy query), at most max_blocks
// and at most one a ry rows, each a range of ceil(M / blocks) rows; a thread
// sums at most a few dozen rows at the training shape. A block adds its
// threads' partials by a fixed tree over ty in shared memory and writes one
// partial row of (1 or 2) C floats; a second small launch on the same stream
// (token_reduce_finish_kernel) adds the blocks' rows in a fixed order. No
// float atomics and no state kept between calls, so the same inputs give the
// same bits on every run on one card model, in a captured CUDA graph too.
// C must be a multiple of 4 (every row then starts 16-byte aligned) and at
// most 4 * 1024; other widths and dtypes are refused (cudaErrorInvalidValue)
// and the wrapper raises before it launches.
//
// Each C entry point launches on the given stream, allocates nothing and
// returns a cudaError_t as int (cudaGetLastError() after the launches).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;            // columns a thread: one 16-byte float32 load
constexpr int kTarget = 512;       // threads a block, at most (unless C / 4 is more)
constexpr int kMaxThreads = 1024;  // so C / 4 <= 1024
constexpr int kUnroll = 4;         // row loads a thread has in flight

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void add4(float (&acc)[kVec], const float4 v) {
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}

// acc += g (x - mean) rstd, element by element
__device__ __forceinline__ void add_xhat4(float (&acc)[kVec], const float4 g, const float4 x,
                                          float mean, float rstd) {
  acc[0] = __fmaf_rn(g.x, (x.x - mean) * rstd, acc[0]);
  acc[1] = __fmaf_rn(g.y, (x.y - mean) * rstd, acc[1]);
  acc[2] = __fmaf_rn(g.z, (x.z - mean) * rstd, acc[2]);
  acc[3] = __fmaf_rn(g.w, (x.w - mean) * rstd, acc[3]);
}

// One block's rows [r0, r1) of g (and x): blockDim (C / 4, ry). Writes the
// block's partial row: partial[block][c] (bias), or partial[block][c] (weight)
// and partial[block][C + c] (bias) with kNorm.
template <typename T, bool kNorm>
__global__ void __launch_bounds__(kMaxThreads)
token_reduce_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    long long rows, int cols, long long rows_per_block,
                    float* __restrict__ partial) {
  extern __shared__ float red[];  // (ry, outs): the threads' partials
  const int cx = threadIdx.x, ty = threadIdx.y, ry = blockDim.y;
  const int col = cx * kVec;
  const int outs = kNorm ? 2 * cols : cols;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  float sb[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};  // sum of g
  float sw[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};  // sum of g (x - mean) rstd
  long long r = r0 + ty;
  for (; r + (kUnroll - 1) * ry < r1; r += kUnroll * ry) {
    float4 gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) gv[u] = load4(g + (r + u * ry) * cols + col);
    if constexpr (kNorm) {
      float4 xv[kUnroll];
      float m[kUnroll], s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xv[u] = load4(x + (r + u * ry) * cols + col);
        m[u] = __ldg(mean + r + u * ry);
        s[u] = __ldg(rstd + r + u * ry);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_xhat4(sw, gv[u], xv[u], m[u], s[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add4(sb, gv[u]);
  }
  for (; r < r1; r += ry) {
    const float4 gv = load4(g + r * cols + col);
    if constexpr (kNorm) {
      add_xhat4(sw, gv, load4(x + r * cols + col), __ldg(mean + r), __ldg(rstd + r));
    }
    add4(sb, gv);
  }
  // the block's rows: a fixed tree over ty
  float* mine = red + ty * outs;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if constexpr (kNorm) {
      mine[col + k] = sw[k];
      mine[cols + col + k] = sb[k];
    } else {
      mine[col + k] = sb[k];
    }
  }
  __syncthreads();
  int span = 1;
  while (span < ry) span <<= 1;
  for (int half = span >> 1; half > 0; half >>= 1) {
    if (ty < half && ty + half < ry) {
      const float* other = red + (ty + half) * outs;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        mine[col + k] += other[col + k];
        if constexpr (kNorm) mine[cols + col + k] += other[cols + col + k];
      }
    }
    __syncthreads();
  }
  if (ty == 0) {
    float* out = partial + static_cast<long long>(blockIdx.x) * outs;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      out[col + k] = mine[col + k];
      if constexpr (kNorm) out[cols + col + k] = mine[cols + col + k];
    }
  }
}

constexpr int kSumOuts = 32, kSumSlices = 32;

// The sum over blocks of partial[b][o], to out[o] for o < split and to
// out2[o - split] beyond: each of kSumSlices threads adds a run of blocks in
// order, then the runs are added in order.
__global__ void __launch_bounds__(kSumOuts * kSumSlices)
token_reduce_finish_kernel(const float* __restrict__ partial, int blocks, int outs, int split,
                           float* __restrict__ out, float* __restrict__ out2) {
  __shared__ float runs[kSumSlices][kSumOuts + 1];
  const int o = blockIdx.x * kSumOuts + threadIdx.x;
  const int per = (blocks + kSumSlices - 1) / kSumSlices;
  const int b0 = threadIdx.y * per;
  const int b1 = b0 + per < blocks ? b0 + per : blocks;
  float acc = 0.0f;
  if (o < outs) {
#pragma unroll 4
    for (int b = b0; b < b1; ++b) acc += __ldg(partial + static_cast<long long>(b) * outs + o);
  }
  runs[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && o < outs) {
    float total = 0.0f;
#pragma unroll
    for (int s = 0; s < kSumSlices; ++s) total += runs[s][threadIdx.x];
    if (o < split) {
      out[o] = total;
    } else {
      out2[o - split] = total;
    }
  }
}

template <typename T, bool kNorm>
int launch(const void* g, const void* x, const float* mean, const float* rstd, long long rows,
           int cols, float* partial, int max_blocks, float* out, float* out2,
           cudaStream_t stream) {
  if (rows < 0 || cols < kVec || cols % kVec || cols / kVec > kMaxThreads || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cv = cols / kVec;
  const int ry = cv >= kTarget ? 1 : kTarget / cv;
  const dim3 block(cv, ry);
  const int outs = kNorm ? 2 * cols : cols;
  const size_t smem = static_cast<size_t>(ry) * outs * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, token_reduce_kernel<T, kNorm>,
                                                        cv * ry, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long by_rows = (rows + ry - 1) / ry;
  if (blocks > by_rows) blocks = by_rows;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  const long long rows_per_block = (rows + blocks - 1) / blocks;
  token_reduce_kernel<T, kNorm><<<static_cast<unsigned>(blocks), block, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), mean, rstd, rows, cols,
      rows_per_block, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  token_reduce_finish_kernel<<<(outs + kSumOuts - 1) / kSumOuts, dim3(kSumOuts, kSumSlices), 0,
                               stream>>>(partial, static_cast<int>(blocks), outs, cols, out, out2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (cols,) = the column sums of g (rows, cols), float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); partial is scratch of max_blocks x cols floats.
extern "C" int srpde_token_bias_grad(const void* g, long long rows, int cols, int bf16,
                                     float* partial, int max_blocks, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, false>(g, nullptr, nullptr, nullptr, rows, cols, partial,
                                             max_blocks, out, nullptr, s)
              : launch<float, false>(g, nullptr, nullptr, nullptr, rows, cols, partial,
                                     max_blocks, out, nullptr, s);
}

// dweight and dbias (cols,): a LayerNorm's weight and bias gradients from the
// output gradient g and the input x (rows, cols), float32 (bf16 = 0) or
// bfloat16 (bf16 = 1), and the forward's float32 mean and rstd (rows,);
// partial is scratch of max_blocks x 2 cols floats.
extern "C" int srpde_token_layer_norm_affine_grad(const void* g, const void* x,
                                                  const float* mean, const float* rstd,
                                                  long long rows, int cols, int bf16,
                                                  float* partial, int max_blocks,
                                                  float* dweight, float* dbias, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, true>(g, x, mean, rstd, rows, cols, partial, max_blocks,
                                            dweight, dbias, s)
              : launch<float, true>(g, x, mean, rstd, rows, cols, partial, max_blocks, dweight,
                                    dbias, s);
}
