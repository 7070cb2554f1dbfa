// Hand-written Hopper (sm_90a) kernels for Restormer's transposed attention
// (MDTA, models/restormer.py), the forward only, in float32 on the CUDA cores
// (no tensor cores: TF32 is ruled out for the port's float32 path). They
// replace no TPU kernel: the JAX package has no Restormer. They replace the
// plain chain F.normalize(q), F.normalize(k), q k^T (a cuBLAS product whose
// reduction runs over all tokens into a d x d result), the scale, the softmax,
// A v and the layout copies around them: 8 or more passes over the operands
// where the three launches below make 4 (q, k and v read once, out written
// once).
//
// What a call computes, for the depthwise convolution's output qkv (B, 3C, H,
// W) in NCHW as it stands, N = H W tokens, `heads` heads of d = C / heads
// channels, and head h's q, k and v the channel rows h d + i, C + h d + i and
// 2 C + h d + i (i < d), each a contiguous row of N floats:
//
//   G    = q k^T                         (d x d, summed over the N tokens)
//   L_ij = G_ij / (max(|q_i|, 1e-12) max(|k_j|, 1e-12)) temperature_h
//   A    = softmax over j of L
//   out  = A v, written to the rows h d + i of out (B, C, H, W)
//
// which is upstream's F.normalize (its clamp of the norm at 1e-12) applied to
// the Gram product rather than to q and k.
//
// Three launches, each on the given stream:
//
// * gram: a block a (slab of tokens, head, sample). It stages its slab 32
//   tokens at a time (q's and k's d rows, 16-byte cp.async copies, two stages
//   in flight) in shared memory rows of 36 floats, so that float4 reads of
//   eight consecutive rows fall in distinct banks. Its compute threads each
//   own RI x RJ entries of G (rows ig + GI m, columns jg + 12 n: a warp's
//   k reads are 12 consecutive rows) and add 4 tokens' outer products a step
//   from 16-byte reads (explicit fmaf: the build keeps --fmad=false); one
//   more warp adds the rows' squares. Each block writes its partial G and
//   norms: no float atomics.
// * softmax: a block a (8 rows of L, head, sample) adds the slabs' partials
//   in a fixed order, normalises, scales and takes each row's softmax with
//   warp shuffles; A is written transposed (A^T[j][i]) for the next launch.
// * apply: a block a (range of token chunks, head, sample) keeps A^T in
//   shared memory and streams v in chunks of 32 TOK tokens (two stages of
//   cp.async copies); a warp owns R consecutive rows of the output and a
//   lane TOK consecutive tokens, so a step reads R values of A^T (the same
//   for the whole warp) and TOK of v, and writes its tokens once.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32 without tensor cores): per
// (sample, head) the two products are 4 d^2 N operations and the data 16 d N
// bytes (q, k, v read, out written), d / 4 operations a byte: 12 at d = 48,
// 24 at d = 96, about the card's balance of 20. So both the HBM stream and
// the FMA rate matter; the register tiles keep shared-memory reads at 1 in 7
// to 1 in 14 FMAs.
//
// Same inputs give the same bits on every run (fixed-order sums, the slab
// count a function of the shape and the card's SM count), in a captured CUDA
// graph too: nothing here synchronises or allocates. Each C entry point
// returns a cudaError_t as int. Head sizes 48 and 96 are built; any other
// size is refused (cudaErrorInvalidValue) and the wrapper raises before it
// launches.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kChunk = 32;           // tokens a gram stage holds
constexpr int kRowPitch = kChunk + 4;  // floats a staged row
constexpr int kGJ = 12;              // column groups of a gram block's compute threads
constexpr float kNormFloor = 1e-12f;  // F.normalize's eps

// gram: RI x RJ entries of G a compute thread; GI = D / RI row groups.
template <int D>
struct Gram;
template <>
struct Gram<48> {
  static constexpr int RI = 6, RJ = 4;
};
template <>
struct Gram<96> {
  static constexpr int RI = 6, RJ = 8;
};

template <int D>
struct GramShape {
  static constexpr int RI = Gram<D>::RI, RJ = Gram<D>::RJ;
  static constexpr int GI = D / RI;
  static constexpr int COMPUTE = GI * kGJ;  // a multiple of 32
  static constexpr int THREADS = COMPUTE + 32;
  static constexpr int STAGE = 2 * D * kRowPitch;  // floats: q's and k's rows
  static constexpr size_t SMEM = 2 * STAGE * sizeof(float);
  static constexpr int NORMS = (2 * D + 31) / 32;  // rows a lane of the norm warp
  static_assert(D % RI == 0 && D % kGJ == 0 && D / kGJ == RJ && COMPUTE % 32 == 0, "tiling");
};

// apply: a warp R rows, a lane TOK tokens; D / R warps.
template <int D>
struct Apply;
template <>
struct Apply<48> {
  static constexpr int R = 12, TOK = 4;
};
template <>
struct Apply<96> {
  static constexpr int R = 12, TOK = 2;
};

template <int D>
struct ApplyShape {
  static constexpr int R = Apply<D>::R, TOK = Apply<D>::TOK;
  static constexpr int WARPS = D / R;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int CHUNK = 32 * TOK;  // tokens a stage holds
  static constexpr size_t SMEM = (D * D + 2 * D * CHUNK) * sizeof(float);
  static_assert(D % R == 0 && R % 4 == 0, "tiling");
};

constexpr int kSoftmaxRows = 8;  // rows of L a softmax block: a warp each

__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies tokens [t0, t0 + width) of `rows` rows (row r at rows_at(r)) into
// shared rows of `pitch` floats; tokens at or past `end` are zeros. With
// `aligned` (N a multiple of 4, so every row and every 4th token is 16-byte
// aligned) in 16-byte copies, else in 4-byte ones.
template <typename RowsAt>
__device__ __forceinline__ void stage(float* dst, int rows, int pitch, int width, long long t0,
                                      long long end, bool aligned, RowsAt rows_at, int tid,
                                      int nthreads) {
  if (aligned) {
    const int quads = width / 4;
    for (int idx = tid; idx < rows * quads; idx += nthreads) {
      const int r = idx / quads, c = 4 * (idx - r * quads);
      const float* row = rows_at(r);
      const bool valid = t0 + c < end;
      copy16(dst + r * pitch + c, valid ? row + t0 + c : row, valid);
    }
  } else {
    for (int idx = tid; idx < rows * width; idx += nthreads) {
      const int r = idx / width, c = idx - r * width;
      const float* row = rows_at(r);
      const bool valid = t0 + c < end;
      copy4(dst + r * pitch + c, valid ? row + t0 + c : row, valid);
    }
  }
}

// ------------------------------------------------------------------- gram
// partial[(b heads + h) slabs + s]: G (D x D, row-major), |q_i|^2 (D), |k_j|^2 (D).
template <int D>
__global__ void __launch_bounds__(GramShape<D>::THREADS)
transposed_attention_gram_kernel(const float* __restrict__ qkv, int heads, long long tokens,
                                 int chunks_per_slab, bool aligned, float* __restrict__ partial) {
  using S = GramShape<D>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, slab = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int slabs = gridDim.x;
  const long long c = static_cast<long long>(heads) * D;
  const float* q = qkv + (static_cast<long long>(b) * 3 * c + static_cast<long long>(h) * D) *
                             tokens;
  const float* k = q + c * tokens;
  const long long first = static_cast<long long>(slab) * chunks_per_slab * kChunk;
  const long long last_token = first + static_cast<long long>(chunks_per_slab) * kChunk;
  const long long end = last_token < tokens ? last_token : tokens;
  const int chunks = static_cast<int>((end - first + kChunk - 1) / kChunk);
  auto rows_at = [&](int r) { return r < D ? q + r * tokens : k + (r - D) * tokens; };

  const bool compute = tid < S::COMPUTE;
  const int ig = tid / kGJ, jg = tid - ig * kGJ;  // compute threads
  const int lane = tid - S::COMPUTE;             // the norm warp
  float acc[S::RI][S::RJ];
#pragma unroll
  for (int m = 0; m < S::RI; ++m) {
#pragma unroll
    for (int n = 0; n < S::RJ; ++n) acc[m][n] = 0.0f;
  }
  float sq[S::NORMS];
#pragma unroll
  for (int r = 0; r < S::NORMS; ++r) sq[r] = 0.0f;

  if (chunks > 0) {
    stage(smem, 2 * D, kRowPitch, kChunk, first, end, aligned, rows_at, tid, S::THREADS);
  }
  commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage(smem + ((ch + 1) & 1) * S::STAGE, 2 * D, kRowPitch, kChunk, first + (ch + 1) * kChunk,
            end, aligned, rows_at, tid, S::THREADS);
    }
    commit();
    wait_groups<1>();
    __syncthreads();
    const float* qs = smem + (ch & 1) * S::STAGE;
    const float* ks = qs + D * kRowPitch;
    if (compute) {
#pragma unroll 2
      for (int t = 0; t < kChunk; t += 4) {
        float4 a[S::RI], w[S::RJ];
#pragma unroll
        for (int m = 0; m < S::RI; ++m) {
          a[m] = *reinterpret_cast<const float4*>(qs + (ig + S::GI * m) * kRowPitch + t);
        }
#pragma unroll
        for (int n = 0; n < S::RJ; ++n) {
          w[n] = *reinterpret_cast<const float4*>(ks + (jg + kGJ * n) * kRowPitch + t);
        }
#pragma unroll
        for (int m = 0; m < S::RI; ++m) {
#pragma unroll
          for (int n = 0; n < S::RJ; ++n) {
            acc[m][n] = __fmaf_rn(a[m].x, w[n].x, acc[m][n]);
            acc[m][n] = __fmaf_rn(a[m].y, w[n].y, acc[m][n]);
            acc[m][n] = __fmaf_rn(a[m].z, w[n].z, acc[m][n]);
            acc[m][n] = __fmaf_rn(a[m].w, w[n].w, acc[m][n]);
          }
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < S::NORMS; ++r) {
        const int row = lane + 32 * r;
        if (row < 2 * D) {
          const float* x = qs + row * kRowPitch;  // k's rows follow q's
#pragma unroll 4
          for (int t = 0; t < kChunk; t += 4) {
            const float4 v = *reinterpret_cast<const float4*>(x + t);
            sq[r] = __fmaf_rn(v.x, v.x, sq[r]);
            sq[r] = __fmaf_rn(v.y, v.y, sq[r]);
            sq[r] = __fmaf_rn(v.z, v.z, sq[r]);
            sq[r] = __fmaf_rn(v.w, v.w, sq[r]);
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + ((static_cast<long long>(b) * heads + h) * slabs + slab) *
                             (D * D + 2 * D);
  if (compute) {
#pragma unroll
    for (int m = 0; m < S::RI; ++m) {
#pragma unroll
      for (int n = 0; n < S::RJ; ++n) out[(ig + S::GI * m) * D + jg + kGJ * n] = acc[m][n];
    }
  } else {
#pragma unroll
    for (int r = 0; r < S::NORMS; ++r) {
      const int row = lane + 32 * r;
      if (row < 2 * D) out[D * D + row] = sq[r];
    }
  }
}

// ---------------------------------------------------------------- softmax
// attn[(b heads + h)]: A^T (D x D), A^T[j][i] = softmax_j(L)_ij.
template <int D>
__global__ void __launch_bounds__(32 * kSoftmaxRows)
transposed_attention_softmax_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ temperature, int heads, int slabs,
                                    float* __restrict__ attn) {
  constexpr int E = D * D + 2 * D, PER = (D + 31) / 32;
  __shared__ float rk[D];  // 1 / max(|k_j|, eps)
  const int bh = blockIdx.y, h = bh % heads;
  const float* p = partial + static_cast<long long>(bh) * slabs * E;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    float s = 0.0f;
    for (int sl = 0; sl < slabs; ++sl) s += p[static_cast<long long>(sl) * E + D * D + D + j];
    rk[j] = 1.0f / fmaxf(sqrtf(s), kNormFloor);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, i = blockIdx.x * kSoftmaxRows + (threadIdx.x >> 5);
  if (i >= D) return;
  float g[PER];
  float nq = 0.0f;
#pragma unroll
  for (int u = 0; u < PER; ++u) g[u] = 0.0f;
  for (int sl = 0; sl < slabs; ++sl) {
    const float* row = p + static_cast<long long>(sl) * E;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int j = lane + 32 * u;
      if (j < D) g[u] += row[i * D + j];
    }
    if (lane == 0) nq += row[D * D + i];
  }
  const float scale = __shfl_sync(0xffffffffu, 1.0f / fmaxf(sqrtf(nq), kNormFloor), 0) *
                      temperature[h];
  float top = -INFINITY;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = lane + 32 * u;
    if (j < D) {
      g[u] = g[u] * scale * rk[j];
      top = fmaxf(top, g[u]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
  float sum = 0.0f;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = lane + 32 * u;
    if (j < D) {
      g[u] = expf(g[u] - top);
      sum += g[u];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  float* a = attn + static_cast<long long>(bh) * D * D;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = lane + 32 * u;
    if (j < D) a[j * D + i] = g[u] / sum;
  }
}

// ------------------------------------------------------------------ apply
template <int D>
__global__ void __launch_bounds__(ApplyShape<D>::THREADS)
transposed_attention_apply_kernel(const float* __restrict__ qkv, const float* __restrict__ attn,
                                  int heads, long long tokens, bool aligned,
                                  float* __restrict__ out) {
  using S = ApplyShape<D>;
  constexpr int R = S::R, TOK = S::TOK, CH = S::CHUNK;
  extern __shared__ __align__(16) float smem[];
  float* at = smem;           // A^T (D x D)
  float* vs = smem + D * D;   // two stages of v (D x CH)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long c = static_cast<long long>(heads) * D;
  const float* v = qkv + (static_cast<long long>(b) * 3 * c + 2 * c +
                          static_cast<long long>(h) * D) * tokens;
  float* o = out + (static_cast<long long>(b) * c + static_cast<long long>(h) * D) * tokens;
  const float* a = attn + (static_cast<long long>(b) * heads + h) * D * D;
  const long long chunks = (tokens + CH - 1) / CH;
  auto rows_at = [&](int r) { return v + r * tokens; };

  for (int idx = tid; idx < D * D / 4; idx += S::THREADS) copy16(at + 4 * idx, a + 4 * idx, true);
  long long ch = blockIdx.x;
  if (ch < chunks) stage(vs, D, CH, CH, ch * CH, tokens, aligned, rows_at, tid, S::THREADS);
  commit();
  const int i0 = warp * R, t_lane = lane * TOK;
  for (int it = 0; ch < chunks; ch += gridDim.x, ++it) {
    const long long next = ch + gridDim.x;
    if (next < chunks) {
      stage(vs + ((it + 1) & 1) * D * CH, D, CH, CH, next * CH, tokens, aligned, rows_at, tid,
            S::THREADS);
    }
    commit();
    wait_groups<1>();
    __syncthreads();
    const float* x = vs + (it & 1) * D * CH + t_lane;
    float acc[R][TOK];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = 0; u < TOK; ++u) acc[r][u] = 0.0f;
    }
#pragma unroll 4
    for (int j = 0; j < D; ++j) {
      float w[R], y[TOK];
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const float4 f = *reinterpret_cast<const float4*>(at + j * D + i0 + r);
        w[r] = f.x;
        w[r + 1] = f.y;
        w[r + 2] = f.z;
        w[r + 3] = f.w;
      }
      if constexpr (TOK == 4) {
        const float4 f = *reinterpret_cast<const float4*>(x + j * CH);
        y[0] = f.x;
        y[1] = f.y;
        y[2] = f.z;
        y[3] = f.w;
      } else {
        const float2 f = *reinterpret_cast<const float2*>(x + j * CH);
        y[0] = f.x;
        y[1] = f.y;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int u = 0; u < TOK; ++u) acc[r][u] = __fmaf_rn(w[r], y[u], acc[r][u]);
      }
    }
    const long long t = ch * CH + t_lane;
    if (aligned && t + TOK <= tokens) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float* dst = o + (i0 + r) * tokens + t;
        if constexpr (TOK == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[r][0], acc[r][1]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int u = 0; u < TOK; ++u) {
          if (t + u < tokens) o[(i0 + r) * tokens + t + u] = acc[r][u];
        }
      }
    }
    __syncthreads();
  }
}

// Shared memory above 48 KB is opted into once per kernel and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, unsigned& devices) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (devices >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 32) devices |= 1u << dev;
  return err;
}

bool valid(int batch, int heads, long long tokens) {
  return batch >= 1 && batch <= 65535 && heads >= 1 && heads <= 65535 && tokens >= 1;
}

template <int D>
int launch_gram(const float* qkv, int batch, int heads, long long tokens, int slabs,
                int chunks_per_slab, float* partial, cudaStream_t s) {
  using S = GramShape<D>;
  static unsigned devices = 0;
  if (slabs < 1 || chunks_per_slab < 1 ||
      static_cast<long long>(slabs) * chunks_per_slab * kChunk < tokens) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_smem(transposed_attention_gram_kernel<D>, S::SMEM, devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  transposed_attention_gram_kernel<D><<<dim3(slabs, heads, batch), S::THREADS, S::SMEM, s>>>(
      qkv, heads, tokens, chunks_per_slab, tokens % 4 == 0, partial);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_softmax(const float* partial, const float* temperature, int batch, int heads,
                   int slabs, float* attn, cudaStream_t s) {
  if (slabs < 1) return static_cast<int>(cudaErrorInvalidValue);
  transposed_attention_softmax_kernel<D>
      <<<dim3((D + kSoftmaxRows - 1) / kSoftmaxRows, batch * heads), 32 * kSoftmaxRows, 0, s>>>(
          partial, temperature, heads, slabs, attn);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_apply(const float* qkv, const float* attn, int batch, int heads, long long tokens,
                 float* out, cudaStream_t s) {
  using S = ApplyShape<D>;
  static unsigned devices = 0;
  cudaError_t err = allow_smem(transposed_attention_apply_kernel<D>, S::SMEM, devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, transposed_attention_apply_kernel<D>, S::THREADS, S::SMEM);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // two waves of resident blocks over all (sample, head) pairs
  const long long chunks = (tokens + S::CHUNK - 1) / S::CHUNK;
  const long long pairs = static_cast<long long>(batch) * heads;
  long long per_pair = (2LL * sms * (per_sm > 0 ? per_sm : 1) + pairs - 1) / pairs;
  if (per_pair > chunks) per_pair = chunks;
  if (per_pair > 65535) per_pair = 65535;
  transposed_attention_apply_kernel<D>
      <<<dim3(static_cast<unsigned>(per_pair), heads, batch), S::THREADS, S::SMEM, s>>>(
          qkv, attn, heads, tokens, tokens % 4 == 0, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partial (batch heads slabs, d^2 + 2 d): each slab's q k^T and squared norms
// from qkv (batch, 3 heads d, tokens); slab s holds tokens [32 s
// chunks_per_slab, 32 (s + 1) chunks_per_slab).
extern "C" int srpde_transposed_attention_gram(const float* qkv, int batch, int heads, int d,
                                               long long tokens, int slabs, int chunks_per_slab,
                                               float* partial, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(batch, heads, tokens)) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 48: return launch_gram<48>(qkv, batch, heads, tokens, slabs, chunks_per_slab, partial, s);
    case 96: return launch_gram<96>(qkv, batch, heads, tokens, slabs, chunks_per_slab, partial, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// attn (batch heads, d, d): A^T of each head from the slabs' partials and
// the heads' temperatures (heads,).
extern "C" int srpde_transposed_attention_softmax(const float* partial, const float* temperature,
                                                  int batch, int heads, int d, int slabs,
                                                  float* attn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || heads < 1 || static_cast<long long>(batch) * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 48: return launch_softmax<48>(partial, temperature, batch, heads, slabs, attn, s);
    case 96: return launch_softmax<96>(partial, temperature, batch, heads, slabs, attn, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (batch, heads d, tokens) = A v, v the rows 2 heads d + h d + j of qkv.
extern "C" int srpde_transposed_attention_apply(const float* qkv, const float* attn, int batch,
                                                int heads, int d, long long tokens, float* out,
                                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(batch, heads, tokens)) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 48: return launch_apply<48>(qkv, attn, batch, heads, tokens, out, s);
    case 96: return launch_apply<96>(qkv, attn, batch, heads, tokens, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
