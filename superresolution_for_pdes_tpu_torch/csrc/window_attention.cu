// Hand-written Hopper (sm_90a) kernels for SwinIR's shifted-window attention
// (models/swinir.py::WindowAttention), forward and backward, in float32 on the
// CUDA cores (no tensor cores: TF32 is ruled out for the port's float32 path).
// They replace no TPU kernel: the JAX package has no SwinIR. They replace the
// composition roll -> window partition -> heads padded 30 -> 32 ->
// scaled_dot_product_attention with bias and mask -> slice -> reverse -> roll,
// whose copies, rolls and full-size mask gradient cost more device time than
// the attention itself.
//
// What a launch computes, for a map of B x Hp x Wp tokens (Hp, Wp multiples of
// the window ws), `heads` heads of size D, C = heads * D, and a shift s (0 on
// plain blocks, ws / 2 on shifted ones):
//
//   the window (wr, wc) of the map rolled by -s holds the tokens at
//   ((wr ws + i + s) mod Hp, (wc ws + j + s) mod Wp), 0 <= i, j < ws;
//   logits  L = scale q k^T + table[index] (+ -100 between tokens of different
//           regions of the rolled map's 3 x 3 slicing by (-ws, -s), when s > 0),
//   index   = (di + ws - 1)(2 ws - 1) + (dj + ws - 1) for the token offset (di, dj),
//   out     = softmax(L) v, written at the same token positions,
//
// so the roll, the partition, its reverse and the roll back are the kernels'
// address arithmetic, and the region mask is computed from a token's place in
// the rolled map (no mask tensor is read). The forward reads q, k and v from
// the qkv linear's output in token layout (B, Hp, Wp, 3C) and writes the
// attended tokens (B, Hp, Wp, C), which the proj linear reads as they are, and
// each row's log-sum-exp (in log2 units: the kernels take exp2 of logits
// scaled by log2 e). The backward recomputes P = exp(L - lse) and writes dqkv
// in the qkv linear's layout:
//
//   dP = dO V^T,  dL = P o (dP - rowsum(P o dP)),  dV = P^T dO,
//   dQ = scale dL K,  dK = scale dL^T Q
//
// (rowsum(P o dP) = rowsum(dO o O), so the output is not read again), and the
// bias table's gradient: each block folds dL into the (2 ws - 1)^2 bins of the
// relative index (fixed order) and writes one partial a window and head; a
// second launch adds the partials of all windows in a fixed order. No float
// atomics, so the same inputs give the same bits on every run.
//
// Design: one block of 2 ws^2 threads (128 at ws = 8) per (window, head), 4,800
// blocks a call at the training shape (32 maps of 40^2, 6 heads). A block
// stages its 64 tokens' q, k, v (and dO) in shared memory by 16-byte cp.async
// copies: each token's run of DP = D + 2 floats (32 for heads of 30), the
// 16-byte aligned run that holds the head at column 0 or 2 (head_shift), whose
// two other columns (the neighbouring head's) are then set to zero. Rows are
// DP + 4 floats, so that the float4 reads of eight consecutive rows fall in
// distinct banks. A warp owns 16 query rows of the 64 x 64 logits, a lane 4
// rows by 8 columns (columns cg + 8 j, so the 8 lanes of a row group cover a
// row), and the row softmax (and the backward's rowsum(P o dP)) is a max and a
// sum over those 8 lanes by shuffles, in registers; a lane then forms 4 rows by
// DP / 8 columns of each product that contracts over the tokens. Products are
// explicit fmaf (the build keeps --fmad=false). Shared memory: forward 29 KB
// (P^T takes the place of q and k once the logits are formed; 6 blocks an SM,
// as registers allow), backward 72 KB (q, k, v, dO, P, dL; 3 blocks an SM).
// Tried on an H100 and slower at this shape: 8 x 8 register tiles (fewer
// shared-memory reads a product, fewer warps), a persistent grid whose blocks
// copy the next (window, head) while computing this one (by all warps, by a
// producer warp, or by bulk copies with an mbarrier: fewer blocks an SM, and
// one warp issues the copies too slowly), and 8-byte copies of the head alone.
// One block per window with all six heads would read each token's 2,160-byte
// qkv row whole but needs 138 KB of shared memory; the per-head runs are
// 128-byte lines of one row, which the neighbouring heads' blocks read from L2.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32): at the training shape one
// block layer moves about 150 MB forward (qkv read, out written) and 260 MB
// backward (qkv, dO read, dqkv written), 45 and 77 us, and does 2.4 and 6.3
// GFLOP (the backward recomputes q k^T), 36 and 94 us.
//
// Instantiated for (ws, D) = (8, 30), SwinIR's published widths, and (4, 6),
// the tests' TINY widths, with an even number of heads (so that C % 4 == 0 and
// every run is 16-byte aligned and inside its token's row); any other shape is
// refused (cudaErrorInvalidValue) and the wrapper runs the plain twin instead.
//
// Each C entry point launches on the given stream, allocates nothing and
// returns a cudaError_t as int (cudaGetLastError() after the launch).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kRegionMask = -100.0f * kLog2e;  // upstream's -100, in log2 units

template <int WS, int D>
struct Tile {
  static constexpr int N = WS * WS;                       // tokens a window
  static constexpr int DP = D + 2;                        // floats of a staged run
  static constexpr int PITCH = DP + 4;                    // floats a staged row
  static constexpr int SP = N + 4;                        // floats a row of P, P^T or dL
  static constexpr int NB = (2 * WS - 1) * (2 * WS - 1);  // bins of the relative index
  static constexpr int NBP = (NB + 3) / 4 * 4;
  static constexpr int THREADS = 2 * N;
  static constexpr int TC = N / 8;   // logit columns a lane
  static constexpr int OC = DP / 8;  // output columns a lane
  static constexpr int CH = DP / 4;  // 16-byte copies a run
  static constexpr size_t kIndexBytes = N * (sizeof(long long) + sizeof(int));
  static constexpr size_t kForwardSmem = (3 * N * PITCH + NBP) * sizeof(float) + kIndexBytes;
  static constexpr size_t kBackwardSmem =
      (4 * N * PITCH + 2 * N * SP + NBP + N) * sizeof(float) + kIndexBytes;
  static_assert(N % 16 == 0, "a warp owns 16 rows of the logits");
  static_assert(D % 4 == 2 && DP % 8 == 0, "a head's 16-byte aligned run is D + 2 floats");
  static_assert(N * SP <= 2 * N * PITCH, "P^T fits where q and k were");
};

struct Args {
  const float* qkv;    // (B, Hp, Wp, 3C)
  const float* table;  // ((2 ws - 1)^2, heads)
  const float* dout;   // (B, Hp, Wp, C), backward
  const float* lse_r;  // (B windows heads, ws^2), backward
  float* out;          // (B, Hp, Wp, C), forward
  float* lse;          // (B windows heads, ws^2), forward
  float* dqkv;         // (B, Hp, Wp, 3C), backward
  float* partial;      // (B windows, (2 ws - 1)^2 heads), backward
  int hp, wp, heads, shift;
  float scale;
};

// The block's window and head, its tokens' rows in the map, their regions and
// the head's bias (in log2 units).
template <int WS, int D>
__device__ __forceinline__ void locate(const Args& a, long long& window, int& head,
                                       long long* tok, int* region, float* bias) {
  using T = Tile<WS, D>;
  head = static_cast<int>(blockIdx.x % a.heads);
  window = blockIdx.x / a.heads;
  const int per_row = a.wp / WS, per_map = (a.hp / WS) * per_row;
  const long long b = window / per_map;
  const int w = static_cast<int>(window % per_map);
  const int r0 = (w / per_row) * WS, c0 = (w % per_row) * WS;
  for (int t = threadIdx.x; t < T::N; t += T::THREADS) {
    const int r = r0 + t / WS, c = c0 + t % WS;  // in the rolled map
    int pr = r + a.shift, pc = c + a.shift;
    if (pr >= a.hp) pr -= a.hp;
    if (pc >= a.wp) pc -= a.wp;
    tok[t] = (b * a.hp + pr) * a.wp + pc;
    const int rr = (r >= a.hp - WS) + (r >= a.hp - a.shift);
    const int rc = (c >= a.wp - WS) + (c >= a.wp - a.shift);
    region[t] = a.shift ? rr * 3 + rc : 0;
  }
  for (int n = threadIdx.x; n < T::NB; n += T::THREADS) {
    bias[n] = a.table[n * a.heads + head] * kLog2e;
  }
}

// The staged column of a head's first float: a head of D floats at float
// column h D of its tensor's part of a row (C % 4 == 0) starts 8 bytes past a
// 16-byte boundary when h D % 4 == 2, and is staged from 2 floats before it.
template <int D>
__device__ __forceinline__ int head_shift(int head) {
  return (head * D) % 4;
}

// Each token's run of DP floats around the head at column `col` of its row of
// `src` (rows of `stride` floats) into `dst` (rows of PITCH), by 16-byte
// asynchronous copies.
template <int WS, int D>
__device__ __forceinline__ void stage(const float* __restrict__ src, long long stride, int col,
                                      const long long* tok, float* dst) {
  using T = Tile<WS, D>;
  const float* from = src + col - col % 4;
  for (int idx = threadIdx.x; idx < T::N * T::CH; idx += T::THREADS) {
    const int t = idx / T::CH, ch = idx - t * T::CH;
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + t * T::PITCH + 4 * ch));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(from + tok[t] * stride + 4 * ch) : "memory");
  }
}

// Waits for this thread's stage() copies into the `tiles` staged tiles from
// `dst`, then sets to zero the two columns of each run outside the head (the
// copying thread's, so no barrier is needed before); a __syncthreads() must
// follow.
template <int WS, int D>
__device__ __forceinline__ void staged(float* dst, int tiles, int sh) {
  using T = Tile<WS, D>;
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  const int edge = sh ? 0 : T::CH - 1, zero = sh ? 0 : D;  // the copy with the outside pair
  for (int m = 0; m < tiles; ++m) {
    for (int idx = threadIdx.x; idx < T::N * T::CH; idx += T::THREADS) {
      const int t = idx / T::CH;
      if (idx - t * T::CH == edge) {
        float* row = dst + (m * T::N + t) * T::PITCH;
        *reinterpret_cast<float2*>(row + zero) = make_float2(0.0f, 0.0f);
      }
    }
  }
}

template <int OC>
__device__ __forceinline__ void load_cols(const float* src, float (&v)[OC]) {
  if constexpr (OC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int c = 0; c < OC; ++c) v[c] = src[c];
  }
}

// Staged columns c0 .. c0 + OC - 1 of one token, those of the head (from
// column sh), to its head slice `dst`, times mul.
template <int D, int OC>
__device__ __forceinline__ void store_cols(float* dst, int c0, int sh, const float (&v)[OC],
                                           float mul) {
  if constexpr (OC % 2 == 0) {
#pragma unroll
    for (int c = 0; c < OC; c += 2) {
      const int col = c0 + c - sh;
      if (col >= 0 && col < D) {
        *reinterpret_cast<float2*>(dst + col) = make_float2(v[c] * mul, v[c + 1] * mul);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = c0 + c - sh;
      if (col >= 0 && col < D) dst[col] = v[c] * mul;
    }
  }
}

__device__ __forceinline__ float dot4(const float4& x, const float4& y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

__device__ __forceinline__ float lane(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// A sum over the 8 lanes of a row group (lanes xor 1, 2, 4): every lane gets
// the same bits.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The logits L (in log2 units) of the lane's 4 x TC tile from its q k^T sums
// `s`, in place.
template <int WS, int D>
__device__ __forceinline__ void logits(float (&s)[4][Tile<WS, D>::TC], int row0, int cg,
                                       const float* bias, const int* region, float scale) {
  using T = Tile<WS, D>;
  const float scale2 = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + i;
    const int base = (r / WS + WS - 1) * (2 * WS - 1) + r % WS + WS - 1;
#pragma unroll
    for (int j = 0; j < T::TC; ++j) {
      const int col = cg + 8 * j;
      float l = fmaf(s[i][j], scale2, bias[base - (col / WS) * (2 * WS - 1) - col % WS]);
      if (region[r] != region[col]) l += kRegionMask;
      s[i][j] = l;
    }
  }
}

template <int WS, int D>
__global__ void __launch_bounds__(Tile<WS, D>::THREADS, 6)
window_attention_forward_kernel(const Args a) {
  using T = Tile<WS, D>;
  extern __shared__ float4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  float* k = q + T::N * T::PITCH;
  float* v = k + T::N * T::PITCH;
  float* pt = q;  // P transposed, pt[j SP + i], once q and k are read
  float* bias = v + T::N * T::PITCH;
  long long* tok = reinterpret_cast<long long*>(bias + T::NBP);
  int* region = reinterpret_cast<int*>(tok + T::N);

  long long window;
  int head;
  locate<WS, D>(a, window, head, tok, region, bias);
  __syncthreads();
  const int c = a.heads * D, sh = head_shift<D>(head);
  stage<WS, D>(a.qkv, 3LL * c, head * D, tok, q);
  stage<WS, D>(a.qkv, 3LL * c, c + head * D, tok, k);
  stage<WS, D>(a.qkv, 3LL * c, 2 * c + head * D, tok, v);
  staged<WS, D>(q, 3, sh);
  __syncthreads();

  const int tid = threadIdx.x, lane_id = tid & 31, cg = lane_id & 7;
  const int row0 = (tid >> 5) * 16 + (lane_id >> 3) * 4;
  float s[4][T::TC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < T::TC; ++j) s[i][j] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < T::DP; kk += 4) {
    float4 qa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = *reinterpret_cast<const float4*>(q + (row0 + i) * T::PITCH + kk);
    }
#pragma unroll
    for (int j = 0; j < T::TC; ++j) {
      const float4 kb = *reinterpret_cast<const float4*>(k + (cg + 8 * j) * T::PITCH + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = dot4(qa[i], kb, s[i][j]);
    }
  }
  logits<WS, D>(s, row0, cg, bias, region, a.scale);

  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float m = s[i][0];
#pragma unroll
    for (int j = 1; j < T::TC; ++j) m = fmaxf(m, s[i][j]);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < T::TC; ++j) {
      s[i][j] = exp2f(s[i][j] - m);
      sum += s[i][j];
    }
    sum = row_sum(sum);
    const float inv = 1.0f / sum;
#pragma unroll
    for (int j = 0; j < T::TC; ++j) s[i][j] *= inv;
    lse[i] = m + log2f(sum);
  }
  __syncthreads();  // q and k are read: P^T takes their place
#pragma unroll
  for (int j = 0; j < T::TC; ++j) {
    *reinterpret_cast<float4*>(pt + (cg + 8 * j) * T::SP + row0) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
  }
  if (cg == 0) {
    *reinterpret_cast<float4*>(a.lse + blockIdx.x * static_cast<long long>(T::N) + row0) =
        make_float4(lse[0], lse[1], lse[2], lse[3]);
  }
  __syncthreads();

  const int c0 = cg * T::OC;
  float o[4][T::OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < T::OC; ++e) o[i][e] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < T::N; ++j) {
    const float4 p = *reinterpret_cast<const float4*>(pt + j * T::SP + row0);
    float vb[T::OC];
    load_cols<T::OC>(v + j * T::PITCH + c0, vb);
#pragma unroll
    for (int e = 0; e < T::OC; ++e) {
      o[0][e] = fmaf(p.x, vb[e], o[0][e]);
      o[1][e] = fmaf(p.y, vb[e], o[1][e]);
      o[2][e] = fmaf(p.z, vb[e], o[2][e]);
      o[3][e] = fmaf(p.w, vb[e], o[3][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    store_cols<D, T::OC>(a.out + tok[row0 + i] * c + head * D, c0, sh, o[i], 1.0f);
  }
}

template <int WS, int D>
__global__ void __launch_bounds__(Tile<WS, D>::THREADS, 3)
window_attention_backward_kernel(const Args a) {
  using T = Tile<WS, D>;
  extern __shared__ float4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  float* k = q + T::N * T::PITCH;
  float* v = k + T::N * T::PITCH;
  float* g = v + T::N * T::PITCH;  // dO
  float* p = g + T::N * T::PITCH;  // P, row-major: p[i SP + j]
  float* dl = p + T::N * T::SP;    // dL, row-major
  float* bias = dl + T::N * T::SP;
  float* lse = bias + T::NBP;
  long long* tok = reinterpret_cast<long long*>(lse + T::N);
  int* region = reinterpret_cast<int*>(tok + T::N);

  long long window;
  int head;
  locate<WS, D>(a, window, head, tok, region, bias);
  const int tid = threadIdx.x;
  for (int t = tid; t < T::N; t += T::THREADS) {
    lse[t] = a.lse_r[blockIdx.x * static_cast<long long>(T::N) + t];
  }
  __syncthreads();
  const int c = a.heads * D, sh = head_shift<D>(head);
  stage<WS, D>(a.qkv, 3LL * c, head * D, tok, q);
  stage<WS, D>(a.qkv, 3LL * c, c + head * D, tok, k);
  stage<WS, D>(a.qkv, 3LL * c, 2 * c + head * D, tok, v);
  stage<WS, D>(a.dout, c, head * D, tok, g);
  staged<WS, D>(q, 4, sh);
  __syncthreads();

  const int lane_id = tid & 31, cg = lane_id & 7;
  {  // P and dL, in the forward's tiles
    const int row0 = (tid >> 5) * 16 + (lane_id >> 3) * 4;
    float s[4][T::TC], dp[4][T::TC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < T::TC; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < T::DP; kk += 4) {
      float4 qa[4], ga[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = *reinterpret_cast<const float4*>(q + (row0 + i) * T::PITCH + kk);
        ga[i] = *reinterpret_cast<const float4*>(g + (row0 + i) * T::PITCH + kk);
      }
#pragma unroll
      for (int j = 0; j < T::TC; ++j) {
        const float4 kb = *reinterpret_cast<const float4*>(k + (cg + 8 * j) * T::PITCH + kk);
        const float4 vb = *reinterpret_cast<const float4*>(v + (cg + 8 * j) * T::PITCH + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = dot4(qa[i], kb, s[i][j]);
          dp[i][j] = dot4(ga[i], vb, dp[i][j]);
        }
      }
    }
    logits<WS, D>(s, row0, cg, bias, region, a.scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + i;
      float delta = 0.0f;
#pragma unroll
      for (int j = 0; j < T::TC; ++j) {
        s[i][j] = exp2f(s[i][j] - lse[r]);
        delta = fmaf(s[i][j], dp[i][j], delta);
      }
      delta = row_sum(delta);  // rowsum(P o dP) = rowsum(dO o O)
#pragma unroll
      for (int j = 0; j < T::TC; ++j) {
        p[r * T::SP + cg + 8 * j] = s[i][j];
        dl[r * T::SP + cg + 8 * j] = s[i][j] * (dp[i][j] - delta);
      }
    }
  }
  __syncthreads();

  const int r0 = (tid >> 3) * 4, c0 = cg * T::OC;  // 4 rows (j, then i) by OC columns
  {  // dV = P^T dO and dK = scale dL^T Q, over the query rows i
    float dv[4][T::OC], dk[4][T::OC];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < T::OC; ++e) dv[jj][e] = dk[jj][e] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < T::N; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(p + i * T::SP + r0);
      const float4 l4 = *reinterpret_cast<const float4*>(dl + i * T::SP + r0);
      float gv[T::OC], qv[T::OC];
      load_cols<T::OC>(g + i * T::PITCH + c0, gv);
      load_cols<T::OC>(q + i * T::PITCH + c0, qv);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < T::OC; ++e) {
          dv[jj][e] = fmaf(lane(p4, jj), gv[e], dv[jj][e]);
          dk[jj][e] = fmaf(lane(l4, jj), qv[e], dk[jj][e]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float* row = a.dqkv + tok[r0 + jj] * (3LL * c);
      store_cols<D, T::OC>(row + c + head * D, c0, sh, dk[jj], a.scale);
      store_cols<D, T::OC>(row + 2 * c + head * D, c0, sh, dv[jj], 1.0f);
    }
  }
  {  // dQ = scale dL K, over the key rows j
    float dq[4][T::OC];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int e = 0; e < T::OC; ++e) dq[ii][e] = 0.0f;
#pragma unroll 2
    for (int jc = 0; jc < T::N; jc += 4) {
      float4 l4[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        l4[ii] = *reinterpret_cast<const float4*>(dl + (r0 + ii) * T::SP + jc);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kv[T::OC];
        load_cols<T::OC>(k + (jc + jj) * T::PITCH + c0, kv);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int e = 0; e < T::OC; ++e) dq[ii][e] = fmaf(lane(l4[ii], jj), kv[e], dq[ii][e]);
      }
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      store_cols<D, T::OC>(a.dqkv + tok[r0 + ii] * (3LL * c) + head * D, c0, sh, dq[ii], a.scale);
    }
  }
  // the bias table's gradient: dL folded into the bins of the relative index,
  // each bin summed over its pairs (i, j) in a fixed order
  for (int b = tid; b < T::NB; b += T::THREADS) {
    const int di = b / (2 * WS - 1) - (WS - 1), dj = b % (2 * WS - 1) - (WS - 1);
    float acc = 0.0f;
    for (int ri = max(0, di); ri < WS + min(0, di); ++ri) {
      for (int ci = max(0, dj); ci < WS + min(0, dj); ++ci) {
        acc += dl[(ri * WS + ci) * T::SP + (ri - di) * WS + (ci - dj)];
      }
    }
    a.partial[window * (static_cast<long long>(T::NB) * a.heads) + b * a.heads + head] = acc;
  }
}

constexpr int kSumOuts = 32, kSumSlices = 32;

// dtable[o] = sum over windows of partial[w][o]: each of kSumSlices threads
// adds a run of windows in order, then the runs are added in order.
__global__ void __launch_bounds__(kSumOuts * kSumSlices)
bias_grad_sum_kernel(const float* __restrict__ partial, long long windows, int outs,
                     float* __restrict__ dtable) {
  __shared__ float runs[kSumSlices][kSumOuts + 1];
  const int o = blockIdx.x * kSumOuts + threadIdx.x;
  const long long per = (windows + kSumSlices - 1) / kSumSlices;
  const long long w0 = threadIdx.y * per;
  const long long w1 = w0 + per < windows ? w0 + per : windows;
  float acc = 0.0f;
  if (o < outs) {
#pragma unroll 8
    for (long long w = w0; w < w1; ++w) acc += __ldg(partial + w * outs + o);
  }
  runs[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && o < outs) {
    float total = 0.0f;
#pragma unroll
    for (int r = 0; r < kSumSlices; ++r) total += runs[r][threadIdx.x];
    dtable[o] = total;
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

template <int WS, int D>
int launch_forward(const Args& a, unsigned blocks, cudaStream_t s) {
  using T = Tile<WS, D>;
  static unsigned devices = 0;
  const cudaError_t err =
      allow_smem(window_attention_forward_kernel<WS, D>, T::kForwardSmem, devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_forward_kernel<WS, D><<<blocks, T::THREADS, T::kForwardSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int WS, int D>
int launch_backward(const Args& a, unsigned blocks, float* dtable, cudaStream_t s) {
  using T = Tile<WS, D>;
  static unsigned devices = 0;
  cudaError_t err = allow_smem(window_attention_backward_kernel<WS, D>, T::kBackwardSmem, devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_backward_kernel<WS, D><<<blocks, T::THREADS, T::kBackwardSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outs = T::NB * a.heads;
  bias_grad_sum_kernel<<<(outs + kSumOuts - 1) / kSumOuts, dim3(kSumOuts, kSumSlices), 0, s>>>(
      a.partial, static_cast<long long>(blocks / a.heads), outs, dtable);
  return static_cast<int>(cudaGetLastError());
}

// The grid (one block per window and head), or 0 for a shape no kernel takes.
unsigned plan(int batch, int hp, int wp, int heads, int window, int shift) {
  if (batch < 1 || heads < 1 || heads % 2 || window < 1 || hp < window || wp < window ||
      hp % window || wp % window || shift < 0 || shift >= window) {
    return 0;
  }
  const long long blocks = static_cast<long long>(batch) * (hp / window) * (wp / window) * heads;
  return blocks <= INT_MAX ? static_cast<unsigned>(blocks) : 0;
}

Args make_args(const float* qkv, const float* table, int hp, int wp, int heads, int shift,
               float scale) {
  Args a{};
  a.qkv = qkv;
  a.table = table;
  a.hp = hp;
  a.wp = wp;
  a.heads = heads;
  a.shift = shift;
  a.scale = scale;
  return a;
}

}  // namespace

// out (B, Hp, Wp, C) and lse (B windows heads, window^2) from qkv (B, Hp, Wp,
// 3C) and the bias table ((2 window - 1)^2, heads); C = heads * head_dim.
extern "C" int srpde_window_attention_forward(const float* qkv, const float* table, float* out,
                                              float* lse, int batch, int hp, int wp, int heads,
                                              int window, int head_dim, int shift, float scale,
                                              void* stream) {
  const unsigned blocks = plan(batch, hp, wp, heads, window, shift);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(qkv, table, hp, wp, heads, shift, scale);
  a.out = out;
  a.lse = lse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window == 8 && head_dim == 30) return launch_forward<8, 30>(a, blocks, s);
  if (window == 4 && head_dim == 6) return launch_forward<4, 6>(a, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dqkv (B, Hp, Wp, 3C) and the bias table's gradient dtable ((2 window - 1)^2,
// heads) from dout, qkv and the forward's lse; partial is scratch of
// (B windows, (2 window - 1)^2 heads) floats.
extern "C" int srpde_window_attention_backward(const float* dout, const float* qkv,
                                               const float* lse, const float* table, float* dqkv,
                                               float* partial, float* dtable, int batch, int hp,
                                               int wp, int heads, int window, int head_dim,
                                               int shift, float scale, void* stream) {
  const unsigned blocks = plan(batch, hp, wp, heads, window, shift);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(qkv, table, hp, wp, heads, shift, scale);
  a.dout = dout;
  a.lse_r = lse;
  a.dqkv = dqkv;
  a.partial = partial;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window == 8 && head_dim == 30) return launch_backward<8, 30>(a, blocks, dtable, s);
  if (window == 4 && head_dim == 6) return launch_backward<4, 6>(a, blocks, dtable, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
