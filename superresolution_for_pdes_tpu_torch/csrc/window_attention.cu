// Hand-written Hopper (sm_90a) kernels for SwinIR's shifted-window attention
// (models/swinir.py::WindowAttention), forward and backward, in float32 on the
// CUDA cores (no tensor cores: TF32 is ruled out for the port's float32 path);
// and, further down, their tiled form for windows too large for one block's
// registers and for queries and keys from different windows (HAT's window-16
// attention and its overlapping cross-window attention, models/hat.py).
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
// refused (cudaErrorInvalidValue). The wrapper (ops/window_attention.py) checks
// the shape before a launch and raises: nothing on a card falls back to the
// plain twin.
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

// ---------------------------------------------------------------------------
// Tiled window attention: windows too large for one block's registers, and
// queries and keys from different windows (HAT, models/hat.py).
//
// A query window of WQ x WQ tokens attends to a key window of WK x WK tokens
// centred on it (PAD = (WK - WQ) / 2 tokens wider on each side):
//
//   WK == WQ: HAB's window attention, SwinIR's arithmetic above (the map
//     rolled by -shift, the relative index (di + WQ - 1)(2 WQ - 1) + (dj + WQ
//     - 1) with di, dj the query's place minus the key's, the region mask on
//     shifted blocks);
//   WK > WQ: OCAB's overlapping cross-window attention (no shift or mask):
//     the key window of query window (wr, wc) holds the tokens at (wr WQ -
//     PAD + i, wc WQ - PAD + j); one outside the map is a zero key and a zero
//     value (upstream's nn.Unfold with zero padding after the linear), whose
//     logit is its bias alone. The table has (WQ + WK - 1)^2 rows, indexed
//     ((dr + OFF)(WQ + WK - 1) + (dc + OFF)) mod its rows, with (dr, dc) the
//     key's place in its window minus the query's in its own and OFF = WQ -
//     WK + 1 (upstream's calculate_rpi_oca, whose negative indices wrap).
//
// Key places: a key-window row holds WKP = WK rounded up to 4 places, and a
// key tile is KT consecutive places (a place past the row or the window is
// no key), so that runs of 4 places lie in one row.
//
// Forward: one block per (window, head, tile of QT queries: QT / WQ rows of
// the query window). It walks the key tiles with an online softmax: running
// max and sum a row, the output rescaled when the max grows, so no logits
// are held past their tile. It writes the output in token layout and each
// row's log-sum-exp (log2 units).
//
// Backward, three launches (four with an overlap) and no float atomics:
//   dq:  one block per query tile, walking the key tiles: delta = rowsum(dO
//        o O) from the forward's output, P = exp2(L - lse), dL = P o (dP -
//        delta), dQ = scale dL K, written in the qkv linear's layout; delta
//        is written for the next launch;
//   dkv: one block per (window, head, key tile), walking the query tiles with
//        the logits transposed: dV = P^T dO, dK = scale dL^T Q, and dL folded
//        into the block's bins of the relative offset (each bin a thread's,
//        added in a fixed order) and written as one partial of the table a
//        block; dK and dV go to the qkv linear's layout (WK == WQ: every key
//        in exactly one window) or, with an overlap, to one row a window and
//        key of a scratch (kv_partial);
//   the bias table's partials summed in a fixed order (bias_grad_sum_kernel);
//   with an overlap, kv_fold_kernel: each token's dK and dV summed over the
//        (at most 2 x 2) key windows that hold it, in a fixed order.
//
// What bounds them on an H100: float32 FMAs on the CUDA cores (67 TFLOP/s)
// and the shared-memory reads that feed them. At hat_train_b32's shape (32
// maps of 48^2, 6 heads of 30) a HAB call (forward and backward) makes 0.98 G
// warp-FMAs, 1.06 ms at the FMA rate of 132 SMs at 1.755 GHz, against 0.19 ms
// for its 640 MB; OCAB 2.2 times that. An SM issues four warp-FMAs a clock
// and reads one 128-byte wavefront of shared memory a clock; a warp's
// 16-byte shared load costs four wavefronts, so a product keeps up with the
// FMAs only if a lane does 16 FMAs for each 16-byte load.
//
// So every dense product is a register-tiled outer product (outer8): a lane
// owns an 8 x 8 tile of it and, at each step k of the contraction, reads its
// 8 values of each operand as two 16-byte loads (the places 4 g .. 4 g + 3
// and n / 2 + 4 g .. of an extent n, at8) and does 64 FMAs: 16 wavefronts
// for 64 warp-FMAs, the FMA rate's own pace (the pair and the kernels before
// them read 12 loads for 128 FMAs, 16 for 128, or 8 for 64: two thirds or
// half of it). The next step's values are read before this step's FMAs.
// That needs each operand's row k contiguous along the lane's 8 values:
//   - q k^T and dO v^T contract over the head (k = 0 .. D - 1), so q, k, v
//     and dO are also held k-major (head column outermost: rows of QT or KT
//     floats), transposed once a tile from their token-major staging
//     (to_kmajor: a lane moves a 16-byte run, consecutive lanes consecutive
//     tokens, into distinct banks both ways);
//   - P V, dL K, P^T dO and dL^T Q contract over tokens, so their right
//     operands are the token-major tiles (16-byte cp.async runs, rows of
//     PITCH), and P and dL are written into shared memory as the next
//     product reads them: pt[key][query] forward, dl[key][query] in dq, pb
//     and lb [query][key] in dkv, each lane storing its tile transposed by
//     16-byte stores along the dimension its quarter-warp's lanes span.
// The logits add the bias per 4 x 4 quarter of a lane's tile (logits8: a
// run of 4 queries of one row against a run of 4 key places of one row
// reads 7 consecutive entries of the table, and its region mask and key
// window once), then one FMA a logit.
// A lane holds one 8 x 8 tile that lives across the walk (O, dQ, dK or dV)
// and at most one more (S or dP), so the threads a block and the tiles'
// mapping come from QT, KT and DP alone: S and dP of a tile pair side by
// side (BTHREADS = 2 (QT / 8)(KT / 8)), the walked product split over its
// contraction among the threads that remain (FSPLIT, QSPLIT, KSPLIT), its
// parts added once, in order, after the walk. The next tile's token-major
// copies are in flight while this tile computes (dq's k and dkv's q and dO
// in two buffers; the forward's k and v one tile apart), and are
// transposed once this tile's S and dP are formed: in dq and dkv by the S
// lanes while the dP lanes form dL, in the forward beside the row maxima.
//
// On an H100 at HAT's published widths (nvcc -Xptxas -v, sm_90a): the
// forward 221 (HAB) and 219 (OCAB) registers, dq 243 and 246, dkv 238 and
// 248, no spills; shared memory 61,712, 81,936 and 110,624 bytes (HAB),
// 63,952, 84,176 and 115,104 (OCAB): three blocks of two warps an SM
// forward, two of four backward.
//
// Instantiated for (WQ, WK, D, KT) = (16, 16, 30, 64), HAB at HAT's published
// widths; (16, 24, 30, 64), OCAB at those widths; (4, 6, 6, 48), OCAB at the
// tests' TINY widths; and (8, 8, 30, 64), SwinIR's window, which the wrapper
// sends to the pair above: it is built so that chip_smoke.py can time the
// tiled form against the pair at the pair's own shape. An even number of
// heads (16-byte aligned runs, as the pair), and a shift a multiple of 4 (a
// run of 4 places never straddles two regions).
// float32 on the CUDA cores; each launch allocates nothing.

namespace {

constexpr float kNeg = -1e30f;  // the logit of a place past the key window

template <int WQ_, int WK_, int D_, int KT_>
struct Tiled {
  static constexpr int WQ = WQ_, WK = WK_, D = D_, KT = KT_;
  static constexpr bool OVERLAP = WK > WQ;
  static constexpr int PAD = (WK - WQ) / 2;
  static constexpr int NQ = WQ * WQ, NK = WK * WK;
  static constexpr int QT = NQ < 64 ? NQ : 64;  // queries a tile
  static constexpr int QR = QT / WQ;            // query-window rows a tile
  static constexpr int NQT = NQ / QT;
  static constexpr int WKP = (WK + 3) / 4 * 4;    // key places a key-window row (WK, rounded up)
  static constexpr int NKP = WK * WKP;            // key places
  static constexpr int NKT = (NKP + KT - 1) / KT;  // tiles of KT key places (the last may pass NKP)
  static constexpr int L = WQ + WK - 1;         // side of the bias table
  static constexpr int NB = L * L;
  static constexpr int NBP = (NB + 3) / 4 * 4;
  static constexpr int OFF = WQ - WK + 1;
  static constexpr int DP = D + 2, PITCH = DP + 4, CH = DP / 4;  // token-major runs and rows
  static constexpr int QK = D * QT, KK = D * KT;                 // a k-major tile (rows of QT, KT)
  static constexpr int QTM = QT * PITCH, KTM = KT * PITCH;       // a token-major tile
  static constexpr int NQG = QT / 8, NKG = KT / 8, NDG = DP / 8;  // 8-wide groups
  static constexpr int S_TILES = NQG * NKG;   // of S (or dP) for a query tile and a key tile
  static constexpr int O_TILES = NQG * NDG;   // of O, or dQ
  static constexpr int KV_TILES = 2 * NKG * NDG;  // of dK and dV
  static constexpr int FTHREADS = (S_TILES + O_TILES - 1) / O_TILES * O_TILES;
  static constexpr int FSPLIT = FTHREADS / O_TILES;  // O's key tile split among threads
  static constexpr int BTHREADS = 2 * S_TILES;       // S and dP side by side
  static constexpr int QSPLIT = BTHREADS / O_TILES;  // dQ's key tile split
  static constexpr int KSPLIT = BTHREADS / KV_TILES;  // dK's and dV's query tile split
  // shared memory, in floats from the start: the forward's (q token-major
  // first staged where P^T goes)
  static constexpr int F_Q = 0, F_K = F_Q + QK, F_KT = F_K + KK, F_V = F_KT + KTM,
                       F_PT = F_V + KTM, F_TMAX = F_PT + KT * QT, F_TSUM = F_TMAX + NKG * QT,
                       F_M = F_TSUM + NKG * QT, F_L = F_M + QT, F_A = F_L + QT,
                       F_BIAS = F_A + QT, F_END = F_BIAS + NBP;
  // dq's: k token-major in two buffers; q, dO and the output first staged
  // token-major where dL, k and v (k-major) and the key tiles go
  static constexpr int B_Q = 0, B_G = B_Q + QK, B_K = B_G + QK, B_V = B_K + KK, B_KT = B_V + KK,
                       B_VT = B_KT + 2 * KTM, B_DL = B_VT + KTM, B_LSE = B_DL + KT * QT,
                       B_DELTA = B_LSE + QT, B_BIAS = B_DELTA + QT, B_END = B_BIAS + NBP;
  // dkv's: the query tiles token-major in two buffers; k and v first staged
  // token-major where P and dL go
  static constexpr int V_K = 0, V_V = V_K + KK, V_Q = V_V + KK, V_G = V_Q + QK, V_TM = V_G + QK,
                       V_P = V_TM + 4 * QTM, V_DL = V_P + QT * KT, V_BIAS = V_DL + QT * KT,
                       V_BINS = V_BIAS + NBP, V_END = V_BINS + NBP;
  // tokens, regions and the keys' bias parts: the walked tiles' in two buffers
  static constexpr size_t kTokBytes =
      (QT + 2 * KT) * sizeof(long long) + (QT + 4 * KT) * sizeof(int);
  static constexpr size_t kForwardSmem = F_END * sizeof(float) + kTokBytes;
  static constexpr size_t kDqSmem = B_END * sizeof(float) + kTokBytes;
  static constexpr size_t kDkvSmem =
      V_END * sizeof(float) + (KT + 2 * QT) * sizeof(long long) + (2 * KT + 2 * QT) * sizeof(int);
  static_assert(QT % 8 == 0 && KT % 8 == 0 && QT % WQ == 0 && NQ % QT == 0 && WQ % 4 == 0,
                "tiles, and runs of 4 queries or key places in one window row");
  static_assert(D % 4 == 2 && DP % 8 == 0, "a head's 16-byte aligned run is D + 2 floats");
  static_assert((WK - WQ) % 2 == 0 && PAD <= WQ / 2, "a key window centred on its query window");
  static_assert(KT % FSPLIT == 0 && BTHREADS % O_TILES == 0 && KT % QSPLIT == 0 &&
                BTHREADS % KV_TILES == 0 && QT % KSPLIT == 0, "splits");
  static_assert(QTM <= KT * QT && QTM <= 2 * KK && QTM <= KTM && 2 * KTM <= 2 * QT * KT,
                "token-major tiles staged in the places named above");
  static_assert((FSPLIT - 1) * 64 * O_TILES <= F_TMAX && (QSPLIT - 1) * 64 * O_TILES <= B_LSE &&
                (KSPLIT - 1) * 64 * KV_TILES <= V_BIAS, "split parts fit the staged tiles");
};

struct TArgs {
  const float* qkv;      // (B, Hp, Wp, 3C)
  const float* table;    // ((WQ + WK - 1)^2, heads)
  const float* dout;     // (B, Hp, Wp, C), backward
  const float* out_r;    // (B, Hp, Wp, C), the forward's output, backward
  const float* lse_r;    // (B windows heads, WQ^2), backward
  const float* delta_r;  // (B windows heads, WQ^2), dkv
  float* out;            // forward
  float* lse;            // forward
  float* dqkv;           // (B, Hp, Wp, 3C), backward
  float* delta;          // dq
  float* kvpart;         // (B windows, WK^2, 2C), dkv with an overlap
  float* partial;        // (B windows key tiles, (WQ + WK - 1)^2 heads), dkv
  int hp, wp, heads, shift;
  float scale;
};

// A query window's batch and the rolled map's row and column of its first token.
struct Where {
  long long b;
  int r0, c0;
};

template <int WQ>
__device__ __forceinline__ Where where(const TArgs& a, long long window) {
  const int per_row = a.wp / WQ, per_map = (a.hp / WQ) * per_row;
  const int w = static_cast<int>(window % per_map);
  return {window / per_map, (w / per_row) * WQ, (w % per_row) * WQ};
}

// The region of a rolled-map place along a side of n (upstream's slicing by
// (-WQ, -shift)).
template <int WQ>
__device__ __forceinline__ int side_region(int r, int n, int shift) {
  return (r >= n - WQ) + (r >= n - shift);
}

// The map place of rolled place (r, c) (shifted by +shift, wrapped), and its region.
template <int WQ>
__device__ __forceinline__ void rolled(const TArgs& a, long long b, int r, int c, long long& tok,
                                       int& region) {
  int pr = r + a.shift, pc = c + a.shift;
  if (pr >= a.hp) pr -= a.hp;
  if (pc >= a.wp) pc -= a.wp;
  tok = (b * a.hp + pr) * a.wp + pc;
  region = a.shift ? side_region<WQ>(r, a.hp, a.shift) * 3 + side_region<WQ>(c, a.wp, a.shift) : 0;
}

// Query t of tile qt: its map place and region.
template <class T>
__device__ __forceinline__ void query_token(const TArgs& a, const Where& w, int qt, int t,
                                            long long* tok, int* region) {
  const int i = qt * T::QT + t;
  rolled<T::WQ>(a, w.b, w.r0 + i / T::WQ, w.c0 + i % T::WQ, tok[t], region[t]);
}

// The base of the bias index of query i of the window.
template <class T>
__device__ __forceinline__ int query_base(int i) {
  const int qr = i / T::WQ, qc = i % T::WQ;
  return T::OVERLAP ? T::OFF * (T::L + 1) - (qr * T::L + qc)
                    : (qr + T::WQ - 1) * T::L + qc + T::WQ - 1;
}

// Key place t of tile kt (row kr, column kc of the key window, WKP places
// a row): its map place (-1: a zero key outside the map), region (-1: past
// the key window, no key) and part of the bias index.
template <class T>
__device__ __forceinline__ void key_token(const TArgs& a, const Where& w, int kt, int t,
                                          long long* tok, int* region, int* part) {
  const int j = kt * T::KT + t, kr = j / T::WKP, kc = j % T::WKP;
  part[t] = T::OVERLAP ? kr * T::L + kc : -(kr * T::L + kc);
  if (kr >= T::WK || kc >= T::WK) {
    tok[t] = -1;
    region[t] = -1;
  } else if (T::OVERLAP) {
    const int r = w.r0 - T::PAD + kr, c = w.c0 - T::PAD + kc;
    tok[t] = (r < 0 || r >= a.hp || c < 0 || c >= a.wp) ? -1 : (w.b * a.hp + r) * a.wp + c;
    region[t] = 0;
  } else {
    rolled<T::WQ>(a, w.b, w.r0 + kr, w.c0 + kc, tok[t], region[t]);
  }
}

// The bin of the table for the key-minus-query offset (dr, dc).
template <class T>
__device__ __forceinline__ int offset_bin(int dr, int dc) {
  if (T::OVERLAP) {
    const int b = (dr + T::OFF) * T::L + dc + T::OFF;
    return b < 0 ? b + T::NB : b;
  }
  return (T::WQ - 1 - dr) * T::L + T::WQ - 1 - dc;
}

// n tokens' runs of DP floats around the head at column `col` of their rows
// of `src` (rows of `stride` floats) into `dst` (rows of PITCH), by 16-byte
// asynchronous copies; a token at -1 is filled with zeros. The two columns
// of a run outside the head are whatever the row holds there.
template <class T>
__device__ __forceinline__ void stage_tokens(const float* __restrict__ src, long long stride,
                                             int col, const long long* tok, int n, float* dst,
                                             int nthreads) {
  const float* from = src + col - col % 4;
  for (int idx = threadIdx.x; idx < n * T::CH; idx += nthreads) {
    const int t = idx / T::CH, ch = idx - t * T::CH;
    const long long tk = tok[t];
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + t * T::PITCH + 4 * ch));
    const float* g = tk >= 0 ? from + tk * stride + 4 * ch : src;
    const int bytes = tk >= 0 ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(g),
                 "r"(bytes) : "memory");
  }
}

// Waits for every copy this thread has issued.
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The i-th of a lane's 8 places along an extent of N for its group g: 4 g +
// i, then N / 2 + 4 g + i - 4 (two runs of 4 floats, 16-byte aligned).
template <int N>
__device__ __forceinline__ int at8(int g, int i) {
  return i < 4 ? 4 * g + i : N / 2 + 4 * g + i - 4;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Two runs of 4 floats to p and p + H.
template <int H>
__device__ __forceinline__ void sts8(float* p, float x0, float x1, float x2, float x3, float x4,
                                     float x5, float x6, float x7) {
  *reinterpret_cast<float4*>(p) = make_float4(x0, x1, x2, x3);
  *reinterpret_cast<float4*>(p + H) = make_float4(x4, x5, x6, x7);
}

template <int H>
__device__ __forceinline__ void lds8(const float* p, float (&v)[8]) {
  const float4 x = lds4(p), y = lds4(p + H);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
}

// N staged tokens' head (from column sh of their token-major runs) into
// `dst` k-major: column d of token t at dst[d N + t]. A lane moves one
// 16-byte run of a token a step; consecutive lanes take consecutive tokens
// (PITCH / 4 is odd, so their 16-byte reads and their 4-byte writes fall in
// distinct banks). Lanes [0, NT) of the block call it, as `lane`.
template <class T, int N, int NT>
__device__ __forceinline__ void to_kmajor(const float* src, float* dst, int sh, int lane) {
  static_assert(T::PITCH % 8 == 4, "an odd number of 16-byte runs a row");
  for (int idx = lane; idx < N * T::CH; idx += NT) {
    const int t = idx % N, ch = idx / N;
    const float4 x = lds4(src + t * T::PITCH + 4 * ch);
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * ch + e - sh;
      if (d >= 0 && d < T::D) dst[d * N + t] = v[e];
    }
  }
}

template <int H>
__device__ __forceinline__ void ldg8(const float* p, float (&v)[8]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  const float4 y = __ldg(reinterpret_cast<const float4*>(p + H));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
}

// The logits (log2 units) of a lane's 8 x 8 tile of q.k sums, in place: its
// rows are queries of group qg and its columns key places of group kg, or
// (KEY_ROWS) the other way round. Each quarter of the tile pairs a run of 4
// queries of one query-window row with a run of 4 key places of one key-
// window row, so its 16 bias indices are 7 consecutive ones (the query's
// place minus the key's, or its negative) and its region mask and key
// window are the runs' (the key window's end is checked a place where a row
// holds WK % 4 != 0 places): 7 reads of the table a quarter, then one FMA a
// logit.
template <class T, bool KEY_ROWS>
__device__ __forceinline__ void logits8(float (&s)[8][8], float scale2, const float* bias,
                                        int qt, int qg, const int* qreg, int kg,
                                        const int* kpart, const int* kreg) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q0 = at8<T::QT>(qg, 4 * r), qb = query_base<T>(qt * T::QT + q0), qr = qreg[q0];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k0 = at8<T::KT>(kg, 4 * c), kr = kreg[k0];
      const float mask = kr < 0 ? kNeg : (qr == kr ? 0.0f : kRegionMask);
      const int b0 = kr < 0 ? 3 : qb + kpart[k0];  // a key past the window reads any entry
      float v[7];  // v[e]: query place minus key place e - 3 (OVERLAP: key minus query)
#pragma unroll
      for (int e = 0; e < 7; ++e) {
        int b = b0 + e - 3;
        if (T::OVERLAP && b < 0) b += T::NB;
        v[e] = bias[b] + mask;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& x = KEY_ROWS ? s[4 * c + j][4 * r + i] : s[4 * r + i][4 * c + j];
          x = fmaf(x, scale2, v[T::OVERLAP ? 3 + j - i : 3 + i - j]);
          // a key-window row of WK % 4 places ends inside a run: those past it, no key
          if (T::WK % 4 && kreg[k0 + j] < 0) x = kNeg;
        }
    }
  }
}

__device__ __forceinline__ void zero8(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// acc[i][j] += sum over k < K of a[k AP + at8(i)] b[k BP + at8(j)], with a and
// b at the lane's group (its 8 values of row k at [0, 4) and [AH, AH + 4)):
// two 16-byte reads of each operand and 64 FMAs a step.
template <int K, int AP, int AH, int BP, int BH>
__device__ __forceinline__ void outer8(float (&acc)[8][8], const float* __restrict__ a,
                                       const float* __restrict__ b) {
  static_assert(K % 2 == 0, "steps in pairs");
  float av[2][8], bv[2][8];  // this step's values and the next's
  lds8<AH>(a, av[0]);
  lds8<BH>(b, bv[0]);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    if (k + 1 < K) {
      lds8<AH>(a + (k + 1) * AP, av[(k + 1) & 1]);
      lds8<BH>(b + (k + 1) * BP, bv[(k + 1) & 1]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[k & 1][i], bv[k & 1][j], acc[i][j]);
  }
}

// A lane's 8 staged columns of one token (at8 of its column group g along
// DP) that lie in the head (from column sh), times mul, to its head slice.
template <class T>
__device__ __forceinline__ void store8(float* dst, int g, int sh, const float (&v)[8], float mul) {
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const int col = at8<T::DP>(g, e) - sh;
    if (col >= 0 && col < T::D) {
      *reinterpret_cast<float2*>(dst + col) = make_float2(v[e] * mul, v[e + 1] * mul);
    }
  }
}

// The split parts of a product a lane group's tile was split into, added in
// order of part into part 0's lanes: lane (part p, tile w) of W tiles passes
// its tile through red (the staged tiles' place, read no more) to lane (0, w).
// Every thread calls it.
template <int W, int SPLIT>
__device__ __forceinline__ void add_parts(float (&acc)[8][8], float* red, int part, int w) {
  if (part > 0) {
#pragma unroll
    for (int v = 0; v < 64; ++v) red[((part - 1) * 64 + v) * W + w] = acc[v / 8][v % 8];
  }
  __syncthreads();
  if (part == 0) {
    for (int p = 1; p < SPLIT; ++p) {
#pragma unroll
      for (int v = 0; v < 64; ++v) acc[v / 8][v % 8] += red[((p - 1) * 64 + v) * W + w];
    }
  }
}

template <class T>
__global__ void __launch_bounds__(T::FTHREADS) tiled_attention_forward_kernel(const TArgs a) {
  constexpr int NT = T::FTHREADS, QT = T::QT, KT = T::KT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* qk = sm + T::F_Q;     // q, k-major: qk[d QT + query]
  float* kk = sm + T::F_K;     // the key tile's k, k-major
  float* ktm = sm + T::F_KT;   // the next key tile's k, token-major
  float* vt = sm + T::F_V;     // the key tile's v, token-major
  float* pt = sm + T::F_PT;    // P^T: pt[key QT + query]; first q, token-major
  float* tmax = sm + T::F_TMAX;  // a row's max and sum over each key group of the tile
  float* tsum = sm + T::F_TSUM;
  float* mrow = sm + T::F_M;   // the running max and sum of a row, and its rescale
  float* lrow = sm + T::F_L;
  float* alpha = sm + T::F_A;
  float* bias = sm + T::F_BIAS;
  long long* qtok = reinterpret_cast<long long*>(sm + T::F_END);
  long long* ktok = qtok + QT;  // two buffers
  int* qreg = reinterpret_cast<int*>(ktok + 2 * KT);
  int* kreg = qreg + QT;        // two buffers
  int* kpart = kreg + 2 * KT;   // two buffers

  const int tid = threadIdx.x;
  const int qt = static_cast<int>(blockIdx.x % T::NQT);
  const long long wh = blockIdx.x / T::NQT;
  const int head = static_cast<int>(wh % a.heads);
  const Where w = where<T::WQ>(a, wh / a.heads);
  const int c = a.heads * T::D, sh = head_shift<T::D>(head);
  auto locate_keys = [&](int kt, int buf) {
    for (int t = tid; t < KT; t += NT) {
      key_token<T>(a, w, kt, t, ktok + buf * KT, kreg + buf * KT, kpart + buf * KT);
    }
  };
  for (int n = tid; n < T::NB; n += NT) bias[n] = a.table[n * a.heads + head] * kLog2e;
  for (int t = tid; t < QT; t += NT) {
    query_token<T>(a, w, qt, t, qtok, qreg);
    mrow[t] = kNeg;
    lrow[t] = 0.0f;
  }
  locate_keys(0, 0);
  __syncthreads();
  stage_tokens<T>(a.qkv, 3LL * c, head * T::D, qtok, QT, pt, NT);
  stage_tokens<T>(a.qkv, 3LL * c, c + head * T::D, ktok, KT, ktm, NT);
  stage_tokens<T>(a.qkv, 3LL * c, 2 * c + head * T::D, ktok, KT, vt, NT);
  copies_landed();
  __syncthreads();
  to_kmajor<T, QT, NT>(pt, qk, sh, tid);
  to_kmajor<T, KT, NT>(ktm, kk, sh, tid);
  if (T::NKT > 1) locate_keys(1, 1);
  __syncthreads();

  const float scale2 = a.scale * kLog2e;
  const bool s_lane = tid < T::S_TILES;  // a tile of S: queries of group sq, keys of group sk
  const int sq = tid % T::NQG, sk = tid / T::NQG;
  const int og = tid % T::NDG, oq = (tid / T::NDG) % T::NQG, part = tid / T::O_TILES;
  constexpr int KS = KT / T::FSPLIT;  // keys of O's part
  float o[8][8];
  zero8(o);
  for (int kt = 0; kt < T::NKT; ++kt) {
    const int cur = kt & 1;
    const bool next = kt + 1 < T::NKT;
    if (next) {  // the next tile's k comes in while this one computes
      stage_tokens<T>(a.qkv, 3LL * c, c + head * T::D, ktok + (cur ^ 1) * KT, KT, ktm, NT);
    }
    const int* kreg_t = kreg + cur * KT;
    const int* kpart_t = kpart + cur * KT;
    float s[8][8];
    if (s_lane) {
      zero8(s);
      outer8<T::D, QT, QT / 2, KT, KT / 2>(s, qk + 4 * sq, kk + 4 * sk);
      logits8<T, false>(s, scale2, bias, qt, sq, qreg, sk, kpart_t, kreg_t);
      float mx[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mx[i] = kNeg;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx[i] = fmaxf(mx[i], s[i][j]);
      }
      sts8<QT / 2>(tmax + sk * QT + 4 * sq, mx[0], mx[1], mx[2], mx[3], mx[4], mx[5], mx[6],
                   mx[7]);
    }
    copies_landed();  // the next tile's k, and this one's v
    __syncthreads();
    if (next) {  // k is read: the next tile's takes its place; its tokens' buffer is free
      to_kmajor<T, KT, NT>(ktm, kk, sh, tid);
      if (kt + 2 < T::NKT) locate_keys(kt + 2, cur);
    }
    for (int q = tid; q < QT; q += NT) {
      float mt = kNeg;
      for (int g = 0; g < T::NKG; ++g) mt = fmaxf(mt, tmax[g * QT + q]);
      const float mnew = fmaxf(mrow[q], mt);
      alpha[q] = exp2f(mrow[q] - mnew);
      mrow[q] = mnew;
    }
    __syncthreads();
    if (s_lane) {
      float m[8], sum[8];
      lds8<QT / 2>(mrow + 4 * sq, m);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sum[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = exp2f(s[i][j] - m[i]);
          sum[i] += s[i][j];
        }
      }
      sts8<QT / 2>(tsum + sk * QT + 4 * sq, sum[0], sum[1], sum[2], sum[3], sum[4], sum[5],
                   sum[6], sum[7]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sts8<QT / 2>(pt + at8<KT>(sk, j) * QT + 4 * sq, s[0][j], s[1][j], s[2][j], s[3][j],
                     s[4][j], s[5][j], s[6][j], s[7][j]);
      }
    }
    __syncthreads();
    for (int q = tid; q < QT; q += NT) {
      float sum = 0.0f;
      for (int g = 0; g < T::NKG; ++g) sum += tsum[g * QT + q];
      lrow[q] = fmaf(lrow[q], alpha[q], sum);
    }
    float al[8];
    lds8<QT / 2>(alpha + 4 * oq, al);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] *= al[i];
    outer8<KS, QT, QT / 2, T::PITCH, T::DP / 2>(o, pt + part * KS * QT + 4 * oq,
                                                vt + part * KS * T::PITCH + 4 * og);
    __syncthreads();
    if (next) {  // v is read
      stage_tokens<T>(a.qkv, 3LL * c, 2 * c + head * T::D, ktok + (cur ^ 1) * KT, KT, vt, NT);
    }
  }
  add_parts<T::O_TILES, T::FSPLIT>(o, sm, part, tid % T::O_TILES);
  if (part == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = at8<QT>(oq, i);
      store8<T>(a.out + qtok[q] * c + head * T::D, og, sh, o[i], 1.0f / lrow[q]);
    }
  }
  for (int q = tid; q < QT; q += NT) {
    a.lse[wh * T::NQ + qt * QT + q] = mrow[q] + log2f(lrow[q]);
  }
}

template <class T>
__global__ void __launch_bounds__(T::BTHREADS) tiled_attention_dq_kernel(const TArgs a) {
  constexpr int NT = T::BTHREADS, QT = T::QT, KT = T::KT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* qk = sm + T::B_Q;    // q, k-major
  float* gk = sm + T::B_G;    // dO, k-major
  float* kk = sm + T::B_K;    // the key tile's k and v, k-major
  float* vk = sm + T::B_V;
  float* ktm = sm + T::B_KT;  // k, token-major, this tile's and the next's
  float* vtm = sm + T::B_VT;  // the next tile's v, token-major
  float* dl = sm + T::B_DL;   // P, then dL: dl[key QT + query]
  float* lse = sm + T::B_LSE;
  float* delta = sm + T::B_DELTA;
  float* bias = sm + T::B_BIAS;
  long long* qtok = reinterpret_cast<long long*>(sm + T::B_END);
  long long* ktok = qtok + QT;  // two buffers
  int* qreg = reinterpret_cast<int*>(ktok + 2 * KT);
  int* kreg = qreg + QT;        // two buffers
  int* kpart = kreg + 2 * KT;   // two buffers

  const int tid = threadIdx.x;
  const int qt = static_cast<int>(blockIdx.x % T::NQT);
  const long long wh = blockIdx.x / T::NQT;
  const int head = static_cast<int>(wh % a.heads);
  const Where w = where<T::WQ>(a, wh / a.heads);
  const int c = a.heads * T::D, sh = head_shift<T::D>(head);
  const long long at = wh * T::NQ + qt * QT;
  auto locate_keys = [&](int kt, int buf) {
    for (int t = tid; t < KT; t += NT) {
      key_token<T>(a, w, kt, t, ktok + buf * KT, kreg + buf * KT, kpart + buf * KT);
    }
  };
  auto stage_keys = [&](int buf, int into) {  // key tile buffer buf's k and v, token-major
    stage_tokens<T>(a.qkv, 3LL * c, c + head * T::D, ktok + buf * KT, KT, ktm + into * T::KTM,
                    NT);
    stage_tokens<T>(a.qkv, 3LL * c, 2 * c + head * T::D, ktok + buf * KT, KT, vtm, NT);
  };
  for (int n = tid; n < T::NB; n += NT) bias[n] = a.table[n * a.heads + head] * kLog2e;
  for (int t = tid; t < QT; t += NT) {
    query_token<T>(a, w, qt, t, qtok, qreg);
    lse[t] = a.lse_r[at + t];
  }
  locate_keys(0, 0);
  __syncthreads();
  // q, dO and the output, token-major, in the places of dL, k and v (k-major)
  // and the second key tile; the first key tile's k and v beside them
  float* g_tm = kk;
  float* o_tm = ktm + T::KTM;
  stage_tokens<T>(a.qkv, 3LL * c, head * T::D, qtok, QT, dl, NT);
  stage_tokens<T>(a.dout, c, head * T::D, qtok, QT, g_tm, NT);
  stage_tokens<T>(a.out_r, c, head * T::D, qtok, QT, o_tm, NT);
  stage_keys(0, 0);
  copies_landed();
  __syncthreads();
  for (int q = tid; q < QT; q += NT) {
    float acc = 0.0f;
    for (int d = sh; d < sh + T::D; ++d) {
      acc = fmaf(g_tm[q * T::PITCH + d], o_tm[q * T::PITCH + d], acc);
    }
    delta[q] = acc;  // rowsum(dO o O) = rowsum(P o dP)
    a.delta[at + q] = acc;
  }
  to_kmajor<T, QT, NT>(dl, qk, sh, tid);
  to_kmajor<T, QT, NT>(g_tm, gk, sh, tid);
  __syncthreads();
  to_kmajor<T, KT, NT>(ktm, kk, sh, tid);
  to_kmajor<T, KT, NT>(vtm, vk, sh, tid);
  if (T::NKT > 1) locate_keys(1, 1);
  __syncthreads();

  const float scale2 = a.scale * kLog2e;
  // S (lanes [0, S_TILES)) and dP (the rest) of the same tile places side by side
  const bool s_lane = tid < T::S_TILES;
  const int tile = s_lane ? tid : tid - T::S_TILES;
  const int sq = tile % T::NQG, sk = tile / T::NQG;
  const float* sa = (s_lane ? qk : gk) + 4 * sq;
  const float* sb = (s_lane ? kk : vk) + 4 * sk;
  const int og = tid % T::NDG, oq = (tid / T::NDG) % T::NQG, part = tid / T::O_TILES;
  constexpr int KS = KT / T::QSPLIT;  // keys of dQ's part
  float dq[8][8];
  zero8(dq);
  for (int kt = 0; kt < T::NKT; ++kt) {
    const int cur = kt & 1;
    const bool next = kt + 1 < T::NKT;
    if (next) stage_keys(cur ^ 1, cur ^ 1);  // the next tile's k and v land while this one computes
    const int* kreg_t = kreg + cur * KT;
    const int* kpart_t = kpart + cur * KT;
    float s[8][8];
    zero8(s);
    outer8<T::D, QT, QT / 2, KT, KT / 2>(s, sa, sb);
    if (s_lane) {
      logits8<T, false>(s, scale2, bias, qt, sq, qreg, sk, kpart_t, kreg_t);
      float lq[8];
      lds8<QT / 2>(lse + 4 * sq, lq);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = exp2f(s[i][j] - lq[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sts8<QT / 2>(dl + at8<KT>(sk, j) * QT + 4 * sq, s[0][j], s[1][j], s[2][j], s[3][j],
                     s[4][j], s[5][j], s[6][j], s[7][j]);
      }
    }
    copies_landed();  // the next tile's k and v
    __syncthreads();
    if (next && kt + 2 < T::NKT) locate_keys(kt + 2, cur);  // this tile's buffer is free
    if (s_lane && next) {  // k and v k-major are read: the next tile's take their place
      to_kmajor<T, KT, T::S_TILES>(ktm + (cur ^ 1) * T::KTM, kk, sh, tid);
      to_kmajor<T, KT, T::S_TILES>(vtm, vk, sh, tid);
    }
    if (!s_lane) {  // dL = P o (dP - delta), over P in place
      float dlt[8];
      lds8<QT / 2>(delta + 4 * sq, dlt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* row = dl + at8<KT>(sk, j) * QT + 4 * sq;
        float p[8];
        lds8<QT / 2>(row, p);
        sts8<QT / 2>(row, p[0] * (s[0][j] - dlt[0]), p[1] * (s[1][j] - dlt[1]),
                     p[2] * (s[2][j] - dlt[2]), p[3] * (s[3][j] - dlt[3]),
                     p[4] * (s[4][j] - dlt[4]), p[5] * (s[5][j] - dlt[5]),
                     p[6] * (s[6][j] - dlt[6]), p[7] * (s[7][j] - dlt[7]));
      }
    }
    __syncthreads();
    outer8<KS, QT, QT / 2, T::PITCH, T::DP / 2>(dq, dl + part * KS * QT + 4 * oq,
                                                ktm + cur * T::KTM + part * KS * T::PITCH +
                                                    4 * og);
    __syncthreads();
  }
  add_parts<T::O_TILES, T::QSPLIT>(dq, sm, part, tid % T::O_TILES);
  if (part == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      store8<T>(a.dqkv + qtok[at8<QT>(oq, i)] * (3LL * c) + head * T::D, og, sh, dq[i], a.scale);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(T::BTHREADS) tiled_attention_dkv_kernel(const TArgs a) {
  constexpr int NT = T::BTHREADS, QT = T::QT, KT = T::KT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* kk = sm + T::V_K;    // k and v, k-major
  float* vk = sm + T::V_V;
  float* qk = sm + T::V_Q;    // the query tile's q and dO, k-major
  float* gk = sm + T::V_G;
  float* tm = sm + T::V_TM;   // q then dO, token-major, of this query tile and the next
  float* pb = sm + T::V_P;    // P: pb[query KT + key]; first k and v, token-major
  float* lb = sm + T::V_DL;   // dL, the same layout
  float* bias = sm + T::V_BIAS;
  float* bins = sm + T::V_BINS;  // the block's sums by key-minus-query offset
  long long* ktok = reinterpret_cast<long long*>(sm + T::V_END);
  long long* qtoks = ktok + KT;  // two buffers
  int* kreg = reinterpret_cast<int*>(qtoks + 2 * QT);
  int* kpart = kreg + KT;
  int* qregs = kpart + KT;        // two buffers

  const int tid = threadIdx.x;
  const int kt = static_cast<int>(blockIdx.x % T::NKT);
  const long long wh = blockIdx.x / T::NKT;
  const int head = static_cast<int>(wh % a.heads);
  const long long window = wh / a.heads;
  const Where w = where<T::WQ>(a, window);
  const int c = a.heads * T::D, sh = head_shift<T::D>(head);
  // a query tile's tokens and regions into buffer buf
  auto locate_queries = [&](int qt, int buf) {
    for (int t = tid; t < QT; t += NT) {
      query_token<T>(a, w, qt, t, qtoks + buf * QT, qregs + buf * QT);
    }
  };
  auto stage_queries = [&](int buf) {  // its q and dO, token-major, into buffer buf
    stage_tokens<T>(a.qkv, 3LL * c, head * T::D, qtoks + buf * QT, QT, tm + 2 * buf * T::QTM,
                    NT);
    stage_tokens<T>(a.dout, c, head * T::D, qtoks + buf * QT, QT, tm + (2 * buf + 1) * T::QTM,
                    NT);
  };
  for (int n = tid; n < T::NB; n += NT) {
    bias[n] = a.table[n * a.heads + head] * kLog2e;
    bins[n] = 0.0f;
  }
  for (int t = tid; t < KT; t += NT) key_token<T>(a, w, kt, t, ktok, kreg, kpart);
  locate_queries(0, 0);
  __syncthreads();
  stage_tokens<T>(a.qkv, 3LL * c, c + head * T::D, ktok, KT, pb, NT);
  stage_tokens<T>(a.qkv, 3LL * c, 2 * c + head * T::D, ktok, KT, pb + T::KTM, NT);
  stage_queries(0);
  copies_landed();
  __syncthreads();
  to_kmajor<T, KT, NT>(pb, kk, sh, tid);
  to_kmajor<T, KT, NT>(pb + T::KTM, vk, sh, tid);
  to_kmajor<T, QT, NT>(tm, qk, sh, tid);
  to_kmajor<T, QT, NT>(tm + T::QTM, gk, sh, tid);
  if (T::NQT > 1) locate_queries(1, 1);
  __syncthreads();

  const float scale2 = a.scale * kLog2e;
  // S^T (lanes [0, S_TILES)) and dP^T (the rest): keys of group sk, queries of group sq
  const bool s_lane = tid < T::S_TILES;
  const int tile = s_lane ? tid : tid - T::S_TILES;
  const int sk = tile % T::NKG, sq = tile / T::NKG;
  const float* sa = (s_lane ? kk : vk) + 4 * sk;
  const float* sb = (s_lane ? qk : gk) + 4 * sq;
  // dV (lanes [0, NT / 2)) and dK (the rest): keys of group ok, columns of group og
  const bool v_lane = tid < NT / 2;
  const int u = v_lane ? tid : tid - NT / 2;
  const int og = u % T::NDG, ok = (u / T::NDG) % T::NKG, part = u / (T::KV_TILES / 2);
  constexpr int QS = QT / T::KSPLIT;  // queries of dK's and dV's part
  const float* pa = (v_lane ? pb : lb) + part * QS * KT + 4 * ok;
  const int pbt = (v_lane ? T::QTM : 0) + part * QS * T::PITCH + 4 * og;  // in a query buffer
  float acc[8][8];
  zero8(acc);
  // the key places of this tile, [j_lo, j_hi), on the key window's rows [kr_lo, kr_hi]
  const int j_lo = kt * KT, j_hi = min(j_lo + KT, T::NKP);
  const int kr_lo = j_lo / T::WKP, kr_hi = (j_hi - 1) / T::WKP;
  for (int qt = 0; qt < T::NQT; ++qt) {
    const int cur = qt & 1;
    const bool next = qt + 1 < T::NQT;
    if (next) stage_queries(cur ^ 1);
    const int* qreg = qregs + cur * QT;
    const long long at = wh * T::NQ + qt * QT;  // the tile's statistics
    float s[8][8];
    zero8(s);
    outer8<T::D, KT, KT / 2, QT, QT / 2>(s, sa, sb);
    if (s_lane) {
      logits8<T, true>(s, scale2, bias, qt, sq, qreg, sk, kpart, kreg);
      float lq[8];
      ldg8<QT / 2>(a.lse_r + at + 4 * sq, lq);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = exp2f(s[i][j] - lq[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sts8<KT / 2>(pb + at8<QT>(sq, j) * KT + 4 * sk, s[0][j], s[1][j], s[2][j], s[3][j],
                     s[4][j], s[5][j], s[6][j], s[7][j]);
      }
    }
    copies_landed();  // the next tile's q and dO
    __syncthreads();
    if (next && qt + 2 < T::NQT) locate_queries(qt + 2, cur);  // this tile's buffer is free
    if (s_lane && next) {  // q and dO k-major are read: the next tile's take their place
      to_kmajor<T, QT, T::S_TILES>(tm + 2 * (cur ^ 1) * T::QTM, qk, sh, tid);
      to_kmajor<T, QT, T::S_TILES>(tm + (2 * (cur ^ 1) + 1) * T::QTM, gk, sh, tid);
    }
    if (!s_lane) {  // dL = P o (dP - delta)
      float dlt[8];
      ldg8<QT / 2>(a.delta_r + at + 4 * sq, dlt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int off = at8<QT>(sq, j) * KT + 4 * sk;
        float p[8];
        lds8<KT / 2>(pb + off, p);
        sts8<KT / 2>(lb + off, p[0] * (s[0][j] - dlt[j]), p[1] * (s[1][j] - dlt[j]),
                     p[2] * (s[2][j] - dlt[j]), p[3] * (s[3][j] - dlt[j]),
                     p[4] * (s[4][j] - dlt[j]), p[5] * (s[5][j] - dlt[j]),
                     p[6] * (s[6][j] - dlt[j]), p[7] * (s[7][j] - dlt[j]));
      }
    }
    __syncthreads();
    // dL folded into the bins of this pair of tiles' offsets dr = kr - qr,
    // dc = kc - qc; each bin a thread's, its pairs added in a fixed order
    const int qr_lo = qt * T::QR, qr_hi = qr_lo + T::QR;
    const int dr_lo = kr_lo - (qr_hi - 1), ndr = kr_hi - qr_lo - dr_lo + 1;
    for (int sl = tid; sl < ndr * T::L; sl += NT) {
      const int dr = dr_lo + sl / T::L, dc = sl % T::L - (T::WQ - 1);
      float sum = 0.0f;
      for (int qr = max(qr_lo, kr_lo - dr); qr < min(qr_hi, kr_hi + 1 - dr); ++qr) {
        const int j0 = (qr + dr) * T::WKP + dc;  // the key place of query column 0
        const int qc_lo = max(max(0, -dc), j_lo - j0);
        const int qc_hi = min(min(T::WQ, T::WK - dc), j_hi - j0);
        const float* d0 = lb + (qr - qr_lo) * T::WQ * KT + j0 - j_lo;
        for (int qc = qc_lo; qc < qc_hi; ++qc) sum += d0[qc * (KT + 1)];
      }
      bins[(dr + T::WQ - 1) * T::L + dc + T::WQ - 1] += sum;
    }
    outer8<QS, KT, KT / 2, T::PITCH, T::DP / 2>(acc, pa, tm + 2 * cur * T::QTM + pbt);
    __syncthreads();
  }
  add_parts<T::KV_TILES, T::KSPLIT>(acc, sm, part, (v_lane ? 0 : T::KV_TILES / 2) +
                                                       u % (T::KV_TILES / 2));
  if (part == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = at8<KT>(ok, i);
      if (kreg[r] < 0) continue;
      const int j = kt * KT + r;  // its key: row j / WKP, column j % WKP
      float* dst = T::OVERLAP
                       ? a.kvpart + (window * T::NK + j / T::WKP * T::WK + j % T::WKP) * (2LL * c)
                       : a.dqkv + ktok[r] * (3LL * c) + c;
      store8<T>(dst + (v_lane ? c : 0) + head * T::D, og, sh, acc[i], v_lane ? 1.0f : a.scale);
    }
  }
  float* out = a.partial + (window * T::NKT + kt) * (static_cast<long long>(T::NB) * a.heads);
  for (int sl = tid; sl < T::NB; sl += NT) {
    const int dr = sl / T::L - (T::WQ - 1), dc = sl % T::L - (T::WQ - 1);
    out[offset_bin<T>(dr, dc) * a.heads + head] = bins[sl];
  }
}

// With an overlap: each token's dK and dV (4 floats of 2C a thread), the sum
// over the key windows that hold it, in order of window row then column.
template <class T>
__global__ void __launch_bounds__(256) kv_fold_kernel(const TArgs a, long long tokens) {
  const int c = a.heads * T::D, per = c / 2;  // float4s of 2C
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  if (idx >= tokens * per) return;
  const long long tok = idx / per;
  const int ch = static_cast<int>(idx % per) * 4;
  const int col = static_cast<int>(tok % a.wp), row = static_cast<int>((tok / a.wp) % a.hp);
  const long long b = tok / (static_cast<long long>(a.wp) * a.hp);
  const int nwr = a.hp / T::WQ, nwc = a.wp / T::WQ;
  const int wr_hi = min((row + T::PAD) / T::WQ, nwr - 1), wc_hi = min((col + T::PAD) / T::WQ, nwc - 1);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int wr = max(0, wr_hi - 1); wr <= wr_hi; ++wr) {
    const int kr = row - (wr * T::WQ - T::PAD);
    if (kr < 0 || kr >= T::WK) continue;
    for (int wc = max(0, wc_hi - 1); wc <= wc_hi; ++wc) {
      const int kc = col - (wc * T::WQ - T::PAD);
      if (kc < 0 || kc >= T::WK) continue;
      const long long window = (b * nwr + wr) * nwc + wc;
      const float4 x = __ldg(reinterpret_cast<const float4*>(
          a.kvpart + (window * T::NK + kr * T::WK + kc) * (2LL * c) + ch));
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
  }
  *reinterpret_cast<float4*>(a.dqkv + tok * (3LL * c) + c + ch) = acc;
}

template <int WQ_, int WK_, int D_, int KT_>
struct Shape {
  using T = Tiled<WQ_, WK_, D_, KT_>;
};

// f(Shape<...>{}) for the instantiated (window, key window, head size), or
// `none`.
template <class F>
int tiled_dispatch(int window, int key_window, int head_dim, int none, F f) {
  if (window == 16 && key_window == 16 && head_dim == 30) return f(Shape<16, 16, 30, 64>{});
  if (window == 16 && key_window == 24 && head_dim == 30) return f(Shape<16, 24, 30, 64>{});
  if (window == 4 && key_window == 6 && head_dim == 6) return f(Shape<4, 6, 6, 48>{});
  if (window == 8 && key_window == 8 && head_dim == 30) return f(Shape<8, 8, 30, 64>{});
  return none;
}

constexpr int kRefused = static_cast<int>(cudaErrorInvalidValue);

// The query windows of a map, or 0 for a geometry no tiled kernel takes.
long long tiled_windows(int batch, int hp, int wp, int heads, int window, int key_window,
                        int shift) {
  if (batch < 1 || heads < 1 || heads % 2 || window < 1 || hp < window || wp < window ||
      hp % window || wp % window || shift < 0 || shift >= window || shift % 4 ||
      (key_window != window && shift != 0)) {
    return 0;
  }
  return static_cast<long long>(batch) * (hp / window) * (wp / window);
}

template <class T, class Kernel>
int launch_tiled(Kernel kernel, size_t smem, long long blocks, int threads, const TArgs& a,
                 unsigned& devices, cudaStream_t s) {
  if (blocks > INT_MAX) return kRefused;
  const cudaError_t err = allow_smem(kernel, smem, devices);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The key tiles of the tiled kernels' shape (window, key window, head size),
// or 0 where none is instantiated: the rows of the backward's bias partials
// are windows times this.
extern "C" int srpde_tiled_attention_key_tiles(int window, int key_window, int head_dim) {
  return tiled_dispatch(window, key_window, head_dim, 0,
                        [](auto shape) { return decltype(shape)::T::NKT; });
}

// out (B, Hp, Wp, C) and lse (B windows heads, window^2) from qkv (B, Hp, Wp,
// 3C) and the bias table ((window + key_window - 1)^2, heads).
extern "C" int srpde_tiled_attention_forward(const float* qkv, const float* table, float* out,
                                             float* lse, int batch, int hp, int wp, int heads,
                                             int window, int key_window, int head_dim, int shift,
                                             float scale, void* stream) {
  const long long windows = tiled_windows(batch, hp, wp, heads, window, key_window, shift);
  if (windows == 0) return kRefused;
  TArgs a{};
  a.qkv = qkv;
  a.table = table;
  a.out = out;
  a.lse = lse;
  a.hp = hp;
  a.wp = wp;
  a.heads = heads;
  a.shift = shift;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tiled_dispatch(window, key_window, head_dim, kRefused, [&](auto shape) {
    using T = typename decltype(shape)::T;
    static unsigned devices = 0;
    return launch_tiled<T>(tiled_attention_forward_kernel<T>, T::kForwardSmem,
                           windows * heads * T::NQT, T::FTHREADS, a, devices, s);
  });
}

// dqkv (B, Hp, Wp, 3C) and dtable from dout, qkv, the forward's out and lse;
// scratch: delta (B windows heads, window^2), partial (B windows key_tiles,
// (window + key_window - 1)^2 heads) and, where key_window > window,
// kv_partial (B windows, key_window^2, 2C).
extern "C" int srpde_tiled_attention_backward(const float* dout, const float* qkv,
                                              const float* out, const float* lse,
                                              const float* table, float* dqkv, float* delta,
                                              float* kv_partial, float* partial, float* dtable,
                                              int batch, int hp, int wp, int heads, int window,
                                              int key_window, int head_dim, int shift,
                                              float scale, void* stream) {
  const long long windows = tiled_windows(batch, hp, wp, heads, window, key_window, shift);
  if (windows == 0 || (key_window != window && kv_partial == nullptr)) return kRefused;
  TArgs a{};
  a.qkv = qkv;
  a.table = table;
  a.dout = dout;
  a.out_r = out;
  a.lse_r = lse;
  a.delta_r = delta;
  a.dqkv = dqkv;
  a.delta = delta;
  a.kvpart = kv_partial;
  a.partial = partial;
  a.hp = hp;
  a.wp = wp;
  a.heads = heads;
  a.shift = shift;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tiled_dispatch(window, key_window, head_dim, kRefused, [&](auto shape) {
    using T = typename decltype(shape)::T;
    static unsigned dq_devices = 0, dkv_devices = 0;
    int err = launch_tiled<T>(tiled_attention_dq_kernel<T>, T::kDqSmem, windows * heads * T::NQT,
                              T::BTHREADS, a, dq_devices, s);
    if (err != 0) return err;
    err = launch_tiled<T>(tiled_attention_dkv_kernel<T>, T::kDkvSmem, windows * heads * T::NKT,
                          T::BTHREADS, a, dkv_devices, s);
    if (err != 0) return err;
    const int outs = T::NB * heads;
    bias_grad_sum_kernel<<<(outs + kSumOuts - 1) / kSumOuts, dim3(kSumOuts, kSumSlices), 0, s>>>(
        partial, windows * T::NKT, outs, dtable);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0 || !T::OVERLAP) return err;
    const long long tokens = static_cast<long long>(batch) * hp * wp;
    const long long work = tokens * (heads * T::D / 2);
    kv_fold_kernel<T><<<static_cast<unsigned>((work + 255) / 256), 256, 0, s>>>(a, tokens);
    return static_cast<int>(cudaGetLastError());
  });
}
