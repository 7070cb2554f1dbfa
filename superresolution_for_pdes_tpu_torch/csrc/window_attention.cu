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
// Forward: one block per (window, head, tile of QT queries: QT / WQ rows of
// the query window), 2 QT threads (a lane owns 4 query rows by KT / 8 key
// columns of a key tile, as the pair's forward). It walks the key tiles (KR
// rows of the key window each) with an online softmax: running max and sum
// a row, the output rescaled when the max grows, so no logits are held past
// their tile. It writes the output in token layout and each row's
// log-sum-exp (log2 units).
//
// Backward, three launches (four with an overlap) and no float atomics:
//   dq:  one block per query tile, walking the key tiles: delta = rowsum(dO
//        o O) from the forward's output, P = exp2(L - lse), dL = P o (dP -
//        delta), dQ = scale dL K, written in the qkv linear's layout; delta
//        is written for the next launch;
//   dkv: one block per (window, head, key tile), walking the query tiles with
//        the logits transposed (a lane owns 4 key rows): dV = P^T dO, dK =
//        scale dL^T Q, and dL folded into the block's bins of the relative
//        offset (each bin a thread's, added in a fixed order) and written as
//        one partial of the table a block; dK and dV go to the qkv linear's
//        layout (WK == WQ: every key in exactly one window) or, with an
//        overlap, to one row a window and key of a scratch (kv_partial);
//   the bias table's partials summed in a fixed order (bias_grad_sum_kernel);
//   with an overlap, kv_fold_kernel: each token's dK and dV summed over the
//        (at most 2 x 2) key windows that hold it, in a fixed order.
//
// Instantiated for (WQ, WK, D) = (16, 16, 30), HAB at HAT's published widths;
// (16, 24, 30), OCAB at those widths; (4, 6, 6), OCAB at the tests' TINY
// widths; and (8, 8, 30), SwinIR's window, which the wrapper sends to the pair
// above: it is built so that chip_smoke.py can time the tiled form against the
// pair at the pair's own shape. An even number of heads (16-byte aligned runs,
// as the pair).
// float32 on the CUDA cores; each launch allocates nothing.

namespace {

constexpr float kNeg = -1e30f;  // the logit of a place past the key window

template <int WQ_, int WK_, int D_, int KR_>
struct Tiled {
  static constexpr int WQ = WQ_, WK = WK_, D = D_, KR = KR_;
  static constexpr bool OVERLAP = WK > WQ;
  static constexpr int PAD = (WK - WQ) / 2;
  static constexpr int NQ = WQ * WQ, NK = WK * WK;
  static constexpr int QT = NQ < 64 ? NQ : 64;  // queries a tile
  static constexpr int QR = QT / WQ;            // query-window rows a tile
  static constexpr int NQT = NQ / QT;
  static constexpr int KT = KR * WK;            // key places a tile (the last may pass WK rows)
  static constexpr int NKT = (WK + KR - 1) / KR;
  static constexpr int L = WQ + WK - 1;         // side of the bias table
  static constexpr int NB = L * L;
  static constexpr int NBP = (NB + 3) / 4 * 4;
  static constexpr int OFF = WQ - WK + 1;
  static constexpr int QTHREADS = 2 * QT, KTHREADS = 2 * KT;
  static constexpr int TC = KT / 8, QC = QT / 8;
  static constexpr int DP = D + 2, PITCH = DP + 4, OC = DP / 8, CH = DP / 4;
  static constexpr int SK = KT + 4, SQ = QT + 4;
  // the walked tiles' tokens, copies, regions and bias parts are double-buffered
  static constexpr size_t kTokBytes = 2 * (QT + KT) * (sizeof(long long) + 2 * sizeof(int));
  static constexpr size_t kForwardSmem =
      (QT * PITCH + 4 * KT * PITCH + KT * SQ + NBP) * sizeof(float) + kTokBytes;
  static constexpr size_t kDqSmem =
      (2 * QT * PITCH + 4 * KT * PITCH + QT * SK + NBP) * sizeof(float) + kTokBytes;
  static constexpr size_t kDkvSmem =
      (2 * KT * PITCH + 4 * QT * PITCH + 2 * KT * SQ + 2 * NBP + 4 * QT) * sizeof(float) +
      kTokBytes;
  static_assert(QT % 16 == 0 && KT % 16 == 0 && QT % WQ == 0 && NQ % QT == 0, "tiles");
  static_assert(D % 4 == 2 && DP % 8 == 0, "a head's 16-byte aligned run is D + 2 floats");
  static_assert((WK - WQ) % 2 == 0 && PAD <= WQ / 2, "a key window centred on its query window");
  static_assert(SK >= PITCH, "the output tile is staged where dL goes");
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

// Query t of tile qt: its map place, region and base of the bias index.
template <class T>
__device__ __forceinline__ void query_token(const TArgs& a, const Where& w, int qt, int t,
                                            long long* tok, int* region, int* base) {
  const int i = qt * T::QT + t, qr = i / T::WQ, qc = i % T::WQ;
  rolled<T::WQ>(a, w.b, w.r0 + qr, w.c0 + qc, tok[t], region[t]);
  base[t] = T::OVERLAP ? T::OFF * (T::L + 1) - (qr * T::L + qc)
                       : (qr + T::WQ - 1) * T::L + qc + T::WQ - 1;
}

// Key place t of tile kt: its map place (-1: a zero key outside the map),
// region (-1: past the key window, no key) and part of the bias index.
template <class T>
__device__ __forceinline__ void key_token(const TArgs& a, const Where& w, int kt, int t,
                                          long long* tok, int* region, int* part) {
  const int j = kt * T::KT + t, kr = j / T::WK, kc = j % T::WK;
  part[t] = T::OVERLAP ? kr * T::L + kc : -(kr * T::L + kc);
  if (kr >= T::WK) {
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

// The logit (log2 units) of q.k = s between a query and a key.
template <class T>
__device__ __forceinline__ float tiled_logit(float s, float scale2, const float* bias, int qbase,
                                             int qregion, int kpart, int kregion) {
  if (kregion < 0) return kNeg;
  int b = qbase + kpart;
  if (T::OVERLAP && b < 0) b += T::NB;
  const float l = fmaf(s, scale2, bias[b]);
  return qregion == kregion ? l : l + kRegionMask;
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
// asynchronous copies; a token at -1 is filled with zeros.
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

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void copies_issued() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits for this thread's copies but those of the last group issued.
__device__ __forceinline__ void copies_but_last_done() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}


// After copies_done(): the two columns of each staged run outside the head
// set to zero, by the thread that copied them (the same loop as the tile's
// stage_tokens call, so no barrier is needed before); a __syncthreads() must
// follow.
template <class T>
__device__ __forceinline__ void zero_outside(float* dst, int n, int sh, int nthreads) {
  const int edge = sh ? 0 : T::CH - 1, zero = sh ? 0 : T::D;
  for (int idx = threadIdx.x; idx < n * T::CH; idx += nthreads) {
    const int t = idx / T::CH;
    if (idx - t * T::CH == edge) {
      *reinterpret_cast<float2*>(dst + t * T::PITCH + zero) = make_float2(0.0f, 0.0f);
    }
  }
}

// The key tiles of a (window, head), walked with the next tile's tokens
// located and its copies in flight while `body(k, v, kreg, kpart)` computes
// on this one (two buffers of each); every thread of the block calls it.
template <class T, class Body>
__device__ __forceinline__ void walk_key_tiles(const TArgs& a, const Where& w, int c, int head,
                                               int sh, float* kv, long long* ktok, int* kreg,
                                               int* kpart, Body body) {
  constexpr int KV = T::KT * T::PITCH;
  auto locate_and_copy = [&](int kt, int buf) {
    long long* tok = ktok + buf * T::KT;
    for (int t = threadIdx.x; t < T::KT; t += T::QTHREADS) {
      key_token<T>(a, w, kt, t, tok, kreg + buf * T::KT, kpart + buf * T::KT);
    }
    __syncthreads();
    stage_tokens<T>(a.qkv, 3LL * c, c + head * T::D, tok, T::KT, kv + 2 * buf * KV, T::QTHREADS);
    stage_tokens<T>(a.qkv, 3LL * c, 2 * c + head * T::D, tok, T::KT, kv + (2 * buf + 1) * KV,
                    T::QTHREADS);
    copies_issued();
  };
  locate_and_copy(0, 0);
  for (int kt = 0; kt < T::NKT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < T::NKT) {
      locate_and_copy(kt + 1, cur ^ 1);
      copies_but_last_done();
    } else {
      copies_done();
    }
    float* k = kv + 2 * cur * KV;
    zero_outside<T>(k, T::KT, sh, T::QTHREADS);
    zero_outside<T>(k + KV, T::KT, sh, T::QTHREADS);
    __syncthreads();
    body(k, k + KV, kreg + cur * T::KT, kpart + cur * T::KT);
    __syncthreads();  // this tile's buffers are read before the next but one fills them
  }
}

template <class T>
__global__ void __launch_bounds__(T::QTHREADS) tiled_attention_forward_kernel(const TArgs a) {
  extern __shared__ float4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  float* kv = q + T::QT * T::PITCH;      // two buffers of a key tile's k then v
  float* pt = kv + 4 * T::KT * T::PITCH;  // the key tile's P^T: pt[j SQ + i]
  float* bias = pt + T::KT * T::SQ;
  long long* qtok = reinterpret_cast<long long*>(bias + T::NBP);
  long long* ktok = qtok + T::QT;  // two buffers
  int* qreg = reinterpret_cast<int*>(ktok + 2 * T::KT);
  int* qbase = qreg + T::QT;
  int* kreg = qbase + T::QT;       // two buffers
  int* kpart = kreg + 2 * T::KT;   // two buffers

  const int tid = threadIdx.x;
  const int qt = static_cast<int>(blockIdx.x % T::NQT);
  const long long wh = blockIdx.x / T::NQT;
  const int head = static_cast<int>(wh % a.heads);
  const Where w = where<T::WQ>(a, wh / a.heads);
  for (int n = tid; n < T::NB; n += T::QTHREADS) bias[n] = a.table[n * a.heads + head] * kLog2e;
  for (int t = tid; t < T::QT; t += T::QTHREADS) query_token<T>(a, w, qt, t, qtok, qreg, qbase);
  __syncthreads();
  const int c = a.heads * T::D, sh = head_shift<T::D>(head);
  stage_tokens<T>(a.qkv, 3LL * c, head * T::D, qtok, T::QT, q, T::QTHREADS);
  copies_done();
  zero_outside<T>(q, T::QT, sh, T::QTHREADS);

  const int lane_id = tid & 31, cg = lane_id & 7, c0 = cg * T::OC;
  const int row0 = (tid >> 5) * 16 + (lane_id >> 3) * 4;
  const float scale2 = a.scale * kLog2e;
  float m[4], l[4], o[4][T::OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < T::OC; ++e) o[i][e] = 0.0f;
  }
  walk_key_tiles<T>(a, w, c, head, sh, kv, ktok, kreg, kpart,
                    [&](const float* k, const float* v, const int* kreg, const int* kpart) {
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + i;
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < T::TC; ++j) {
        const int col = cg + 8 * j;
        s[i][j] = tiled_logit<T>(s[i][j], scale2, bias, qbase[r], qreg[r], kpart[col], kreg[col]);
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int x = 1; x < 8; x <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, x));
      const float mnew = fmaxf(m[i], mt), alpha = exp2f(m[i] - mnew);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < T::TC; ++j) {
        s[i][j] = exp2f(s[i][j] - mnew);
        sum += s[i][j];
      }
      l[i] = fmaf(l[i], alpha, row_sum(sum));
      m[i] = mnew;
#pragma unroll
      for (int e = 0; e < T::OC; ++e) o[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < T::TC; ++j) {
      *reinterpret_cast<float4*>(pt + (cg + 8 * j) * T::SQ + row0) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncwarp();  // a row group reads only the P^T its own lanes wrote
#pragma unroll 4
    for (int j = 0; j < T::KT; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pt + j * T::SQ + row0);
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
  });
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    store_cols<T::D, T::OC>(a.out + qtok[row0 + i] * c + head * T::D, c0, sh, o[i], 1.0f / l[i]);
    lse[i] = m[i] + log2f(l[i]);
  }
  if (cg == 0) {
    *reinterpret_cast<float4*>(a.lse + wh * T::NQ + qt * T::QT + row0) =
        make_float4(lse[0], lse[1], lse[2], lse[3]);
  }
}

template <class T>
__global__ void __launch_bounds__(T::QTHREADS) tiled_attention_dq_kernel(const TArgs a) {
  extern __shared__ float4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  float* g = q + T::QT * T::PITCH;        // dO
  float* kv = g + T::QT * T::PITCH;       // two buffers of a key tile's k then v
  float* dl = kv + 4 * T::KT * T::PITCH;  // dL, row-major; first the output, staged
  float* bias = dl + T::QT * T::SK;
  long long* qtok = reinterpret_cast<long long*>(bias + T::NBP);
  long long* ktok = qtok + T::QT;  // two buffers
  int* qreg = reinterpret_cast<int*>(ktok + 2 * T::KT);
  int* qbase = qreg + T::QT;
  int* kreg = qbase + T::QT;       // two buffers
  int* kpart = kreg + 2 * T::KT;   // two buffers

  const int tid = threadIdx.x;
  const int qt = static_cast<int>(blockIdx.x % T::NQT);
  const long long wh = blockIdx.x / T::NQT;
  const int head = static_cast<int>(wh % a.heads);
  const Where w = where<T::WQ>(a, wh / a.heads);
  for (int n = tid; n < T::NB; n += T::QTHREADS) bias[n] = a.table[n * a.heads + head] * kLog2e;
  for (int t = tid; t < T::QT; t += T::QTHREADS) query_token<T>(a, w, qt, t, qtok, qreg, qbase);
  __syncthreads();
  const int c = a.heads * T::D, sh = head_shift<T::D>(head);
  stage_tokens<T>(a.qkv, 3LL * c, head * T::D, qtok, T::QT, q, T::QTHREADS);
  stage_tokens<T>(a.dout, c, head * T::D, qtok, T::QT, g, T::QTHREADS);
  stage_tokens<T>(a.out_r, c, head * T::D, qtok, T::QT, dl, T::QTHREADS);
  copies_done();
  zero_outside<T>(q, T::QT, sh, T::QTHREADS);
  zero_outside<T>(g, T::QT, sh, T::QTHREADS);
  zero_outside<T>(dl, T::QT, sh, T::QTHREADS);
  __syncthreads();

  const int lane_id = tid & 31, cg = lane_id & 7, c0 = cg * T::OC;
  const int row0 = (tid >> 5) * 16 + (lane_id >> 3) * 4;
  const long long at = wh * T::NQ + qt * T::QT + row0;
  float delta[4], lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float gv[T::OC], ov[T::OC];
    load_cols<T::OC>(g + (row0 + i) * T::PITCH + c0, gv);
    load_cols<T::OC>(dl + (row0 + i) * T::PITCH + c0, ov);
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < T::OC; ++e) acc = fmaf(gv[e], ov[e], acc);
    delta[i] = row_sum(acc);  // rowsum(dO o O) = rowsum(P o dP)
    lse[i] = a.lse_r[at + i];
  }
  if (cg == 0) {
    *reinterpret_cast<float4*>(a.delta + at) = make_float4(delta[0], delta[1], delta[2], delta[3]);
  }
  const float scale2 = a.scale * kLog2e;
  float dq[4][T::OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < T::OC; ++e) dq[i][e] = 0.0f;
  walk_key_tiles<T>(a, w, c, head, sh, kv, ktok, kreg, kpart,
                    [&](const float* k, const float* v, const int* kreg, const int* kpart) {
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + i;
#pragma unroll
      for (int j = 0; j < T::TC; ++j) {
        const int col = cg + 8 * j;
        const float p = exp2f(tiled_logit<T>(s[i][j], scale2, bias, qbase[r], qreg[r], kpart[col],
                                             kreg[col]) - lse[i]);
        dl[r * T::SK + col] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncwarp();  // a row group reads only the dL its own lanes wrote
#pragma unroll 2
    for (int jc = 0; jc < T::KT; jc += 4) {
      float4 l4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        l4[i] = *reinterpret_cast<const float4*>(dl + (row0 + i) * T::SK + jc);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kb[T::OC];
        load_cols<T::OC>(k + (jc + jj) * T::PITCH + c0, kb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < T::OC; ++e) dq[i][e] = fmaf(lane(l4[i], jj), kb[e], dq[i][e]);
      }
    }
  });
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    store_cols<T::D, T::OC>(a.dqkv + qtok[row0 + i] * (3LL * c) + head * T::D, c0, sh, dq[i],
                            a.scale);
  }
}

template <class T>
__global__ void __launch_bounds__(T::KTHREADS) tiled_attention_dkv_kernel(const TArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int QG = T::QT * T::PITCH;
  float* k = reinterpret_cast<float*>(smem4);
  float* v = k + T::KT * T::PITCH;
  float* qg = v + T::KT * T::PITCH;  // two buffers of a query tile's q then dO
  float* pt = qg + 4 * QG;           // P^T, pt[j SQ + i]
  float* dlt = pt + T::KT * T::SQ;   // dL^T
  float* bias = dlt + T::KT * T::SQ;
  float* bins = bias + T::NBP;       // the block's sums by key-minus-query offset
  float* lses = bins + T::NBP;       // two buffers
  float* deltas = lses + 2 * T::QT;  // two buffers
  long long* ktok = reinterpret_cast<long long*>(deltas + 2 * T::QT);
  long long* qtoks = ktok + T::KT;   // two buffers
  int* kreg = reinterpret_cast<int*>(qtoks + 2 * T::QT);
  int* kpart = kreg + T::KT;
  int* qregs = kpart + T::KT;        // two buffers
  int* qbases = qregs + 2 * T::QT;   // two buffers

  const int tid = threadIdx.x;
  const int kt = static_cast<int>(blockIdx.x % T::NKT);
  const long long wh = blockIdx.x / T::NKT;
  const int head = static_cast<int>(wh % a.heads);
  const long long window = wh / a.heads;
  const Where w = where<T::WQ>(a, window);
  for (int n = tid; n < T::NB; n += T::KTHREADS) {
    bias[n] = a.table[n * a.heads + head] * kLog2e;
    bins[n] = 0.0f;
  }
  for (int t = tid; t < T::KT; t += T::KTHREADS) key_token<T>(a, w, kt, t, ktok, kreg, kpart);
  __syncthreads();
  const int c = a.heads * T::D, sh = head_shift<T::D>(head);
  stage_tokens<T>(a.qkv, 3LL * c, c + head * T::D, ktok, T::KT, k, T::KTHREADS);
  stage_tokens<T>(a.qkv, 3LL * c, 2 * c + head * T::D, ktok, T::KT, v, T::KTHREADS);
  copies_done();
  zero_outside<T>(k, T::KT, sh, T::KTHREADS);
  zero_outside<T>(v, T::KT, sh, T::KTHREADS);

  const int lane_id = tid & 31, cg = lane_id & 7, c0 = cg * T::OC;
  const int row0 = (tid >> 5) * 16 + (lane_id >> 3) * 4;  // 4 key rows
  const float scale2 = a.scale * kLog2e;
  float dk[4][T::OC], dv[4][T::OC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < T::OC; ++e) dk[j][e] = dv[j][e] = 0.0f;
  const int kr_lo = kt * T::KR, kr_hi = min(kr_lo + T::KR, T::WK);
  // the query tiles, walked with the next tile's tokens, statistics and
  // copies in flight while this one computes (two buffers of each)
  auto locate_and_copy = [&](int qt, int buf) {
    const long long at = wh * T::NQ + qt * T::QT;
    long long* tok = qtoks + buf * T::QT;
    for (int t = tid; t < T::QT; t += T::KTHREADS) {
      query_token<T>(a, w, qt, t, tok, qregs + buf * T::QT, qbases + buf * T::QT);
      lses[buf * T::QT + t] = a.lse_r[at + t];
      deltas[buf * T::QT + t] = a.delta_r[at + t];
    }
    __syncthreads();
    stage_tokens<T>(a.qkv, 3LL * c, head * T::D, tok, T::QT, qg + 2 * buf * QG, T::KTHREADS);
    stage_tokens<T>(a.dout, c, head * T::D, tok, T::QT, qg + (2 * buf + 1) * QG, T::KTHREADS);
    copies_issued();
  };
  locate_and_copy(0, 0);
  for (int qt = 0; qt < T::NQT; ++qt) {
    const int cur = qt & 1;
    if (qt + 1 < T::NQT) {
      // the last tile's q, dO, tokens and statistics of buffer cur ^ 1 are read
      locate_and_copy(qt + 1, cur ^ 1);
      copies_but_last_done();
    } else {
      copies_done();
    }
    const float* q = qg + 2 * cur * QG;
    const float* g = q + QG;
    const int* qreg = qregs + cur * T::QT;
    const int* qbase = qbases + cur * T::QT;
    const float* lse = lses + cur * T::QT;
    const float* delta = deltas + cur * T::QT;
    zero_outside<T>(qg + 2 * cur * QG, T::QT, sh, T::KTHREADS);
    zero_outside<T>(qg + (2 * cur + 1) * QG, T::QT, sh, T::KTHREADS);
    __syncthreads();

    float s[4][T::QC], dp[4][T::QC];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < T::QC; ++i) s[j][i] = dp[j][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < T::DP; kk += 4) {
      float4 ka[4], va[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = *reinterpret_cast<const float4*>(k + (row0 + j) * T::PITCH + kk);
        va[j] = *reinterpret_cast<const float4*>(v + (row0 + j) * T::PITCH + kk);
      }
#pragma unroll
      for (int i = 0; i < T::QC; ++i) {
        const float4 qb = *reinterpret_cast<const float4*>(q + (cg + 8 * i) * T::PITCH + kk);
        const float4 gb = *reinterpret_cast<const float4*>(g + (cg + 8 * i) * T::PITCH + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j][i] = dot4(ka[j], qb, s[j][i]);
          dp[j][i] = dot4(va[j], gb, dp[j][i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + j;
#pragma unroll
      for (int i = 0; i < T::QC; ++i) {
        const int col = cg + 8 * i;
        const float p = exp2f(tiled_logit<T>(s[j][i], scale2, bias, qbase[col], qreg[col],
                                             kpart[r], kreg[r]) - lse[col]);
        pt[r * T::SQ + col] = p;
        dlt[r * T::SQ + col] = p * (dp[j][i] - delta[col]);
      }
    }
    __syncwarp();  // a row group reads only the rows its own lanes wrote
#pragma unroll 2
    for (int ic = 0; ic < T::QT; ic += 4) {
      float4 p4[4], l4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p4[j] = *reinterpret_cast<const float4*>(pt + (row0 + j) * T::SQ + ic);
        l4[j] = *reinterpret_cast<const float4*>(dlt + (row0 + j) * T::SQ + ic);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        float gv[T::OC], qv[T::OC];
        load_cols<T::OC>(g + (ic + ii) * T::PITCH + c0, gv);
        load_cols<T::OC>(q + (ic + ii) * T::PITCH + c0, qv);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < T::OC; ++e) {
            dv[j][e] = fmaf(lane(p4[j], ii), gv[e], dv[j][e]);
            dk[j][e] = fmaf(lane(l4[j], ii), qv[e], dk[j][e]);
          }
      }
    }
    __syncthreads();  // every row of dL^T is written
    // dL folded into the bins of this pair of tiles' offsets dr = kr - qr,
    // dc = kc - qc; each bin a thread's, its pairs added in a fixed order
    const int qr_lo = qt * T::QR, qr_hi = qr_lo + T::QR;
    const int dr_lo = kr_lo - (qr_hi - 1), ndr = kr_hi - 1 - qr_lo - dr_lo + 1;
    for (int sl = tid; sl < ndr * T::L; sl += T::KTHREADS) {
      const int dr = dr_lo + sl / T::L, dc = sl % T::L - (T::WQ - 1);
      const int qc_lo = max(0, -dc), qc_hi = min(T::WQ, T::WK - dc);
      float acc = 0.0f;
      for (int qr = max(qr_lo, kr_lo - dr); qr < min(qr_hi, kr_hi - dr); ++qr) {
        const float* d0 = dlt + ((qr + dr - kr_lo) * T::WK + dc) * T::SQ + (qr - qr_lo) * T::WQ;
        for (int qc = qc_lo; qc < qc_hi; ++qc) acc += d0[qc * (T::SQ + 1)];
      }
      bins[(dr + T::WQ - 1) * T::L + dc + T::WQ - 1] += acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = row0 + j;
    if (kreg[r] < 0) continue;
    float* dst;
    long long stride_off;
    if (T::OVERLAP) {
      dst = a.kvpart + (window * T::NK + kt * T::KT + r) * (2LL * c);
      stride_off = c;
    } else {
      dst = a.dqkv + ktok[r] * (3LL * c) + c;
      stride_off = c;
    }
    store_cols<T::D, T::OC>(dst + head * T::D, c0, sh, dk[j], a.scale);
    store_cols<T::D, T::OC>(dst + stride_off + head * T::D, c0, sh, dv[j], 1.0f);
  }
  float* part = a.partial + (window * T::NKT + kt) * (static_cast<long long>(T::NB) * a.heads);
  for (int sl = tid; sl < T::NB; sl += T::KTHREADS) {
    const int dr = sl / T::L - (T::WQ - 1), dc = sl % T::L - (T::WQ - 1);
    part[offset_bin<T>(dr, dc) * a.heads + head] = bins[sl];
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

template <int WQ_, int WK_, int D_, int KR_>
struct Shape {
  using T = Tiled<WQ_, WK_, D_, KR_>;
};

// f(Shape<...>{}) for the instantiated (window, key window, head size), or
// `none`.
template <class F>
int tiled_dispatch(int window, int key_window, int head_dim, int none, F f) {
  if (window == 16 && key_window == 16 && head_dim == 30) return f(Shape<16, 16, 30, 4>{});
  if (window == 16 && key_window == 24 && head_dim == 30) return f(Shape<16, 24, 30, 2>{});
  if (window == 4 && key_window == 6 && head_dim == 6) return f(Shape<4, 6, 6, 8>{});
  if (window == 8 && key_window == 8 && head_dim == 30) return f(Shape<8, 8, 30, 8>{});
  return none;
}

constexpr int kRefused = static_cast<int>(cudaErrorInvalidValue);

// The query windows of a map, or 0 for a geometry no tiled kernel takes.
long long tiled_windows(int batch, int hp, int wp, int heads, int window, int key_window,
                        int shift) {
  if (batch < 1 || heads < 1 || heads % 2 || window < 1 || hp < window || wp < window ||
      hp % window || wp % window || shift < 0 || shift >= window ||
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
                           windows * heads * T::NQT, T::QTHREADS, a, devices, s);
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
                              T::QTHREADS, a, dq_devices, s);
    if (err != 0) return err;
    err = launch_tiled<T>(tiled_attention_dkv_kernel<T>, T::kDkvSmem, windows * heads * T::NKT,
                          T::KTHREADS, a, dkv_devices, s);
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
