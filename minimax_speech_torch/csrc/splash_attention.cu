// K2: differentiable chunk-causal attention with segment padding, for Hopper.
//
// Replaces the Pallas TPU splash kernel that
// minimax_speech_tpu/kernels/splash.py:92 (splash_chunk_attention, and
// splash_causal_attention at :138, which is chunk 1 with no left bound)
// configures: forward and backward of out = softmax(Q K^T) V over
// (B, H, T, D), D = 64, where Q arrives with the 1/sqrt(d) scale already
// folded in (the wrapper does that, in Q's dtype, as JAX does). Query q of
// sample b sees key k iff
//   k <  min((q / chunk + 1) * chunk, T)            (chunk > 0)
//   k >= (q / chunk - left_chunks) * chunk          (chunk > 0, left >= 0)
//   (q < kv_len[b]) == (k < kv_len[b])              (segments: pads see pads)
// which is one interval [lo(q), hi(q)) per row: a valid row sees
// [lo, min(hi, len)), a pad row [max(lo, len), hi). Every row sees itself.
//
// Three kernels, FA2's split, deterministic and without atomics:
//   splash_fwd   one block per (b*h, 64-row query tile): online softmax in
//                fp32 over the key tiles the tile's rows can reach; writes
//                O (input dtype) and the fp32 logsumexp L (B, H, T).
//   splash_dkdv  one block per (b*h, 64-key tile): loops over the query
//                tiles whose intervals reach the key tile, recomputes
//                P = exp(S - L), accumulates dV += P^T dO and
//                dK += dS^T Q with dS = P * (dO V^T - Delta).
//   splash_dq    one block per (b*h, query tile): dQ += dS K over the
//                visible key tiles.
// Delta = rowsum(dO * O) comes from the wrapper (PyTorch), as JAX's splash
// backward computes it with an einsum outside its Pallas kernels.
//
// What bounds it on an H100: at the LM training shape (B=8, H=14, T=512,
// D=64, causal, ragged lengths) the forward reads 3 and writes 1 tensor of
// 3.7M values (59 MB in fp32, 18 us at 3.35 TB/s) and does 4*D FLOP for each
// of ~9.1M visible (q, k) pairs, 2.3 GFLOP (35 us on the 67 TFLOP/s fp32
// pipes); the backward does 2.5x that. The arithmetic bounds it.
//
// Design (right and simple first; tensor cores come later): 256 threads,
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4) of every 64x64 product, so each shared-memory load
// feeds four FMAs. Tiles live in shared memory as fp32 with a row stride of
// 65 floats so the 16 column-threads of a half-warp hit 16 banks. A block
// visits only the tiles that the union of its rows' intervals reaches
// (block sparsity), and masks boundary tiles element by element with each
// row's interval. Rows and keys >= T are zero-filled and never visible, so
// any T works. Scores and products run on the fp32 pipes.

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;           // head dim
constexpr int kTile = 64;        // rows of a query or key tile
constexpr int kStride = kD + 1;  // shared-memory row stride in floats
constexpr int kTileFloats = kTile * kStride;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Mask {
  int seq, len, chunk, left;
};

// keys row q sees: [lo, hi); empty for rows outside the sequence
__device__ __forceinline__ void row_span(const Mask& m, int q, int& lo,
                                         int& hi) {
  if (q >= m.seq) {
    lo = 0;
    hi = 0;
    return;
  }
  int l = 0, h = m.seq;
  if (m.chunk > 0) {
    h = min((q / m.chunk + 1) * m.chunk, m.seq);
    if (m.left >= 0) l = max(0, (q / m.chunk - m.left) * m.chunk);
  }
  if (q < m.len) {
    h = min(h, m.len);
  } else {
    l = max(l, m.len);
  }
  lo = l;
  hi = h;
}

// queries that can see some key in [k_first, k_last]: [lo, hi)
__device__ __forceinline__ void col_span(const Mask& m, int k_first,
                                         int k_last, int& lo, int& hi) {
  int l = 0, h = m.seq;
  if (m.chunk > 0) {
    l = (k_first / m.chunk) * m.chunk;
    if (m.left >= 0) h = min(m.seq, (k_last / m.chunk + m.left + 1) * m.chunk);
  }
  if (k_first >= m.len) l = max(l, m.len);
  if (k_last < m.len) h = min(h, m.len);
  lo = l;
  hi = h;
}

// key tiles a query tile [q0, q0 + 64) can reach: [lo, hi)
__device__ __forceinline__ void tile_keys(const Mask& m, int q0, int& lo,
                                          int& hi) {
  int unused;
  row_span(m, q0, lo, unused);
  row_span(m, min(q0 + kTile, m.seq) - 1, unused, hi);
}

// 64 rows of a (seq, 64) matrix from row0 into shared memory as fp32
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int seq) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD;
    const int c = i % kD;
    const int g = row0 + r;
    dst[r * kStride + c] =
        g < seq ? load_f(src + static_cast<size_t>(g) * kD + c) : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[i][j] += sum_d a[(ty + 16 i) * kStride + d] * b[(tx + 16 j) * kStride + d]
__device__ __forceinline__ void mma_abt(float (&acc)[4][4], const float* a,
                                        const float* b, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * kStride + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * kStride + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
  }
}

// acc[i][j] += sum_r a[(ty + 16 i) * kStride + r] * b[r * kStride + tx + 16 j]
__device__ __forceinline__ void mma_ab(float (&acc)[4][4], const float* a,
                                       const float* b, int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * kStride + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[r * kStride + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
  }
}

// acc[i][j] += sum_r a[r * kStride + ty + 16 i] * b[r * kStride + tx + 16 j]
__device__ __forceinline__ void mma_atb(float (&acc)[4][4], const float* a,
                                        const float* b, int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[r * kStride + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[r * kStride + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ Mask make_mask(const int* kv_len, int b, int seq,
                                          int chunk, int left) {
  return Mask{seq, max(0, min(kv_len[b], seq)), chunk, left};
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
splash_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ kv_len,
           T* __restrict__ out, float* __restrict__ lse, int heads, int seq,
           int chunk, int left) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTileFloats;
  float* vs = ks + kTileFloats;
  float* ps = vs + kTileFloats;

  const int bh = blockIdx.y;
  const Mask m = make_mask(kv_len, bh / heads, seq, chunk, left);
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * seq * kD;

  int lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row_span(m, q0 + ty + 16 * i, lo[i], hi[i]);
  int k_lo, k_hi;
  tile_keys(m, q0, k_lo, k_hi);

  load_tile(qs, q + base, q0, seq);
  float row_max[4], row_sum[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_max[i] = kNegInf;
    row_sum[i] = 0.f;
  }
  zero(acc);

  for (int k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile(ks, k + base, k0, seq);
    load_tile(vs, v + base, k0, seq);
    __syncthreads();
    float s[4][4];
    zero(s);
    mma_abt(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= lo[i] && kj < hi[i]) tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float new_max = fmaxf(row_max[i], half_warp_max(tile_max));
      const float alpha = expf(row_max[i] - new_max);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float p = (kj >= lo[i] && kj < hi[i]) ? expf(s[i][j] - new_max)
                                                    : 0.f;
        ps[(ty + 16 * i) * kStride + tx + 16 * j] = p;
        p_sum += p;
      }
      row_sum[i] = row_sum[i] * alpha + half_warp_sum(p_sum);
      row_max[i] = new_max;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mma_ab(acc, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= seq) continue;
    const float inv = 1.f / fmaxf(row_sum[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_f(out + base + static_cast<size_t>(qi) * kD + tx + 16 * j,
              acc[i][j] * inv);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * seq + qi] =
          row_max[i] + logf(fmaxf(row_sum[i], 1e-30f));
  }
}

// P and dS of the tile pair (q0, k0) for the thread's 4x4 elements
// (rows q0 + ty + 16 i, keys k0 + tx + 16 j), from S = Q K^T and
// dP = dO V^T; lse and delta are the rows' logsumexp and rowsum(dO * O)
__device__ __forceinline__ void probs_and_dscores(
    float (&s)[4][4], float (&dp)[4][4], const Mask& m, int q0, int k0,
    const float (&row_lse)[4], const float (&row_delta)[4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int lo, hi;
    row_span(m, q0 + ty + 16 * i, lo, hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      const float p = (kj >= lo && kj < hi) ? expf(s[i][j] - row_lse[i]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - row_delta[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
splash_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ kv_len,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk,
            T* __restrict__ dv, int heads, int seq, int chunk, int left) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTileFloats;
  float* qs = vs + kTileFloats;
  float* dos = qs + kTileFloats;
  float* ps = dos + kTileFloats;
  float* dss = ps + kTileFloats;
  float* lse_s = dss + kTileFloats;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const Mask m = make_mask(kv_len, bh / heads, seq, chunk, left);
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * seq * kD;
  const size_t row_base = static_cast<size_t>(bh) * seq;

  int q_lo, q_hi;
  col_span(m, k0, min(k0 + kTile, seq) - 1, q_lo, q_hi);

  load_tile(ks, k + base, k0, seq);
  load_tile(vs, v + base, k0, seq);
  float acc_dk[4][4], acc_dv[4][4];
  zero(acc_dk);
  zero(acc_dv);

  for (int q0 = (q_lo / kTile) * kTile; q0 < q_hi; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    load_tile(qs, q + base, q0, seq);
    load_tile(dos, dout + base, q0, seq);
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < seq ? lse[row_base + qi] : 0.f;
      delta_s[threadIdx.x] = qi < seq ? delta[row_base + qi] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4], row_lse[4], row_delta[4];
    zero(s);
    zero(dp);
    mma_abt(s, qs, ks, ty, tx);
    mma_abt(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      row_lse[i] = lse_s[ty + 16 * i];
      row_delta[i] = delta_s[ty + 16 * i];
    }
    probs_and_dscores(s, dp, m, q0, k0, row_lse, row_delta, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * kStride + tx + 16 * j] = s[i][j];
        dss[(ty + 16 * i) * kStride + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    // this thread's key rows are now k0 + ty + 16 i
    mma_atb(acc_dv, ps, dos, ty, tx);
    mma_atb(acc_dk, dss, qs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= seq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t off = base + static_cast<size_t>(kr) * kD + tx + 16 * j;
      store_f(dk + off, acc_dk[i][j]);
      store_f(dv + off, acc_dv[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
splash_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ kv_len,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int heads,
          int seq, int chunk, int left) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTileFloats;
  float* ks = dos + kTileFloats;
  float* vs = ks + kTileFloats;
  float* dss = vs + kTileFloats;

  const int bh = blockIdx.y;
  const Mask m = make_mask(kv_len, bh / heads, seq, chunk, left);
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * seq * kD;
  const size_t row_base = static_cast<size_t>(bh) * seq;

  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    row_lse[i] = qi < seq ? lse[row_base + qi] : 0.f;
    row_delta[i] = qi < seq ? delta[row_base + qi] : 0.f;
  }
  int k_lo, k_hi;
  tile_keys(m, q0, k_lo, k_hi);

  load_tile(qs, q + base, q0, seq);
  load_tile(dos, dout + base, q0, seq);
  float acc[4][4];
  zero(acc);

  for (int k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    load_tile(ks, k + base, k0, seq);
    load_tile(vs, v + base, k0, seq);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mma_abt(s, qs, ks, ty, tx);
    mma_abt(dp, dos, vs, ty, tx);
    probs_and_dscores(s, dp, m, q0, k0, row_lse, row_delta, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kStride + tx + 16 * j] = dp[i][j];
    __syncthreads();
    mma_ab(acc, dss, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= seq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_f(dq + base + static_cast<size_t>(qi) * kD + tx + 16 * j,
              acc[i][j]);
  }
}

constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kDkdvSmem = (6 * kTileFloats + 2 * kTile) * sizeof(float);
constexpr size_t kDqSmem = 5 * kTileFloats * sizeof(float);

bool bad_args(int batch, int heads, int seq, int head_dim, int dtype) {
  return head_dim != kD || seq <= 0 || batch <= 0 || heads <= 0 ||
         (dtype != 0 && dtype != 1);
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const int* kv_len,
                void* out, float* lse, int batch, int heads, int seq,
                int chunk, int left, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      splash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  splash_fwd<T><<<grid, kThreads, kFwdSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), lse, heads, seq,
      chunk, left);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const int* kv_len,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int batch, int heads, int seq,
                int chunk, int left, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      splash_dkdv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      splash_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  splash_dkdv<T><<<grid, kThreads, kDkdvSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<const T*>(dout), lse,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), heads, seq, chunk,
      left);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  splash_dq<T><<<grid, kThreads, kDqSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<const T*>(dout), lse,
      delta, static_cast<T*>(dq), heads, seq, chunk, left);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous on the device. q, k, v, out, dout, dq, dk, dv:
// (batch, heads, seq, head_dim) in dtype (0 = float32, 1 = bfloat16), q
// already scaled; lse, delta: float32 (batch, heads, seq); kv_len: int32
// (batch,). chunk 0 means no chunk predicate (full); left_chunks < 0 no
// left bound. Each launches on `stream` and returns cudaGetLastError()
// (0 when every launch was taken).
extern "C" int mmst_splash_fwd(const void* q, const void* k, const void* v,
                               const int* kv_len, void* out, float* lse,
                               int batch, int heads, int seq, int head_dim,
                               int chunk, int left_chunks, int dtype,
                               void* stream) {
  if (bad_args(batch, heads, seq, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? fwd<__nv_bfloat16>(q, k, v, kv_len, out, lse, batch, heads,
                                      seq, chunk, left_chunks, s)
                 : fwd<float>(q, k, v, kv_len, out, lse, batch, heads, seq,
                              chunk, left_chunks, s);
  return static_cast<int>(err);
}

extern "C" int mmst_splash_bwd(const void* q, const void* k, const void* v,
                               const int* kv_len, const void* dout,
                               const float* lse, const float* delta, void* dq,
                               void* dk, void* dv, int batch, int heads,
                               int seq, int head_dim, int chunk,
                               int left_chunks, int dtype, void* stream) {
  if (bad_args(batch, heads, seq, head_dim, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1
          ? bwd<__nv_bfloat16>(q, k, v, kv_len, dout, lse, delta, dq, dk, dv,
                               batch, heads, seq, chunk, left_chunks, s)
          : bwd<float>(q, k, v, kv_len, dout, lse, delta, dq, dk, dv, batch,
                       heads, seq, chunk, left_chunks, s);
  return static_cast<int>(err);
}
