// K1: forward attention with pad, causal and chunk-causal masks, for Hopper.
//
// Replaces the Pallas TPU kernel minimax_speech_tpu/kernels/flash_attention.py
// (flash_attention, body _attn_kernel): out = softmax(Q K^T / sqrt(d)) V over
// (B, H, T, D) with an fp32 online softmax. Query q sees key k iff
//   k < kv_len[b]                                  (pad)
//   k <= q                                         (causal)
//   k < (q / chunk + 1) * chunk                    (chunk > 0)
//   k >= (q / chunk - left_chunks) * chunk         (chunk > 0, left_chunks >= 0)
// which is one interval [lo(q), hi(q)) of keys per query row.
//
// What bounds it on an H100: at the flow UNet's shape (B=2, H=8, T=506,
// D=64, kv_len=400) one call reads 3 x 2 x 8 x 506 x 64 fp32 values and
// writes one such tensor (8.3 MB, about 2.5 us at 3.35 TB/s) and does
// 4 x 2 x 8 x 506 x 400 x 64 = 0.83 GFLOP (about 12 us on the 67 TFLOP/s
// fp32 pipes, 0.8 us on the bf16 tensor cores), so the arithmetic bounds it.
//
// Design (this version is right and simple; tensor cores come later):
//   * one thread block per (b*h, 64-row query tile); two threads per query
//     row, each owning 32 of the 64 dims (interleaved, even/odd, so the two
//     halves of a warp read different shared-memory banks);
//   * the query row stays in registers; K and V tiles of 64 rows are staged
//     through shared memory as fp32 (fp32 and bf16 inputs, fp32 math, the
//     output in the input's type);
//   * the key loop runs only over the tiles the tile's interval can reach
//     ([lo(q_first), hi(q_last))), so masked-out tiles cost nothing, and
//     boundary tiles are masked element by element with the row's interval;
//   * ragged T needs no divisibility rule: rows >= T are not stored and keys
//     >= T are outside every interval.
// No wgmma or TMA yet: the scores and P*V products run on the fp32 pipes.

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;                  // head dim this kernel takes
constexpr int kBlockQ = 64;             // query rows per block
constexpr int kBlockK = 64;             // key rows per shared-memory tile
constexpr int kThreads = 2 * kBlockQ;   // two threads per query row
constexpr int kHalf = kD / 2;           // dims owned by one thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const int* __restrict__ kv_len,
         T* __restrict__ out, int heads, int seq, int chunk, int left_chunks,
         int causal, float scale) {
  __shared__ float ks[kBlockK][kD];
  __shared__ float vs[kBlockK][kD];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int q_first = blockIdx.x * kBlockQ;
  const int q_last = min(q_first + kBlockQ, seq) - 1;
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;  // this thread owns dims 2*i + half
  const int qi = q_first + row;
  const bool row_ok = qi < seq;
  const size_t base = static_cast<size_t>(bh) * seq * kD;

  const int len = min(kv_len[b], seq);
  // keys any row of the tile can see: [tile_lo, tile_hi)
  int tile_lo = 0, tile_hi = len;
  // keys this row can see: [row_lo, row_hi)
  int row_lo = 0, row_hi = len;
  if (causal) {
    tile_hi = min(tile_hi, q_last + 1);
    row_hi = min(row_hi, qi + 1);
  }
  if (chunk > 0) {
    tile_hi = min(tile_hi, (q_last / chunk + 1) * chunk);
    row_hi = min(row_hi, (qi / chunk + 1) * chunk);
    if (left_chunks >= 0) {
      tile_lo = max(0, (q_first / chunk - left_chunks) * chunk);
      row_lo = max(0, (qi / chunk - left_chunks) * chunk);
    }
  }

  float qr[kHalf];
  float acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    qr[i] = row_ok ? load_f(q + base + static_cast<size_t>(qi) * kD + 2 * i + half)
                   : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = (tile_lo / kBlockK) * kBlockK; k0 < tile_hi; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBlockK * kD; i += kThreads) {
      const int r = i / kD;
      const int c = i % kD;
      const int kr = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kr < seq) {
        const size_t off = base + static_cast<size_t>(kr) * kD + c;
        kx = load_f(k + off);
        vx = load_f(v + off);
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) dot += qr[i] * ks[j][2 * i + half];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const int kj = k0 + j;
      s[j] = (kj >= row_lo && kj < row_hi) ? dot * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const int kj = k0 + j;
      const float p = (kj >= row_lo && kj < row_hi) ? expf(s[j] - m_new) : 0.f;
      s[j] = p;
      p_sum += p;
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int i = 0; i < kHalf; ++i) acc[i] += s[j] * vs[j][2 * i + half];
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + base + static_cast<size_t>(qi) * kD + half;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) store_f(o + 2 * i, acc[i] * inv);
  }
}

}  // namespace

// q, k, v, out: contiguous (batch, heads, seq, head_dim); kv_len: int32
// (batch,) on the device; dtype: 0 = float32, 1 = bfloat16. Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was taken).
extern "C" int mmst_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const int* kv_len,
                                        void* out, int batch, int heads,
                                        int seq, int head_dim, int chunk,
                                        int left_chunks, int causal, int dtype,
                                        void* stream) {
  if (head_dim != kD || seq <= 0 || batch <= 0 || heads <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch * heads);
  const float scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    attn_fwd<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), kv_len,
        static_cast<__nv_bfloat16*>(out), heads, seq, chunk, left_chunks,
        causal, scale);
  } else {
    attn_fwd<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), kv_len, static_cast<float*>(out), heads,
        seq, chunk, left_chunks, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
