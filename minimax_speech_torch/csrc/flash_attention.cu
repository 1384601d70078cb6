// K1: forward attention with pad, causal and chunk-causal masks, for Hopper.
//
// Replaces the Pallas TPU kernel minimax_speech_tpu/kernels/flash_attention.py
// (flash_attention, body _attn_kernel): out = softmax(Q K^T / sqrt(d)) V over
// (B, H, T, D) with an fp32 online softmax. Query q sees key k iff
//   k < kv_len[b]                                  (pad)
//   k <= q                                         (causal)
//   k < (q / chunk + 1) * chunk                    (chunk > 0)
//   k >= (q / chunk - left_chunks) * chunk         (chunk > 0, left_chunks >= 0)
// which is one interval [lo(q), hi(q)) of keys per query row (K1Mask below).
//
// What bounds it on an H100: at the flow UNet's shape (B=2, H=8, T=506,
// D=64, kv_len=400) one call reads 3 x 2 x 8 x 506 x 64 fp32 values and
// writes one such tensor (8.3 MB, 2.5 us at 3.35 TB/s) and does
// 4 x 2 x 8 x 506 x 400 x 64 = 0.83 GFLOP. At fp32 accuracy on the tensor
// cores (3 TF32 products per fp32 product, 494.7 TFLOP/s dense) that is
// 5.0 us, so the arithmetic bounds it: 0.0050 ms. Measured, the issue
// rate of mma.sync's TF32 products limits it (kernels/variants.py,
// PERF.md); wgmma is the next step.
//
// Design: the products run on the tensor cores (mma.sync m16n8k8, TF32 in
// 3xTF32 for fp32 accuracy) and K and V tiles stream in by cp.async,
// double-buffered; the shared code is attention_mma.cuh (its note says
// how fragments, splits and shared-memory layout work). The UNet's shape
// has only 16 (b, h) x 8 query tiles, so each block of 8 warps splits its
// tile's key range in two: 4 warps (16 query rows each) take the even key
// tiles, 4 the odd ones, and their (m, l, O) are combined at the end, which
// gives each SM 8 warps. A block visits only the key tiles its rows' intervals
// reach, a warp computes only those its own rows reach, and boundary tiles
// are masked per element on the fragments. Any T works: rows and keys past
// T are zero-filled and never visible. bf16 inputs stay bf16 in shared
// memory and are converted at the fragment load; the output is written in
// the input's type.
//
// It replaces the first design (two threads per query row, 64 rows per
// 4-warp block, every FMA on the fp32 pipes reading shared memory, 231
// registers a thread): 0.2327 ms against SDPA's 0.1048 ms at the shape above
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 3, PERF.md).

#include <cmath>

#include "attention_mma.cuh"

namespace {

using attn::kD;
using attn::kGroupThreads;
using attn::kTile;
using attn::Tile;

constexpr int kSplit = 2;  // key groups per block
constexpr int kThreads = kSplit * kGroupThreads;

// K1's rule: the keys row q sees are [lo, hi)
struct K1Mask {
  int len, chunk, left, causal;
  __device__ __forceinline__ void row_span(int q, int& lo, int& hi) const {
    lo = 0;
    hi = len;
    if (causal) hi = min(hi, q + 1);
    if (chunk > 0) {
      hi = min(hi, (q / chunk + 1) * chunk);
      if (left >= 0) lo = max(0, (q / chunk - left) * chunk);
    }
  }
};

template <typename T>
constexpr size_t smem_bytes() {
  return attn::forward_tiles(kSplit) * Tile<T>::kElems * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const int* __restrict__ kv_len,
         T* __restrict__ out, int heads, int seq, int chunk, int left_chunks,
         int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.y;
  const size_t base = static_cast<size_t>(bh) * seq * kD;
  const K1Mask mask{max(0, min(kv_len[bh / heads], seq)), chunk, left_chunks,
                    causal};
  attn::attention_forward<T, kSplit, false>(
      q + base, k + base, v + base, out + base, nullptr, mask, seq,
      blockIdx.x * kTile, scale, reinterpret_cast<T*>(smem));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, void* out, int batch, int heads, int seq,
                   int chunk, int left_chunks, int causal, float scale,
                   cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      attn_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  attn_fwd<T><<<grid, kThreads, smem_bytes<T>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), heads, seq,
      chunk, left_chunks, causal, scale);
  return cudaGetLastError();
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
  const float scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(q, k, v, kv_len, out, batch, heads,
                                         seq, chunk, left_chunks, causal,
                                         scale, s)
                 : launch<float>(q, k, v, kv_len, out, batch, heads, seq,
                                 chunk, left_chunks, causal, scale, s);
  return static_cast<int>(err);
}
