// K2: differentiable chunk-causal attention with segment padding, for Hopper.
//
// Replaces the Pallas TPU splash kernel that
// minimax_speech_tpu/kernels/splash.py:92 (splash_chunk_attention, and
// splash_causal_attention at :138, which is chunk 1 with no left bound)
// configures: forward and backward of out = softmax(Q K^T) V over
// (B, H, T, D), D one of 8, 16 and 64 (a template parameter: the LM at
// configs/default.yaml's widths takes 64, the tiny LM and UNet of
// configs/tiny.yaml 8, and a 64-wide tiny LM 16), where Q arrives with the 1/sqrt(d) scale already
// folded in (the wrapper does that, in Q's dtype, as JAX does). Query q of
// sample b sees key k iff
//   k <  min((q / chunk + 1) * chunk, T)            (chunk > 0)
//   k >= (q / chunk - left_chunks) * chunk          (chunk > 0, left >= 0)
//   (q < kv_len[b]) == (k < kv_len[b])              (segments: pads see pads)
// which is one interval [lo, hi) of keys per row (row_span): a valid row
// sees [lo, min(hi, len)), a pad row [max(lo, len), hi). Every row sees
// itself. The queries that see a key form one interval too (col_span).
//
// Three kernels, FA2's split, deterministic and without atomics:
//   splash_fwd   one block per (b*h, 64-row query tile): online softmax in
//                fp32 over the key tiles the tile's rows can reach; writes
//                O (input dtype) and the fp32 logsumexp L (B, H, T).
//   splash_dkdv  one block per (b*h, 64-key tile): loops over the query
//                tiles whose intervals reach the key tile, recomputes
//                P^T = exp(K Q^T - L), accumulates dV += P^T dO and
//                dK += dS^T Q with dS^T = P^T * (V dO^T - Delta).
//   splash_dq    one block per (b*h, query tile): dQ += dS K over the
//                visible key tiles.
// Delta = rowsum(dO * O) comes from the wrapper (PyTorch), as JAX's splash
// backward computes it with an einsum outside its Pallas kernels.
//
// What bounds it on an H100: at the LM training shape (B=8, H=14, T=512,
// D=64, causal, ragged lengths, ~9.07M visible (q, k) pairs) the forward
// moves 4 tensors of 3.7M fp32 values (59 MB, 17.5 us at 3.35 TB/s) and
// does 2 products of 2 D FLOP per visible pair, 2.3 GFLOP: at fp32
// accuracy on the tensor cores (3 TF32 products per fp32 product at 494.7
// TFLOP/s) 14.1 us, so the bytes bound the forward (0.0175 ms). Forward
// and backward move 117 MB (35.0 us) and do 7 products per pair, 8.1 GFLOP
// (49.3 us): the arithmetic bounds them (0.0493 ms). Measured, the issue
// rate of mma.sync's TF32 products limits all three kernels
// (kernels/variants.py, PERF.md); wgmma is the next step.
//
// Design: every product runs on the tensor cores (mma.sync m16n8k8, TF32
// in 3xTF32), one warp for each 16 rows of a 4-warp block, with the
// streamed tiles (K and V in splash_fwd and splash_dq, Q, dO, L and Delta
// in splash_dkdv) brought in by cp.async, double-buffered; the shared code
// is attention_mma.cuh (fragments, splits, shared-memory layout; bf16
// stays bf16 in shared memory and is converted at the fragment load).
// splash_fwd is the forward pass K1 runs too, with K2's mask and the
// logsumexp written. In the backward the accumulators of S^T and dP^T
// (dkdv) or S and dP (dq) become the A operands of the next products in
// place. A block visits only the tiles that the union of its rows'
// intervals reaches (block sparsity), a warp computes only those its own
// rows reach, and boundary tiles are masked per element on the fragments.
// Rows and keys >= T are zero-filled and never visible, so any T works.
//
// It replaces the first design (256 threads with 4x4 register tiles on
// the fp32 pipes, 8 shared-memory loads per 16 FMAs): forward 0.2073 ms,
// forward+backward 0.8406 ms at the shape above (NVIDIA H100 80GB HBM3,
// 700 W, chip_smoke.py phase 6, PERF.md).

#include "attention_mma.cuh"

namespace {

using attn::kGroupThreads;
using attn::kTile;
using attn::kWarpRows;
using attn::Tile;

struct Mask {
  int seq, len, chunk, left;

  // keys row q sees: [lo, hi); empty for rows outside the sequence
  __device__ __forceinline__ void row_span(int q, int& lo, int& hi) const {
    if (q >= seq) {
      lo = 0;
      hi = 0;
      return;
    }
    int l = 0, h = seq;
    if (chunk > 0) {
      h = min((q / chunk + 1) * chunk, seq);
      if (left >= 0) l = max(0, (q / chunk - left) * chunk);
    }
    if (q < len) {
      h = min(h, len);
    } else {
      l = max(l, len);
    }
    lo = l;
    hi = h;
  }

  // queries that can see some key in [k_first, k_last]: [lo, hi)
  __device__ __forceinline__ void col_span(int k_first, int k_last, int& lo,
                                           int& hi) const {
    int l = 0, h = seq;
    if (chunk > 0) {
      l = (k_first / chunk) * chunk;
      if (left >= 0) h = min(seq, (k_last / chunk + left + 1) * chunk);
    }
    if (k_first >= len) l = max(l, len);
    if (k_last < len) h = min(h, len);
    lo = l;
    hi = h;
  }
};

__device__ __forceinline__ Mask make_mask(const int* kv_len, int b, int seq,
                                          int chunk, int left) {
  return Mask{seq, max(0, min(kv_len[b], seq)), chunk, left};
}

// the rows [r0, r0 + n) of a tile, clipped to the sequence, reach the
// columns [lo, hi) of the other side (span: row_span or col_span)
template <bool kKeys>
__device__ __forceinline__ void rows_reach(const Mask& m, int r0, int n,
                                           int& lo, int& hi) {
  lo = hi = 0;
  if (r0 >= m.seq) return;
  const int last = min(r0 + n, m.seq) - 1;
  int unused;
  if (kKeys) {
    m.row_span(r0, lo, unused);
    m.row_span(last, unused, hi);
  } else {
    m.col_span(r0, last, lo, hi);
  }
}

// P = exp(S - L) where visible (else 0) and dS = P * (dP - Delta), in place
// of s and dp. kByColumn false: rows are queries, L and Delta per row;
// true: rows are keys, columns queries, L and Delta per column from
// shared memory (col0 is the columns' first index).
template <bool kByColumn>
__device__ __forceinline__ void probs_and_dscores(
    float (&s)[8][4], float (&dp)[8][4], int col0, const int (&lo)[2],
    const int (&hi)[2], const float (&row_lse)[2], const float (&row_delta)[2],
    const float* col_lse, const float* col_delta, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int c = 8 * n + 2 * t + (e & 1);
      const float l = kByColumn ? col_lse[c] : row_lse[i];
      const float d = kByColumn ? col_delta[c] : row_delta[i];
      const float p =
          attn::visible(col0 + c, lo[i], hi[i]) ? expf(s[n][e] - l) : 0.f;
      s[n][e] = p;
      dp[n][e] = p * (dp[n][e] - d);
    }
}

// the warp's 16 rows of a (seq, 8 N) accumulator from r0, clipped to seq
template <int N, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[N][4],
                                           int r0, int seq, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= seq) continue;
    T* p = dst + static_cast<size_t>(row) * (8 * N) + 2 * t;
#pragma unroll
    for (int n = 0; n < N; ++n)
      attn::store_pair(p + 8 * n, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kGroupThreads, 1)
splash_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ kv_len,
           T* __restrict__ out, float* __restrict__ lse, int heads, int seq,
           int chunk, int left) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.y;
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const Mask m = make_mask(kv_len, bh / heads, seq, chunk, left);
  attn::attention_forward<T, D, 1, true>(
      q + base, k + base, v + base, out + base,
      lse + static_cast<size_t>(bh) * seq, m, seq, blockIdx.x * kTile, 1.0f,
      reinterpret_cast<T*>(smem));
}

// The backward kernels, like the forward, say one block per SM at least:
// told only the thread count, ptxas kept splash_dq<bf16, 8> at 96
// registers and spilled 8 bytes.
template <typename T, int D>
__global__ void __launch_bounds__(kGroupThreads, 1)
splash_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ kv_len,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk,
            T* __restrict__ dv, int heads, int seq, int chunk, int left) {
  using Tl = Tile<T, D>;
  constexpr int E = Tl::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* ks = smem;
  T* vs = smem + E;
  T* qd = smem + 2 * E;                                   // [stage][Q, dO]
  float* rows = reinterpret_cast<float*>(smem + 6 * E);   // [stage][L, Delta]

  const int bh = blockIdx.y;
  const Mask m = make_mask(kv_len, bh / heads, seq, chunk, left);
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const size_t row_base = static_cast<size_t>(bh) * seq;

  // queries that see the block's keys, this warp's keys, each row's key
  int q_lo, q_hi, w_lo, w_hi, lo[2], hi[2];
  rows_reach<false>(m, k0, kTile, q_lo, q_hi);
  const int r0 = k0 + warp * kWarpRows;
  rows_reach<false>(m, r0, kWarpRows, w_lo, w_hi);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    rows_reach<false>(m, r0 + g + 8 * i, 1, lo[i], hi[i]);
  const int first = (q_lo / kTile) * kTile;
  const int n_tiles = q_hi > first ? (q_hi - first + kTile - 1) / kTile : 0;

  attn::load_tile<D>(ks, k + base, k0, seq, tid, kGroupThreads);
  attn::load_tile<D>(vs, v + base, k0, seq, tid, kGroupThreads);
  if (n_tiles > 0) {
    attn::load_tile<D>(qd, q + base, first, seq, tid, kGroupThreads);
    attn::load_tile<D>(qd + E, dout + base, first, seq, tid, kGroupThreads);
    attn::load_rows(rows, lse + row_base, first, seq, tid);
    attn::load_rows(rows + kTile, delta + row_base, first, seq, tid);
  }
  attn::cp_async_commit();
  attn::cp_async_wait_all();
  __syncthreads();

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
  attn::zero(acc_dk);
  attn::zero(acc_dv);
  const T* kw = ks + warp * kWarpRows * Tl::kStride;
  const T* vw = vs + warp * kWarpRows * Tl::kStride;
  const float none[2] = {0.f, 0.f};
  int stage = 0;
  for (int i = 0; i < n_tiles; ++i, stage ^= 1) {
    const int q0 = first + i * kTile;
    if (i + 1 < n_tiles) {  // the next query tile streams in meanwhile
      T* nxt = qd + (stage ^ 1) * 2 * E;
      float* nrows = rows + (stage ^ 1) * 2 * kTile;
      attn::load_tile<D>(nxt, q + base, q0 + kTile, seq, tid, kGroupThreads);
      attn::load_tile<D>(nxt + E, dout + base, q0 + kTile, seq, tid,
                         kGroupThreads);
      attn::load_rows(nrows, lse + row_base, q0 + kTile, seq, tid);
      attn::load_rows(nrows + kTile, delta + row_base, q0 + kTile, seq, tid);
    }
    attn::cp_async_commit();
    if (q0 < w_hi && q0 + kTile > w_lo) {
      const T* qs = qd + stage * 2 * E;
      const T* dos = qs + E;
      const float* ls = rows + stage * 2 * kTile;
      float s[8][4], dp[8][4];
      attn::zero(s);
      attn::zero(dp);
      attn::mma_rows<D>(s, kw, qs, g, t);    // S^T = K Q^T
      attn::mma_rows<D>(dp, vw, dos, g, t);  // dP^T = V dO^T
      probs_and_dscores<true>(s, dp, q0, lo, hi, none, none, ls, ls + kTile,
                              t);
      attn::mma_acc(acc_dv, s, dos, g, t);  // dV += P^T dO
      attn::mma_acc(acc_dk, dp, qs, g, t);  // dK += dS^T Q
    }
    attn::cp_async_wait_all();
    __syncthreads();
  }

  store_rows(dk + base, acc_dk, r0, seq, g, t);
  store_rows(dv + base, acc_dv, r0, seq, g, t);
}

template <typename T, int D>
__global__ void __launch_bounds__(kGroupThreads, 1)
splash_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ kv_len,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int heads,
          int seq, int chunk, int left) {
  using Tl = Tile<T, D>;
  constexpr int E = Tl::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* qs = smem;
  T* dos = smem + E;
  T* kv = smem + 2 * E;  // [stage][K, V]

  const int bh = blockIdx.y;
  const Mask m = make_mask(kv_len, bh / heads, seq, chunk, left);
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const size_t row_base = static_cast<size_t>(bh) * seq;

  int k_lo, k_hi, w_lo, w_hi, lo[2], hi[2];
  float row_lse[2], row_delta[2];
  rows_reach<true>(m, q0, kTile, k_lo, k_hi);
  const int r0 = q0 + warp * kWarpRows;
  rows_reach<true>(m, r0, kWarpRows, w_lo, w_hi);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + g + 8 * i;
    m.row_span(qi, lo[i], hi[i]);
    row_lse[i] = qi < seq ? lse[row_base + qi] : 0.f;
    row_delta[i] = qi < seq ? delta[row_base + qi] : 0.f;
  }
  const int first = (k_lo / kTile) * kTile;
  const int n_tiles = k_hi > first ? (k_hi - first + kTile - 1) / kTile : 0;

  attn::load_tile<D>(qs, q + base, q0, seq, tid, kGroupThreads);
  attn::load_tile<D>(dos, dout + base, q0, seq, tid, kGroupThreads);
  if (n_tiles > 0) {
    attn::load_tile<D>(kv, k + base, first, seq, tid, kGroupThreads);
    attn::load_tile<D>(kv + E, v + base, first, seq, tid, kGroupThreads);
  }
  attn::cp_async_commit();
  attn::cp_async_wait_all();
  __syncthreads();

  float acc[D / 8][4];
  attn::zero(acc);
  const T* qw = qs + warp * kWarpRows * Tl::kStride;
  const T* dow = dos + warp * kWarpRows * Tl::kStride;
  int stage = 0;
  for (int i = 0; i < n_tiles; ++i, stage ^= 1) {
    const int k0 = first + i * kTile;
    if (i + 1 < n_tiles) {  // the next key tile streams in meanwhile
      T* nxt = kv + (stage ^ 1) * 2 * E;
      attn::load_tile<D>(nxt, k + base, k0 + kTile, seq, tid, kGroupThreads);
      attn::load_tile<D>(nxt + E, v + base, k0 + kTile, seq, tid,
                         kGroupThreads);
    }
    attn::cp_async_commit();
    if (k0 < w_hi && k0 + kTile > w_lo) {
      const T* ks = kv + stage * 2 * E;
      float s[8][4], dp[8][4];
      attn::zero(s);
      attn::zero(dp);
      attn::mma_rows<D>(s, qw, ks, g, t);        // S = Q K^T
      attn::mma_rows<D>(dp, dow, ks + E, g, t);  // dP = dO V^T
      probs_and_dscores<false>(s, dp, k0, lo, hi, row_lse, row_delta,
                               nullptr, nullptr, t);
      attn::mma_acc(acc, dp, ks, g, t);  // dQ += dS K
    }
    attn::cp_async_wait_all();
    __syncthreads();
  }

  store_rows(dq + base, acc, r0, seq, g, t);
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  return attn::forward_tiles(1) * Tile<T, D>::kElems * sizeof(T);
}
template <typename T, int D>
constexpr size_t dkdv_smem() {
  return 6 * Tile<T, D>::kElems * sizeof(T) + 4 * kTile * sizeof(float);
}
template <typename T, int D>
constexpr size_t dq_smem() {
  return 6 * Tile<T, D>::kElems * sizeof(T);
}

// head_dim is checked by attn::with_head_dim
bool bad_args(int batch, int heads, int seq, int dtype) {
  return seq <= 0 || batch <= 0 || heads <= 0 || (dtype != 0 && dtype != 1);
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, const int* kv_len,
                void* out, float* lse, int batch, int heads, int seq,
                int chunk, int left, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      splash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fwd_smem<T, D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  splash_fwd<T, D><<<grid, kGroupThreads, fwd_smem<T, D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), lse, heads, seq,
      chunk, left);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const int* kv_len,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int batch, int heads, int seq,
                int chunk, int left, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      splash_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkdv_smem<T, D>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(splash_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem<T, D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  splash_dkdv<T, D><<<grid, kGroupThreads, dkdv_smem<T, D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<const T*>(dout), lse,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), heads, seq, chunk,
      left);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  splash_dq<T, D><<<grid, kGroupThreads, dq_smem<T, D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<const T*>(dout), lse,
      delta, static_cast<T*>(dq), heads, seq, chunk, left);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous on the device. q, k, v, out, dout, dq, dk, dv:
// (batch, heads, seq, head_dim) in dtype (0 = float32, 1 = bfloat16),
// head_dim 8, 16 or 64 (else cudaErrorInvalidValue), q already scaled; lse, delta: float32 (batch, heads, seq); kv_len: int32
// (batch,). chunk 0 means no chunk predicate (full); left_chunks < 0 no
// left bound. Each launches on `stream` and returns cudaGetLastError()
// (0 when every launch was taken).
extern "C" int mmst_splash_fwd(const void* q, const void* k, const void* v,
                               const int* kv_len, void* out, float* lse,
                               int batch, int heads, int seq, int head_dim,
                               int chunk, int left_chunks, int dtype,
                               void* stream) {
  if (bad_args(batch, heads, seq, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(attn::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return dtype == 1
               ? fwd<__nv_bfloat16, D>(q, k, v, kv_len, out, lse, batch,
                                       heads, seq, chunk, left_chunks, s)
               : fwd<float, D>(q, k, v, kv_len, out, lse, batch, heads, seq,
                               chunk, left_chunks, s);
  }));
}

extern "C" int mmst_splash_bwd(const void* q, const void* k, const void* v,
                               const int* kv_len, const void* dout,
                               const float* lse, const float* delta, void* dq,
                               void* dk, void* dv, int batch, int heads,
                               int seq, int head_dim, int chunk,
                               int left_chunks, int dtype, void* stream) {
  if (bad_args(batch, heads, seq, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(attn::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return dtype == 1
               ? bwd<__nv_bfloat16, D>(q, k, v, kv_len, dout, lse, delta, dq,
                                       dk, dv, batch, heads, seq, chunk,
                                       left_chunks, s)
               : bwd<float, D>(q, k, v, kv_len, dout, lse, delta, dq, dk, dv,
                               batch, heads, seq, chunk, left_chunks, s);
  }));
}
