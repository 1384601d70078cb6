// Shared device code of the attention kernels K1 (flash_attention.cu) and
// K2 (splash_attention.cu): tile loads by cp.async, warp-level products on
// the tensor cores, the online softmax and the per-row interval mask on the
// accumulator fragments, and the masked forward pass both kernels run.
//
// Products: mma.sync.aligned.m16n8k8 with TF32 operands and fp32
// accumulators, one warp for each 16 rows. fp32 accuracy comes from
// 3xTF32: an fp32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest as cvt.rna.tf32.f32 rounds
// (the tensor core would truncate a raw fp32 register), and a*b is taken as
// a_hi*b_lo + a_lo*b_hi + a_hi*b_hi. A bf16 value is exact in TF32, so
// its lo is 0 and the term with it is skipped. P and dS are fp32 values
// and keep their lo for either input type.
//
// Fragments (lane = 4 g + t): A (16x8) holds (g, t) (g+8, t) (g, t+4)
// (g+8, t+4); B (8x8, k by n) holds (k=t, n=g) (k=t+4, n=g); the
// accumulator C (16x8) holds (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1). An
// accumulator becomes the A operand of the next product without a shuffle
// by renaming the contraction index within each 8-chunk: A's column t is
// the chunk's element 2t, column t+4 element 2t+1, so the B operand reads
// rows 2t and 2t+1 of its tile.
//
// The head dim D is a template parameter, one of kHeadDims (8, 16, 64).
// Tiles are 64 rows of D values in shared memory in the input's type:
// bf16 is converted to fp32 at the fragment load. Rows are padded
// (Tile::kStride: 68, 20, 12 floats or 72, 24, 8 bf16 values for D = 64,
// 16, 8; 16-byte aligned rows for cp.async), so that the row reads (lane g
// reads row g, column t) and the column reads (lane reads rows 2t, 2t+1,
// column g) of a warp hit 32 distinct banks, or one 4-byte word twice.
// A row is D / 8 k-steps of the products that contract over D (Q K^T, dO
// V^T) and D / 8 n-tiles of those that make D columns (P V, dS K, ...).
// Rows at or past the sequence's end are zero-filled by the copy.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr int kTile = 64;          // rows of a query or key tile
constexpr int kWarpRows = 16;      // rows of one warp's products
constexpr int kGroupThreads = 128; // 4 warps: the rows of one tile
constexpr float kNegInf = -1e30f;

// tiles of shared memory attention_forward takes with kSplit key groups
constexpr int forward_tiles(int split) { return 1 + 4 * split; }

// Calls f(std::integral_constant<int, D>()) for head_dim D of the
// instantiated set (8, 16, 64); any other head_dim returns
// cudaErrorInvalidValue and launches nothing.
template <typename F>
inline cudaError_t with_head_dim(int head_dim, F&& f) {
  switch (head_dim) {
    case 8:
      return f(std::integral_constant<int, 8>());
    case 16:
      return f(std::integral_constant<int, 16>());
    case 64:
      return f(std::integral_constant<int, 64>());
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
struct Tile {
  static_assert(D == 8 || D == 16 || D == 64, "head dims 8, 16 and 64");
  static constexpr bool kFloat = std::is_same<T, float>::value;
  // elements per row: D + 4 floats, D + 8 bf16 values, or 8 bf16 values at
  // D = 8 (4 words a row already spread a warp's reads over the banks)
  static constexpr int kStride = kFloat ? D + 4 : (D == 8 ? 8 : D + 8);
  static constexpr int kElems = kTile * kStride;
  static constexpr int kChunk = 16 / sizeof(T);     // elements per copy
  static_assert(D % kChunk == 0 && (kStride * sizeof(T)) % 16 == 0,
                "rows of whole 16-byte copies");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- asynchronous copies -------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros when src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// barrier of the 128 threads of group 0 or 1 (barriers 1 and 2; 0 is
// __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  if (group == 0) {
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  }
}

// rows row0 .. row0 + 63 of a (seq, D) matrix into a tile, by the
// `n_threads` threads numbered `tid` from 0
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int seq, int tid, int n_threads) {
  using Tl = Tile<T, D>;
  constexpr int kPerRow = D / Tl::kChunk;
  for (int i = tid; i < kTile * kPerRow; i += n_threads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * Tl::kChunk;
    const int g = row0 + r;
    cp_async16(dst + r * Tl::kStride + c,
               src + static_cast<size_t>(min(g, seq - 1)) * D + c,
               g < seq ? 16 : 0);
  }
}

// 64 floats of a (seq,) vector from row0 (zeros past the end)
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int seq, int tid) {
  if (tid < kTile) {
    const int g = row0 + tid;
    cp_async4(dst + tid, src + min(g, seq - 1), g < seq ? 4 : 0);
  }
}

// ---- tensor-core products -------------------------------------------------

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest on
// the low 13 bits, ties away from zero: the magnitude bits round half up),
// in two integer instructions. cvt.rna compiles to a compare-and-select
// sequence that made the kernels 1.14-1.18x slower on an H100
// (kernels/variants.py).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32; with kSplit false, x is exact in TF32 and lo is 0
template <bool kSplit>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kSplit) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32, leaving out the terms of a lo that is 0
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (kSplitA) mma(d, al, bh);
  if (kSplitB) mma(d, ah, bl);
  mma(d, ah, bh);
}

// acc[n] += A B_n^T over the D columns: A is the 16 rows of tile `a`
// from `a` on, B_n rows 8n .. 8n+7 of tile `b` (S = Q K^T, dP = dO V^T,
// and their transposes in the backward)
template <int D, typename T>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const T* a,
                                         const T* b, int g, int t) {
  constexpr int S = Tile<T, D>::kStride;
  constexpr bool kSplit = Tile<T, D>::kFloat;
  // a rolled loop: unrolled, the backward ran 1.09x slower on an H100
  // (kernels/variants.py)
#pragma unroll 1
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = 8 * kk + t;
    uint32_t ah[4], al[4];
    split<kSplit>(to_f(a[g * S + c]), ah[0], al[0]);
    split<kSplit>(to_f(a[(g + 8) * S + c]), ah[1], al[1]);
    split<kSplit>(to_f(a[g * S + c + 4]), ah[2], al[2]);
    split<kSplit>(to_f(a[(g + 8) * S + c + 4]), ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bh[2], bl[2];
      split<kSplit>(to_f(b[(8 * n + g) * S + c]), bh[0], bl[0]);
      split<kSplit>(to_f(b[(8 * n + g) * S + c + 4]), bh[1], bl[1]);
      mma3<kSplit, kSplit>(acc[n], ah, al, bh, bl);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// acc[n] += P B[:, 8n .. 8n+7] for the N = D / 8 n-tiles of B's D
// columns, P (16 x 64) an fp32 accumulator in C layout, B the 64 rows of
// tile `b` (O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K).
// The tensor cores add each product into the accumulator they are given
// with a long fp32 sum of their own, which rounds worse than an FADD:
// chained over every key tile of a row, it put the forward's O 7.4e-6
// from the plain version at the LM shape, and through Delta = rowsum(dO
// O) moved the flow UNet's to_q/to_k gradients 1.4-2.4e-4 of their
// largest from float64 (the CPU's float32: 2e-5). With kTileSum the 8
// k-steps of the tile are summed in a zeroed fragment, which is then
// added to acc by FADDs, so no tensor-core sum spans more than one key
// tile. K2's forward O takes it; the backward's products, whose sums
// span fewer tiles, and K1 keep the chained form.
template <bool kTileSum = false, int N, typename T>
__device__ __forceinline__ void mma_acc(float (&acc)[N][4],
                                        const float (&p)[8][4], const T* b,
                                        int g, int t) {
  using Tl = Tile<T, 8 * N>;
  constexpr int S = Tl::kStride;
  float part[N][4];
  if (kTileSum) zero(part);
  float(&d)[N][4] = kTileSum ? part : acc;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t ah[4], al[4];
    split<true>(p[j][0], ah[0], al[0]);
    split<true>(p[j][2], ah[1], al[1]);
    split<true>(p[j][1], ah[2], al[2]);
    split<true>(p[j][3], ah[3], al[3]);
    const T* r0 = b + (8 * j + 2 * t) * S + g;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      uint32_t bh[2], bl[2];
      split<Tl::kFloat>(to_f(r0[8 * n]), bh[0], bl[0]);
      split<Tl::kFloat>(to_f(r0[S + 8 * n]), bh[1], bl[1]);
      mma3<true, Tl::kFloat>(d[n], ah, al, bh, bl);
    }
  }
  if (kTileSum) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

// the column of accumulator element (n, e) is col0 + 8n + 2t + (e & 1); its
// row is g + 8 (e >> 1). Row i sees the columns [lo[i], hi[i]).
__device__ __forceinline__ bool visible(int col, int lo, int hi) {
  return col >= lo && col < hi;
}

// max and sum over the 4 lanes that hold one row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One key tile of the online softmax: s = scale * S, masked; the rows'
// maxima m move, the lane's partial row sums l and the output o (N = D / 8
// n-tiles) rescale, and s becomes P = exp(s - m) (0 where masked).
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], int k0,
                                               const int (&lo)[2],
                                               const int (&hi)[2], float scale,
                                               float (&m)[2], float (&l)[2],
                                               float (&o)[N][4], int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[n][2 * i + e];
        x = visible(k0 + 8 * n + 2 * t + e, lo[i], hi[i]) ? x * scale
                                                          : kNegInf;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m[i], quad_max(mx));
    const float alpha = expf(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[n][2 * i + e];
        x = x == kNegInf ? 0.f : expf(x - m_new);
        sum += x;
      }
    l[i] = l[i] * alpha + sum;
    m[i] = m_new;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      o[n][2 * i] *= alpha;
      o[n][2 * i + 1] *= alpha;
    }
  }
}

// The masked forward pass of one 64-row query tile from q0: O =
// softmax(scale Q K^T) V with row q seeing the keys of
// mask.row_span(q, lo, hi), and, when lse is not null, the rows' fp32
// logsumexp. q, k, v, out point at one (seq, D) head. The block has
// kSplit groups of 4 warps: warp w of a group owns rows q0 + 16 (w % 4)
// and group j takes key tiles j, j + kSplit, ... of the range the tile's
// rows reach, each group with its own double-buffered K and V; the
// groups' (m, l, O) are combined at the end. kTileSum: O += P V as
// mma_acc<true> sums it, one zeroed fragment per key tile.
// The shared memory holds forward_tiles(kSplit) tiles.
template <typename T, int D, int kSplit, bool kTileSum, typename Mask>
__device__ __forceinline__ void attention_forward(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    const Mask& mask, int seq, int q0, float scale, T* smem) {
  static_assert(kSplit == 1 || kSplit == 2, "one or two key groups");
  using Tl = Tile<T, D>;
  constexpr int E = Tl::kElems;
  constexpr int N = D / 8;  // n-tiles of an output row
  const int tid = threadIdx.x;
  const int group = tid / kGroupThreads;
  const int warp = (tid % kGroupThreads) / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  T* qs = smem;
  T* kv = smem + E + group * 4 * E;  // [stage][K, V]

  // key tiles the block's rows reach, and the keys this warp's rows reach
  int k_lo, k_hi, unused;
  mask.row_span(q0, k_lo, unused);
  mask.row_span(min(q0 + kTile, seq) - 1, unused, k_hi);
  const int r0 = q0 + warp * kWarpRows;
  int w_lo = 0, w_hi = 0;
  if (r0 < seq) {
    mask.row_span(r0, w_lo, unused);
    mask.row_span(min(r0 + kWarpRows, seq) - 1, unused, w_hi);
  }
  int lo[2], hi[2];
  mask.row_span(r0 + g, lo[0], hi[0]);
  mask.row_span(r0 + g + 8, lo[1], hi[1]);
  const int first = (k_lo / kTile) * kTile;
  const int n_tiles = k_hi > first ? (k_hi - first + kTile - 1) / kTile : 0;

  load_tile<D>(qs, q, q0, seq, tid, kSplit * kGroupThreads);
  const int gtid = tid % kGroupThreads;
  if (group < n_tiles) {
    load_tile<D>(kv, k, first + group * kTile, seq, gtid, kGroupThreads);
    load_tile<D>(kv + E, v, first + group * kTile, seq, gtid, kGroupThreads);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[N][4];
  zero(o);
  const T* qw = qs + warp * kWarpRows * Tl::kStride;
  int stage = 0;
  for (int i = group; i < n_tiles; i += kSplit, stage ^= 1) {
    const int k0 = first + i * kTile;
    if (i + kSplit < n_tiles) {  // the next tile streams in meanwhile
      T* nxt = kv + (stage ^ 1) * 2 * E;
      load_tile<D>(nxt, k, k0 + kSplit * kTile, seq, gtid, kGroupThreads);
      load_tile<D>(nxt + E, v, k0 + kSplit * kTile, seq, gtid,
                   kGroupThreads);
    }
    cp_async_commit();
    if (k0 < w_hi && k0 + kTile > w_lo) {
      const T* ks = kv + stage * 2 * E;
      float s[8][4];
      zero(s);
      mma_rows<D>(s, qw, ks, g, t);
      online_softmax(s, k0, lo, hi, scale, m, l, o, t);
      mma_acc<kTileSum>(o, s, ks + E, g, t);
    }
    cp_async_wait_all();
    group_sync(group);
  }

  if (kSplit == 2) {
    // group 1 hands its (m, l, O) to group 0 through the K/V buffers
    constexpr int kVals = 4 + 4 * N;
    static_assert(4 * kVals * 32 * sizeof(float) <=
                      4 * kSplit * E * sizeof(T),
                  "the hand-over fits the K/V buffers");
    __syncthreads();
    float* buf = reinterpret_cast<float*>(smem + E) +
                 warp * kVals * 32 + lane;
    if (group == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        buf[i * 32] = m[i];
        buf[(2 + i) * 32] = l[i];
      }
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) buf[(4 + 4 * n + e) * 32] = o[n][e];
    }
    __syncthreads();
    if (group == 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = buf[i * 32];
      const float m_new = fmaxf(m[i], m1);
      const float a0 = expf(m[i] - m_new), a1 = expf(m1 - m_new);
      l[i] = l[i] * a0 + buf[(2 + i) * 32] * a1;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[n][2 * i + e] =
              o[n][2 * i + e] * a0 + buf[(4 + 4 * n + 2 * i + e) * 32] * a1;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    const float sum = fmaxf(quad_sum(l[i]), 1e-30f);
    if (row >= seq) continue;
    const float inv = 1.f / sum;
    T* dst = out + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < N; ++n)
      store_pair(dst + 8 * n, o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (lse != nullptr && t == 0) lse[row] = m[i] + logf(sum);
  }
}

}  // namespace attn
