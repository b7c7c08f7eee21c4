// Flash attention forward and backward for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces the three TPU kernels of workloads/ops/attention.py:
//   K2 flash_fwd_*     <- _flash_kernel          (forward: out and lse)
//   K3 flash_bwd_dq_*  <- _flash_bwd_dq_kernel   (dq)
//   K4 flash_bwd_dkv_* <- _flash_bwd_dkv_kernel  (dk, dv)
// They compute the same functions: scaled dot-product attention over the
// [batch, seq, heads, head_dim] layout, causal or full, grouped-query heads
// (q head h reads kv head h / (heads / kv_heads)), a causal sliding window,
// segment_ids packing, scores in float32 scaled by 1/sqrt(head_dim), masked
// entries at -1e30 (not -inf), a float32 online softmax whose weights are
// rounded to the input dtype before each product with v, the backward's p
// recomputed from (q, k, lse) and explicitly zeroed where masked, and ds
// rounded to the input dtype before its products with k and q.
//
// What bounds them: operations.  At the training shapes (seq 2047, head_dim
// 128) attention does ~2*seq*hd flops per q/k/v element it reads, far above
// the ~295 flops per byte at which an H100's tensor cores become the limit.
// So the bf16 kernels are built around the tensor cores.  Each kernel comes
// in versions picked by the input dtype and, for the backward, head_dim:
//   * bf16 at head_dim 64 and 128 (the training path), all three kernels:
//     Hopper's warpgroup products, `wgmma.mma_async`, fed from a
//     shared-memory ring that the Tensor Memory Accelerator fills
//     (`cp.async.bulk.tensor` with `mbarrier`s), warp-specialised: one
//     producer warp keeps the next tiles' copies in flight while two
//     consumer warpgroups (64 rows each) run the products, so a tile's copy
//     overlaps the previous tile's math; `setmaxnreg` moves registers from
//     the producer to the consumers.  K3's and K4's score products take both
//     operands from shared memory, K2's takes q from registers; p and ds,
//     rounded to bf16, become register A operands of the next products (the
//     wgmma accumulator and register-A layouts match lane for lane).  The
//     mask is evaluated only on tiles that the diagonal, the window edge,
//     the end of seq or a segment boundary cut; fully visible tiles skip it.
//     Sections "wgmma backward" and "wgmma forward" below have the layouts;
//   * bf16 at head_dim 16 and 32 (tests and the tiny configurations, where a
//     64-column TMA box is wider than the head): warp-level mma.sync
//     m16n8k16 tensor-core products, bf16 operands and float32 accumulators.
//     A CTA is 4 warps; each warp owns 16 rows of a 64-row tile.  Tiles are
//     staged in shared memory with 16-byte loads into rows padded by 8
//     elements (16 bytes), so ldmatrix reads them without bank conflicts.
//     The rounding of p and ds to bf16 is the conversion of the score
//     fragments into the next product's operand.  This is a compile-time
//     dispatch on head_dim (`launch<HD>`), not a fallback;
//   * float32: float32 FMAs on CUDA cores from padded shared-memory tiles
//     (tensor cores would round the operands to TF32).  256 threads; each
//     thread owns a 4x4 block of a 64x64 score tile (rows ty*4+i, columns
//     tx+16j) and a 4 x (head_dim/16) block of the output tile.
// The design shared by all:
//   * K2 and K3: one CTA per (batch*head, q tile: 64 rows, 128 on the wgmma
//     route); the k/v walk is a loop inside the CTA (the Pallas grid's
//     sequential axis), with the online-softmax state (m, l) or the dq
//     accumulator in registers; the last q tile goes first;
//   * K4: one CTA per (batch*kv_head, k tile: 64 keys, 128 on the wgmma
//     route), looping over every (group member, q tile) pair, so a
//     grouped-query group's dk/dv sum is taken inside the CTA in the Pallas
//     kernel's order -- no atomics, and the gradients are deterministic;
//   * fully masked tiles are skipped: k tiles past the diagonal or before the
//     window (K2, K3: attention.py:120-122), q tiles above the diagonal or
//     past the window (K4: attention.py:393-396);
//   * every load and store is bounded by seq (2047 is not a multiple of the
//     tile), and every tensor offset is 64-bit.
// (Issuing a tile's gradient products with the next tile's score products,
// to overlap them inside a warpgroup, measured no faster in K3 and K4 on an
// H100: the two consumer warpgroups already fill each other's gaps.)

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;        // q rows per tile
constexpr int kBlockK = 64;        // k rows per tile
constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF

// The mask of attention.py: key inside the sequence, and when causal, at or
// before the query and (with a window) inside its last `window` positions.
__device__ __forceinline__ bool visible(int qi, int kj, int seq, int causal, int window) {
  bool ok = kj < seq;
  if (causal) {
    ok = ok && kj <= qi;
    if (window > 0) ok = ok && kj > qi - window;
  }
  return ok;
}

// K2 and K3 walk the k tiles that hold a key visible from some row of the q
// tile at q0: stop past the diagonal, skip tiles before the window.
__device__ __forceinline__ bool k_tile_past(int k0, int q0, int causal) {
  return causal && k0 > q0 + kBlockQ - 1;
}
__device__ __forceinline__ bool k_tile_before_window(int k0, int q0, int causal, int window) {
  return causal && window > 0 && k0 + kBlockK - 1 <= q0 - window;
}
// K4 walks the q tiles that hold a query that sees some key of the k tile at
// k0: skip tiles above the diagonal and past the window.
__device__ __forceinline__ bool q_tile_dead(int q0, int k0, int causal, int window) {
  if (!causal) return false;
  if (q0 + kBlockQ - 1 < k0) return true;
  return window > 0 && q0 > k0 + kBlockK - 1 + window - 1;
}

// 64 per-row values of one (batch*head) row vector [seq], `pad` past seq.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int seq, float pad) {
  for (int r = threadIdx.x; r < 64; r += blockDim.x)
    dst[r] = row0 + r < seq ? src[row0 + r] : pad;
}

// 64 segment ids of one batch row [seq]; -1 past seq (matches no segment).
__device__ __forceinline__ void load_seg(int* dst, const int* __restrict__ seg, int row0,
                                         int seq) {
  for (int r = threadIdx.x; r < 64; r += blockDim.x) dst[r] = row0 + r < seq ? seg[row0 + r] : -1;
}

// ---------------------------------------------------------------------------
// float32: FMAs on CUDA cores.

constexpr int kThreads = 256;      // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kPLd = kBlockK + 1;  // padded row stride of a [64, 64] score tile

// Max and sum over the 16 lanes (one tx range) that share a score row.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + 64) of head `head` of a [batch, seq, n_heads, HD] tensor
// into a tile with row stride HD + 1 (the padding keeps the column reads of
// tile_dot_nt free of bank conflicts).  Rows past seq read as 0.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int64_t b,
                                          int row0, int seq, int n_heads, int head) {
  for (int idx = threadIdx.x; idx < 64 * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int row = row0 + r;
    const int64_t off = ((b * seq + row) * n_heads + head) * (int64_t)HD + d;
    dst[r * (HD + 1) + d] = row < seq ? src[off] : 0.f;
  }
}

// acc[i][j] += sum_d a[ty*4+i][d] * b[tx+16j][d] over two [64, HD] tiles.
template <int HD>
__device__ __forceinline__ void tile_dot_nt(float (&acc)[4][4], const float* a, const float* b,
                                            int ty, int tx) {
  constexpr int kLd = HD + 1;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// acc[i][c] += sum_t P[ty*4+i][t] * x[t][tx+16c]       (kTransP false), or
// acc[i][c] += sum_t P[t][ty*4+i] * x[t][tx+16c]       (kTransP true),
// for a [64, 64] tile P (stride kPLd) and a [64, HD] tile x.
template <int HD, bool kTransP>
__device__ __forceinline__ void tile_dot_pn(float (&acc)[4][HD / 16], const float* p,
                                            const float* x, int ty, int tx) {
  constexpr int kLd = HD + 1;
#pragma unroll 4
  for (int t = 0; t < 64; ++t) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = kTransP ? p[t * kPLd + ty * 4 + i] : p[(ty * 4 + i) * kPLd + t];
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float xv = x[t * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * xv;
    }
  }
}

template <int HD>
constexpr size_t fwd_f32_smem_bytes() {
  return sizeof(float) * (3 * 64 * (HD + 1) + 64 * kPLd) + sizeof(int) * 2 * 64;
}

template <int HD>
constexpr size_t dq_f32_smem_bytes() {
  return sizeof(float) * (4 * 64 * (HD + 1) + 64 * kPLd + 2 * 64) + sizeof(int) * 2 * 64;
}

// The largest, at HD 128, is 166,400 bytes: every head_dim fits one block's
// 227 KB.
template <int HD>
constexpr size_t dkv_f32_smem_bytes() {
  return sizeof(float) * (4 * 64 * (HD + 1) + 2 * 64 * kPLd + 2 * 64) + sizeof(int) * 2 * 64;
}
static_assert(dkv_f32_smem_bytes<128>() <= 232448, "K4's tiles must fit one block");

// K2, float32.  Grid (batch*heads, q tiles).  out [batch, seq, heads, HD],
// lse [batch*heads, seq].
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     float* __restrict__ out, float* __restrict__ lse, int seq, int heads,
                     int kv_heads, int causal, int window, float sm_scale) {
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + 64 * kLd;
  float* v_s = k_s + 64 * kLd;
  float* p_s = v_s + 64 * kLd;
  int* segq_s = reinterpret_cast<int*>(p_s + 64 * kPLd);
  int* segk_s = segq_s + 64;

  const int bh = blockIdx.x;
  const int64_t b = bh / heads;
  const int h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = blockIdx.y * kBlockQ;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<HD>(q_s, q, b, q0, seq, heads, h);
  if (seg) load_seg(segq_s, seg + b * seq, q0, seq);
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (seq + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    if (k_tile_past(k0, q0, causal)) break;  // so is every later k tile
    if (k_tile_before_window(k0, q0, causal, window)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD>(k_s, k, b, k0, seq, kv_heads, hk);
    load_tile<HD>(v_s, v, b, k0, seq, kv_heads, hk);
    if (seg) load_seg(segk_s, seg + b * seq, k0, seq);
    __syncthreads();

    float s[4][4] = {};
    tile_dot_nt<HD>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(q0 + r, k0 + c, seq, causal, window) &&
                        (!seg || segq_s[r] == segk_s[c]);
        s[i][j] = ok ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[r * kPLd + tx + 16 * j] = p;
      }
      sum = row_sum16(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_dot_pn<HD, false>(acc, p_s, v_s, ty, tx);
  }

  // l_safe as attention.py:131: a row with l == 0 writes 0 and lse -1e30.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    float* o = out + ((b * seq + row) * heads + h) * (int64_t)HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = acc[i][c] / l_safe;
    if (tx == 0) lse[(int64_t)bh * seq + row] = m[i] + logf(l_safe);
  }
}

// K3, float32.  Grid (batch*heads, q tiles).  dq [batch, seq, heads, HD].
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ seg, float* __restrict__ dq, int seq, int heads,
                        int kv_heads, int causal, int window, float sm_scale) {
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* do_s = q_s + 64 * kLd;
  float* k_s = do_s + 64 * kLd;
  float* v_s = k_s + 64 * kLd;
  float* ds_s = v_s + 64 * kLd;
  float* lse_s = ds_s + 64 * kPLd;
  float* delta_s = lse_s + 64;
  int* segq_s = reinterpret_cast<int*>(delta_s + 64);
  int* segk_s = segq_s + 64;

  const int bh = blockIdx.x;
  const int64_t b = bh / heads;
  const int h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = blockIdx.y * kBlockQ;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<HD>(q_s, q, b, q0, seq, heads, h);
  load_tile<HD>(do_s, dout, b, q0, seq, heads, h);
  load_rows(lse_s, lse + (int64_t)bh * seq, q0, seq, kNegInf);
  load_rows(delta_s, delta + (int64_t)bh * seq, q0, seq, 0.f);
  if (seg) load_seg(segq_s, seg + b * seq, q0, seq);
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int n_kt = (seq + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    if (k_tile_past(k0, q0, causal)) break;
    if (k_tile_before_window(k0, q0, causal, window)) continue;
    __syncthreads();
    load_tile<HD>(k_s, k, b, k0, seq, kv_heads, hk);
    load_tile<HD>(v_s, v, b, k0, seq, kv_heads, hk);
    if (seg) load_seg(segk_s, seg + b * seq, k0, seq);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot_nt<HD>(s, q_s, k_s, ty, tx);
    tile_dot_nt<HD>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = q0 + r < seq && visible(q0 + r, k0 + c, seq, causal, window) &&
                        (!seg || segq_s[r] == segk_s[c]);
        // Zeroed explicitly where masked: a row with no visible key carries
        // lse -1e30, where exp(s - lse) would give 1.
        const float p = ok ? expf(s[i][j] * sm_scale - lse_s[r]) : 0.f;
        ds_s[r * kPLd + c] = p * (dp[i][j] - delta_s[r]) * sm_scale;
      }
    }
    __syncthreads();
    tile_dot_pn<HD, false>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq) continue;
    float* o = dq + ((b * seq + row) * heads + h) * (int64_t)HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = acc[i][c];
  }
}

// K4, float32.  Grid (batch*kv_heads, k tiles).  dk, dv [batch, seq, kv_heads, HD].
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ seg, float* __restrict__ dk,
                         float* __restrict__ dv, int seq, int heads, int kv_heads, int causal,
                         int window, float sm_scale) {
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + 64 * kLd;
  float* q_s = v_s + 64 * kLd;
  float* do_s = q_s + 64 * kLd;
  float* p_s = do_s + 64 * kLd;
  float* ds_s = p_s + 64 * kPLd;
  float* lse_s = ds_s + 64 * kPLd;
  float* delta_s = lse_s + 64;
  int* segq_s = reinterpret_cast<int*>(delta_s + 64);
  int* segk_s = segq_s + 64;

  const int bk = blockIdx.x;
  const int64_t b = bk / kv_heads;
  const int hk = bk % kv_heads;
  const int group = heads / kv_heads;
  const int k0 = blockIdx.y * kBlockK;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<HD>(k_s, k, b, k0, seq, kv_heads, hk);
  load_tile<HD>(v_s, v, b, k0, seq, kv_heads, hk);
  if (seg) load_seg(segk_s, seg + b * seq, k0, seq);
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qt = (seq + kBlockQ - 1) / kBlockQ;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t bh = b * heads + h;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kBlockQ;
      if (q_tile_dead(q0, k0, causal, window)) continue;
      __syncthreads();
      load_tile<HD>(q_s, q, b, q0, seq, heads, h);
      load_tile<HD>(do_s, dout, b, q0, seq, heads, h);
      load_rows(lse_s, lse + bh * seq, q0, seq, kNegInf);
      load_rows(delta_s, delta + bh * seq, q0, seq, 0.f);
      if (seg) load_seg(segq_s, seg + b * seq, q0, seq);
      __syncthreads();

      float s[4][4] = {}, dp[4][4] = {};
      tile_dot_nt<HD>(s, q_s, k_s, ty, tx);
      tile_dot_nt<HD>(dp, do_s, v_s, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = q0 + r < seq && visible(q0 + r, k0 + c, seq, causal, window) &&
                          (!seg || segq_s[r] == segk_s[c]);
          const float p = ok ? expf(s[i][j] * sm_scale - lse_s[r]) : 0.f;
          p_s[r * kPLd + c] = p;
          ds_s[r * kPLd + c] = p * (dp[i][j] - delta_s[r]) * sm_scale;
        }
      }
      __syncthreads();
      tile_dot_pn<HD, true>(dv_acc, p_s, do_s, ty, tx);
      tile_dot_pn<HD, true>(dk_acc, ds_s, q_s, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= seq) continue;
    const int64_t off = ((b * seq + row) * kv_heads + hk) * (int64_t)HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[off + tx + 16 * c] = dk_acc[i][c];
      dv[off + tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync tensor-core tiles.
//
// Fragments of mma.m16n8k16 (bf16 in, float32 out), per lane, with
// r = lane / 4 and c = 2 * (lane % 4):
//   A [16 x 16]: a0 (r, c..c+1), a1 (r+8, c..c+1), a2 (r, c+8..), a3 (r+8, c+8..);
//   B [16 x 8] : b0 (k c..c+1, n r), b1 (k c+8.., n r);
//   C [16 x 8] : c0, c1 (r, c..c+1), c2, c3 (r+8, c..c+1).
// Two C tiles side by side (columns 0-7 and 8-15) hold, lane by lane, the
// elements of one A fragment over those 16 columns: a score tile turns into
// the next product's operand in registers, rounded to bf16 on the way.

typedef __nv_bfloat16 bf16;

constexpr int kMmaThreads = 128;  // 4 warps, 16 tile rows each
constexpr int kRowPad = 8;        // bf16 elements of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of columns [16j, 16j + 16) of a 16-row score block held as
// C tiles s[2j], s[2j + 1].
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&s0)[4],
                                         const float (&s1)[4]) {
  a[0] = pack_bf16(s0[0], s0[1]);
  a[1] = pack_bf16(s0[2], s0[3]);
  a[2] = pack_bf16(s1[0], s1[1]);
  a[3] = pack_bf16(s1[2], s1[3]);
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a row-major tile.
template <int LD>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* t, int r0, int c0, int lane) {
  ldmatrix_x4(a, t + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of n tiles [n0, n0 + 8) and [n0 + 8, n0 + 16) over k [k0, k0 + 16)
// from a tile stored [n][k] (b[0], b[1] the first n tile; b[2], b[3] the second).
template <int LD>
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], const bf16* t, int n0, int k0,
                                        int lane) {
  ldmatrix_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n].
template <int LD>
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], const bf16* t, int k0, int n0,
                                        int lane) {
  ldmatrix_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8);
}

// Rows [row0, row0 + 64) of head `head` of a [batch, seq, n_heads, HD] bf16
// tensor into a tile with row stride HD + kRowPad, 16 bytes a load.  Rows
// past seq read as 0.
template <int HD>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src,
                                               int64_t b, int row0, int seq, int n_heads,
                                               int head) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row < seq) {
      const int64_t off = ((b * seq + row) * n_heads + head) * (int64_t)HD + c;
      x = *reinterpret_cast<const uint4*>(src + off);
    }
    *reinterpret_cast<uint4*>(dst + r * (HD + kRowPad) + c) = x;
  }
}

// Max and sum over the 4 lanes that share a fragment row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two float32 values rounded to bf16 and stored at p (4-byte aligned).
__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

template <int HD>
constexpr size_t fwd_bf16_smem_bytes() {
  return sizeof(bf16) * 3 * 64 * (HD + kRowPad) + sizeof(int) * 2 * 64;
}

template <int HD>
constexpr size_t bwd_bf16_smem_bytes() {
  return sizeof(bf16) * 4 * 64 * (HD + kRowPad) + sizeof(float) * 2 * 64 + sizeof(int) * 2 * 64;
}

// K2, bf16.  Grid (batch*heads, q tiles), the last q tile first (under a
// causal mask it walks the most k tiles).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ seg,
                      bf16* __restrict__ out, float* __restrict__ lse, int seq, int heads,
                      int kv_heads, int causal, int window, float sm_scale) {
  constexpr int LD = HD + kRowPad;
  constexpr int kN = HD / 8;  // C tiles across head_dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + 64 * LD;
  bf16* v_s = k_s + 64 * LD;
  int* segq_s = reinterpret_cast<int*>(v_s + 64 * LD);
  int* segk_s = segq_s + 64;

  const int bh = blockIdx.x;
  const int64_t b = bh / heads;
  const int h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int lane = threadIdx.x % 32;
  const int wr = (threadIdx.x / 32) * 16;  // this warp's first row of the tile
  const int fr = lane >> 2;                // fragment row (and row + 8)
  const int fc = 2 * (lane & 3);           // fragment column pair

  load_tile_bf16<HD>(q_s, q, b, q0, seq, heads, h);
  if (seg) load_seg(segq_s, seg + b * seq, q0, seq);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kN][4] = {};

  const int n_kt = (seq + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    if (k_tile_past(k0, q0, causal)) break;  // so is every later k tile
    if (k_tile_before_window(k0, q0, causal, window)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16<HD>(k_s, k, b, k0, seq, kv_heads, hk);
    load_tile_bf16<HD>(v_s, v, b, k0, seq, kv_heads, hk);
    if (seg) load_seg(segk_s, seg + b * seq, k0, seq);
    __syncthreads();

    // s = q k^T: 16 rows x 64 keys for this warp, as 8 C tiles.
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ld_a<LD>(a, q_s, wr, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bf[4];
        ld_b_nk<LD>(bf, k_s, nt * 16, kk * 16, lane);
        mma_bf16(s[2 * nt], a, bf[0], bf[1]);
        mma_bf16(s[2 * nt + 1], a, bf[2], bf[3]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {  // fragment rows fr and fr + 8
      const int r = wr + fr + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + fc + e;
          const bool ok = visible(q0 + r, k0 + c, seq, causal, window) &&
                          (!seg || segq_s[r] == segk_s[c]);
          float& x = s[j][2 * i + e];
          x = ok ? x * sm_scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = quad_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      // l sums the float32 weights; the p.v product takes them rounded to bf16.
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * i + e];
          x = expf(x - m_new);
          sum += x;
        }
      sum = quad_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        o[c][2 * i] *= alpha;
        o[c][2 * i + 1] *= alpha;
      }
    }

    // o += p v over the tile's 64 keys.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < HD / 16; ++nt) {
        uint32_t bf[4];
        ld_b_kn<LD>(bf, v_s, kk * 16, nt * 16, lane);
        mma_bf16(o[2 * nt], a, bf[0], bf[1]);
        mma_bf16(o[2 * nt + 1], a, bf[2], bf[3]);
      }
    }
  }

  // l_safe as attention.py:131: a row with l == 0 writes 0 and lse -1e30.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + fr + 8 * i;
    if (row >= seq) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    bf16* op = out + ((b * seq + row) * heads + h) * (int64_t)HD;
#pragma unroll
    for (int c = 0; c < kN; ++c)
      store_pair(op + c * 8 + fc, o[c][2 * i] / l_safe, o[c][2 * i + 1] / l_safe);
    if ((lane & 3) == 0) lse[(int64_t)bh * seq + row] = m[i] + logf(l_safe);
  }
}

// K3, bf16.  Grid (batch*heads, q tiles), the last q tile first.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ seg, bf16* __restrict__ dq, int seq, int heads,
                         int kv_heads, int causal, int window, float sm_scale) {
  constexpr int LD = HD + kRowPad;
  constexpr int kN = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + 64 * LD;
  bf16* k_s = do_s + 64 * LD;
  bf16* v_s = k_s + 64 * LD;
  float* lse_s = reinterpret_cast<float*>(v_s + 64 * LD);
  float* delta_s = lse_s + 64;
  int* segq_s = reinterpret_cast<int*>(delta_s + 64);
  int* segk_s = segq_s + 64;

  const int bh = blockIdx.x;
  const int64_t b = bh / heads;
  const int h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int lane = threadIdx.x % 32;
  const int wr = (threadIdx.x / 32) * 16;
  const int fr = lane >> 2;
  const int fc = 2 * (lane & 3);

  load_tile_bf16<HD>(q_s, q, b, q0, seq, heads, h);
  load_tile_bf16<HD>(do_s, dout, b, q0, seq, heads, h);
  load_rows(lse_s, lse + (int64_t)bh * seq, q0, seq, kNegInf);
  load_rows(delta_s, delta + (int64_t)bh * seq, q0, seq, 0.f);
  if (seg) load_seg(segq_s, seg + b * seq, q0, seq);
  float acc[kN][4] = {};

  const int n_kt = (seq + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    if (k_tile_past(k0, q0, causal)) break;
    if (k_tile_before_window(k0, q0, causal, window)) continue;
    __syncthreads();
    load_tile_bf16<HD>(k_s, k, b, k0, seq, kv_heads, hk);
    load_tile_bf16<HD>(v_s, v, b, k0, seq, kv_heads, hk);
    if (seg) load_seg(segk_s, seg + b * seq, k0, seq);
    __syncthreads();

    // s = q k^T and dp = dout v^T, 16 rows x 64 keys each.
    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ld_a<LD>(aq, q_s, wr, kk * 16, lane);
      ld_a<LD>(ado, do_s, wr, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bf[4];
        ld_b_nk<LD>(bf, k_s, nt * 16, kk * 16, lane);
        mma_bf16(s[2 * nt], aq, bf[0], bf[1]);
        mma_bf16(s[2 * nt + 1], aq, bf[2], bf[3]);
        ld_b_nk<LD>(bf, v_s, nt * 16, kk * 16, lane);
        mma_bf16(dp[2 * nt], ado, bf[0], bf[1]);
        mma_bf16(dp[2 * nt + 1], ado, bf[2], bf[3]);
      }
    }

    // ds = p (dp - delta) sm_scale, into s.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wr + fr + 8 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + fc + e;
          const bool ok = q0 + r < seq && visible(q0 + r, k0 + c, seq, causal, window) &&
                          (!seg || segq_s[r] == segk_s[c]);
          // Zeroed explicitly where masked: a row with no visible key carries
          // lse -1e30, where exp(s - lse) would give 1.
          const float p = ok ? expf(s[j][2 * i + e] * sm_scale - lse_s[r]) : 0.f;
          s[j][2 * i + e] = p * (dp[j][2 * i + e] - delta_s[r]) * sm_scale;
        }
    }

    // dq += ds k over the tile's 64 keys.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < HD / 16; ++nt) {
        uint32_t bf[4];
        ld_b_kn<LD>(bf, k_s, kk * 16, nt * 16, lane);
        mma_bf16(acc[2 * nt], a, bf[0], bf[1]);
        mma_bf16(acc[2 * nt + 1], a, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + fr + 8 * i;
    if (row >= seq) continue;
    bf16* op = dq + ((b * seq + row) * heads + h) * (int64_t)HD;
#pragma unroll
    for (int c = 0; c < kN; ++c) store_pair(op + c * 8 + fc, acc[c][2 * i], acc[c][2 * i + 1]);
  }
}

// K4, bf16.  Grid (batch*kv_heads, k tiles).  Each warp owns 16 keys of the
// tile and takes each q tile in two halves of 32 queries, which keeps the
// transposed score and dp blocks to 16 registers each beside the dk and dv
// accumulators.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ seg, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int seq, int heads, int kv_heads, int causal,
                          int window, float sm_scale) {
  constexpr int LD = HD + kRowPad;
  constexpr int kN = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + 64 * LD;
  bf16* q_s = v_s + 64 * LD;
  bf16* do_s = q_s + 64 * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + 64 * LD);
  float* delta_s = lse_s + 64;
  int* segq_s = reinterpret_cast<int*>(delta_s + 64);
  int* segk_s = segq_s + 64;

  const int bk = blockIdx.x;
  const int64_t b = bk / kv_heads;
  const int hk = bk % kv_heads;
  const int group = heads / kv_heads;
  const int k0 = blockIdx.y * kBlockK;
  const int lane = threadIdx.x % 32;
  const int wr = (threadIdx.x / 32) * 16;  // this warp's first key of the tile
  const int fr = lane >> 2;
  const int fc = 2 * (lane & 3);

  load_tile_bf16<HD>(k_s, k, b, k0, seq, kv_heads, hk);
  load_tile_bf16<HD>(v_s, v, b, k0, seq, kv_heads, hk);
  if (seg) load_seg(segk_s, seg + b * seq, k0, seq);
  float dk_acc[kN][4] = {}, dv_acc[kN][4] = {};

  const int n_qt = (seq + kBlockQ - 1) / kBlockQ;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t bh = b * heads + h;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kBlockQ;
      if (q_tile_dead(q0, k0, causal, window)) continue;
      __syncthreads();
      load_tile_bf16<HD>(q_s, q, b, q0, seq, heads, h);
      load_tile_bf16<HD>(do_s, dout, b, q0, seq, heads, h);
      load_rows(lse_s, lse + bh * seq, q0, seq, kNegInf);
      load_rows(delta_s, delta + bh * seq, q0, seq, 0.f);
      if (seg) load_seg(segq_s, seg + b * seq, q0, seq);
      __syncthreads();

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qh = half * 32;
        // s^T = k q^T and dp^T = v dout^T: 16 keys x 32 queries each.
        float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t ak[4], av[4];
          ld_a<LD>(ak, k_s, wr, kk * 16, lane);
          ld_a<LD>(av, v_s, wr, kk * 16, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t bf[4];
            ld_b_nk<LD>(bf, q_s, qh + nt * 16, kk * 16, lane);
            mma_bf16(st[2 * nt], ak, bf[0], bf[1]);
            mma_bf16(st[2 * nt + 1], ak, bf[2], bf[3]);
            ld_b_nk<LD>(bf, do_s, qh + nt * 16, kk * 16, lane);
            mma_bf16(dpt[2 * nt], av, bf[0], bf[1]);
            mma_bf16(dpt[2 * nt + 1], av, bf[2], bf[3]);
          }
        }

        // p^T into st and ds^T into dpt; rows are keys, columns queries.
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wr + fr + 8 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = qh + j * 8 + fc + e;
              const bool ok = q0 + c < seq && visible(q0 + c, k0 + r, seq, causal, window) &&
                              (!seg || segq_s[c] == segk_s[r]);
              const float p = ok ? expf(st[j][2 * i + e] * sm_scale - lse_s[c]) : 0.f;
              st[j][2 * i + e] = p;
              dpt[j][2 * i + e] = p * (dpt[j][2 * i + e] - delta_s[c]) * sm_scale;
            }
        }

        // dv += p^T dout and dk += ds^T q over these 32 queries.
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t ap[4], ads[4];
          a_from_c(ap, st[2 * kk], st[2 * kk + 1]);
          a_from_c(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int nt = 0; nt < HD / 16; ++nt) {
            uint32_t bf[4];
            ld_b_kn<LD>(bf, do_s, qh + kk * 16, nt * 16, lane);
            mma_bf16(dv_acc[2 * nt], ap, bf[0], bf[1]);
            mma_bf16(dv_acc[2 * nt + 1], ap, bf[2], bf[3]);
            ld_b_kn<LD>(bf, q_s, qh + kk * 16, nt * 16, lane);
            mma_bf16(dk_acc[2 * nt], ads, bf[0], bf[1]);
            mma_bf16(dk_acc[2 * nt + 1], ads, bf[2], bf[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + wr + fr + 8 * i;
    if (row >= seq) continue;
    const int64_t off = ((b * seq + row) * kv_heads + hk) * (int64_t)HD;
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      store_pair(dk + off + c * 8 + fc, dk_acc[c][2 * i], dk_acc[c][2 * i + 1]);
      store_pair(dv + off + c * 8 + fc, dv_acc[c][2 * i], dv_acc[c][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma backward: bf16 K3 and K4 at head_dim 64 and 128.
//
// A CTA is two consumer warpgroups (warps 0-7, 64 rows each) and a producer
// warpgroup whose first warp (warp 8) does the loading; the other three
// producer warps exit.  The producer loads, once, the tiles the CTA keeps
// (K and V for K4; Q and dO for K3), then walks the tiles the CTA streams
// (Q and dO for K4; K and V for K3) through a kStages-deep ring: it waits
// for a slot's `empty` barrier, writes the slot's per-row values (lse, delta,
// segment ids) with plain stores, and asks TMA for the tiles, which complete
// the slot's `full` barrier by their byte count.  Each consumer warp arrives
// on `empty` once its products have read the slot.
//
// Tiles arrive through 4-D tensor maps over [batch, seq, heads, hd]
// ({hd, heads, seq, batch} innermost first), in boxes of 64 columns (128
// bytes) by r rows with the 128-byte swizzle; head_dim 128 is two boxes, one
// after the other.  Rows past seq come back as zeros.  A box is r x 128
// bytes, 1024-byte aligned: the layout that a wgmma descriptor with the
// 128-byte swizzle reads, K-major (contraction along the 64 columns, 1024
// bytes between 8-row groups, +32 bytes per 16 columns) or MN-major
// (contraction along the rows, 1024 bytes between 8-row groups, one box
// between the two 64-column halves).
//
// K4 (dk, dv): rows are keys.  Consumer warpgroup w owns keys
// [k0 + 64w, k0 + 64w + 64) and, for each 64-query slot taken in QN-query
// parts, computes s^T = K q^T and dp^T = V dO^T (m64nQNk16, both operands in
// shared memory), turns them into p^T and ds^T in registers, and adds
// dv += p^T dO and dk += ds^T q (m64nHDk16, A from registers, B = the slot's
// dO or q read MN-major).  K3 (dq): rows are queries; warpgroup w owns q rows
// [q0 + 64w, q0 + 64w + 64) and, for each 64-key slot, computes s = q K^T and
// dp = dO V^T, then dq += ds K.

// Registers: with 9 to 12 warps, three warps share one of the SM's four
// 16K-register files, so a thread starts with 168.  setmaxnreg moves
// registers between whole warpgroups: the producer warpgroup gives back 128 a
// thread, and each consumer thread takes 64 more (256 x 232 + 128 x 40 =
// 384 x 168).  A 64-row accumulator of head_dim 128 is 64 registers a
// thread, and K4 holds two.
constexpr int kWsThreads = 384;
constexpr int kProducerWarp = 8;
constexpr int kConsumerWarps = 8;
constexpr int kStages = 3;  // ring depth (2 measured 3-8% slower on an H100)
constexpr int kMixedSegs = -2147483647 - 1;  // a tile whose segment ids differ
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA transfers to come.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity.  (No
// timeout: a trap anywhere in a setmaxnreg region makes ptxas size the
// region by the launch's 168 registers, and K4 then spills.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// One TMA box: 64 columns from column c0 of head `head`, rows from row0, of
// batch row `batch`, into shared memory at dst; completes on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                        int c0, int head, int row0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(head), "r"(row0), "r"(batch),
      "r"(smem_u32(bar))
      : "memory");
}

// A [rows, HD] tile: HD / 64 boxes of rows x 128 bytes.
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row0, int batch, int rows) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
    tma_box(dst + c * rows * 128, map, bar, 64 * c, head, row0, batch);
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading byte offset `lbo`, 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// K-major operand: rows [row0, row0 + 64) of a tile whose boxes hold
// box_rows rows, contraction columns [16kk, 16kk + 16); `desc` describes the
// tile's start (lbo unused).  The start address field is the low 14 bits and
// no offset carries out of it (shared memory ends below 256 KB).
__device__ __forceinline__ uint64_t kmajor(uint64_t desc, int box_rows, int row0, int kk) {
  return desc + (uint64_t)(((kk >> 2) * box_rows * 128 + row0 * 128 + (kk & 3) * 32) >> 4);
}

// MN-major B operand: contraction rows [row0 + 16kk, row0 + 16kk + 16) of a
// tile; `desc` describes the tile's start with lbo = one box.
__device__ __forceinline__ uint64_t mnmajor(uint64_t desc, int row0, int kk) {
  return desc + (uint64_t)(((row0 + 16 * kk) * 128) >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most the newest committed group is still running.
__device__ __forceinline__ void wgmma_wait_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to registers that an asynchronous
// wgmma reads or writes across the instructions that order it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[16] (+)= A.B, m64n32k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] (+)= A.B, m64n64k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A.B, m64n64k16, A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] (+)= A.B, m64n64k16, A from registers, B from shared memory K-major.
__device__ __forceinline__ void wgmma_rs_kmajor_n64(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64] += A.B, m64n128k16, A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 32 || N == 64, "score products are 32 or 64 wide");
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, accumulate);
  else wgmma_ss_n64(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "gradient products are head_dim wide");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// Accumulator columns [16kk, 16kk + 16) as the A operand of a register-A
// wgmma, rounded to bf16.  A warp's accumulator element 4j + 2i + e sits at
// (row fr + 8i, column 8j + fc + e) of its 16 rows; the A fragment wants
// (fr, fc..fc+1), (fr + 8, fc..), (fr, fc + 8..), (fr + 8, fc + 8..).
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// The segment id that all 64 ids held by one warp (two a lane) share, or
// kMixedSegs.
__device__ __forceinline__ int uniform_seg(int v0, int v1) {
  const int first = __shfl_sync(0xffffffffu, v0, 0);
  return __all_sync(0xffffffffu, v0 == first && v1 == first) ? first : kMixedSegs;
}

struct MaskArgs {
  const int* seg;
  int seq, causal, window;
};

// p = exp(s * sm_scale - lse) (as exp2 of s * sm_scale * log2e - lse * log2e),
// zeroed where masked, and ds = p (dp - delta) sm_scale, in place: s becomes
// p and dp becomes ds.  Element 4j + 2i + e is (row r[i], column
// col0 + 8j + fc + e).  K3 (kRowsAreKeys false) takes lse and delta per row
// and the other segment ids per column from `col_seg`; K4 (true) takes them
// per column from the slot and its rows' segment ids from `row_seg`.
template <int R, bool kMask, bool kRowsAreKeys>
__device__ __forceinline__ void softmax_grad(float (&s)[R], float (&dp)[R], const int (&r)[2],
                                             const int (&row_seg)[2], const float (&row_lse2)[2],
                                             const float (&row_delta)[2], const float* col_lse2,
                                             const float* col_delta, const int* col_seg,
                                             int col0, int col_base, int fc, float scale_log2,
                                             float sm_scale, const MaskArgs& m) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col_base + 8 * j + fc + e;  // column within the slot or tile
      const int col = col0 + c;                 // its position in the sequence
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 4 * j + 2 * i + e;
        const float l2 = kRowsAreKeys ? col_lse2[c] : row_lse2[i];
        const float dl = kRowsAreKeys ? col_delta[c] : row_delta[i];
        bool ok = true;
        if (kMask) {
          const int qi = kRowsAreKeys ? col : r[i];
          const int kj = kRowsAreKeys ? r[i] : col;
          ok = qi < m.seq && visible(qi, kj, m.seq, m.causal, m.window) &&
               (!m.seg || col_seg[c] == row_seg[i]);
        }
        const float p = ok ? exp2f(fmaf(s[x], scale_log2, -l2)) : 0.f;
        s[x] = p;
        dp[x] = p * (dp[x] - dl) * sm_scale;
      }
    }
}

// Shared memory of K4, byte offsets from a 1024-byte-aligned base.
template <int HD>
struct DkvSmem {
  static constexpr int kTileK = 128 * HD * 2;  // K or V: 128 keys
  static constexpr int kTileQ = 64 * HD * 2;   // q or dO: 64 queries
  static constexpr int k = 0;
  static constexpr int v = kTileK;
  static constexpr int ring = 2 * kTileK;
  static constexpr int kSlot = 2 * kTileQ;     // q, then dO
  // Per slot: lse * log2e [64], delta [64], segment ids [64], the tile's
  // common segment id (or kMixedSegs), padded to 16 bytes.
  static constexpr int rows = ring + kStages * kSlot;
  static constexpr int kRowBytes = 3 * 64 * 4 + 16;
  // The keys' segment ids [128] and each warpgroup's common one [2].
  static constexpr int keys = rows + kStages * kRowBytes;
  static constexpr int bars = keys + 128 * 4 + 16;
  static constexpr int total = bars + (1 + 2 * kStages) * 8;
  static constexpr size_t alloc = total + 1024;  // room to align the base
};
static_assert(DkvSmem<128>::alloc <= 232448, "K4's ring must fit one block");

// Shared memory of K3.
template <int HD>
struct DqSmem {
  static constexpr int kTileQ = 128 * HD * 2;  // q or dO: 128 rows
  static constexpr int kTileK = 64 * HD * 2;   // K or V: 64 keys
  static constexpr int q = 0;
  static constexpr int dout = kTileQ;
  static constexpr int ring = 2 * kTileQ;
  static constexpr int kSlot = 2 * kTileK;     // K, then V
  // Per slot: the keys' segment ids [64] and their common one, padded.
  static constexpr int keys = ring + kStages * kSlot;
  static constexpr int kKeyBytes = 64 * 4 + 16;
  // The q rows' segment ids [128] and each warpgroup's common one [2].
  static constexpr int rows = keys + kStages * kKeyBytes;
  static constexpr int bars = rows + 128 * 4 + 16;
  static constexpr int total = bars + (1 + 2 * kStages) * 8;
  static constexpr size_t alloc = total + 1024;
};
static_assert(DqSmem<128>::alloc <= 232448, "K3's ring must fit one block");

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// The q tiles (64 rows) that K4's 128-key tile at k0 walks: skip tiles above
// the diagonal and past the window (attention.py:393-396 with block_k 128).
__device__ __forceinline__ void dkv_q_range(int k0, int n_qt, int causal, int window, int& lo,
                                            int& hi) {
  lo = causal ? k0 / 64 : 0;
  hi = n_qt - 1;
  if (causal && window > 0) hi = min(hi, (k0 + 127 + window - 1) / 64);
}

// The k tiles (64 keys) that the `rows` q rows from qa walk: stop past the
// diagonal, skip tiles before the window.
__device__ __forceinline__ void k_tile_range(int qa, int rows, int n_kt, int causal, int window,
                                             int& lo, int& hi) {
  lo = 0;
  hi = n_kt - 1;
  if (causal) {
    hi = min(hi, (qa + rows - 1) / 64);
    if (window > 0) {
      const int x = qa - window - 63;  // tiles starting at or before x end before the window
      lo = x < 0 ? 0 : x / 64 + 1;
    }
  }
}

// K3's and K2's 128-row q tile at q0.
__device__ __forceinline__ void dq_k_range(int q0, int n_kt, int causal, int window, int& lo,
                                           int& hi) {
  k_tile_range(q0, 128, n_kt, causal, window, lo, hi);
}

// K4, bf16, head_dim 64 or 128.  Grid (batch*kv_heads, 128-key tiles).
// QN: queries per score product (64, or 32 to bound registers).
template <int HD, int QN>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                           const float* __restrict__ delta, const int* __restrict__ seg,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int heads,
                           int kv_heads, int causal, int window, float sm_scale) {
  using L = DkvSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(base);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  int* key_seg = reinterpret_cast<int*>(base + L::keys);

  const int bk = blockIdx.x;
  const int b = bk / kv_heads;
  const int hk = bk % kv_heads;
  const int group = heads / kv_heads;
  const int k0 = blockIdx.y * 128;
  int qt_lo, qt_hi;
  dkv_q_range(k0, (seq + 63) / 64, causal, window, qt_lo, qt_hi);
  // The role is taken from lane 0's warp index, so that the compiler knows
  // each role's branch is warp-uniform: setmaxnreg and wgmma are
  // .sync.aligned, reached by whole warps.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != kProducerWarp) return;
    if (seg) {
      const int* sg = seg + (int64_t)b * seq;
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + lane + 32 * i;
        v[i] = key < seq ? sg[key] : -1;
        key_seg[lane + 32 * i] = v[i];
      }
      const int u0 = uniform_seg(v[0], v[1]);
      const int u1 = uniform_seg(v[2], v[3]);
      if (lane == 0) {
        key_seg[128] = u0;
        key_seg[129] = u1;
      }
    }
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * L::kTileK);
      tma_tile<HD>(sbase + L::k, &tm_k, kv_full, hk, k0, b, 128);
      tma_tile<HD>(sbase + L::v, &tm_v, kv_full, hk, k0, b, 128);
    } else {
      mbar_arrive(kv_full);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      const int64_t bh_row = ((int64_t)b * heads + h) * seq;
      for (int qt = qt_lo; qt <= qt_hi; ++qt) {
        const int q0 = qt * 64;
        mbar_wait(&empty[stage], phase ^ 1);
        float* lse_s = reinterpret_cast<float*>(base + L::rows + stage * L::kRowBytes);
        float* delta_s = lse_s + 64;
        int* seg_s = reinterpret_cast<int*>(delta_s + 64);
        int sv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = lane + 32 * i;
          const bool in = q0 + r < seq;
          lse_s[r] = in ? lse[bh_row + q0 + r] * kLog2e : 0.f;
          delta_s[r] = in ? delta[bh_row + q0 + r] : 0.f;
          sv[i] = in && seg ? seg[(int64_t)b * seq + q0 + r] : -1;
          seg_s[r] = sv[i];
        }
        const int u = uniform_seg(sv[0], sv[1]);
        if (lane == 0) {
          seg_s[64] = u;
          const uint32_t slot = sbase + L::ring + stage * L::kSlot;
          mbar_arrive_tx(&full[stage], L::kSlot);
          tma_tile<HD>(slot, &tm_q, &full[stage], h, q0, b, 64);
          tma_tile<HD>(slot + L::kTileQ, &tm_do, &full[stage], h, q0, b, 64);
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4;            // consumer warpgroup
    const int ka = k0 + 64 * wg;        // its first key
    const int fr = (warp % 4) * 16 + lane / 4;  // its fragment row (and row + 8)
    const int fc = 2 * (lane % 4);
    const int kr[2] = {ka + fr, ka + fr + 8};
    const MaskArgs m{seg, seq, causal, window};
    const float scale_log2 = sm_scale * kLog2e;
    const float no_row_values[2] = {0.f, 0.f};  // lse and delta come per column
    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    int kseg[2] = {0, 0};
    int kseg_common = 0;
    if (seg) {
      kseg[0] = key_seg[64 * wg + fr];
      kseg[1] = key_seg[64 * wg + fr + 8];
      kseg_common = key_seg[128 + wg];
    }
    const uint32_t k_tile = sbase + L::k;
    const uint32_t v_tile = sbase + L::v;
    int stage = 0;
    uint32_t phase = 0;
    for (int g = 0; g < group; ++g) {
      for (int qt = qt_lo; qt <= qt_hi; ++qt) {
        const int q0 = qt * 64;
        mbar_wait(&full[stage], phase);
        const uint32_t q_tile = sbase + L::ring + stage * L::kSlot;
        const uint32_t do_tile = q_tile + L::kTileQ;
        const uint64_t kd = sw128_desc(k_tile, 16), vd = sw128_desc(v_tile, 16);
        const uint64_t qd = sw128_desc(q_tile, 16), dod = sw128_desc(do_tile, 16);
        const uint64_t qd_mn = sw128_desc(q_tile, 64 * 128);
        const uint64_t dod_mn = sw128_desc(do_tile, 64 * 128);
        const float* lse_s =
            reinterpret_cast<const float*>(base + L::rows + stage * L::kRowBytes);
        const float* delta_s = lse_s + 64;
        const int* seg_s = reinterpret_cast<const int*>(delta_s + 64);
        const bool seg_whole = !seg || (seg_s[64] != kMixedSegs && seg_s[64] == kseg_common);
#pragma unroll
        for (int part = 0; part < 64 / QN; ++part) {
          const int qa = q0 + part * QN;  // this part's first query
          const int qz = qa + QN - 1;     // and last
          const bool live = ka < seq && qa < seq &&
                            (!causal || (qz >= ka && (window <= 0 || qa <= ka + 63 + window - 1)));
          if (!live) continue;
          const bool whole = seg_whole && qz < seq && ka + 63 < seq &&
                             (!causal || (ka + 63 <= qa && (window <= 0 || ka > qz - window)));
          float st[QN / 2], dpt[QN / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<QN>(st, kmajor(kd, 128, 64 * wg, kk), kmajor(qd, 64, part * QN, kk),
                         kk > 0);
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<QN>(dpt, kmajor(vd, 128, 64 * wg, kk), kmajor(dod, 64, part * QN, kk),
                         kk > 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(st);
          fence_regs(dpt);
          if (whole)
            softmax_grad<QN / 2, false, true>(st, dpt, kr, kseg, no_row_values, no_row_values,
                                              lse_s, delta_s, seg_s, q0, part * QN, fc,
                                              scale_log2, sm_scale, m);
          else
            softmax_grad<QN / 2, true, true>(st, dpt, kr, kseg, no_row_values, no_row_values,
                                             lse_s, delta_s, seg_s, q0, part * QN, fc,
                                             scale_log2, sm_scale, m);
          uint32_t ap[QN / 16][4], ads[QN / 16][4];
#pragma unroll
          for (int kk = 0; kk < QN / 16; ++kk) {
            acc_to_a(ap[kk], st, kk);
            acc_to_a(ads[kk], dpt, kk);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < QN / 16; ++kk)
            wgmma_rs<HD>(dv_acc, ap[kk], mnmajor(dod_mn, part * QN, kk));
#pragma unroll
          for (int kk = 0; kk < QN / 16; ++kk)
            wgmma_rs<HD>(dk_acc, ads[kk], mnmajor(qd_mn, part * QN, kk));
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          fence_regs(ap);
          fence_regs(ads);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kr[i] >= seq) continue;
      const int64_t off = (((int64_t)b * seq + kr[i]) * kv_heads + hk) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        store_pair(dk + off + 8 * j + fc, dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
        store_pair(dv + off + 8 * j + fc, dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// K3, bf16, head_dim 64 or 128.  Grid (batch*heads, 128-row q tiles), the
// last q tile first (under a causal mask it walks the most k tiles).
template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                          const float* __restrict__ delta, const int* __restrict__ seg,
                          bf16* __restrict__ dq, int seq, int heads, int kv_heads, int causal,
                          int window, float sm_scale) {
  using L = DqSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(base);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  int* row_seg_s = reinterpret_cast<int*>(base + L::rows);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;
  int kt_lo, kt_hi;
  dq_k_range(q0, (seq + 63) / 64, causal, window, kt_lo, kt_hi);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != kProducerWarp) return;
    if (seg) {
      const int* sg = seg + (int64_t)b * seq;
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + lane + 32 * i;
        v[i] = row < seq ? sg[row] : -1;
        row_seg_s[lane + 32 * i] = v[i];
      }
      const int u0 = uniform_seg(v[0], v[1]);
      const int u1 = uniform_seg(v[2], v[3]);
      if (lane == 0) {
        row_seg_s[128] = u0;
        row_seg_s[129] = u1;
      }
    }
    if (lane == 0) {
      mbar_arrive_tx(q_full, 2 * L::kTileQ);
      tma_tile<HD>(sbase + L::q, &tm_q, q_full, h, q0, b, 128);
      tma_tile<HD>(sbase + L::dout, &tm_do, q_full, h, q0, b, 128);
    } else {
      mbar_arrive(q_full);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      const int k0 = kt * 64;
      mbar_wait(&empty[stage], phase ^ 1);
      int* seg_s = reinterpret_cast<int*>(base + L::keys + stage * L::kKeyBytes);
      int sv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = k0 + lane + 32 * i;
        sv[i] = key < seq && seg ? seg[(int64_t)b * seq + key] : -1;
        seg_s[lane + 32 * i] = sv[i];
      }
      const int u = uniform_seg(sv[0], sv[1]);
      if (lane == 0) {
        seg_s[64] = u;
        const uint32_t slot = sbase + L::ring + stage * L::kSlot;
        mbar_arrive_tx(&full[stage], L::kSlot);
        tma_tile<HD>(slot, &tm_k, &full[stage], hk, k0, b, 64);
        tma_tile<HD>(slot + L::kTileK, &tm_v, &full[stage], hk, k0, b, 64);
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4;
    const int qa = q0 + 64 * wg;  // this warpgroup's first q row
    const int qz = qa + 63;
    const int fr = (warp % 4) * 16 + lane / 4;
    const int fc = 2 * (lane % 4);
    const int qr[2] = {qa + fr, qa + fr + 8};
    const MaskArgs m{seg, seq, causal, window};
    const float scale_log2 = sm_scale * kLog2e;
    float row_lse2[2], row_delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = qr[i] < seq;
      row_lse2[i] = in ? lse[(int64_t)bh * seq + qr[i]] * kLog2e : 0.f;
      row_delta[i] = in ? delta[(int64_t)bh * seq + qr[i]] : 0.f;
    }
    float dq_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;

    mbar_wait(q_full, 0);
    int qseg[2] = {0, 0};
    int qseg_common = 0;
    if (seg) {
      qseg[0] = row_seg_s[64 * wg + fr];
      qseg[1] = row_seg_s[64 * wg + fr + 8];
      qseg_common = row_seg_s[128 + wg];
    }
    const uint32_t q_tile = sbase + L::q;
    const uint32_t do_tile = sbase + L::dout;
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      const int ka = kt * 64;
      mbar_wait(&full[stage], phase);
      const uint32_t k_tile = sbase + L::ring + stage * L::kSlot;
      const uint32_t v_tile = k_tile + L::kTileK;
      const int* seg_s = reinterpret_cast<const int*>(base + L::keys + stage * L::kKeyBytes);
      const bool live =
          qa < seq && (!causal || (ka <= qz && (window <= 0 || ka + 63 > qa - window)));
      if (live) {
        const bool whole = (!seg || (seg_s[64] != kMixedSegs && seg_s[64] == qseg_common)) &&
                           qz < seq && ka + 63 < seq &&
                           (!causal || (ka + 63 <= qa && (window <= 0 || ka > qz - window)));
        const uint64_t qd = sw128_desc(q_tile, 16), dod = sw128_desc(do_tile, 16);
        const uint64_t kd = sw128_desc(k_tile, 16), vd = sw128_desc(v_tile, 16);
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<64>(s, kmajor(qd, 128, 64 * wg, kk), kmajor(kd, 64, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<64>(dp, kmajor(dod, 128, 64 * wg, kk), kmajor(vd, 64, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
        if (whole)
          softmax_grad<32, false, false>(s, dp, qr, qseg, row_lse2, row_delta, nullptr, nullptr,
                                         seg_s, ka, 0, fc, scale_log2, sm_scale, m);
        else
          softmax_grad<32, true, false>(s, dp, qr, qseg, row_lse2, row_delta, nullptr, nullptr,
                                        seg_s, ka, 0, fc, scale_log2, sm_scale, m);
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], dp, kk);
        const uint64_t kd_mn = sw128_desc(k_tile, 64 * 128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dq_acc, a[kk], mnmajor(kd_mn, 0, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq_acc);
        fence_regs(a);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qr[i] >= seq) continue;
      bf16* op = dq + (((int64_t)b * seq + qr[i]) * heads + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        store_pair(op + 8 * j + fc, dq_acc[4 * j + 2 * i], dq_acc[4 * j + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma forward: bf16 K2 at head_dim 64 and 128.
//
// The CTA of K3: two consumer warpgroups of 64 q rows each and a producer
// warp.  The producer loads the 128-row Q tile once, then streams the kv
// head's K and V tiles of 64 keys through the ring.  For each tile a
// warpgroup computes s = q K^T (m64n64k16, q from registers, K from shared
// memory), runs the online softmax on the accumulator layout in registers
// (row max over the 4 lanes of a row; the row sum stays a per-lane partial
// until the end), and adds o += p V with p, rounded to bf16, as the register
// A operand and V read MN-major from the slot.  o (HD / 2 float32 registers
// a thread), m and l never leave registers.  The scale is folded into exp2:
// m is kept in the log2 domain, and lse = m ln2 + ln l.  The softmax block
// is the tile's 64 keys, as in the plain forward the kernel is held to.
//
// What it is built around, in the order of what each gained on an H100 at
// batch 8, 16 heads, seq 2,047, head_dim 128: the q tile runs fastest in the
// grid, so the CTAs in flight share a few heads' K and V in L2 (with batch x
// head fastest every tile came from device memory); a ring of kFwdStages
// slots; tile j + 1's score product issued before tile j's p.v, so a
// warpgroup's exponentials run under its own products.

// Shared memory of K2, byte offsets from a 1024-byte-aligned base.
constexpr int kFwdStages = 4;  // ring depth (3 measured 6% slower on an H100)

template <int HD>
struct FwdSmem {
  static constexpr int kTileQ = 128 * HD * 2;  // q: 128 rows
  static constexpr int kTileK = 64 * HD * 2;   // K or V: 64 keys
  static constexpr int q = 0;
  static constexpr int ring = kTileQ;
  static constexpr int kSlot = 2 * kTileK;     // K, then V
  // Per slot: the keys' segment ids [64] and their common one, padded.
  static constexpr int keys = ring + kFwdStages * kSlot;
  static constexpr int kKeyBytes = 64 * 4 + 16;
  // The q rows' segment ids [128] and each warpgroup's common one [2].
  static constexpr int rows = keys + kFwdStages * kKeyBytes;
  static constexpr int bars = rows + 128 * 4 + 16;
  static constexpr int total = bars + (1 + 2 * kFwdStages) * 8;
  static constexpr size_t alloc = total + 1024;
};
static_assert(FwdSmem<128>::alloc <= 232448, "K2's ring must fit one block");

// Rows [row0 + 16w, +16) x columns [16kk, +16) of a TMA-written tile (boxes of
// `box_rows` rows x 128 bytes, 128-byte swizzle: the 16-byte chunk index of
// a row is XORed with the row's low 3 bits) as warp w's register A operand:
// (fr, fc..fc+1), (fr + 8, fc..), (fr, fc + 8..), (fr + 8, fc + 8..).
__device__ __forceinline__ void load_a_sw128(uint32_t (&a)[4], const unsigned char* tile,
                                             int box_rows, int fr, int fc, int kk) {
  const unsigned char* box = tile + (kk >> 2) * box_rows * 128;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int row = fr + 8 * (x & 1);
    const int chunk = 2 * (kk & 3) + (x >> 1);
    a[x] = *reinterpret_cast<const uint32_t*>(box + row * 128 + ((chunk ^ (row & 7)) << 4) +
                                              2 * fc);
  }
}

// 2^x in one instruction; flushes results below 2^-126 to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One 64 x 64 score tile's online-softmax step, in place: s becomes p, and
// m2 (the running max of s * scale * log2e) and l (this lane's partial row
// sums) are brought to the new max; alpha is what the caller owes o, once
// no product is writing it.  Element 4j + 2i + e of s is (row r[i], column
// ka + 8j + fc + e).
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&alpha)[2], float (&m2)[2],
                                             float (&l)[2], const int (&r)[2],
                                             const int (&row_seg)[2], const int* col_seg, int ka,
                                             int fc, float scale_log2, const MaskArgs& m) {
  // A masked tile scales and masks first and subtracts the max after, so
  // that a masked entry under a max still at -1e30 gives exp2(0), as the
  // plain version does (a later visible key wipes it: alpha is 0 then).  A
  // fully visible tile takes its max of the raw scores and folds scale and
  // max into one fused multiply-add.
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 4 * j + 2 * i + e;
        if (kMask) {
          const int c = 8 * j + fc + e;
          const bool ok = visible(r[i], ka + c, m.seq, m.causal, m.window) &&
                          (!m.seg || col_seg[c] == row_seg[i]);
          s[x] = ok ? s[x] * scale_log2 : kNegInf;
        }
        mx[i] = fmaxf(mx[i], s[x]);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float tile_max = quad_max(mx[i]);
    const float m_new = fmaxf(m2[i], kMask ? tile_max : tile_max * scale_log2);
    alpha[i] = fast_exp2(m2[i] - m_new);
    m2[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        s[x] = fast_exp2(kMask ? s[x] - m_new : fmaf(s[x], scale_log2, -m_new));
        sum += s[x];
      }
    // l sums the float32 weights; the p.v product takes them rounded to bf16.
    l[i] = l[i] * alpha[i] + sum;
  }
}

// o's rows brought to the new max.
template <int R>
__device__ __forceinline__ void rescale_rows(float (&o)[R], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= alpha[i];
      o[4 * j + 2 * i + 1] *= alpha[i];
    }
}

// K2, bf16, head_dim 64 or 128.  Grid (batch*heads, 128-row q tiles), the
// last q tile first (under a causal mask it walks the most k tiles).
template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
                       bf16* __restrict__ out, float* __restrict__ lse, int seq, int heads,
                       int kv_heads, int causal, int window, float sm_scale) {
  using L = FwdSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(base);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kFwdStages;
  int* row_seg_s = reinterpret_cast<int*>(base + L::rows);

  // The q tile runs fastest in the grid, so that the CTAs in flight walk the
  // K and V of a few heads and find them in L2.
  const int n_qt = (seq + 127) / 128;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / heads;
  const int h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * 128;
  int kt_lo, kt_hi;
  dq_k_range(q0, (seq + 63) / 64, causal, window, kt_lo, kt_hi);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 32);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != kProducerWarp) return;
    if (seg) {
      const int* sg = seg + (int64_t)b * seq;
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + lane + 32 * i;
        v[i] = row < seq ? sg[row] : -1;
        row_seg_s[lane + 32 * i] = v[i];
      }
      const int u0 = uniform_seg(v[0], v[1]);
      const int u1 = uniform_seg(v[2], v[3]);
      if (lane == 0) {
        row_seg_s[128] = u0;
        row_seg_s[129] = u1;
      }
    }
    if (lane == 0) {
      mbar_arrive_tx(q_full, L::kTileQ);
      tma_tile<HD>(sbase + L::q, &tm_q, q_full, h, q0, b, 128);
    } else {
      mbar_arrive(q_full);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      const int k0 = kt * 64;
      mbar_wait(&empty[stage], phase ^ 1);
      int* seg_s = reinterpret_cast<int*>(base + L::keys + stage * L::kKeyBytes);
      int sv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = k0 + lane + 32 * i;
        sv[i] = key < seq && seg ? seg[(int64_t)b * seq + key] : -1;
        seg_s[lane + 32 * i] = sv[i];
      }
      const int u = uniform_seg(sv[0], sv[1]);
      if (lane == 0) {
        seg_s[64] = u;
        const uint32_t slot = sbase + L::ring + stage * L::kSlot;
        mbar_arrive_tx(&full[stage], L::kSlot);
        tma_tile<HD>(slot, &tm_k, &full[stage], hk, k0, b, 64);
        tma_tile<HD>(slot + L::kTileK, &tm_v, &full[stage], hk, k0, b, 64);
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == kFwdStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4;
    const int qa = q0 + 64 * wg;  // this warpgroup's first q row
    const int qz = qa + 63;
    const int fr = (warp % 4) * 16 + lane / 4;
    const int fc = 2 * (lane % 4);
    const int qr[2] = {qa + fr, qa + fr + 8};
    const MaskArgs m{seg, seq, causal, window};
    const float scale_log2 = sm_scale * kLog2e;
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    int qseg[2] = {0, 0};
    int qseg_common = 0;
    if (seg) {
      qseg[0] = row_seg_s[64 * wg + fr];
      qseg[1] = row_seg_s[64 * wg + fr + 8];
      qseg_common = row_seg_s[128 + wg];
    }
    // This warpgroup's q rows as register A operands, HD / 16 fragments:
    // with q in shared memory too, an m64n64k16 score product would read
    // 4 KB for 32 clocks of tensor-core work, all an SM's shared memory gives.
    uint32_t qa_frag[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      load_a_sw128(qa_frag[kk], base + L::q, 128, 64 * wg + fr, fc, kk);
    // This warpgroup's own live tiles [wlo, whi] of the CTA's walk; the
    // tiles outside are exact no-ops for its rows and are only released.
    int wlo, whi;
    k_tile_range(qa, 64, (seq + 63) / 64, causal, window, wlo, whi);
    wlo = max(wlo, kt_lo);
    whi = qa < seq ? min(whi, kt_hi) : wlo - 1;
    int stage = 0;
    uint32_t phase = 0;
    auto release = [&]() {  // hand the slot back and move to the next
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kFwdStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    auto k_desc = [&]() { return sw128_desc(sbase + L::ring + stage * L::kSlot, 16); };
    auto v_desc = [&]() {
      return sw128_desc(sbase + L::ring + stage * L::kSlot + L::kTileK, 64 * 128);
    };
    // s = q K^T of the tile in this slot; the caller commits.
    auto issue_scores = [&](float (&s)[32]) {
      const uint64_t kd = k_desc();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_rs_kmajor_n64(s, qa_frag[kk], kmajor(kd, 64, 0, kk), kk > 0);
    };
    // The softmax step of tile kt, whose keys' segment ids are in this slot.
    auto softmax = [&](float (&s)[32], float (&alpha)[2], int kt) {
      const int ka = kt * 64;
      const int* seg_s = reinterpret_cast<const int*>(base + L::keys + stage * L::kKeyBytes);
      // Rows past seq are never written, so only the keys' end counts.
      const bool whole = (!seg || (seg_s[64] != kMixedSegs && seg_s[64] == qseg_common)) &&
                         ka + 63 < seq &&
                         (!causal || (ka + 63 <= qa && (window <= 0 || ka > qz - window)));
      if (whole)
        softmax_tile<false>(s, alpha, m2, l, qr, qseg, seg_s, ka, fc, scale_log2, m);
      else
        softmax_tile<true>(s, alpha, m2, l, qr, qseg, seg_s, ka, fc, scale_log2, m);
    };

    int kt = kt_lo;
    for (; kt < wlo && kt <= kt_hi; ++kt) {
      mbar_wait(&full[stage], phase);
      release();
    }
    if (wlo <= whi) {
      // Tile j + 1's score product is issued before tile j's p.v, and its
      // softmax runs while p.v does: the exponentials of one tile hide
      // under the tensor cores' work on the other.  Every issue is on the
      // one path through the loop.
      float s[32], alpha[2];
      uint32_t a[4][4];
      mbar_wait(&full[stage], phase);
      wgmma_fence();
      issue_scores(s);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      softmax(s, alpha, kt);  // o is still zero: alpha is owed nothing
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
      for (; kt < whi; ++kt) {
        const uint64_t vd = v_desc();  // tile kt's V, in the slot still held
        const int held = stage;
        int next = stage + 1;
        uint32_t next_phase = phase;
        if (next == kFwdStages) {
          next = 0;
          next_phase ^= 1;
        }
        mbar_wait(&full[next], next_phase);
        stage = next;
        fence_regs(o);
        fence_regs(a);
        wgmma_fence();
        issue_scores(s);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(o, a[kk], mnmajor(vd, 0, kk));
        wgmma_commit();
        wgmma_wait_but_one();
        fence_regs(s);
        softmax(s, alpha, kt + 1);
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(a);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[held]);
        phase = next_phase;
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) rescale_rows(o, alpha);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], s, kk);
      }
      const uint64_t vd = v_desc();
      fence_regs(o);
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(o, a[kk], mnmajor(vd, 0, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(a);
      release();
      ++kt;
    }
    for (; kt <= kt_hi; ++kt) {
      mbar_wait(&full[stage], phase);
      release();
    }

    // l_safe as attention.py:131: a row with l == 0 writes 0 and lse -1e30.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l_row = quad_sum(l[i]);
      if (qr[i] >= seq) continue;
      const float l_safe = l_row > 0.f ? l_row : 1.f;
      const float inv = 1.f / l_safe;
      bf16* op = out + (((int64_t)b * seq + qr[i]) * heads + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        store_pair(op + 8 * j + fc, o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      if (lane % 4 == 0)
        lse[(int64_t)bh * seq + qr[i]] =
            l_row > 0.f ? m2[i] * kLn2 + logf(l_row) : kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const int* seg;
  void* out0;  // out | dq | dk
  void* out1;  // lse | -  | dv
  int batch, seq, heads, kv_heads, causal, window;
  float sm_scale;
  cudaStream_t stream;
};

// One launch of `kernel` over `grid` with `threads` and `smem` bytes.
template <typename T, typename Kernel>
cudaError_t launch_fwd(Kernel kernel, int threads, size_t smem, const Args& a) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.batch * a.heads, (a.seq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.seg,
      static_cast<T*>(a.out0), static_cast<float*>(a.out1), a.seq, a.heads, a.kv_heads,
      a.causal, a.window, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, typename Kernel>
cudaError_t launch_dq(Kernel kernel, int threads, size_t smem, const Args& a) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.batch * a.heads, (a.seq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, a.seg, static_cast<T*>(a.out0), a.seq,
      a.heads, a.kv_heads, a.causal, a.window, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, typename Kernel>
cudaError_t launch_dkv(Kernel kernel, int threads, size_t smem, const Args& a) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.batch * a.kv_heads, (a.seq + kBlockK - 1) / kBlockK);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse_in, a.delta, a.seg, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.seq, a.heads, a.kv_heads, a.causal, a.window, a.sm_scale);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (cudaGetDriverEntryPoint), so that the library links no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A TMA map over a contiguous bf16 [batch, seq, n_heads, HD] tensor: boxes of
// 64 columns by `rows` rows of one head, 128-byte swizzle, rows past seq read
// as zeros.  The base must be 16-byte aligned (the wrapper's _operand).
template <int HD>
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, int batch, int seq, int n_heads,
                     int rows) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)n_heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)n_heads * HD * 2,
                                 (cuuint64_t)seq * n_heads * HD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Queries per K4 score product.  At head_dim 128 the dk and dv accumulators
// take 128 of a consumer's 232 registers, and a 64-wide pair of score blocks
// spills (28 bytes, ptxas); 32-wide parts do not, at the same speed.
template <int HD>
constexpr int dkv_qn() {
  return HD == 128 ? 32 : 64;
}

// K4 on wgmma: q and dO in 64-row boxes, K and V in 128-row boxes.
template <int HD>
cudaError_t launch_dkv_wgmma(const Args& a) {
  CUtensorMap mq, mdo, mk, mv;
  cudaError_t err;
  if ((err = bf16_map<HD>(&mq, a.q, a.batch, a.seq, a.heads, 64)) != cudaSuccess ||
      (err = bf16_map<HD>(&mdo, a.dout, a.batch, a.seq, a.heads, 64)) != cudaSuccess ||
      (err = bf16_map<HD>(&mk, a.k, a.batch, a.seq, a.kv_heads, 128)) != cudaSuccess ||
      (err = bf16_map<HD>(&mv, a.v, a.batch, a.seq, a.kv_heads, 128)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_dkv_wgmma_kernel<HD, dkv_qn<HD>()>;
  if ((err = allow_smem(kernel, DkvSmem<HD>::alloc)) != cudaSuccess) return err;
  dim3 grid(a.batch * a.kv_heads, (a.seq + 127) / 128);
  kernel<<<grid, kWsThreads, DkvSmem<HD>::alloc, a.stream>>>(
      mq, mdo, mk, mv, a.lse_in, a.delta, a.seg, static_cast<bf16*>(a.out0),
      static_cast<bf16*>(a.out1), a.seq, a.heads, a.kv_heads, a.causal, a.window, a.sm_scale);
  return cudaGetLastError();
}

// K3 on wgmma: q and dO in 128-row boxes, K and V in 64-row boxes.
template <int HD>
cudaError_t launch_dq_wgmma(const Args& a) {
  CUtensorMap mq, mdo, mk, mv;
  cudaError_t err;
  if ((err = bf16_map<HD>(&mq, a.q, a.batch, a.seq, a.heads, 128)) != cudaSuccess ||
      (err = bf16_map<HD>(&mdo, a.dout, a.batch, a.seq, a.heads, 128)) != cudaSuccess ||
      (err = bf16_map<HD>(&mk, a.k, a.batch, a.seq, a.kv_heads, 64)) != cudaSuccess ||
      (err = bf16_map<HD>(&mv, a.v, a.batch, a.seq, a.kv_heads, 64)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_dq_wgmma_kernel<HD>;
  if ((err = allow_smem(kernel, DqSmem<HD>::alloc)) != cudaSuccess) return err;
  dim3 grid(a.batch * a.heads, (a.seq + 127) / 128);
  kernel<<<grid, kWsThreads, DqSmem<HD>::alloc, a.stream>>>(
      mq, mdo, mk, mv, a.lse_in, a.delta, a.seg, static_cast<bf16*>(a.out0), a.seq, a.heads,
      a.kv_heads, a.causal, a.window, a.sm_scale);
  return cudaGetLastError();
}

// K2 on wgmma: q in 128-row boxes, K and V in 64-row boxes.
template <int HD>
cudaError_t launch_fwd_wgmma(const Args& a) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = bf16_map<HD>(&mq, a.q, a.batch, a.seq, a.heads, 128)) != cudaSuccess ||
      (err = bf16_map<HD>(&mk, a.k, a.batch, a.seq, a.kv_heads, 64)) != cudaSuccess ||
      (err = bf16_map<HD>(&mv, a.v, a.batch, a.seq, a.kv_heads, 64)) != cudaSuccess)
    return err;
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  if ((err = allow_smem(kernel, FwdSmem<HD>::alloc)) != cudaSuccess) return err;
  dim3 grid(a.batch * a.heads * ((a.seq + 127) / 128));
  kernel<<<grid, kWsThreads, FwdSmem<HD>::alloc, a.stream>>>(
      mq, mk, mv, a.seg, static_cast<bf16*>(a.out0), static_cast<float*>(a.out1), a.seq,
      a.heads, a.kv_heads, a.causal, a.window, a.sm_scale);
  return cudaGetLastError();
}

// which: 0 = K2 forward, 1 = K3 dq, 2 = K4 dk/dv; dtype: 0 = float32, 1 = bf16.
// The bf16 kernels take wgmma at head_dim 64 and 128 and mma.sync below.
template <int HD>
cudaError_t launch(int which, int dtype, const Args& a) {
  if (dtype == 0) {
    if (which == 0)
      return launch_fwd<float>(flash_fwd_f32_kernel<HD>, kThreads, fwd_f32_smem_bytes<HD>(), a);
    if (which == 1)
      return launch_dq<float>(flash_bwd_dq_f32_kernel<HD>, kThreads, dq_f32_smem_bytes<HD>(), a);
    if (which == 2)
      return launch_dkv<float>(flash_bwd_dkv_f32_kernel<HD>, kThreads, dkv_f32_smem_bytes<HD>(),
                               a);
  } else if (dtype == 1) {
    if constexpr (HD >= 64) {
      if (which == 0) return launch_fwd_wgmma<HD>(a);
      if (which == 1) return launch_dq_wgmma<HD>(a);
      if (which == 2) return launch_dkv_wgmma<HD>(a);
    } else {
      if (which == 0)
        return launch_fwd<bf16>(flash_fwd_bf16_kernel<HD>, kMmaThreads,
                                fwd_bf16_smem_bytes<HD>(), a);
      if (which == 1)
        return launch_dq<bf16>(flash_bwd_dq_bf16_kernel<HD>, kMmaThreads,
                               bwd_bf16_smem_bytes<HD>(), a);
      if (which == 2)
        return launch_dkv<bf16>(flash_bwd_dkv_bf16_kernel<HD>, kMmaThreads,
                                bwd_bf16_smem_bytes<HD>(), a);
    }
  }
  return cudaErrorInvalidValue;
}

int run(int which, int dtype, int head_dim, const Args& a) {
  switch (head_dim) {
    case 16:
      return launch<16>(which, dtype, a);
    case 32:
      return launch<32>(which, dtype, a);
    case 64:
      return launch<64>(which, dtype, a);
    case 128:
      return launch<128>(which, dtype, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  causal: 0 or 1.  window <= 0 means no
// window.  seg may be null (no segment_ids).  Every tensor is contiguous:
// q, out, dout, dq [batch, seq, heads, head_dim]; k, v, dk, dv
// [batch, seq, kv_heads, head_dim]; lse, delta [batch*heads, seq] float32;
// seg [batch, seq] int32.  Each returns cudaGetLastError() after its launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* seg, void* out,
                        void* lse, int dtype, int batch, int seq, int heads, int kv_heads,
                        int head_dim, int causal, int window, float sm_scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, static_cast<const int*>(seg), out, lse,
         batch, seq, heads, kv_heads, causal, window, sm_scale,
         static_cast<cudaStream_t>(stream)};
  return run(0, dtype, head_dim, a);
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* seg, void* dq,
                           int dtype, int batch, int seq, int heads, int kv_heads, int head_dim,
                           int causal, int window, float sm_scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int*>(seg), dq, nullptr, batch, seq, heads, kv_heads, causal,
         window, sm_scale, static_cast<cudaStream_t>(stream)};
  return run(1, dtype, head_dim, a);
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* seg, void* dk,
                            void* dv, int dtype, int batch, int seq, int heads, int kv_heads,
                            int head_dim, int causal, int window, float sm_scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int*>(seg), dk, dv, batch, seq, heads, kv_heads, causal, window,
         sm_scale, static_cast<cudaStream_t>(stream)};
  return run(2, dtype, head_dim, a);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
