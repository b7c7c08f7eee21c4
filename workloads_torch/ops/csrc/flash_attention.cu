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
// Each kernel comes in two versions, picked by the input dtype:
//   * bfloat16 (the training path): warp-level mma.sync m16n8k16 tensor-core
//     products, bf16 operands and float32 accumulators.  A CTA is 4 warps;
//     each warp owns 16 rows of a 64-row tile.  Tiles are staged in shared
//     memory with 16-byte loads into rows padded by 8 elements (16 bytes), so
//     ldmatrix reads them without bank conflicts.  The rounding of p and ds
//     to bf16 is the conversion of the score fragments into the next
//     product's operand;
//   * float32: float32 FMAs on CUDA cores from padded shared-memory tiles
//     (tensor cores would round the operands to TF32).  256 threads; each
//     thread owns a 4x4 block of a 64x64 score tile (rows ty*4+i, columns
//     tx+16j) and a 4 x (head_dim/16) block of the output tile.
// The design shared by both:
//   * K2 and K3: one CTA per (batch*head, 64-row q tile); the k/v walk is a
//     loop inside the CTA (the Pallas grid's sequential axis), with the
//     online-softmax state (m, l) and the output accumulator in registers;
//   * K4: one CTA per (batch*kv_head, 64-row k tile), looping over every
//     (group member, q tile) pair, so a grouped-query group's dk/dv sum is
//     taken inside the CTA in the Pallas kernel's order -- no atomics, and the
//     gradients are deterministic;
//   * fully masked tiles are skipped: k tiles past the diagonal or before the
//     window (K2, K3: attention.py:120-122), q tiles above the diagonal or
//     past the window (K4: attention.py:393-396);
//   * every load and store is bounded by seq (2047 is not a multiple of the
//     tile), and every tensor offset is 64-bit.
// Left for later work: wgmma, TMA or cp.async staging with loads overlapped
// with math, and warp specialisation.

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

// which: 0 = K2 forward, 1 = K3 dq, 2 = K4 dk/dv; dtype: 0 = float32, 1 = bf16.
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
    if (which == 0)
      return launch_fwd<bf16>(flash_fwd_bf16_kernel<HD>, kMmaThreads, fwd_bf16_smem_bytes<HD>(),
                              a);
    if (which == 1)
      return launch_dq<bf16>(flash_bwd_dq_bf16_kernel<HD>, kMmaThreads,
                             bwd_bf16_smem_bytes<HD>(), a);
    if (which == 2)
      return launch_dkv<bf16>(flash_bwd_dkv_bf16_kernel<HD>, kMmaThreads,
                              bwd_bf16_smem_bytes<HD>(), a);
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
