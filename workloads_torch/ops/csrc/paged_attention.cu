// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel workloads/ops/paged_attention.py::_paged_decode_kernel.
// It computes the same function: one query token per batch row attends over
// that row's KV history, stored in fixed-size pages of a pool
// [layers, pages, kv_heads, page_size, head_dim] and mapped by a block table
// [batch, max_pages]; per-row lengths, an optional sliding window, grouped-query
// heads, a float32 online softmax whose weights are rounded to the value
// dtype before the p.v product (as the Pallas kernel's p.astype(v.dtype)),
// and zeros for a length-0 row.
//
// What bounds it: bytes.  A decode step does ~4 flops per K/V byte it reads,
// far below the ~295 flops/byte at which an H100's tensor cores become the
// limit, so its floor is the live K/V pages' bytes over device-memory
// bandwidth.  The design reads each live (page, kv head) tile exactly once:
//   * one CTA per (batch row, kv head) holds the whole GQA group's queries in
//     registers, so each K/V tile feeds every query head that shares it;
//   * the CTA walks only the row's live pages, from the window start (or 0) to
//     the page holding position length-1 -- dead pages are neither read nor
//     computed (the Pallas kernel's clamped index map, as a loop bound);
//   * a (page, kv head) tile is page_size*head_dim contiguous elements in the
//     pool layout, so the CTA copies it to shared memory with 16-byte loads,
//     neighbouring threads on neighbouring addresses.
// Left for later work: splitting a long row's page walk across CTAs (split-K)
// to fill the card at small batch, and overlapping the next page's copy with
// this page's math (cp.async / TMA).
//
// Offsets into the pool are 64-bit: a full-width pool passes 2^31 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;      // query heads per kv head
constexpr float kNegInf = -1e30f; // the JAX package's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// v rounded to T and back: the Pallas kernel casts its softmax weights to
// the value dtype before the p.v product.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Shared memory: the K and V tiles of one (page, kv head) in the input type,
// then float32 scores [kMaxGroup][page_size], then m, l, alpha [kMaxGroup].
template <typename T>
size_t smem_bytes(int page_size, int head_dim) {
  return 2 * sizeof(T) * (size_t)page_size * head_dim +
         sizeof(float) * ((size_t)kMaxGroup * page_size + 3 * kMaxGroup);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int heads,
                    int kv_heads, int page_size, int n_pages, int max_pages, int layer,
                    int window, float sm_scale) {
  constexpr int kDimPerLane = (HD + 31) / 32;
  constexpr int kPairsPerThread = (kMaxGroup * HD + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int group = heads / kv_heads;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = page_size * HD;

  T* k_tile = reinterpret_cast<T*>(smem_raw);
  T* v_tile = k_tile + tile;
  float* scores = reinterpret_cast<float*>(v_tile + tile);
  float* m_s = scores + kMaxGroup * page_size;
  float* l_s = m_s + kMaxGroup;
  float* alpha_s = l_s + kMaxGroup;

  // The group's queries, split over lanes by head_dim: lane holds dims
  // lane, lane+32, ...
  const T* q_grp = q + ((int64_t)b * heads + (int64_t)h * group) * HD;
  float qreg[kMaxGroup][kDimPerLane];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) {
      const int d = lane + 32 * i;
      qreg[g][i] = (g < group && d < HD) ? to_f32(q_grp[g * HD + d]) : 0.f;
    }
  }
  float acc[kPairsPerThread];
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) acc[k] = 0.f;
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int length = lengths[b];
  int first = 0;
  if (window > 0) first = max(length - window, 0) / page_size;
  const int last = length > 0 ? min((length - 1) / page_size, max_pages - 1) : -1;
  const int n_vec = tile * (int)sizeof(T) / 16;

  for (int j = first; j <= last; ++j) {
    // A table entry outside the pool would fault; clamp it (live rows
    // always hold real pages, parked rows the trash page).
    const int page = min(max(tables[(int64_t)b * max_pages + j], 0), n_pages - 1);
    const int64_t base = (((int64_t)layer * n_pages + page) * kv_heads + h) * tile;
    __syncthreads();  // the previous page's readers are done with the tiles
    const uint4* k_src = reinterpret_cast<const uint4*>(k_pool + base);
    const uint4* v_src = reinterpret_cast<const uint4*>(v_pool + base);
    uint4* k_dst = reinterpret_cast<uint4*>(k_tile);
    uint4* v_dst = reinterpret_cast<uint4*>(v_tile);
    for (int i = tid; i < n_vec; i += kThreads) {
      k_dst[i] = k_src[i];
      v_dst[i] = v_src[i];
    }
    __syncthreads();

    // Scores: one warp per key, lanes split head_dim, one sum per query head.
    for (int t = warp; t < page_size; t += kWarps) {
      const T* krow = k_tile + t * HD;
      float kv[kDimPerLane];
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) {
        const int d = lane + 32 * i;
        kv[i] = d < HD ? to_f32(krow[d]) : 0.f;
      }
      const int pos = j * page_size + t;
      const bool valid = pos < length && (window <= 0 || pos >= length - window);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < kDimPerLane; ++i) dot += qreg[g][i] * kv[i];
          dot = warp_sum(dot);
          if (lane == 0) scores[g * page_size + t] = valid ? dot * sm_scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online-softmax update, one warp per query head.  Every walked page
    // holds at least one visible position, so m_new is finite.
    for (int g = warp; g < group; g += kWarps) {
      float* s = scores + g * page_size;
      float mx = kNegInf;
      for (int t = lane; t < page_size; t += 32) mx = fmaxf(mx, s[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      // l sums the float32 weights; the p.v product takes them rounded to
      // the value dtype, as the Pallas kernel does.
      float sum = 0.f;
      for (int t = lane; t < page_size; t += 32) {
        const float p = s[t] == kNegInf ? 0.f : expf(s[t] - m_new);
        s[t] = round_to(p, v_tile);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha + sum_t p[g, t] * v[t, d]; thread owns the
    // (g, d) pairs tid, tid + 128, ...
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < group * HD) {
        const int g = idx / HD;
        const int d = idx % HD;
        const float* p = scores + g * page_size;
        float a = acc[k] * alpha_s[g];
        for (int t = 0; t < page_size; ++t) a += p[t] * to_f32(v_tile[t * HD + d]);
        acc[k] = a;
      }
    }
  }

  // acc / l; a row that walked no page (length 0) has l == 0 and writes 0.
  T* o_grp = out + ((int64_t)b * heads + (int64_t)h * group) * HD;
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < group * HD) {
      const int g = idx / HD;
      const float l = l_s[g];
      store(o_grp + idx, acc[k] / (l > 0.f ? l : 1.f));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                   const int* lengths, void* out, int batch, int heads, int kv_heads,
                   int page_size, int n_pages, int max_pages, int layer, int window,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(page_size, HD);
  auto kernel = paged_decode_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(batch, kv_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lengths, static_cast<T*>(out), heads, kv_heads, page_size, n_pages, max_pages,
      layer, window, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int head_dim, const void* q, const void* k_pool, const void* v_pool,
                        const int* tables, const int* lengths, void* out, int batch,
                        int heads, int kv_heads, int page_size, int n_pages, int max_pages,
                        int layer, int window, float sm_scale, cudaStream_t stream) {
#define PA_CASE(HD)                                                                      \
  case HD:                                                                               \
    return launch<T, HD>(q, k_pool, v_pool, tables, lengths, out, batch, heads, kv_heads, \
                         page_size, n_pages, max_pages, layer, window, sm_scale, stream);
  switch (head_dim) {
    PA_CASE(16)
    PA_CASE(32)
    PA_CASE(64)
    PA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PA_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns cudaGetLastError() after the launch (0 on success).
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const void* tables, const void* lengths, void* out, int dtype,
                        int batch, int heads, int kv_heads, int head_dim, int page_size,
                        int n_pages, int max_pages, int layer, int window, float sm_scale,
                        void* stream) {
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(head_dim, q, k_pool, v_pool, t, l, out, batch, heads, kv_heads,
                              page_size, n_pages, max_pages, layer, window, sm_scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(head_dim, q, k_pool, v_pool, t, l, out, batch, heads,
                                      kv_heads, page_size, n_pages, max_pages, layer, window,
                                      sm_scale, s);
  return cudaErrorInvalidValue;
}

// Shared memory one launch needs, so the wrapper can refuse a shape the card
// cannot hold before launching it.
long long paged_attention_smem_bytes(int dtype, int page_size, int head_dim) {
  return dtype == 0 ? (long long)smem_bytes<float>(page_size, head_dim)
                    : (long long)smem_bytes<__nv_bfloat16>(page_size, head_dim);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
