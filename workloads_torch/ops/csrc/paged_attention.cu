// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel workloads/ops/paged_attention.py::_paged_decode_kernel.
// It computes the same function: one query token per batch row attends over
// that row's KV history, stored in fixed-size pages of a pool
// [layers, pages, kv_heads, page_size, head_dim] and mapped by a block table
// [batch, max_pages]; per-row lengths, an optional sliding window, grouped-query
// heads, a float32 online softmax whose weights are rounded to the value
// dtype before the p.v product (as the Pallas kernel's p.astype(v.dtype))
// while l sums them unrounded, and zeros for a length-0 row.
//
// What bounds it: bytes.  A decode step does ~4 flops per K/V byte it reads,
// far below the ~295 flops/byte at which an H100's tensor cores become the
// limit, so its floor is the live K/V pages' bytes over device-memory
// bandwidth.  The design reads each live (page, kv head) tile exactly once
// and keeps many tiles in flight:
//   * grid (batch row, kv head, split): a row's live pages, from the window
//     start (or 0) to the page holding position length-1, are cut into
//     `splits` contiguous shares, one CTA each, so a small batch still
//     fills the card.  The host picks `splits` from shapes alone;
//   * a (page, kv head) tile is page_size*head_dim contiguous elements of the
//     pool, so it needs no tensor map: a producer warp copies K and V tiles
//     with 1-D bulk copies (cp.async.bulk) into a ring of `stages` slots,
//     each with a `full` and an `empty` mbarrier, and the next pages are in
//     flight while one is computed;
//   * four consumer warps share each page: a group of head_dim/DPL lanes owns
//     one key at a time and DPL dims of it, with the GQA group's queries for
//     those dims in registers.  A page takes two passes and one barrier of
//     the four warps between them: scores (reduced over the lanes of a key)
//     to shared memory with each warp's max; then every warp takes the
//     page's max, so p is rounded against the same running max as in the
//     plain version, and each lane group adds p and p.v of its own keys to
//     its own l and acc.  Since all share one m, these partial sums simply
//     add up at the end: over a warp's key groups by shuffles, over the
//     warps through shared memory;
//   * with more than one split each CTA writes its (m, l, acc) to a float32
//     workspace [batch, heads, splits, head_dim + 2]: the last CTA of a
//     (row, kv head) to finish (a ticket taken with atomicAdd after
//     __threadfence) merges them in split order, not arrival order, each
//     weighed by exp(m - max m), so repeats are bit-identical, and sets the
//     ticket back to 0.  It is one launch a call.  With one split the CTA
//     writes `out` itself.  A share with nothing visible is (-1e30, 0, 0),
//     so empty shares and length-0 rows fall out as zeros.
//
// Offsets into the pool are 64-bit: a full-width pool passes 2^31 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kProducerWarp = kConsumerWarps;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kMaxGroup = 8;       // query heads per kv head
constexpr int kMaxStages = 8;      // ring depth the barrier array allows
constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// v rounded to T and back: the Pallas kernel casts its softmax weights to
// the value dtype before the p.v product.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// 16 bytes at p (16-byte aligned, shared or global) as float32 values.
__device__ __forceinline__ void load_vec(float* f, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
}
__device__ __forceinline__ void load_vec(float* f, const __nv_bfloat16* p) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completes on `bar` by its byte count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Dims one lane owns of each key: 16, or 8 where the group's queries and
// accumulators would not fit the registers.
__host__ __device__ constexpr int dims_per_lane(int group) { return group > 4 ? 8 : 16; }

// Shared memory: the ring (K then V tile a slot), each consumer warp's
// partial (acc[HD], m, l) per query head, a page's scores, the warps' maxes
// of two pages, the barriers, the ticket.
size_t smem_bytes(size_t elt, int page_size, int head_dim, int group, int stages) {
  return (size_t)stages * 2 * elt * page_size * head_dim +
         sizeof(float) * group *
             (kConsumerWarps * (head_dim + 2) + ((page_size + 3) & ~3) + 2 * kConsumerWarps) +
         2 * kMaxStages * 8 + 16;
}

// The template group: the smallest of 1, 2, 4, 8 that holds `group`.
int group_bucket(int group) { return group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : 8; }

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* lengths;
  void* out;
  float* workspace;  // [batch, heads, splits, HD + 2]: acc, m, l; unused with one split
  int* tickets;      // [batch, kv_heads], zero between launches
  int heads, kv_heads, page_size, n_pages, max_pages, layer, window, splits, stages;
  float sm_scale;
};

// Merges n partials (m_i, l_i, a_i) in index order into (m, l, a), m the
// largest m_i and each partial weighed by exp(m_i - m).
template <typename F>
__device__ __forceinline__ void merge_parts(int n, F part, float& m, float& l, float& a) {
  m = kNegInf;
  for (int i = 0; i < n; ++i) {
    float mi, li, ai;
    part(i, mi, li, ai);
    m = fmaxf(m, mi);
  }
  l = 0.f, a = 0.f;
  for (int i = 0; i < n; ++i) {
    float mi, li, ai;
    part(i, mi, li, ai);
    const float w = expf(mi - m);
    l += li * w;
    a += ai * w;
  }
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Params p) {
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte load
  constexpr int DPL = dims_per_lane(G);      // dims a lane owns
  constexpr int NC = DPL / kVec;             // 16-byte loads a lane makes per key
  constexpr int LPK = HD / DPL;              // lanes per key
  constexpr int KPI = 32 / LPK;              // keys a warp takes at a time
  constexpr int kPart = HD + 2;              // acc[HD], m, l
  static_assert(DPL % kVec == 0 && HD % DPL == 0 && LPK <= 32, "lane layout");
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int group = p.heads / p.kv_heads;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int page_size = p.page_size;
  const int tile = page_size * HD;
  const uint32_t tile_bytes = (uint32_t)tile * sizeof(T);

  T* ring = reinterpret_cast<T*>(smem_raw);
  float* parts = reinterpret_cast<float*>(ring + (size_t)p.stages * 2 * tile);
  float* scores = parts + kConsumerWarps * G * kPart;  // [G][page_size]
  float* maxes = scores + G * ((page_size + 3) & ~3);  // [2][warps][G]: pages alternate
  uint64_t* full = reinterpret_cast<uint64_t*>(maxes + 2 * kConsumerWarps * G);
  uint64_t* empty = full + kMaxStages;
  int* ticket_s = reinterpret_cast<int*>(empty + kMaxStages);

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // This split's share [lo, hi] of the row's live pages [first, last].
  const int length = p.lengths[b];
  int first = 0;
  if (p.window > 0) first = max(length - p.window, 0) / page_size;
  const int last = length > 0 ? min((length - 1) / page_size, p.max_pages - 1) : -1;
  const int per = max((last - first + 1 + p.splits - 1) / p.splits, 0);
  const int lo = first + split * per;
  const int hi = min(lo + per - 1, last);

  if (warp == kProducerWarp) {
    const T* k_pool = static_cast<const T*>(p.k_pool);
    const T* v_pool = static_cast<const T*>(p.v_pool);
    int stage = 0;
    uint32_t phase = 0;
    for (int c0 = lo; c0 <= hi; c0 += 32) {
      // 32 table entries at a time, one a lane, so no copy waits for a
      // dependent load of its own.
      const int mine = c0 + lane <= hi ? p.tables[(int64_t)b * p.max_pages + c0 + lane] : 0;
      const int n = min(32, hi - c0 + 1);
      for (int i = 0; i < n; ++i) {
        // A table entry outside the pool would fault; clamp it (live rows
        // always hold real pages, parked rows the trash page).
        const int page = min(max(__shfl_sync(0xffffffffu, mine, i), 0), p.n_pages - 1);
        if (lane == 0) {
          const int64_t base = (((int64_t)p.layer * p.n_pages + page) * p.kv_heads + h) * tile;
          mbar_wait(&empty[stage], phase ^ 1);
          T* slot = ring + (size_t)stage * 2 * tile;
          mbar_arrive_tx(&full[stage], 2 * tile_bytes);
          bulk_copy(slot, k_pool + base, tile_bytes, &full[stage]);
          bulk_copy(slot + tile, v_pool + base, tile_bytes, &full[stage]);
        }
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    const int sub = lane % LPK;  // which dims of a key
    const int kg = lane / LPK;   // which key of the warp's KPI
    // The group's queries for this lane's dims: chunk c holds dims
    // (c * LPK + sub) * kVec ..., so neighbouring lanes load neighbouring
    // 16 bytes of a key.
    const T* q_grp = static_cast<const T*>(p.q) + ((int64_t)b * p.heads + (int64_t)h * group) * HD;
    float qf[G][DPL], acc[G][DPL], m[G], l[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) qf[g][i] = acc[g][i] = 0.f;
      if (g < group) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          load_vec(&qf[g][c * kVec], q_grp + g * HD + (c * LPK + sub) * kVec);
      }
    }

    int stage = 0;
    uint32_t phase = 0;
    for (int j = lo; j <= hi; ++j) {
      mbar_wait(&full[stage], phase);
      const T* k_tile = ring + (size_t)stage * 2 * tile;
      const T* v_tile = k_tile + tile;

      // Scores of this warp's keys, to shared memory, and their max.
      float warp_max[G];
#pragma unroll
      for (int g = 0; g < G; ++g) warp_max[g] = kNegInf;
#pragma unroll 2
      for (int t0 = warp * KPI; t0 < page_size; t0 += kConsumerWarps * KPI) {
        const int t = t0 + kg;
        const int row = (t < page_size ? t : 0) * HD;
        float kf[DPL];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          load_vec(&kf[c * kVec], k_tile + row + (c * LPK + sub) * kVec);
        const int pos = j * page_size + t;
        const bool ok =
            t < page_size && pos < length && (p.window <= 0 || pos >= length - p.window);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) dot = fmaf(qf[g][i], kf[i], dot);
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          const float sc = ok ? dot * p.sm_scale : kNegInf;
          if (sub == 0 && t < page_size) scores[g * page_size + t] = sc;
          warp_max[g] = fmaxf(warp_max[g], sc);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int off = LPK; off < 32; off <<= 1)
          warp_max[g] = fmaxf(warp_max[g], __shfl_xor_sync(0xffffffffu, warp_max[g], off));
        if (lane == 0) maxes[((j & 1) * kConsumerWarps + warp) * G + g] = warp_max[g];
      }
      // The one exchange a page: every warp takes the page's max, so that p
      // is rounded against the same running max as the plain version's.
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w)
          m_new = fmaxf(m_new, maxes[((j & 1) * kConsumerWarps + w) * G + g]);
        const float alpha = expf(m[g] - m_new);
        m[g] = m_new;
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
      }

      // l sums the float32 weights; the p.v product takes them rounded to
      // the value dtype, as the Pallas kernel does.
#pragma unroll 2
      for (int t0 = warp * KPI; t0 < page_size; t0 += kConsumerWarps * KPI) {
        const int t = t0 + kg;
        const int tt = t < page_size ? t : 0;
        float vf[DPL];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          load_vec(&vf[c * kVec], v_tile + tt * HD + (c * LPK + sub) * kVec);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float sc = scores[g * page_size + tt];
          const float pw = t < page_size && sc != kNegInf ? expf(sc - m[g]) : 0.f;
          l[g] += pw;
          const float rounded = round_to(pw, v_tile);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(rounded, vf[i], acc[g][i]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Every key group holds sums against the same max: they add up, over
    // the warp's key groups by a butterfly, then over the warps below.
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
      }
    }
    if (kg == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float* part = parts + (warp * G + g) * kPart;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            part[(c * LPK + sub) * kVec + e] = acc[g][c * kVec + e];
        if (sub == 0) {
          part[HD] = m[g];
          part[HD + 1] = l[g];
        }
      }
    }
  }
  __syncthreads();

  // The warps' partials merge in warp order; thread per (query head, dim).
  T* o_grp = static_cast<T*>(p.out) + ((int64_t)b * p.heads + (int64_t)h * group) * HD;
  float* ws = p.workspace + (((int64_t)b * p.heads + (int64_t)h * group) * p.splits) * kPart;
  for (int idx = tid; idx < group * HD; idx += kThreads) {
    const int g = idx / HD;
    const int d = idx % HD;
    // The warps share one running max: their sums add up, in warp order.
    const float mm = parts[g * kPart + HD];
    float ll = 0.f, aa = 0.f;
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float* part = parts + (w * G + g) * kPart;
      ll += part[HD + 1];
      aa += part[d];
    }
    if (p.splits == 1) {
      // A row that walked no page (length 0) has l == 0 and writes 0.
      store(o_grp + idx, aa / (ll > 0.f ? ll : 1.f));
    } else {
      float* part = ws + ((int64_t)g * p.splits + split) * kPart;
      part[d] = aa;
      if (d == 0) {
        part[HD] = mm;
        part[HD + 1] = ll;
      }
    }
  }
  if (p.splits == 1) return;

  // The last CTA of this (row, kv head) to get here merges the splits.
  // Its partials are visible before its ticket is taken.
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + (int64_t)b * p.kv_heads + h;
  if (tid == 0) *ticket_s = atomicAdd(ticket, 1);
  __syncthreads();
  if (*ticket_s != p.splits - 1) return;
  __threadfence();
  for (int idx = tid; idx < group * HD; idx += kThreads) {
    const int g = idx / HD;
    const int d = idx % HD;
    float mm, ll, aa;
    merge_parts(
        p.splits,
        [&](int s, float& mi, float& li, float& ai) {
          const float* part = ws + ((int64_t)g * p.splits + s) * kPart;
          mi = __ldcg(part + HD), li = __ldcg(part + HD + 1), ai = __ldcg(part + d);
        },
        mm, ll, aa);
    store(o_grp + idx, aa / (ll > 0.f ? ll : 1.f));
  }
  if (tid == 0) *ticket = 0;  // clean for the next launch
}

template <typename T, int HD, int G>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T), p.page_size, HD, G, p.stages);
  auto kernel = paged_decode_kernel<T, HD, G>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(batch, p.kv_heads, p.splits);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(const Params& p, int batch, cudaStream_t stream) {
  switch (group_bucket(p.heads / p.kv_heads)) {
    case 1:
      return launch<T, HD, 1>(p, batch, stream);
    case 2:
      return launch<T, HD, 2>(p, batch, stream);
    case 4:
      return launch<T, HD, 4>(p, batch, stream);
    default:
      return launch<T, HD, 8>(p, batch, stream);
  }
}

template <typename T>
cudaError_t dispatch_hd(int head_dim, const Params& p, int batch, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return dispatch_group<T, 16>(p, batch, stream);
    case 32:
      return dispatch_group<T, 32>(p, batch, stream);
    case 64:
      return dispatch_group<T, 64>(p, batch, stream);
    case 128:
      return dispatch_group<T, 128>(p, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.  splits
// >= 1 shares of each row's live pages, one CTA each; with splits > 1,
// workspace is float32 [batch, heads, splits, head_dim + 2] and tickets int32
// [batch, kv_heads], all zeros (the kernel leaves them so).  stages: the
// ring's depth.  Returns cudaGetLastError() after the launch (0 on success).
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const void* tables, const void* lengths, void* out, void* workspace,
                        void* tickets, int dtype, int batch, int heads, int kv_heads,
                        int head_dim, int page_size, int n_pages, int max_pages, int layer,
                        int window, int splits, int stages, float sm_scale, void* stream) {
  const int group = kv_heads > 0 ? heads / kv_heads : 0;
  if (group < 1 || group > kMaxGroup || splits < 1 || stages < 1 || stages > kMaxStages)
    return cudaErrorInvalidValue;
  const Params p{q, k_pool, v_pool, static_cast<const int*>(tables),
                 static_cast<const int*>(lengths), out, static_cast<float*>(workspace),
                 static_cast<int*>(tickets), heads, kv_heads, page_size, n_pages, max_pages,
                 layer, window, splits, stages, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(head_dim, p, batch, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(head_dim, p, batch, s);
  return cudaErrorInvalidValue;
}

// Shared memory one launch needs, so the wrapper can size the ring and
// refuse a shape the card cannot hold before launching it.
long long paged_attention_smem_bytes(int dtype, int page_size, int head_dim, int group,
                                     int stages) {
  return (long long)smem_bytes(dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16), page_size,
                               head_dim, group_bucket(group), stages);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
