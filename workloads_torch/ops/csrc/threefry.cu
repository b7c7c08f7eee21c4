// Threefry-2x32 counter hashing for the port's PRNG keys (workloads_torch/prng.py).
//
// Replaces no TPU kernel: the JAX package draws its random numbers through
// XLA's threefry2x32 primitive (jax/_src/prng.py, threefry_2x32 and
// _threefry_split_foldlike / _threefry_random_bits_partitionable under
// jax_threefry_partitionable), which has no pl.pallas_call.  It was added
// because the plain PyTorch hash is some 160 elementwise launches over int64
// tensors, inside every sampled decode step; this is one.
//
// One thread hashes one element: key pair (k0, k1) from device memory (so a
// CUDA graph replays it with whatever key its buffer holds), counter pair
// (hi, lo) = the 64-bit index base + (element mod per_key), JAX's
// iota_2x32_shape counter, then 20 rounds with key injection every 4.  What
// it writes is chosen by `mode`:
//   0  both words, int64 [n_keys, per_key, 2]     (split, fold_in)
//   1  their xor, int64 [n_keys, per_key]         (random_bits, 32 bits)
//   2  float32 [n_keys, per_key] uniform in [minval, maxval): JAX's bit
//      trick (bits >> 9 | 1.0f's exponent, minus 1) scaled with IEEE-rounded
//      multiply and add (no FMA contraction), then max(minval, .), so the
//      values equal the plain version's bit for bit.
// Words are stored zero-extended in int64, as the plain version keeps them.
//
// Bound: about 80 int32 operations an element (60 in the rounds, a dozen in
// the key injections, the counter and the output), against 4-16 bytes
// written; above a few thousand elements the INT32 lanes, not the memory,
// limit it.  The design keeps every intermediate in registers and makes one
// pass; a grid-stride loop keeps the grid at a few waves of 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

#define THREEFRY_ROUND(r) \
  x0 += x1;               \
  x1 = rotl32(x1, r);     \
  x1 ^= x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  THREEFRY_ROUND(13) THREEFRY_ROUND(15) THREEFRY_ROUND(26) THREEFRY_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  THREEFRY_ROUND(17) THREEFRY_ROUND(29) THREEFRY_ROUND(16) THREEFRY_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  THREEFRY_ROUND(13) THREEFRY_ROUND(15) THREEFRY_ROUND(26) THREEFRY_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  THREEFRY_ROUND(17) THREEFRY_ROUND(29) THREEFRY_ROUND(16) THREEFRY_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  THREEFRY_ROUND(13) THREEFRY_ROUND(15) THREEFRY_ROUND(26) THREEFRY_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef THREEFRY_ROUND

template <int kMode>
__global__ void threefry_kernel(const int64_t* __restrict__ keys, int64_t n_keys,
                                int64_t per_key, uint64_t base, void* __restrict__ out,
                                float minval, float scale) {
  const int64_t total = n_keys * per_key;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int64_t kidx = n_keys == 1 ? 0 : e / per_key;
    const uint64_t c = base + (uint64_t)(e - kidx * per_key);
    uint32_t x0 = (uint32_t)(c >> 32);
    uint32_t x1 = (uint32_t)c;
    threefry2x32((uint32_t)keys[2 * kidx], (uint32_t)keys[2 * kidx + 1], x0, x1);
    if (kMode == 0) {
      int64_t* o = static_cast<int64_t*>(out);
      o[2 * e] = (int64_t)x0;
      o[2 * e + 1] = (int64_t)x1;
    } else if (kMode == 1) {
      static_cast<int64_t*>(out)[e] = (int64_t)(x0 ^ x1);
    } else {
      const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
      const float f = __fsub_rn(__uint_as_float(bits), 1.0f);
      static_cast<float*>(out)[e] = fmaxf(minval, __fadd_rn(__fmul_rn(f, scale), minval));
    }
  }
}

}  // namespace

extern "C" {

// keys: int64 [n_keys, 2], words in [0, 2^32).  Element e of key e / per_key
// hashes the counter base + e % per_key.  mode as above; out sized to it.
// scale = maxval - minval in float32 (mode 2 only).  Returns
// cudaGetLastError() after the launch (0 on success).
int threefry_launch(const void* keys, long long n_keys, long long per_key,
                    unsigned long long base, int mode, void* out, float minval, float scale,
                    void* stream) {
  const long long total = n_keys * per_key;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 16;  // a few waves; the loop strides the rest
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* k = static_cast<const int64_t*>(keys);
  switch (mode) {
    case 0:
      threefry_kernel<0><<<(unsigned)blocks, threads, 0, s>>>(k, n_keys, per_key, base, out,
                                                               minval, scale);
      break;
    case 1:
      threefry_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(k, n_keys, per_key, base, out,
                                                               minval, scale);
      break;
    case 2:
      threefry_kernel<2><<<(unsigned)blocks, threads, 0, s>>>(k, n_keys, per_key, base, out,
                                                               minval, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* threefry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
