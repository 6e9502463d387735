// philox_check.cu -- the CUDA toolkit's Philox4x32-10 (curand_kernel.h),
// built only to hold wire_native.cu's generator against it (chip_smoke.py,
// phase 3): the same (counter, key) pairs must give the same 4 words.
// Not a kernel of any path.

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace {
__global__ void curand_philox_kernel(const uint32_t* __restrict__ ctr,
                                     const uint32_t* __restrict__ key,
                                     uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 r = curand_Philox4x32_10(
      make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]),
      make_uint2(key[2 * i], key[2 * i + 1]));
  out[4 * i] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}
}  // namespace

// ctr (n, 4), key (n, 2) uint32 -> out (n, 4) uint32
extern "C" int curand_philox4x32_10_u32(const void* ctr, const void* key,
                                        void* out, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  curand_philox_kernel<<<(n + 127) / 128, 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ctr), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}
