// XOR delta of two byte buffers, for sm_90a.
//
// Replaces the TPU kernel `xor_pallas` / `_xor_kernel` in
// src/repro/kernels/delta/delta.py (a ^ b over (n, 2048) uint32 tiles,
// trimmed back to the array's byte length by `delta_host`).  The same
// XOR encodes a delta against the base image and applies it on restore.
//
// Bound on the H100: bytes.  Two inputs read and one output written
// once: 3 * nbytes / 3.35 TB/s; one integer op per word.  Design: each
// CTA owns a tile of kVec * 256 16-byte vectors (uint4); a thread issues
// all kVec loads of both inputs before its first store, so each SM keeps
// many independent 16-byte loads in flight, and each warp still moves
// 512 contiguous bytes per access.  One CTA per tile, no grid-stride
// cap.  A second, scalar launch XORs the last nbytes % 16 bytes.
// Nothing is padded on the device.  When any of the three base
// addresses is not 16-byte aligned the whole range takes that scalar
// grid-stride byte loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;   // uint4 vectors per thread, loaded before storing

__global__ void __launch_bounds__(kThreads)
xor_vec_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
               uint4* __restrict__ out, long long n16) {
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kVec +
                         threadIdx.x;
  uint4 x[kVec], y[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const long long i = base + static_cast<long long>(k) * kThreads;
    if (i < n16) { x[k] = a[i]; y[k] = b[i]; }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const long long i = base + static_cast<long long>(k) * kThreads;
    if (i < n16)
      out[i] = make_uint4(x[k].x ^ y[k].x, x[k].y ^ y[k].y, x[k].z ^ y[k].z,
                          x[k].w ^ y[k].w);
  }
}

__global__ void __launch_bounds__(kThreads)
xor_byte_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                uint8_t* __restrict__ out, long long from, long long nbytes) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = from + static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < nbytes; i += stride)
    out[i] = a[i] ^ b[i];
}

}  // namespace

// a, b, out: nbytes each (nbytes > 0)
extern "C" int xor_launch(const void* a, const void* b, void* out,
                          long long nbytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  auto* po = static_cast<uint8_t*>(out);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  long long from = 0;
  if (aligned) {
    const long long n16 = nbytes / 16;
    const long long tile = static_cast<long long>(kThreads) * kVec;
    if (n16 > 0)
      xor_vec_kernel<<<static_cast<unsigned>((n16 + tile - 1) / tile),
                       kThreads, 0, s>>>(
          reinterpret_cast<const uint4*>(pa), reinterpret_cast<const uint4*>(pb),
          reinterpret_cast<uint4*>(po), n16);
    from = n16 * 16;
  }
  if (from < nbytes) {
    long long grid = (nbytes - from + kThreads - 1) / kThreads;
    if (grid > 132LL * 16) grid = 132LL * 16;   // 16 CTAs per SM
    xor_byte_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        pa, pb, po, from, nbytes);
  }
  return static_cast<int>(cudaGetLastError());
}
