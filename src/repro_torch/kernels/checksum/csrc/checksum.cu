// Fletcher-style block checksum of a byte buffer, for sm_90a.
//
// Replaces the TPU kernel `block_sums_pallas` / `_block_sums_kernel` in
// src/repro/kernels/checksum/checksum.py, plus the cross-block fold
// that the reference leaves to jnp (`ref.fold`).  Definition (bit for bit
// `checksum_np`): the bytes are read as little-endian uint32 words in
// blocks of 2048 words (8 KiB), the last block zero-padded; per block
// s1 = sum(w), s2 = sum(i * w); then f1 = sum(s1_b * (b+1)),
// f2 = sum(s2_b * (b+1)^2) and digest = f1 ^ (f2 << 1), all mod 2^32.
//
// Bound on the H100: bytes.  One pass reads each input byte once
// (nbytes / 3.35 TB/s); the arithmetic is two integer multiply-adds per
// word.  Design: pass 1 is one CTA of 256 threads per 8 KiB block, each
// thread loading 16-byte words (uint4) so a warp reads 512 contiguous
// bytes per instruction; the sums wrap natively in uint32_t and reduce
// with warp shuffles, then across the 8 warps in shared memory.  Blocks
// run in any order on the 132 SMs, so pass 2 (one CTA) folds the
// (n_blocks, 2) partial sums to one uint32; only that word goes back to
// the host.  Bytes are read in place at any length and offset: the tail
// block is zero-padded inside the kernel with masked byte loads, and a
// base address that is not 16-byte aligned takes a scalar byte path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 2048;            // uint32 words per block
constexpr int kBlockBytes = 4 * kWords;  // 8 KiB
constexpr int kThreads = 256;

__device__ __forceinline__ void block_reduce2(uint32_t& a, uint32_t& b) {
  __shared__ uint32_t sa[kThreads / 32], sb[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { sa[warp] = a; sb[warp] = b; }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0u;
    b = lane < kThreads / 32 ? sb[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
  }
}

// little-endian word `w` of block `blk`, bytes past `nbytes` read as zero
__device__ __forceinline__ uint32_t masked_word(const uint8_t* data,
                                                long long nbytes,
                                                long long blk, int w) {
  const long long base = blk * kBlockBytes + 4LL * w;
  uint32_t word = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (base + k < nbytes) word |= uint32_t(data[base + k]) << (8 * k);
  }
  return word;
}

__global__ void __launch_bounds__(kThreads)
block_sums_kernel(const uint8_t* __restrict__ data, long long nbytes,
                  bool aligned, uint32_t* __restrict__ sums) {
  const long long blk = blockIdx.x;
  uint32_t s1 = 0u, s2 = 0u;
  const bool full = (blk + 1) * kBlockBytes <= nbytes;
  if (aligned && full) {
    const uint4* v = reinterpret_cast<const uint4*>(data + blk * kBlockBytes);
#pragma unroll
    for (int r = 0; r < kWords / 4 / kThreads; ++r) {
      const int j = threadIdx.x + r * kThreads;   // uint4 index in block
      const uint4 q = v[j];
      const uint32_t i0 = 4u * uint32_t(j);
      s1 += q.x + q.y + q.z + q.w;
      s2 += i0 * q.x + (i0 + 1u) * q.y + (i0 + 2u) * q.z + (i0 + 3u) * q.w;
    }
  } else {
    for (int w = threadIdx.x; w < kWords; w += kThreads) {
      const uint32_t word = masked_word(data, nbytes, blk, w);
      s1 += word;
      s2 += uint32_t(w) * word;
    }
  }
  block_reduce2(s1, s2);
  if (threadIdx.x == 0) {
    sums[2 * blk] = s1;
    sums[2 * blk + 1] = s2;
  }
}

__global__ void __launch_bounds__(kThreads)
fold_kernel(const uint32_t* __restrict__ sums, long long n_blocks,
            uint32_t* __restrict__ out) {
  uint32_t f1 = 0u, f2 = 0u;
  for (long long b = threadIdx.x; b < n_blocks; b += kThreads) {
    const uint32_t pos = uint32_t(b + 1);
    f1 += sums[2 * b] * pos;
    f2 += sums[2 * b + 1] * pos * pos;
  }
  block_reduce2(f1, f2);
  if (threadIdx.x == 0) out[0] = f1 ^ (f2 << 1);
}

}  // namespace

// data: first byte to digest (any alignment); nbytes > 0;
// sums: uint32[n_blocks * 2] scratch; out: uint32[1]
extern "C" int checksum_launch(const void* data, long long nbytes, void* sums,
                               void* out, void* stream) {
  const long long n_blocks = (nbytes + kBlockBytes - 1) / kBlockBytes;
  const bool aligned = (reinterpret_cast<uintptr_t>(data) & 15u) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  block_sums_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(data), nbytes, aligned,
      static_cast<uint32_t*>(sums));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_kernel<<<1, kThreads, 0, s>>>(static_cast<const uint32_t*>(sums),
                                     n_blocks, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
