// XOR delta of two byte buffers, for sm_90a.
//
// Replaces the TPU kernel `xor_pallas` / `_xor_kernel` in
// src/repro/kernels/delta/delta.py:17-32 (a ^ b over (n, 2048) uint32
// tiles, trimmed back to the array's byte length by `delta_host`).  The
// same XOR encodes a delta against the base image and applies it on
// restore.
//
// Bound on the H100: bytes.  Two inputs read and one output written
// once: 3 * nbytes / 3.35 TB/s; one integer op per 4 bytes.
// Design, chosen by timing it in turns against the others and against
// `torch.bitwise_xor` on several cards (tools/time_xor_designs.py,
// PERF.md):
//  - one 256-thread CTA per 2 KiB of each input (`xor_tile`), one 8-byte
//    vector of a and of b a thread, plain loads and stores; a CTA this
//    short leaves no tail.  Other CTA sizes and vector widths tried
//    while choosing were not better across cards;
//  - measured slower, and so not used (times in PERF.md): 16 KiB CTAs
//    with 4 x 16 B a thread (the earlier kernel's); a persistent grid,
//    one CTA an SM walking 16 KiB tiles in grid-stride order, with TMA
//    bulk copies into a 4-stage shared-memory ring of full/empty
//    mbarriers, or two CTAs an SM with 8 x 16 B a thread in registers
//    (both in tools/xor_designs.cu); L2 evict-first or no-allocate
//    hints on the loads and streaming stores, on either.
//    Why the persistent designs lose is not established: a guess is
//    that CTAs walking fixed tiles drift apart and widen the range of
//    addresses in flight, while the block scheduler hands short CTAs
//    out in address order; it has not been checked with a profiler;
//  - alignment: when a, b and out share their address mod 8, CTA 0 also
//    XORs the at most 7 bytes before the first 8-byte boundary (the head)
//    and the at most 7 after the last (the tail), so the call is one
//    launch.  Mismatched alignments take a scalar grid-stride byte loop
//    sized from the SM count (queried once per device), also one launch.
//    Nothing is padded on the device.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;       // one uint2 of each input a thread
constexpr int kByteThreads = 256;
constexpr int kMaxDevices = 64;

std::atomic<int> g_sms[kMaxDevices];   // 0 until queried

// [head, head + body) is the 8-byte-aligned range of all three buffers
__global__ void __launch_bounds__(kThreads)
xor_vec_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
               uint8_t* __restrict__ out, long long head, long long body,
               long long nbytes) {
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid < 16) {       // head and tail bytes
    const long long i = tid < 8 ? tid : head + body + (tid - 8);
    if (tid < 8 ? i < head : i < nbytes) out[i] = a[i] ^ b[i];
  }
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  if (i < body / 8) {
    const uint2 x = reinterpret_cast<const uint2*>(a + head)[i];
    const uint2 y = reinterpret_cast<const uint2*>(b + head)[i];
    reinterpret_cast<uint2*>(out + head)[i] = make_uint2(x.x ^ y.x, x.y ^ y.y);
  }
}

__global__ void __launch_bounds__(kByteThreads)
xor_byte_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                uint8_t* __restrict__ out, long long nbytes) {
  const long long stride = static_cast<long long>(gridDim.x) * kByteThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kByteThreads +
                     threadIdx.x;
       i < nbytes; i += stride)
    out[i] = a[i] ^ b[i];
}

}  // namespace

// bytes of each input one CTA of xor_vec_kernel takes
extern "C" int xor_tile() { return kThreads * 8; }

// a, b, out: nbytes each (nbytes > 0), on the current device
extern "C" int xor_launch(const void* a, const void* b, void* out,
                          long long nbytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  auto* po = static_cast<uint8_t*>(out);
  const uintptr_t ua = reinterpret_cast<uintptr_t>(a);
  if (((ua ^ reinterpret_cast<uintptr_t>(b)) |
       (ua ^ reinterpret_cast<uintptr_t>(out))) & 7u) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    int sms = g_sms[dev].load(std::memory_order_relaxed);
    if (sms == 0) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      g_sms[dev].store(sms, std::memory_order_relaxed);
    }
    long long grid = (nbytes + kByteThreads - 1) / kByteThreads;
    if (grid > 16LL * sms) grid = 16LL * sms;   // 16 CTAs an SM
    xor_byte_kernel<<<static_cast<unsigned>(grid), kByteThreads, 0, s>>>(
        pa, pb, po, nbytes);
    return static_cast<int>(cudaGetLastError());
  }
  long long head = static_cast<long long>((8 - (ua & 7u)) & 7u);
  if (head > nbytes) head = nbytes;
  const long long body = (nbytes - head) & ~7LL;
  long long grid = (body / 8 + kThreads - 1) / kThreads;
  if (grid < 1) grid = 1;                        // head and tail alone
  xor_vec_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      pa, pb, po, head, body, nbytes);
  return static_cast<int>(cudaGetLastError());
}
