// XOR delta, the two persistent designs first proposed for sm_90a, which
// tools/time_xor_designs.py times against the shipped kernel
// (src/repro_torch/kernels/delta/csrc/delta.cu) and `torch.bitwise_xor`;
// both lost to them (PERF.md).  Same C entry point as the shipped kernel.
//
// Bound on the H100: bytes, 3 * nbytes / 3.35 TB/s.  Both designs run a
// persistent grid sized from the SM count (queried once per device),
// capped at the number of tiles, walking 16-byte-aligned tiles in
// grid-stride order:
//  - XOR_DESIGN 1, TMA ring: one CTA an SM.  One thread of a producer
//    warp copies the 16 KiB tiles of a and b into a ring of 4 stages in
//    shared memory with 1-D bulk async copies (`cp.async.bulk`) that
//    complete on the stage's "full" mbarrier, armed with both tiles'
//    bytes; the tile index goes beside it, -1 when the CTA has no more.
//    Two consumer warpgroups wait on "full", XOR 16 bytes a thread out of
//    shared memory, store, and arrive on the stage's "empty" mbarrier,
//    which the producer waits on before it refills the stage;
//  - XOR_DESIGN 2, register path: two CTAs an SM, each thread holding
//    8 x 16 B of each input in registers before it stores them;
//  - XOR_HINTS 1 (the default): L2 evict-first on the ring's bulk loads,
//    `ld.global.nc.L1::no_allocate` on the register path's, and
//    streaming stores (`st.global.cs`) on both; 0: plain loads, stores.
// When a, b and out share their address mod 16, CTA 0 also XORs the
// head and tail bytes; mismatched alignments take a byte loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#ifndef XOR_DESIGN
#define XOR_DESIGN 1
#endif
#ifndef XOR_HINTS
#define XOR_HINTS 1
#endif

namespace {

constexpr int kByteThreads = 256;
constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices];         // 0 until queried

__device__ __forceinline__ void store_cs(void* p, uint4 v) {
#if XOR_HINTS
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
#else
  *static_cast<uint4*>(p) = v;
#endif
}

__device__ __forceinline__ uint4 xor4(uint4 x, uint4 y) {
  return make_uint4(x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w);
}

// CTA 0: the bytes before `head` and after `head + body`
__device__ __forceinline__ void head_tail(
    const uint8_t* a, const uint8_t* b, uint8_t* out, long long head,
    long long body, long long nbytes) {
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid < 32) {
    const long long i = tid < 16 ? tid : head + body + (tid - 16);
    if (tid < 16 ? i < head : i < nbytes) out[i] = a[i] ^ b[i];
  }
}

#if XOR_DESIGN == 1
constexpr int kTile = 16384;                 // bytes of each input a stage
constexpr int kStages = 4;
constexpr int kCtasPerSm = 1;
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kRingBytes = kStages * 2 * kTile;
constexpr long long kGrain = kTile;          // bytes of each input a tile
std::atomic<bool> g_smem_set[kMaxDevices];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completes `bytes` of the transaction count of mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
#if XOR_HINTS
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy) : "memory");
#else
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
#endif
}

// [head, head + body) is the 16-byte-aligned range of all three buffers
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
xor_design_kernel(const uint8_t* __restrict__ a,
                  const uint8_t* __restrict__ b, uint8_t* __restrict__ out,
                  long long head, long long body, long long nbytes) {
  extern __shared__ __align__(128) uint8_t ring[];   // per stage: a, b tiles
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ long long tile_of[kStages];             // -1: no more tiles
  const int tid = threadIdx.x;
  head_tail(a, b, out, head, body, nbytes);
  const long long ntiles = (body + kTile - 1) / kTile;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(smem_addr(&full[s]), 1);
      bar_init(smem_addr(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  a += head;
  b += head;
  out += head;

  if (tid >= kConsumers) {                 // producer warp
    if (tid == kConsumers) {
      uint64_t policy;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                   : "=l"(policy));
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x;; t += gridDim.x) {
        bar_wait(smem_addr(&empty[stage]), phase ^ 1);   // stage is free
        const uint32_t bar = smem_addr(&full[stage]);
        if (t >= ntiles) {
          tile_of[stage] = -1;
          bar_arrive(bar);
          break;
        }
        tile_of[stage] = t;
        const long long off = t * kTile;
        const uint32_t len = static_cast<uint32_t>(
            body - off < kTile ? body - off : kTile);
        const uint32_t dst = smem_addr(ring + stage * 2 * kTile);
        bar_expect_tx(bar, 2 * len);
        bulk_load(dst, a + off, len, bar, policy);
        bulk_load(dst + kTile, b + off, len, bar, policy);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    bar_wait(smem_addr(&full[stage]), phase);
    const long long t = tile_of[stage];
    if (t < 0) break;
    const long long off = t * kTile;
    const int n16 = static_cast<int>(body - off < kTile ? body - off : kTile)
                    / 16;
    const uint4* ta = reinterpret_cast<const uint4*>(ring + stage * 2 * kTile);
    const uint4* tb = ta + kTile / 16;
    uint4* o = reinterpret_cast<uint4*>(out + off);
#pragma unroll 4
    for (int i = tid; i < n16; i += kConsumers)
      store_cs(o + i, xor4(ta[i], tb[i]));
    __syncwarp();
    if ((tid & 31) == 0) bar_arrive(smem_addr(&empty[stage]));
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }
}

#else   // XOR_DESIGN 2
constexpr int kThreads = 256;
constexpr int kVec = 8;                      // vectors of each input a thread
constexpr int kCtasPerSm = 2;
constexpr long long kChunk = static_cast<long long>(kThreads) * kVec;
constexpr long long kGrain = kChunk * 16;    // bytes of each input a chunk

__device__ __forceinline__ uint4 load_nc(const uint4* p) {
#if XOR_HINTS
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
#else
  return *p;
#endif
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
xor_design_kernel(const uint8_t* __restrict__ a,
                  const uint8_t* __restrict__ b, uint8_t* __restrict__ out,
                  long long head, long long body, long long nbytes) {
  const int tid = threadIdx.x;
  head_tail(a, b, out, head, body, nbytes);
  const auto* va = reinterpret_cast<const uint4*>(a + head);
  const auto* vb = reinterpret_cast<const uint4*>(b + head);
  auto* vo = reinterpret_cast<uint4*>(out + head);
  const long long n16 = body / 16;
  for (long long base = blockIdx.x * kChunk + tid; base < n16;
       base += gridDim.x * kChunk) {
    uint4 x[kVec], y[kVec];
    if (base - tid + kChunk <= n16) {      // a whole chunk
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        x[k] = load_nc(va + base + k * kThreads);
        y[k] = load_nc(vb + base + k * kThreads);
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        store_cs(vo + base + k * kThreads, xor4(x[k], y[k]));
      continue;
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long i = base + k * kThreads;
      if (i < n16) { x[k] = load_nc(va + i); y[k] = load_nc(vb + i); }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long i = base + k * kThreads;
      if (i < n16) store_cs(vo + i, xor4(x[k], y[k]));
    }
  }
}
#endif

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

// a, b, out: nbytes each (nbytes > 0), on the current device
extern "C" int xor_launch(const void* a, const void* b, void* out,
                          long long nbytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
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
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  auto* po = static_cast<uint8_t*>(out);
  const uintptr_t ua = reinterpret_cast<uintptr_t>(a);
  if (((ua ^ reinterpret_cast<uintptr_t>(b)) |
       (ua ^ reinterpret_cast<uintptr_t>(out))) & 15u) {
    long long grid = (nbytes + kByteThreads - 1) / kByteThreads;
    if (grid > 16LL * sms) grid = 16LL * sms;
    xor_byte_kernel<<<static_cast<unsigned>(grid), kByteThreads, 0, s>>>(
        pa, pb, po, nbytes);
    return static_cast<int>(cudaGetLastError());
  }
  int smem = 0;
#if XOR_DESIGN == 1
  smem = kRingBytes;
  if (!g_smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(xor_design_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[dev].store(true, std::memory_order_release);
  }
#endif
  long long head = static_cast<long long>((16 - (ua & 15u)) & 15u);
  if (head > nbytes) head = nbytes;
  const long long body = (nbytes - head) & ~15LL;
  long long grid = (body + kGrain - 1) / kGrain;
  if (grid > static_cast<long long>(kCtasPerSm) * sms)
    grid = static_cast<long long>(kCtasPerSm) * sms;
  if (grid < 1) grid = 1;
  xor_design_kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      pa, pb, po, head, body, nbytes);
  return static_cast<int>(cudaGetLastError());
}
