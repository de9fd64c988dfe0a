// Blockwise absmax int8 quantization and dequantization, for sm_90a.
//
// quantize_kernel replaces the TPU kernel `quantize_pallas` /
// `_quant_kernel` in src/repro/kernels/quantize/quantize.py.  Per row of 1024 f32 values:
// amax = max|x|, scale = amax / 127 (1 when amax == 0),
// q = clip(round-half-even(x / scale), -127, 127) as int8.  Bit for bit
// `quantize_np`: true IEEE division (no fast math, no reciprocal), the
// f32 divisor 127.0f, rintf for half-to-even rounding.
//
// Bound on the H100: bytes.  Per element 4 bytes read and 1 written,
// plus 4 bytes of scale per 1024 elements: ~5 * n / 3.35 TB/s.  The
// arithmetic (an abs-max reduction and one division per element) is far
// below the card's rate.  Design: one CTA of 256 threads per row; each
// thread loads one float4, so the row is read once into registers, the
// abs-max reduces by warp shuffles and shared memory, and each thread
// writes its four int8 as one 32-bit store.  The ragged last row is
// read with masked loads as zeros (the reference pads it with zeros),
// so the input is never padded or copied.
//
// dequantize_kernel replaces `dequantize_pallas` / `_dequant_kernel` in
// the same file: x = f32(q) * scale of the row, bit for bit
// `dequantize_np` (one IEEE f32 multiply, nothing to contract into an
// FMA).  Bound on the H100: bytes, 1 read and 4 written per element
// plus 4 bytes of scale per row: ~5 * n / 3.35 TB/s.  Design: the same
// grid, one CTA of 256 threads per row; each thread loads its four int8
// as one char4 and the row's scale once, and stores one float4.  Only
// the n values of the array are written (the zero pad of the last row
// is never materialised), with a masked scalar path for that row and
// for addresses that are not aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 1024;
constexpr int kThreads = 256;   // 4 elements each

__device__ __forceinline__ int8_t quant(float x, float scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, long long n, bool aligned,
                int8_t* __restrict__ q, float* __restrict__ scales) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ float row_scale;
  const long long row = blockIdx.x;
  const long long i0 = row * kRow + 4LL * threadIdx.x;
  float v[4];
  if (aligned && i0 + 4 <= n) {
    const float4 f = *reinterpret_cast<const float4*>(x + i0);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i0 + k < n ? x[i0 + k] : 0.f;
  }
  float m = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, o));
    if (lane == 0) {
      const float s = m > 0.f ? m / 127.0f : 1.0f;
      row_scale = s;
      scales[row] = s;
    }
  }
  __syncthreads();
  const float s = row_scale;
  char4 out;
  out.x = quant(v[0], s); out.y = quant(v[1], s);
  out.z = quant(v[2], s); out.w = quant(v[3], s);
  reinterpret_cast<char4*>(q + row * kRow)[threadIdx.x] = out;
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  long long n, bool aligned, float* __restrict__ x) {
  const long long row = blockIdx.x;
  const long long i0 = row * kRow + 4LL * threadIdx.x;
  const float s = scales[row];
  if (aligned && i0 + 4 <= n) {
    const char4 c = reinterpret_cast<const char4*>(q + row * kRow)[threadIdx.x];
    *reinterpret_cast<float4*>(x + i0) =
        make_float4(static_cast<float>(c.x) * s, static_cast<float>(c.y) * s,
                    static_cast<float>(c.z) * s, static_cast<float>(c.w) * s);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < n) x[i0 + k] = static_cast<float>(q[i0 + k]) * s;
  }
}

}  // namespace

// x: f32[n] (n > 0); q: int8[n_rows * 1024]; scales: f32[n_rows]
extern "C" int quantize_launch(const void* x, long long n, void* q,
                               void* scales, void* stream) {
  const long long n_rows = (n + kRow - 1) / kRow;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  quantize_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, aligned, static_cast<int8_t*>(q),
      static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

// q: int8[n_rows * 1024]; scales: f32[n_rows]; x: f32[n] (n > 0), with
// n_rows = ceil(n / 1024)
extern "C" int dequantize_launch(const void* q, const void* scales,
                                 long long n, void* x, void* stream) {
  const long long n_rows = (n + kRow - 1) / kRow;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) & 3u) |
                        (reinterpret_cast<uintptr_t>(x) & 15u)) == 0;
  dequantize_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), n,
      aligned, static_cast<float*>(x));
  return static_cast<int>(cudaGetLastError());
}
