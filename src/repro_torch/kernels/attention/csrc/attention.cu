// Fused causal / non-causal GQA attention, forward and backward, for
// sm_90a, in bf16 with f32 accumulation.
//
// Replaces no TPU kernel: the JAX package's attention is chunked jnp
// under a custom VJP (`_flash_fwd_impl`, `_flash_bwd` in
// src/repro/models/attention.py), which XLA fuses.  The port's plain
// version of it (`_chunked_attention` in
// src/repro_torch/models/attention.py) writes each block's f32 scores
// to device memory, passes over them about ten times forward and
// fifteen times backward, and runs every product in f32 on the CUDA
// cores.  This kernel set keeps scores and probabilities in registers.
// It computes what the reference computes:
//  - every product is bf16 x bf16 summed in f32 (the
//    reference's einsums on compute-dtype operands with
//    preferred_element_type f32; a product of two bf16 values is exact
//    in f32);
//  - forward: an online softmax over tiles of 64 keys, as
//    `_flash_fwd_impl` scans key blocks: f32 running max m and sum l,
//    p = exp(s - m) rounded to the compute dtype before the value
//    product and summed into l as rounded, the output divided by
//    max(l, 1e-30) once at the end, lse = m + log(max(l, 1e-30));
//  - backward, as `_flash_bwd`: p recomputed from the saved lse and
//    rounded, delta = rowsum(dout * out) in f32, ds = p * (dp - delta)
//    rounded, dq = ds k, dk = ds^T q, dv = p^T dout.
// q arrives scaled (q * 1/sqrt(hd) rounded in its dtype, as the
// reference scales it), so the kernels apply no scale.
//
// Bound on the H100: the tensor cores.  At the main path's shape (B 14,
// S 4096, 16 heads over 2 KV heads, hd 64, causal) a layer's forward is
// 2 products of 0.24 TFLOP over the causal half: ~0.49 ms at 989 TFLOP/s
// (the backward's 5 products ~1.2 ms), while its inputs and output are
// 0.16 GB (0.05 ms at 3.35 TB/s).  Design (on `mma.sync`: the score products on `wgmma`, from
// swizzled tiles, gave the same bits and no gain at that shape, since each
// tile's chain of products, exp and waits is serial; a faster kernel
// needs the softmax overlapped with the products):
//  - GQA: a CTA serves one (batch, KV head) and a tile of that head's
//    "packed" query rows, row f = position * G + g over the G query
//    heads of the group (as the plain version packs (c * G) rows), so
//    one K/V tile in shared memory feeds all G heads and K/V are never
//    repeated in memory.  Causal masks compare the key with f / G;
//  - tiles come in by 16-byte `cp.async` into shared memory rows padded
//    by 8 elements (rows hd + 8 long: the 8 rows of each `ldmatrix` fall
//    on distinct banks for hd 16, 64, 128 and 160), double-buffered so
//    the next tile loads while this one computes;
//  - `mma.sync.m16n8k16` with `ldmatrix` operands; each warp owns 16
//    rows of the output tile; the score accumulators become the A
//    operand of the next product in registers (scores, probabilities
//    and ds never touch shared or device memory);
//  - exp as `ex2.approx` of s * log2(e) - m * log2(e) (one FMA);
//  - causal: key tiles wholly past a query tile's last row are skipped,
//    only tiles that cross the diagonal or the ragged end are masked;
//    the heaviest tiles are launched first;
//  - backward without atomics, so a step is bit-identical from run to
//    run: a small pass for delta, then `attention_bwd_dkdv_kernel`, one
//    CTA per 64 keys of a (batch, KV head) looping over the packed query
//    rows of all G heads with dK and dV in f32 registers, written once;
//    and `attention_bwd_dq_kernel`, one CTA per 64 packed query rows
//    looping over key tiles, dQ in f32 registers.  Both recompute p.
// Inputs are read through their strides (batch, position, head; the
// last dim contiguous, rows 16-byte aligned), outputs are contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;      // (B, S, H, hd), scaled
  const void* k;      // (B, T, K, hd)
  const void* v;      // (B, T, K, hd)
  const void* o;      // (B, S, H, hd) forward output (backward input)
  const void* dout;   // (B, S, H, hd)
  void* out;          // forward output, contiguous (B, S, H, hd)
  float* lse;         // (B, K, S * G) f32, natural log
  float* delta;       // (B, K, S * G) f32
  void* dq;           // contiguous (B, S, H, hd)
  void* dk;           // contiguous (B, T, K, hd)
  void* dv;           // contiguous (B, T, K, hd)
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh, d_sb, d_ss, d_sh;
  int B, S, T, H, K, G, M, causal;   // M = S * G packed rows a KV head
};

template <typename T> struct Elt;

template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float lo(uint32_t u) {
    return __uint_as_float(u << 16);
  }
  static __device__ __forceinline__ float hi(uint32_t u) {
    return __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !valid (nothing is read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared; zero where !valid
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory operand offsets (in elements, rows LD long) for lane l:
// the A operand (16 x 16 at row r0, col c0: rows along M, cols along K)
template <int LD> __device__ __forceinline__ int a_off(int r0, int c0, int lane) {
  return (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
// B operands of two n8 tiles n0, n0 + 8 at depth k0, stored n-major
// (row = n, contiguous along K): ldmatrix without .trans
template <int LD> __device__ __forceinline__ int bn_off(int n0, int k0, int lane) {
  return (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8;
}
// B operands of two n8 tiles n0, n0 + 8 at depth k0, stored k-major
// (row = k, contiguous along N): ldmatrix .trans
template <int LD> __device__ __forceinline__ int bk_off(int k0, int n0, int lane) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8;
}

// packed query rows f0.. (position f / G, head kv * G + f % G) of one
// batch's tensor at `base` -> shared rows; rows past M are zeros
template <typename T, int HD, int ROWS, int NT>
__device__ __forceinline__ void load_packed(T* dst, const T* base, int f0, int M,
                                            int G, int kv, long long ss,
                                            long long sh) {
  constexpr int CPR = HD / 8, LD = HD + 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i - r * CPR, f = f0 + r;
    const bool ok = f < M;
    const T* src = ok ? base + static_cast<long long>(f / G) * ss +
                            static_cast<long long>(kv * G + f % G) * sh + c * 8
                      : base;
    cp16(dst + r * LD + c * 8, src, ok);
  }
}

// key rows t0.. of one (batch, KV head) at `base` -> shared rows; rows
// past T are zeros
template <typename T, int HD, int ROWS, int NT>
__device__ __forceinline__ void load_keys(T* dst, const T* base, int t0, int T_,
                                          long long st) {
  constexpr int CPR = HD / 8, LD = HD + 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i - r * CPR, t = t0 + r;
    const bool ok = t < T_;
    cp16(dst + r * LD + c * 8, ok ? base + static_cast<long long>(t) * st + c * 8 : base,
         ok);
  }
}

// ---------------------------------------------------------------------------
// forward: one CTA per (tile of BR packed query rows, batch, KV head)
// ---------------------------------------------------------------------------

constexpr int kFwdWarps = 8;
constexpr int kFwdRows = 16 * kFwdWarps;
constexpr int kFwdKeys = 64;

template <int HD> constexpr size_t fwd_smem() {
  return static_cast<size_t>(kFwdRows + 4 * kFwdKeys) * (HD + 8) * 2;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFwdWarps * 32)
attention_fwd_kernel(const Params p) {
  using E = Elt<T>;
  constexpr int BR = kFwdRows, BC = kFwdKeys, NT = kFwdWarps * 32, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BR * LD;            // 2 buffers of BC rows
  T* sV = sK + 2 * BC * LD;        // 2 buffers of BC rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int BK = p.B * p.K, tiles = (p.M + BR - 1) / BR;
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x / BK);
  const int bk = blockIdx.x % BK, b = bk / p.K, kv = bk % p.K;
  const int f0 = tile * BR;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kv * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kv * p.v_sh;

  load_packed<T, HD, BR, NT>(sQ, qb, f0, p.M, p.G, kv, p.q_ss, p.q_sh);
  const int first_pos = f0 / p.G;
  const int last_pos = min(p.S - 1, (f0 + BR - 1) / p.G);
  const int t_end = p.causal ? min(p.T, last_pos + 1) : p.T;
  const int n = (t_end + BC - 1) / BC;
  load_keys<T, HD, BC, NT>(sK, kb, 0, p.T, p.k_st);
  load_keys<T, HD, BC, NT>(sV, vb, 0, p.T, p.v_st);
  cp_commit();

  const int ra = warp * 16 + (lane >> 2);          // rows ra, ra + 8
  const int pos_a = (f0 + ra) / p.G, pos_b = (f0 + ra + 8) / p.G;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  uint32_t qf[HD / 16][4];

  for (int j = 0; j < n; ++j) {
    const int buf = j & 1;
    if (j + 1 < n) {
      load_keys<T, HD, BC, NT>(sK + (buf ^ 1) * BC * LD, kb, (j + 1) * BC, p.T, p.k_st);
      load_keys<T, HD, BC, NT>(sV + (buf ^ 1) * BC * LD, vb, (j + 1) * BC, p.T, p.v_st);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) ldsm(qf[kk], sQ + a_off<LD>(warp * 16, kk * 16, lane));
    }
    const T* Ks = sK + buf * BC * LD;
    const T* Vs = sV + buf * BC * LD;

    float s[BC / 8][4];
#pragma unroll
    for (int t = 0; t < BC / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BC / 16; ++np) {
        uint32_t kf[4];
        ldsm(kf, Ks + bn_off<LD>(np * 16, kk * 16, lane));
        E::mma(s[2 * np], qf[kk], kf[0], kf[1]);
        E::mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }
    const int t0 = j * BC;
    if (t0 + BC > p.T || (p.causal && t0 + BC - 1 > first_pos)) {
#pragma unroll
      for (int t = 0; t < BC / 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + t * 8 + (lane & 3) * 2 + (e & 1);
          if (key >= p.T || (p.causal && key > (e < 2 ? pos_a : pos_b)))
            s[t][e] = -INFINITY;
        }
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int t = 0; t < BC / 8; ++t) {
      mx_a = fmaxf(mx_a, fmaxf(s[t][0], s[t][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[t][2], s[t][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    // a row with every key masked so far keeps l = 0 and acc = 0
    const float ms_a = mx_a == -INFINITY ? 0.f : mx_a * kLog2e;
    const float ms_b = mx_b == -INFINITY ? 0.f : mx_b * kLog2e;
    const float c_a = ex2(m_a * kLog2e - ms_a), c_b = ex2(m_b * kLog2e - ms_b);
    m_a = mx_a;
    m_b = mx_b;
    float rs_a = 0.f, rs_b = 0.f;
    uint32_t pf[BC / 16][4];
#pragma unroll
    for (int t = 0; t < BC / 8; ++t) {
      const uint32_t u01 = E::pack(ex2(fmaf(s[t][0], kLog2e, -ms_a)),
                                   ex2(fmaf(s[t][1], kLog2e, -ms_a)));
      const uint32_t u23 = E::pack(ex2(fmaf(s[t][2], kLog2e, -ms_b)),
                                   ex2(fmaf(s[t][3], kLog2e, -ms_b)));
      rs_a += E::lo(u01) + E::hi(u01);
      rs_b += E::lo(u23) + E::hi(u23);
      pf[t >> 1][(t & 1) * 2] = u01;
      pf[t >> 1][(t & 1) * 2 + 1] = u23;
    }
    l_a = l_a * c_a + rs_a;
    l_b = l_b * c_b + rs_b;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      acc[d][0] *= c_a; acc[d][1] *= c_a;
      acc[d][2] *= c_b; acc[d][3] *= c_b;
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vf[4];
        ldsm_t(vf, Vs + bk_off<LD>(kk * 16, dp * 16, lane));
        E::mma(acc[2 * dp], pf[kk], vf[0], vf[1]);
        E::mma(acc[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
  T* ob = static_cast<T*>(p.out);
  float* lb = p.lse + static_cast<long long>(bk) * p.M;
#pragma unroll
  for (int rw = 0; rw < 2; ++rw) {
    const int f = f0 + ra + rw * 8;
    if (f >= p.M) continue;
    const float den = rw ? d_b : d_a;
    const int pos = f / p.G, h = kv * p.G + f % p.G;
    T* row = ob + ((static_cast<long long>(b) * p.S + pos) * p.H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      *reinterpret_cast<uint32_t*>(row + d * 8 + (lane & 3) * 2) =
          E::pack(acc[d][rw * 2] / den, acc[d][rw * 2 + 1] / den);
    }
    if ((lane & 3) == 0) lb[f] = (rw ? m_b : m_a) + logf(den);
  }
}

// ---------------------------------------------------------------------------
// backward, 1 of 3: delta = rowsum(dout * out) in f32, 8 threads a row
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(256) attention_bwd_delta_kernel(const Params p) {
  using E = Elt<T>;
  const long long gid = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long row = gid >> 3, rows = static_cast<long long>(p.B) * p.S * p.H;
  const int part = static_cast<int>(gid & 7);
  float acc = 0.f;
  int b = 0, s = 0, h = 0;
  if (row < rows) {
    h = static_cast<int>(row % p.H);
    const long long bs = row / p.H;
    s = static_cast<int>(bs % p.S);
    b = static_cast<int>(bs / p.S);
    const T* o = static_cast<const T*>(p.o) + b * p.o_sb + s * p.o_ss + h * p.o_sh;
    const T* d = static_cast<const T*>(p.dout) + b * p.d_sb + s * p.d_ss + h * p.d_sh;
    for (int c = part; c < HD / 8; c += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + c * 8);
      const uint4 y = *reinterpret_cast<const uint4*>(d + c * 8);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc = fmaf(E::lo(xs[i]), E::lo(ys[i]), acc);
        acc = fmaf(E::hi(xs[i]), E::hi(ys[i]), acc);
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 4; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (row < rows && part == 0) {
    const int kv = h / p.G, g = h % p.G;
    p.delta[(static_cast<long long>(b) * p.K + kv) * p.M +
            static_cast<long long>(s) * p.G + g] = acc;
  }
}

// ---------------------------------------------------------------------------
// backward, 2 of 3: dK, dV.  One CTA of 4 warps per 64 keys of a (batch,
// KV head); each warp owns 16 keys and loops over tiles of BRQ packed
// query rows, computing S^T = K Q^T and dP^T = V dO^T so that P^T and
// dS^T land in registers as the A operands of dV += P^T dO and
// dK += dS^T Q.
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 4;
constexpr int kBwdKeys = 16 * kBwdWarps;

template <int HD> __host__ __device__ constexpr int dkdv_rows() { return HD <= 128 ? 32 : 16; }
template <int HD> constexpr size_t dkdv_smem() {
  return static_cast<size_t>(2 * kBwdKeys + 4 * dkdv_rows<HD>()) * (HD + 8) * 2 +
         4 * dkdv_rows<HD>() * sizeof(float);
}

// hd <= 64: at most 128 registers, so that four CTAs share an SM (of the
// tile sizes and occupancies tried at the main path's shape, the
// fastest: 5.46 ms against 5.90 with 64 query rows and three CTAs)
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdWarps * 32, HD <= 64 ? 4 : 1)
attention_bwd_dkdv_kernel(const Params p) {
  using E = Elt<T>;
  constexpr int BKC = kBwdKeys, BRQ = dkdv_rows<HD>(), NT = kBwdWarps * 32, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + BKC * LD;
  T* sQ = sV + BKC * LD;           // 2 buffers of BRQ rows
  T* sO = sQ + 2 * BRQ * LD;       // dO, 2 buffers
  float* sL = reinterpret_cast<float*>(sO + 2 * BRQ * LD);   // lse
  float* sD = sL + 2 * BRQ;                                  // delta
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int BK = p.B * p.K;
  const int kt = static_cast<int>(blockIdx.x / BK), bk = blockIdx.x % BK;
  const int b = bk / p.K, kv = bk % p.K, k0 = kt * BKC;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* db = static_cast<const T*>(p.dout) + b * p.d_sb;
  const float* lb = p.lse + static_cast<long long>(bk) * p.M;
  const float* deltab = p.delta + static_cast<long long>(bk) * p.M;

  load_keys<T, HD, BKC, NT>(sK, static_cast<const T*>(p.k) + b * p.k_sb + kv * p.k_sh,
                            k0, p.T, p.k_st);
  load_keys<T, HD, BKC, NT>(sV, static_cast<const T*>(p.v) + b * p.v_sb + kv * p.v_sh,
                            k0, p.T, p.v_st);
  const int n_qt = (p.M + BRQ - 1) / BRQ;
  const int first = p.causal
      ? static_cast<int>(min(static_cast<long long>(k0) * p.G,
                             static_cast<long long>(p.M)) / BRQ)
      : 0;
  auto load_q = [&](int qt, int buf) {
    const int f0 = qt * BRQ;
    load_packed<T, HD, BRQ, NT>(sQ + buf * BRQ * LD, qb, f0, p.M, p.G, kv, p.q_ss, p.q_sh);
    load_packed<T, HD, BRQ, NT>(sO + buf * BRQ * LD, db, f0, p.M, p.G, kv, p.d_ss, p.d_sh);
    // rows past M read lse 0 and delta 0: their dO and q are zeros, so
    // they add nothing to dV or dK
    for (int i = threadIdx.x; i < BRQ; i += NT) {
      const int f = f0 + i;
      const bool ok = f < p.M;
      cp4(sL + buf * BRQ + i, ok ? lb + f : lb, ok);
      cp4(sD + buf * BRQ + i, ok ? deltab + f : deltab, ok);
    }
  };
  if (first < n_qt) load_q(first, 0);
  cp_commit();

  const int ta = k0 + warp * 16 + (lane >> 2), tb = ta + 8;   // this thread's keys
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int qt = first; qt < n_qt; ++qt) {
    const int buf = (qt - first) & 1;
    if (qt + 1 < n_qt) {
      load_q(qt + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* Qs = sQ + buf * BRQ * LD;
    const T* Os = sO + buf * BRQ * LD;
    const float* L = sL + buf * BRQ;
    const float* D = sD + buf * BRQ;

    float st[BRQ / 8][4], dpt[BRQ / 8][4];
#pragma unroll
    for (int t = 0; t < BRQ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm(ka, sK + a_off<LD>(warp * 16, kk * 16, lane));
      ldsm(va, sV + a_off<LD>(warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < BRQ / 16; ++np) {
        uint32_t qf[4], of[4];
        ldsm(qf, Qs + bn_off<LD>(np * 16, kk * 16, lane));
        ldsm(of, Os + bn_off<LD>(np * 16, kk * 16, lane));
        E::mma(st[2 * np], ka, qf[0], qf[1]);
        E::mma(st[2 * np + 1], ka, qf[2], qf[3]);
        E::mma(dpt[2 * np], va, of[0], of[1]);
        E::mma(dpt[2 * np + 1], va, of[2], of[3]);
      }
    }
    const int f0 = qt * BRQ;
    const bool mask = p.causal && f0 / p.G < k0 + BKC - 1;
    uint32_t pa[BRQ / 16][4];
#pragma unroll
    for (int t = 0; t < BRQ / 8; ++t) {
      const int c = t * 8 + (lane & 3) * 2;
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c + (e & 1);
        float x = ex2(fmaf(st[t][e], kLog2e, -(L[col] * kLog2e)));
        if (mask && (e < 2 ? ta : tb) > (f0 + col) / p.G) x = 0.f;
        pr[e] = x;
      }
      const uint32_t u01 = E::pack(pr[0], pr[1]), u23 = E::pack(pr[2], pr[3]);
      pa[t >> 1][(t & 1) * 2] = u01;
      pa[t >> 1][(t & 1) * 2 + 1] = u23;
      st[t][0] = E::lo(u01); st[t][1] = E::hi(u01);
      st[t][2] = E::lo(u23); st[t][3] = E::hi(u23);
    }
#pragma unroll
    for (int kk = 0; kk < BRQ / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t f[4];
        ldsm_t(f, Os + bk_off<LD>(kk * 16, dp * 16, lane));
        E::mma(dv[2 * dp], pa[kk], f[0], f[1]);
        E::mma(dv[2 * dp + 1], pa[kk], f[2], f[3]);
      }
    }
#pragma unroll
    for (int t = 0; t < BRQ / 8; ++t) {
      const int c = t * 8 + (lane & 3) * 2;
      const float d0 = D[c], d1 = D[c + 1];
      pa[t >> 1][(t & 1) * 2] = E::pack(st[t][0] * (dpt[t][0] - d0), st[t][1] * (dpt[t][1] - d1));
      pa[t >> 1][(t & 1) * 2 + 1] =
          E::pack(st[t][2] * (dpt[t][2] - d0), st[t][3] * (dpt[t][3] - d1));
    }
#pragma unroll
    for (int kk = 0; kk < BRQ / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t f[4];
        ldsm_t(f, Qs + bk_off<LD>(kk * 16, dp * 16, lane));
        E::mma(dk[2 * dp], pa[kk], f[0], f[1]);
        E::mma(dk[2 * dp + 1], pa[kk], f[2], f[3]);
      }
    }
    __syncthreads();
  }

  T* dkb = static_cast<T*>(p.dk);
  T* dvb = static_cast<T*>(p.dv);
#pragma unroll
  for (int rw = 0; rw < 2; ++rw) {
    const int t = rw ? tb : ta;
    if (t >= p.T) continue;
    const long long row = ((static_cast<long long>(b) * p.T + t) * p.K + kv) * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const int col = d * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(dkb + row + col) =
          E::pack(dk[d][rw * 2], dk[d][rw * 2 + 1]);
      *reinterpret_cast<uint32_t*>(dvb + row + col) =
          E::pack(dv[d][rw * 2], dv[d][rw * 2 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, 3 of 3: dQ.  One CTA of 4 warps per 64 packed query rows of a
// (batch, KV head), looping over tiles of BC keys.
// ---------------------------------------------------------------------------

constexpr int kDqRows = 16 * kBwdWarps;

template <int HD> __host__ __device__ constexpr int dq_keys() { return HD <= 128 ? 64 : 32; }
template <int HD> constexpr size_t dq_smem() {
  return static_cast<size_t>(2 * kDqRows + 4 * dq_keys<HD>()) * (HD + 8) * 2;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_bwd_dq_kernel(const Params p) {
  using E = Elt<T>;
  constexpr int BR = kDqRows, BC = dq_keys<HD>(), NT = kBwdWarps * 32, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + BR * LD;
  T* sK = sO + BR * LD;            // 2 buffers of BC rows
  T* sV = sK + 2 * BC * LD;        // 2 buffers of BC rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int BK = p.B * p.K, tiles = (p.M + BR - 1) / BR;
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x / BK);
  const int bk = blockIdx.x % BK, b = bk / p.K, kv = bk % p.K;
  const int f0 = tile * BR;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kv * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kv * p.v_sh;

  load_packed<T, HD, BR, NT>(sQ, static_cast<const T*>(p.q) + b * p.q_sb, f0, p.M, p.G, kv,
                             p.q_ss, p.q_sh);
  load_packed<T, HD, BR, NT>(sO, static_cast<const T*>(p.dout) + b * p.d_sb, f0, p.M, p.G,
                             kv, p.d_ss, p.d_sh);
  const int first_pos = f0 / p.G;
  const int last_pos = min(p.S - 1, (f0 + BR - 1) / p.G);
  const int t_end = p.causal ? min(p.T, last_pos + 1) : p.T;
  const int n = (t_end + BC - 1) / BC;
  load_keys<T, HD, BC, NT>(sK, kb, 0, p.T, p.k_st);
  load_keys<T, HD, BC, NT>(sV, vb, 0, p.T, p.v_st);
  cp_commit();

  const int ra = warp * 16 + (lane >> 2);
  const int fa = f0 + ra, fb = fa + 8;
  const int pos_a = fa / p.G, pos_b = fb / p.G;
  const float* lb = p.lse + static_cast<long long>(bk) * p.M;
  const float* deltab = p.delta + static_cast<long long>(bk) * p.M;
  const float l2a = fa < p.M ? lb[fa] * kLog2e : INFINITY;
  const float l2b = fb < p.M ? lb[fb] * kLog2e : INFINITY;
  const float da = fa < p.M ? deltab[fa] : 0.f;
  const float db = fb < p.M ? deltab[fb] : 0.f;

  float dq[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int buf = j & 1;
    if (j + 1 < n) {
      load_keys<T, HD, BC, NT>(sK + (buf ^ 1) * BC * LD, kb, (j + 1) * BC, p.T, p.k_st);
      load_keys<T, HD, BC, NT>(sV + (buf ^ 1) * BC * LD, vb, (j + 1) * BC, p.T, p.v_st);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* Ks = sK + buf * BC * LD;
    const T* Vs = sV + buf * BC * LD;

    float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int t = 0; t < BC / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm(qa, sQ + a_off<LD>(warp * 16, kk * 16, lane));
      ldsm(oa, sO + a_off<LD>(warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < BC / 16; ++np) {
        uint32_t kf[4], vf[4];
        ldsm(kf, Ks + bn_off<LD>(np * 16, kk * 16, lane));
        ldsm(vf, Vs + bn_off<LD>(np * 16, kk * 16, lane));
        E::mma(s[2 * np], qa, kf[0], kf[1]);
        E::mma(s[2 * np + 1], qa, kf[2], kf[3]);
        E::mma(dp[2 * np], oa, vf[0], vf[1]);
        E::mma(dp[2 * np + 1], oa, vf[2], vf[3]);
      }
    }
    const int t0 = j * BC;
    const bool mask = t0 + BC > p.T || (p.causal && t0 + BC - 1 > first_pos);
    uint32_t pa[BC / 16][4];
#pragma unroll
    for (int t = 0; t < BC / 8; ++t) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + t * 8 + (lane & 3) * 2 + (e & 1);
        float x = ex2(fmaf(s[t][e], kLog2e, -(e < 2 ? l2a : l2b)));
        if (mask && (key >= p.T || (p.causal && key > (e < 2 ? pos_a : pos_b)))) x = 0.f;
        pr[e] = x;
      }
      const uint32_t u01 = E::pack(pr[0], pr[1]), u23 = E::pack(pr[2], pr[3]);
      pa[t >> 1][(t & 1) * 2] =
          E::pack(E::lo(u01) * (dp[t][0] - da), E::hi(u01) * (dp[t][1] - da));
      pa[t >> 1][(t & 1) * 2 + 1] =
          E::pack(E::lo(u23) * (dp[t][2] - db), E::hi(u23) * (dp[t][3] - db));
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        uint32_t f[4];
        ldsm_t(f, Ks + bk_off<LD>(kk * 16, d2 * 16, lane));
        E::mma(dq[2 * d2], pa[kk], f[0], f[1]);
        E::mma(dq[2 * d2 + 1], pa[kk], f[2], f[3]);
      }
    }
    __syncthreads();
  }

  T* dqb = static_cast<T*>(p.dq);
#pragma unroll
  for (int rw = 0; rw < 2; ++rw) {
    const int f = rw ? fb : fa;
    if (f >= p.M) continue;
    const int pos = f / p.G, h = kv * p.G + f % p.G;
    T* row = dqb + ((static_cast<long long>(b) * p.S + pos) * p.H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      *reinterpret_cast<uint32_t*>(row + d * 8 + (lane & 3) * 2) =
          E::pack(dq[d][rw * 2], dq[d][rw * 2 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, unsigned blocks, int threads, size_t smem, cudaStream_t st,
                   const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t fwd(const Params& p, cudaStream_t st) {
  const unsigned tiles = (p.M + kFwdRows - 1) / kFwdRows;
  return launch(attention_fwd_kernel<T, HD>, tiles * p.B * p.K, kFwdWarps * 32,
                fwd_smem<HD>(), st, p);
}

template <typename T, int HD>
cudaError_t bwd(const Params& p, cudaStream_t st) {
  const long long rows = static_cast<long long>(p.B) * p.S * p.H;
  attention_bwd_delta_kernel<T, HD>
      <<<static_cast<unsigned>((rows * 8 + 255) / 256), 256, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned key_tiles = (p.T + kBwdKeys - 1) / kBwdKeys;
  err = launch(attention_bwd_dkdv_kernel<T, HD>, key_tiles * p.B * p.K, kBwdWarps * 32,
               dkdv_smem<HD>(), st, p);
  if (err != cudaSuccess) return err;
  const unsigned q_tiles = (p.M + kDqRows - 1) / kDqRows;
  return launch(attention_bwd_dq_kernel<T, HD>, q_tiles * p.B * p.K, kBwdWarps * 32,
                dq_smem<HD>(), st, p);
}

// dims: B, S, T, H, K, hd, causal
// strides (elements): q, k, v, o, dout, each (batch, position, head)
Params make_params(const long long* dims, const long long* strides) {
  Params p = {};
  p.B = static_cast<int>(dims[0]);
  p.S = static_cast<int>(dims[1]);
  p.T = static_cast<int>(dims[2]);
  p.H = static_cast<int>(dims[3]);
  p.K = static_cast<int>(dims[4]);
  p.G = p.H / p.K;
  p.M = p.S * p.G;
  p.causal = static_cast<int>(dims[6]);
  long long* s[15] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_st, &p.k_sh,
                      &p.v_sb, &p.v_st, &p.v_sh, &p.o_sb, &p.o_ss, &p.o_sh,
                      &p.d_sb, &p.d_ss, &p.d_sh};
  for (int i = 0; i < 15; ++i) *s[i] = strides[i];
  return p;
}

template <typename T>
int fwd_by_dim(const Params& p, long long hd, cudaStream_t st) {
  switch (hd) {
    case 16: return static_cast<int>(fwd<T, 16>(p, st));
    case 64: return static_cast<int>(fwd<T, 64>(p, st));
    case 128: return static_cast<int>(fwd<T, 128>(p, st));
    case 160: return static_cast<int>(fwd<T, 160>(p, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int bwd_by_dim(const Params& p, long long hd, cudaStream_t st) {
  switch (hd) {
    case 16: return static_cast<int>(bwd<T, 16>(p, st));
    case 64: return static_cast<int>(bwd<T, 64>(p, st));
    case 128: return static_cast<int>(bwd<T, 128>(p, st));
    case 160: return static_cast<int>(bwd<T, 160>(p, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v: inputs read through `strides` (their first 9 entries); out:
// contiguous (B, S, H, hd); lse: f32 (B, K, S * H / K)
extern "C" int attention_fwd_launch(const void* q, const void* k, const void* v,
                                    void* out, void* lse, const long long* dims,
                                    const long long* strides, void* stream) {
  Params p = make_params(dims, strides);
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fwd_by_dim<__nv_bfloat16>(p, dims[5], st);
}

// q, k, v, o, dout read through `strides`; lse from the forward; delta:
// f32 scratch shaped as lse; dq: contiguous (B, S, H, hd); dk, dv:
// contiguous (B, T, K, hd)
extern "C" int attention_bwd_launch(const void* q, const void* k, const void* v,
                                    const void* o, const void* lse, const void* dout,
                                    void* delta, void* dq, void* dk, void* dv,
                                    const long long* dims, const long long* strides,
                                    void* stream) {
  Params p = make_params(dims, strides);
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bwd_by_dim<__nv_bfloat16>(p, dims[5], st);
}
