// Online-softmax (flash) attention forward on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_attention.py:_attn_kernel.
// For q, k, v of shape (B, H, S, D): o = softmax(scale * q k^T) v, optionally
// causal, with the running max m of the scaled scores and the running sum
// l = sum exp(s - m) of every row as (B, H, S) f32.  Scores past S, and above
// the diagonal under causal masking, are set to -1e30 as the TPU kernel's
// _NEG_INF; a row with l == 0 gives 0.  o is written in the input type.
//
// What bounds it: operations.  At the transformer slice's (8, 12, 1024, 64)
// causal it needs 4 D per (q, k) pair the mask keeps, 12.9 GFLOP, against
// 0.1 GB of q, k, v, o, m and l: 0.19 ms on the CUDA cores in f32, 0.078 ms
// for the three TF32 products below at the TF32 tensor-core rate, 0.015 ms
// of bytes in bf16.  So both products run on the tensor cores:
//
// Type policy.  f32 inputs run as 3xTF32: each operand x is split into
// hi = rna_tf32(x) and lo = rna_tf32(x - hi) (rna_tf32 rounds as
// cvt.rna.tf32.f32 does, with two integer instructions), and the f32
// accumulator takes lo*hi + hi*lo + hi*hi, which keeps about 1e-6 of f32
// (one TF32 product alone is off by about 1.5e-3, past the 2e-4 gate); the
// probabilities P are split the same way before P V.  bf16 inputs go to the
// tensor cores as bf16 with an f32 accumulator, and P is rounded to bf16 for
// P V, as FlashAttention does; l sums P in f32.  The running max, the sum,
// the accumulator and the rescaling are f32 in both.
//
// Design.  mma.sync (m16n8k8 TF32, m16n8k16 bf16), not wgmma: TF32 wgmma
// takes both operands K-major, so V would have to be transposed while it is
// staged; mma.sync takes V as it lies.  One block of four warps per (b*h,
// 64-row q tile); each warp owns 16 q rows, and the TPU's sequential third
// grid axis becomes a loop over 64-key tiles.  The q tile and two stages of
// k and v tiles live in shared memory, zero-padded in D to the template
// width kD (32, 64 or 128) and zero past S; the next k and v tiles are
// copied with cp.async.cg (16 B a copy, zero-filled past D and S) while the
// current ones compute.  S = q k^T stays in the accumulator registers; the
// row max is taken across the 4 lanes of a quad, the exponentials in base 2
// with log2(e) folded into the scale (m is converted back before it is
// stored), and l is summed per lane and across the quad once at the end.
// P stays in registers as the A operand of P V: for bf16 the C layout of
// two n8 tiles is the A layout of one k16 step; for TF32 the C fragment
// holds keys 2t and 2t+1 where A wants k indices t and t+4, so V's B
// fragment is read in that key order instead (the sum over keys does not
// depend on it).  V's bf16 fragments come from ldmatrix.trans.  Shared
// rows are padded (4 floats, 8 bf16) so that no fragment load conflicts on
// a bank.  Under causal masking the k tiles wholly above the diagonal are
// skipped, and the heaviest q tiles are scheduled first; scores are masked
// only in the tiles that need it.  q, k and v may be strided views (any
// strides over b, h and s, stride 1 over d), so the caller's head split
// needs no copy; o, m and l are contiguous.  cp.async needs 16-byte aligned
// rows; where a pointer or a stride is not, the same kernel stages its tiles
// with scalar loads instead (chosen from the pointers and strides).  It
// allocates nothing, launches on the caller's stream and does not
// synchronise.
//
// Plain C interface, loaded with ctypes (mxnet_tpu_torch/kernels/build.py).
// Each entry point returns the cudaError_t of its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // q rows of a block, 16 a warp
constexpr int kBlockK = 64;           // keys of a tile
constexpr int kRows = 64;             // rows of every staged tile (q, k or v)
constexpr int kSTiles = kBlockK / 8;  // n8 tiles of scores a warp holds
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kStaticSmemLimit = 48 * 1024;
static_assert(kBlockQ == kRows && kBlockK == kRows, "one tile shape for q, k and v");

struct Strides {
  int64_t b, h, s;
};

template <typename T>
struct Pad;  // elements added to every shared-memory row
template <>
struct Pad<float> {
  static constexpr int value = 4;
};
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int value = 8;
};

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rows [row0, row0 + 64) of one (b, h) slice into dst (row stride kD + pad
// elements): columns at or past D and rows at or past S are 0.
template <typename T, int kD, bool kAsync>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int64_t s_stride, int row0, int S, int D) {
  constexpr int kLd = kD + Pad<T>::value;
  if constexpr (kAsync) {
    constexpr int kVec = 16 / sizeof(T);  // elements a copy
    constexpr int kChunks = kD / kVec;    // copies a row
    for (int e = threadIdx.x; e < kRows * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e % kChunks) * kVec;
      const int row = row0 + r;
      const bool in = row < S && c < D;
      // src-size below 16 zero-fills the rest of the copy
      const uint32_t bytes = in ? static_cast<uint32_t>(min(kVec, D - c) * sizeof(T)) : 0u;
      const T* g = in ? src + row * s_stride + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + r * kLd + c)),
                   "l"(g), "r"(bytes)
                   : "memory");
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kD; e += kThreads) {
      const int r = e / kD;
      const int c = e % kD;
      const int row = row0 + r;
      dst[r * kLd + c] = (row < S && c < D) ? src[row * s_stride + c] : zero_of(T());
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// cvt.rna.tf32.f32 of a finite x: round the magnitude to 10 mantissa bits,
// to nearest, ties away from zero, by adding half of the dropped 13 bits
// and clearing them (the sign bit stays apart).  Two integer instructions:
// the cvt instruction itself compiles on sm_90a to a longer sequence with a
// NaN test, and the f32 kernel ran 1.5x slower with it (PERF.md).  An
// infinite or NaN x still gives a NaN product through lo.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo to about 2^-22 relative, each part a TF32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The hi and lo parts of kA operand registers.
template <int kA>
struct Split {
  uint32_t hi[kA], lo[kA];
  __device__ __forceinline__ explicit Split(const float (&x)[kA]) {
#pragma unroll
    for (int i = 0; i < kA; ++i) split_tf32(x[i], hi[i], lo[i]);
  }
};

// c += a b in 3xTF32 from split operands: the hi*hi product last, after the
// two small ones
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split<4>& a,
                                           const Split<2>& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragments of lane (g, t) = (lane / 4, lane % 4), as the PTX ISA lays out
// mma.m16n8k8 (TF32) and mma.m16n8k16 (bf16): A row g and g + 8; B column g;
// C rows g and g + 8, columns 2t and 2t + 1.

// s[j] += q_w k_j^T for the warp's 16 rows (qw) and keys 8j..8j+7 (kt).
template <int kD>
__device__ __forceinline__ void qk(float (&s)[kSTiles][4], const float* qw, const float* kt,
                                   int g, int t) {
  constexpr int kLd = kD + Pad<float>::value;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const float qa[4] = {qw[g * kLd + 8 * kk + t], qw[(g + 8) * kLd + 8 * kk + t],
                         qw[g * kLd + 8 * kk + t + 4], qw[(g + 8) * kLd + 8 * kk + t + 4]};
    const Split<4> a(qa);
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      const float* kr = kt + (8 * j + g) * kLd + 8 * kk;
      const float kb[2] = {kr[t], kr[t + 4]};
      mma_3xtf32(s[j], a, Split<2>(kb));
    }
  }
}

template <int kD>
__device__ __forceinline__ void qk(float (&s)[kSTiles][4], const __nv_bfloat16* qw,
                                   const __nv_bfloat16* kt, int g, int t) {
  constexpr int kLd = kD + Pad<__nv_bfloat16>::value;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
    const uint32_t a[4] = {lds32(qw + g * kLd + c), lds32(qw + (g + 8) * kLd + c),
                           lds32(qw + g * kLd + c + 8), lds32(qw + (g + 8) * kLd + c + 8)};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      const __nv_bfloat16* kr = kt + (8 * j + g) * kLd + c;
      const uint32_t b[2] = {lds32(kr), lds32(kr + 8)};
      mma_bf16(s[j], a, b);
    }
  }
}

// o[n] += p v_n for dims 8n..8n+7, P in the score registers.  TF32: the A
// operand of k step kk takes keys 8kk + 2t and 8kk + 2t + 1 as k indices t
// and t + 4, so B's rows t and t + 4 are read from those keys.
template <int kD>
__device__ __forceinline__ void pv(float (&o)[kD / 8][4], const float (&p)[kSTiles][4],
                                   const float* vt, int lane) {
  constexpr int kLd = kD + Pad<float>::value;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kSTiles; ++kk) {
    const float pa[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
    const Split<4> a(pa);
    const float* v0 = vt + (8 * kk + 2 * t) * kLd + g;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const float vb[2] = {v0[8 * n], v0[kLd + 8 * n]};
      mma_3xtf32(o[n], a, Split<2>(vb));
    }
  }
}

// bf16: the C fragments of score tiles 2i and 2i + 1 are the A fragment of
// k step i; V's B fragments for two n8 tiles at once from ldmatrix.trans.
template <int kD>
__device__ __forceinline__ void pv(float (&o)[kD / 8][4], const float (&p)[kSTiles][4],
                                   const __nv_bfloat16* vt, int lane) {
  constexpr int kLd = kD + Pad<__nv_bfloat16>::value;
#pragma unroll
  for (int i = 0; i < kSTiles / 2; ++i) {
    const uint32_t a[4] = {pack_bf16(p[2 * i][0], p[2 * i][1]),
                           pack_bf16(p[2 * i][2], p[2 * i][3]),
                           pack_bf16(p[2 * i + 1][0], p[2 * i + 1][1]),
                           pack_bf16(p[2 * i + 1][2], p[2 * i + 1][3])};
    const __nv_bfloat16* row = vt + (16 * i + (lane & 15)) * kLd + (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      uint32_t b0[2], b1[2];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
          : "r"(smem_addr(row + 16 * n)));
      mma_bf16(o[2 * n], a, b0);
      mma_bf16(o[2 * n + 1], a, b1);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int kD, bool kAsync>
__global__ void __launch_bounds__(kThreads)
    flash_attn_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ m_out, float* __restrict__ l_out, int H,
                          int S, int D, Strides qs, Strides ks, Strides vs, float scale,
                          int causal) {
  constexpr int kLd = kD + Pad<T>::value;
  constexpr int kTile = kRows * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kTile;      // two stages
  T* Vs = Ks + 2 * kTile;  // two stages

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int qt = static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y);  // heaviest first
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  const int n_kt_all = (S + kBlockK - 1) / kBlockK;
  // causal: a k tile whose first key lies past the q tile's last row adds nothing
  const int n_kt = causal ? min(n_kt_all, (q0 + kBlockQ - 1) / kBlockK + 1) : n_kt_all;

  load_tile<T, kD, kAsync>(Qs, qb, qs.s, q0, S, D);
  load_tile<T, kD, kAsync>(Ks, kb, ks.s, 0, S, D);
  load_tile<T, kD, kAsync>(Vs, vb, vs.s, 0, S, D);
  if constexpr (kAsync) cp_async_commit();

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max (base 2) and this lane's
  // share of the running sum
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  const float scale2 = scale * kLog2e;
  const int row_g = q0 + 16 * warp + g;
  const T* qw = Qs + 16 * warp * kLd;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    const int stage = kt & 1;
    if (kt + 1 < n_kt) {  // the next tiles into the other stage, in flight during this one
      load_tile<T, kD, kAsync>(Ks + (stage ^ 1) * kTile, kb, ks.s, k0 + kBlockK, S, D);
      load_tile<T, kD, kAsync>(Vs + (stage ^ 1) * kTile, vb, vs.s, k0 + kBlockK, S, D);
      if constexpr (kAsync) {
        cp_async_commit();
        cp_async_wait<1>();
      }
    } else if constexpr (kAsync) {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    qk<kD>(s, qw, Ks + stage * kTile, g, t);

    const bool masked = k0 + kBlockK > S || (causal && k0 + kBlockK - 1 > q0);
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row_g + 8 * (e >> 1);
        const bool keep = !masked || (key < S && (!causal || key <= row));
        s[j][e] = keep ? s[j][e] * scale2 : kNegInf;
      }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m_r[r], quad_max(mx));
      const float corr = exp2f(m_r[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_new);
          ps += s[j][e];
        }
      l_r[r] = l_r[r] * corr + ps;
      m_r[r] = m_new;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    pv<kD>(acc, s, Vs + stage * kTile, lane);
    __syncthreads();  // this stage is refilled by the next iteration's copies
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    const float l = quad_sum(l_r[r]);
    if (row >= S) continue;
    const int64_t out = static_cast<int64_t>(bh) * S + row;
    const float inv_l = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D) store(o + out * D + col, acc[n][2 * r] * inv_l);
      if (col + 1 < D) store(o + out * D + col + 1, acc[n][2 * r + 1] * inv_l);
    }
    if (t == 0) {
      m_out[out] = m_r[r] == kNegInf ? kNegInf : m_r[r] * kLn2;
      l_out[out] = l;
    }
  }
}

template <typename T, int kD, bool kAsync>
int launch_d(const void* q, const void* k, const void* v, void* o, void* m, void* l,
             int BH, int H, int S, int D, Strides qs, Strides ks, Strides vs, float scale,
             int causal, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 5 * kRows * (kD + Pad<T>::value);
  auto kernel = flash_attn_mma_kernel<T, kD, kAsync>;
  if (smem > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(BH, (S + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(m), static_cast<float*>(l), H, S, D, qs, ks,
      vs, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_align(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                 int BH, int H, int S, int D, Strides qs, Strides ks, Strides vs,
                 float scale, int causal, cudaStream_t stream) {
  // cp.async copies 16 aligned bytes: every row of q, k and v must start on 16 B
  constexpr int64_t kVec = 16 / sizeof(T);
  bool aligned = true;
  for (const void* p : {q, k, v}) aligned &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const Strides& st : {qs, ks, vs})
    aligned &= st.b % kVec == 0 && st.h % kVec == 0 && st.s % kVec == 0;
  if (aligned)
    return launch_d<T, kD, true>(q, k, v, o, m, l, BH, H, S, D, qs, ks, vs, scale, causal,
                                 stream);
  return launch_d<T, kD, false>(q, k, v, o, m, l, BH, H, S, D, qs, ks, vs, scale, causal,
                                stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* m, void* l, int B,
           int H, int S, int D, const int64_t* st, float scale, int causal,
           void* stream_ptr) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int BH = B * H;
  if (D >= 1 && D <= 32)
    return launch_align<T, 32>(q, k, v, o, m, l, BH, H, S, D, qs, ks, vs, scale, causal,
                               stream);
  if (D > 32 && D <= 64)
    return launch_align<T, 64>(q, k, v, o, m, l, BH, H, S, D, qs, ks, vs, scale, causal,
                               stream);
  if (D > 64 && D <= 128)
    return launch_align<T, 128>(q, k, v, o, m, l, BH, H, S, D, qs, ks, vs, scale, causal,
                                stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, k, v: (B, H, S, D) float32 views with strides st[0:3], st[3:6], st[6:9]
// over (b, h, s) and 1 over d; o: (B, H, S, D) float32 contiguous;
// m, l: (B, H, S) float32 contiguous.  D <= 128.
int flash_attn_forward_f32(const void* q, const void* k, const void* v, void* o, void* m,
                           void* l, int B, int H, int S, int D, const int64_t* strides,
                           float scale, int causal, void* stream) {
  return launch<float>(q, k, v, o, m, l, B, H, S, D, strides, scale, causal, stream);
}

// As flash_attn_forward_f32 with bfloat16 q, k, v and o (m, l stay float32).
int flash_attn_forward_bf16(const void* q, const void* k, const void* v, void* o, void* m,
                            void* l, int B, int H, int S, int D, const int64_t* strides,
                            float scale, int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, m, l, B, H, S, D, strides, scale, causal,
                               stream);
}

}  // extern "C"
