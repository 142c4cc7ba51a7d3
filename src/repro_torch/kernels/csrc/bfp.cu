// 2D block floating point (BFP) kernels for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of repro/kernels:
//   bfp_matmul          bfp_matmul.py::_bfp_matmul_kernel (bfp_matmul :61)
//   bfp_quantize        bfp_quant.py::_quant_kernel (bfp_quantize_pallas :33)
//   bfp_matmul_packed   bfp_quant.py::_packed_matmul_kernel (:92)
// and the in-tile helpers of bfp_common.py as device functions.  The
// arithmetic is the reference's, bit for bit:
//   exponent  e = clip(floor_log2(max |x| over the g x g group),
//                      -2^(ebits-1), 2^(ebits-1) - 1), floor_log2 taken from
//             the f32 bit pattern (biased exponent - 127; zeros and
//             subnormals give -127 before the clip);
//   mantissa  clip(rint(x * 2^-(e-mbits+1)), +-(2^mbits - 1)), rintf rounding
//             half to even as jnp.round does;
//   value     mantissa * 2^(e-mbits+1), both powers of two made by ldexpf
//             (exact).  Multiplying by the exact inverse power equals the
//             reference's division: both round the same real number.
// The wrapper admits 1 <= mbits, ebits <= 7, so every power of two stays a
// normal f32 and every mantissa fits int8.
//
// Tiles.  Every CTA works on 96 x 96 tiles anchored at multiples of 96 from
// the origin.  96 is a multiple of each supported group (3, 8, 16, 32), so
// a tile holds whole groups of the global grid and its in-tile group max is
// the global one; rows and columns past the matrix read as zeros, which is
// what the reference's zero padding gives.  Any other group is refused
// (cudaErrorInvalidValue); nothing falls back.
//
// Products.  A BFP value is at most a 7-bit integer times a power of two, so
// it is exact in bf16, and so is an int8 mantissa.  Each operand tile is
// quantized (or dequantized) into shared memory as bf16 and multiplied with
// mma.sync m16n8k16 (bf16 in, f32 accumulate): 8 warps, each a 48 x 24 block
// of the 96 x 96 output tile.  The result equals the f32 reference up to the
// order of the f32 sums.  Operands are read through element strides, so the
// transposed views of bfp_dense's backward (x2^T, w^T) go in without a copy;
// a tile is staged along whichever dimension has stride 1, so the global
// reads coalesce either way.  The output is a contiguous (M, N) f32 array.
//
// What bounds them on the H100.  bfp_matmul at the slice's full width
// (M=8192, K=4096, N=12800): 2MKN = 8.6e11 operations, 0.43 ms at the int8
// tensor-core rate (the least the card could take: mantissas fit int8 and a
// 32-wide K group is one int8 k32 step), 0.87 ms at the bf16 rate this
// kernel runs at, against 763 MB of f32 in and out (0.23 ms at 3.35 TB/s):
// operations bound.  This simple design re-quantizes each A tile for every
// column of CTAs and each B tile for every row of CTAs in SIMT
// instructions, and keeps one K step in flight (stage, barrier, mma,
// barrier; no cp.async).  How the time splits between the two is not
// measured; bfp_matmul_packed, which quantizes nothing but runs the same
// loop, takes about two thirds of bfp_matmul's time on an H100, so the loop
// structure costs at least as much as the re-quantization.  What the
// design does about it: both operands of a K step stay on chip after one
// global read, and two CTAs per SM let one CTA's staging and quantization
// overlap the other's products.  The storage path (bfp_quantize once, then
// bfp_matmul_packed) removes the re-quantization.  bfp_quantize is bytes
// bound: f32 in, int8 out, 168 MB for an 8192 x 4096 operand, 0.05 ms.
//
// Each C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for an unsupported
// group, dtype or bit width).
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 96;            // tile side: a multiple of 3, 8, 16, 32
constexpr int kThreads = 256;     // 8 warps
constexpr int kFP = kT + 1;       // f32 staging pitch (floats)
constexpr int kHP = kT + 8;       // bf16 operand pitch: 208 bytes, an odd
                                  // count of 16-byte chunks (ldmatrix reads
                                  // free of bank conflicts)
constexpr int kMaxGroups = 32 * 32;  // groups per tile at g = 3
constexpr int kPerThread = kT * kT / kThreads;   // tile elements a thread moves
static_assert(kT * kT % kThreads == 0, "whole tile per pass");

// Shared memory layout (bytes).  bfp_quantize uses the part up to kSmemQuant.
constexpr int kOffF = 0;                                // float [kT][kFP]
constexpr int kOffScale = kOffF + kT * kFP * 4;         // float [kMaxGroups]
constexpr int kOffInv = kOffScale + kMaxGroups * 4;     // float [kMaxGroups]
constexpr int kOffSeg = kOffInv + kMaxGroups * 4;       // u8 [kT][32]
constexpr int kOffExp = kOffSeg + kT * 32;              // i8 [kMaxGroups]
constexpr int kSmemQuant = kOffExp + kMaxGroups;
constexpr int kOffA = kSmemQuant;                       // bf16 [kT][kHP]
constexpr int kOffB = kOffA + kT * kHP * 2;             // bf16 [kT][kHP]
constexpr int kSmemMatmul = kOffB + kT * kHP * 2;
static_assert(kOffA % 16 == 0 && kOffB % 16 == 0, "ldmatrix alignment");

struct Tiles {
  float* F;
  float* scale;
  float* inv;
  unsigned char* seg;
  int8_t* exp;
  bf16* A;
  bf16* B;
};

__device__ __forceinline__ Tiles carve(unsigned char* s) {
  return {reinterpret_cast<float*>(s + kOffF),
          reinterpret_cast<float*>(s + kOffScale),
          reinterpret_cast<float*>(s + kOffInv), s + kOffSeg,
          reinterpret_cast<int8_t*>(s + kOffExp),
          reinterpret_cast<bf16*>(s + kOffA),
          reinterpret_cast<bf16*>(s + kOffB)};
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Element i of a tile walk: (row, col) with consecutive threads on the
// dimension whose stride is 1, so global accesses coalesce.
__device__ __forceinline__ void tile_pos(int i, bool col_major, int& r,
                                         int& c) {
  const int a = i / kT, b = i % kT;
  r = col_major ? b : a;
  c = col_major ? a : b;
}

// Stage rows [r0, r0+kT) x cols [c0, c0+kT) of a rows x cols matrix (element
// strides rs, cs) into F as f32; outside the matrix reads 0.  Each thread
// issues all of its loads before its first store, so they are in flight
// together rather than one global-memory latency each.
template <typename T>
__device__ void stage_tile(float* F, const T* src, int rows, int cols,
                           long long rs, long long cs, int r0, int c0) {
  const bool col_major = cs != 1 && rs == 1;
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    int r, c;
    tile_pos(threadIdx.x + j * kThreads, col_major, r, c);
    const int gr = r0 + r, gc = c0 + c;
    v[j] = gr < rows && gc < cols ? to_f32(src[gr * rs + gc * cs]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    int r, c;
    tile_pos(threadIdx.x + j * kThreads, col_major, r, c);
    F[r * kFP + c] = v[j];
  }
}

// Group exponents of the staged tile (bfp_common.group_exponent): the max
// biased exponent over each g-wide row segment, then over g segments; also
// the exact scale 2^(e-mbits+1) and its inverse.  Ends with a barrier.
template <int G>
__device__ void group_scales(const Tiles& t, int mbits, int ebits) {
  constexpr int NG = kT / G;   // groups per tile side
  for (int s = threadIdx.x; s < kT * NG; s += kThreads) {
    const int r = s / NG, gc = s % NG;
    const float* row = t.F + r * kFP + gc * G;
    unsigned int e = 0;
#pragma unroll
    for (int j = 0; j < G; ++j)
      e = max(e, (__float_as_uint(row[j]) >> 23) & 0xFFu);
    t.seg[r * NG + gc] = static_cast<unsigned char>(e);
  }
  __syncthreads();
  const int lo = -(1 << (ebits - 1)), hi = (1 << (ebits - 1)) - 1;
  for (int q = threadIdx.x; q < NG * NG; q += kThreads) {
    const int gr = q / NG, gc = q % NG;
    unsigned int e = 0;
#pragma unroll
    for (int j = 0; j < G; ++j)
      e = max(e, static_cast<unsigned int>(t.seg[(gr * G + j) * NG + gc]));
    const int ex = min(max(static_cast<int>(e) - 127, lo), hi);
    t.exp[q] = static_cast<int8_t>(ex);
    t.scale[q] = ldexpf(1.f, ex - (mbits - 1));
    t.inv[q] = ldexpf(1.f, (mbits - 1) - ex);
  }
  __syncthreads();
}

template <int G>
__device__ __forceinline__ float mantissa(const Tiles& t, int r, int c,
                                          float lim, int& q) {
  q = (r / G) * (kT / G) + c / G;
  return fminf(fmaxf(rintf(t.F[r * kFP + c] * t.inv[q]), -lim), lim);
}

// Quantize->dequantize one operand tile into H as bf16 (bfp_common.qdq_block);
// returns whether any value of the tile is nonzero, for every thread.
template <typename T, int G>
__device__ int qdq_tile(const Tiles& t, bf16* H, const T* src, int rows,
                        int cols, long long rs, long long cs, int r0, int c0,
                        int mbits, int ebits, float lim) {
  __syncthreads();   // the previous readers of F and H are done
  stage_tile(t.F, src, rows, cols, rs, cs, r0, c0);
  __syncthreads();
  group_scales<G>(t, mbits, ebits);
  int nz = 0;
  for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
    const int r = i / kT, c = i % kT;
    int q;
    const float m = mantissa<G>(t, r, c, lim, q);
    nz |= m != 0.f;
    H[r * kHP + c] = __float2bfloat16_rn(m * t.scale[q]);
  }
  return __syncthreads_or(nz);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A (kT x kT, row-major bf16) * B (kT x kT, row-major bf16) for this
// warp's 48 x 24 block: warps 2 (rows) x 4 (columns).
__device__ __forceinline__ void mma_tile(const bf16* A, const bf16* B,
                                         float (&acc)[3][3][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp / 4) * 48, col0 = (warp % 4) * 24;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    uint32_t af[3][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      ldmatrix_x4(af[i], A + (row0 + i * 16 + (lane % 16)) * kHP + kk * 16 +
                             (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1,
                        B + (kk * 16 + (lane % 16)) * kHP + col0 + j * 8);
#pragma unroll
      for (int i = 0; i < 3; ++i) mma_bf16(acc[i][j], af[i], b0, b1);
    }
  }
}

__device__ __forceinline__ void store_tile(float* C, int m, int n, int m0,
                                           int n0,
                                           const float (&acc)[3][3][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + (warp / 4) * 48, col0 = n0 + (warp % 4) * 24;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + i * 16 + g + (e / 2) * 8;
        const int c = col0 + j * 8 + 2 * t4 + (e % 2);
        if (r < m && c < n) C[static_cast<long long>(r) * n + c] = acc[i][j][e];
      }
}

// C = Q(A) Q(B); one CTA per 96 x 96 output tile, K walked in 96-wide steps.
// skip_zero: the tile-level gate of the reference (skip the product when
// either quantized operand tile is all zero), which changes no value.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 2)
bfp_matmul_kernel(const T* a, const T* b, float* c, int m, int k, int n,
                  long long a_rs, long long a_cs, long long b_rs,
                  long long b_cs, int mbits, int ebits, int skip_zero) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles t = carve(smem);
  const int m0 = blockIdx.y * kT, n0 = blockIdx.x * kT;
  const float lim = static_cast<float>((1 << mbits) - 1);
  float acc[3][3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kT) {
    const int nz_a = qdq_tile<T, G>(t, t.A, a, m, k, a_rs, a_cs, m0, k0,
                                    mbits, ebits, lim);
    const int nz_b = qdq_tile<T, G>(t, t.B, b, k, n, b_rs, b_cs, k0, n0,
                                    mbits, ebits, lim);
    if (!skip_zero || (nz_a && nz_b)) mma_tile(t.A, t.B, acc);
  }
  store_tile(c, m, n, m0, n0, acc);
}

// x (m x n) -> mant (mp x np, contiguous) and exp (mp/G x np/G, contiguous);
// one CTA per 96 x 96 tile of the padded output.  The padded region is
// quantized from zeros, as the reference pads before quantizing.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
bfp_quantize_kernel(const T* x, int m, int n, long long rs, long long cs,
                    int8_t* mant, int8_t* exps, int mp, int np, int mbits,
                    int ebits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles t = carve(smem);
  constexpr int NG = kT / G;
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  const float lim = static_cast<float>((1 << mbits) - 1);
  stage_tile(t.F, x, m, n, rs, cs, r0, c0);
  __syncthreads();
  group_scales<G>(t, mbits, ebits);
  for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
    const int r = i / kT, c = i % kT;
    if (r0 + r >= mp || c0 + c >= np) continue;
    int q;
    const float v = mantissa<G>(t, r, c, lim, q);
    mant[static_cast<long long>(r0 + r) * np + c0 + c] =
        static_cast<int8_t>(v);
  }
  const int egr = mp / G, egc = np / G;
  for (int q = threadIdx.x; q < NG * NG; q += kThreads) {
    const int gr = r0 / G + q / NG, gc = c0 / G + q % NG;
    if (gr < egr && gc < egc)
      exps[static_cast<long long>(gr) * egc + gc] = t.exp[q];
  }
}

// Dequantize one packed operand tile into H as bf16 (bfp_common.dequant_block):
// mant * 2^(exp - mbits + 1), zeros past the matrix.  The int8 mantissas go
// from registers straight to bf16, with all of a thread's loads in flight
// before its first store.
template <int G>
__device__ void dequant_tile(const Tiles& t, bf16* H, const int8_t* mant,
                             const int8_t* exps, int rows, int cols,
                             long long rs, long long cs, long long ers,
                             long long ecs, int r0, int c0, int mbits) {
  constexpr int NG = kT / G;
  __syncthreads();   // the previous readers of H and the scales are done
  for (int q = threadIdx.x; q < NG * NG; q += kThreads) {
    const int gr = r0 / G + q / NG, gc = c0 / G + q % NG;
    const bool ok = gr * G < rows && gc * G < cols;
    const int e = ok ? exps[gr * ers + gc * ecs] : 0;
    t.scale[q] = ldexpf(1.f, e - (mbits - 1));
  }
  __syncthreads();
  const bool col_major = cs != 1 && rs == 1;
  int v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    int r, c;
    tile_pos(threadIdx.x + j * kThreads, col_major, r, c);
    const int gr = r0 + r, gc = c0 + c;
    v[j] = gr < rows && gc < cols ? mant[gr * rs + gc * cs] : 0;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    int r, c;
    tile_pos(threadIdx.x + j * kThreads, col_major, r, c);
    H[r * kHP + c] = __float2bfloat16_rn(static_cast<float>(v[j]) *
                                         t.scale[(r / G) * NG + c / G]);
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads, 2)
bfp_matmul_packed_kernel(const int8_t* am, const int8_t* ae,
                         const int8_t* bm, const int8_t* be, float* c, int m,
                         int k, int n, long long am_rs, long long am_cs,
                         long long ae_rs, long long ae_cs, long long bm_rs,
                         long long bm_cs, long long be_rs, long long be_cs,
                         int mbits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles t = carve(smem);
  const int m0 = blockIdx.y * kT, n0 = blockIdx.x * kT;
  float acc[3][3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kT) {
    dequant_tile<G>(t, t.A, am, ae, m, k, am_rs, am_cs, ae_rs, ae_cs, m0, k0,
                    mbits);
    dequant_tile<G>(t, t.B, bm, be, k, n, bm_rs, bm_cs, be_rs, be_cs, k0, n0,
                    mbits);
    __syncthreads();
    mma_tile(t.A, t.B, acc);
  }
  store_tile(c, m, n, m0, n0, acc);
}

bool bits_ok(int mbits, int ebits) {
  return mbits >= 1 && mbits <= 7 && ebits >= 1 && ebits <= 7;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

dim3 tiles(int rows, int cols) {
  return dim3((cols + kT - 1) / kT, (rows + kT - 1) / kT);
}

template <typename T, int G>
cudaError_t matmul_g(const void* a, const void* b, float* c, int m, int k,
                     int n, long long a_rs, long long a_cs, long long b_rs,
                     long long b_cs, int mbits, int ebits, int skip_zero,
                     cudaStream_t st) {
  return launch(bfp_matmul_kernel<T, G>, tiles(m, n), kSmemMatmul, st,
                static_cast<const T*>(a), static_cast<const T*>(b), c, m, k,
                n, a_rs, a_cs, b_rs, b_cs, mbits, ebits, skip_zero);
}

template <typename T>
cudaError_t matmul_t(int group, const void* a, const void* b, float* c, int m,
                     int k, int n, long long a_rs, long long a_cs,
                     long long b_rs, long long b_cs, int mbits, int ebits,
                     int skip_zero, cudaStream_t st) {
  switch (group) {
    case 3: return matmul_g<T, 3>(a, b, c, m, k, n, a_rs, a_cs, b_rs, b_cs,
                                  mbits, ebits, skip_zero, st);
    case 8: return matmul_g<T, 8>(a, b, c, m, k, n, a_rs, a_cs, b_rs, b_cs,
                                  mbits, ebits, skip_zero, st);
    case 16: return matmul_g<T, 16>(a, b, c, m, k, n, a_rs, a_cs, b_rs, b_cs,
                                    mbits, ebits, skip_zero, st);
    case 32: return matmul_g<T, 32>(a, b, c, m, k, n, a_rs, a_cs, b_rs, b_cs,
                                    mbits, ebits, skip_zero, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int G>
cudaError_t quantize_g(const void* x, int m, int n, long long rs,
                       long long cs, int8_t* mant, int8_t* exps, int mp,
                       int np, int mbits, int ebits, cudaStream_t st) {
  return launch(bfp_quantize_kernel<T, G>, tiles(mp, np), kSmemQuant, st,
                static_cast<const T*>(x), m, n, rs, cs, mant, exps, mp, np,
                mbits, ebits);
}

template <typename T>
cudaError_t quantize_t(int group, const void* x, int m, int n, long long rs,
                       long long cs, int8_t* mant, int8_t* exps, int mp,
                       int np, int mbits, int ebits, cudaStream_t st) {
  switch (group) {
    case 3: return quantize_g<T, 3>(x, m, n, rs, cs, mant, exps, mp, np,
                                    mbits, ebits, st);
    case 8: return quantize_g<T, 8>(x, m, n, rs, cs, mant, exps, mp, np,
                                    mbits, ebits, st);
    case 16: return quantize_g<T, 16>(x, m, n, rs, cs, mant, exps, mp, np,
                                      mbits, ebits, st);
    case 32: return quantize_g<T, 32>(x, m, n, rs, cs, mant, exps, mp, np,
                                      mbits, ebits, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int G>
cudaError_t packed_g(const int8_t* am, const int8_t* ae, const int8_t* bm,
                     const int8_t* be, float* c, int m, int k, int n,
                     const long long* s, int mbits, cudaStream_t st) {
  return launch(bfp_matmul_packed_kernel<G>, tiles(m, n), kSmemMatmul, st,
                am, ae, bm, be, c, m, k, n, s[0], s[1], s[2], s[3], s[4],
                s[5], s[6], s[7], mbits);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (both operands).  Strides in elements.
// c: contiguous (m, n) float32.  Returns a cudaError_t value (0 = success).
extern "C" int bfp_matmul_fwd(const void* a, const void* b, float* c,
                              int dtype, int m, int k, int n, long long a_rs,
                              long long a_cs, long long b_rs, long long b_cs,
                              int group, int mbits, int ebits, int skip_zero,
                              void* stream) {
  if (!bits_ok(mbits, ebits)) return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return matmul_t<float>(group, a, b, c, m, k, n, a_rs, a_cs, b_rs,
                                   b_cs, mbits, ebits, skip_zero, st);
    case 1: return matmul_t<bf16>(group, a, b, c, m, k, n, a_rs, a_cs, b_rs,
                                  b_cs, mbits, ebits, skip_zero, st);
    default: return cudaErrorInvalidValue;
  }
}

// x: (m, n) with element strides; mant: contiguous (mp, np) int8; exps:
// contiguous (mp/group, np/group) int8; mp, np multiples of group.
extern "C" int bfp_quantize_fwd(const void* x, int dtype, int m, int n,
                                long long rs, long long cs, int8_t* mant,
                                int8_t* exps, int mp, int np, int group,
                                int mbits, int ebits, void* stream) {
  if (!bits_ok(mbits, ebits) || group <= 0 || mp % group || np % group ||
      mp < m || np < n)
    return cudaErrorInvalidValue;
  if (mp == 0 || np == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return quantize_t<float>(group, x, m, n, rs, cs, mant, exps, mp,
                                     np, mbits, ebits, st);
    case 1: return quantize_t<bf16>(group, x, m, n, rs, cs, mant, exps, mp,
                                    np, mbits, ebits, st);
    default: return cudaErrorInvalidValue;
  }
}

// Packed operands: mantissas (m, k) and (k, n), exponents (m/g, k/g) and
// (k/g, n/g), all int8 with element strides (s: am_rs, am_cs, ae_rs, ae_cs,
// bm_rs, bm_cs, be_rs, be_cs); m, k, n multiples of the group.
extern "C" int bfp_matmul_packed_fwd(const int8_t* am, const int8_t* ae,
                                     const int8_t* bm, const int8_t* be,
                                     float* c, int m, int k, int n,
                                     const long long* strides, int group,
                                     int mbits, void* stream) {
  if (mbits < 1 || mbits > 7 || group <= 0 || m % group || k % group ||
      n % group)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 3: return packed_g<3>(am, ae, bm, be, c, m, k, n, strides, mbits, st);
    case 8: return packed_g<8>(am, ae, bm, be, c, m, k, n, strides, mbits, st);
    case 16: return packed_g<16>(am, ae, bm, be, c, m, k, n, strides, mbits,
                                 st);
    case 32: return packed_g<32>(am, ae, bm, be, c, m, k, n, strides, mbits,
                                 st);
    default: return cudaErrorInvalidValue;
  }
}
