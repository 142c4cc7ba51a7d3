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
// Each product is two stages.
//
// 1. Operand passes (SIMT, bytes bound), one launch per operand.  A pass
//    reads its operand once, through element strides, and writes a fresh
//    bf16 buffer in the GEMM's layout: A as Aq (Mp x Kp), B as Bq = Q(B)^T
//    (Np x Kp), K contiguous in both, zeros past the matrix.  A BFP value
//    is at most a 7-bit integer times a power of two inside bf16's exponent
//    range, so the bf16 buffer holds Q(x) exactly.  bfp_operand_kernel
//    quantizes (bfp_matmul); bfp_dequant_operand_kernel scales packed int8
//    mantissas by their group exponents (bfp_matmul_packed).  Since groups
//    are square and anchored at the origin, Q(B^T) = Q(B)^T, so B goes in
//    as its transposed view and the same kernel serves both operands.
//    Staging tiles are 96 x 96, anchored at multiples of 96: 96 is a
//    multiple of each supported group (3, 8, 16, 32), so a tile holds
//    whole groups of the global grid and its in-tile group max is the
//    global one.  Any other group is refused (cudaErrorInvalidValue).  With
//    the zero gate on, the pass also marks each (GEMM row tile, K tile)
//    that holds a nonzero value.
// 2. One bf16 GEMM, C (M x N, f32) = Aq Bq^T, shared by both products; it
//    knows nothing of groups, so its tiles are powers of two: TMA loads
//    into a ring of shared-memory stages, wgmma on the tensor cores, f32
//    accumulation in registers.  See bfp_gemm_kernel.  The host encodes
//    its tensor maps with cuTensorMapEncodeTiled, taken from the driver
//    through cudaGetDriverEntryPoint, so nothing links libcuda.
//
// bfp_quantize is one pass, bytes bound: bfp_quantize_rows_kernel reads a
// source with contiguous, 16-byte aligned rows in 16-byte loads, takes each
// group's exponent by warp shuffles without shared memory, and writes
// 4- or 8-byte words of mantissas; group 3, column-major and unaligned
// sources take bfp_quantize_tile_kernel (96 x 96 staging tiles, 4-byte
// mantissa words where the row allows).
//
// The tile-level gate of the reference (skip a product whose quantized A
// or B tile is all zero, the paper's section V-B gating checkpoint)
// changes no value: an all-zero tile adds exact zeros.
//
// What replaced what.  The first port of the two products (two fused
// kernels) gave each CTA one 96 x 96 output tile, re-quantized every
// operand tile it read in SIMT code (each A tile once per CTA column, each
// B tile once per CTA row), and ran stage -> barrier -> mma.sync -> barrier
// with one K step in flight.  The operand passes now quantize each operand
// once, and the TMA + wgmma GEMM replaces the loop.
//
// What bounds them on the H100, at the BFP path's full-width shape
// (M=8192, K=4096, N=12800, f32 operands):
//   operand passes: bytes.  Q(x) and Q(w)^T read 344 MB of f32 and write
//     172 MB of bf16, 0.154 ms at 3.35 TB/s (the packed passes read 86 MB
//     of int8 and write the same 172 MB, 0.077 ms);
//   GEMM: operations.  2MKN = 8.6e11 bf16 operations, 0.87 ms at 989
//     TFLOP/s, against 0.18 ms for its bytes (175 MB in, 419 MB of f32 out).
//   bfp_quantize of x (8192 x 4096 f32): bytes.  134 MB read, 34 MB of
//     mantissas and 32 KB of exponents written, 0.050 ms at 3.35 TB/s.
// The least the card could take for Q(A) Q(B) is the int8 tensor-core
// rate, 0.43 ms, since every mantissa fits int8.  The design does not take
// it: each 32-wide K group would need its own int32 -> f32 promotion,
// scaled per (row group, column group), on every accumulator element, about
// 16,384 conversions and FMAs per m64n256k32 s8 wgmma of about 128 SM
// clocks, at some 64 a clock; the promotion, not the MMA, would set the
// pace, and int8 would lose to bf16.
//
// Each C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for an unsupported
// group, dtype, bit width or shape).
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

using bf16 = __nv_bfloat16;

constexpr int kT = 96;            // staging tile side: a multiple of 3, 8,
                                  // 16, 32
constexpr int kThreads = 256;     // 8 warps
constexpr int kFP = kT + 1;       // f32 staging pitch (floats)
constexpr int kMaxGroups = 32 * 32;  // groups per tile at g = 3
constexpr int kPerThread = kT * kT / kThreads;   // tile elements a thread moves
constexpr int kMaxFlagTiles = 4;  // GEMM tiles (>= 32 wide) a 96-span meets
static_assert(kT * kT % kThreads == 0, "whole tile per pass");

// Shared memory layout (bytes).
constexpr int kOffF = 0;                                // float [kT][kFP]
constexpr int kOffScale = kOffF + kT * kFP * 4;         // float [kMaxGroups]
constexpr int kOffInv = kOffScale + kMaxGroups * 4;     // float [kMaxGroups]
constexpr int kOffSeg = kOffInv + kMaxGroups * 4;       // u8 [kT][32]
constexpr int kOffExp = kOffSeg + kT * 32;              // i8 [kMaxGroups]
constexpr int kSmemQuant = kOffExp + kMaxGroups;
constexpr int kOffFlag = kSmemQuant;                    // int [4][4]
constexpr int kSmemOperand = kOffFlag + kMaxFlagTiles * kMaxFlagTiles * 4;
static_assert(kOffFlag % 4 == 0, "int alignment");

struct Tiles {
  float* F;
  float* scale;
  float* inv;
  unsigned char* seg;
  int8_t* exp;
  int* flag;
};

__device__ __forceinline__ Tiles carve(unsigned char* s) {
  return {reinterpret_cast<float*>(s + kOffF),
          reinterpret_cast<float*>(s + kOffScale),
          reinterpret_cast<float*>(s + kOffInv), s + kOffSeg,
          reinterpret_cast<int8_t*>(s + kOffExp),
          reinterpret_cast<int*>(s + kOffFlag)};
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

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

// Write the staged tile's values, value(r, c) for an even c giving two
// neighbours at once, to out (rp x kp bf16, row-major) as bf16 pairs, the
// part of the tile inside [0, rp) x [0, kp) (kp is even).  With flags, also
// mark each (tr x tk) GEMM tile that receives a nonzero value:
// flags[(r / tr) * (kp / tk) + c / tk] = 1 (flags were zeroed before).
template <typename Value>
__device__ void write_operand(const Tiles& t, Value value, bf16* out, int rp,
                              int kp, int r0, int c0, unsigned char* flags,
                              int tr, int tk) {
  if (flags && threadIdx.x < kMaxFlagTiles * kMaxFlagTiles)
    t.flag[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < kT * kT / 2; i += kThreads) {
    const int r = i / (kT / 2), c = (i % (kT / 2)) * 2;
    if (r0 + r >= rp || c0 + c >= kp) continue;
    float v0, v1;
    value(r, c, v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(
        out + static_cast<long long>(r0 + r) * kp + c0 + c) =
        __floats2bfloat162_rn(v0, v1);
    if (flags && (v0 != 0.f || v1 != 0.f))
      t.flag[((r0 + r) / tr - r0 / tr) * kMaxFlagTiles +
             (c0 + c) / tk - c0 / tk] = 1;
  }
  if (!flags) return;
  __syncthreads();
  if (threadIdx.x < kMaxFlagTiles * kMaxFlagTiles && t.flag[threadIdx.x]) {
    const int fr = r0 / tr + threadIdx.x / kMaxFlagTiles;
    const int fc = c0 / tk + threadIdx.x % kMaxFlagTiles;
    flags[static_cast<long long>(fr) * (kp / tk) + fc] = 1;
  }
}

// Operand pass of bfp_matmul: x (rows x cols, element strides) -> out = the
// zero-padded Q(x) as bf16 (rp x kp); one CTA per 96 x 96 staging tile of
// the padded output, so the padding is written too.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
bfp_operand_kernel(const T* x, int rows, int cols, long long rs,
                   long long cs, bf16* out, int rp, int kp, int mbits,
                   int ebits, unsigned char* flags, int tr, int tk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles t = carve(smem);
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  const float lim = static_cast<float>((1 << mbits) - 1);
  stage_tile(t.F, x, rows, cols, rs, cs, r0, c0);
  __syncthreads();
  group_scales<G>(t, mbits, ebits);
  write_operand(
      t,
      [&](int r, int c, float& v0, float& v1) {
        int q0, q1;
        const float m0 = mantissa<G>(t, r, c, lim, q0);
        const float m1 = mantissa<G>(t, r, c + 1, lim, q1);
        v0 = m0 * t.scale[q0];
        v1 = m1 * t.scale[q1];
      },
      out, rp, kp, r0, c0, flags, tr, tk);
}

// Operand pass of bfp_matmul_packed: int8 mantissas (rows x cols) and
// exponents (rows/G x cols/G), both with element strides -> out =
// mant * 2^(exp - mbits + 1) as bf16 (rp x kp), zeros past the matrix
// (bfp_common.dequant_block).
template <int G>
__global__ void __launch_bounds__(kThreads)
bfp_dequant_operand_kernel(const int8_t* mant, const int8_t* exps, int rows,
                           int cols, long long rs, long long cs,
                           long long ers, long long ecs, bf16* out, int rp,
                           int kp, int mbits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles t = carve(smem);
  constexpr int NG = kT / G;
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  for (int q = threadIdx.x; q < NG * NG; q += kThreads) {
    const int gr = r0 / G + q / NG, gc = c0 / G + q % NG;
    const bool ok = gr * G < rows && gc * G < cols;
    const int e = ok ? exps[gr * ers + gc * ecs] : 0;
    t.scale[q] = ldexpf(1.f, e - (mbits - 1));
  }
  stage_tile(t.F, mant, rows, cols, rs, cs, r0, c0);
  __syncthreads();
  write_operand(
      t,
      [&](int r, int c, float& v0, float& v1) {
        const float* f = t.F + r * kFP + c;
        v0 = f[0] * t.scale[(r / G) * NG + c / G];
        v1 = f[1] * t.scale[(r / G) * NG + (c + 1) / G];
      },
      out, rp, kp, r0, c0, nullptr, 1, 1);
}

// x (m x n, any strides) -> mant (mp x np, contiguous) and exp (mp/G x
// np/G, contiguous); one CTA per 96 x 96 tile of the padded output, staged
// through shared memory.  The padded region is quantized from zeros, as the
// reference pads before quantizing.  Serves what bfp_quantize_rows_kernel
// does not take: group 3, column-major or unaligned sources.  Mantissas go
// out four to a store where the row allows it.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
bfp_quantize_tile_kernel(const T* x, int m, int n, long long rs,
                         long long cs, int8_t* mant, int8_t* exps, int mp,
                         int np, int mbits, int ebits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles t = carve(smem);
  constexpr int NG = kT / G;
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  const float lim = static_cast<float>((1 << mbits) - 1);
  stage_tile(t.F, x, m, n, rs, cs, r0, c0);
  __syncthreads();
  group_scales<G>(t, mbits, ebits);
  const bool words = np % 4 == 0;   // c0 is a multiple of 4 too
  for (int i = threadIdx.x; i < kT * kT / 4; i += kThreads) {
    const int r = i / (kT / 4), c = (i % (kT / 4)) * 4;
    if (r0 + r >= mp || c0 + c >= np) continue;
    int8_t* dst = mant + static_cast<long long>(r0 + r) * np + c0 + c;
    int8_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gq;
      q[j] = static_cast<int8_t>(mantissa<G>(t, r, c + j, lim, gq));
    }
    if (words && c0 + c + 4 <= np) {
      *reinterpret_cast<char4*>(dst) = make_char4(q[0], q[1], q[2], q[3]);
    } else {
      for (int j = 0; j < 4 && c0 + c + j < np; ++j) dst[j] = q[j];
    }
  }
  const int egr = mp / G, egc = np / G;
  for (int q = threadIdx.x; q < NG * NG; q += kThreads) {
    const int gr = r0 / G + q / NG, gc = c0 / G + q % NG;
    if (gr < egr && gc < egc)
      exps[static_cast<long long>(gr) * egc + gc] = t.exp[q];
  }
}

// Value j of 16 bytes of T held as four words: an f32 word, or one bf16 of
// a pair (the first in the low half).
template <typename T>
__device__ __forceinline__ float word_value(const uint32_t (&w)[4], int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[j]);
  } else {
    return __uint_as_float(j % 2 ? w[j / 2] & 0xFFFF0000u : w[j / 2] << 16);
  }
}

// The same quantization for a source whose rows are contiguous, 16-byte
// aligned (pointer and row stride), and a group of 8, 16 or 32, with no
// shared memory and no barrier.  A warp owns G rows x 16 VEC columns (VEC
// values in 16 bytes: 4 f32 or 8 bf16): lane l reads columns
// (l % 16) VEC .. + VEC of rows l / 16, l / 16 + 2, ..., G / 2 loads of 16
// bytes all in flight before the first use.  A group's max exponent is a
// max over the thread's values, then over the G / VEC lanes of its columns
// and the lane 16 apart (shuffles).  Each thread writes its VEC mantissas of
// a row in one 4- or 8-byte store; one lane per group writes the exponent.
// A CTA is 8 warps side by side along the row; the grid covers the padded
// output, whose padding is quantized from zeros.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
bfp_quantize_rows_kernel(const T* __restrict__ x, int m, int n, long long rs,
                         int8_t* __restrict__ mant, int8_t* __restrict__ exps,
                         int mp, int np, int mbits, int ebits) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LG = G / VEC;       // lanes across one group's columns
  constexpr int RPT = G / 2;        // rows a thread holds
  static_assert(G % VEC == 0 && (16 * VEC) % G == 0, "whole groups a warp");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rl = lane / 16;
  const int c = ((blockIdx.x * (kThreads / 32) + warp) * 16 + lane % 16) * VEC;
  const int r0 = blockIdx.y * G;
  uint32_t v[RPT][4];   // the raw 16 bytes of each row: 64 registers
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + rl + 2 * i;
    const T* src = x + static_cast<long long>(r) * rs + c;
    if (r < m && c + VEC <= n) {
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      v[i][0] = u.x; v[i][1] = u.y; v[i][2] = u.z; v[i][3] = u.w;
    } else {
      float f[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        f[j] = r < m && c + j < n ? to_f32(src[j]) : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (sizeof(T) == 4)
          v[i][k] = __float_as_uint(f[k]);
        else   // bf16 values are f32 with 16 zero low bits: repack exactly
          v[i][k] = (__float_as_uint(f[2 * k]) >> 16) |
                    (__float_as_uint(f[2 * k + 1]) & 0xFFFF0000u);
      }
    }
  }
  unsigned int e = 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      e = max(e, (__float_as_uint(word_value<T>(v[i], j)) >> 23) & 0xFFu);
#pragma unroll
  for (int off = 1; off < LG; off *= 2)
    e = max(e, __shfl_xor_sync(0xffffffffu, e, off));
  e = max(e, __shfl_xor_sync(0xffffffffu, e, 16));
  const int lo = -(1 << (ebits - 1)), hi = (1 << (ebits - 1)) - 1;
  const int ex = min(max(static_cast<int>(e) - 127, lo), hi);
  const float inv = ldexpf(1.f, (mbits - 1) - ex);
  const float lim = static_cast<float>((1 << mbits) - 1);
  if (c >= np) return;              // whole groups leave together
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + rl + 2 * i;
    uint32_t w[VEC / 4];
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float q = fminf(
            fmaxf(rintf(word_value<T>(v[i], 4 * k + j) * inv), -lim), lim);
        word |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu)
                << (8 * j);
      }
      w[k] = word;
    }
    int8_t* dst = mant + static_cast<long long>(r) * np + c;
    if constexpr (VEC == 4) {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    } else {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    }
  }
  if (rl == 0 && (lane % 16) % LG == 0)
    exps[static_cast<long long>(r0 / G) * (np / G) + c / G] =
        static_cast<int8_t>(ex);
}

// ---------------------------------------------------------------------------
// The bf16 GEMM shared by both products: C (m x n, f32) = Aq Bq^T.
//
// One CTA per 128 x 256 output tile, in groups of kGroupM row tiles so
// that the CTAs in flight share their A and B tiles in L2.  Warp
// specialised: warpgroup 0 is the producer, of which one thread issues TMA
// loads (cp.async.bulk.tensor, 128-byte swizzle: a 64-wide bf16 K tile is
// one 128-byte row) of the A and B tiles into a ring of kStages 48 KB
// stages, each completion counted on the stage's "full" mbarrier;
// warpgroups 1 and 2 are the consumers, each owning 64 rows of the tile,
// which run wgmma.mma_async m64n128k16 (bf16 in, f32 accumulate in 128
// registers a thread) on each stage as it arrives, keep one K step's
// products in flight, and release a stage through its "empty" mbarrier
// once its products are done.  setmaxnreg moves registers from the
// producer (40) to the consumers (232).  With the zero gate, a consumer
// skips the products of a K step whose A or B tile flag is 0; the stage
// still arrives and is still released.  The output tiles divide the
// full-width shapes exactly (3,200 tiles for 8192 x 12800), so a plain
// grid of one CTA per tile keeps the card busy.
// ---------------------------------------------------------------------------

constexpr int kGemmBM = 128, kGemmBN = 256, kGemmBK = 64;
constexpr int kStages = 4;
constexpr int kGroupM = 16;                   // row tiles per raster group
constexpr int kGemmThreads = 384;             // 3 warpgroups
constexpr int kNSub = kGemmBN / 128;          // n128 products per k16 step
constexpr int kTileABytes = kGemmBM * kGemmBK * 2;
constexpr int kTileBBytes = kGemmBN * kGemmBK * 2;
constexpr int kStageBytes = kTileABytes + kTileBBytes;
// the stages, 1024-byte aligned (the 128-byte swizzle's period), then the
// 2 x kStages mbarriers
constexpr int kSmemGemm = 1024 + kStages * kStageBytes + 2 * kStages * 8;
static_assert(kGemmBK * 2 == 128, "a K tile row is one 128-byte swizzle row");
static_assert(kGemmBN % 128 == 0 && kGemmBN <= 256, "TMA box <= 256 rows");

// Output tile of CTA id: kGroupM row tiles at a time, down the rows first.
__device__ __forceinline__ void tile_of(int id, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int first = (id / per_group) * kGroupM;
  const int rows = min(kGroupM, tiles_m - first);
  const int r = id % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

__global__ void __launch_bounds__(kGemmThreads, 1)
bfp_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, float* c, int m,
                int n, int nkt, int tiles_m, int tiles_n,
                const unsigned char* fa, const unsigned char* fb) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + kStages * kStageBytes;   // kStages barriers
  const uint32_t empty = full + kStages * 8;             // kStages barriers
  int tm, tn;
  tile_of(blockIdx.x, tiles_m, tiles_n, tm, tn);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);     // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    // producer warpgroup: thread 0 issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kStageBytes);
        const uint32_t dst = base + s * kStageBytes;
        tma_load(dst, &map_a, full + 8 * s, kt * kGemmBK, tm * kGemmBM);
        tma_load(dst + kTileABytes, &map_b, full + 8 * s, kt * kGemmBK,
                 tn * kGemmBN);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1;     // consumer: rows cw*64 ..+64
    float acc[kNSub][64];
#pragma unroll
    for (int j = 0; j < kNSub; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
    // one K step's products stay in flight: the group committed at step kt
    // (empty when the gate skips it) is waited for at step kt + 1, which
    // then releases stage kt
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full + 8 * s, (kt / kStages) & 1);
      if (!fa || (fa[tm * nkt + kt] && fb[tn * nkt + kt])) {
        const uint32_t sa = base + s * kStageBytes + cw * 64 * 128;
        const uint32_t sb = base + s * kStageBytes + kTileABytes;
#pragma unroll
        for (int j = 0; j < kNSub; ++j) fence_acc(acc[j]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kGemmBK / 16; ++k)
#pragma unroll
          for (int j = 0; j < kNSub; ++j)
            wgmma_128(acc[j], smem_desc(sa + 32 * k),
                      smem_desc(sb + j * 128 * 128 + 32 * k));
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int j = 0; j < kNSub; ++j) fence_acc(acc[j]);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty + 8 * ((kt - 1) % kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kNSub; ++j) fence_acc(acc[j]);
    // epilogue: fragment element (row lane/4 [+8], column 8 c8 + 2 (lane%4)
    // [+1]) of each warp's 16 rows, straight to C, masked at the edge
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = tm * kGemmBM + cw * 64 + warp * 16 + lane / 4;
    const int col0 = tn * kGemmBN + 2 * (lane % 4);
    const bool pairs = n % 2 == 0;
#pragma unroll
    for (int j = 0; j < kNSub; ++j)
#pragma unroll
      for (int c8 = 0; c8 < 16; ++c8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h, col = col0 + j * 128 + 8 * c8;
          if (r >= m) continue;
          const float v0 = acc[j][4 * c8 + 2 * h];
          const float v1 = acc[j][4 * c8 + 2 * h + 1];
          float* dst = c + static_cast<long long>(r) * n + col;
          if (pairs && col < n) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (col < n) dst[0] = v0;
            if (col + 1 < n) dst[1] = v1;
          }
        }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

bool bits_ok(int mbits, int ebits) {
  return mbits >= 1 && mbits <= 7 && ebits >= 1 && ebits <= 7;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The tensor map of a contiguous (rows, kp) bf16 buffer, read in boxes of
// box_rows x kGemmBK with the 128-byte swizzle the wgmma descriptors expect.
bool operand_map(CUtensorMap* map, const void* p, int rows, int kp,
                 int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp) * 2};
  const cuuint32_t box[2] = {kGemmBK, static_cast<cuuint32_t>(box_rows)};
  return bf16_map(map, p, 2, dims, strides, box);
}

dim3 tiles(int rows, int cols) {
  return dim3((cols + kT - 1) / kT, (rows + kT - 1) / kT);
}

// f(std::integral_constant<int, G>{}) for the supported group sizes.
template <typename F>
cudaError_t by_group(int group, F f) {
  switch (group) {
    case 3: return f(std::integral_constant<int, 3>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t operand_t(int group, const void* x, int rows, int cols,
                      long long rs, long long cs, bf16* out, int rp, int kp,
                      int mbits, int ebits, unsigned char* flags, int tr,
                      int tk, cudaStream_t st) {
  return by_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    return launch(bfp_operand_kernel<T, G>, tiles(rp, kp), kThreads,
                  kSmemOperand, st, static_cast<const T*>(x), rows, cols, rs,
                  cs, out, rp, kp, mbits, ebits, flags, tr, tk);
  });
}

template <typename T>
cudaError_t quantize_t(int group, const void* x, int m, int n, long long rs,
                       long long cs, int8_t* mant, int8_t* exps, int mp,
                       int np, int mbits, int ebits, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool rows = (cs == 1 || n <= 1) && (rs % VEC == 0 || m <= 1) &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return by_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    if constexpr (G % VEC == 0) {
      if (rows) {
        constexpr int cols = kThreads / 32 * 16 * VEC;   // per CTA
        return launch(bfp_quantize_rows_kernel<T, G>,
                      dim3((np + cols - 1) / cols, mp / G), kThreads, 0, st,
                      static_cast<const T*>(x), m, n, rs, mant, exps, mp, np,
                      mbits, ebits);
      }
    }
    return launch(bfp_quantize_tile_kernel<T, G>, tiles(mp, np), kThreads,
                  kSmemQuant, st, static_cast<const T*>(x), m, n, rs, cs,
                  mant, exps, mp, np, mbits, ebits);
  });
}

bool padded_ok(int rows, int cols, int rp, int kp, int tr, int tk) {
  return rows >= 0 && cols >= 0 && rp >= rows && kp >= cols && tr >= 32 &&
         tk >= 32 && tk % 2 == 0 && rp % tr == 0 && kp % tk == 0;
}

}  // namespace

// Operand pass of bfp_matmul.  x: (rows, cols) with element strides, dtype
// 0 = float32, 1 = bfloat16; out: contiguous (rp, kp) bf16, rp and kp
// multiples of the GEMM tile (tr, tk); flags: contiguous (rp/tr, kp/tk)
// uint8, or null for no zero gate.
extern "C" int bfp_operand_fwd(const void* x, int dtype, int rows, int cols,
                               long long rs, long long cs, void* out, int rp,
                               int kp, int group, int mbits, int ebits,
                               unsigned char* flags, int tr, int tk,
                               void* stream) {
  if (!bits_ok(mbits, ebits) || !padded_ok(rows, cols, rp, kp, tr, tk))
    return cudaErrorInvalidValue;
  if (rp == 0 || kp == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags) {
    cudaError_t err = cudaMemsetAsync(
        flags, 0, static_cast<size_t>(rp / tr) * (kp / tk), st);
    if (err != cudaSuccess) return err;
  }
  bf16* o = static_cast<bf16*>(out);
  switch (dtype) {
    case 0: return operand_t<float>(group, x, rows, cols, rs, cs, o, rp, kp,
                                    mbits, ebits, flags, tr, tk, st);
    case 1: return operand_t<bf16>(group, x, rows, cols, rs, cs, o, rp, kp,
                                   mbits, ebits, flags, tr, tk, st);
    default: return cudaErrorInvalidValue;
  }
}

// Operand pass of bfp_matmul_packed.  mant: (rows, cols) int8, exps:
// (rows/group, cols/group) int8, both with element strides; rows and cols
// multiples of the group; out: contiguous (rp, kp) bf16 as above.
extern "C" int bfp_dequant_operand_fwd(const int8_t* mant,
                                       const int8_t* exps, int rows, int cols,
                                       long long rs, long long cs,
                                       long long ers, long long ecs,
                                       void* out, int rp, int kp, int group,
                                       int mbits, int tr, int tk,
                                       void* stream) {
  if (mbits < 1 || mbits > 7 || group <= 0 || rows % group ||
      cols % group || !padded_ok(rows, cols, rp, kp, tr, tk))
    return cudaErrorInvalidValue;
  if (rp == 0 || kp == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* o = static_cast<bf16*>(out);
  return by_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    return launch(bfp_dequant_operand_kernel<G>, tiles(rp, kp), kThreads,
                  kSmemQuant, st, mant, exps, rows, cols, rs, cs, ers, ecs, o,
                  rp, kp, mbits);
  });
}

// C = Aq Bq^T: aq contiguous (mp, kp) bf16, bq contiguous (np, kp) bf16,
// c contiguous (m, n) float32; mp, np, kp multiples of the GEMM tile
// (bfp_gemm_tiles), m <= mp, n <= np.  fa (mp/BM, kp/BK) and fb (np/BN,
// kp/BK) uint8 zero-gate flags, both null for no gate.
extern "C" int bfp_gemm_fwd(const void* aq, const void* bq, float* c, int m,
                            int n, int mp, int np, int kp,
                            const unsigned char* fa, const unsigned char* fb,
                            void* stream) {
  if (m < 0 || n < 0 || m > mp || n > np || mp % kGemmBM || np % kGemmBN ||
      kp % kGemmBK || (fa == nullptr) != (fb == nullptr))
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kp == 0)
    return cudaMemsetAsync(c, 0, static_cast<size_t>(m) * n * sizeof(float),
                           st);
  CUtensorMap map_a, map_b;
  if (!operand_map(&map_a, aq, mp, kp, kGemmBM) ||
      !operand_map(&map_b, bq, np, kp, kGemmBN))
    return cudaErrorInvalidValue;
  const int tiles_m = mp / kGemmBM, tiles_n = np / kGemmBN;
  return launch(bfp_gemm_kernel, dim3(tiles_m * tiles_n), kGemmThreads,
                kSmemGemm, st, map_a, map_b, c, m, n, kp / kGemmBK, tiles_m,
                tiles_n, fa, fb);
}

// The GEMM's tile (BM, BN, BK): the operand passes pad to its multiples.
extern "C" void bfp_gemm_tiles(int* t) {
  t[0] = kGemmBM;
  t[1] = kGemmBN;
  t[2] = kGemmBK;
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
