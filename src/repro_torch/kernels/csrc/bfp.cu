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

#include <cuda.h>   // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// that has not completed after 4 s traps (a launch error on the host) rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t t = global_ns();
    if (t0 == 0) t0 = t;
    else if (t - t0 > 4000000000ull) __trap();
  }
}

// TMA: the box at (inner coordinate x, row y) of the tensor map into dst,
// its bytes counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// start address >> 4, leading byte offset 16 (unused by this layout),
// stride byte offset 1024 (8 rows of 128 bytes), layout type 1 (128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keep the compiler from moving accumulator accesses across wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, wgmma fragment) += A (64 x 16) * B^T (B 128 x 16), both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < kGemmBK / 16; ++k)
#pragma unroll
          for (int j = 0; j < kNSub; ++j)
            wgmma_128(acc[j], smem_desc(sa + 32 * k),
                      smem_desc(sb + j * 128 * 128 + 32 * k));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < kNSub; ++j) fence_acc(acc[j]);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty + 8 * ((kt - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// cuTensorMapEncodeTiled, taken from the driver at run time through the
// runtime's cudaGetDriverEntryPoint, so the library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous (rows, kp) bf16 buffer, read in boxes of
// box_rows x kGemmBK with the 128-byte swizzle the wgmma descriptors expect.
bool operand_map(CUtensorMap* map, const void* p, int rows, int kp,
                 int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp) * 2};
  const cuuint32_t box[2] = {kGemmBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  return by_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    return launch(bfp_quantize_kernel<T, G>, tiles(mp, np), kThreads,
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
