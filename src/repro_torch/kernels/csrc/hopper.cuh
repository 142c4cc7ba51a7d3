// Hopper (sm_90a) building blocks shared by the kernels of this directory:
// shared-memory addresses, mbarriers, TMA loads, wgmma descriptors and
// products, and the host-side tensor-map encoder.
//
// Nothing here links libcuda: cuTensorMapEncodeTiled is taken from the
// driver at run time through the runtime's cudaGetDriverEntryPoint.
#pragma once

#include <cstdint>

#include <cuda.h>   // CUtensorMap and its enums; no driver call is linked
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and to the
// other threads; call once after the inits, before a block-wide barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// ---------------------------------------------------------------------------
// TMA loads: the box at the given coordinates (innermost first) of the
// tensor map into dst, its bytes counted on bar.  Coordinates past the
// tensor's extent read zeros; the full box's bytes are counted all the same.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x, int y, int z,
                                            int w) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z),
      "r"(w)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory descriptor of a K-major tile with 128-byte swizzle (each row
// one 128-byte line of 64 bf16, as TMA writes a 64-wide box): start address
// >> 4, leading byte offset 16 (unused by this layout), stride byte offset
// 1024 (8 rows of 128 bytes), layout type 1 (128B).  A k16 step is +32
// bytes of start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Shared-memory descriptor of an MN-major operand with 128-byte swizzle:
// rows along K, each row 64 bf16 of the MN dimension in one 128-byte line,
// so 8 K rows make one 1024-byte swizzle atom (the stride byte offset), and
// the next 64 MN values start `mn_atom_bytes` further on (the leading byte
// offset).  A k16 step is 16 rows, +2048 bytes of start address.
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr,
                                                 uint32_t mn_atom_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((mn_atom_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_ACC64                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_ACC32                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define HOPPER_ACC128                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),               \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),      \
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),      \
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),      \
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),      \
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),      \
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),      \
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),      \
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),      \
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
      "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
      "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
      "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define HOPPER_REGS128                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                        \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                                  \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                                \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                                \
  " %32, %33, %34, %35, %36, %37, %38, %39,"                                \
  " %40, %41, %42, %43, %44, %45, %46, %47,"                                \
  " %48, %49, %50, %51, %52, %53, %54, %55,"                                \
  " %56, %57, %58, %59, %60, %61, %62, %63,"                                \
  " %64, %65, %66, %67, %68, %69, %70, %71,"                                \
  " %72, %73, %74, %75, %76, %77, %78, %79,"                                \
  " %80, %81, %82, %83, %84, %85, %86, %87,"                                \
  " %88, %89, %90, %91, %92, %93, %94, %95,"                                \
  " %96, %97, %98, %99, %100, %101, %102, %103,"                            \
  " %104, %105, %106, %107, %108, %109, %110, %111,"                        \
  " %112, %113, %114, %115, %116, %117, %118, %119,"                        \
  " %120, %121, %122, %123, %124, %125, %126, %127}"
#define HOPPER_REGS64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                        \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                                  \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                                \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                                \
  " %32, %33, %34, %35, %36, %37, %38, %39,"                                \
  " %40, %41, %42, %43, %44, %45, %46, %47,"                                \
  " %48, %49, %50, %51, %52, %53, %54, %55,"                                \
  " %56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_REGS32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                        \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                                  \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                                \
  " %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 128 f32, wgmma fragment) (+)= A (64 x 16) * B^T (B 128 x 16), both
// K-major in shared memory.  ScaleD 0 overwrites d, 1 accumulates.
template <int ScaleD = 1>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_REGS64
      ", %64, %65, %66, 1, 1, 0, 0;\n"
      : HOPPER_ACC64
      : "l"(da), "l"(db), "n"(ScaleD));
}

// d (64 x 64 f32) (+)= A (64 x 16) * B^T (B 64 x 16), both K-major in
// shared memory, as wgmma_128.
template <int ScaleD = 1>
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", %32, %33, %34, 1, 1, 0, 0;\n"
      : HOPPER_ACC32
      : "l"(da), "l"(db), "n"(ScaleD));
}

// d (64 x N f32) += A (64 x 16, bf16 fragment in registers, the layout of
// the m64 accumulator rounded to bf16 pairs) * B (16 x N), B MN-major in
// shared memory (the transpose bit set).  N = 256, 128 or 64.
__device__ __forceinline__ void wgmma_128_rs_mn(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_REGS64
      ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : HOPPER_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_64_rs_mn(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : HOPPER_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_256_rs_mn(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOPPER_REGS128
      ", {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : HOPPER_ACC128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef HOPPER_ACC128
#undef HOPPER_ACC64
#undef HOPPER_ACC32
#undef HOPPER_REGS128
#undef HOPPER_REGS64
#undef HOPPER_REGS32

// ---------------------------------------------------------------------------
// Host side: the tensor-map encoder.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, or null if it cannot be had.
inline EncodeTiled encode_tiled() {
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

// The tensor map of a bf16 tensor of `rank` dimensions (innermost first,
// the innermost contiguous), byte strides of dimensions 1.. in `strides`,
// read in boxes of `box` elements with the 128-byte swizzle that the wgmma
// descriptors above expect (box[0] * 2 <= 128).
inline bool bf16_map(CUtensorMap* map, const void* p, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
