// Flash attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel behind repro.kernels.flash_attention.flash_attention).  Computes
// what that kernel computes, not block for block:
//   o[b,h] = softmax(mask(softcap(q[b,h] k[b,h/g]^T / sqrt(d)))) v[b,h/g]
// with GQA (kv head = h / (H/KV)), the causal mask top-left aligned
// (key position <= query position, both counted from 0, also when
// Sq != Skv), masked scores given no weight (the reference's -1e30: every
// row it stores has a live key in every tile it visits), keys past Skv
// given none, softcap cap*tanh(s/cap) applied after the 1/sqrt(d) scale,
// the online softmax state (m, l, acc) kept in f32, and the output written
// in the input's dtype (f32 or bf16) with the caller's strides.
//
// Head dims 64, 128 and 256.  Kernels behind one entry point, all walking the
// kv tiles of a query tile up to the causal diagonal, with the kv head as an
// index (no expanded copy of K/V) and the heaviest query tiles issued first
// so the causal triangle balances:
//  * bf16, d = 64 and 128 (the main path): flash_fwd_wgmma_kernel, 128 x 128
//    tiles, TMA loads by a producer warpgroup, wgmma products and the
//    softmax in two consumer warpgroups; see the section below.
//  * bf16, d = 256 (gemma2's global layers): flash_fwd_wgmma_d256_kernel,
//    128 queries x 64-key tiles, the same two consumers without a producer
//    warpgroup; see its section.  TMA needs every pointer 16-byte aligned
//    and every stride a multiple of 8 elements.
//  * f32: f32 SIMT FMAs, 64 x 64 tiles, 256 threads, K/V/scores staged in
//    shared memory as f32 -- exact enough for the 2e-5 check.
//
// Bound at the main path's shapes (B=2, H=32, KV=8, S=4096, d=128, bf16,
// causal): 4*B*H*d*S(S+1)/2 = 275 GFLOP per launch, 0.28 ms at the H100's
// 989 TFLOP/s bf16 tensor-core peak, against 168 MB of q/k/v/o (0.05 ms at
// 3.35 TB/s): compute-bound.  What the design does about it: both products
// run on wgmma, the only path to Hopper's tensor-core rate; TMA feeds them
// without spending consumer instructions on copies; scores and softmax
// state never leave the registers; each q/k/v byte is read once per CTA.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for an unsupported
// dtype or head dim, bf16 operands that are not 16-byte aligned, or a
// tensor map the driver refuses).
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qb, qh, qs;  // element strides: batch, head, sequence
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, os;
  int group;             // query heads per kv head
  int sq, skv;
  int causal;
  float scale;
  float softcap;         // <= 0: none
};

template <int D>
constexpr int smem_floats() {
  // Q and K tiles padded to D+4 per row (float4-aligned, conflict-free
  // column reads), V unpadded, scores padded to BK+4, three row stats.
  return kBQ * (D + 4) + kBK * (D + 4) + kBK * D + kBQ * (kBK + 4) + 3 * kBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int QP = D + 4;
  constexpr int SP = kBK + 4;
  constexpr int CG = D / 64;   // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QP;
  float* Vs = Ks + kBK * QP;
  float* Ss = Vs + kBK * D;
  float* m_s = Ss + kBQ * SP;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const int q0 = qt * kBQ;

  const float* qg = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kb + kvh * p.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vb + kvh * p.vh;
  float* og = static_cast<float*>(p.o) + b * p.ob + h * p.oh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, qi = q0 + r;
    Qs[r * QP + c] = qi < p.sq ? qg[qi * p.qs + c] : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  float acc[4][CG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CG * 4; ++c) acc[i][c] = 0.f;

  // keys a causal tile needs: k <= last live query of the tile
  const int kv_end = p.causal ? min(p.skv, min(p.sq, q0 + kBQ)) : p.skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // previous tile's readers are done with Ks/Vs/Ss
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, ki = k0 + r;
      const bool ok = ki < p.skv;
      Ks[r * QP + c] = ok ? kg[ki * p.ks + c] : 0.f;
      Vs[r * D + c] = ok ? vg[ki * p.vs + c] : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QP + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QP + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, ki = k0 + c;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (ki >= p.skv) x = -INFINITY;            // past the end: no weight
        else if (p.causal && ki > qi) x = kNegInf;  // the reference's mask value
        Ss[r * SP + c] = x;
      }
    }
    __syncthreads();

    // online softmax, four threads per row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = Ss + r * SP;
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float e = expf(row[c] - m_new);
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty*4+i, columns tx*4 + 64*g + e
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < CG * 4; ++c) acc[i][c] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ss[(ty * 4 + i) * SP + kk];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[kk * D + tx * 4 + 64 * g]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(pr[i], vv.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(pr[i], vv.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(pr[i], vv.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(pr[i], vv.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
    if (qi >= p.sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        og[qi * p.os + tx * 4 + 64 * g + e] = acc[i][g * 4 + e] / l;
  }
}

// ---------------------------------------------------------------------------
// bf16 path: TMA + warp-specialised wgmma.
//
// One CTA per (128-query tile, head, batch), 384 threads in three
// warpgroups.  Warpgroup 0 is the producer: one of its threads loads the
// CTA's Q tile once and then the K and V tiles of 128 keys into a ring of
// kStages stages with TMA (4-D tensor maps over (d, S, heads, batch) with
// the caller's strides, 128-byte swizzle, so a d = 128 tile is two 64-wide
// boxes), each arrival counted on the stage's "full" mbarrier (one for K,
// one for V, so S = Q K^T starts before V lands).  Warpgroups 1 and 2 are
// the consumers, 64 query rows each:
//   S = Q K^T   wgmma m64n128k16, A = Q and B = K both K-major in shared
//               memory, f32 scores in 64 registers a thread;
//   softmax     on the fragments: a row lives in the 4 threads of a quad,
//               so its max and sum are two shuffles each; the 1/sqrt(d)
//               scale and log2(e) fold into one FMA before ex2.approx; the
//               per-element mask runs only on a tile that holds the causal
//               diagonal or keys past Skv;
//   O += P V    wgmma m64n{D}k16 with A = P from registers (each k16 slice
//               of the score fragment rounded to bf16 pairs in place: the
//               accumulator's quad layout is the A fragment's) and B = V
//               MN-major (keys are the reduction, V rows are d-contiguous:
//               the transpose bit and an MN-major descriptor read the tile
//               as TMA wrote it);
// and release the stage through its "empty" mbarrier once the products
// that read it have retired.  The two consumers take turns issuing S = Q K^T
// (named barriers, see Turns), so one's softmax runs while the other's
// products hold the tensor cores.  setmaxnreg hands the producer's
// registers (it keeps 24) to the consumers (240), though ptxas compiles
// them within 168 (below).  m, l and O stay f32 in registers;
// O / l is written as bf16 pairs straight to global memory, rows >= Sq
// skipped.  Rows and keys past Sq / Skv arrive as TMA's zero fill; keys
// past Skv get no weight.
//
// Not done, and why: issuing tile t's S with tile t-1's P V, so that a
// consumer's own softmax overlaps its products, keeps S, P and O (160
// registers) live at once; ptxas compiles each branch within the 168
// registers a thread that 384 threads leave at entry, whatever setmaxnreg
// asks, so that version spills.  Without the producer warpgroup (256
// threads, 246 registers, loads issued by a consumer warp) it fits, and
// measured no faster on the H100 (PERF.md).
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int kTQ = 128;           // query rows per CTA
constexpr int kTK = 128;           // keys per kv tile
constexpr int kStages = 2;
constexpr int kTmaThreads = 384;   // producer + 2 consumer warpgroups
constexpr int kBoxBytes = 128 * 128;   // 128 rows x one 64-wide bf16 box
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: Q, then kStages x (K, V), 1024-byte aligned (the swizzle's
// period), then the mbarriers: full_q, full_k[kStages], full_v[kStages],
// empty[kStages].
template <int D>
struct TmaLayout {
  static constexpr int kTile = kTQ * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kKV = kTile;                // stage s: K, then V
  static constexpr int kBars = kTile * (1 + 2 * kStages);
  static constexpr int kBytes = 1024 + kBars + 8 * (1 + 3 * kStages);
};

struct TmaParams {
  void* o;
  long long ob, oh, os;   // element strides of o: batch, head, sequence
  int group;              // query heads per kv head
  int sq, skv;
  int causal;
  float c;                // log2(e) x (softcap, or the 1/sqrt(d) scale)
  float cap_scale;        // scale / softcap; 0: no softcap
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two consumer warpgroups take turns issuing their products (named
// barriers 1 and 2, one per warpgroup, 256 threads each: the waiting
// warpgroup's bar.sync and the other's bar.arrive), so that one
// warpgroup's softmax runs while the other's products hold the tensor
// cores.  Warpgroup 0 goes first; each turn ends by handing over, except
// warpgroup 1's last, so that every arrival meets a wait.
struct Turns {
  int mine, other;
  __device__ __forceinline__ Turns(int cw, bool any) : mine(1 + cw),
                                                       other(2 - cw) {
    if (cw == 1 && any)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(other) : "memory");
  }
  __device__ __forceinline__ void begin() const {
    asm volatile("bar.sync %0, 256;\n" ::"r"(mine) : "memory");
  }
  __device__ __forceinline__ void end(bool last) const {
    if (!(last && mine == 2))
      asm volatile("bar.arrive %0, 256;\n" ::"r"(other) : "memory");
  }
};

// The online softmax of one 64 x (2R) score tile in a consumer's R fragment
// registers (keys k0 ..; rows row0 and row0 + 8 of this thread, its columns
// 8j + 2 t4 (+1)): softcap, mask (only on a tile that needs it), row max
// over the quad, then s = 2^(s c - m c) in place, alpha = the factor that
// rescales the earlier sum and output, and l = l alpha + this thread's
// part of the row sum.  R = 64 (128-key tiles) or 32 (64-key tiles).
template <int R>
__device__ __forceinline__ void softmax_tile(float (&s)[R], float (&m_r)[2],
                                             float (&l_r)[2],
                                             float (&alpha)[2],
                                             const TmaParams& p, int k0,
                                             int q0, int row0, int t4) {
  constexpr int kKeys = 2 * R;
  if (p.cap_scale > 0.f) {
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = tanhf(s[i] * p.cap_scale);
  }
  if ((p.causal && k0 + kKeys - 1 > q0) || k0 + kKeys > p.skv) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int ki = k0 + 8 * (i / 4) + 2 * t4 + (i % 2);
      const int qi = row0 + 8 * ((i / 2) % 2);
      if (ki >= p.skv || (p.causal && ki > qi)) s[i] = -INFINITY;
    }
  }
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int i = 0; i < R; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row with no live key yet keeps 0 as its base (no inf - inf)
    mc[r] = mx[r] == -INFINITY ? 0.f : mx[r] * p.c;
    alpha[r] = ex2(fmaf(m_r[r], p.c, -mc[r]));
    m_r[r] = mx[r];
    l_r[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float e = ex2(fmaf(s[i], p.c, -mc[(i / 2) % 2]));
    s[i] = e;
    l_r[(i / 2) % 2] += e;
  }
}

// O's two rows of this thread scaled by alpha: fragment elements 4j, 4j+1
// (row0) and 4j+2, 4j+3 (row0 + 8).
template <int R>
__device__ __forceinline__ void rescale_rows(float (&o)[R],
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// P as bf16 pairs: key n-tiles 2kk, 2kk+1 make the A fragment of k16 step
// kk, in the accumulator's own quad layout.
template <int R>
__device__ __forceinline__ void pack_p(const float (&s)[R],
                                       uint32_t (&pa)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// O / l as bf16 pairs to this thread's two rows of the output (l summed over
// the quad; rows >= Sq skipped).
template <int R>
__device__ __forceinline__ void store_o(const float (&o)[R],
                                        const float (&l_r)[2],
                                        const TmaParams& p, int b, int h,
                                        int row0, int t4) {
  bf16* og = static_cast<bf16*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int qi = row0 + 8 * r;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + qi * p.os + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
  }
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const TmaParams p) {
  using L = TmaLayout<D>;
  constexpr int NB = D / 64;        // 64-wide boxes per row of a tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full_q = base + L::kBars;
  const uint32_t full_k = full_q + 8;
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTQ;
  // keys a causal tile needs: k <= last live query of the tile
  const int kv_end = p.causal ? min(p.skv, min(p.sq, q0 + kTQ)) : p.skv;
  const int n_tiles = (kv_end + kTK - 1) / kTK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);     // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform as far as the compiler can tell: else
  // ptxas sees the wgmmas in a divergent path and serializes them (C7520)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int kvh = h / p.group;
      mbar_expect_tx(full_q, L::kTile);
      for (int j = 0; j < NB; ++j)
        tma_load_4d(base + L::kQ + j * kBoxBytes, &map_q, full_q, 64 * j, q0,
                    h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t kd = base + L::kKV + s * 2 * L::kTile;
        mbar_expect_tx(full_k + 8 * s, L::kTile);
        for (int j = 0; j < NB; ++j)
          tma_load_4d(kd + j * kBoxBytes, &map_k, full_k + 8 * s, 64 * j,
                      t * kTK, kvh, b);
        mbar_expect_tx(full_v + 8 * s, L::kTile);
        for (int j = 0; j < NB; ++j)
          tma_load_4d(kd + L::kTile + j * kBoxBytes, &map_v, full_v + 8 * s,
                      64 * j, t * kTK, kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                   // consumer: rows cw*64 .. +64
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    // this thread's rows: row0 (fragment elements 4j, 4j+1) and row0 + 8
    // (4j+2, 4j+3); its columns 8j + 2 (lane % 4) (+1)
    const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;
    const uint32_t qa = base + L::kQ + cw * 64 * 128;
    float o[D / 2];
    float s[64];
    uint32_t pa[kTK / 16][4];   // P of the last tile, bf16 A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};   // row max, in raw score units
    float l_r[2] = {0.f, 0.f};               // this thread's partial sums
    float alpha[2];
    Turns turns(cw, n_tiles > 0);
    mbar_wait(full_q, 0);
    auto stage_k = [&](int t) {
      return base + L::kKV + (t % kStages) * 2 * L::kTile;
    };
    auto issue_s = [&](int t) {       // S = Q K_t^T
      const uint32_t kb = stage_k(t);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        if (kk == 0)
          wgmma_128<0>(s, smem_desc(qa + off), smem_desc(kb + off));
        else
          wgmma_128<1>(s, smem_desc(qa + off), smem_desc(kb + off));
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int t) {      // O += P_t V_t, after V_t has landed
      mbar_wait(full_v + 8 * (t % kStages), (t / kStages) & 1);
      const uint32_t vb = stage_k(t) + L::kTile;
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        const uint64_t dv = smem_desc_mn(vb + kk * 16 * 128, kBoxBytes);
        if constexpr (D == 128)
          wgmma_128_rs_mn(o, pa[kk], dv);
        else
          wgmma_64_rs_mn(o, pa[kk], dv);
      }
      wgmma_commit();
    };
    auto release = [&](int t) {
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * (t % kStages));
    };

    auto wait_k = [&](int t) {
      mbar_wait(full_k + 8 * (t % kStages), (t / kStages) & 1);
    };
    // S = Q K_t^T is issued in this warpgroup's turn, then the turn passes
    // to the other, whose S runs while this one computes its softmax; P V
    // follows at once, outside the turns.
    for (int t = 0; t < n_tiles; ++t) {
      wait_k(t);
      turns.begin();
      wgmma_fence();
      issue_s(t);
      turns.end(t == n_tiles - 1);
      wgmma_wait<0>();
      fence_acc(s);
      softmax_tile(s, m_r, l_r, alpha, p, t * kTK, q0, row0, lane % 4);
      rescale_rows(o, alpha);
      pack_p(s, pa);
      wgmma_fence();
      issue_pv(t);
      wgmma_wait<0>();
      fence_acc(o);
      release(t);
    }

    store_o(o, l_r, p, b, h, row0, lane % 4);
  }
}

// ---------------------------------------------------------------------------
// bf16 at head dim 256: flash_fwd_wgmma_d256_kernel.
//
// The layout above does not fit at d = 256.  Q (64 KB) and two stages of
// 128-key K and V tiles (64 KB each) need 321 KB of the 227 KB a block may
// have; and a consumer's 64 x 256 f32 O fragment (128 registers) beside a
// 64 x 128 score fragment (64) passes the 168 registers that 384 threads
// leave a thread.  This kernel keeps the CTA's 128 query rows, the two
// consumer warpgroups with their turns, the softmax and the epilogue, and
// changes three things:
//  * 64-key K/V tiles (32 KB each, four 64-wide boxes of 64 rows): Q plus
//    two stages of K and V take 192 KB;
//  * no producer warpgroup: 256 threads, so a thread may hold 255 registers
//    (O 128, S 32, P 16, the softmax state).  The first thread of consumer
//    1 issues the TMA loads: its warpgroup takes its turn after consumer
//    0's, so it is, as a rule, the later of the two to finish with a stage,
//    and the wait for the other's release is short;
//  * K and V have their own "empty" barriers: a K stage is released once
//    both consumers' S = Q K^T has retired, so the next K tile loads while
//    the softmax and P V of this one run.
// S = Q K^T is 16 k16 steps of wgmma m64n64k16 (A = Q, B = K, both K-major);
// O += P V is 4 k16 steps of m64n256k16 with P from registers and V
// MN-major, its four 64-wide column boxes 8 KB apart (the descriptor's
// leading byte offset).
// ---------------------------------------------------------------------------

constexpr int kWK = 64;                    // keys per kv tile at d = 256
constexpr int kWideThreads = 256;          // two consumer warpgroups
constexpr int kWideBoxBytes = kWK * 128;   // 64 rows x one 64-wide bf16 box

// Shared memory: Q (four boxes of 128 rows), then kStages x (K, V) (four
// boxes of 64 rows each), 1024-byte aligned, then the mbarriers: full_q,
// full_k[kStages], full_v[kStages], empty_k[kStages], empty_v[kStages].
struct WideLayout {
  static constexpr int kQTile = kTQ * 256 * 2;     // 64 KB
  static constexpr int kKVTile = kWK * 256 * 2;    // 32 KB
  static constexpr int kKV = kQTile;               // stage s: K, then V
  static constexpr int kBars = kQTile + 2 * kStages * kKVTile;
  static constexpr int kBytes = 1024 + kBars + 8 * (1 + 4 * kStages);
};
static_assert(WideLayout::kBytes <= 232448, "a block has at most 227 KB");

__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_wgmma_d256_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const TmaParams p) {
  using L = WideLayout;
  constexpr int D = 256;
  constexpr int NB = D / 64;        // 64-wide boxes per row of a tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full_q = base + L::kBars;
  const uint32_t full_k = full_q + 8;
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const int q0 = qt * kTQ;
  // keys a causal tile needs: k <= last live query of the tile
  const int kv_end = p.causal ? min(p.skv, min(p.sq, q0 + kTQ)) : p.skv;
  const int n_tiles = (kv_end + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2);   // one arrival per consumer warpgroup
      mbar_init(empty_v + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  auto stage = [&](int t) {
    return base + L::kKV + (t % kStages) * 2 * L::kKVTile;
  };
  auto load_k = [&](int t) {
    const uint32_t bar = full_k + 8 * (t % kStages);
    mbar_expect_tx(bar, L::kKVTile);
    for (int j = 0; j < NB; ++j)
      tma_load_4d(stage(t) + j * kWideBoxBytes, &map_k, bar, 64 * j,
                  t * kWK, kvh, b);
  };
  auto load_v = [&](int t) {
    const uint32_t bar = full_v + 8 * (t % kStages);
    mbar_expect_tx(bar, L::kKVTile);
    for (int j = 0; j < NB; ++j)
      tma_load_4d(stage(t) + L::kKVTile + j * kWideBoxBytes, &map_v, bar,
                  64 * j, t * kWK, kvh, b);
  };
  const bool loader = threadIdx.x == 128;   // consumer 1's first thread
  if (loader) {
    mbar_expect_tx(full_q, L::kQTile);
    for (int j = 0; j < NB; ++j)
      tma_load_4d(base + j * kBoxBytes, &map_q, full_q, 64 * j, q0, h, b);
    for (int t = 0; t < min(kStages, n_tiles); ++t) {
      load_k(t);
      load_v(t);
    }
  }
  __syncwarp();

  // the warpgroup, warp-uniform as far as the compiler can tell (C7520)
  const int cw = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  // this thread's rows: row0 (fragment elements 4j, 4j+1) and row0 + 8
  // (4j+2, 4j+3); its columns 8j + 2 (lane % 4) (+1)
  const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;
  const uint32_t qa = base + cw * 64 * 128;
  float o[D / 2];
  float s[kWK / 2];
  uint32_t pa[kWK / 16][4];   // P of the tile, bf16 A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};   // row max, in raw score units
  float l_r[2] = {0.f, 0.f};               // this thread's partial sums
  float alpha[2];
  Turns turns(cw, n_tiles > 0);
  mbar_wait(full_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages, ph = (t / kStages) & 1;
    const bool refill = loader && t + kStages < n_tiles;
    const uint32_t kb = stage(t);
    mbar_wait(full_k + 8 * st, ph);
    turns.begin();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {      // S = Q K_t^T
      const uint64_t dq = smem_desc(qa + (kk / 4) * kBoxBytes + (kk % 4) * 32);
      const uint64_t dk =
          smem_desc(kb + (kk / 4) * kWideBoxBytes + (kk % 4) * 32);
      if (kk == 0)
        wgmma_64<0>(s, dq, dk);
      else
        wgmma_64<1>(s, dq, dk);
    }
    wgmma_commit();
    turns.end(t == n_tiles - 1);
    wgmma_wait<0>();
    fence_acc(s);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty_k + 8 * st);
    if (refill) {          // both consumers are done with K_t
      mbar_wait(empty_k + 8 * st, ph);
      load_k(t + kStages);
    }
    __syncwarp();
    softmax_tile(s, m_r, l_r, alpha, p, t * kWK, q0, row0, lane % 4);
    rescale_rows(o, alpha);
    pack_p(s, pa);
    mbar_wait(full_v + 8 * st, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk)      // O += P_t V_t
      wgmma_256_rs_mn(o, pa[kk],
                      smem_desc_mn(kb + L::kKVTile + kk * 16 * 128,
                                   kWideBoxBytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty_v + 8 * st);
    if (refill) {          // both consumers are done with V_t
      mbar_wait(empty_v + 8 * st, ph);
      load_v(t + kStages);
    }
    __syncwarp();
  }

  store_o(o, l_r, p, b, h, row0, lane % 4);
}

// The 4-D tensor map (d, seq, heads, batch) of a bf16 operand with element
// strides (batch, head, seq); boxes of 64 x rows x 1 x 1.
bool operand_map(CUtensorMap* map, const void* ptr, int d, int seq,
                 int heads, int batch, long long sb, long long sh,
                 long long ss, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  return bf16_map(map, ptr, 4, dims, strides, box);
}

TmaParams tma_params(const Params& p) {
  const bool cap = p.softcap > 0.f;
  return TmaParams{p.o, p.ob, p.oh, p.os, p.group, p.sq, p.skv, p.causal,
                   kLog2e * (cap ? p.softcap : p.scale),
                   cap ? p.scale / p.softcap : 0.f};
}

using TmaKernel = void (*)(const CUtensorMap, const CUtensorMap,
                           const CUtensorMap, const TmaParams);

// One launch of a TMA kernel over (query tiles of kTQ, heads, batch): Q read
// in boxes of 64 x kTQ, K and V in boxes of 64 x kv_rows.
cudaError_t launch_tma(TmaKernel kernel, int threads, int smem, int kv_rows,
                       const Params& p, int d, int batch, int heads,
                       cudaStream_t stream) {
  const int kv_heads = heads / p.group;
  CUtensorMap mq, mk, mv;
  if (!operand_map(&mq, p.q, d, p.sq, heads, batch, p.qb, p.qh, p.qs, kTQ) ||
      !operand_map(&mk, p.k, d, p.skv, kv_heads, batch, p.kb, p.kh, p.ks,
                   kv_rows) ||
      !operand_map(&mv, p.v, d, p.skv, kv_heads, batch, p.vb, p.vh, p.vs,
                   kv_rows))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kTQ - 1) / kTQ, heads, batch);
  kernel<<<grid, threads, smem, stream>>>(mq, mk, mv, tma_params(p));
  return cudaGetLastError();
}

// TMA needs 16-byte aligned bases and strides: every pointer 16-byte
// aligned and every stride a multiple of 8 bf16.
bool tma_aligned(const Params& p) {
  const long long strides[] = {p.qb, p.qh, p.qs, p.kb, p.kh, p.ks,
                               p.vb, p.vh, p.vs, p.ob, p.oh, p.os};
  for (long long s : strides)
    if (s % 8) return false;
  const void* ptrs[] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return true;
}

template <int D>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Params& p, int d, int batch, int heads,
                         cudaStream_t stream) {
  switch (d) {
    case 64: return launch<64>(p, batch, heads, stream);
    case 128: return launch<128>(p, batch, heads, stream);
    case 256: return launch<256>(p, batch, heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 runs on the wgmma kernel only; the caller aligns the operands.
cudaError_t dispatch_bf16(const Params& p, int d, int batch, int heads,
                          cudaStream_t stream) {
  if (!tma_aligned(p)) return cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return launch_tma(flash_fwd_wgmma_kernel<64>, kTmaThreads,
                        TmaLayout<64>::kBytes, kTK, p, 64, batch, heads,
                        stream);
    case 128:
      return launch_tma(flash_fwd_wgmma_kernel<128>, kTmaThreads,
                        TmaLayout<128>::kBytes, kTK, p, 128, batch, heads,
                        stream);
    case 256:
      return launch_tma(flash_fwd_wgmma_d256_kernel, kWideThreads,
                        WideLayout::kBytes, kWK, p, 256, batch, heads,
                        stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head
// dimension must be contiguous.  Returns a cudaError_t value (0 = success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int kv_heads, int sq, int skv, int d,
    long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os,
    int causal, float softcap, float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads) return cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return cudaSuccess;
  Params p{q, k, v, o, qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os,
           heads / kv_heads, sq, skv, causal, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_f32(p, d, batch, heads, st);
    case 1: return dispatch_bf16(p, d, batch, heads, st);
    default: return cudaErrorInvalidValue;
  }
}
