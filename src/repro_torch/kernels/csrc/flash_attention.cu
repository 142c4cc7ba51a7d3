// Flash attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel behind repro.kernels.flash_attention.flash_attention).  Computes
// what that kernel computes, not block for block:
//   o[b,h] = softmax(mask(softcap(q[b,h] k[b,h/g]^T / sqrt(d)))) v[b,h/g]
// with GQA (kv head = h / (H/KV)), the causal mask top-left aligned
// (key position <= query position, both counted from 0, also when
// Sq != Skv), masked scores set to -1e30, softcap cap*tanh(s/cap) applied
// after the 1/sqrt(d) scale, the online softmax state (m, l, acc) kept in
// f32, and the output written in the input's dtype (f32 or bf16).
//
// One kernel per dtype behind one entry point, both one CTA per (query tile
// of 64 rows, head, batch), walking kv tiles of 64 keys up to the causal
// diagonal, with the kv head as an index (no expanded copy of K/V) and the
// heaviest query tiles issued first so the causal triangle balances:
//  * bf16 (the main path): tensor cores through mma.sync m16n8k16 (bf16
//    operands, f32 accumulate), 4 warps of 16 query rows, scores and output
//    accumulator in mma fragments, K/V double-buffered in shared memory with
//    cp.async.  P is rounded to bf16 as the A operand of P·V; m, l and acc
//    stay f32.  It reads 16-byte chunks, so every pointer must be 16-byte
//    aligned and every stride a multiple of 8 elements.
//  * f32: f32 SIMT FMAs, 256 threads, K/V/scores staged in shared memory as
//    f32 — exact enough for the 2e-5 check.
//
// Bound at the main path's shapes (B=2, H=32, KV=8, S=4096, d=128, bf16,
// causal): 4*B*H*d*S(S+1)/2 = 275 GFLOP per launch, 0.28 ms at the H100's
// 989 TFLOP/s bf16 tensor-core peak, against 168 MB of q/k/v/o (0.05 ms at
// 3.35 TB/s): compute-bound.  What the design does about it: the products
// run on the tensor cores, scores and softmax state never leave the chip,
// and each q/k/v byte is read once per CTA, so the time is tensor-core
// arithmetic plus the softmax between the two products.  mma.sync reaches
// only part of the Hopper peak; wgmma with TMA-fed tiles and warp
// specialisation is the later step toward the bound.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for an unsupported
// dtype or head dim, or bf16 operands that are not 16-byte aligned).
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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
// bf16 tensor-core path: mma.sync m16n8k16 (bf16 in, f32 accumulate).
// 4 warps per CTA, 16 query rows each; Q fragments stay in registers, the
// score tile and the output accumulator live in mma fragments, and the
// probabilities go from the score fragments straight into the A operand of
// the P·V product (rounded to bf16 there; m, l and acc stay f32).  K and V
// tiles are double-buffered in shared memory with cp.async, so the next
// tile's loads overlap this tile's products.  Rows are padded by 8 bf16
// so that ldmatrix reads are free of bank conflicts.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr int mma_smem_bytes() {
  return (kBQ + 4 * kBK) * (D + 8) * 2;   // Q + two stages of K and V
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int PITCH = D + 8;        // bf16 elements per smem row
  constexpr int CHUNKS = D / 8;       // 16-byte chunks per row
  constexpr int NT = kBK / 8;         // key n-tiles per kv tile
  constexpr int DT = D / 8;           // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * PITCH;        // [2][kBK][PITCH]
  bf16* Vs = Ks + 2 * kBK * PITCH;    // [2][kBK][PITCH]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const int q0 = qt * kBQ;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qb + h * p.qh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.kb + kvh * p.kh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vb + kvh * p.vh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.ob + h * p.oh;

  const int kv_end = p.causal ? min(p.skv, min(p.sq, q0 + kBQ)) : p.skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  auto load_kv = [&](int tile, int stage) {
    bf16* ks = Ks + stage * kBK * PITCH;
    bf16* vs = Vs + stage * kBK * PITCH;
    for (int i = tid; i < kBK * CHUNKS; i += kMmaThreads) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8, ki = tile * kBK + r;
      const bool ok = ki < p.skv;
      const long long row = ok ? ki : 0;
      cp_async16(ks + r * PITCH + c, kg + row * p.ks + c, ok);
      cp_async16(vs + r * PITCH + c, vg + row * p.vs + c, ok);
    }
  };

  for (int i = tid; i < kBQ * CHUNKS; i += kMmaThreads) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8, qi = q0 + r;
    const bool ok = qi < p.sq;
    cp_async16(Qs + r * PITCH + c, qg + (ok ? qi : 0) * p.qs + c, ok);
  }
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};   // rows g and g+8 of this warp
  float l_r[2] = {0.f, 0.f};           // this thread's partial row sums
  const int row0 = q0 + warp * 16 + g;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane % 16)) * PITCH + kk * 16 +
                                (lane / 16) * 8);
    }
    const bf16* ks = Ks + (t & 1) * kBK * PITCH;
    const bf16* vs = Vs + (t & 1) * kBK * PITCH;
    const int k0 = t * kBK;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (j * 8 + (lane / 16) * 8 + (lane % 8)) * PITCH +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[j], qf[kk], bf[0], bf[1]);
        mma_bf16(s[j + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale, softcap, mask; online softmax on the fragments
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row0 + (e / 2) * 8;
        const int ki = k0 + j * 8 + 2 * t4 + (e % 2);
        float x = s[j][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (ki >= p.skv) x = -INFINITY;
        else if (p.causal && ki > qi) x = kNegInf;
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = __expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[j][e] - m_r[e / 2]);
        s[j][e] = pe;
        l_r[e / 2] += pe;
      }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the score fragments of key n-tiles 2kk, 2kk+1 are the A
    // operand of key step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) *
                                       PITCH + n * 8 + (lane / 16) * 8);
        mma_bf16(o[n], pa, bv[0], bv[1]);
        mma_bf16(o[n + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();   // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    l_r[r] = fmaxf(l_r[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + r * 8;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(o[n][2 * r] / l_r[r],
                                                      o[n][2 * r + 1] / l_r[r]);
      *reinterpret_cast<__nv_bfloat162*>(og + qi * p.os + n * 8 + 2 * t4) = v2;
    }
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, int batch, int heads,
                       cudaStream_t stream) {
  const int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core path reads 16-byte chunks: every pointer 16-byte aligned
// and every stride a multiple of 8 elements.
bool mma_aligned(const Params& p) {
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
    default: return cudaErrorInvalidValue;
  }
}

// bf16 runs on the tensor-core kernel only; the caller aligns the operands.
cudaError_t dispatch_bf16(const Params& p, int d, int batch, int heads,
                          cudaStream_t stream) {
  if (!mma_aligned(p)) return cudaErrorInvalidValue;
  switch (d) {
    case 64: return launch_mma<64>(p, batch, heads, stream);
    case 128: return launch_mma<128>(p, batch, heads, stream);
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
