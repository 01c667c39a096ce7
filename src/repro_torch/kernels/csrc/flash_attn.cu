// Prefill (flash) attention for Hopper (sm_90a): blockwise online softmax
// with causal and sliding-window masks, gemma2's score softcap and GQA.
//
// Replaces the TPU kernel repro/kernels/flash_attn/flash_attn.py:78
// (flash_attention_pallas, body _kernel at :29). For each query row q of
// head h (KV head h / group, as jnp.repeat(k, group, axis=2) lays them out)
// over keys kp < skv:
//   s  = (q . k) * scale,  scale = 1/sqrt(dh)
//   s  = c * tanh(s / c)                     (softcap c, if given)
//   s  = -1e30 where masked (kp > q if causal, kp <= q - window if windowed)
//   out = softmax(s) v
// computed tile by tile with a running max m, sum l and accumulator acc in
// f32, exactly as the Pallas kernel: m_new = max(m, max_j s), p = exp(s -
// m_new), alpha = exp(m - m_new), l = alpha l + sum p, acc = alpha acc + p v,
// and out = acc / max(l, 1e-30). Masked scores are -1e30, not -inf: a row
// whose first visited tile is wholly masked accumulates exp(0) = 1 there,
// and alpha = exp(-1e30 - m) underflows to exactly 0 at its first real
// score, wiping it, as in the Pallas kernel. The wrapper refuses inputs in
// which a row sees no key at all.
//
// What bounds it: operations. 4 dh flops per visible (query, key) pair
// (q.k and p.v) against 2 (sq + skv) h dh elements moved: in bf16 the
// tensor cores' 989 TFLOP/s, in f32 the FP32 pipes' 67 TFLOP/s.
//
// bf16 (flash_bf16_kernel): on the tensor cores.
//  * one block of 4 warps per (64 query rows, batch x head), each warp
//    owning 16 rows; grid (b h, query tiles), the query tiles launched in
//    reverse so the longest causal rows start first;
//  * S = Q K^T and O += P V with mma.sync m16n8k16 (bf16 in, f32
//    accumulators), operands loaded from shared memory with ldmatrix; V
//    with ldmatrix.trans, so it needs no transposed copy. Shared memory
//    holds bf16, never widened. Q's fragments are reloaded per 16-column
//    step: held across the key loop they would cost 64 registers a thread
//    at dh 256 on top of the O accumulator's 128;
//  * P stays in registers: the S accumulators of two adjacent n8 key tiles
//    are the A fragment of the next m16n8k16, so p is rounded to bf16 there
//    (the Pallas kernel's p.astype(v.dtype)) and fed to P V; l sums the
//    unrounded f32 p. Row max and sum reduce over the 4 lanes of a quad;
//  * K and V tiles come by cp.async.cg 16-byte copies into a ring of two
//    stages, K and V in separate groups: tile t's K is in use while its V
//    lands, and tile t+1 loads behind both. Rows past skv (and query rows
//    past sq) are zero-filled by cp.async's src-size operand, never read.
//    Rows are padded by 16 bytes, so the 8 rows an ldmatrix phase reads
//    at one column fall in 8 distinct bank groups: no bank conflicts;
//  * tiles: BQ 64 and BK 64, or BK 32 at dh 256. Shared memory is the Q
//    tile and two stages of K and V, (64 + 4 BK)(dh + 8) x 2 bytes: 101,376
//    B at dh 256 and 87,040 B at dh 128, so 2 blocks (8 warps) fit an SM's
//    227 KB; __launch_bounds__(128, 2) leaves 255 registers a thread for
//    the 128-float O accumulator (dh 256) and 16-float S tile, unspilled
//    (the build's -Xptxas -v log shows registers and spills);
//  * exp2 with log2(e) folded into the scale (or into the softcap's c);
//    the softcap keeps the accurate tanhf. Masks are applied only on tiles
//    that cut the diagonal, the window's edge or skv; tiles wholly above
//    the diagonal or before the window are skipped (they change nothing);
//  * GQA reads KV head h / group in place; dh 32, 64, 128, 256 compiled.
//
// f32 (flash_fwd_kernel): the FP32 pipes, 64 x 64 tiles staged in shared
// memory as f32 (215 KB at dh 256), one 16 x 16 thread grid of fmaf. The
// JAX package's f32 tolerance (2e-5) rules out TF32's 10-bit mantissa, and
// this kernel is already 1.9x faster than SDPA in f32 on the H100.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile (f32)
constexpr int THREADS = 256;  // 16 x 16 (f32)
constexpr int LDP = BK + 16;  // p row stride: the two half-warps hit
                              // disjoint banks on write and read
constexpr float NEG_INF = -1e30f;

// ---- f32: the FP32 pipes ---------------------------------------------------

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int PER16 = 4;  // elements per 16-byte load
  __device__ static void load16(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float round_p(float p) { return p; }
  __device__ static float store(float v) { return v; }
};

// Rows [row0, row0 + R) of one head (row stride `stride` elements, dh
// contiguous) into sm[R][DH + 4] as f32; rows >= nrows are zeros.
template <typename T, int DH, int R>
__device__ __forceinline__ void stage(float* sm, const T* base,
                                      long long stride, int row0, int nrows) {
  constexpr int P = Elem<T>::PER16;
  constexpr int CH = DH / P;
  constexpr int LD = DH + 4;
  for (int idx = threadIdx.x; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, c = idx - r * CH;
    float vals[P];
    if (row0 + r < nrows) {
      Elem<T>::load16(base + (long long)(row0 + r) * stride + c * P, vals);
    } else {
#pragma unroll
      for (int e = 0; e < P; ++e) vals[e] = 0.0f;
    }
    float* dst = sm + r * LD + c * P;
#pragma unroll
    for (int e = 0; e < P; e += 4)
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 4) + 2 * BK * (DH + 4) + BQ * LDP;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
                 int h, int kvh, float scale, float softcap, int causal,
                 int window) {
  constexpr int LD = DH + 4;
  constexpr int VW = DH >= 64 ? 4 : 2;      // output columns per vector
  constexpr int NV = DH / (16 * VW);        // vectors per thread per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / h, hh = blockIdx.y - b * h;
  const int kh = hh / (h / kvh);
  const long long q_stride = (long long)h * DH, k_stride = (long long)kvh * DH;
  const T* qb = q + (long long)b * sq * q_stride + (long long)hh * DH;
  const T* kb = k + (long long)b * skv * k_stride + (long long)kh * DH;
  const T* vb = v + (long long)b * skv * k_stride + (long long)kh * DH;
  T* ob = o + (long long)b * sq * q_stride + (long long)hh * DH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage<T, DH, BQ>(Qs, qb, q_stride, q0, sq);

  // the key tiles any row of this block can see
  int kend = skv;
  if (causal) kend = min(kend, q0 + BQ);
  const int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = kbeg / BK, t_last = (kend + BK - 1) / BK;

  float m[4], l[4], acc[4][NV * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_first; t < t_last; ++t) {
    __syncthreads();  // the previous tile's K, V and p are used up
    stage<T, DH, BK>(Ks, kb, k_stride, t * BK, skv);
    stage<T, DH, BK>(Vs, vb, k_stride, t * BK, skv);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t * BK + tx + 16 * j;
        float s = __fmul_rn(sc[i][j], scale);
        if (softcap > 0.0f)
          s = __fmul_rn(softcap, tanhf(__fdiv_rn(s, softcap)));
        bool ok = kp < skv;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        sc[i][j] = ok ? s : NEG_INF;
        mc = fmaxf(mc, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(__fsub_rn(m[i], mn));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(__fsub_rn(sc[i][j], mn));
        rs = __fadd_rn(rs, p);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = Elem<T>::round_p(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NV * VW; ++c) acc[i][c] = __fmul_rn(alpha, acc[i][c]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int kk = 0; kk < NV; ++kk) {
        const float* vp = Vs + c * LD + VW * (tx + 16 * kk);
        float vv[VW];
        if constexpr (VW == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vp);
          vv[0] = t4.x; vv[1] = t4.y; vv[2] = t4.z; vv[3] = t4.w;
        } else {
          const float2 t2 = *reinterpret_cast<const float2*>(vp);
          vv[0] = t2.x; vv[1] = t2.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][kk * VW + e] = fmaf(pv[i], vv[e], acc[i][kk * VW + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + (long long)qp * q_stride;
#pragma unroll
    for (int kk = 0; kk < NV; ++kk)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        orow[VW * (tx + 16 * kk) + e] =
            Elem<T>::store(__fdiv_rn(acc[i][kk * VW + e], denom));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int h, int kvh, float scale, float softcap,
           int causal, int window, cudaStream_t stream) {
  const int bytes = smem_floats<DH>() * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, DH>;
  // the limit is per device: set it on every launch (it is cheap), so a
  // launch on another card than the first one gets it too
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, h, kvh, scale,
      softcap, causal, window);
  return (int)cudaGetLastError();
}


// ---- bf16: the tensor cores ------------------------------------------------

constexpr int NW = 4;                  // warps per block, 16 query rows each
constexpr int BQ_TC = 16 * NW;         // query rows per block
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct TcTile {
  static constexpr int BK = DH >= 256 ? 32 : 64;        // keys per tile
  static constexpr int LDS = DH + 8;                    // row stride, elts
  static constexpr int ROW_BYTES = LDS * 2;
  static constexpr int SMEM = (BQ_TC + 4 * BK) * ROW_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b for one m16n8k16 tile: A 16 x 16 row-major, B 16 x 8 column-
// major, bf16 in, f32 accumulators. Lane (g = lane / 4, c = lane % 4)
// holds d[0], d[1] at row g, columns 2c, 2c + 1 and d[2], d[3] at row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + R) of one head (row stride `stride` elements) into
// shared memory at `dst` (row stride TcTile::ROW_BYTES) by cp.async;
// rows >= nrows are zero-filled and their source is not read.
template <int DH, int R>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long stride, int row0,
                                          int nrows) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  static_assert((R * CH) % (NW * 32) == 0, "tile rows do not split evenly");
#pragma unroll
  for (int i = 0; i < R * CH / (NW * 32); ++i) {
    const int idx = threadIdx.x + i * NW * 32;
    const int r = idx / CH, c = idx - r * CH;
    const bool in = row0 + r < nrows;
    const __nv_bfloat16* src =
        base + (in ? (long long)(row0 + r) * stride : 0) + c * 8;
    cp_async16(dst + r * TcTile<DH>::ROW_BYTES + c * 16, src, in ? 16 : 0);
  }
}

template <int DH>
__global__ void __launch_bounds__(NW * 32, 2)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int sq, int skv, int h,
                  int kvh, float scale_log2, float scale_over_cap,
                  float cap_log2, int causal, int window) {
  using Tile = TcTile<DH>;
  constexpr int TK = Tile::BK, RB = Tile::ROW_BYTES;
  constexpr int NS = TK / 8;  // n8 tiles of S (keys)
  constexpr int NO = DH / 8;  // n8 tiles of O (head dim)
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  const uint32_t q_sm = smem_u32(Qs);
  const uint32_t k_sm = q_sm + BQ_TC * RB;   // two stages of TK rows
  const uint32_t v_sm = k_sm + 2 * TK * RB;  // two stages of TK rows

  const int b = blockIdx.x / h, hh = blockIdx.x - b * h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ_TC;
  const int kh = hh / (h / kvh);
  const long long q_stride = (long long)h * DH, k_stride = (long long)kvh * DH;
  const __nv_bfloat16* qb = q + (long long)b * sq * q_stride + (long long)hh * DH;
  const __nv_bfloat16* kb = k + (long long)b * skv * k_stride + (long long)kh * DH;
  const __nv_bfloat16* vb = v + (long long)b * skv * k_stride + (long long)kh * DH;
  __nv_bfloat16* ob = o + (long long)b * sq * q_stride + (long long)hh * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;

  // the key tiles any row of this block can see
  int kend = skv;
  if (causal) kend = min(kend, q0 + BQ_TC);
  const int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = kbeg / TK, t_last = (kend + TK - 1) / TK;

  // group 0: the Q tile and the first K tile; group 1: the first V tile
  load_rows<DH, BQ_TC>(q_sm, qb, q_stride, q0, sq);
  load_rows<DH, TK>(k_sm, kb, k_stride, t_first * TK, skv);
  cp_async_commit();
  load_rows<DH, TK>(v_sm, vb, k_stride, t_first * TK, skv);
  cp_async_commit();

  // ldmatrix row addresses of this lane. Q (A operand) and V (.trans, B
  // operand): row lane % 16, column 8 (lane / 16). K (B operand, two n8
  // tiles): key lane % 8 + 8 (lane / 16), column 8 ((lane / 8) % 2).
  const uint32_t q_lane = q_sm + (warp * 16 + lane % 16) * RB + (lane / 16) * 16;
  const uint32_t v_lane = (lane % 16) * RB + (lane / 16) * 16;
  const uint32_t k_lane = (lane % 8 + 8 * (lane / 16)) * RB + ((lane / 8) % 2) * 16;

  // rows g and g + 8 of this warp's 16
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = t_first; t < t_last; ++t) {
    const int st = (t - t_first) & 1;
    const bool more = t + 1 < t_last;
    cp_async_wait<1>();  // this tile's K (its V may still be in flight)
    __syncthreads();     // ... visible to all; the other stage is free
    if (more) {
      load_rows<DH, TK>(k_sm + (st ^ 1) * TK * RB, kb, k_stride, (t + 1) * TK, skv);
      cp_async_commit();
      load_rows<DH, TK>(v_sm + (st ^ 1) * TK * RB, vb, k_stride, (t + 1) * TK, skv);
      cp_async_commit();
    }

    // S = Q K^T: 16 rows x TK keys per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t k_tile = k_sm + st * TK * RB + k_lane;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_lane + kk * 32);
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, k_tile + j * 16 * RB + kk * 32);
        mma_bf16(s[2 * j], a, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // scores in log2 units; the mask only where this tile cuts it
    const bool cut = (t + 1) * TK > skv ||
                     (causal && (t + 1) * TK - 1 > q0) ||
                     (window > 0 && t * TK <= q0 + BQ_TC - 1 - window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        x = cap_log2 > 0.f ? cap_log2 * tanhf(x * scale_over_cap)
                           : x * scale_log2;
        if (cut) {
          const int kp = t * TK + 8 * j + 2 * c + (e & 1);
          const int qp = q0 + 16 * warp + g + 8 * (e >> 1);
          bool ok = kp < skv;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
      }

    // online softmax; a row lives on the 4 lanes of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - mx);
          rs += s[j][e];
        }
      l[r] = l[r] * alpha + rs;  // this lane's part; quad-summed at the end
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    if (more) cp_async_wait<2>(); else cp_async_wait<0>();  // this tile's V
    __syncthreads();

    // O += P V, P rounded to bf16 straight from the S accumulators
    const uint32_t v_tile = v_sm + st * TK * RB + v_lane;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < DH / 16; ++d) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_tile + kk * 16 * RB + d * 32);
        mma_bf16(acc[2 * d], a, bv[0], bv[1]);
        mma_bf16(acc[2 * d + 1], a, bv[2], bv[3]);
      }
    }
  }

  // out = acc / max(l, 1e-30) in bf16, staged in this warp's own Q rows
  // (no other warp reads them) and written with 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
  char* qw = reinterpret_cast<char*>(Qs) + warp * 16 * RB;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(qw + (g + 8 * r) * RB + (8 * j + 2 * c) * 2) =
          pack_bf16(__fdiv_rn(acc[j][2 * r], denom),
                    __fdiv_rn(acc[j][2 * r + 1], denom));
  }
  __syncwarp();
  constexpr int CH = DH / 8;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, cc = i - r * CH;
    const int qp = q0 + 16 * warp + r;
    if (qp < sq)
      *reinterpret_cast<uint4*>(ob + (long long)qp * q_stride + cc * 8) =
          *reinterpret_cast<const uint4*>(qw + r * RB + cc * 16);
  }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int skv, int h, int kvh, float scale, float softcap,
                int causal, int window, cudaStream_t stream) {
  auto kernel = flash_bf16_kernel<DH>;
  // per device: set on every launch (it is cheap)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TcTile<DH>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (sq + BQ_TC - 1) / BQ_TC;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(b * h, tiles);
  const bool capped = softcap > 0.0f;
  kernel<<<grid, NW * 32, TcTile<DH>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      skv, h, kvh, (float)((double)scale * 1.4426950408889634),
      capped ? (float)((double)scale / softcap) : 0.0f,
      capped ? (float)(softcap * 1.4426950408889634) : 0.0f, causal, window);
  return (int)cudaGetLastError();
}

// blocks of one instance resident on an SM (cudaOccupancy...)
template <int DH>
int occupancy(int dtype, int* blocks) {
  if (dtype == 1) {
    auto kernel = flash_bf16_kernel<DH>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TcTile<DH>::SMEM);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, NW * 32, TcTile<DH>::SMEM);
  }
  auto kernel = flash_fwd_kernel<float, DH>;
  const int bytes = smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            THREADS, bytes);
}

#define FLASH_ARGS q, k, v, o, b, sq, skv, h, kvh, scale, softcap, causal, window, stream

int dispatch(int dh, int dtype, const void* q, const void* k, const void* v,
             void* o, int b, int sq, int skv, int h, int kvh, float scale,
             float softcap, int causal, int window, cudaStream_t stream) {
  if (dtype == 0) {
    switch (dh) {
      case 32: return launch<float, 32>(FLASH_ARGS);
      case 64: return launch<float, 64>(FLASH_ARGS);
      case 128: return launch<float, 128>(FLASH_ARGS);
      case 256: return launch<float, 256>(FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (dh) {
      case 32: return launch_bf16<32>(FLASH_ARGS);
      case 64: return launch_bf16<64>(FLASH_ARGS);
      case 128: return launch_bf16<128>(FLASH_ARGS);
      case 256: return launch_bf16<256>(FLASH_ARGS);
    }
  }
  return (int)cudaErrorInvalidValue;
}

#undef FLASH_ARGS

}  // namespace

// q, o: (b, sq, h, dh); k, v: (b, skv, kvh, dh); all contiguous and
// 16-byte aligned; h % kvh == 0. dtype 0: float32, 1: bfloat16. softcap <=
// 0: none; window <= 0: none. Returns the cudaError_t of the launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int b, int sq, int skv, int h,
                              int kvh, int dh, float scale, float softcap,
                              int causal, int window, int dtype,
                              void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || kvh < 1 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(dh, dtype, q, k, v, o, b, sq, skv, h, kvh, scale, softcap,
                  causal, window, static_cast<cudaStream_t>(stream));
}

// How many blocks of the (dh, dtype) instance one SM of the current device
// holds at once, into *blocks. Returns the cudaError_t.
extern "C" int flash_attn_blocks_per_sm(int dh, int dtype, int* blocks) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return occupancy<32>(dtype, blocks);
    case 64: return occupancy<64>(dtype, blocks);
    case 128: return occupancy<128>(dtype, blocks);
    case 256: return occupancy<256>(dtype, blocks);
  }
  return (int)cudaErrorInvalidValue;
}
