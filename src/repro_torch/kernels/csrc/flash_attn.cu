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
// (q.k and p.v) against 2 (sq + skv) h dh elements moved. This first
// version computes on the FP32 pipes, not the tensor cores, so its roof is
// the card's 67 TFLOP/s FP32 rate in both types (the bf16 bound that the
// tensor cores set is 15x lower).
//
// Design:
//  * one block of 256 threads per (64-row query tile, batch x head); keys
//    in tiles of 64; tiles wholly above the diagonal or before the window
//    are skipped (they would change nothing: see above);
//  * the Q tile and each K and V tile are staged in dynamic shared memory
//    as f32 (bf16 inputs widened exactly), rows padded by 4 floats so the
//    16-byte reads of K rows hit distinct banks; at dh 256 this is 215 KB,
//    above the 48 KB default, hence cudaFuncSetAttribute;
//  * thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i (i < 4):
//    it computes scores for keys tx + 16 j (j < 4) with float4 reads of Q
//    and K, reduces the row max and sum over its 16 lanes with shuffles,
//    writes p to shared memory, and accumulates its rows' outputs at the
//    columns 4 (tx + 16 kk) of dh (2 (tx + 16 kk) at dh 32);
//  * f32: true FP32 fmas, no TF32. bf16: bf16 operands, f32 accumulation,
//    p rounded to bf16 before the p.v product (the Pallas kernel's
//    p.astype(v.dtype)), the output rounded once at the end;
//  * dh is not padded: 32, 64, 128 and 256 are compiled.
// Left for later: tensor cores (mma.sync / wgmma), TMA staging, and
// double-buffered tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDP = BK + 16;  // p row stride: the two half-warps hit
                              // disjoint banks on write and read
constexpr float NEG_INF = -1e30f;

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

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int PER16 = 8;
  __device__ static void load16(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float round_p(float p) {
    return __bfloat162float(__float2bfloat16(p));
  }
  __device__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
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

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, void* o,
             int b, int sq, int skv, int h, int kvh, float scale,
             float softcap, int causal, int window, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, skv, h, kvh, scale, softcap,
                           causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, skv, h, kvh, scale, softcap,
                           causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, skv, h, kvh, scale, softcap,
                            causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, b, sq, skv, h, kvh, scale, softcap,
                            causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(dh, q, k, v, o, b, sq, skv, h, kvh, scale,
                           softcap, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(dh, q, k, v, o, b, sq, skv, h, kvh, scale,
                                   softcap, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
