// Fused SDM-DSGD update for Hopper (sm_90a): Algorithm 1's elementwise
// core in one pass over (rows, 1024) f32 planes.
//
// Replaces the TPU kernel repro/kernels/sdm_update/sdm_update.py:77
// (sdm_update_pallas, body _kernel at :52). Per element, with three u32
// bit streams (mask, n1, n2) and u(b) = max((b >> 8) * 2^-24, 2^-24):
//   s   = s + nb
//   g   = clip(g, +-C)                                  (if C is given)
//   g   = g + sigma * sqrt(-2 log u(n1)) * cos(2 pi u(n2))   (if sigma > 0)
//   y   = (1 - theta) x + theta (w_self x + s - gamma g)
//   sd  = u(mask) < p ? (y - x) * f32(1/p) : 0
//   x   = x + sd
// and writes x, s and sd.
//
// What bounds it: bytes. It reads 7 streams of 4 bytes and writes 3: 40
// bytes per element over the card's 3.35 TB/s. The accurate logf, cosf and
// sqrtf cost ~150 instructions per element, which at this byte rate stays
// under the FP32 pipes' roof.
//
// Design:
//  * one thread per 4 elements: 16-byte loads of each stream (float4 for
//    x, s, nb, g; uint4 for the bit words) and 16-byte stores; a
//    grid-stride loop covers any multiple of 4 (the plane is rows x 1024);
//    streaming cache hints (__ldcs / __stcs): every byte is touched once;
//  * the bit streams are u32 words in 4-byte storage (the wrapper passes
//    int32 tensors), so a word costs 4 bytes, not the 8 of an int64;
//  * bit-equal with the plain version (repro_torch/kernels/sdm_update/
//    ref.py), which rounds every operation as its own f32 tensor op: each
//    product, sum and difference here is rounded alone in the same order
//    (__fmul_rn, __fadd_rn, __fsub_rn), so nvcc cannot contract them into
//    fmas; logf, cosf and sqrtf are CUDA's accurate functions, the ones
//    torch's own CUDA log, cos and sqrt call (no --use_fast_math);
//  * 1/p is rounded to f32 on the host from the double reciprocal, as the
//    Pallas kernel's d * (1.0 / p) does; 1 - theta likewise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  float p, inv_p, one_minus_theta, theta, gamma, sigma, clip_c, self_w;
  int has_clip, has_noise;
};

__device__ __forceinline__ float uniform01(uint32_t bits) {
  const float inv24 = 5.9604644775390625e-08f;   // 2^-24
  return fmaxf(__fmul_rn((float)(bits >> 8), inv24), inv24);
}

__device__ __forceinline__ void update(float x, float s, float nb, float g,
                                       uint32_t mb, uint32_t n1, uint32_t n2,
                                       const Params& q, float& xo, float& so,
                                       float& sdo) {
  s = __fadd_rn(s, nb);
  if (q.has_clip) g = fminf(fmaxf(g, -q.clip_c), q.clip_c);
  if (q.has_noise) {
    const float two_pi = 6.283185307179586f;
    const float r = sqrtf(__fmul_rn(logf(uniform01(n1)), -2.0f));
    const float c = cosf(__fmul_rn(uniform01(n2), two_pi));
    g = __fadd_rn(g, __fmul_rn(__fmul_rn(r, c), q.sigma));
  }
  const float a = __fmul_rn(x, q.one_minus_theta);
  float b = __fadd_rn(__fmul_rn(x, q.self_w), s);
  b = __fsub_rn(b, __fmul_rn(g, q.gamma));
  const float y = __fadd_rn(a, __fmul_rn(b, q.theta));
  const float d = __fsub_rn(y, x);
  const float sd = uniform01(mb) < q.p ? __fmul_rn(d, q.inv_p) : 0.0f;
  xo = __fadd_rn(x, sd);
  so = s;
  sdo = sd;
}

__global__ void __launch_bounds__(256)
sdm_update_kernel(const float4* __restrict__ x, const float4* __restrict__ s,
                  const float4* __restrict__ nb, const float4* __restrict__ g,
                  const uint4* __restrict__ mb, const uint4* __restrict__ n1,
                  const uint4* __restrict__ n2, float4* __restrict__ xo,
                  float4* __restrict__ so, float4* __restrict__ sdo,
                  long long n4, Params q) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const float4 xv = __ldcs(x + i), sv = __ldcs(s + i), nv = __ldcs(nb + i),
                 gv = __ldcs(g + i);
    const uint4 mv = __ldcs(mb + i), av = __ldcs(n1 + i), bv = __ldcs(n2 + i);
    float4 xr, sr, dr;
    update(xv.x, sv.x, nv.x, gv.x, mv.x, av.x, bv.x, q, xr.x, sr.x, dr.x);
    update(xv.y, sv.y, nv.y, gv.y, mv.y, av.y, bv.y, q, xr.y, sr.y, dr.y);
    update(xv.z, sv.z, nv.z, gv.z, mv.z, av.z, bv.z, q, xr.z, sr.z, dr.z);
    update(xv.w, sv.w, nv.w, gv.w, mv.w, av.w, bv.w, q, xr.w, sr.w, dr.w);
    __stcs(xo + i, xr);
    __stcs(so + i, sr);
    __stcs(sdo + i, dr);
  }
}

}  // namespace

// n: element count, a multiple of 4; every pointer 16-byte aligned.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sdm_update(const float* x, const float* s, const float* nb,
                          const float* g, const uint32_t* mb,
                          const uint32_t* n1, const uint32_t* n2, float* xo,
                          float* so, float* sd, long long n, float p,
                          float inv_p, float one_minus_theta, float theta,
                          float gamma, float sigma, float clip_c,
                          int has_clip, float self_w, int has_noise,
                          void* stream) {
  if (n % 4 != 0) return (int)cudaErrorInvalidValue;
  const uintptr_t all = (uintptr_t)x | (uintptr_t)s | (uintptr_t)nb |
                        (uintptr_t)g | (uintptr_t)mb | (uintptr_t)n1 |
                        (uintptr_t)n2 | (uintptr_t)xo | (uintptr_t)so |
                        (uintptr_t)sd;
  if (all % 16 != 0) return (int)cudaErrorMisalignedAddress;
  Params q{p, inv_p, one_minus_theta, theta, gamma, sigma, clip_c, self_w,
           has_clip, has_noise};
  const long long n4 = n / 4;
  const int threads = 256;
  long long blocks = (n4 + threads - 1) / threads;
  // a grid-stride loop covers the rest: 132 SMs x 8 resident blocks
  const long long cap = 132LL * 8;
  if (blocks > cap) blocks = cap;
  sdm_update_kernel<<<(unsigned int)blocks, threads, 0,
                      (cudaStream_t)stream>>>(
      (const float4*)x, (const float4*)s, (const float4*)nb,
      (const float4*)g, (const uint4*)mb, (const uint4*)n1, (const uint4*)n2,
      (float4*)xo, (float4*)so, (float4*)sd, n4, q);
  return (int)cudaGetLastError();
}
