// Fused QSGD quantize + offset-encode + sub-byte pack for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/wire_compress/wire_compress.py:80
// (qsgd_pack_pallas, body _qsgd_kernel at :42). Same function, per node i
// of a stack and element e of its flat plane:
//   ratio = |x| * inv[i];  level = floor(ratio) + (u < ratio - floor(ratio))
//   q = sign(x) * min(level, s);  enc = q + s  in [0, 2s],  s = 2^(bits-1)-1
// and k = 8/bits encoded levels per output byte (k = 1 for bits 8), element
// j of a group in bits [j*bits, (j+1)*bits), row-major over the node's flat
// plane, a ragged last byte filled with encoded value 0.
//
// What bounds it: bytes. Each element reads its f32 value and its f32
// uniform once and writes bits/8 bytes: (8 + bits/8) bytes per element
// over the card's 3.35 TB/s. A handful of flops per element is far below
// any compute roof.
//
// Design:
//  * ONE launch over the whole node stack (the vmapped Pallas call runs
//    once per node); the per-node inv is a vector, read once per thread;
//  * one thread per output byte: it reads its k consecutive values and
//    uniforms (neighbouring threads read neighbouring addresses) and
//    writes one byte; a grid-stride loop covers any size;
//  * any contiguous f32 length: the byte index, not a (rows, 128) tile,
//    drives the loop, so odd lengths need no separate path;
//  * bit-exact with the plain version and the JAX package: the product
//    and the subtraction are rounded separately (__fmul_rn, __fsub_rn), so
//    nvcc cannot contract them into an fma (which would change frac);
//    the norm and the uniform draw stay outside, as in JAX;
//  * sign(x) as jnp.sign: x > 0 -> +q, x < 0 -> -q, +-0 -> 0 (the level of
//    a zero is 0 anyway, so -0.0 and an all-zero plane give enc = s).
// Left for later: 16-byte vector loads and a wider output per thread.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <int BITS>
__global__ void qsgd_pack_kernel(const float* __restrict__ x,
                                 const float* __restrict__ u,
                                 const float* __restrict__ inv,
                                 uint8_t* __restrict__ out, long long n_nodes,
                                 long long d, long long nbytes) {
  constexpr int K = (BITS == 2 || BITS == 4) ? 8 / BITS : 1;
  constexpr float S = float((1 << (BITS - 1)) - 1);
  const long long total = n_nodes * nbytes;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long node = t / nbytes;
    const long long b = t - node * nbytes;
    const float sc = inv[node];
    const long long base = node * d;
    unsigned int byte = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const long long e = b * K + j;
      unsigned int enc = 0;
      if (e < d) {
        const float xv = x[base + e];
        const float ratio = __fmul_rn(fabsf(xv), sc);
        float level = floorf(ratio);
        const float frac = __fsub_rn(ratio, level);
        if (u[base + e] < frac) level = __fadd_rn(level, 1.0f);
        const float mag = fminf(level, S);
        const int q = xv > 0.0f ? (int)mag : (xv < 0.0f ? -(int)mag : 0);
        enc = (unsigned int)(q + (int)S);
      }
      byte |= enc << (j * BITS);
    }
    out[t] = (uint8_t)byte;
  }
}

template <int BITS>
int launch(const float* x, const float* u, const float* inv, uint8_t* out,
           long long n_nodes, long long d, long long nbytes,
           cudaStream_t stream) {
  const int threads = 256;
  const long long total = n_nodes * nbytes;
  long long blocks = (total + threads - 1) / threads;
  // a grid-stride loop covers the rest; 132 SMs x 16 blocks keeps every
  // SM full without a grid larger than needed.
  const long long cap = 132LL * 16;
  if (blocks > cap) blocks = cap;
  qsgd_pack_kernel<BITS><<<(unsigned int)blocks, threads, 0, stream>>>(
      x, u, inv, out, n_nodes, d, nbytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qsgd_pack(const void* x, const void* u, const void* inv,
                         void* out, long long n_nodes, long long d,
                         long long nbytes, int bits, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* uf = static_cast<const float*>(u);
  const float* iv = static_cast<const float*>(inv);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_nodes <= 0 || d <= 0 || nbytes <= 0) return cudaErrorInvalidValue;
  switch (bits) {
    case 2: return launch<2>(xf, uf, iv, o, n_nodes, d, nbytes, st);
    case 4: return launch<4>(xf, uf, iv, o, n_nodes, d, nbytes, st);
    case 8: return launch<8>(xf, uf, iv, o, n_nodes, d, nbytes, st);
    default: return cudaErrorInvalidValue;
  }
}
