// Wire-compressor kernels for Hopper (sm_90a): the fused QSGD quantize +
// offset-encode + sub-byte pack (qsgd_pack) and the fixed-k sender pack
// (fixedk_gather_pack, below).
//
// qsgd_pack:
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

// ---------------------------------------------------------------------------
// fixedk_gather_pack
//
// Replaces the TPU kernel repro/kernels/wire_compress/wire_compress.py:112
// (fixedk_gather_pack_pallas, body _gather_kernel at :106), the sender-side
// pack of the fixedk_packed exchange (repro/core/gossip.py:781-788). Per
// node l of a block, kept row r and column c:
//   out[l, r, c] = db[l, idx[l, r], c] * scale
// with scale the f32 rounding of nb/kb: one f32 multiply per element,
// rounded once (__fmul_rn), so the result is bit-exact with
// jnp.take(db, idx, 0) * scale and with the plain version.
//
// What bounds it: bytes. Each node reads kb rows of block f32 values and
// kb int32 indices and writes kb rows: (8 block + 4) bytes per kept row
// over the card's 3.35 TB/s; one multiply per element is nothing.
//
// Design: ONE launch over the whole node block (the TPU kernel packs one
// node per call); neighbouring threads take neighbouring columns of one
// row, so a row is read and written in whole sectors; where block is a
// multiple of 4 each thread moves one 16-byte float4 (the rows of a
// contiguous f32 view then start 16-byte aligned). A grid-stride loop
// covers any size. The indices come from fixedk_indices (distinct, in
// [0, nb)); one that is not in range gives a NaN row instead of a read
// out of bounds.
// Left for later: TMA / cp.async bulk copies of whole rows.
template <int VEC>
__global__ void fixedk_gather_pack_kernel(const float* __restrict__ db,
                                          const int* __restrict__ idx,
                                          float* __restrict__ out,
                                          long long n_nodes, long long nb,
                                          long long block, long long kb,
                                          float scale) {
  const long long vpr = block / VEC;   // vectors per row
  const long long total = n_nodes * kb * vpr;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / vpr;      // node * kb + r
    const long long c = (t - row * vpr) * VEC;
    const long long node = row / kb;
    const int i = idx[row];
    float* o = out + row * block + c;
    if (i < 0 || (long long)i >= nb) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = __int_as_float(0x7fc00000);
      continue;
    }
    const float* src = db + (node * nb + i) * block + c;
    if (VEC == 4) {
      float4 v = *reinterpret_cast<const float4*>(src);
      v.x = __fmul_rn(v.x, scale);
      v.y = __fmul_rn(v.y, scale);
      v.z = __fmul_rn(v.z, scale);
      v.w = __fmul_rn(v.w, scale);
      *reinterpret_cast<float4*>(o) = v;
    } else {
      o[0] = __fmul_rn(src[0], scale);
    }
  }
}

template <int VEC>
int launch_gather(const float* db, const int* idx, float* out,
                  long long n_nodes, long long nb, long long block,
                  long long kb, float scale, cudaStream_t stream) {
  const int threads = 256;
  const long long total = n_nodes * kb * (block / VEC);
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 16;
  if (blocks > cap) blocks = cap;
  fixedk_gather_pack_kernel<VEC><<<(unsigned int)blocks, threads, 0,
                                   stream>>>(db, idx, out, n_nodes, nb,
                                             block, kb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fixedk_gather_pack(const void* db, const void* idx, void* out,
                                  long long n_nodes, long long nb,
                                  long long block, long long kb, float scale,
                                  void* stream) {
  const float* d = static_cast<const float*>(db);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_nodes <= 0 || nb <= 0 || block <= 0 || kb <= 0)
    return cudaErrorInvalidValue;
  const bool vec4 = block % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(db) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) return launch_gather<4>(d, ix, o, n_nodes, nb, block, kb, scale,
                                    st);
  return launch_gather<1>(d, ix, o, n_nodes, nb, block, kb, scale, st);
}

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
