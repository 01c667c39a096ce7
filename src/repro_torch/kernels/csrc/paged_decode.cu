// Paged flash decode for Hopper (sm_90a): single-token GQA attention that
// reads K/V THROUGH a per-row block table.
//
// Replaces the TPU kernel repro/kernels/flash_attn/decode.py:83
// (paged_flash_decode_pallas, body _kernel at :37). Same function: the
// seq_lens mask, an optional sliding window, an optional softcap, online
// softmax in f32, and zeros for a row with seq_len 0.
//
// What bounds it: bytes. Each (row, kv head) reads its visible K and V
// once: about sum_rows ceil(visible_len/page)*page * kvh * dh * 2 (K and V)
// * bytes/elt, over the card's 3.35 TB/s. The arithmetic is 4 flops per
// byte pair at most, far below the tensor cores' ridge.
//
// Design (not a block-by-block copy of the TPU kernel):
//  * one thread block per (row, kv head, chunk of <= 8 query heads of the
//    GQA group); a loop over that row's tokens stands in for the TPU's
//    sequential third grid axis, and the block reads page ids from the
//    block table itself (the TPU prefetches them as scalars);
//  * it stops at seq_len (the TPU visits all n_blocks) and starts at the
//    window's first visible token, so pages wholly before the window are
//    never read;
//  * warp w takes a tile of U tokens from lo + w*U, then jumps by
//    kWarps*U. Each lane holds E = dh/32 contiguous elements of a K/V row
//    (16-byte vector loads where the width allows), so a token's row is
//    one coalesced read. The next tile's K and V are loaded into registers
//    before the current tile's arithmetic, so loads overlap compute;
//  * scores, running max and sum, and the accumulator are f32. The tile's
//    U x G q.k dots are reduced with warp shuffles side by side (one chain
//    of 5 shuffle rounds, not U*G chains), and the online softmax is
//    updated once per tile. Each warp keeps its own softmax state; the
//    warps merge through shared memory at the end;
//  * the output is written in the input dtype.
// Left for later: splitting a row's tokens across blocks (split-K) to
// fill more than b*kvh SMs, and TMA / cp.async staging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxGroup = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes -> floats
__device__ __forceinline__ void unpack(const uint4& u, float* o, float) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* o,
                                       __nv_bfloat16) {
  // bfloat16 is the high half of a float32; element 0 is the low half-word
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// E contiguous elements of T -> floats
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float* o) {
  if constexpr ((E * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < E / kPer; ++i) unpack(__ldg(p4 + i), o + i * kPer, T());
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = to_float(p[e]);
  }
}

// U tokens' K and V rows (this lane's E elements) from token t0 on, read
// through the row's block table; rows at or past hi are zeros
template <typename T, int E, int U>
__device__ __forceinline__ void load_tile(const T* __restrict__ k_head,
                                          const T* __restrict__ v_head,
                                          const int* __restrict__ trow, int page,
                                          size_t tok_stride, int t0, int hi,
                                          float (&kr)[U][E], float (&vr)[U][E]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    if (t < hi) {
      const size_t off = ((size_t)trow[t / page] * page + t % page) * tok_stride;
      load_row<T, E>(k_head + off, kr[u]);
      load_row<T, E>(v_head + off, vr[u]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
    }
  }
}

// T: element type; E = dh / 32; G: query heads per block (>= the chunk);
// U: tokens per warp and tile (two tiles are in registers at once).
template <typename T, int E, int G, int U>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int kvh, int group, int page, int n_blocks, int window,
                    float softcap, float scale) {
  constexpr int dh = 32 * E;
  const int row = blockIdx.x, h = blockIdx.y;
  const int g0 = blockIdx.z * G;
  const int ng = min(G, group - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int seq_len = seq_lens[row];
  // the table covers n_blocks*page positions; like the TPU kernel, never
  // look past it. The window counts back from the row's own last token.
  const int hi = min(seq_len, n_blocks * page);
  const int lo = window > 0 ? max(0, seq_len - window) : 0;

  float qr[G][E], acc[G][E], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = qr[g][e] = 0.f;
    if (g < ng)
      load_row<T, E>(q + ((size_t)(row * kvh + h) * group + g0 + g) * dh + lane * E,
                     qr[g]);
  }

  const int* trow = block_table + (size_t)row * n_blocks;
  const T* k_head = k_pages + (size_t)h * dh + lane * E;
  const T* v_head = v_pages + (size_t)h * dh + lane * E;
  const size_t tok_stride = (size_t)kvh * dh;
  constexpr int kStep = kWarps * U;

  float kr[U][E], vr[U][E];
  int t0 = lo + warp * U;
  load_tile<T, E, U>(k_head, v_head, trow, page, tok_stride, t0, hi, kr, vr);
  for (; t0 < hi; t0 += kStep) {
    // issue the next tile's loads before this tile's arithmetic
    float kn[U][E], vn[U][E];
    load_tile<T, E, U>(k_head, v_head, trow, page, tok_stride, t0 + kStep, hi,
                       kn, vn);

    // U x G partial dots, then their shuffle reductions side by side
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kr[u][e], d);
        s[u][g] = d;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);

    // one online-softmax update per head for the whole tile
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= ng) break;
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = s[u][g] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[u][g] = t0 + u < hi ? x : -INFINITY;
        m_new = fmaxf(m_new, s[u][g]);
      }
      // token t0 is visible, so m_new is finite and alpha is 0 on the
      // first tile (m = -inf)
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u][g] - m_new);  // 0 past hi
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
      }
      m[g] = m_new;
    }

#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[u][e] = kn[u][e];
        vr[u][e] = vn[u][e];
      }
  }

  // merge the warps' partial softmax states: smem[warp][g][dh + 2]
  extern __shared__ float smem[];
  constexpr int kStride = dh + 2;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= ng) break;
    float* s = smem + (warp * G + g) * kStride;
#pragma unroll
    for (int e = 0; e < E; ++e) s[lane * E + e] = acc[g][e];
    if (lane == 0) {
      s[dh] = m[g];
      s[dh + 1] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * dh; i += blockDim.x) {
    const int g = i / dh, d = i % dh;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, smem[(w * G + g) * kStride + dh]);
    float num = 0.f, den = 0.f;
    if (mx > -INFINITY) {  // else: no visible token (seq_len 0) -> zeros
      for (int w = 0; w < kWarps; ++w) {
        const float* s = smem + (w * G + g) * kStride;
        const float f = expf(s[dh] - mx);  // a warp that saw nothing gives 0
        num = fmaf(s[d], f, num);
        den = fmaf(s[dh + 1], f, den);
      }
    }
    store(out + ((size_t)(row * kvh + h) * group + g0 + g) * dh + d,
          den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int E, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tbl,
                   const int* seq, void* out, int b, int kvh, int group,
                   int page, int n_blocks, int window, float softcap,
                   float scale, cudaStream_t stream) {
  // U*E <= 32 keeps the two K/V tiles within 128 registers
  constexpr int U = (8 / G < 32 / E) ? 8 / G : 32 / E;
  auto kernel = paged_decode_kernel<T, E, G, U>;
  const size_t smem = sizeof(float) * kWarps * G * (32 * E + 2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(b, kvh, (group + G - 1) / G);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tbl, seq, static_cast<T*>(out), kvh, group,
      page, n_blocks, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T, int E>
cudaError_t dispatch_group(const void* q, const void* k, const void* v,
                           const int* tbl, const int* seq, void* out, int b,
                           int kvh, int group, int page, int n_blocks,
                           int window, float softcap, float scale,
                           cudaStream_t st) {
#define ARGS q, k, v, tbl, seq, out, b, kvh, group, page, n_blocks, window, softcap, scale, st
  if (group <= 1) return launch<T, E, 1>(ARGS);
  if (group <= 2) return launch<T, E, 2>(ARGS);
  if (group <= 4) return launch<T, E, 4>(ARGS);
  return launch<T, E, kMaxGroup>(ARGS);  // larger groups: several blocks
#undef ARGS
}

template <typename T>
cudaError_t dispatch_dim(int dh, const void* q, const void* k, const void* v,
                         const int* tbl, const int* seq, void* out, int b,
                         int kvh, int group, int page, int n_blocks,
                         int window, float softcap, float scale,
                         cudaStream_t st) {
#define ARGS q, k, v, tbl, seq, out, b, kvh, group, page, n_blocks, window, softcap, scale, st
  switch (dh) {
    case 32: return dispatch_group<T, 1>(ARGS);
    case 64: return dispatch_group<T, 2>(ARGS);
    case 96: return dispatch_group<T, 3>(ARGS);
    case 128: return dispatch_group<T, 4>(ARGS);
    case 160: return dispatch_group<T, 5>(ARGS);
    case 192: return dispatch_group<T, 6>(ARGS);
    case 224: return dispatch_group<T, 7>(ARGS);
    case 256: return dispatch_group<T, 8>(ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef ARGS
}

}  // namespace

// q (b, kvh, group, dh); k/v pages (n_pages + 1, page, kvh, dh), all
// contiguous and of one dtype (0: float32, 1: bfloat16); block_table
// (b, n_blocks) int32; seq_lens (b,) int32; out like q. window <= 0 means
// no window, softcap <= 0 no softcap. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* block_table,
                            const void* seq_lens, void* out, int b, int kvh,
                            int group, int dh, int page, int n_blocks,
                            int window, float softcap, float scale, int dtype,
                            void* stream) {
  const int* tbl = static_cast<const int*>(block_table);
  const int* seq = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || kvh <= 0 || group <= 0 || page <= 0 || n_blocks <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dim<float>(dh, q, k_pages, v_pages, tbl, seq, out, b, kvh,
                               group, page, n_blocks, window, softcap, scale, st);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(dh, q, k_pages, v_pages, tbl, seq, out,
                                       b, kvh, group, page, n_blocks, window,
                                       softcap, scale, st);
  return cudaErrorInvalidValue;
}
