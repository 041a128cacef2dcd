// Shared-memory tiles of the forward pruning kernels for any state count S
// from 2 to 64: K7' (csrc/wide.cu) and K5' at S != 4 (csrc/loop.cu), and the
// constants that the reverse sweeps' node step (csrc/wide_backward.cuh)
// shares with them. A block of 8 warps stages one child's P matrix ([S, S])
// and its [S, 32] partials tile in shared memory; warp w owns states w,
// w + 8, ... (at most 8, so S <= 64) of its lane's pattern and reads P as a
// broadcast. The tile rows are padded to 33 so that a warp's 32 lanes hit
// 32 banks.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int NW = 8;                  // warps per block
constexpr int THREADS = NW * 32;
constexpr int TP = 32;                 // patterns per tile, one per lane
constexpr int TPS = TP + 1;            // padded row stride of [S][TP] tiles
constexpr int A_MAX = 8;               // states per thread in the products
constexpr int MAX_S = NW * A_MAX;      // 64
constexpr int MAX_C = 8;
constexpr int BWD_CHUNKS = 4;          // pattern tiles per backward block
constexpr int BWD_P = TP * BWD_CHUNKS;

// Ps <- P[ch, c] ([S, S]); Xs[b][q] <- child ch's partials (category c) at
// pattern p0 + q, or `pad` past P. `partials` may have been written earlier
// in the same launch (csrc/loop.cu): plain loads, not the read-only path.
template <typename scalar_t>
__device__ inline void stage_child(const scalar_t* __restrict__ tips,
                                   const scalar_t* __restrict__ pmats,
                                   const scalar_t* partials, int ch, int c,
                                   int T, int C, int S, int P, int p0,
                                   scalar_t pad, scalar_t* Ps, scalar_t* Xs) {
  const scalar_t* pm = pmats + ((size_t)ch * C + c) * S * S;
  for (int t = threadIdx.x; t < S * S; t += blockDim.x) Ps[t] = __ldg(pm + t);
  const scalar_t* src = ch < T ? tips + (size_t)ch * S * P
                               : partials + ((size_t)(ch - T) * C + c) * S * P;
  for (int t = threadIdx.x; t < S * TP; t += blockDim.x) {
    const int b = t / TP, q = t - b * TP, p = p0 + q;
    Xs[b * TPS + q] = p < P ? src[(size_t)b * P + p] : pad;
  }
}

// acc[i] *= sum_b Ps[a, b] Xs[b, lane] for the thread's states a = w + NW i
template <typename scalar_t>
__device__ inline void mul_product(const scalar_t* Ps, const scalar_t* Xs,
                                   int S, int w, int lane,
                                   scalar_t acc[A_MAX]) {
  scalar_t s[A_MAX];
#pragma unroll
  for (int i = 0; i < A_MAX; ++i) s[i] = 0;
  for (int b = 0; b < S; ++b) {
    const scalar_t xb = Xs[b * TPS + lane];
#pragma unroll
    for (int i = 0; i < A_MAX; ++i) {
      const int a = w + NW * i;
      if (a < S) s[i] += Ps[a * S + b] * xb;
    }
  }
#pragma unroll
  for (int i = 0; i < A_MAX; ++i) acc[i] *= s[i];
}

}  // namespace
