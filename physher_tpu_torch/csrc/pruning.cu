// Felsenstein pruning forward sweep and its reverse sweep, for Hopper (sm_90a).
//
// Kernel F (pruning_forward_*) replaces the TPU kernel
// physher_tpu/ops/pallas_fused.py _fused_fwd_kernel (built by
// build_fused_forward); kernel B (pruning_backward_*) replaces
// _fused_bwd_kernel (build_fused_backward). Both compute the function of the
// fused kernel, not its TPU layout: no block-diagonal [Rb, Rb] packing and no
// VMEM-resident stage buffer.
//
// Layouts (all contiguous, pattern axis innermost so that neighbouring threads
// touch neighbouring addresses):
//   tips      [T, 4, P]      tip partials (pad columns: all ones)
//   pmats     [N, C, 4, 4]   P matrix of the branch above each node
//   children  [I, maxc]      int32 child ids, -1 for a missing child
//   rootw     [C * 4]        props (x) freqs
//   partials  [I, C, 4, P]   rescaled partials of internal node rank k
//   scale     [I, P]         per-node per-pattern max m over (C, 4)
//   site_log  [P]            log(max(rootw . root, tiny)) + sum_k log m_k
// Internal node k has id T + k; ids are postorder ranks and the root is N - 1.
//
// What bounds them on this card: per node and pattern, F reads maxc*C*4
// child partials and writes C*4 (about (maxc+1)*C*4*4 bytes in float32)
// against maxc*C*4*4*2 FLOPs: about 1.3 FLOP per byte for a binary tree,
// far below the H100's ridge (~20 FLOP per byte for float32 on the CUDA
// cores: 67 TFLOP/s over 3.35 TB/s), so both kernels are bound by
// device-memory (or L2) bandwidth and, at small pattern counts, by the
// latency of the chain of dependent node steps.
//
// F does the simple thing about it: one thread per pattern, the pattern
// axis innermost so every load and store is coalesced, P matrices read
// through the read-only cache (__ldg; every thread of a warp reads the same
// address, a broadcast). F writes the rescaled partials and the scalers to
// device memory anyway, so B keeps them instead of recomputing the forward
// as the TPU kernel must (it has only VMEM); that costs no extra traffic in
// F.
//
// B, redesigned for this card, is the reverse step of csrc/s4_backward.cuh
// at one chain, which K6' at S = 4 shares: a walk that carries only the
// cotangents by preorder level, then a pass that sums every branch's dP
// and d rootw at once, in a fixed order into per-chunk partial sums that
// the caller sums over the chunks (none up to 2048 patterns); the header
// says how.

#include <cuda_runtime.h>

#include "s4_backward.cuh"
#include "tiles.cuh"

namespace {

// Loads the 4 partials of child `ch` in category c at pattern p.
template <typename scalar_t>
__device__ inline void load_child(const scalar_t* __restrict__ tips,
                                  const scalar_t* __restrict__ partials,
                                  int ch, int c, int T, int C, int P, int p,
                                  scalar_t x[4]) {
  if (ch < T) {
#pragma unroll
    for (int b = 0; b < 4; ++b) x[b] = tips[((size_t)ch * 4 + b) * P + p];
  } else {
    const size_t base = ((size_t)(ch - T) * C + c) * 4;
#pragma unroll
    for (int b = 0; b < 4; ++b) x[b] = partials[(base + b) * P + p];
  }
}

// contrib[a] = sum_b P[ch, c, a, b] * x[b]
template <typename scalar_t>
__device__ inline void apply_p(const scalar_t* __restrict__ pmats, int ch,
                               int c, int C, const scalar_t x[4],
                               scalar_t out[4]) {
  const scalar_t* pm = pmats + ((size_t)ch * C + c) * 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    scalar_t s = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) s += __ldg(pm + a * 4 + b) * x[b];
    out[a] = s;
  }
}

template <typename scalar_t, int C>
__global__ void forward_kernel(const scalar_t* __restrict__ tips,
                               const scalar_t* __restrict__ pmats,
                               const int* __restrict__ children,
                               const scalar_t* __restrict__ rootw,
                               scalar_t* __restrict__ partials,
                               scalar_t* __restrict__ scale,
                               scalar_t* __restrict__ site_log, int T, int I,
                               int maxc, int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  scalar_t res[C][4];
  scalar_t log_sum = 0;
  for (int k = 0; k < I; ++k) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) res[c][a] = 1;
    for (int j = 0; j < maxc; ++j) {
      const int ch = __ldg(children + k * maxc + j);
      if (ch < 0) continue;  // a missing child contributes 1
#pragma unroll
      for (int c = 0; c < C; ++c) {
        scalar_t x[4], contrib[4];
        load_child(tips, partials, ch, c, T, C, P, p, x);
        apply_p(pmats, ch, c, C, x, contrib);
#pragma unroll
        for (int a = 0; a < 4; ++a) res[c][a] *= contrib[a];
      }
    }
    scalar_t m = Limits<scalar_t>::tiny();
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) m = res[c][a] > m ? res[c][a] : m;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        res[c][a] = res[c][a] / m;
        partials[(((size_t)k * C + c) * 4 + a) * P + p] = res[c][a];
      }
    scale[(size_t)k * P + p] = m;
    log_sum += log_(m);
  }
  // res holds the root (rank I - 1)
  scalar_t site = 0;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int a = 0; a < 4; ++a) site += __ldg(rootw + c * 4 + a) * res[c][a];
  const scalar_t tiny = Limits<scalar_t>::tiny();
  site = site > tiny ? site : tiny;
  site_log[p] = log_(site) + log_sum;
}

template <typename scalar_t>
cudaError_t launch_forward(const void* tips, const void* pmats,
                           const void* children, const void* rootw,
                           void* partials, void* scale, void* site_log, int T,
                           int I, int C, int maxc, int P, int threads,
                           cudaStream_t stream) {
  const dim3 grid((P + threads - 1) / threads);
  const auto* t_ = static_cast<const scalar_t*>(tips);
  const auto* pm_ = static_cast<const scalar_t*>(pmats);
  const auto* ch_ = static_cast<const int*>(children);
  const auto* rw_ = static_cast<const scalar_t*>(rootw);
  auto* pa_ = static_cast<scalar_t*>(partials);
  auto* sc_ = static_cast<scalar_t*>(scale);
  auto* sl_ = static_cast<scalar_t*>(site_log);
#define PHYSHER_FWD_CASE(CC)                                                  \
  case CC:                                                                    \
    forward_kernel<scalar_t, CC><<<grid, threads, 0, stream>>>(              \
        t_, pm_, ch_, rw_, pa_, sc_, sl_, T, I, maxc, P);                     \
    break;
  switch (C) {
    PHYSHER_FWD_CASE(1)
    PHYSHER_FWD_CASE(2)
    PHYSHER_FWD_CASE(3)
    PHYSHER_FWD_CASE(4)
    PHYSHER_FWD_CASE(5)
    PHYSHER_FWD_CASE(6)
    PHYSHER_FWD_CASE(7)
    PHYSHER_FWD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PHYSHER_FWD_CASE
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t launch_backward(const void* tips, const void* pmats,
                            const void* children, const void* order,
                            const void* offsets, const void* rootw,
                            const void* partials, const void* scale,
                            const void* g, void* gbuf, void* inv,
                            void* dP_part, void* drootw_part, int n_levels,
                            int T, int I, int C, int maxc, int P,
                            int dp_chunk, cudaStream_t stream) {
  return launch_s4_backward<scalar_t>(
      static_cast<const scalar_t*>(tips), static_cast<const scalar_t*>(pmats),
      static_cast<const int*>(children), static_cast<const int*>(order),
      static_cast<const int*>(offsets), n_levels,
      RootWeights<scalar_t>{static_cast<const scalar_t*>(rootw),
                            static_cast<scalar_t*>(drootw_part)},
      static_cast<const scalar_t*>(partials),
      static_cast<const scalar_t*>(scale), static_cast<const scalar_t*>(g),
      static_cast<scalar_t*>(gbuf), static_cast<scalar_t*>(inv),
      static_cast<scalar_t*>(dP_part), T, I, C, maxc, P, 1, dp_chunk,
      stream);
}

}  // namespace

extern "C" {

cudaError_t pruning_forward_f32(const void* tips, const void* pmats,
                                const void* children, const void* rootw,
                                void* partials, void* scale, void* site_log,
                                int T, int I, int C, int maxc, int P,
                                int threads, void* stream) {
  return launch_forward<float>(tips, pmats, children, rootw, partials, scale,
                               site_log, T, I, C, maxc, P, threads,
                               static_cast<cudaStream_t>(stream));
}

cudaError_t pruning_forward_f64(const void* tips, const void* pmats,
                                const void* children, const void* rootw,
                                void* partials, void* scale, void* site_log,
                                int T, int I, int C, int maxc, int P,
                                int threads, void* stream) {
  return launch_forward<double>(tips, pmats, children, rootw, partials, scale,
                                site_log, T, I, C, maxc, P, threads,
                                static_cast<cudaStream_t>(stream));
}

#define PHYSHER_PRUNING_BACKWARD_ENTRY(SUFFIX, TYPE)                          \
  cudaError_t pruning_backward_##SUFFIX(                                      \
      const void* tips, const void* pmats, const void* children,              \
      const void* order, const void* offsets, const void* rootw,              \
      const void* partials, const void* scale, const void* g, void* gbuf,     \
      void* inv, void* dP_part, void* drootw_part, int n_levels, int T,       \
      int I, int C, int maxc, int P, int dp_chunk, void* stream) {            \
    return launch_backward<TYPE>(tips, pmats, children, order, offsets,       \
                                 rootw, partials, scale, g, gbuf, inv,        \
                                 dP_part, drootw_part, n_levels, T, I, C,     \
                                 maxc, P, dp_chunk,                           \
                                 static_cast<cudaStream_t>(stream));          \
  }

PHYSHER_PRUNING_BACKWARD_ENTRY(f32, float)
PHYSHER_PRUNING_BACKWARD_ENTRY(f64, double)

#undef PHYSHER_PRUNING_BACKWARD_ENTRY

}  // extern "C"
