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
// cores: 67 TFLOP/s over 3.35 TB/s), and at ML and ADVI sizes (the fluA
// tree, 238 patterns) each sweep moves a few MB (bounds of 0.2 us), so both
// kernels wait on the latency of the chain of dependent node steps.
//
// F, redesigned for this card, is the forward step of csrc/s4_forward.cuh
// at one chain, which K5' at S = 4 shares: a walk by postorder level, leaves
// first, in one launch, the threads on (pattern, category, state) so that
// the rescaling max over (C, 4) is a few warp shuffles, every load
// unconditional and a binary node's tip children copied by cp.async two
// levels ahead; the header says how. F writes the rescaled partials and the
// scalers, which B keeps instead of recomputing the forward as the TPU
// kernel must (it has only VMEM).
//
// B, redesigned for this card, is the reverse step of csrc/s4_backward.cuh
// at one chain, which K6' at S = 4 shares: a walk that carries only the
// cotangents by preorder level, then a pass that sums every branch's dP
// and d rootw at once, in a fixed order into per-chunk partial sums that
// the caller sums over the chunks (none up to 2048 patterns); the header
// says how.

#include <cuda_runtime.h>

#include "s4_backward.cuh"
#include "s4_forward.cuh"

namespace {

template <typename scalar_t>
cudaError_t launch_forward(const void* tips, const void* pmats,
                           const void* children, const void* order,
                           const void* offsets, const void* rootw,
                           void* partials, void* scale, void* site_log,
                           int n_levels, int T, int I, int C, int maxc, int P,
                           cudaStream_t stream) {
  return launch_s4_forward<scalar_t>(
      static_cast<const scalar_t*>(tips), static_cast<const scalar_t*>(pmats),
      static_cast<const int*>(children), static_cast<const int*>(order),
      static_cast<const int*>(offsets), n_levels,
      RootWeights<scalar_t>{static_cast<const scalar_t*>(rootw), nullptr},
      static_cast<scalar_t*>(partials), static_cast<scalar_t*>(scale),
      static_cast<scalar_t*>(site_log), T, I, C, maxc, P, 1, 1, stream);
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

#define PHYSHER_PRUNING_FORWARD_ENTRY(SUFFIX, TYPE)                           \
  cudaError_t pruning_forward_##SUFFIX(                                       \
      const void* tips, const void* pmats, const void* children,              \
      const void* order, const void* offsets, const void* rootw,              \
      void* partials, void* scale, void* site_log, int n_levels, int T,       \
      int I, int C, int maxc, int P, void* stream) {                          \
    return launch_forward<TYPE>(tips, pmats, children, order, offsets, rootw, \
                                partials, scale, site_log, n_levels, T, I, C, \
                                maxc, P, static_cast<cudaStream_t>(stream));  \
  }

PHYSHER_PRUNING_FORWARD_ENTRY(f32, float)
PHYSHER_PRUNING_FORWARD_ENTRY(f64, double)

#undef PHYSHER_PRUNING_FORWARD_ENTRY

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
