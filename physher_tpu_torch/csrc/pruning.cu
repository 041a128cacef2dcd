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
//
// Any other state count, S from 2 to 64 (protein S = 20, codon S = 61):
// fused_wide_forward_kernel (K1') and fused_wide_backward_kernel (K2'), the
// same function with the layouts above at S in place of 4, in both of the
// TPU kernel's modes (ops/fused.py picks one by the TPU wrapper's rule,
// _needs_csplit):
// - packed: the categories of a pattern block meet in a thread-block
//   cluster for the per-pattern max over (C, S) and the root's sum, as in
//   K5' at S != 4 (csrc/loop.cu), whose walk (forward_walk,
//   csrc/wide_forward.cuh) and reverse walk (backward_walk,
//   csrc/wide_backward.cuh) they call, at one chain with rootw for the
//   root's weights;
// - category-split: each category is a sweep of its own, as the TPU kernel
//   runs it (once per category at C = 1, the states padded to 8): its own
//   max over S and scalers (scale [C, I, P]), no cluster and no barrier
//   across categories, and per-category site logs
//   log(max(rootw_c . root_c, tiny)) + sum_k log m_k^c [C, P], which the
//   caller combines by a logsumexp over c. The reverse sweep takes the
//   per-category cotangent that autograd gives from that logsumexp and runs
//   each category's reverse step from the forward's partials and scalers;
//   the TPU kernel must recompute the forward (it keeps no partials).
// One launch a sweep each. What bounds them is K5''s and K6''s (the FLOPs
// of the node products; csrc/loop.cu); the per-block dP scratch is
// ceil(P / 128) x N x C x S^2 scalars (52 MB at WAG+G4 64 x 8192 in
// float32).

#include <cuda_runtime.h>

#include "s4_backward.cuh"
#include "s4_forward.cuh"
#include "tiles.cuh"
#include "wide_backward.cuh"
#include "wide_forward.cuh"

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

// ---- any other state count, S from 2 to 64 (the tiles of csrc/tiles.cuh)

// K1' for S != 4: grid (pattern blocks of one step, C). A block walks the
// whole postorder at category c for its patterns (128 at S <= 32, 32
// above), one WideForwardStep a node, then the root (forward_walk,
// csrc/wide_forward.cuh, which K5' at S != 4 shares). Packed: the C blocks
// of a pattern block form one cluster and meet for each node's max over
// (C, S) and for the root's sum over categories; site_log [P]. Category-
// split (csplit): no cluster, each category its own max and scalers
// (scale [C, I, P]) and its own row of site_log [C, P]. Registers as K5''s.
template <typename scalar_t, int A, int CP>
__global__ void __launch_bounds__(THREADS, sizeof(scalar_t) == 4 ? 4 : 2)
    fused_wide_forward_kernel(const scalar_t* __restrict__ tips,
                              const scalar_t* __restrict__ pmats,
                              const int* __restrict__ children,
                              const scalar_t* __restrict__ rootw,
                              scalar_t* partials, scalar_t* __restrict__ scale,
                              scalar_t* __restrict__ site_log, int T, int I,
                              int C, int S, int maxc, int P, int csplit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Step = WideForwardStep<scalar_t, A, CP>;
  const int c = blockIdx.y;
  const Step step(tips, pmats, children, partials,
                  csplit ? scale + (size_t)c * I * P : scale, smem_raw, T, C,
                  S, maxc, P, c, blockIdx.x * Step::TQ, 1, csplit);
  forward_walk(step, I, StateWeights<scalar_t>{rootw, nullptr, S},
               csplit ? site_log + (size_t)c * P : site_log);
}

// K2' for S != 4: grid (pattern blocks of BWD_P, C). A block seeds category
// c at the root and walks the reverse postorder for its 128 patterns, one
// WideBackwardStep a node (backward_walk, csrc/wide_backward.cuh, which K6'
// at S != 4 shares), from the forward's partials and scalers: it never
// recomputes the forward. With csplit, the scalers and the cotangent g are
// category c's (scale [C, I, P], g [C, P]: g times exp(site_c - site_log),
// from the logsumexp outside the kernel). gbuf [I, C, S, P]; dP_part [nb,
// N, C, S, S] (the caller zeroes the root's rows) and drootw_part [nb, C,
// S], which the caller sums over the blocks: no atomics. Registers as K6''s.
template <typename scalar_t, int A, int CP>
__global__ void __launch_bounds__(THREADS,
                                  sizeof(scalar_t) == 4 ? (CP == 4 ? 2 : 3)
                                                        : 1)
    fused_wide_backward_kernel(
        const scalar_t* __restrict__ tips, const scalar_t* __restrict__ pmats,
        const int* __restrict__ children, const scalar_t* __restrict__ rootw,
        const scalar_t* __restrict__ partials,
        const scalar_t* __restrict__ scale, const scalar_t* __restrict__ g,
        scalar_t* gbuf, scalar_t* __restrict__ dP_part,
        scalar_t* __restrict__ drootw_part, int T, int I, int C, int S,
        int maxc, int P, int csplit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.y;
  const int N = T + I;
  backward_walk<scalar_t, A, CP>(
      tips, pmats, children, partials,
      csplit ? scale + (size_t)c * I * P : scale, gbuf,
      dP_part + (size_t)blockIdx.x * N * C * S * S,
      drootw_part + ((size_t)blockIdx.x * C + c) * S,
      StateWeights<scalar_t>{rootw, nullptr, S},
      csplit ? g + (size_t)c * P : g, smem_raw, T, I, C, S, maxc, P, c,
      blockIdx.x * BWD_P, csplit);
}

bool wide_bad_dims(int C, int S, int maxc) {
  return S < 2 || S > MAX_S || C < 1 || C > MAX_C || maxc < 1;
}

template <typename scalar_t, int A, int CP> struct FusedWideForward {
  static cudaError_t run(const void* tips, const void* pmats,
                         const void* children, const void* rootw,
                         void* partials, void* scale, void* site_log, int T,
                         int I, int C, int S, int maxc, int P, int csplit,
                         cudaStream_t stream) {
    using Step = WideForwardStep<scalar_t, A, CP>;
    return launch_clusters(
        fused_wide_forward_kernel<scalar_t, A, CP>,
        dim3((P + Step::TQ - 1) / Step::TQ, C, 1),
        Step::smem_scalars(S) * sizeof(scalar_t), stream, !csplit,
        static_cast<const scalar_t*>(tips),
        static_cast<const scalar_t*>(pmats),
        static_cast<const int*>(children),
        static_cast<const scalar_t*>(rootw), static_cast<scalar_t*>(partials),
        static_cast<scalar_t*>(scale), static_cast<scalar_t*>(site_log), T, I,
        C, S, maxc, P, csplit);
  }
};

template <typename scalar_t, int A, int CP> struct FusedWideBackward {
  static cudaError_t run(const void* tips, const void* pmats,
                         const void* children, const void* rootw,
                         const void* partials, const void* scale,
                         const void* g, void* gbuf, void* dP_part,
                         void* drootw_part, int T, int I, int C, int S,
                         int maxc, int P, int csplit, cudaStream_t stream) {
    const size_t smem =
        WideTiles<scalar_t, A, CP>::smem_scalars(S) * sizeof(scalar_t);
    cudaError_t e = cudaFuncSetAttribute(
        fused_wide_backward_kernel<scalar_t, A, CP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((P + BWD_P - 1) / BWD_P, C, 1);
    fused_wide_backward_kernel<scalar_t, A, CP>
        <<<grid, THREADS, smem, stream>>>(
            static_cast<const scalar_t*>(tips),
            static_cast<const scalar_t*>(pmats),
            static_cast<const int*>(children),
            static_cast<const scalar_t*>(rootw),
            static_cast<const scalar_t*>(partials),
            static_cast<const scalar_t*>(scale),
            static_cast<const scalar_t*>(g), static_cast<scalar_t*>(gbuf),
            static_cast<scalar_t*>(dP_part),
            static_cast<scalar_t*>(drootw_part), T, I, C, S, maxc, P,
            csplit);
    return cudaGetLastError();
  }
};

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

#define PHYSHER_FUSED_WIDE_ENTRY(SUFFIX, TYPE)                                \
  cudaError_t fused_wide_forward_##SUFFIX(                                    \
      const void* tips, const void* pmats, const void* children,              \
      const void* rootw, void* partials, void* scale, void* site_log, int T,  \
      int I, int C, int S, int maxc, int P, int csplit, void* stream) {       \
    if (wide_bad_dims(C, S, maxc)) return cudaErrorInvalidValue;              \
    return with_wide_tiles<TYPE, FusedWideForward>(                           \
        S, tips, pmats, children, rootw, partials, scale, site_log, T, I, C,  \
        S, maxc, P, csplit, static_cast<cudaStream_t>(stream));               \
  }                                                                           \
  cudaError_t fused_wide_backward_##SUFFIX(                                   \
      const void* tips, const void* pmats, const void* children,              \
      const void* rootw, const void* partials, const void* scale,             \
      const void* g, void* gbuf, void* dP_part, void* drootw_part, int T,     \
      int I, int C, int S, int maxc, int P, int csplit, void* stream) {       \
    if (wide_bad_dims(C, S, maxc)) return cudaErrorInvalidValue;              \
    return with_wide_tiles<TYPE, FusedWideBackward>(                          \
        S, tips, pmats, children, rootw, partials, scale, g, gbuf, dP_part,   \
        drootw_part, T, I, C, S, maxc, P, csplit,                             \
        static_cast<cudaStream_t>(stream));                                   \
  }

PHYSHER_FUSED_WIDE_ENTRY(f32, float)
PHYSHER_FUSED_WIDE_ENTRY(f64, double)

#undef PHYSHER_FUSED_WIDE_ENTRY

}  // extern "C"
