// Felsenstein pruning over a batch of chains: the loop kernels, for Hopper
// (sm_90a).
//
// Kernel K5' (loop_forward_*) replaces the TPU kernel
// physher_tpu/ops/pallas_pruning_loop.py _kernel (built by
// build_loop_forward); kernel K6' (loop_backward_*) replaces
// _backward_kernel (build_loop_backward). They compute the loop kernel's
// function: the flat postorder over internal nodes with any number of
// children (-1 pads a missing child, which contributes 1), rescaling by the
// per-node per-pattern max over (C, 4) or none, the root
// log(max(sum_c props_c sum_s freqs_s root[c, s], tiny)) + sum log m, and
// the backward's d pmats, d freqs and d props. They add what the TPU kernel
// got from jax.custom_batching.sequential_vmap: a leading batch axis L of
// chains (MCMC chains, a tempered ladder), which here is a grid axis. The
// TPU kernel's blocks of 4 nodes with a dummy slot N and its scalar
// prefetch served Mosaic's unrolled fori_loop; they are dropped.
//
// Layouts (all contiguous, pattern axis innermost so that neighbouring
// threads touch neighbouring addresses):
//   tips      [T, 4, P]          tip partials, shared by every chain
//   pmats     [L, N, C, 4, 4]    P matrix of the branch above each node
//   children  [I, maxc]          int32 child ids, -1 for a missing child
//   freqs     [L, 4], props [L, C]
//   partials  [L, I, C, 4, P]    (rescaled) partials of internal node rank k
//   scale     [L, I, P]          per-node max m over (C, 4); 1 unrescaled
//   site_log  [L, P]
// Internal node k has id T + k; ids are postorder ranks and the root is
// N - 1.
//
// What bounds them on this card, and what the design does about it: per
// node and pattern a sweep does maxc * C * (32 + 4) FLOPs against about
// (maxc + 1) * C * 16 bytes of partials: about 1 FLOP per byte, far below
// the H100's float32 ridge (~20), and at MCMC sizes (the fluA tree, 238
// patterns, L = 16) the whole sweep is a few MB and a few tens of MFLOPs,
// so neither bound matters: the time is the latency of the chain of
// dependent node steps.
// - K5' at S = 4, redesigned for this card, is the forward step of
//   csrc/s4_forward.cuh, which K1' shares (one chain there): a walk by
//   postorder level, leaves first, in one launch, grid (pattern blocks, L),
//   threads on (pattern, category, state) so that the rescaling max over
//   (C, 4) is a few warp shuffles, every load unconditional and a binary
//   node's tip children copied by cp.async two levels ahead; the header
//   says how.
// - K6' at S = 4, redesigned for this card, is the reverse step of
//   csrc/s4_backward.cuh, which K2' shares (one chain there): a walk that
//   carries only the cotangents by preorder level (one barrier a level,
//   threads on (pattern, state), grid (pattern blocks, C, L)), then a pass
//   that sums every branch's d pmats at once and turns d rootw into
//   d freqs and d props; the header says how.
//
// K5' writes each node's partials and scale to device memory, and K6'
// reads them instead of recomputing the forward as the TPU kernel must
// (it keeps everything in VMEM and writes no partials). On the card they
// are the walk's hand-off from one level to the next anyway, so keeping
// them costs nothing extra in K5' and saves K6' the forward's arithmetic.
// Their size is L * I * (C * 4 + 1) * P scalars: 16.6 MB at fluA with
// L = 16, C = 4 in float32.
//
// K6' sums d pmats and d rootw (at S = 4 d freqs and d props) over the
// patterns of a block in a fixed order into per-(chain, block) partial sums
// that the caller sums over the block axis: no atomics, so results are
// deterministic.
//
// Any other state count, S from 2 to 64 (protein S = 20, codon S = 61):
// loop_wide_forward_kernel (K5') and loop_wide_backward_kernel (K6'), the
// same function with the layouts above at S in place of 4. The S = 4 walks
// give each of a pattern's C x 4 partials a lane and trade a child's four
// states by quad shuffles; at S = 61 each child costs an
// [S, S] @ [S, patterns] product: 2 S^2 FLOPs per pattern against S
// partials read, 2 S FLOP per element, about 30 FLOP per byte at S = 61 in
// float32 (the H100's float32 ridge is ~20). At the slice's shapes the
// FLOPs bound them: GY94 on 32 taxa x 4096 codons, C = 1, L = 8 chains is
// about 15 GFLOP a forward sweep (0.23 ms at 67 TFLOP/s), WAG+G4 on 64 taxa
// x 8192 patterns, L = 4 about 13 GFLOP (bounds of 0.23 and 0.21 ms).
//
// K5' at S != 4, redesigned for this card. The first design, one block per
// (32-pattern tile, chain) walking every node x category x child in turn
// through K7''s first tiles (P read as one scalar load per FMA, eight rows a
// thread at every S), ran at 23-25x that bound. The design now:
// - Categories on the grid: (pattern blocks of one step, C, L), launched
//   as thread-block clusters (1, C, 1), 1024 blocks at both shapes above.
//   A block walks the whole postorder of one chain at one category, one
//   launch per sweep; a node's category-c partials need only its
//   children's, which the same block wrote (a barrier orders them). The
//   per-pattern max over (C, S) that the rescaling needs meets across the
//   cluster through distributed shared memory, one cluster barrier a node
//   (none at C = 1); the root's sum over categories too, in a fixed order.
// - Each node is one step of csrc/wide_forward.cuh, which K7' shares: each
//   child staged once by cp.async, tiles and thread work shaped to S (the
//   header says how).
//
// K6' at S != 4, redesigned for this card. What bounds it: per branch,
// category and pattern 6 S^2 FLOPs above an internal node and 4 S^2 above
// a tip (no cotangent) against a few S scalars read, so the FLOPs bound the
// function (0.50 ms at WAG+G4 64 x 8192, C = 4, L = 4; 0.56 ms at GY94
// 32 x 4096, L = 8). The first design, one block per (128 patterns, chain)
// walking every node x category x child x 32-pattern tile in sequence,
// tiles laid out for S = 64 at every S and each sibling's P restaged per
// tile, waited on latency at 43x that bound. The design now:
// - Categories on the grid: (pattern blocks of 128, C, L). A category's
//   backward needs nothing of the others, so each block walks 1/C of the
//   former steps and there are C times as many blocks (1024 at WAG+G4
//   L = 4). Each block recomputes the root's site over all categories for
//   its seed. The dP scratch keeps its size, L x ceil(P / 128) x N x C x
//   S^2 (208 MB at WAG+G4 L = 4, 240 MB at GY94 L = 8 in float32).
// - Each node is one step of csrc/wide_backward.cuh, which K8' shares: each
//   child staged once per node, tiles and thread work shaped to S, staging
//   by cp.async (the header says how).
// - Registers: in float32 the launch bounds trade spills for resident
//   blocks (chip_profile.py --k6-bounds measures the choice).

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
                           const void* offsets, const void* freqs,
                           const void* props, void* partials, void* scale,
                           void* site_log, int n_levels, int T, int I, int C,
                           int maxc, int P, int L, int rescale,
                           cudaStream_t stream) {
  return launch_s4_forward<scalar_t>(
      static_cast<const scalar_t*>(tips), static_cast<const scalar_t*>(pmats),
      static_cast<const int*>(children), static_cast<const int*>(order),
      static_cast<const int*>(offsets), n_levels,
      FreqsProps<scalar_t>{static_cast<const scalar_t*>(freqs),
                           static_cast<const scalar_t*>(props), nullptr,
                           nullptr},
      static_cast<scalar_t*>(partials), static_cast<scalar_t*>(scale),
      static_cast<scalar_t*>(site_log), T, I, C, maxc, P, L, rescale,
      stream);
}

template <typename scalar_t>
cudaError_t launch_backward(const void* tips, const void* pmats,
                            const void* children, const void* order,
                            const void* offsets, const void* freqs,
                            const void* props, const void* partials,
                            const void* scale, const void* g, void* gbuf,
                            void* inv, void* dP_part, void* dfreqs_part,
                            void* dprops_part, int n_levels, int T, int I,
                            int C, int maxc, int P, int L, int dp_chunk,
                            cudaStream_t stream) {
  return launch_s4_backward<scalar_t>(
      static_cast<const scalar_t*>(tips), static_cast<const scalar_t*>(pmats),
      static_cast<const int*>(children), static_cast<const int*>(order),
      static_cast<const int*>(offsets), n_levels,
      FreqsProps<scalar_t>{static_cast<const scalar_t*>(freqs),
                           static_cast<const scalar_t*>(props),
                           static_cast<scalar_t*>(dfreqs_part),
                           static_cast<scalar_t*>(dprops_part)},
      static_cast<const scalar_t*>(partials),
      static_cast<const scalar_t*>(scale), static_cast<const scalar_t*>(g),
      static_cast<scalar_t*>(gbuf), static_cast<scalar_t*>(inv),
      static_cast<scalar_t*>(dP_part), T, I, C, maxc, P, L, dp_chunk,
      stream);
}

// ---- any state count, S from 2 to 64 (the tiles of csrc/tiles.cuh) -------

// K5' for S from 2 to 64: grid (pattern blocks of one step, C, L), as
// clusters (1, C, 1). A block walks the postorder of chain l at category c
// for its patterns (128 at S <= 32, 32 above), one WideForwardStep a node
// (forward_walk, csrc/wide_forward.cuh; K1' at S != 4 shares the step); the C
// blocks of a cluster meet for each node's per-pattern max and for the
// root.
// Registers: float32 at four blocks an SM (64 registers, up to 32 B
// spilled), float64 at two; at three or two blocks an SM float32 spills
// less and runs 3-25 % slower (chip_profile.py --k5-bounds).
template <typename scalar_t, int A, int CP>
__global__ void __launch_bounds__(THREADS, sizeof(scalar_t) == 4 ? 4 : 2)
    loop_wide_forward_kernel(const scalar_t* __restrict__ tips,
                             const scalar_t* __restrict__ pmats,
                             const int* __restrict__ children,
                             const scalar_t* __restrict__ freqs,
                             const scalar_t* __restrict__ props,
                             scalar_t* partials, scalar_t* __restrict__ scale,
                             scalar_t* __restrict__ site_log, int T, int I,
                             int C, int S, int maxc, int P, int rescale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Step = WideForwardStep<scalar_t, A, CP>;
  const int c = blockIdx.y, l = blockIdx.z;
  const int N = T + I;
  const Step step(tips, pmats + (size_t)l * N * C * S * S, children,
                  partials + (size_t)l * I * C * S * P,
                  scale + (size_t)l * I * P, smem_raw, T, C, S, maxc, P, c,
                  blockIdx.x * Step::TQ, rescale);
  forward_walk(step, I,
               StateWeights<scalar_t>{freqs + (size_t)l * S,
                                      props + (size_t)l * C, 0},
               site_log + (size_t)l * P);
}

// K6' for S from 2 to 64: grid (pattern blocks of BWD_P, C, L), 256 threads.
// A block seeds category c at the root and walks the reverse postorder of
// chain l for its 128 patterns, one WideBackwardStep a node
// (backward_walk, csrc/wide_backward.cuh; K2' at S != 4 shares the step).
// gbuf [L, I, C, S, P]; dP_part [L, nb, N, C, S, S] (the caller zeroes the
// root's rows); drootw_part [L, nb, C, S].

// Registers: float32 at two blocks an SM (128 registers) where a step takes
// the block's four tiles, at three (80 registers, with spills) where it
// takes one; float64, whose tiles take up to 200 KB, at one. Measured
// against the other budgets by `chip_profile.py --k6-bounds`.
template <typename scalar_t, int A, int CP>
__global__ void __launch_bounds__(THREADS,
                                  sizeof(scalar_t) == 4 ? (CP == 4 ? 2 : 3)
                                                        : 1)
    loop_wide_backward_kernel(
        const scalar_t* __restrict__ tips, const scalar_t* __restrict__ pmats,
        const int* __restrict__ children, const scalar_t* __restrict__ freqs,
        const scalar_t* __restrict__ props,
        const scalar_t* __restrict__ partials,
        const scalar_t* __restrict__ scale, const scalar_t* __restrict__ g,
        scalar_t* gbuf, scalar_t* __restrict__ dP_part,
        scalar_t* __restrict__ drootw_part, int T, int I, int C, int S,
        int maxc, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.y, l = blockIdx.z;
  const int N = T + I;
  const size_t blk = (size_t)l * gridDim.x + blockIdx.x;
  backward_walk<scalar_t, A, CP>(
      tips, pmats + (size_t)l * N * C * S * S, children,
      partials + (size_t)l * I * C * S * P, scale + (size_t)l * I * P,
      gbuf + (size_t)l * I * C * S * P, dP_part + blk * N * C * S * S,
      drootw_part + (blk * C + c) * S,
      StateWeights<scalar_t>{freqs + (size_t)l * S, props + (size_t)l * C,
                             0},
      g + (size_t)l * P, smem_raw, T, I, C, S, maxc, P, c,
      blockIdx.x * BWD_P, 0);
}

bool wide_bad_dims(int C, int S, int maxc, int L) {
  return S < 2 || S > MAX_S || C < 1 || C > MAX_C || maxc < 1 || L < 1 ||
         L > 65535;
}

template <typename scalar_t, int A, int CP> struct LoopWideForward {
  static size_t smem(int S) {
    return WideForwardStep<scalar_t, A, CP>::smem_scalars(S) *
           sizeof(scalar_t);
  }
  static cudaError_t run(const void* tips, const void* pmats,
                         const void* children, const void* freqs,
                         const void* props, void* partials, void* scale,
                         void* site_log, int T, int I, int C, int S, int maxc,
                         int P, int L, int rescale, cudaStream_t stream) {
    constexpr int TQ = WideForwardStep<scalar_t, A, CP>::TQ;
    return launch_clusters(
        loop_wide_forward_kernel<scalar_t, A, CP>,
        dim3((P + TQ - 1) / TQ, C, L), smem(S), stream, true,
        static_cast<const scalar_t*>(tips),
        static_cast<const scalar_t*>(pmats),
        static_cast<const int*>(children),
        static_cast<const scalar_t*>(freqs),
        static_cast<const scalar_t*>(props), static_cast<scalar_t*>(partials),
        static_cast<scalar_t*>(scale), static_cast<scalar_t*>(site_log), T, I,
        C, S, maxc, P, rescale);
  }
};

template <typename scalar_t>
cudaError_t launch_wide_forward(const void* tips, const void* pmats,
                                const void* children, const void* freqs,
                                const void* props, void* partials, void* scale,
                                void* site_log, int T, int I, int C, int S,
                                int maxc, int P, int L, int rescale,
                                cudaStream_t stream) {
  if (wide_bad_dims(C, S, maxc, L)) return cudaErrorInvalidValue;
  return with_wide_tiles<scalar_t, LoopWideForward>(
      S, tips, pmats, children, freqs, props, partials, scale, site_log, T, I,
      C, S, maxc, P, L, rescale, stream);
}

// The most clusters of K5' at (S, C) resident at once
template <typename scalar_t, int A, int CP> struct LoopWideForwardClusters {
  static cudaError_t run(int S, int C, int* clusters) {
    return cluster_occupancy(loop_wide_forward_kernel<scalar_t, A, CP>, C,
                             LoopWideForward<scalar_t, A, CP>::smem(S),
                             clusters);
  }
};

template <typename scalar_t, int A, int CP> struct LoopWideBackward {
  static cudaError_t run(const void* tips, const void* pmats,
                         const void* children, const void* freqs,
                         const void* props, const void* partials,
                         const void* scale, const void* g, void* gbuf,
                         void* dP_part, void* drootw_part, int T, int I, int C,
                         int S, int maxc, int P, int L, cudaStream_t stream) {
    const size_t smem =
        WideTiles<scalar_t, A, CP>::smem_scalars(S) * sizeof(scalar_t);
    cudaError_t e = cudaFuncSetAttribute(
        loop_wide_backward_kernel<scalar_t, A, CP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((P + BWD_P - 1) / BWD_P, C, L);
    loop_wide_backward_kernel<scalar_t, A, CP><<<grid, THREADS, smem, stream>>>(
        static_cast<const scalar_t*>(tips),
        static_cast<const scalar_t*>(pmats),
        static_cast<const int*>(children),
        static_cast<const scalar_t*>(freqs),
        static_cast<const scalar_t*>(props),
        static_cast<const scalar_t*>(partials),
        static_cast<const scalar_t*>(scale), static_cast<const scalar_t*>(g),
        static_cast<scalar_t*>(gbuf), static_cast<scalar_t*>(dP_part),
        static_cast<scalar_t*>(drootw_part), T, I, C, S, maxc, P);
    return cudaGetLastError();
  }
};

template <typename scalar_t>
cudaError_t launch_wide_backward(const void* tips, const void* pmats,
                                 const void* children, const void* freqs,
                                 const void* props, const void* partials,
                                 const void* scale, const void* g, void* gbuf,
                                 void* dP_part, void* drootw_part, int T,
                                 int I, int C, int S, int maxc, int P, int L,
                                 cudaStream_t stream) {
  if (wide_bad_dims(C, S, maxc, L)) return cudaErrorInvalidValue;
  return with_wide_tiles<scalar_t, LoopWideBackward>(
      S, tips, pmats, children, freqs, props, partials, scale, g, gbuf,
      dP_part, drootw_part, T, I, C, S, maxc, P, L, stream);
}

}  // namespace

extern "C" {

#define PHYSHER_LOOP_FORWARD_ENTRY(SUFFIX, TYPE)                              \
  cudaError_t loop_forward_##SUFFIX(                                          \
      const void* tips, const void* pmats, const void* children,              \
      const void* order, const void* offsets, const void* freqs,              \
      const void* props, void* partials, void* scale, void* site_log,         \
      int n_levels, int T, int I, int C, int maxc, int P, int L, int rescale, \
      void* stream) {                                                         \
    return launch_forward<TYPE>(tips, pmats, children, order, offsets, freqs, \
                                props, partials, scale, site_log, n_levels,   \
                                T, I, C, maxc, P, L, rescale,                 \
                                static_cast<cudaStream_t>(stream));           \
  }

PHYSHER_LOOP_FORWARD_ENTRY(f32, float)
PHYSHER_LOOP_FORWARD_ENTRY(f64, double)

#undef PHYSHER_LOOP_FORWARD_ENTRY

#define PHYSHER_LOOP_BACKWARD_ENTRY(SUFFIX, TYPE)                             \
  cudaError_t loop_backward_##SUFFIX(                                         \
      const void* tips, const void* pmats, const void* children,              \
      const void* order, const void* offsets, const void* freqs,              \
      const void* props, const void* partials, const void* scale,             \
      const void* g, void* gbuf, void* inv, void* dP_part, void* dfreqs_part, \
      void* dprops_part, int n_levels, int T, int I, int C, int maxc, int P,  \
      int L, int dp_chunk, void* stream) {                                    \
    return launch_backward<TYPE>(tips, pmats, children, order, offsets,       \
                                 freqs, props, partials, scale, g, gbuf, inv, \
                                 dP_part, dfreqs_part, dprops_part, n_levels, \
                                 T, I, C, maxc, P, L, dp_chunk,               \
                                 static_cast<cudaStream_t>(stream));          \
  }

PHYSHER_LOOP_BACKWARD_ENTRY(f32, float)
PHYSHER_LOOP_BACKWARD_ENTRY(f64, double)

#undef PHYSHER_LOOP_BACKWARD_ENTRY

#define PHYSHER_LOOP_WIDE_ENTRY(SUFFIX, TYPE)                                 \
  cudaError_t loop_wide_forward_##SUFFIX(                                     \
      const void* tips, const void* pmats, const void* children,              \
      const void* freqs, const void* props, void* partials, void* scale,      \
      void* site_log, int T, int I, int C, int S, int maxc, int P, int L,     \
      int rescale, void* stream) {                                            \
    return launch_wide_forward<TYPE>(tips, pmats, children, freqs, props,     \
                                     partials, scale, site_log, T, I, C, S,   \
                                     maxc, P, L, rescale,                     \
                                     static_cast<cudaStream_t>(stream));      \
  }                                                                           \
  cudaError_t loop_wide_backward_##SUFFIX(                                    \
      const void* tips, const void* pmats, const void* children,              \
      const void* freqs, const void* props, const void* partials,             \
      const void* scale, const void* g, void* gbuf, void* dP_part,            \
      void* drootw_part, int T, int I, int C, int S, int maxc, int P, int L,  \
      void* stream) {                                                         \
    return launch_wide_backward<TYPE>(tips, pmats, children, freqs, props,    \
                                      partials, scale, g, gbuf, dP_part,      \
                                      drootw_part, T, I, C, S, maxc, P, L,    \
                                      static_cast<cudaStream_t>(stream));     \
  }                                                                           \
  cudaError_t loop_wide_forward_clusters_##SUFFIX(int S, int C,               \
                                                  int* clusters) {            \
    if (C < 1 || C > MAX_C) return cudaErrorInvalidValue;                     \
    return with_wide_tiles<TYPE, LoopWideForwardClusters>(S, S, C, clusters); \
  }

PHYSHER_LOOP_WIDE_ENTRY(f32, float)
PHYSHER_LOOP_WIDE_ENTRY(f64, double)

#undef PHYSHER_LOOP_WIDE_ENTRY

}  // extern "C"
