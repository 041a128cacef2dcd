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
// What bounds them on this card, and what the design does about it: one
// thread per (pattern, chain), grid (pattern blocks, L), walks the internal
// nodes in postorder rank with the C x 4 partials in registers. Per node
// and pattern a thread does maxc * C * (32 + 4) FLOPs against about
// (maxc + 1) * C * 16 bytes of partials: about 1 FLOP per byte, far below
// the H100's float32 ridge (~20), and at MCMC sizes (the fluA tree, 238
// patterns, L = 16) the whole sweep is a few MB and a few tens of MFLOPs,
// so neither bound matters: the time is the latency of each thread's chain
// of I dependent node steps. The design answers with parallel width: blocks
// of 32 patterns (one warp), so that L x blocks covers the 132 SMs (fluA at
// L = 16: 8 x 16 = 128 blocks), instead of the 128-pattern blocks of K1'.
//
// K5' writes each node's partials and scale to device memory, and K6'
// reads them instead of recomputing the forward as the TPU kernel must
// (it keeps everything in VMEM and writes no partials). On the card they
// are written anyway as the walk's working set (a thread reads its
// children's partials back, mostly from L1/L2), so keeping them costs
// nothing extra in K5' and saves K6' the forward's arithmetic. Their size
// is L * I * (C * 4 + 1) * P scalars: 16.6 MB at fluA with L = 16, C = 4 in
// float32.
//
// K6' reduces d pmats, d freqs and d props over the patterns of a block
// (warp shuffles, then shared memory across the block's warps) into per-
// (chain, block) partial sums that the caller sums over the block axis: no
// atomics, so results are deterministic.
//
// Any other state count, S from 2 to 64 (protein S = 20, codon S = 61):
// loop_wide_forward_kernel (K5') and loop_wide_backward_kernel (K6'), the
// same function with the layouts above at S in place of 4. The S = 4 kernels
// keep each pattern's C x 4 partials in one thread's registers; at S = 61 a
// node's C x S partials do not fit one thread, and each child costs an
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

#include "tiles.cuh"
#include "wide_backward.cuh"
#include "wide_forward.cuh"

namespace {

// The 4 partials of child `ch` in category c at pattern p. `part` is this
// chain's partials, written earlier in the same launch by the same thread:
// plain loads, not the read-only path.
template <typename scalar_t>
__device__ inline void load_child(const scalar_t* tips, const scalar_t* part,
                                  int ch, int c, int T, int C, int P, int p,
                                  scalar_t x[4]) {
  if (ch < T) {
#pragma unroll
    for (int b = 0; b < 4; ++b) x[b] = tips[((size_t)ch * 4 + b) * P + p];
  } else {
    const size_t base = ((size_t)(ch - T) * C + c) * 4;
#pragma unroll
    for (int b = 0; b < 4; ++b) x[b] = part[(base + b) * P + p];
  }
}

// out[a] = sum_b P[ch, c, a, b] * x[b], with `pm` this chain's P matrices
template <typename scalar_t>
__device__ inline void apply_p(const scalar_t* __restrict__ pm, int ch, int c,
                               int C, const scalar_t x[4], scalar_t out[4]) {
  const scalar_t* q = pm + ((size_t)ch * C + c) * 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    scalar_t s = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) s += __ldg(q + a * 4 + b) * x[b];
    out[a] = s;
  }
}

template <typename scalar_t, int C>
__global__ void loop_forward_kernel(const scalar_t* __restrict__ tips,
                                    const scalar_t* __restrict__ pmats,
                                    const int* __restrict__ children,
                                    const scalar_t* __restrict__ freqs,
                                    const scalar_t* __restrict__ props,
                                    scalar_t* partials,
                                    scalar_t* __restrict__ scale,
                                    scalar_t* __restrict__ site_log, int T,
                                    int I, int maxc, int P, int rescale) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (p >= P) return;
  const int N = T + I;
  const scalar_t* pm = pmats + (size_t)l * N * C * 16;
  scalar_t* part = partials + (size_t)l * I * C * 4 * P;
  scalar_t* sc = scale + (size_t)l * I * P;
  const scalar_t tiny = Limits<scalar_t>::tiny();
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
        load_child(tips, part, ch, c, T, C, P, p, x);
        apply_p(pm, ch, c, C, x, contrib);
#pragma unroll
        for (int a = 0; a < 4; ++a) res[c][a] *= contrib[a];
      }
    }
    scalar_t m = 1;
    if (rescale) {
      m = tiny;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int a = 0; a < 4; ++a) m = res[c][a] > m ? res[c][a] : m;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int a = 0; a < 4; ++a) res[c][a] = res[c][a] / m;
      log_sum += log_(m);
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        part[(((size_t)k * C + c) * 4 + a) * P + p] = res[c][a];
    sc[(size_t)k * P + p] = m;
  }
  // res holds the root (rank I - 1)
  scalar_t site = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    scalar_t per_cat = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      per_cat += __ldg(freqs + (size_t)l * 4 + a) * res[c][a];
    site += __ldg(props + (size_t)l * C + c) * per_cat;
  }
  site = site > tiny ? site : tiny;
  site_log[(size_t)l * P + p] = log_(site) + log_sum;
}

template <typename scalar_t>
__device__ inline scalar_t warp_sum(scalar_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// smem: [n_warps, max(maxc * C * 16, 4 + C)] per-warp sums.
// dP_part [L, nb, N, C, 16]; dfreqs_part [L, nb, 4]; dprops_part [L, nb, C];
// gbuf [L, I, C, 4, P] cotangents of the (rescaled) partials.
template <typename scalar_t>
__global__ void loop_backward_kernel(
    const scalar_t* __restrict__ tips, const scalar_t* __restrict__ pmats,
    const int* __restrict__ children, const scalar_t* __restrict__ freqs,
    const scalar_t* __restrict__ props, const scalar_t* __restrict__ partials,
    const scalar_t* __restrict__ scale, const scalar_t* __restrict__ g,
    scalar_t* gbuf, scalar_t* __restrict__ dP_part,
    scalar_t* __restrict__ dfreqs_part, scalar_t* __restrict__ dprops_part,
    int T, int I, int C, int maxc, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* smem = reinterpret_cast<scalar_t*>(smem_raw);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  const int nb = gridDim.x;
  // threads past P take part in every shuffle and barrier with zeros
  const bool valid = p < P;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int N = T + I;
  const int width = maxc * C * 16;
  const scalar_t* pm = pmats + (size_t)l * N * C * 16;
  const scalar_t* part = partials + (size_t)l * I * C * 4 * P;
  const scalar_t* sc = scale + (size_t)l * I * P;
  scalar_t* gb = gbuf + (size_t)l * I * C * 4 * P;
  const size_t blk = (size_t)l * nb + blockIdx.x;
  scalar_t* dP = dP_part + blk * N * C * 16;
  const scalar_t* fr = freqs + (size_t)l * 4;
  const scalar_t* pr = props + (size_t)l * C;

  // ---- root seed: site in scaled coordinates, as the forward computed it
  {
    const int root = I - 1;
    scalar_t site = 0;
    for (int c = 0; c < C; ++c) {
      scalar_t per_cat = 0;
      for (int a = 0; a < 4; ++a)
        per_cat += valid ? __ldg(fr + a) *
                               part[(((size_t)root * C + c) * 4 + a) * P + p]
                         : scalar_t(0);
      site += __ldg(pr + c) * per_cat;
    }
    const scalar_t tiny = Limits<scalar_t>::tiny();
    site = site > tiny ? site : tiny;
    const scalar_t inv = valid ? g[(size_t)l * P + p] / site : scalar_t(0);
    scalar_t dfr[4] = {0, 0, 0, 0};
    for (int c = 0; c < C; ++c) {
      scalar_t per_cat = 0;
      for (int a = 0; a < 4; ++a) {
        const size_t idx = (((size_t)root * C + c) * 4 + a) * P + p;
        const scalar_t x = valid ? part[idx] : scalar_t(0);
        if (valid) gb[idx] = __ldg(pr + c) * __ldg(fr + a) * inv;
        dfr[a] += __ldg(pr + c) * x * inv;
        per_cat += __ldg(fr + a) * x;
      }
      const scalar_t s = warp_sum(per_cat * inv);
      if (lane == 0) smem[n_warps * 4 + warp * C + c] = s;
    }
    for (int a = 0; a < 4; ++a) {
      const scalar_t s = warp_sum(dfr[a]);
      if (lane == 0) smem[warp * 4 + a] = s;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < 4 + C; t += blockDim.x) {
      scalar_t s = 0;
      if (t < 4) {
        for (int w = 0; w < n_warps; ++w) s += smem[w * 4 + t];
        dfreqs_part[blk * 4 + t] = s;
      } else {
        for (int w = 0; w < n_warps; ++w)
          s += smem[n_warps * 4 + w * C + (t - 4)];
        dprops_part[blk * C + (t - 4)] = s;
      }
    }
    __syncthreads();
  }

  // ---- reverse postorder
  for (int k = I - 1; k >= 0; --k) {
    const scalar_t m = valid ? sc[(size_t)k * P + p] : scalar_t(1);
    for (int c = 0; c < C; ++c) {
      // cotangent of the raw (pre-rescale) product; the max is a constant
      scalar_t graw[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        graw[a] = valid ? gb[(((size_t)k * C + c) * 4 + a) * P + p] / m
                        : scalar_t(0);
      for (int i = 0; i < maxc; ++i) {
        const int ch = __ldg(children + k * maxc + i);
        if (ch < 0) continue;
        // other_i = graw * prod_{j != i} contrib_j
        scalar_t other[4] = {graw[0], graw[1], graw[2], graw[3]};
        for (int j = 0; j < maxc; ++j) {
          const int cj = __ldg(children + k * maxc + j);
          if (j == i || cj < 0) continue;
          scalar_t xj[4] = {0, 0, 0, 0}, cb[4];
          if (valid) load_child(tips, part, cj, c, T, C, P, p, xj);
          apply_p(pm, cj, c, C, xj, cb);
#pragma unroll
          for (int a = 0; a < 4; ++a) other[a] *= cb[a];
        }
        scalar_t x[4] = {0, 0, 0, 0};
        if (valid) load_child(tips, part, ch, c, T, C, P, p, x);
        // dP[ch, c, a, b] += other[a] * x[b], reduced over the warp
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const scalar_t s = warp_sum(other[a] * x[b]);
            if (lane == 0)
              smem[warp * width + (i * C + c) * 16 + a * 4 + b] = s;
          }
        // the child's cotangent: sum_a P[ch, c, a, b] * other[a]
        if (valid && ch >= T) {
          const scalar_t* q = pm + ((size_t)ch * C + c) * 16;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            scalar_t s = 0;
#pragma unroll
            for (int a = 0; a < 4; ++a) s += __ldg(q + a * 4 + b) * other[a];
            gb[((((size_t)(ch - T)) * C + c) * 4 + b) * P + p] = s;
          }
        }
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < width; t += blockDim.x) {
      const int i = t / (C * 16);
      const int ch = __ldg(children + k * maxc + i);
      if (ch < 0) continue;  // no d pmats row for a missing child
      scalar_t s = 0;
      for (int w = 0; w < n_warps; ++w) s += smem[w * width + t];
      dP[(size_t)ch * C * 16 + (t - i * C * 16)] = s;
    }
    __syncthreads();
  }
}

template <typename scalar_t>
cudaError_t launch_forward(const void* tips, const void* pmats,
                           const void* children, const void* freqs,
                           const void* props, void* partials, void* scale,
                           void* site_log, int T, int I, int C, int maxc,
                           int P, int L, int rescale, int threads,
                           cudaStream_t stream) {
  if (threads % 32 != 0 || L < 1 || L > 65535) return cudaErrorInvalidValue;
  const dim3 grid((P + threads - 1) / threads, L);
  const auto* t_ = static_cast<const scalar_t*>(tips);
  const auto* pm_ = static_cast<const scalar_t*>(pmats);
  const auto* ch_ = static_cast<const int*>(children);
  const auto* fr_ = static_cast<const scalar_t*>(freqs);
  const auto* pr_ = static_cast<const scalar_t*>(props);
  auto* pa_ = static_cast<scalar_t*>(partials);
  auto* sc_ = static_cast<scalar_t*>(scale);
  auto* sl_ = static_cast<scalar_t*>(site_log);
#define PHYSHER_LOOP_FWD_CASE(CC)                                             \
  case CC:                                                                    \
    loop_forward_kernel<scalar_t, CC><<<grid, threads, 0, stream>>>(         \
        t_, pm_, ch_, fr_, pr_, pa_, sc_, sl_, T, I, maxc, P, rescale);       \
    break;
  switch (C) {
    PHYSHER_LOOP_FWD_CASE(1)
    PHYSHER_LOOP_FWD_CASE(2)
    PHYSHER_LOOP_FWD_CASE(3)
    PHYSHER_LOOP_FWD_CASE(4)
    PHYSHER_LOOP_FWD_CASE(5)
    PHYSHER_LOOP_FWD_CASE(6)
    PHYSHER_LOOP_FWD_CASE(7)
    PHYSHER_LOOP_FWD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PHYSHER_LOOP_FWD_CASE
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t launch_backward(const void* tips, const void* pmats,
                            const void* children, const void* freqs,
                            const void* props, const void* partials,
                            const void* scale, const void* g, void* gbuf,
                            void* dP_part, void* dfreqs_part,
                            void* dprops_part, int T, int I, int C, int maxc,
                            int P, int L, int threads, cudaStream_t stream) {
  if (threads % 32 != 0 || C < 1 || C > 8 || L < 1 || L > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((P + threads - 1) / threads, L);
  const int width = maxc * C * 16 > 4 + C ? maxc * C * 16 : 4 + C;
  const size_t smem = (size_t)(threads / 32) * width * sizeof(scalar_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        loop_backward_kernel<scalar_t>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  loop_backward_kernel<scalar_t><<<grid, threads, smem, stream>>>(
      static_cast<const scalar_t*>(tips), static_cast<const scalar_t*>(pmats),
      static_cast<const int*>(children), static_cast<const scalar_t*>(freqs),
      static_cast<const scalar_t*>(props),
      static_cast<const scalar_t*>(partials),
      static_cast<const scalar_t*>(scale), static_cast<const scalar_t*>(g),
      static_cast<scalar_t*>(gbuf), static_cast<scalar_t*>(dP_part),
      static_cast<scalar_t*>(dfreqs_part), static_cast<scalar_t*>(dprops_part),
      T, I, C, maxc, P);
  return cudaGetLastError();
}

// ---- any state count, S from 2 to 64 (the tiles of csrc/tiles.cuh) -------

// K5' for S from 2 to 64: grid (pattern blocks of one step, C, L), as
// clusters (1, C, 1). A block walks the postorder of chain l at category c
// for its patterns (128 at S <= 32, 32 above), one WideForwardStep a node
// (csrc/wide_forward.cuh); the C blocks of a cluster meet for each node's
// per-pattern max and for the root.
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
  scalar_t x[A], log_sum = 0;
  for (int k = 0; k < I; ++k) log_sum += step.node(k, k & 1, x);
  step.root(freqs + (size_t)l * S, props + (size_t)l * C, x, log_sum,
            site_log + (size_t)l * P);
}

// K6' for S from 2 to 64: grid (pattern blocks of BWD_P, C, L), 256 threads.
// A block walks the reverse postorder of chain l at category c for its 128
// patterns, one WideBackwardStep a node (csrc/wide_backward.cuh).
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
  const auto sm = WideSmem<scalar_t>::template at<A, CP>(smem_raw, S);
  const int c = blockIdx.y, l = blockIdx.z;
  const int nb = gridDim.x;
  const int N = T + I;
  const int CS = C * S, SS = S * S;
  const scalar_t* pm = pmats + (size_t)l * N * C * SS;
  const scalar_t* part = partials + (size_t)l * I * CS * P;
  const scalar_t* sc = scale + (size_t)l * I * P;
  scalar_t* gb = gbuf + (size_t)l * I * CS * P;
  const size_t blk = (size_t)l * nb + blockIdx.x;
  scalar_t* dP = dP_part + blk * N * C * SS;
  const scalar_t* fr = freqs + (size_t)l * S;
  const scalar_t* pr = props + (size_t)l * C;
  const int pb = blockIdx.x * BWD_P;

  // ---- root seed of category c: gbuf[root, c] = props_c freqs g / site and
  // d rootw[c] summed over the block's patterns; site (over every category,
  // in scaled coordinates as the forward had it) is recomputed by each of
  // the C blocks of a pattern block
  scalar_t* inv_s = sm.Os;  // [BWD_P], free until the first node
  const size_t root = (size_t)(I - 1) * CS * P;
  const scalar_t tiny = Limits<scalar_t>::tiny();
  for (int r = threadIdx.x; r < BWD_P; r += blockDim.x) {
    const int p = pb + r;
    scalar_t inv = 0;
    if (p < P) {
      scalar_t site = 0;
      for (int cc = 0; cc < C; ++cc) {
        scalar_t per_cat = 0;
        for (int s = 0; s < S; ++s)
          per_cat += __ldg(fr + s) * part[root + ((size_t)cc * S + s) * P + p];
        site += __ldg(pr + cc) * per_cat;
      }
      site = site > tiny ? site : tiny;
      inv = g[(size_t)l * P + p] / site;
    }
    inv_s[r] = inv;
  }
  __syncthreads();
  const size_t root_c = root + (size_t)c * S * P;
  for (int t = threadIdx.x; t < S * BWD_P; t += blockDim.x) {
    const int s = t / BWD_P, r = t - s * BWD_P, p = pb + r;
    if (p < P)
      gb[root_c + (size_t)s * P + p] = __ldg(pr + c) * __ldg(fr + s) * inv_s[r];
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    scalar_t acc = 0;
    for (int r = 0; r < BWD_P && pb + r < P; ++r)
      acc += part[root_c + (size_t)s * P + pb + r] * inv_s[r];
    drootw_part[(blk * C + c) * S + s] = acc;
  }
  __syncthreads();  // inv_s is read
  zero_spare_o_rows<scalar_t, A, CP>(sm.Os);
  // ---- reverse postorder, category c
  const WideBackwardStep<scalar_t, A, CP> step(tips, pm, children, part, sc,
                                               gb, dP, sm, T, C, S, maxc, P,
                                               c, pb, min(pb + BWD_P, P));
  if (maxc <= 2) {
    for (int k = I - 1; k >= 0; --k) step.pair(k);
    return;
  }
  for (int k = I - 1; k >= 0; --k) step.polytomy(k);
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
        dim3((P + TQ - 1) / TQ, C, L), smem(S), stream,
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

cudaError_t loop_forward_f32(const void* tips, const void* pmats,
                             const void* children, const void* freqs,
                             const void* props, void* partials, void* scale,
                             void* site_log, int T, int I, int C, int maxc,
                             int P, int L, int rescale, int threads,
                             void* stream) {
  return launch_forward<float>(tips, pmats, children, freqs, props, partials,
                               scale, site_log, T, I, C, maxc, P, L, rescale,
                               threads, static_cast<cudaStream_t>(stream));
}

cudaError_t loop_forward_f64(const void* tips, const void* pmats,
                             const void* children, const void* freqs,
                             const void* props, void* partials, void* scale,
                             void* site_log, int T, int I, int C, int maxc,
                             int P, int L, int rescale, int threads,
                             void* stream) {
  return launch_forward<double>(tips, pmats, children, freqs, props, partials,
                                scale, site_log, T, I, C, maxc, P, L, rescale,
                                threads, static_cast<cudaStream_t>(stream));
}

cudaError_t loop_backward_f32(const void* tips, const void* pmats,
                              const void* children, const void* freqs,
                              const void* props, const void* partials,
                              const void* scale, const void* g, void* gbuf,
                              void* dP_part, void* dfreqs_part,
                              void* dprops_part, int T, int I, int C,
                              int maxc, int P, int L, int threads,
                              void* stream) {
  return launch_backward<float>(tips, pmats, children, freqs, props,
                                partials, scale, g, gbuf, dP_part,
                                dfreqs_part, dprops_part, T, I, C, maxc, P, L,
                                threads, static_cast<cudaStream_t>(stream));
}

cudaError_t loop_backward_f64(const void* tips, const void* pmats,
                              const void* children, const void* freqs,
                              const void* props, const void* partials,
                              const void* scale, const void* g, void* gbuf,
                              void* dP_part, void* dfreqs_part,
                              void* dprops_part, int T, int I, int C,
                              int maxc, int P, int L, int threads,
                              void* stream) {
  return launch_backward<double>(tips, pmats, children, freqs, props,
                                 partials, scale, g, gbuf, dP_part,
                                 dfreqs_part, dprops_part, T, I, C, maxc, P,
                                 L, threads,
                                 static_cast<cudaStream_t>(stream));
}

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
