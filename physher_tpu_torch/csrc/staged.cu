// Felsenstein pruning for large nucleotide alignments, one launch per tree
// level, and its reverse sweep, for Hopper (sm_90a).
//
// Kernel K3' (staged_forward_*) replaces the TPU kernel
// physher_tpu/ops/pallas_staged.py _fwd_kernel (built by build_staged_forward
// and run with spill=True, as _staged_fwd does); kernel K4' (staged_backward_*)
// replaces _bwd_kernel (build_staged_backward). tools/staged_proto.py
// build_staged_forward is a forward-only prototype of the same function, so
// K3' is its counterpart too.
//
// Layouts (all contiguous, pattern axis innermost):
//   tips      [T, 4, P]      tip partials (pad columns: all ones)
//   pmats     [N, C, 4, 4]   P matrix of the branch above each node
//   children  [I, maxc]      int32 child ids, -1 for a missing child
//   nodes     [I]            internal ranks, level by level, leaves first
//   rootw     [C * 4]        props (x) freqs
//   partials  [I, C, 4, P]   rescaled partials of internal node rank k
//                            ("the stage": written by K3', read by K4')
//   logscale  [I, P]         log of the per-node per-pattern max m over (C, 4)
//   site_log  [P]            log(max(rootw . root, tiny)) + sum_k logscale[k]
// Internal node k has id T + k; ids are postorder ranks, the root is N - 1.
//
// What the design keeps from the TPU kernels: the tree step is a parallel
// axis (there a grid axis over block-packed steps, here one launch per level
// of the postorder with the level's nodes on gridDim.y), and the forward's
// rescaled partials and scalers are saved to device memory so that the
// backward reads them and never recomputes the forward (the TPU's spill=True
// path). What it drops: the block-diagonal [Rb, Rb] packing of B nodes per
// step, the consumer-slot layout, the category padding to 8 sublanes and
// TILE = 256, all of which serve the MXU and Mosaic.
//
// What bounds them on this card: per node, category and child a 4 x 4
// product per pattern, 32 FLOPs against 16 bytes of child partials read and
// 16 bytes written in float32: about 1 FLOP per byte, far below the H100's
// float32 ridge (67 TFLOP/s over 3.35 TB/s, about 20 FLOP per byte), so both
// kernels are bound by device-memory (or L2) bandwidth. The design does the
// simple thing about it:
// - Parallelism across the nodes of a level as well as across patterns:
//   grid (pattern tiles of 128, nodes of the level), one thread per pattern,
//   the C x 4 partials in registers (C a template parameter), the pattern
//   axis innermost so every load and store is coalesced. At 128 taxa x 16384
//   patterns the first level is 64 x 128 = 8192 blocks, where the fused
//   kernel (csrc/pruning.cu), which walks the whole postorder in one launch,
//   has 128.
// - A block stages its node's children's C x maxc x 16 P entries in shared
//   memory once; every thread reads them as broadcasts.
// - A tip child's 4 states are loaded once for all C categories.
// - The root's level holds the root alone; its launch also computes
//   site_log, so a forward sweep is one launch per level.
// - K4' is a root launch (the seed g / site and d rootw), then one launch per
//   level, root first. A block reads its node's cotangent [C, 4, 128] from
//   device memory and writes each internal child's. It sums dP over its 128
//   patterns (warp shuffles, then shared memory across the 4 warps) into one
//   per-block partial sum per (child, category); each (block, child) row is
//   written by exactly one block, and the caller sums the block axis in a
//   fixed order: deterministic, no atomics.
// Every buffer the caller hands in is fully written before it is read: each
// internal node is in one level, each non-root node is the child of one
// parent, and the caller zeroes the root's row of the dP partial sums, which
// no block writes.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int THREADS = 128;           // one pattern per thread
constexpr int NW = THREADS / 32;
constexpr int MAX_CS = 32;             // C <= 8 categories of 4 states

template <typename scalar_t> struct Limits;
template <> struct Limits<float> {
  __device__ static float tiny() { return FLT_MIN; }
};
template <> struct Limits<double> {
  __device__ static double tiny() { return DBL_MIN; }
};

__device__ inline float log_(float x) { return logf(x); }
__device__ inline double log_(double x) { return log(x); }
__device__ inline float exp_(float x) { return expf(x); }
__device__ inline double exp_(double x) { return exp(x); }

template <typename scalar_t>
__device__ inline scalar_t warp_sum(scalar_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Ps[j, c, :, :] <- P of node k's child j in category c (zero for a missing
// child); every thread of the block takes part.
template <typename scalar_t>
__device__ inline void stage_pmats(const scalar_t* __restrict__ pmats,
                                   const int* __restrict__ children, int k,
                                   int C, int maxc, scalar_t* Ps) {
  const int per_child = C * 16;
  for (int t = threadIdx.x; t < maxc * per_child; t += blockDim.x) {
    const int j = t / per_child;
    const int ch = __ldg(children + k * maxc + j);
    Ps[t] = ch < 0 ? scalar_t(0)
                   : __ldg(pmats + (size_t)ch * per_child + (t - j * per_child));
  }
}

// x[b] <- child ch's partials (category c) at pattern p
template <typename scalar_t>
__device__ inline void load_child(const scalar_t* __restrict__ tips,
                                  const scalar_t* partials, int ch, int c,
                                  int T, int C, int P, int p, scalar_t x[4]) {
  const scalar_t* src = ch < T ? tips + (size_t)ch * 4 * P
                               : partials + ((size_t)(ch - T) * C + c) * 4 * P;
#pragma unroll
  for (int b = 0; b < 4; ++b) x[b] = src[(size_t)b * P + p];
}

// out[a] = sum_b Pm[a, b] * x[b]
template <typename scalar_t>
__device__ inline void apply_p(const scalar_t* Pm, const scalar_t x[4],
                               scalar_t out[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    scalar_t s = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) s += Pm[a * 4 + b] * x[b];
    out[a] = s;
  }
}

// One level of the postorder: grid (pattern tiles, nodes of the level).
// smem: Ps [maxc, C, 16].
template <typename scalar_t, int C>
__global__ void __launch_bounds__(THREADS)
    forward_level(const scalar_t* __restrict__ tips,
                  const scalar_t* __restrict__ pmats,
                  const int* __restrict__ children,
                  const int* __restrict__ nodes,
                  const scalar_t* __restrict__ rootw, scalar_t* partials,
                  scalar_t* logscale, scalar_t* __restrict__ site_log, int T,
                  int I, int maxc, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* Ps = reinterpret_cast<scalar_t*>(smem_raw);
  const int k = __ldg(nodes + blockIdx.y);
  stage_pmats(pmats, children, k, C, maxc, Ps);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  scalar_t res[C][4];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int a = 0; a < 4; ++a) res[c][a] = 1;
  for (int j = 0; j < maxc; ++j) {
    const int ch = __ldg(children + k * maxc + j);
    if (ch < 0) continue;  // a missing child contributes 1
    scalar_t x[4], contrib[4];
    if (ch < T) load_child(tips, partials, ch, 0, T, C, P, p, x);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (ch >= T) load_child(tips, partials, ch, c, T, C, P, p, x);
      apply_p(Ps + (j * C + c) * 16, x, contrib);
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
  const scalar_t lm = log_(m);
  logscale[(size_t)k * P + p] = lm;
  if (k == I - 1) {
    // the root: its level holds it alone, and every other node's scaler was
    // written by an earlier launch on the same stream
    scalar_t site = 0;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) site += __ldg(rootw + c * 4 + a) * res[c][a];
    const scalar_t tiny = Limits<scalar_t>::tiny();
    site = site > tiny ? site : tiny;
    scalar_t log_sum = lm;
    for (int r = 0; r < I - 1; ++r) log_sum += logscale[(size_t)r * P + p];
    site_log[p] = log_(site) + log_sum;
  }
}

// Root seed of the reverse sweep, per block of THREADS patterns:
// gbuf[root] = rootw * g / site; drootw_part[block] = sum_p root * g / site.
template <typename scalar_t>
__global__ void __launch_bounds__(THREADS)
    backward_root(const scalar_t* __restrict__ partials,
                  const scalar_t* __restrict__ rootw,
                  const scalar_t* __restrict__ g, scalar_t* __restrict__ gbuf,
                  scalar_t* __restrict__ drootw_part, int I, int CS, int P) {
  __shared__ scalar_t red[NW][MAX_CS];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p < P;  // threads past P join the shuffles with zeros
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t root = (size_t)(I - 1) * CS * P;
  scalar_t site = 0;
  if (valid)
    for (int cs = 0; cs < CS; ++cs)
      site += __ldg(rootw + cs) * partials[root + (size_t)cs * P + p];
  const scalar_t tiny = Limits<scalar_t>::tiny();
  site = site > tiny ? site : tiny;
  const scalar_t inv = valid ? g[p] / site : scalar_t(0);
  for (int cs = 0; cs < CS; ++cs) {
    const size_t idx = root + (size_t)cs * P + p;
    const scalar_t x = valid ? partials[idx] : scalar_t(0);
    if (valid) gbuf[idx] = __ldg(rootw + cs) * inv;
    const scalar_t s = warp_sum(x * inv);
    if (lane == 0) red[w][cs] = s;
  }
  __syncthreads();
  for (int cs = threadIdx.x; cs < CS; cs += blockDim.x) {
    scalar_t s = 0;
    for (int v = 0; v < NW; ++v) s += red[v][cs];
    drootw_part[(size_t)blockIdx.x * CS + cs] = s;
  }
}

// One level of the reverse sweep: grid (pattern tiles, nodes of the level).
// For node k, category c and child i, per pattern:
//   other = gbuf[k, c] / m_k * prod_{j != i} P_j @ x_j
//   dP[child i, c] += other x_i^T    (summed over the block's patterns)
//   gbuf[child i, c] = P_i^T @ other (internal children only)
// smem: Ps [maxc, C, 16], red [NW, maxc * C * 16].
// dP_part: [gridDim.x, N, C, 16]; the caller zeroes the root's row.
template <typename scalar_t, int C>
__global__ void __launch_bounds__(THREADS)
    backward_level(const scalar_t* __restrict__ tips,
                   const scalar_t* __restrict__ pmats,
                   const int* __restrict__ children,
                   const int* __restrict__ nodes,
                   const scalar_t* __restrict__ partials,
                   const scalar_t* __restrict__ logscale, scalar_t* gbuf,
                   scalar_t* __restrict__ dP_part, int T, int N, int maxc,
                   int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int width = maxc * C * 16;
  scalar_t* Ps = reinterpret_cast<scalar_t*>(smem_raw);
  scalar_t* red = Ps + width;
  const int k = __ldg(nodes + blockIdx.y);
  stage_pmats(pmats, children, k, C, maxc, Ps);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p < P;  // threads past P join the shuffles with zeros
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // cotangent of the raw (pre-rescale) product: the max is a constant
  const scalar_t minv =
      valid ? exp_(-logscale[(size_t)k * P + p]) : scalar_t(0);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    scalar_t graw[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      graw[a] = valid ? gbuf[(((size_t)k * C + c) * 4 + a) * P + p] * minv
                      : scalar_t(0);
    for (int i = 0; i < maxc; ++i) {
      const int ch = __ldg(children + k * maxc + i);
      if (ch < 0) continue;  // block-uniform
      scalar_t other[4] = {graw[0], graw[1], graw[2], graw[3]};
      for (int j = 0; j < maxc; ++j) {
        const int cj = __ldg(children + k * maxc + j);
        if (j == i || cj < 0) continue;
        scalar_t xj[4] = {0, 0, 0, 0}, cb[4];
        if (valid) load_child(tips, partials, cj, c, T, C, P, p, xj);
        apply_p(Ps + (j * C + c) * 16, xj, cb);
#pragma unroll
        for (int a = 0; a < 4; ++a) other[a] *= cb[a];
      }
      scalar_t x[4] = {0, 0, 0, 0};
      if (valid) load_child(tips, partials, ch, c, T, C, P, p, x);
      // dP[ch, c, a, b] += other[a] * x[b], reduced over the warp
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const scalar_t s = warp_sum(other[a] * x[b]);
          if (lane == 0) red[w * width + (i * C + c) * 16 + a * 4 + b] = s;
        }
      // the child's cotangent: sum_a P[ch, c, a, b] * other[a]
      if (valid && ch >= T) {
        const scalar_t* Pm = Ps + (i * C + c) * 16;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          scalar_t s = 0;
#pragma unroll
          for (int a = 0; a < 4; ++a) s += Pm[a * 4 + b] * other[a];
          gbuf[((((size_t)(ch - T)) * C + c) * 4 + b) * P + p] = s;
        }
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < width; t += blockDim.x) {
    const int i = t / (C * 16);
    const int ch = __ldg(children + k * maxc + i);
    if (ch < 0) continue;
    scalar_t s = 0;
    for (int v = 0; v < NW; ++v) s += red[v * width + t];
    dP_part[((size_t)blockIdx.x * N + ch) * C * 16 + (t - i * C * 16)] = s;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename scalar_t, int C>
cudaError_t run_forward(const scalar_t* tips, const scalar_t* pmats,
                        const int* children, const int* nodes,
                        const int* offsets, int n_levels,
                        const scalar_t* rootw, scalar_t* partials,
                        scalar_t* logscale, scalar_t* site_log, int T, int I,
                        int maxc, int P, cudaStream_t stream) {
  const size_t smem = (size_t)maxc * C * 16 * sizeof(scalar_t);
  cudaError_t e = allow_smem(forward_level<scalar_t, C>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (P + THREADS - 1) / THREADS;
  for (int l = 0; l < n_levels; ++l) {
    const dim3 grid(tiles, offsets[l + 1] - offsets[l]);
    forward_level<scalar_t, C><<<grid, THREADS, smem, stream>>>(
        tips, pmats, children, nodes + offsets[l], rootw, partials, logscale,
        site_log, T, I, maxc, P);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename scalar_t, int C>
cudaError_t run_backward(const scalar_t* tips, const scalar_t* pmats,
                         const int* children, const int* nodes,
                         const int* offsets, int n_levels,
                         const scalar_t* rootw, const scalar_t* partials,
                         const scalar_t* logscale, const scalar_t* g,
                         scalar_t* gbuf, scalar_t* dP_part,
                         scalar_t* drootw_part, int T, int I, int maxc, int P,
                         cudaStream_t stream) {
  const size_t smem = (size_t)maxc * C * 16 * (1 + NW) * sizeof(scalar_t);
  cudaError_t e = allow_smem(backward_level<scalar_t, C>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (P + THREADS - 1) / THREADS;
  backward_root<scalar_t><<<tiles, THREADS, 0, stream>>>(
      partials, rootw, g, gbuf, drootw_part, I, C * 4, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  for (int l = n_levels - 1; l >= 0; --l) {
    const dim3 grid(tiles, offsets[l + 1] - offsets[l]);
    backward_level<scalar_t, C><<<grid, THREADS, smem, stream>>>(
        tips, pmats, children, nodes + offsets[l], partials, logscale, gbuf,
        dP_part, T, T + I, maxc, P);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

#define PHYSHER_STAGED_CASES(CALL) \
  switch (C) {                     \
    case 1: return CALL(1);        \
    case 2: return CALL(2);        \
    case 3: return CALL(3);        \
    case 4: return CALL(4);        \
    case 5: return CALL(5);        \
    case 6: return CALL(6);        \
    case 7: return CALL(7);        \
    case 8: return CALL(8);        \
    default: return cudaErrorInvalidValue; \
  }

template <typename scalar_t>
cudaError_t launch_forward(const void* tips, const void* pmats,
                           const void* children, const void* nodes,
                           const int* offsets, int n_levels,
                           const void* rootw, void* partials, void* logscale,
                           void* site_log, int T, int I, int C, int maxc,
                           int P, cudaStream_t stream) {
  if (maxc < 1 || n_levels < 1) return cudaErrorInvalidValue;
#define PHYSHER_FWD(CC)                                                       \
  run_forward<scalar_t, CC>(                                                  \
      static_cast<const scalar_t*>(tips), static_cast<const scalar_t*>(pmats), \
      static_cast<const int*>(children), static_cast<const int*>(nodes),      \
      offsets, n_levels, static_cast<const scalar_t*>(rootw),                 \
      static_cast<scalar_t*>(partials), static_cast<scalar_t*>(logscale),     \
      static_cast<scalar_t*>(site_log), T, I, maxc, P, stream)
  PHYSHER_STAGED_CASES(PHYSHER_FWD)
#undef PHYSHER_FWD
}

template <typename scalar_t>
cudaError_t launch_backward(const void* tips, const void* pmats,
                            const void* children, const void* nodes,
                            const int* offsets, int n_levels,
                            const void* rootw, const void* partials,
                            const void* logscale, const void* g, void* gbuf,
                            void* dP_part, void* drootw_part, int T, int I,
                            int C, int maxc, int P, cudaStream_t stream) {
  if (maxc < 1 || n_levels < 1) return cudaErrorInvalidValue;
#define PHYSHER_BWD(CC)                                                       \
  run_backward<scalar_t, CC>(                                                 \
      static_cast<const scalar_t*>(tips), static_cast<const scalar_t*>(pmats), \
      static_cast<const int*>(children), static_cast<const int*>(nodes),      \
      offsets, n_levels, static_cast<const scalar_t*>(rootw),                 \
      static_cast<const scalar_t*>(partials),                                 \
      static_cast<const scalar_t*>(logscale), static_cast<const scalar_t*>(g), \
      static_cast<scalar_t*>(gbuf), static_cast<scalar_t*>(dP_part),          \
      static_cast<scalar_t*>(drootw_part), T, I, maxc, P, stream)
  PHYSHER_STAGED_CASES(PHYSHER_BWD)
#undef PHYSHER_BWD
}

#undef PHYSHER_STAGED_CASES

}  // namespace

extern "C" {

#define PHYSHER_STAGED_ENTRY(SUFFIX, TYPE)                                     \
  cudaError_t staged_forward_##SUFFIX(                                         \
      const void* tips, const void* pmats, const void* children,               \
      const void* nodes, const int* offsets, int n_levels, const void* rootw,  \
      void* partials, void* logscale, void* site_log, int T, int I, int C,     \
      int maxc, int P, void* stream) {                                         \
    return launch_forward<TYPE>(tips, pmats, children, nodes, offsets,         \
                                n_levels, rootw, partials, logscale, site_log, \
                                T, I, C, maxc, P,                              \
                                static_cast<cudaStream_t>(stream));            \
  }                                                                            \
  cudaError_t staged_backward_##SUFFIX(                                        \
      const void* tips, const void* pmats, const void* children,               \
      const void* nodes, const int* offsets, int n_levels, const void* rootw,  \
      const void* partials, const void* logscale, const void* g, void* gbuf,   \
      void* dP_part, void* drootw_part, int T, int I, int C, int maxc, int P,  \
      void* stream) {                                                          \
    return launch_backward<TYPE>(tips, pmats, children, nodes, offsets,        \
                                 n_levels, rootw, partials, logscale, g, gbuf, \
                                 dP_part, drootw_part, T, I, C, maxc, P,       \
                                 static_cast<cudaStream_t>(stream));           \
  }

PHYSHER_STAGED_ENTRY(f32, float)
PHYSHER_STAGED_ENTRY(f64, double)

#undef PHYSHER_STAGED_ENTRY

}  // extern "C"
