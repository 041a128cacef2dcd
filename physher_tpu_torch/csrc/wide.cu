// Felsenstein pruning for wide state spaces (codon S = 61, protein S = 20)
// and its reverse sweep, for Hopper (sm_90a).
//
// Kernel K7' (wide_forward_*) replaces the TPU kernel
// physher_tpu/ops/pallas_wide.py _fwd_kernel (built by build_wide_forward);
// kernel K8' (wide_backward_*) replaces _bwd_kernel (build_wide_backward).
// They compute the function of the TPU kernels, not their layout: no
// group-diagonal [Rg, Rg] packing, no padding of S to a multiple of 8 and no
// per-step DMA semaphores, all of which exist for the MXU and Mosaic.
//
// Layouts (all contiguous, pattern axis innermost):
//   tips      [T, S, P]      tip partials (pad columns: all ones)
//   pmats     [N, C, S, S]   P matrix of the branch above each node
//   children  [I, maxc]      int32 child ids, -1 for a missing child
//   nodes     [I]            internal ranks, level by level, leaves first
//   rootw     [C * S]        props (x) freqs
//   partials  [I, C, S, P]   rescaled partials of internal node rank k
//   scale     [I, P]         per-node per-pattern max m over (C, S)
//   site_log  [P]            log(max(rootw . root, tiny)) + sum_k log m_k
// Internal node k has id T + k; ids are postorder ranks, the root is N - 1.
//
// What the TPU design keeps: the per-node partials live in device memory,
// not on chip, so on-chip memory is bounded by one node's work whatever the
// tree's depth. The forward writes them anyway, so the backward reads them
// instead of recomputing the forward.
//
// What bounds them on this card: per node, category and child a product
// [S, S] @ [S, patterns], 2 S^2 FLOPs per pattern against S partials read
// and written: 2 S FLOP per element, 30 FLOP per byte at S = 61 in float32,
// so codon models are compute-heavy for plain FMAs, and protein models
// (S = 20, C = 4, more nodes) sit near the ridge. The design does the simple
// thing about it:
// - Parallelism across nodes as well as patterns: one launch per level of
//   the postorder (the nodes of a level are independent), grid (pattern
//   tiles, nodes of the level). A block takes one node and 32 patterns.
// - A block stages one child's P matrix and its [S, 32] partials tile in
//   shared memory (dynamic, above 48 KB where S and the type need it); each
//   warp owns states w, w + 8, ... (at most 8, so S <= 64) for the 32
//   patterns of its lanes, and reads P as a broadcast.
// - The node's categories meet in shared memory before the division by the
//   per-pattern max over (C, S), as the rescaling requires.
// - The backward gives each block 4 tiles (128 patterns) and sums dP over
//   them in registers (a 16 x 16 grid of threads, 4 x 4 entries each) into
//   one per-block partial sum per (child, category); each (block, child)
//   row is written by exactly one block, and the caller sums the block
//   axis in a fixed order: deterministic, no atomics.

#include <cuda_runtime.h>
#include <cfloat>

#include "tiles.cuh"

namespace {

template <typename scalar_t> struct Limits;
template <> struct Limits<float> {
  __device__ static float tiny() { return FLT_MIN; }
};
template <> struct Limits<double> {
  __device__ static double tiny() { return DBL_MIN; }
};

__device__ inline float log_(float x) { return logf(x); }
__device__ inline double log_(double x) { return log(x); }

// One level of the postorder: grid (pattern tiles, nodes of the level).
// smem: Ps [S*S], Xs [S*TPS], Rs [C*S*TPS], red [NW*TP].
template <typename scalar_t>
__global__ void __launch_bounds__(THREADS)
    forward_level(const scalar_t* __restrict__ tips,
                  const scalar_t* __restrict__ pmats,
                  const int* __restrict__ children,
                  const int* __restrict__ nodes, scalar_t* partials,
                  scalar_t* __restrict__ scale, int T, int C, int S, int maxc,
                  int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* Ps = reinterpret_cast<scalar_t*>(smem_raw);
  scalar_t* Xs = Ps + S * S;
  scalar_t* Rs = Xs + S * TPS;
  scalar_t* red = Rs + C * S * TPS;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p0 = blockIdx.x * TP, p = p0 + lane;
  const int k = __ldg(nodes + blockIdx.y);
  scalar_t mx = Limits<scalar_t>::tiny();
  for (int c = 0; c < C; ++c) {
    scalar_t acc[A_MAX];
#pragma unroll
    for (int i = 0; i < A_MAX; ++i) acc[i] = 1;
    for (int j = 0; j < maxc; ++j) {
      const int ch = __ldg(children + k * maxc + j);
      if (ch < 0) continue;  // a missing child contributes 1
      __syncthreads();       // the previous child's tiles are consumed
      stage_child(tips, pmats, partials, ch, c, T, C, S, P, p0, scalar_t(1),
                  Ps, Xs);
      __syncthreads();
      mul_product(Ps, Xs, S, w, lane, acc);
    }
#pragma unroll
    for (int i = 0; i < A_MAX; ++i) {
      const int a = w + NW * i;
      if (a < S) {
        Rs[(c * S + a) * TPS + lane] = acc[i];
        mx = acc[i] > mx ? acc[i] : mx;
      }
    }
  }
  // the per-pattern max over all (C, S): the categories have met
  red[w * TP + lane] = mx;
  __syncthreads();
  scalar_t m = red[lane];
  for (int v = 1; v < NW; ++v) m = red[v * TP + lane] > m ? red[v * TP + lane] : m;
  if (p >= P) return;
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < A_MAX; ++i) {
      const int a = w + NW * i;
      if (a < S)
        partials[(((size_t)k * C + c) * S + a) * P + p] =
            Rs[(c * S + a) * TPS + lane] / m;
    }
  if (w == 0) scale[(size_t)k * P + p] = m;
}

// site_log[p] = log(max(rootw . root, tiny)) + sum_k log scale[k, p]
template <typename scalar_t>
__global__ void forward_root(const scalar_t* __restrict__ partials,
                             const scalar_t* __restrict__ scale,
                             const scalar_t* __restrict__ rootw,
                             scalar_t* __restrict__ site_log, int I, int CS,
                             int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const scalar_t* root = partials + (size_t)(I - 1) * CS * P;
  scalar_t site = 0;
  for (int cs = 0; cs < CS; ++cs) site += __ldg(rootw + cs) * root[(size_t)cs * P + p];
  const scalar_t tiny = Limits<scalar_t>::tiny();
  site = site > tiny ? site : tiny;
  scalar_t log_sum = 0;
  for (int k = 0; k < I; ++k) log_sum += log_(scale[(size_t)k * P + p]);
  site_log[p] = log_(site) + log_sum;
}

// Root seed of the reverse sweep, per block of BWD_P patterns:
// gbuf[root] = rootw * g / site; drootw_part[block] = sum_p root * g / site.
template <typename scalar_t>
__global__ void backward_root(const scalar_t* __restrict__ partials,
                              const scalar_t* __restrict__ rootw,
                              const scalar_t* __restrict__ g,
                              scalar_t* __restrict__ gbuf,
                              scalar_t* __restrict__ drootw_part, int I,
                              int CS, int P) {
  __shared__ scalar_t inv_s[BWD_P];
  const int p0 = blockIdx.x * BWD_P;
  const size_t root = (size_t)(I - 1) * CS * P;
  const scalar_t tiny = Limits<scalar_t>::tiny();
  for (int q = threadIdx.x; q < BWD_P; q += blockDim.x) {
    const int p = p0 + q;
    scalar_t inv = 0;
    if (p < P) {
      scalar_t site = 0;
      for (int cs = 0; cs < CS; ++cs)
        site += __ldg(rootw + cs) * partials[root + (size_t)cs * P + p];
      site = site > tiny ? site : tiny;
      inv = g[p] / site;
    }
    inv_s[q] = inv;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < CS * BWD_P; t += blockDim.x) {
    const int cs = t / BWD_P, q = t - cs * BWD_P, p = p0 + q;
    if (p < P) gbuf[root + (size_t)cs * P + p] = __ldg(rootw + cs) * inv_s[q];
  }
  for (int cs = threadIdx.x; cs < CS; cs += blockDim.x) {
    scalar_t s = 0;
    for (int q = 0; q < BWD_P && p0 + q < P; ++q)
      s += partials[root + (size_t)cs * P + p0 + q] * inv_s[q];
    drootw_part[(size_t)blockIdx.x * CS + cs] = s;
  }
}

// One level of the reverse sweep: grid (pattern blocks of BWD_P, nodes of
// the level). For node k, category c, child i and each tile of the block:
//   other = gbuf[k, c] / m_k * prod_{j != i} P_j @ x_j
//   dP[child i, c] += other @ x_i^T    (summed over the block's patterns)
//   gbuf[child i, c] = P_i^T @ other   (internal children only)
// smem: Ps [S*S], Xs [S*TPS], Os [S*TPS].
// dP_part: [gridDim.x, N, C, S, S]; the caller zeroes the root's row.
template <typename scalar_t>
__global__ void __launch_bounds__(THREADS)
    backward_level(const scalar_t* __restrict__ tips,
                   const scalar_t* __restrict__ pmats,
                   const int* __restrict__ children,
                   const int* __restrict__ nodes,
                   const scalar_t* __restrict__ partials,
                   const scalar_t* __restrict__ scale, scalar_t* gbuf,
                   scalar_t* __restrict__ dP_part, int T, int N, int C, int S,
                   int maxc, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* Ps = reinterpret_cast<scalar_t*>(smem_raw);
  scalar_t* Xs = Ps + S * S;
  scalar_t* Os = Xs + S * TPS;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int tx = threadIdx.x % DT, ty = threadIdx.x / DT;
  const int k = __ldg(nodes + blockIdx.y);
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < maxc; ++i) {
      const int ch = __ldg(children + k * maxc + i);
      if (ch < 0) continue;
      scalar_t acc[DA][DA];
#pragma unroll
      for (int u = 0; u < DA; ++u)
#pragma unroll
        for (int v = 0; v < DA; ++v) acc[u][v] = 0;
      for (int chunk = 0; chunk < BWD_CHUNKS; ++chunk) {
        const int p0 = (blockIdx.x * BWD_CHUNKS + chunk) * TP;
        if (p0 >= P) break;  // block-uniform
        const int p = p0 + lane;
        const bool valid = p < P;
        // cotangent of the raw (pre-rescale) product; the max is a constant
        const scalar_t m = valid ? scale[(size_t)k * P + p] : scalar_t(1);
        scalar_t o[A_MAX];
#pragma unroll
        for (int u = 0; u < A_MAX; ++u) {
          const int a = w + NW * u;
          o[u] = (valid && a < S)
                     ? gbuf[(((size_t)k * C + c) * S + a) * P + p] / m
                     : scalar_t(0);
        }
        for (int j = 0; j < maxc; ++j) {
          const int cj = __ldg(children + k * maxc + j);
          if (j == i || cj < 0) continue;
          __syncthreads();
          stage_child(tips, pmats, partials, cj, c, T, C, S, P, p0,
                      scalar_t(0), Ps, Xs);
          __syncthreads();
          mul_product(Ps, Xs, S, w, lane, o);
        }
        __syncthreads();  // every read of Ps, Xs and Os above is done
#pragma unroll
        for (int u = 0; u < A_MAX; ++u) {
          const int a = w + NW * u;
          if (a < S) Os[a * TPS + lane] = o[u];
        }
        stage_child(tips, pmats, partials, ch, c, T, C, S, P, p0,
                    scalar_t(0), Ps, Xs);
        __syncthreads();
        // dP[ch, c, a, b] += sum_q other[a, q] x[b, q]
        for (int q = 0; q < TP; ++q) {
          scalar_t oa[DA], xb[DA];
#pragma unroll
          for (int u = 0; u < DA; ++u) {
            const int a = ty + DT * u, b = tx + DT * u;
            oa[u] = a < S ? Os[a * TPS + q] : scalar_t(0);
            xb[u] = b < S ? Xs[b * TPS + q] : scalar_t(0);
          }
#pragma unroll
          for (int u = 0; u < DA; ++u)
#pragma unroll
            for (int v = 0; v < DA; ++v) acc[u][v] += oa[u] * xb[v];
        }
        if (ch >= T) {
          scalar_t gch[A_MAX];
          transpose_product(Ps, Os, S, w, lane, gch);
          if (valid) {
#pragma unroll
            for (int u = 0; u < A_MAX; ++u) {
              const int b = w + NW * u;
              if (b < S)
                gbuf[((((size_t)(ch - T)) * C + c) * S + b) * P + p] = gch[u];
            }
          }
        }
      }
      scalar_t* out = dP_part + (((size_t)blockIdx.x * N + ch) * C + c) * S * S;
#pragma unroll
      for (int u = 0; u < DA; ++u)
#pragma unroll
        for (int v = 0; v < DA; ++v) {
          const int a = ty + DT * u, b = tx + DT * v;
          if (a < S && b < S) out[a * S + b] = acc[u][v];
        }
    }
  }
}

bool bad_dims(int C, int S, int maxc) {
  return S < 2 || S > MAX_S || C < 1 || C > MAX_C || maxc < 1;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename scalar_t>
cudaError_t launch_forward(const void* tips, const void* pmats,
                           const void* children, const void* nodes,
                           const int* offsets, int n_levels,
                           const void* rootw, void* partials, void* scale,
                           void* site_log, int T, int I, int C, int S,
                           int maxc, int P, cudaStream_t stream) {
  if (bad_dims(C, S, maxc)) return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(S * S + S * TPS + C * S * TPS + NW * TP) * sizeof(scalar_t);
  cudaError_t e = allow_smem(forward_level<scalar_t>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (P + TP - 1) / TP;
  const int* nodes_ = static_cast<const int*>(nodes);
  for (int l = 0; l < n_levels; ++l) {
    const dim3 grid(tiles, offsets[l + 1] - offsets[l]);
    forward_level<scalar_t><<<grid, THREADS, smem, stream>>>(
        static_cast<const scalar_t*>(tips),
        static_cast<const scalar_t*>(pmats),
        static_cast<const int*>(children), nodes_ + offsets[l],
        static_cast<scalar_t*>(partials), static_cast<scalar_t*>(scale), T,
        C, S, maxc, P);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  forward_root<scalar_t><<<(P + 255) / 256, 256, 0, stream>>>(
      static_cast<const scalar_t*>(partials),
      static_cast<const scalar_t*>(scale),
      static_cast<const scalar_t*>(rootw), static_cast<scalar_t*>(site_log),
      I, C * S, P);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t launch_backward(const void* tips, const void* pmats,
                            const void* children, const void* nodes,
                            const int* offsets, int n_levels,
                            const void* rootw, const void* partials,
                            const void* scale, const void* g, void* gbuf,
                            void* dP_part, void* drootw_part, int T, int I,
                            int C, int S, int maxc, int P,
                            cudaStream_t stream) {
  if (bad_dims(C, S, maxc)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(S * S + 2 * S * TPS) * sizeof(scalar_t);
  cudaError_t e = allow_smem(backward_level<scalar_t>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (P + BWD_P - 1) / BWD_P;
  backward_root<scalar_t><<<blocks, THREADS, 0, stream>>>(
      static_cast<const scalar_t*>(partials),
      static_cast<const scalar_t*>(rootw), static_cast<const scalar_t*>(g),
      static_cast<scalar_t*>(gbuf), static_cast<scalar_t*>(drootw_part), I,
      C * S, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int* nodes_ = static_cast<const int*>(nodes);
  for (int l = n_levels - 1; l >= 0; --l) {
    const dim3 grid(blocks, offsets[l + 1] - offsets[l]);
    backward_level<scalar_t><<<grid, THREADS, smem, stream>>>(
        static_cast<const scalar_t*>(tips),
        static_cast<const scalar_t*>(pmats),
        static_cast<const int*>(children), nodes_ + offsets[l],
        static_cast<const scalar_t*>(partials),
        static_cast<const scalar_t*>(scale), static_cast<scalar_t*>(gbuf),
        static_cast<scalar_t*>(dP_part), T, T + I, C, S, maxc, P);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

#define PHYSHER_WIDE_ENTRY(SUFFIX, TYPE)                                       \
  cudaError_t wide_forward_##SUFFIX(                                           \
      const void* tips, const void* pmats, const void* children,               \
      const void* nodes, const int* offsets, int n_levels, const void* rootw,  \
      void* partials, void* scale, void* site_log, int T, int I, int C, int S, \
      int maxc, int P, void* stream) {                                         \
    return launch_forward<TYPE>(tips, pmats, children, nodes, offsets,         \
                                n_levels, rootw, partials, scale, site_log, T, \
                                I, C, S, maxc, P,                              \
                                static_cast<cudaStream_t>(stream));            \
  }                                                                            \
  cudaError_t wide_backward_##SUFFIX(                                          \
      const void* tips, const void* pmats, const void* children,               \
      const void* nodes, const int* offsets, int n_levels, const void* rootw,  \
      const void* partials, const void* scale, const void* g, void* gbuf,      \
      void* dP_part, void* drootw_part, int T, int I, int C, int S, int maxc,  \
      int P, void* stream) {                                                   \
    return launch_backward<TYPE>(tips, pmats, children, nodes, offsets,        \
                                 n_levels, rootw, partials, scale, g, gbuf,    \
                                 dP_part, drootw_part, T, I, C, S, maxc, P,    \
                                 static_cast<cudaStream_t>(stream));           \
  }

PHYSHER_WIDE_ENTRY(f32, float)
PHYSHER_WIDE_ENTRY(f64, double)

#undef PHYSHER_WIDE_ENTRY

}  // extern "C"
