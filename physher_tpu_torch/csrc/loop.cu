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

#include <cuda_runtime.h>
#include <cfloat>

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

}  // extern "C"
