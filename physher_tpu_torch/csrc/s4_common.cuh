// What the two S = 4 walks by tree level share: the forward
// (csrc/s4_forward.cuh: K1' and K5' at S = 4) and the reverse
// (csrc/s4_backward.cuh: K2' and K6' at S = 4). Their block size, the root
// weights of one chain (RootWeights, K1'/K2') or of a batch of chains
// (FreqsProps, K5'/K6'), and the index tables a walk reads at every level,
// which it keeps in shared memory where they fit.

#pragma once

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

constexpr int S4_THREADS = 256;
constexpr int S4_WARPS = S4_THREADS / 32;
constexpr unsigned S4_FULL = 0xffffffffu;
// a walk keeps its index tables in shared memory up to this size
constexpr size_t S4_TABLE_SMEM = 48 * 1024;

// rootw[c, s] of K1'/K2': one chain's props (x) freqs, flattened [C * 4].
// Its cotangent leaves as d rootw, a row a chunk: drootw_part [nq, C * 4].
template <typename scalar_t> struct RootWeights {
  const scalar_t* rootw;
  scalar_t* drootw_part;
  __device__ scalar_t operator()(int, int c, int s, int) const {
    return __ldg(rootw + c * 4 + s);
  }
  // chunk q's d rootw from d[c * 4 + s] (shared memory), by thread
  __device__ void put(const scalar_t* d, int, int q, int C) const {
    if ((int)threadIdx.x < 4 * C)
      drootw_part[(size_t)q * C * 4 + threadIdx.x] = d[threadIdx.x];
  }
};

// rootw[l, c, s] of K5'/K6': props [L, C] and freqs [L, 4]. Its cotangent
// leaves as d freqs [L, nq, 4] and d props [L, nq, C] a chunk, through
// rootw = props (x) freqs.
template <typename scalar_t> struct FreqsProps {
  const scalar_t* freqs;
  const scalar_t* props;
  scalar_t* dfreqs_part;
  scalar_t* dprops_part;
  __device__ scalar_t operator()(int l, int c, int s, int C) const {
    return __ldg(props + (size_t)l * C + c) * __ldg(freqs + (size_t)l * 4 + s);
  }
  __device__ void put(const scalar_t* d, int l, int q, int C) const {
    const int t = threadIdx.x, nq = gridDim.x / C;
    scalar_t v = 0;
    if (t < 4) {
      for (int c = 0; c < C; ++c)
        v += __ldg(props + (size_t)l * C + c) * d[c * 4 + t];
      dfreqs_part[((size_t)l * nq + q) * 4 + t] = v;
    } else if (t < 4 + C) {
      for (int s = 0; s < 4; ++s)
        v += __ldg(freqs + (size_t)l * 4 + s) * d[(t - 4) * 4 + s];
      dprops_part[((size_t)l * nq + q) * C + t - 4] = v;
    }
  }
};

// Where a walk finds, at every level, the level's bounds, its nodes and
// their children: in shared memory when they fit (kids then holds each
// node's children in the walk's order), else in device memory (kids null).
struct WalkTables {
  const int* offsets;  // [levels + 1]
  const int* order;    // [I], the internal ranks by level
  const int* kids;     // [I, maxc] in `order`'s order, or null
  const int* __restrict__ children;
  int maxc;
  // child i of the node at position j of `order`
  __device__ int kid(int j, int i) const {
    return kids ? kids[j * maxc + i]
                : __ldg(children + (size_t)order[j] * maxc + i);
  }
};

// the bytes the tables take in shared memory
__host__ __device__ inline size_t s4_table_bytes(int n_levels, int I,
                                                 int maxc) {
  return ((size_t)n_levels + 1 + (size_t)I * (1 + maxc)) * sizeof(int);
}

// The walk's tables: copied into `tab` (shared memory) by the block if
// `in_smem`, else where they are. The caller synchronizes the block before
// it reads them.
__device__ inline WalkTables walk_tables(const int* __restrict__ offsets,
                                         const int* __restrict__ order,
                                         const int* __restrict__ children,
                                         int n_levels, int I, int maxc,
                                         bool in_smem, int* tab) {
  if (!in_smem) return WalkTables{offsets, order, nullptr, children, maxc};
  int* t_off = tab;
  int* t_ord = tab + n_levels + 1;
  int* t_kids = t_ord + I;
  for (int t = threadIdx.x; t <= n_levels; t += blockDim.x)
    t_off[t] = __ldg(offsets + t);
  for (int t = threadIdx.x; t < I; t += blockDim.x)
    t_ord[t] = __ldg(order + t);
  for (int t = threadIdx.x; t < I * maxc; t += blockDim.x)
    t_kids[t] = __ldg(children + (size_t)__ldg(order + t / maxc) * maxc +
                      t % maxc);
  return WalkTables{t_off, t_ord, t_kids, children, maxc};
}

}  // namespace
