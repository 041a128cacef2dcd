// Shared-memory tiles of the pruning node steps for any state count S from 2
// to 64, shared by both sweeps: the forward (csrc/wide_forward.cuh: K5' at
// S != 4 and K7') and the reverse (csrc/wide_backward.cuh: K6' at S != 4
// and K8'). A block of 8 warps takes one category of one node for one
// step's patterns: at S <= 32 four 32-pattern tiles at once (CP = 4, two
// warps a tile), above one tile (CP = 1, eight warps a tile). A thread owns
// A rows a = wi + WPC i (wi its warp within the tile) of its lane's
// pattern in the products y = M z; A is a template parameter, chosen at
// launch from S by with_wide_tiles, so the products spend almost no FMA on
// padding. P matrices are staged as [RA][SP] (zero outside [S, S]) and read
// as 16-byte broadcasts; partials tiles as [rows][TX] with a row stride TX
// of the step's patterns plus one 16-byte vector, so that eight lanes'
// vectors fall in distinct banks. Staging is by cp.async.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int NW = 8;                  // warps per block
constexpr int THREADS = NW * 32;
constexpr int TP = 32;                 // patterns per tile, one per lane
constexpr int MAX_S = 64;
constexpr int MAX_C = 8;
constexpr int BWD_CHUNKS = 4;          // pattern tiles per backward block
constexpr int BWD_P = TP * BWD_CHUNKS;

template <typename scalar_t> struct Limits;
template <> struct Limits<float> {
  __device__ static float tiny() { return FLT_MIN; }
};
template <> struct Limits<double> {
  __device__ static double tiny() { return DBL_MIN; }
};

__device__ inline float log_(float x) { return logf(x); }
__device__ inline double log_(double x) { return log(x); }

// The root's weight of (category c, state s), factor(c) * states(c)[s]:
// props_c freqs_s of one chain (K5'/K6': w = freqs [S], props [C], cstride
// 0) or rootw [C, S] (K1'/K2': props null, cstride S)
template <typename scalar_t> struct StateWeights {
  const scalar_t* w;
  const scalar_t* props;
  int cstride;
  __device__ const scalar_t* states(int c) const {
    return w + (size_t)c * cstride;
  }
  __device__ scalar_t factor(int c) const {
    return props ? __ldg(props + c) : scalar_t(1);
  }
};

// 16-byte vectors of the tiles: 4 floats or 2 doubles
template <typename scalar_t> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float o[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
};
template <> struct Vec<double> {
  static constexpr int n = 2;
  __device__ static void load(const double* p, double o[2]) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    o[0] = v.x, o[1] = v.y;
  }
};

// Shape of the tiles at A product rows per thread and CP tiles a step; AD,
// J, XR and OR are the reverse sweep's dP pass (csrc/wide_backward.cuh)
template <typename scalar_t, int A, int CP> struct WideTiles {
  static_assert(BWD_CHUNKS % CP == 0 && NW % CP == 0, "tiles per step");
  static constexpr int V = Vec<scalar_t>::n;
  static constexpr int WPC = NW / CP;           // warps per tile
  static constexpr int RA = WPC * A;            // product rows, >= SP
  static constexpr int AD = (RA + NW - 1) / NW;  // dP rows per thread
  static constexpr int J = (RA + 31) / 32;       // dP columns per lane
  static constexpr int XR = 32 * J, OR = NW * AD;
  static constexpr int TQ = TP * CP, TX = TQ + V;
  __host__ __device__ static int sp(int S) { return (S + V - 1) / V * V; }
  __host__ __device__ static size_t smem_scalars(int S) {
    return 4 * (size_t)RA * sp(S) + 2 * (size_t)XR * TX + 2 * (size_t)OR * TX;
  }
};

// The staging below copies with cp.async, one scalar a piece (zero-filled
// where `in` is false, reading nothing): a thread's copies are all in flight
// at once, where loads through registers would wait in turn. The caller
// commits, waits and then synchronizes the block.
template <typename scalar_t>
__device__ inline void copy_async(scalar_t* dst, const scalar_t* src,
                                  bool in) {
  __pipeline_memcpy_async(dst, src, sizeof(scalar_t),
                          in ? 0 : sizeof(scalar_t));
}

// Pd [RA][SP] <- P ([S, S], row-major) and Ptd <- Pᵀ, each unless null;
// zero outside [S, S]
template <typename scalar_t>
__device__ inline void stage_pmat(const scalar_t* __restrict__ pm, int RA,
                                  int S, int SP, scalar_t* Pd, scalar_t* Ptd) {
  for (int t = threadIdx.x; t < RA * SP; t += blockDim.x) {
    const int r = t / SP, col = t - r * SP;
    const bool in = r < S && col < S;
    if (Pd) copy_async(Pd + t, pm + (in ? r * S + col : 0), in);
    if (Ptd) copy_async(Ptd + t, pm + (in ? col * S + r : 0), in);
  }
}

// Xd [XR][TX] <- src [S, P] at patterns p0 .. p0 + TQ - 1, zero outside.
// `src` may have been written earlier in the same launch by other threads
// of the block (the forward's partials), before a barrier: not the
// read-only path.
template <typename scalar_t>
__device__ inline void stage_tile(const scalar_t* src, int S, int P, int p0,
                                  int XR, int TQ, int TX, scalar_t* Xd) {
  for (int t = threadIdx.x; t < XR * TQ; t += blockDim.x) {
    const int b = t / TQ, q = t - b * TQ, p = p0 + q;
    const bool in = b < S && p < P;
    copy_async(Xd + b * TX + q, src + (in ? (size_t)b * P + p : 0), in);
  }
}

// this thread's copies have landed; the caller then synchronizes the block
__device__ inline void staged() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// y[i] = sum_b M[r0 + step i, b] Z[b, col] over b < SP: M [RA][SP],
// Z [>= SP][TX]
template <typename scalar_t, int A>
__device__ inline void rows_product(const scalar_t* M, const scalar_t* Z,
                                    int SP, int TX, int r0, int step,
                                    int col, scalar_t y[A]) {
  constexpr int V = Vec<scalar_t>::n;
#pragma unroll
  for (int i = 0; i < A; ++i) y[i] = 0;
  // not unrolled: an unrolled step keeps A more vectors live, and the
  // float32 kernels must stay within their register budgets
#pragma unroll 1
  for (int b0 = 0; b0 < SP; b0 += V) {
    scalar_t z[V];
#pragma unroll
    for (int v = 0; v < V; ++v) z[v] = Z[(b0 + v) * TX + col];
#pragma unroll
    for (int i = 0; i < A; ++i) {
      scalar_t m[V];
      Vec<scalar_t>::load(M + (r0 + step * i) * SP + b0, m);
#pragma unroll
      for (int v = 0; v < V; ++v) y[i] += m[v] * z[v];
    }
  }
}

// Launch<scalar_t, A, CP>::run(args...) at S's tile shape: at S <= 32 the
// block's four tiles at once (CP = 4, two warps a tile), A = SP / 2 rounded
// up to an even count (2 to 16); at S > 32 one tile a step (CP = 1, eight
// warps a tile), A = ceil(SP / 8) (5 to 8), SP being S rounded up to a
// 16-byte vector. cudaErrorInvalidValue outside S 2 to 64.
template <typename scalar_t, template <typename, int, int> class Launch,
          typename... Args>
cudaError_t with_wide_tiles(int S, Args... args) {
  if (S < 2 || S > MAX_S) return cudaErrorInvalidValue;
  const int SP = WideTiles<scalar_t, 1, 1>::sp(S);
#define PHYSHER_WIDE_TILES_CASE(AA, CC) \
  case AA:                              \
    return Launch<scalar_t, AA, CC>::run(args...);
  if (S <= 32) {
    switch ((SP + 3) / 4 * 2) {
      PHYSHER_WIDE_TILES_CASE(2, 4)
      PHYSHER_WIDE_TILES_CASE(4, 4)
      PHYSHER_WIDE_TILES_CASE(6, 4)
      PHYSHER_WIDE_TILES_CASE(8, 4)
      PHYSHER_WIDE_TILES_CASE(10, 4)
      PHYSHER_WIDE_TILES_CASE(12, 4)
      PHYSHER_WIDE_TILES_CASE(14, 4)
      PHYSHER_WIDE_TILES_CASE(16, 4)
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch ((SP + NW - 1) / NW) {
    PHYSHER_WIDE_TILES_CASE(5, 1)
    PHYSHER_WIDE_TILES_CASE(6, 1)
    PHYSHER_WIDE_TILES_CASE(7, 1)
    PHYSHER_WIDE_TILES_CASE(8, 1)
    default:
      return cudaErrorInvalidValue;
  }
#undef PHYSHER_WIDE_TILES_CASE
}

}  // namespace
