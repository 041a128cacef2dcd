// Felsenstein pruning for large nucleotide alignments, one launch per wide
// tree level and one walk of the rest, and its reverse sweep, one launch
// per level, for Hopper (sm_90a).
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
// kernels are bound by device-memory (or L2) bandwidth where a launch has
// the bytes to fill the card, and by latency where it has not: a launch of
// a level of one node costs 5-6 us of device time at 16 384 patterns and
// C = 4, against 1 us of bytes. The function's bound at 128 taxa x 16 291
// patterns, C = 4, float32 is 0.052 ms; the level-by-level design's floor,
// every internal child read back from device memory, 0.091 ms for K3' and
// 0.131 for K4' (chip_profile.staged_design_floor_ms).
//
// K3', redesigned for this card. The first design, one launch a level with
// the root's launch summing every scaler row in one serial loop a thread,
// spent 14 launches a sweep at the 128-taxon config and 21 on the GTR+G4
// fluA tree, whose levels each fill two of 132 SMs. Now:
// - The levels below a switch level (ops/staged.py walk_level) one launch
//   each, forward_level: grid (pattern tiles, nodes of the level), the C x 4
//   partials of a pattern in one thread's registers (C a template
//   parameter); a block stages its node's children's P matrices in shared
//   memory, a tip child's 4 states are loaded once for all C categories.
//   In float32, where P is a multiple of 4 and the level still gives every
//   SM four blocks (forward_ppt), a thread takes 16 bytes of consecutive
//   patterns a row as one vector load and store (7-10 % off balanced 128 x
//   16 384's two widest levels; as many strided patterns took 9 % longer
//   than one a thread, and float64's pairs 5 % longer).
// - The rest of the tree in one launch, by one of two walks, each summing
//   every node's log m into the site log in a fixed order (the stage's
//   rows with SUM_LOADS loads in flight):
//   - over few patterns (P x C' <= 16 384), the S = 4 walk of
//     csrc/s4_forward.cuh, which K1' and K5' share, with the TopOfStage
//     policy: threads on (pattern, category, state), a level's nodes across
//     the block, one barrier a level, children below the switch read from
//     the stage with plain loads and walked ones handed on in shared
//     memory, log m stored. The GTR+G4 fluA tree is walked whole: 21
//     launches and 87 us of device time became one of 25 us, K1''s time.
//   - over more, the chain walk (forward_chain): threads on (pattern,
//     category), each walking the remaining nodes in turn with no barrier,
//     since a pattern's node depends on that pattern alone; a lane's rows
//     are contiguous across the warp, which the S = 4 walk's (four state
//     lanes a pattern) are not, and its grid is resident where the S = 4
//     walk's takes two to three waves, each paying every level's latency.
//     At the 128-taxon config it walks levels 6-13 (15 nodes) in 39 us,
//     where their launches took 60.
// - walk_level's rule was fitted to the least summed time over 192 shapes
//   (chip_profile.py --switch): its sum is 1.5 % above that of the best
//   switch for each shape, a launch a level's 55 % above.
// What bounds it now: the widest level moves about 2.1 TB/s (73 MB in 34
// us at the config); the config's sweep takes 161 us against its 0.052 ms
// bound and this design's floor of 0.087 ms (the walked nodes' partials
// are written but not read back from device memory).
//
// K4', redesigned for this card. The first design (one thread per pattern
// walking every category and child, each dP entry reduced over every
// 128-pattern block by its own 5-shuffle warp sum, each sibling reloaded and
// its product recomputed per child) spent more shuffles than arithmetic
// and ran at 10x the function's bound. What it does now:
// - Categories across the warps of a block (Lanes): CP warps a pattern row,
//   C rounded up to a power of two, warp w taking category w % CP and lane
//   l pattern l of the row, so every warp's load and store is a whole
//   128-byte line (categories across the lanes of a warp, four 32-byte
//   pieces a load, took 10 % longer), the C warps of a pattern meet a tip
//   child's states and the node's scaler in the same lines, and every level
//   has C times the threads of one thread a pattern.
// - dP accumulated over many patterns before any reduction: a thread takes
//   ppt patterns of its block, strided by the block's row of QB, and the
//   block reduces once, by a butterfly over the warp's lanes that halves
//   the values a lane holds at each step (31 shuffles for 32 values, not 32
//   x 5), then the category's warps in a fixed order. ppt is chosen per
//   level by the caller (ops/staged.py level_ppt) from the level's waves of
//   blocks: the wide levels take 16 patterns a thread, the root's one.
// - A binary node: each child's P in registers, its partials and its
//   product u_j = P_j x_j once per category and pattern, the two "other"
//   vectors from the cotangent and the sibling's u. A thread's log m,
//   cotangent and children's partials are copied by cp.async into its own
//   shared-memory slots BWD_DEPTH - 1 patterns ahead of the arithmetic
//   (10-15 % off the wide levels against none). A polytomy (or a missing
//   child) takes the general loop, one child at a time.
// - The per-block partial sums go to a scratch laid out per node (rows:
//   its offset and block count, from the caller; 2.1 MB at 128 taxa x
//   16 291 patterns, C = 4, where the first design's was 8.4), and one more
//   launch sums each (child, category, entry) over its blocks in a fixed
//   order and writes d pmats and d rootw: deterministic, no atomics.
// What bounds it now (chip_profile.py --staged): the wide levels move
// about 1.4 TB/s, 40 % of the card's byte rate; the narrow ones take about
// 5 us each, near the host's 6 us to launch one.
// Every buffer the caller hands in is fully written before it is read: each
// internal node is in one level, each non-root node is the child of one
// parent, and the sum launch zeroes the root's d pmats row.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

#include "s4_forward.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int FWD_THREADS = 128;       // K3''s levels and chain walk
// rows of the stage's log m summed with this many loads in flight
constexpr int SUM_LOADS = 4;
// K4''s binary node: scalars staged a pattern (log m, the cotangent, two
// children), patterns staged ahead (BWD_DEPTH - 1), and the blocks an SM its
// registers allow in float32 (float64 takes one)
constexpr int STAGED = 13;
constexpr int BWD_DEPTH = 4;
constexpr int BWD_BLOCKS = 2;

__device__ inline float exp_(float x) { return expf(x); }
__device__ inline double exp_(double x) { return exp(x); }

// *dst <- row[p] by cp.async, or zero where !valid (row[0] is then named,
// and nothing is read)
template <typename scalar_t>
__device__ inline void copy_scalar(scalar_t* dst, const scalar_t* row, int p,
                                   bool valid) {
  __pipeline_memcpy_async(dst, row + (valid ? p : 0), sizeof(scalar_t),
                          valid ? 0 : sizeof(scalar_t));
}

// The threads: CP warps a pattern row (C rounded up to a power of two),
// warp w taking category w % CP and lane l pattern l of its row, so each
// warp's loads and stores are whole 128-byte lines; a block row covers QB
// patterns (ops/staged.py block_patterns).
template <int C> struct Lanes {
  static constexpr int CP = C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : 8;
  static constexpr int QB = NW / CP * 32;
  int lane, w, c, cc, q;
  bool act;  // c < C; the other warps of a pattern row hold zeros
  __device__ Lanes()
      : lane(threadIdx.x & 31), w(threadIdx.x >> 5), c(w & (CP - 1)),
        cc(c < C ? c : 0), q((w / CP) * 32 + lane), act(c < C) {}
};

// The sum of v over the categories of a pattern, in the order c = 0 .. C -
// 1; every thread of the pattern gets it.
// buf: THREADS scalars of shared memory; every thread of the block calls it.
template <int C, typename scalar_t>
__device__ inline scalar_t category_sum(scalar_t v, scalar_t* buf) {
  using L = Lanes<C>;
  const L t;
  buf[t.c * L::QB + t.q] = v;
  __syncthreads();
  v = buf[t.q];
  for (int c = 1; c < C; ++c) v += buf[c * L::QB + t.q];
  __syncthreads();
  return v;
}

// v[0 .. N) summed over the lanes that differ in the lane bits M, 2M, ...,
// 16: each step sends half the values a lane holds to its partner and adds
// the half it keeps, so a lane ends with N / 2^steps sums, of entries base
// .. (or, once a lane holds one, the remaining steps add it whole and
// `owner` marks one lane of the pair).
template <typename scalar_t, int N, int M> struct Butterfly {
  __device__ static void run(scalar_t* v, int lane, int& base, bool& owner) {
    if constexpr (M < 32) {
      if constexpr (N > 1) {
        constexpr int H = N / 2;
        const bool up = lane & M;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const scalar_t send = up ? v[i] : v[i + H];
          const scalar_t keep = up ? v[i + H] : v[i];
          v[i] = keep + __shfl_xor_sync(FULL, send, M);
        }
        if (up) base += H;
        Butterfly<scalar_t, H, 2 * M>::run(v, lane, base, owner);
      } else {
        v[0] += __shfl_xor_sync(FULL, v[0], M);
        if (lane & M) owner = false;
        Butterfly<scalar_t, 1, 2 * M>::run(v, lane, base, owner);
      }
    }
  }
};

// v[0 .. V) of each thread summed over the block's threads of each category
// in a fixed order (the butterfly over a warp's lanes, then the category's
// warps in turn); entry i of category c goes to dst[(i / E) * C * E + c * E
// + i % E]. red: NW x V scalars. Every thread of the block calls it.
template <typename scalar_t, int C, int V, int E>
__device__ inline void block_sum(scalar_t* v, scalar_t* red,
                                 scalar_t* __restrict__ dst) {
  using L = Lanes<C>;
  const L t;
  int base = 0;
  bool owner = true;
  Butterfly<scalar_t, V, 1>::run(v, t.lane, base, owner);
  constexpr int held = V / 32 > 0 ? V / 32 : 1;
  if (owner)
#pragma unroll
    for (int i = 0; i < held; ++i) red[t.w * V + base + i] = v[i];
  __syncthreads();
  for (int u = threadIdx.x; u < C * V; u += THREADS) {
    const int c = u / V, i = u - c * V;
    scalar_t s = 0;
    for (int w = c; w < NW; w += L::CP) s += red[w * V + i];
    dst[(i / E) * C * E + c * E + i % E] = s;
  }
  __syncthreads();
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

// child ch's partials in category c: [4, P] rows (a tip's whatever c)
template <typename scalar_t>
__device__ inline const scalar_t* child_rows(const scalar_t* tips,
                                             const scalar_t* partials, int ch,
                                             int c, int T, int C, int P) {
  return ch < T ? tips + (size_t)ch * 4 * P
                : partials + ((size_t)(ch - T) * C + c) * 4 * P;
}

// x[b] <- child ch's partials (category c) at pattern p
template <typename scalar_t>
__device__ inline void load_child(const scalar_t* __restrict__ tips,
                                  const scalar_t* partials, int ch, int c,
                                  int T, int C, int P, int p, scalar_t x[4]) {
  const scalar_t* src = child_rows(tips, partials, ch, c, T, C, P);
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

// dst[b * P] = sum_a Pm[a, b] * o[a]: a child's cotangent
template <typename scalar_t>
__device__ inline void store_pt(const scalar_t* Pm, const scalar_t o[4],
                                scalar_t* dst, int P) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    scalar_t s = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) s += Pm[a * 4 + b] * o[a];
    dst[(size_t)b * P] = s;
  }
}

// K3''s patterns a thread at a wide level below the walk (ops/staged.py
// forward_ppt picks this or one a level): in float32 16 bytes of each row
// at C <= 4, 8 above, where the C x 4 partials of each pattern take more
// registers; one in float64, whose pairs took 5 % longer than one
template <typename scalar_t, int C> struct FwdPatterns {
  static constexpr int n = sizeof(scalar_t) == 8 ? 1 : C <= 4 ? 4 : 2;
};

// n consecutive scalars of a row as one load or store of n * sizeof bytes
template <typename scalar_t, int n> struct Pack {
  static_assert(n == 1, "one scalar");
  __device__ static void load(const scalar_t* p, scalar_t v[1]) { v[0] = *p; }
  __device__ static void store(scalar_t* p, const scalar_t v[1]) { *p = v[0]; }
};
template <> struct Pack<float, 2> {
  __device__ static void load(const float* p, float v[2]) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x, v[1] = u.y;
  }
  __device__ static void store(float* p, const float v[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <> struct Pack<float, 4> {
  __device__ static void load(const float* p, float v[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
  __device__ static void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// A thread's PPT consecutive patterns of one level, read and written as one
// vector a row (where PPT > 1, P is a multiple of PPT and every row is
// 16-byte aligned: run_forward checks)
template <typename scalar_t, int PPT> struct FwdRows {
  int p0;
  __device__ void load(const scalar_t* row, scalar_t v[PPT]) const {
    Pack<scalar_t, PPT>::load(row + p0, v);
  }
  __device__ void store(scalar_t* row, const scalar_t v[PPT]) const {
    Pack<scalar_t, PPT>::store(row + p0, v);
  }
};

// One level below the walk: grid (pattern tiles of FWD_THREADS x PPT,
// nodes of the level), each thread PPT consecutive patterns. With no walk
// (a switch past the last level) the root's level is launched here too and
// its launch computes site_log. smem: Ps [maxc, C, 16].
template <typename scalar_t, int C, int PPT>
__global__ void __launch_bounds__(FWD_THREADS)
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
  const int p0 = (blockIdx.x * FWD_THREADS + threadIdx.x) * PPT;
  const FwdRows<scalar_t, PPT> rows{p0};
  if (rows.p0 >= P) return;
  scalar_t res[C][4][PPT];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < PPT; ++i) res[c][a][i] = 1;
  for (int j = 0; j < maxc; ++j) {
    const int ch = __ldg(children + k * maxc + j);
    if (ch < 0) continue;  // a missing child contributes 1
    scalar_t x[4][PPT];
    if (ch < T)
#pragma unroll
      for (int b = 0; b < 4; ++b) rows.load(tips + ((size_t)ch * 4 + b) * P, x[b]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (ch >= T)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          rows.load(partials + (((size_t)(ch - T) * C + c) * 4 + b) * P,
                    x[b]);
      const scalar_t* Pm = Ps + (j * C + c) * 16;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          scalar_t y = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) y += Pm[a * 4 + b] * x[b][i];
          res[c][a][i] *= y;
        }
    }
  }
  const scalar_t tiny = Limits<scalar_t>::tiny();
  scalar_t m[PPT], lm[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    m[i] = tiny;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int a = 0; a < 4; ++a) m[i] = res[c][a][i] > m[i] ? res[c][a][i] : m[i];
    lm[i] = log_(m[i]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int i = 0; i < PPT; ++i) res[c][a][i] = res[c][a][i] / m[i];
      rows.store(partials + (((size_t)k * C + c) * 4 + a) * P, res[c][a]);
    }
  rows.store(logscale + (size_t)k * P, lm);
  if (k == I - 1) {
    // the root, with no walk: its level holds it alone, and every other
    // node's scaler was written by an earlier launch on the same stream
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = rows.p0 + i;
      scalar_t site = 0;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          site += __ldg(rootw + c * 4 + a) * res[c][a][i];
      site = site > tiny ? site : tiny;
      scalar_t log_sum = 0;
      for (int r = 0; r < I - 1; r += SUM_LOADS) {
        scalar_t v[SUM_LOADS];
#pragma unroll
        for (int u = 0; u < SUM_LOADS; ++u)
          v[u] = logscale[(size_t)min(r + u, I - 2) * P + p];
#pragma unroll
        for (int u = 0; u < SUM_LOADS; ++u)
          if (r + u < I - 1) log_sum += v[u];
      }
      site_log[p] = log_(site) + (lm[i] + log_sum);
    }
  }
}

// The top of a tree over many patterns in one launch (the chain walk):
// grid (blocks of FWD_THREADS / CP patterns), threads on (pattern,
// category), the CP lanes of a pattern adjacent in a warp (CP: C rounded up
// to a power of two; a padded lane repeats category C - 1 and stores
// nothing), each walking the nodes of `nodes` from position j0 to the root
// in turn, children first. A pattern's node depends on that pattern alone,
// so no lane waits on another pattern's: a node's 4 partials of a category
// are formed in registers from its children's (the stage's, written by
// earlier launches, or this lane's own from an earlier node: plain loads;
// a binary node's two children loaded at once), its max over (C, 4) met by
// shuffles over the pattern's lanes, and the rescaled partials and log m
// written to the stage. The site log sums the walked nodes' log m as they
// come, the stage's rows below the walk (the pattern's lanes taking every
// CP-th, SUM_LOADS loads in flight, then a butterfly) and the root's site.
template <typename scalar_t, int C>
__global__ void __launch_bounds__(FWD_THREADS)
    forward_chain(const scalar_t* __restrict__ tips,
                  const scalar_t* __restrict__ pmats,
                  const int* __restrict__ children,
                  const int* __restrict__ nodes,
                  const scalar_t* __restrict__ rootw, scalar_t* partials,
                  scalar_t* logscale, scalar_t* __restrict__ site_log, int T,
                  int I, int maxc, int P, int j0) {
  constexpr int CP = C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : 8;
  const int c = threadIdx.x & (CP - 1);
  const bool cin = c < C;
  const int cc = cin ? c : C - 1;
  const int p = blockIdx.x * (FWD_THREADS / CP) + threadIdx.x / CP;
  const bool valid = p < P;
  const int pc = valid ? p : P - 1;  // every lane loads; only these store
  const scalar_t tiny = Limits<scalar_t>::tiny();
  // x[b] <- child ch's partials of category cc at this pattern
  auto load = [&](int ch, scalar_t x[4]) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[b] = ch < T ? __ldg(tips + ((size_t)ch * 4 + b) * P + pc)
                    : partials[(((size_t)(ch - T) * C + cc) * 4 + b) * P + pc];
  };
  // res[a] *= (P_ch x)[a]
  auto times = [&](int ch, const scalar_t x[4], scalar_t res[4]) {
    const scalar_t* Pm = pmats + ((size_t)ch * C + cc) * 16;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      scalar_t y = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) y += __ldg(Pm + a * 4 + b) * x[b];
      res[a] *= y;
    }
  };
  scalar_t res[4], walked = 0;
  for (int j = j0; j < I; ++j) {
    const int k = __ldg(nodes + j);
#pragma unroll
    for (int a = 0; a < 4; ++a) res[a] = 1;
    const int c0 = __ldg(children + k * maxc);
    const int c1 = maxc == 2 ? __ldg(children + k * maxc + 1) : -1;
    if (c0 >= 0 && c1 >= 0) {
      scalar_t x0[4], x1[4];
      load(c0, x0);
      load(c1, x1);
      times(c0, x0, res);
      times(c1, x1, res);
    } else {
      for (int i = 0; i < maxc; ++i) {
        const int ch = __ldg(children + k * maxc + i);
        if (ch < 0) continue;  // a missing child contributes 1
        scalar_t x[4];
        load(ch, x);
        times(ch, x, res);
      }
    }
    scalar_t m = tiny;
#pragma unroll
    for (int a = 0; a < 4; ++a) m = cin && res[a] > m ? res[a] : m;
#pragma unroll
    for (int off = 1; off < CP; off <<= 1) {
      const scalar_t o = __shfl_xor_sync(FULL, m, off);
      m = o > m ? o : m;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      res[a] = res[a] / m;
      if (valid && cin)
        partials[(((size_t)k * C + c) * 4 + a) * P + p] = res[a];
    }
    const scalar_t lm = log_(m);
    if (valid && c == 0) logscale[(size_t)k * P + p] = lm;
    walked += lm;
  }
  // the root is the last node walked: res holds its partials
  scalar_t site = 0, below = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    site += cin ? __ldg(rootw + c * 4 + a) * res[a] : scalar_t(0);
  for (int j = c; j < j0; j += SUM_LOADS * CP) {
    scalar_t v[SUM_LOADS];
#pragma unroll
    for (int u = 0; u < SUM_LOADS; ++u)
      v[u] = logscale[(size_t)__ldg(nodes + min(j + u * CP, j0 - 1)) * P + pc];
#pragma unroll
    for (int u = 0; u < SUM_LOADS; ++u)
      if (j + u * CP < j0) below += v[u];
  }
#pragma unroll
  for (int off = 1; off < CP; off <<= 1) {
    site += __shfl_xor_sync(FULL, site, off);
    below += __shfl_xor_sync(FULL, below, off);
  }
  site = site > tiny ? site : tiny;
  if (valid && c == 0) site_log[p] = log_(site) + (below + walked);
}

// Root seed of the reverse sweep: grid (blocks of QB x ppt patterns),
// threads as Lanes<C>. gbuf[root] = rootw * g / site; drootw_part[block] =
// the sum over the block's patterns of root * g / site.
template <typename scalar_t, int C>
__global__ void __launch_bounds__(THREADS)
    backward_root(const scalar_t* __restrict__ partials,
                  const scalar_t* __restrict__ rootw,
                  const scalar_t* __restrict__ g, scalar_t* __restrict__ gbuf,
                  scalar_t* __restrict__ drootw_part, int I, int P, int ppt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* red = reinterpret_cast<scalar_t*>(smem_raw);
  scalar_t* buf = red + NW * 4;
  using L = Lanes<C>;
  const L t;
  const size_t rows = ((size_t)(I - 1) * C + t.cc) * 4 * P;
  const scalar_t* root = partials + rows;
  scalar_t* groot = gbuf + rows;
  scalar_t rw[4], dr[4] = {0, 0, 0, 0};
#pragma unroll
  for (int a = 0; a < 4; ++a) rw[a] = t.act ? __ldg(rootw + t.c * 4 + a) : 0;
  const scalar_t tiny = Limits<scalar_t>::tiny();
  const int p0 = blockIdx.x * L::QB * ppt;
  for (int it = 0; it < ppt; ++it) {
    const int p = p0 + it * L::QB + t.q;
    const bool in = p < P, valid = in && t.act;
    scalar_t r[4] = {0, 0, 0, 0}, s = 0;
    if (valid)
#pragma unroll
      for (int a = 0; a < 4; ++a) r[a] = root[(size_t)a * P + p];
#pragma unroll
    for (int a = 0; a < 4; ++a) s += rw[a] * r[a];
    scalar_t site = category_sum<C>(s, buf);
    site = site > tiny ? site : tiny;
    const scalar_t inv = in ? g[p] / site : scalar_t(0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (valid) groot[(size_t)a * P + p] = rw[a] * inv;
      dr[a] += r[a] * inv;
    }
  }
  block_sum<scalar_t, C, 4, 4>(dr, red,
                               drootw_part + (size_t)blockIdx.x * C * 4);
}

// A binary node k of the reverse sweep, one category a warp:
//   other_0 = gbuf[k, c] / m_k * u_1,  other_1 = gbuf[k, c] / m_k * u_0
//   dP[child i, c] += other_i x_i^T   (over the block's patterns)
//   gbuf[child i, c] = P_i^T other_i  (internal children only)
template <typename scalar_t, int C>
__device__ inline void backward_pair(
    const scalar_t* __restrict__ tips, const scalar_t* partials,
    const scalar_t* __restrict__ logscale, scalar_t* gbuf, const scalar_t* Ps,
    scalar_t* red, scalar_t* stage, scalar_t* __restrict__ out, int k,
    int ch0, int ch1, int T, int P, int ppt) {
  using L = Lanes<C>;
  const L t;
  scalar_t P0[16], P1[16], acc[32];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    P0[e] = Ps[t.cc * 16 + e];
    P1[e] = Ps[(C + t.cc) * 16 + e];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0;
  const scalar_t* x0s = child_rows(tips, partials, ch0, t.cc, T, C, P);
  const scalar_t* x1s = child_rows(tips, partials, ch1, t.cc, T, C, P);
  const scalar_t* gk = gbuf + ((size_t)k * C + t.cc) * 4 * P;
  const scalar_t* lk = logscale + (size_t)k * P;
  scalar_t* g0 =
      ch0 < T ? nullptr : gbuf + ((size_t)(ch0 - T) * C + t.cc) * 4 * P;
  scalar_t* g1 =
      ch1 < T ? nullptr : gbuf + ((size_t)(ch1 - T) * C + t.cc) * 4 * P;
  const int p0 = blockIdx.x * L::QB * ppt;
  // pattern it's STAGED scalars (log m, the cotangent, both children) are
  // copied into this thread's own slots of stage[it % BWD_DEPTH], BWD_DEPTH
  // - 1 patterns ahead of the arithmetic: each thread reads only what it
  // copied, so no barrier is needed
  auto prefetch = [&](int it) {
    if (it < ppt) {
      const int p = p0 + it * L::QB + t.q;
      const bool valid = t.act && p < P;
      scalar_t* s = stage + (size_t)(it % BWD_DEPTH) * STAGED * THREADS +
                    threadIdx.x;
      copy_scalar(s, lk, p, valid);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        copy_scalar(s + (1 + a) * THREADS, gk + (size_t)a * P, p, valid);
        copy_scalar(s + (5 + a) * THREADS, x0s + (size_t)a * P, p, valid);
        copy_scalar(s + (9 + a) * THREADS, x1s + (size_t)a * P, p, valid);
      }
    }
    __pipeline_commit();
  };
  for (int it = 0; it < BWD_DEPTH - 1; ++it) prefetch(it);
  for (int it = 0; it < ppt; ++it) {
    prefetch(it + BWD_DEPTH - 1);
    __pipeline_wait_prior(BWD_DEPTH - 1);
    const int p = p0 + it * L::QB + t.q;
    const bool valid = t.act && p < P;
    const scalar_t* s = stage + (size_t)(it % BWD_DEPTH) * STAGED * THREADS +
                        threadIdx.x;
    scalar_t x0[4], x1[4], u0[4], u1[4], o0[4], o1[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x0[a] = s[(5 + a) * THREADS];
      x1[a] = s[(9 + a) * THREADS];
    }
    // cotangent of the raw (pre-rescale) product: the max is a constant
    const scalar_t minv = valid ? exp_(-s[0]) : scalar_t(0);
    apply_p(P0, x0, u0);
    apply_p(P1, x1, u1);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const scalar_t ga = s[(1 + a) * THREADS] * minv;
      o0[a] = ga * u1[a];
      o1[a] = ga * u0[a];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        acc[a * 4 + b] += o0[a] * x0[b];
        acc[16 + a * 4 + b] += o1[a] * x1[b];
      }
    }
    if (valid) {
      if (g0) store_pt(P0, o0, g0 + p, P);
      if (g1) store_pt(P1, o1, g1 + p, P);
    }
  }
  block_sum<scalar_t, C, 32, 16>(acc, red, out);
}

// Any other node (a polytomy, or a missing child): one child at a time,
// every sibling's product recomputed for it
template <typename scalar_t, int C>
__device__ inline void backward_general(
    const scalar_t* __restrict__ tips, const scalar_t* partials,
    const scalar_t* __restrict__ logscale, scalar_t* gbuf,
    const int* __restrict__ children, const scalar_t* Ps, scalar_t* red,
    scalar_t* __restrict__ out, int k, int T, int maxc, int P, int ppt) {
  using L = Lanes<C>;
  const L t;
  const scalar_t* gk = gbuf + ((size_t)k * C + t.cc) * 4 * P;
  const int p0 = blockIdx.x * L::QB * ppt;
  for (int i = 0; i < maxc; ++i) {
    const int ch = __ldg(children + k * maxc + i);
    if (ch < 0) continue;  // block-uniform
    scalar_t Pi[16], acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      Pi[e] = Ps[(i * C + t.cc) * 16 + e];
      acc[e] = 0;
    }
    const scalar_t* xs = child_rows(tips, partials, ch, t.cc, T, C, P);
    scalar_t* gi =
        ch < T ? nullptr : gbuf + ((size_t)(ch - T) * C + t.cc) * 4 * P;
    for (int it = 0; it < ppt; ++it) {
      const int p = p0 + it * L::QB + t.q;
      const bool valid = t.act && p < P;
      scalar_t o[4] = {0, 0, 0, 0}, x[4] = {0, 0, 0, 0};
      if (valid) {
        const scalar_t minv = exp_(-logscale[(size_t)k * P + p]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          o[a] = gk[(size_t)a * P + p] * minv;
          x[a] = xs[(size_t)a * P + p];
        }
        for (int j = 0; j < maxc; ++j) {
          const int cj = __ldg(children + k * maxc + j);
          if (j == i || cj < 0) continue;
          scalar_t xj[4], u[4];
          load_child(tips, partials, cj, t.cc, T, C, P, p, xj);
          apply_p(Ps + (j * C + t.cc) * 16, xj, u);
#pragma unroll
          for (int a = 0; a < 4; ++a) o[a] *= u[a];
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a * 4 + b] += o[a] * x[b];
      if (valid && gi) store_pt(Pi, o, gi + p, P);
    }
    block_sum<scalar_t, C, 16, 16>(acc, red, out + i * C * 16);
  }
}

// One level of the reverse sweep: grid (blocks of QB x ppt patterns, nodes
// of the level), threads as Lanes<C>. Block (b, y) writes its per-block sums
// of d pmats for the children of node nodes[y] at dP_part + rows[2 y] +
// b * maxc * C * 16, laid out [maxc, C, 16].
// smem: Ps [maxc, C, 16], red [NW, 32], stage [BWD_DEPTH, STAGED, THREADS]
// (a binary node's).
template <typename scalar_t, int C>
__global__ void __launch_bounds__(THREADS,
                                  sizeof(scalar_t) == 4 ? BWD_BLOCKS : 1)
    backward_level(const scalar_t* __restrict__ tips,
                   const scalar_t* __restrict__ pmats,
                   const int* __restrict__ children,
                   const int* __restrict__ nodes,
                   const long long* __restrict__ rows,
                   const scalar_t* __restrict__ partials,
                   const scalar_t* __restrict__ logscale, scalar_t* gbuf,
                   scalar_t* __restrict__ dP_part, int T, int maxc, int P,
                   int ppt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* Ps = reinterpret_cast<scalar_t*>(smem_raw);
  scalar_t* red = Ps + maxc * 16 * C;
  scalar_t* stage = red + NW * 32;
  const int k = __ldg(nodes + blockIdx.y);
  stage_pmats(pmats, children, k, C, maxc, Ps);
  __syncthreads();
  scalar_t* out = dP_part + __ldg(rows + 2 * blockIdx.y) +
                  (size_t)blockIdx.x * maxc * C * 16;
  const int ch0 = __ldg(children + k * maxc);
  const int ch1 = maxc == 2 ? __ldg(children + k * maxc + 1) : -1;
  if (ch0 >= 0 && ch1 >= 0)
    backward_pair<scalar_t, C>(tips, partials, logscale, gbuf, Ps, red, stage,
                               out, k, ch0, ch1, T, P, ppt);
  else
    backward_general<scalar_t, C>(tips, partials, logscale, gbuf, children,
                                  Ps, red, out, k, T, maxc, P, ppt);
}

// The last pass: d pmats[child] = the sum of its per-block rows, the
// root's row zero; d rootw = the sum of drootw_part's rows. One output a
// lane, 32 a block: warp w sums rows w, w + NW, ... in order, then the NW
// warps' sums are added in order.
template <typename scalar_t>
__global__ void __launch_bounds__(THREADS)
    backward_sum(const scalar_t* __restrict__ dP_part,
                 const int* __restrict__ children,
                 const int* __restrict__ nodes,
                 const long long* __restrict__ rows,
                 const scalar_t* __restrict__ drootw_part, int root_blocks,
                 scalar_t* __restrict__ dP, scalar_t* __restrict__ drootw,
                 int I, int N, int C, int maxc) {
  __shared__ scalar_t red[NW][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long W = C * 16, n_dp = (long long)I * maxc * W;
  const long long u = (long long)blockIdx.x * 32 + lane;
  const scalar_t* src = nullptr;
  scalar_t* dst = nullptr;
  long long nb = 0, stride = 0;
  if (u < n_dp) {
    const int q = (int)(u / (maxc * W));
    const long long r = u - q * maxc * W;
    const int i = (int)(r / W);
    const int ch = __ldg(children + __ldg(nodes + q) * maxc + i);
    if (ch >= 0) {
      src = dP_part + __ldg(rows + 2 * q) + r;
      nb = __ldg(rows + 2 * q + 1);
      stride = maxc * W;
      dst = dP + ch * W + (r - i * W);
    }
  } else if (u < n_dp + W) {
    dst = dP + (N - 1) * W + (u - n_dp);  // the root is no node's child
  } else if (u < n_dp + W + C * 4) {
    src = drootw_part + (u - n_dp - W);
    nb = root_blocks;
    stride = C * 4;
    dst = drootw + (u - n_dp - W);
  }
  scalar_t s = 0;
  for (long long b = w; b < nb; b += NW) s += src[b * stride];
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && dst) {
    s = 0;
    for (int v = 0; v < NW; ++v) s += red[v][lane];
    *dst = s;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// K3''s walks of the top of the tree: the S = 4 walk of csrc/s4_forward.cuh
// (a TopOfStage), or the chain walk (forward_chain)
constexpr int WALK_S4 = 0;
constexpr int WALK_CHAIN = 1;

// The levels below `top` one launch each, the rest in one launch of the
// walk `walk`; top == n_levels: every level one launch, the root's
// computing site_log. Level l's threads take ppt[l] patterns (1 or
// FwdPatterns' n) as one vector where the rows allow (P a multiple of it,
// every base 16-byte aligned), else one.
template <typename scalar_t, int C>
cudaError_t run_forward(const scalar_t* tips, const scalar_t* pmats,
                        const int* children, const int* nodes,
                        const int* offsets, const int* dev_offsets,
                        const int* slots, const int* ppt, int n_levels,
                        int top, int walk, const scalar_t* rootw,
                        scalar_t* partials, scalar_t* logscale,
                        scalar_t* site_log, int T, int I, int maxc, int P,
                        int* launched, cudaStream_t stream) {
  constexpr int V = FwdPatterns<scalar_t, C>::n;
  const size_t smem = (size_t)maxc * C * 16 * sizeof(scalar_t);
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
  };
  const bool vec = P % V == 0 && aligned(tips) && aligned(partials) &&
                   aligned(logscale);
  const auto one = forward_level<scalar_t, C, 1>;
  const auto wide = forward_level<scalar_t, C, V>;
  cudaError_t e = cudaSuccess;
  if (top > 0) {
    if ((e = allow_smem(one, smem)) != cudaSuccess) return e;
    if ((e = allow_smem(wide, smem)) != cudaSuccess) return e;
  }
  for (int l = 0; l < top; ++l) {
    if (ppt[l] != 1 && ppt[l] != V) return cudaErrorInvalidValue;
    const bool w = ppt[l] == V && vec;
    const auto level = w ? wide : one;
    const int span = FWD_THREADS * (w ? V : 1);
    const dim3 grid((P + span - 1) / span, offsets[l + 1] - offsets[l]);
    level<<<grid, FWD_THREADS, smem, stream>>>(
        tips, pmats, children, nodes + offsets[l], rootw, partials, logscale,
        site_log, T, I, maxc, P);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ++*launched;
  }
  if (top == n_levels) return cudaSuccess;
  if (walk == WALK_CHAIN) {
    constexpr int per_block = FWD_THREADS / Lanes<C>::CP;
    forward_chain<scalar_t, C>
        <<<(P + per_block - 1) / per_block, FWD_THREADS, 0, stream>>>(
            tips, pmats, children, nodes, rootw, partials, logscale,
            site_log, T, I, maxc, P, offsets[top]);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
    return e;
  }
  e = launch_s4_forward<scalar_t>(
      tips, pmats, children, nodes, dev_offsets, n_levels,
      RootWeights<scalar_t>{rootw, nullptr}, partials, logscale, site_log, T,
      I, C, maxc, P, 1, 1, stream, TopOfStage{slots, top},
      I - offsets[top]);
  if (e == cudaSuccess) ++*launched;
  return e;
}

template <typename scalar_t, int C>
cudaError_t run_backward(const scalar_t* tips, const scalar_t* pmats,
                         const int* children, const int* nodes,
                         const int* offsets, int n_levels, const int* ppt,
                         const long long* rows, const scalar_t* rootw,
                         const scalar_t* partials, const scalar_t* logscale,
                         const scalar_t* g, scalar_t* gbuf, scalar_t* dP_part,
                         scalar_t* drootw_part, scalar_t* dP,
                         scalar_t* drootw, int T, int I, int maxc, int P,
                         cudaStream_t stream) {
  constexpr int QB = Lanes<C>::QB;
  const size_t smem =
      ((size_t)maxc * 16 * C + NW * 32 +
       (maxc == 2 ? (size_t)BWD_DEPTH * STAGED * THREADS : 0)) *
      sizeof(scalar_t);
  cudaError_t e = allow_smem(backward_level<scalar_t, C>, smem);
  if (e != cudaSuccess) return e;
  const int root_ppt = ppt[n_levels - 1];
  const int root_blocks = (P + QB * root_ppt - 1) / (QB * root_ppt);
  backward_root<scalar_t, C>
      <<<root_blocks, THREADS, (NW * 4 + THREADS) * sizeof(scalar_t),
         stream>>>(
          partials, rootw, g, gbuf, drootw_part, I, P, root_ppt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  for (int l = n_levels - 1; l >= 0; --l) {
    const dim3 grid((P + QB * ppt[l] - 1) / (QB * ppt[l]),
                    offsets[l + 1] - offsets[l]);
    backward_level<scalar_t, C><<<grid, THREADS, smem, stream>>>(
        tips, pmats, children, nodes + offsets[l], rows + 2 * offsets[l],
        partials, logscale, gbuf, dP_part, T, maxc, P, ppt[l]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long n = (long long)I * maxc * C * 16 + C * 16 + C * 4;
  backward_sum<scalar_t><<<(unsigned)((n + 31) / 32), THREADS, 0, stream>>>(
      dP_part, children, nodes, rows, drootw_part, root_blocks, dP, drootw, I,
      T + I, C, maxc);
  return cudaGetLastError();
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
                           const int* offsets, const void* dev_offsets,
                           const void* slots, const int* ppt, int n_levels,
                           int top, int walk, const void* rootw,
                           void* partials, void* logscale, void* site_log,
                           int T, int I,
                           int C, int maxc, int P, int* launched,
                           cudaStream_t stream) {
  *launched = 0;
  if (maxc < 1 || n_levels < 1 || top < 0 || top > n_levels ||
      (walk != WALK_S4 && walk != WALK_CHAIN))
    return cudaErrorInvalidValue;
#define PHYSHER_FWD(CC)                                                       \
  run_forward<scalar_t, CC>(                                                  \
      static_cast<const scalar_t*>(tips), static_cast<const scalar_t*>(pmats), \
      static_cast<const int*>(children), static_cast<const int*>(nodes),      \
      offsets, static_cast<const int*>(dev_offsets),                          \
      static_cast<const int*>(slots), ppt, n_levels, top, walk,               \
      static_cast<const scalar_t*>(rootw), static_cast<scalar_t*>(partials),  \
      static_cast<scalar_t*>(logscale), static_cast<scalar_t*>(site_log), T,  \
      I, maxc, P, launched, stream)
  PHYSHER_STAGED_CASES(PHYSHER_FWD)
#undef PHYSHER_FWD
}

template <typename scalar_t>
cudaError_t launch_backward(const void* tips, const void* pmats,
                            const void* children, const void* nodes,
                            const int* offsets, int n_levels, const int* ppt,
                            const void* rows, const void* rootw,
                            const void* partials, const void* logscale,
                            const void* g, void* gbuf, void* dP_part,
                            void* drootw_part, void* dP, void* drootw, int T,
                            int I, int C, int maxc, int P,
                            cudaStream_t stream) {
  if (maxc < 1 || n_levels < 1) return cudaErrorInvalidValue;
  for (int l = 0; l < n_levels; ++l)
    if (ppt[l] < 1) return cudaErrorInvalidValue;
#define PHYSHER_BWD(CC)                                                       \
  run_backward<scalar_t, CC>(                                                 \
      static_cast<const scalar_t*>(tips), static_cast<const scalar_t*>(pmats), \
      static_cast<const int*>(children), static_cast<const int*>(nodes),      \
      offsets, n_levels, ppt, static_cast<const long long*>(rows),            \
      static_cast<const scalar_t*>(rootw),                                    \
      static_cast<const scalar_t*>(partials),                                 \
      static_cast<const scalar_t*>(logscale), static_cast<const scalar_t*>(g), \
      static_cast<scalar_t*>(gbuf), static_cast<scalar_t*>(dP_part),          \
      static_cast<scalar_t*>(drootw_part), static_cast<scalar_t*>(dP),        \
      static_cast<scalar_t*>(drootw), T, I, maxc, P, stream)
  PHYSHER_STAGED_CASES(PHYSHER_BWD)
#undef PHYSHER_BWD
}

#undef PHYSHER_STAGED_CASES

}  // namespace

extern "C" {

#define PHYSHER_STAGED_ENTRY(SUFFIX, TYPE)                                     \
  cudaError_t staged_forward_##SUFFIX(                                         \
      const void* tips, const void* pmats, const void* children,               \
      const void* nodes, const int* offsets, const void* dev_offsets,          \
      const void* slots, const int* ppt, int n_levels, int top, int walk,      \
      const void* rootw, void* partials, void* logscale, void* site_log,       \
      int T, int I, int C, int maxc, int P, int* launched, void* stream) {     \
    return launch_forward<TYPE>(tips, pmats, children, nodes, offsets,         \
                                dev_offsets, slots, ppt, n_levels, top, walk,  \
                                rootw, partials, logscale, site_log, T, I, C,  \
                                maxc, P, launched,                             \
                                static_cast<cudaStream_t>(stream));            \
  }                                                                            \
  cudaError_t staged_backward_##SUFFIX(                                        \
      const void* tips, const void* pmats, const void* children,               \
      const void* nodes, const int* offsets, int n_levels, const int* ppt,     \
      const void* rows, const void* rootw, const void* partials,               \
      const void* logscale, const void* g, void* gbuf, void* dP_part,          \
      void* drootw_part, void* dP, void* drootw, int T, int I, int C,          \
      int maxc, int P, void* stream) {                                         \
    return launch_backward<TYPE>(                                              \
        tips, pmats, children, nodes, offsets, n_levels, ppt, rows, rootw,     \
        partials, logscale, g, gbuf, dP_part, drootw_part, dP, drootw, T, I,   \
        C, maxc, P, static_cast<cudaStream_t>(stream));                        \
  }

PHYSHER_STAGED_ENTRY(f32, float)
PHYSHER_STAGED_ENTRY(f64, double)

#undef PHYSHER_STAGED_ENTRY

}  // extern "C"
