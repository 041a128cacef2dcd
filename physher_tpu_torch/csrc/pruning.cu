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
// Any other state count, S from 2 to 64 (protein S = 20, codon S = 61): K1'
// and K2', the same function with the layouts above at S in place of 4, in
// both of the TPU kernel's modes (ops/fused.py picks one by the TPU
// wrapper's rule, _needs_csplit):
// - packed: the categories of a pattern block meet in a thread-block
//   cluster for the per-pattern max over (C, S) and the root's sum;
// - category-split: each category is a sweep of its own, as the TPU kernel
//   runs it (once per category at C = 1, the states padded to 8): its own
//   max over S and scalers (scale [C, I, P]), no cluster and no barrier
//   across categories, and per-category site logs
//   log(max(rootw_c . root_c, tiny)) + sum_k log m_k^c [C, P], which the
//   caller combines by a logsumexp over c. The reverse sweep takes the
//   per-category cotangent that autograd gives from that logsumexp and runs
//   each category's reverse step from the forward's partials and scalers;
//   the TPU kernel must recompute the forward (it keeps no partials).
// What bounds them: the FLOPs of the node products, as K5''s and K6''s
// (csrc/loop.cu): 2 S^2 a (branch, category, pattern) forward, 6 S^2 above
// an internal node and 4 S^2 above a tip backward (chip_smoke.pruning_work;
// 0.029 / 0.070 ms at GY94 M0 32 x 4096, 0.063 / 0.124 at WAG+G4 64 x
// 8192). One launch a sweep each, on the node steps that K5'/K6' and
// K7'/K8' share (WideForwardStep, WideBackwardStep). The TPU grid runs in
// order on one core, so its kernel walks every node in one grid step; a
// walk in one block per (pattern block, category) fills a tenth of the
// card at GY94 32 x 4096 (32 blocks) and a fifth at WAG 64 x 8192, where it
// took 3.1x and 1.9x K8', which gives every node of a level its own
// blocks. So each sweep has two kernels, and ops/fused.walks picks one a
// call (no launch a level, no host synchronisation, no memset: a CUDA
// graph carries one kernel):
// - The walk (fused_wide_forward_walk, fused_wide_backward_walk: the
//   walks of K5'/K6') where its blocks fill at least half of the card's
//   resident blocks (WAG+G4 64 x 8192 in float32 backward, float64 both
//   ways) or the tree is a chain (a caterpillar), which no schedule
//   spreads.
// - Elsewhere the tree's schedule (fused_wide_forward_tree,
//   fused_wide_backward_tree). K1': a block per (node whose children are
//   all tips, pattern block, category) runs its node step and goes on up
//   the tree; at a parent of several internal children the last block to
//   arrive at the parent's counter goes on and the others leave
//   (ops/fused.forward_plan), so no block waits and the grid is as wide as
//   the tree. K2': a persistent grid claims (node, or where a preorder
//   level holds at most one (node, pattern block, category) an SM, one
//   child of a node, as K8' splits it; pattern block; category) items in
//   preorder-level order from a counter and waits on the item's node's
//   flag; the item that wrote a node's cotangent rows sets the flag, and
//   goes on itself with the node's lead item, at its tallest internal
//   child, so a chain of nodes pays no hand-off (ops/fused.backward_plan).
// Measured on an H100 in float32 (chip_profile.py --fused-wide): the tree
// takes K2' at GY94 from 3.6x to 0.95x K8' and K1' there from 1.4x to 0.97x
// K7'. Tried and dropped: the tree's schedule where the walk fills the
// card (K2' 4 % slower than the walk in float32; K2' 5 % and K1' 27 % in
// float64) and on a caterpillar in float32 (1.19x the walk; in float64 it
// is 0.79x: the tree kernel's steps run slower in float32, for a cause
// not measured); every item claimed, no chain continued (0-12 % slower);
// levels split by child up to the resident blocks (1-10 % slower); the
// walk as a plan of the tree
// kernel (1.11-1.15x the walk kernel in float32 with the loop's item in
// shared memory, 1.20-1.51x with it in registers across the step). Waiting
// blocks poll with volatile loads and fence once (load.acquire at every
// poll was dropped with the registers' loop state; not measured apart).
// Counters and flags come back to zero inside each launch (the last
// arrival, the last claim and the waiting items reset them), so a CUDA
// graph replays a sweep; each output row is written by one item in a fixed
// order, so a sweep is bit-identical run to run and the two kernels'
// outputs agree bit for bit. The per-block dP scratch is
// ceil(P / 128) x N x C x S^2 scalars (52 MB at WAG+G4 64 x 8192 in
// float32).

#include <cuda_runtime.h>

#include <algorithm>

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

// K1' for S != 4 as a walk: grid (pattern blocks of one step, C). A block
// walks the whole postorder at category c for its patterns (128 at S <= 32,
// 32 above), one WideForwardStep a node, then the root (forward_walk,
// csrc/wide_forward.cuh, which K5' at S != 4 shares). Packed: the C blocks
// of a pattern block form one cluster and meet for each node's max over
// (C, S) and for the root's sum over categories; site_log [P]. Category-
// split (csplit): no cluster, each category its own max and scalers
// (scale [C, I, P]) and its own row of site_log [C, P]. Registers as K5''s.
template <typename scalar_t, int A, int CP>
__global__ void __launch_bounds__(THREADS, sizeof(scalar_t) == 4 ? 4 : 2)
    fused_wide_forward_walk(const scalar_t* __restrict__ tips,
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

// K2' for S != 4 as a walk: grid (pattern blocks of BWD_P, C). A block
// zeroes the root's dP rows of category c (the root is no node's child),
// seeds it at the root and walks the reverse postorder for its 128
// patterns, one WideBackwardStep a node (backward_walk,
// csrc/wide_backward.cuh, which K6' at S != 4 shares), from the forward's
// partials and scalers: it never recomputes the forward. With csplit, the
// scalers and the cotangent g are category c's (scale [C, I, P], g [C, P]:
// g times exp(site_c - site_log), from the logsumexp outside the kernel).
// gbuf [I, C, S, P]; dP_part [nb, N, C, S, S] and drootw_part [nb, C, S],
// which the caller sums over the blocks: no atomics. Registers as K6''s.
template <typename scalar_t, int A, int CP>
__global__ void __launch_bounds__(THREADS,
                                  sizeof(scalar_t) == 4 ? (CP == 4 ? 2 : 3)
                                                        : 1)
    fused_wide_backward_walk(
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
  scalar_t* dP = dP_part + (size_t)blockIdx.x * N * C * S * S;
  for (int t = threadIdx.x; t < S * S; t += blockDim.x)
    dP[((size_t)(N - 1) * C + c) * S * S + t] = 0;
  backward_walk<scalar_t, A, CP>(
      tips, pmats, children, partials,
      csplit ? scale + (size_t)c * I * P : scale, gbuf, dP,
      drootw_part + ((size_t)blockIdx.x * C + c) * S,
      StateWeights<scalar_t>{rootw, nullptr, S},
      csplit ? g + (size_t)c * P : g, smem_raw, T, I, C, S, maxc, P, c,
      blockIdx.x * BWD_P, csplit);
}

// The schedule's hand-offs between blocks of one launch. A release is a
// barrier (every thread's stores are issued), then thread 0's release
// store, or its acq_rel fence and atomic; an acquire is thread 0's strong
// load (or atomic), its acq_rel fence, then a barrier. A waiting block
// polls with volatile loads, which leave its SM's L1 alone, and fences
// once. The counters and flags live in a per-device workspace that starts
// at zero, and every launch leaves them at zero: a CUDA graph replays the
// launch with the same pointers.
__device__ inline void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ inline void store_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;\n"
               :
               : "l"(p), "r"(v)
               : "memory");
}

// Thread 0: until *flag is set; then takes one off it (the last of its
// readers leaves 0) and acquires its writer's stores
__device__ inline void wait_flag(int* flag) {
  while (!*reinterpret_cast<volatile int*>(flag)) __nanosleep(100);
  atomicSub(flag, 1);
  fence_acq_rel();
}

// Thread 0: one of n arrivals at *count; true for the last, which resets
// the count to 0 and acquires the other arrivals' stores
__device__ inline bool arrive(int* count, int n) {
  fence_acq_rel();  // release this block's stores
  const bool last = atomicAdd(count, 1) == n - 1;
  if (last) {
    atomicExch(count, 0);
    fence_acq_rel();
  }
  return last;
}

// Whether this block (with `cluster`, its cluster of C blocks, deciding as
// one) is the last of n to arrive at *count: the block's (cluster's)
// partials and scalers are written first
__device__ inline bool last_arrival(int* count, int n, bool cluster) {
  __shared__ int last;
  __syncthreads();
  if (!cluster) {
    if (threadIdx.x == 0) last = arrive(count, n);
    __syncthreads();
    return last;
  }
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) fence_acq_rel();
  cl.sync();  // every block of the cluster has released its stores
  if (cl.block_rank() == 0 && threadIdx.x == 0) last = arrive(count, n);
  cl.sync();
  const bool l = *cl.map_shared_rank(&last, 0);
  if (l && threadIdx.x == 0) fence_acq_rel();  // acquire on this SM too
  __syncthreads();
  return l;
}

// K1' for S != 4 on the tree: the forward sweep of one chain in one launch,
// its (node, pattern block, category) steps on as many blocks as the
// tree's width gives. A block starts at a node whose children are all tips
// (`starts`; grid.x: those nodes x pattern blocks of one step, grid.y: C),
// runs its WideForwardStep (csrc/wide_forward.cuh, K5''s and K7''s node
// step) and goes on to the node's parent (`next`): at once where it has
// one internal child, else only if it is the last of its `need` internal
// children's blocks to arrive at its counter (`arrivals` [I, pattern
// blocks, C]), so no block ever waits. The root's block sums log m over
// every node in rank order from the scalers, as the walk sums it, and
// writes site_log. Packed: the C blocks of a pattern block form one cluster, meet
// for each node's max over (C, S) and the root's sum, and arrive as one;
// site_log [P]. Category-split (csplit): no cluster, each category its own
// max, scalers (scale [C, I, P]) and row of site_log [C, P]. The partials
// and scalers are those of the walk (forward_walk) bit for bit. Registers
// as K5''s.
template <typename scalar_t, int A, int CP>
__global__ void __launch_bounds__(THREADS, sizeof(scalar_t) == 4 ? 4 : 2)
    fused_wide_forward_tree(const scalar_t* __restrict__ tips,
                            const scalar_t* __restrict__ pmats,
                            const int* __restrict__ children,
                            const scalar_t* __restrict__ rootw,
                            scalar_t* partials, scalar_t* scale,
                            scalar_t* __restrict__ site_log,
                            const int* __restrict__ next,
                            const int* __restrict__ need,
                            const int* __restrict__ starts, int* arrivals,
                            int T, int I, int C, int S, int maxc, int P,
                            int csplit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Step = WideForwardStep<scalar_t, A, CP>;
  const int c = blockIdx.y;
  const int nq = (P + Step::TQ - 1) / Step::TQ;
  const int q = blockIdx.x % nq;
  const bool cluster = C > 1 && !csplit;
  scalar_t* sc = csplit ? scale + (size_t)c * I * P : scale;
  const Step step(tips, pmats, children, partials, sc, smem_raw, T, C, S,
                  maxc, P, c, q * Step::TQ, 1, csplit);
  int k = __ldg(starts + blockIdx.x / nq);
  scalar_t x[A];
  for (int slot = 0;; slot ^= 1) {
    step.node(k, slot, x);
    const int up = __ldg(next + k);
    if (up < 0) break;  // the root
    const int n = __ldg(need + up);
    if (n > 1 && !last_arrival(arrivals + ((size_t)up * nq + q) * C +
                                   (cluster ? 0 : c),
                               n, cluster)) {
      // no block of the cluster leaves while another reads its `last`
      if (cluster) cg::this_cluster().sync();
      return;
    }
    k = up;
  }
  // log m over every node in rank order, as the walk sums it
  scalar_t log_sum = 0;
  if (step.sc && step.wi == 0 && step.p < P) {
#pragma unroll 8
    for (int j = 0; j < I; ++j) log_sum += log_(sc[(size_t)j * P + step.p]);
  }
  step.root(StateWeights<scalar_t>{rootw, nullptr, S}, x, log_sum,
            csplit ? site_log + (size_t)c * P : site_log);
}

// Thread 0 of a K2' block: claims the next of `total` (item, pattern block,
// category) from the counter sync[0] (the launch's last claim resets it)
// and, for an item that waits, waits for its node's flag; writes it to
// *item, *pb, *c, or item->x = -1 when none is left
__device__ inline void claim_item(const int4* __restrict__ items,
                                  const int* __restrict__ claims, int* flags,
                                  int* sync, int total, int nb, int C,
                                  int4* item, int* pb, int* c) {
  const int q = atomicAdd(sync, 1);
  if (q == total + (int)gridDim.x - 1) atomicExch(sync, 0);
  if (q >= total) {
    item->x = -1;
    return;
  }
  const int per = nb * C, e = q / per, r = q - e * per;
  const int4 it = __ldg(items + __ldg(claims + e));
  *item = it;
  *pb = r / C;
  *c = r - *pb * C;
  if ((it.w & 3) == 1) wait_flag(flags + ((size_t)it.x * nb + *pb) * C + *c);
}

// K2' for S != 4 on the tree: the reverse sweep of one chain in one launch,
// on a
// persistent grid (as many blocks as the card keeps resident). Its work
// items (`items` [n, 4]: node rank, child index or -1 for all children,
// the item to continue with or -1, and 0 / 1 / 2 for continued / waits /
// the root's seed, plus 4 where it sets a flag) run at each (pattern
// block of BWD_P, category), by
// WideBackwardStep (csrc/wide_backward.cuh, K6''s and K8''s node step):
// pair or polytomy at a node, child at one child of a node where the level
// is narrow (as K8' splits it). Blocks claim the items of `claims` in order
// (preorder level, root first; flattened with the pattern blocks and
// categories) from the counter sync[0], and a claimed item waits on its
// node's flag (sync[1 + (k x pattern blocks + block) x C + c]), which the
// item that wrote the node's cotangent rows sets to its number of waiting
// items (`consumers`); each of them takes one off, so the flags end at 0,
// and the launch's last claim resets the counter. A block that finishes an
// item goes on with its `continue` item (the first internal child it wrote)
// at the same pattern block and category, with no hand-off. Every item
// waits only on an item claimed before its own (or on the chain of one), so
// no block waits on a block that is not running. The root's seed item
// writes gbuf[root, c], d rootw and the root's zero rows of dP_part (the
// root is no node's child). With csplit, the scalers and the cotangent g
// are category c's (scale [C, I, P], g [C, P]). gbuf [I, C, S, P]; dP_part
// [nb, N, C, S, S] and drootw_part [nb, C, S], summed by the caller over
// the blocks: each row written by one item, no atomics. Registers as K6''s.
template <typename scalar_t, int A, int CP>
__global__ void __launch_bounds__(THREADS,
                                  sizeof(scalar_t) == 4 ? (CP == 4 ? 2 : 3)
                                                        : 1)
    fused_wide_backward_tree(
        const scalar_t* __restrict__ tips, const scalar_t* __restrict__ pmats,
        const int* __restrict__ children, const scalar_t* __restrict__ rootw,
        const scalar_t* __restrict__ partials,
        const scalar_t* __restrict__ scale, const scalar_t* __restrict__ g,
        scalar_t* gbuf, scalar_t* __restrict__ dP_part,
        scalar_t* __restrict__ drootw_part, const int4* __restrict__ items,
        const int* __restrict__ claims, const int* __restrict__ consumers,
        int* sync, int n_claims, int T, int I, int C, int S, int maxc, int P,
        int csplit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the block's item (node, child or -1, next item or -1, kind | 4 where
  // it publishes) and its pattern block and category, in shared memory so
  // that no register holds them across a step
  __shared__ int4 item;
  __shared__ int item_pb, item_c;
  const auto sm = WideSmem<scalar_t>::template at<A, CP>(smem_raw, S);
  zero_spare_o_rows<scalar_t, A, CP>(sm.Os);
  const int N = T + I, nb = (P + BWD_P - 1) / BWD_P;
  int* const flags = sync + 1;
  if (threadIdx.x == 0)
    claim_item(items, claims, flags, sync, n_claims * nb * C, nb, C, &item,
               &item_pb, &item_c);
  __syncthreads();
  while (item.x >= 0) {
    const int k = item.x, part = item.y, pb = item_pb, c = item_c;
    scalar_t* dP = dP_part + (size_t)pb * N * C * S * S;
    if ((item.w & 3) == 2) {  // the root's seed, and its zero dP rows
      backward_seed(partials, gbuf, drootw_part + ((size_t)pb * C + c) * S,
                    StateWeights<scalar_t>{rootw, nullptr, S},
                    csplit ? g + (size_t)c * P : g, sm.Os, I, C, S, P, c,
                    pb * BWD_P, csplit);
      for (int t = threadIdx.x; t < S * S; t += blockDim.x)
        dP[((size_t)(N - 1) * C + c) * S * S + t] = 0;
      const int n = __ldg(consumers + k);
      if (n && threadIdx.x == 0)
        store_release(flags + ((size_t)k * nb + pb) * C + c, n);
    }
    const WideBackwardStep<scalar_t, A, CP> step(
        tips, pmats, children, partials,
        csplit ? scale + (size_t)c * I * P : scale, gbuf, dP, sm, T, C, S,
        maxc, P, c, pb * BWD_P, min(pb * BWD_P + BWD_P, P));
    if (part >= 0)
      step.child(k, part);
    else if (maxc <= 2)
      step.pair(k);
    else
      step.polytomy(k);
    __syncthreads();  // the item's stores are issued, and `item` is read
    if (threadIdx.x == 0) {
      const int4 done = item;
      if (done.w & 4) {
        // the children whose cotangent rows it wrote and others wait on
        const int j1 = done.y < 0 ? maxc : done.y + 1;
        for (int j = done.y < 0 ? 0 : done.y; j < j1; ++j) {
          const int ch = __ldg(children + (size_t)done.x * maxc + j) - T;
          const int n = ch >= 0 ? __ldg(consumers + ch) : 0;
          if (n)
            store_release(flags + ((size_t)ch * nb + item_pb) * C + item_c,
                          n);
        }
      }
      if (done.z >= 0)
        item = __ldg(items + done.z);  // at the same block and category
      else
        claim_item(items, claims, flags, sync, n_claims * nb * C, nb, C,
                   &item, &item_pb, &item_c);
    }
    __syncthreads();
  }
}

bool wide_bad_dims(int C, int S, int maxc) {
  return S < 2 || S > MAX_S || C < 1 || C > MAX_C || maxc < 1;
}

// CUDA launches made by the two entries below (one a sweep), which a
// profiler may stop seeing
long fused_wide_launches = 0;

template <typename scalar_t, int A, int CP> struct FusedWideForward {
  static cudaError_t per_sm(int S, int* blocks) {
    const auto kernel = fused_wide_forward_tree<scalar_t, A, CP>;
    const size_t smem =
        WideForwardStep<scalar_t, A, CP>::smem_scalars(S) * sizeof(scalar_t);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         THREADS, smem);
  }
  static cudaError_t run(const void* tips, const void* pmats,
                         const void* children, const void* rootw,
                         void* partials, void* scale, void* site_log,
                         const void* next, const void* need,
                         const void* starts, void* sync, int n_starts, int T,
                         int I, int C, int S, int maxc, int P, int csplit,
                         int walk, cudaStream_t stream) {
    using Step = WideForwardStep<scalar_t, A, CP>;
    const size_t smem = Step::smem_scalars(S) * sizeof(scalar_t);
    const int nq = (P + Step::TQ - 1) / Step::TQ;
    ++fused_wide_launches;
    if (walk)
      return launch_clusters(
          fused_wide_forward_walk<scalar_t, A, CP>, dim3(nq, C, 1), smem,
          stream, !csplit, static_cast<const scalar_t*>(tips),
          static_cast<const scalar_t*>(pmats),
          static_cast<const int*>(children),
          static_cast<const scalar_t*>(rootw),
          static_cast<scalar_t*>(partials), static_cast<scalar_t*>(scale),
          static_cast<scalar_t*>(site_log), T, I, C, S, maxc, P, csplit);
    const long blocks = (long)n_starts * nq;
    if (n_starts < 1 || blocks > 0x7fffffffL) return cudaErrorInvalidValue;
    return launch_clusters(
        fused_wide_forward_tree<scalar_t, A, CP>,
        dim3((unsigned)blocks, C, 1), smem, stream, !csplit,
        static_cast<const scalar_t*>(tips),
        static_cast<const scalar_t*>(pmats),
        static_cast<const int*>(children),
        static_cast<const scalar_t*>(rootw), static_cast<scalar_t*>(partials),
        static_cast<scalar_t*>(scale), static_cast<scalar_t*>(site_log),
        static_cast<const int*>(next), static_cast<const int*>(need),
        static_cast<const int*>(starts), static_cast<int*>(sync) + 1, T, I,
        C, S, maxc, P, csplit);
  }
};

// The persistent grid of K2': the blocks of the kernel the card keeps
// resident at once (blocks an SM x SMs), at most one an item
template <typename scalar_t, int A, int CP> struct FusedWideBackward {
  static size_t smem(int S) {
    return WideTiles<scalar_t, A, CP>::smem_scalars(S) * sizeof(scalar_t);
  }
  static cudaError_t per_sm(int S, int* blocks) {
    const auto kernel = fused_wide_backward_tree<scalar_t, A, CP>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem(S));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         THREADS, smem(S));
  }
  static cudaError_t run(const void* tips, const void* pmats,
                         const void* children, const void* rootw,
                         const void* partials, const void* scale,
                         const void* g, void* gbuf, void* dP_part,
                         void* drootw_part, const void* items,
                         const void* claims, const void* consumers,
                         void* sync, int n_claims, int T, int I, int C, int S,
                         int maxc, int P, int csplit, int walk,
                         cudaStream_t stream) {
    const int nb = (P + BWD_P - 1) / BWD_P;
    if (walk) {
      const auto kernel = fused_wide_backward_walk<scalar_t, A, CP>;
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem(S));
      if (e != cudaSuccess) return e;
      ++fused_wide_launches;
      kernel<<<dim3(nb, C, 1), THREADS, smem(S), stream>>>(
          static_cast<const scalar_t*>(tips),
          static_cast<const scalar_t*>(pmats),
          static_cast<const int*>(children),
          static_cast<const scalar_t*>(rootw),
          static_cast<const scalar_t*>(partials),
          static_cast<const scalar_t*>(scale),
          static_cast<const scalar_t*>(g), static_cast<scalar_t*>(gbuf),
          static_cast<scalar_t*>(dP_part),
          static_cast<scalar_t*>(drootw_part), T, I, C, S, maxc, P, csplit);
      return cudaGetLastError();
    }
    int device, sms, blocks;
    cudaError_t e = per_sm(S, &blocks);
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (e != cudaSuccess) return e;
    const long total = (long)n_claims * nb * C;
    const long grid = std::min(total, (long)blocks * sms);
    if (n_claims < 1 || blocks < 1 || total + grid > 0x7fffffffL)
      return cudaErrorInvalidValue;
    ++fused_wide_launches;
    fused_wide_backward_tree<scalar_t, A, CP>
        <<<(unsigned)grid, THREADS, smem(S), stream>>>(
            static_cast<const scalar_t*>(tips),
            static_cast<const scalar_t*>(pmats),
            static_cast<const int*>(children),
            static_cast<const scalar_t*>(rootw),
            static_cast<const scalar_t*>(partials),
            static_cast<const scalar_t*>(scale),
            static_cast<const scalar_t*>(g), static_cast<scalar_t*>(gbuf),
            static_cast<scalar_t*>(dP_part),
            static_cast<scalar_t*>(drootw_part),
            static_cast<const int4*>(items), static_cast<const int*>(claims),
            static_cast<const int*>(consumers), static_cast<int*>(sync),
            n_claims, T, I, C, S, maxc, P, csplit);
    return cudaGetLastError();
  }
};

// Blocks of K1' (backward: of K2') at S states that one SM keeps resident
template <typename scalar_t, int A, int CP> struct FusedWideBlocks {
  static cudaError_t run(int S, int backward, int* blocks) {
    return backward ? FusedWideBackward<scalar_t, A, CP>::per_sm(S, blocks)
                    : FusedWideForward<scalar_t, A, CP>::per_sm(S, blocks);
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
      const void* rootw, void* partials, void* scale, void* site_log,         \
      const void* next, const void* need, const void* starts, void* sync,     \
      int n_starts, int T, int I, int C, int S, int maxc, int P, int csplit,  \
      int walk, void* stream) {                                               \
    if (wide_bad_dims(C, S, maxc)) return cudaErrorInvalidValue;              \
    return with_wide_tiles<TYPE, FusedWideForward>(                           \
        S, tips, pmats, children, rootw, partials, scale, site_log, next,     \
        need, starts, sync, n_starts, T, I, C, S, maxc, P, csplit, walk,      \
        static_cast<cudaStream_t>(stream));                                   \
  }                                                                           \
  cudaError_t fused_wide_backward_##SUFFIX(                                   \
      const void* tips, const void* pmats, const void* children,              \
      const void* rootw, const void* partials, const void* scale,             \
      const void* g, void* gbuf, void* dP_part, void* drootw_part,            \
      const void* items, const void* claims, const void* consumers,           \
      void* sync, int n_claims, int T, int I, int C, int S, int maxc, int P,  \
      int csplit, int walk, void* stream) {                                   \
    if (wide_bad_dims(C, S, maxc)) return cudaErrorInvalidValue;              \
    return with_wide_tiles<TYPE, FusedWideBackward>(                          \
        S, tips, pmats, children, rootw, partials, scale, g, gbuf, dP_part,   \
        drootw_part, items, claims, consumers, sync, n_claims, T, I, C, S,    \
        maxc, P, csplit, walk, static_cast<cudaStream_t>(stream));            \
  }                                                                           \
  cudaError_t fused_wide_blocks_##SUFFIX(int S, int backward, int* blocks) {  \
    return with_wide_tiles<TYPE, FusedWideBlocks>(S, S, backward, blocks);    \
  }

PHYSHER_FUSED_WIDE_ENTRY(f32, float)
PHYSHER_FUSED_WIDE_ENTRY(f64, double)

#undef PHYSHER_FUSED_WIDE_ENTRY

long fused_wide_kernel_launches() { return fused_wide_launches; }

}  // extern "C"
